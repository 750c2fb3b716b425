// Device code shared by the kernels of csrc/*.cu: the tile constants, the
// operand modes, and the recon and ratio steps of one 64 x 64 tile.
//
// K3 (fused_mu.cu) and K5 (tile_sparse.cu) both form Y = W H for a 64 x 64
// tile in registers (recon_tile) and, K5, Z = X / max(Y, eps) into shared
// memory (ratio_tile), staged per Mode; K1/K2 stage their own
// (simt_tile.cuh, mma_tile.cuh) by the same Modes and rules.  Everything
// here sits in an anonymous namespace, so each translation unit compiles
// its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // BM = BN: one block's output/recon tile edge
constexpr int KS = 16;        // K slice staged per phase-A step
constexpr int THREADS = 256;  // 16 x 16; tx = tid % 16, ty = tid / 16
constexpr int WS_STRIDE = TILE + 1;  // padded transposed W slice

enum XKind { X_F32 = 0, X_BF16 = 1, X_U8 = 2 };
enum Gemm { GEMM_F32 = 0, GEMM_SPLIT3 = 1, GEMM_BF16 = 2 };

// How a kernel stages its operands, fixed at compile time.  F32: W, H and X
// are f32 and the GEMM takes them as they are (the main path).  ANY: the
// state dtype, the X storage and bf16 rounding are runtime choices, each
// taken once per staging loop.  SPLIT3:
// as ANY, with each operand split into a bf16 (hi, lo) pair (K5 on the SIMT
// units, below; K1/K2 on the tensor cores, mma_tile.cuh).  Sharing the
// runtime choices cost the f32 path 47% at 10240^2, K=256 on an H100 (more
// code and over 128 registers: one block an SM), hence its own instances.
enum class Mode { F32, ANY, SPLIT3, BF16 };

// The operands and modes of one call, passed by value to every kernel.
struct Operands {
  const void* w;         // (m, k) state dtype
  const void* h;         // (k, n) state dtype
  const void* x;         // (m, n) f32 | bf16 | uint8 codes
  const float* scales;   // (n,) per-column scales of uint8 codes, else null
  int m, n, k;
  int state_bf16;        // W and H are bf16 (else f32)
  int x_kind;            // XKind
  int round_bf16;        // GEMM inputs rounded to bf16 (bfloat16 policy)
  float eps;
};

// A staged GEMM operand: an f32 value, or under split3 a bf16 (hi, lo)
// pair in the same 4 bytes, so the shared memory is the same in every mode.
template <bool S3>
struct Staged {
  using T = float;
};
template <>
struct Staged<true> {
  using T = __nv_bfloat162;
};
static_assert(sizeof(__nv_bfloat162) == sizeof(float), "staging is 4 bytes");
template <Mode MODE>
using StagedT = typename Staged<MODE == Mode::SPLIT3>::T;

// The same operand in registers, ready for the FMAs.
template <bool S3>
struct Val {
  float v;
  __device__ __forceinline__ void load(float e) { v = e; }
};
template <>
struct Val<true> {
  float hi, lo;
  __device__ __forceinline__ void load(__nv_bfloat162 e) {
    hi = __low2float(e);
    lo = __high2float(e);
  }
};

__device__ __forceinline__ float mac(const Val<false>& a, const Val<false>& b,
                                     float acc) {
  return fmaf(a.v, b.v, acc);
}

// hi*bh + hi*bl + lo*bh: _kdot's three passes, per pair of operands
__device__ __forceinline__ float mac(const Val<true>& a, const Val<true>& b,
                                     float acc) {
  acc = fmaf(a.hi, b.hi, acc);
  acc = fmaf(a.hi, b.lo, acc);
  return fmaf(a.lo, b.hi, acc);
}

__device__ __forceinline__ float clamp_eps(float v, float eps) {
  return v < eps ? eps : v;  // keeps NaN, like the reference's `a < EPS`
}

// Element sources, each widening its dtype to f32: W or H in the state
// dtype (indexed by position), X in its storage (position and column).
struct F32In {
  const float* p;
  __device__ __forceinline__ float operator()(size_t i, int = 0) const { return p[i]; }
};
struct Bf16In {
  const __nv_bfloat16* p;
  __device__ __forceinline__ float operator()(size_t i, int = 0) const {
    return __bfloat162float(p[i]);
  }
};
struct U8In {  // uint8 codes, dequantized in register: float(q) * scale[col]
  const uint8_t* p;
  const float* scales;
  __device__ __forceinline__ float operator()(size_t i, int col) const {
    return (float)p[i] * scales[col];
  }
};

// Staging rules of a GEMM operand: as it is, rounded to bf16 (nearest
// even), or split into a bf16 (hi, lo) pair.
struct AsIs {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct RoundBf16 {
  __device__ __forceinline__ float operator()(float v) const {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};
struct Split3 {
  __device__ __forceinline__ __nv_bfloat162 operator()(float v) const {
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    return __halves2bfloat162(hi, __float2bfloat16_rn(v - __bfloat162float(hi)));
  }
};

// The runtime modes are taken once per staging loop, before it: these call
// body(...) with the source and the rule as types.  (A branch per element,
// copied into every unrolled staging loop, doubled the kernels' code.)
template <Mode MODE, typename Body>
__device__ __forceinline__ void with_rule(const Operands& o, Body&& body) {
  if constexpr (MODE == Mode::SPLIT3) {
    body(Split3{});
  } else if constexpr (MODE == Mode::F32) {
    body(AsIs{});
  } else {
    if (o.round_bf16) body(RoundBf16{}); else body(AsIs{});
  }
}

// body(src, rule) for W or H (p): bf16 state values are bf16 already, so
// rounding them is the identity and needs no rule of its own.
template <Mode MODE, typename Body>
__device__ __forceinline__ void with_state(const void* p, const Operands& o, Body&& body) {
  if constexpr (MODE == Mode::F32) {
    body(F32In{static_cast<const float*>(p)}, AsIs{});
  } else if (o.state_bf16) {
    const Bf16In src{static_cast<const __nv_bfloat16*>(p)};
    if constexpr (MODE == Mode::SPLIT3) body(src, Split3{}); else body(src, AsIs{});
  } else {
    const F32In src{static_cast<const float*>(p)};
    with_rule<MODE>(o, [&](auto rule) { body(src, rule); });
  }
}

// body(src) for X.
template <Mode MODE, typename Body>
__device__ __forceinline__ void with_x(const Operands& o, Body&& body) {
  if constexpr (MODE == Mode::F32) {
    body(F32In{static_cast<const float*>(o.x)});
  } else {
    switch (o.x_kind) {
      case X_BF16: body(Bf16In{static_cast<const __nv_bfloat16*>(o.x)}); break;
      case X_U8: body(U8In{static_cast<const uint8_t*>(o.x), o.scales}); break;
      default: body(F32In{static_cast<const float*>(o.x)});
    }
  }
}

// 16-byte vectors of a row-major array p of row stride `stride`: possible
// when p and every row start on 16 bytes (v elements), so that a vector at
// a column multiple of v never leaves its row.
__device__ __forceinline__ bool vec_ok(const void* p, int stride, int v) {
  return stride % v == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Phase A: s[r][c] = sum_k W[m0 + ty + 16 r, k] * H[k, n0 + tx + 16 c] over
// all k < K, out-of-range rows, columns and k read as 0, each operand staged
// in the GEMM mode.  ws holds the W slice transposed ([KS][TILE + 1]), hs
// the H slice ([KS][TILE]).
template <Mode MODE>
__device__ __forceinline__ void recon_tile(const Operands& o, int m0, int n0,
                                           StagedT<MODE>* ws, StagedT<MODE>* hs,
                                           float s[4][4]) {
  constexpr bool S3 = MODE == Mode::SPLIT3;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int k0 = 0; k0 < o.k; k0 += KS) {
    with_state<MODE>(o.w, o, [&](auto w, auto rule) {
      for (int e = tid; e < TILE * KS; e += THREADS) {
        const int i = e / KS, kk = e % KS;  // neighbours along k: coalesced
        const int gm = m0 + i, gk = k0 + kk;
        ws[kk * WS_STRIDE + i] = rule((gm < o.m && gk < o.k) ? w((size_t)gm * o.k + gk) : 0.f);
      }
    });
    with_state<MODE>(o.h, o, [&](auto h, auto rule) {
      for (int e = tid; e < KS * TILE; e += THREADS) {
        const int kk = e / TILE, j = e % TILE;  // neighbours along n
        const int gk = k0 + kk, gn = n0 + j;
        hs[kk * TILE + j] = rule((gk < o.k && gn < o.n) ? h((size_t)gk * o.n + gn) : 0.f);
      }
    });
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      Val<S3> a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r].load(ws[kk * WS_STRIDE + ty + 16 * r]);
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c].load(hs[kk * TILE + tx + 16 * c]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = mac(a[r], b[c], s[r][c]);
    }
    __syncthreads();
  }
}

// Z = X / clamp(W H) for the tile into zs ([TILE][TILE + 1]), staged in the
// GEMM mode.  Positions outside (m, n) have X = 0 and W H = 0, so Z = 0 /
// eps = 0 there exactly.  s is overwritten with Z.
template <Mode MODE>
__device__ __forceinline__ void ratio_tile(const Operands& o, int m0, int n0,
                                           float s[4][4], StagedT<MODE>* zs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  with_x<MODE>(o, [&](auto x) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm = m0 + ty + 16 * r, gn = n0 + tx + 16 * c;
        const float xv = (gm < o.m && gn < o.n) ? x((size_t)gm * o.n + gn, gn) : 0.f;
        s[r][c] = xv / clamp_eps(s[r][c], o.eps);
      }
  });
  with_rule<MODE>(o, [&](auto rule) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        zs[(ty + 16 * r) * (TILE + 1) + tx + 16 * c] = rule(s[r][c]);
  });
}

constexpr size_t staging_words() {
  return (size_t)KS * WS_STRIDE + (size_t)KS * TILE + (size_t)TILE * (TILE + 1);
}

// The operands of a call, or an error for a mode the kernels do not have.
cudaError_t make_operands(const void* w, const void* h, const void* x,
                          const float* scales, int m, int n, int k,
                          int state_bf16, int x_kind, int gemm, float eps,
                          Operands* o) {
  if ((state_bf16 != 0 && state_bf16 != 1) || x_kind < X_F32 || x_kind > X_U8 ||
      gemm < GEMM_F32 || gemm > GEMM_BF16 || (x_kind == X_U8 && scales == nullptr))
    return cudaErrorInvalidValue;
  *o = Operands{w, h, x, scales, m, n, k, state_bf16, x_kind,
                gemm == GEMM_BF16 ? 1 : 0, eps};
  return cudaSuccess;
}

// W, H and X all f32: the kernels' F32 mode (when the GEMM is float32).
bool all_f32(const Operands& o) { return !o.state_bf16 && o.x_kind == X_F32; }

}  // namespace
