// Device code shared by the kernels of csrc/*.cu: the tile constants, the
// operand modes, the sources a pass-1 walk stages from, and K3's recon of
// one 64 x 64 tile.
//
// K3 (fused_mu.cu) forms Y = W H for a 64 x 64 tile in registers
// (recon_tile); K1/K2's pass 1 and K5 (tile_sparse.cu), which runs the same
// pass 1 over a sweep plan (pass1.cuh), stage their own (simt_tile.cuh,
// mma_tile.cuh) by the same Modes and rules.  Everything here sits in an
// anonymous namespace, so each translation unit compiles its own copy.

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
// taken once per staging loop.  SPLIT3 and BF16: the float32_fast and
// bfloat16 GEMM policies on the tensor cores (mma_tile.cuh), every state
// dtype and X storage.  Sharing the runtime choices cost the f32 path 47%
// at 10240^2, K=256 on an H100 (more code and over 128 registers: one block
// an SM), hence its own instances.
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

// Staging rules of a GEMM operand: as it is, or rounded to bf16 (nearest
// even).
struct AsIs {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct RoundBf16 {
  __device__ __forceinline__ float operator()(float v) const {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};
// The runtime modes are taken once per staging loop, before it: these call
// body(...) with the source and the rule as types.  (A branch per element,
// copied into every unrolled staging loop, doubled the kernels' code.)
template <Mode MODE, typename Body>
__device__ __forceinline__ void with_rule(const Operands& o, Body&& body) {
  if constexpr (MODE == Mode::F32) {
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
    body(Bf16In{static_cast<const __nv_bfloat16*>(p)}, AsIs{});
  } else {
    const F32In src{static_cast<const float*>(p)};
    with_rule<MODE>(o, [&](auto rule) { body(src, rule); });
  }
}

// body(src) for X at p (in the storage o.x_kind names), or at o.x.
template <Mode MODE, typename Body>
__device__ __forceinline__ void with_x(const Operands& o, const void* p, Body&& body) {
  if constexpr (MODE == Mode::F32) {
    body(F32In{static_cast<const float*>(p)});
  } else {
    switch (o.x_kind) {
      case X_BF16: body(Bf16In{static_cast<const __nv_bfloat16*>(p)}); break;
      case X_U8: body(U8In{static_cast<const uint8_t*>(p), o.scales}); break;
      default: body(F32In{static_cast<const float*>(p)});
    }
  }
}
template <Mode MODE, typename Body>
__device__ __forceinline__ void with_x(const Operands& o, Body&& body) {
  with_x<MODE>(o, o.x, body);
}

// Where one step of a pass-1 walk reads its 64 x 64 tile of X: element
// (r, c) is p[(r0 + r) * stride + c0 + c] (column c0 + c for the scales of
// uint8 codes), 0 where r0 + r >= rlim or c0 + c >= clim.
struct XSrc {
  const void* p;
  int stride, r0, c0, rlim, clim;
};

// One step of a pass-1 walk: the walked operand's 64 rows of W (K1's side)
// or 64 columns of H (K2's side) from r0, staged as 0 from lim on, and the
// step's X.
struct WalkStep {
  int r0, lim;
  XSrc x;
};

// 16-byte vectors of a row-major array p of row stride `stride`: possible
// when p and every row start on 16 bytes (v elements), so that a vector at
// a column multiple of v never leaves its row.
__device__ __forceinline__ bool vec_ok(const void* p, int stride, int v) {
  return stride % v == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// K3's recon: s[r][c] = sum_k W[m0 + ty + 16 r, k] * H[k, n0 + tx + 16 c]
// over all k < K, out-of-range rows, columns and k read as 0, each operand
// staged by the mode's rule (F32 or ANY).  ws holds the W slice transposed
// ([KS][TILE + 1]), hs the H slice ([KS][TILE]).
template <Mode MODE>
__device__ __forceinline__ void recon_tile(const Operands& o, int m0, int n0, float* ws,
                                           float* hs, float s[4][4]) {
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
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = ws[kk * WS_STRIDE + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = hs[kk * TILE + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(a[r], b[c], s[r][c]);
    }
    __syncthreads();
  }
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
