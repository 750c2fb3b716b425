// Device code shared by the kernels of csrc/*.cu: the tile constants, the
// operand modes, the sources a pass-1 walk stages from, and the terms of
// K3's cost and their compensated sum.
//
// K1/K2's pass 1, K5 (tile_sparse.cu), which runs the same pass 1 over a
// sweep plan, and K3, which runs K1's walk with the cost's sum in place of
// the contraction (pass1.cuh), stage their operands (simt_tile.cuh,
// mma_tile.cuh) by the same Modes and rules.  Everything here sits in an
// anonymous namespace, so each translation unit compiles its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // BM = BN: one block's output/recon tile edge
constexpr int KS = 16;        // k depth of one mma k-step (mma_tile.cuh)
constexpr int THREADS = 256;  // 16 x 16; tx = tid % 16, ty = tid / 16

enum XKind { X_F32 = 0, X_BF16 = 1, X_U8 = 2 };
enum Gemm { GEMM_F32 = 0, GEMM_SPLIT3 = 1, GEMM_BF16 = 2 };

// How a kernel stages its operands, fixed at compile time.  F32: W, H and X
// are f32 and the GEMM takes them as they are (the main path).  ANY: f32
// GEMMs, the state dtype and the X storage runtime choices, each taken once
// per staging loop.  SPLIT3 and BF16: the float32_fast and
// bfloat16 GEMM policies on the tensor cores (mma_tile.cuh), every state
// dtype and X storage.  Sharing the runtime choices cost the f32 path 47%
// at 10240^2, K=256 on an H100 (more code and over 128 registers: one block
// an SM), hence its own instances.
enum class Mode { F32, ANY, SPLIT3, BF16 };

// The operands and modes of one call, passed by value to every kernel.
// The device pieces take their operands' type as a template parameter
// (Ops): this struct, or a view with the same fields (fused_mu.cu's
// MemberOperands, one member of a batched launch).
struct Operands {
  const void* w;         // (m, k) state dtype
  const void* h;         // (k, n) state dtype
  const void* x;         // (m, n) f32 | bf16 | uint8 codes
  const float* scales;   // (n,) per-column scales of uint8 codes, else null
  int m, n, k;
  int state_bf16;        // W and H are bf16 (else f32)
  int x_kind;            // XKind
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

// The runtime modes are taken once per staging loop, before it: these call
// body(src) with the source as a type.  (A branch per element, copied into
// every unrolled staging loop, doubled the kernels' code.)
//
// body(src) for W or H (p) in the state dtype.
template <Mode MODE, typename Body, typename Ops>
__device__ __forceinline__ void with_state(const void* p, const Ops& o, Body&& body) {
  if constexpr (MODE == Mode::F32) {
    body(F32In{static_cast<const float*>(p)});
  } else if (o.state_bf16) {
    body(Bf16In{static_cast<const __nv_bfloat16*>(p)});
  } else {
    body(F32In{static_cast<const float*>(p)});
  }
}

// body(src) for X at p (in the storage o.x_kind names).
template <Mode MODE, typename Body, typename Ops>
__device__ __forceinline__ void with_x(const Ops& o, const void* p, Body&& body) {
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

// One element's term of K3's cost (fused_mu.py:540-544): y = max(s, eps),
// x (log x - log y) - x + y with the x -> 0 limit 0 for x log x, the
// accurate logf.  Each term is >= 0 for x >= 0, y > 0.
__device__ __forceinline__ float kl_term(float x, float s, float eps) {
  const float y = clamp_eps(s, eps);
  const float xlog = x > 0.f ? x * (logf(x) - logf(y)) : 0.f;
  return xlog - x + y;
}

// A running f32 sum with Kahan's compensation: the rounding error of each
// add is carried into the next, so a sum over a walk of hundreds of steps
// keeps about one rounding of its result instead of one a step.
struct KahanSum {
  float sum = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float v) {
    const float y = v - c;
    const float t = sum + y;
    c = (t - sum) - y;
    sum = t;
  }
};

// The operands of a call, or an error for a mode the kernels do not have.
cudaError_t make_operands(const void* w, const void* h, const void* x,
                          const float* scales, int m, int n, int k,
                          int state_bf16, int x_kind, int gemm, float eps,
                          Operands* o) {
  if ((state_bf16 != 0 && state_bf16 != 1) || x_kind < X_F32 || x_kind > X_U8 ||
      gemm < GEMM_F32 || gemm > GEMM_BF16 || (x_kind == X_U8 && scales == nullptr))
    return cudaErrorInvalidValue;
  *o = Operands{w, h, x, scales, m, n, k, state_bf16, x_kind, eps};
  return cudaSuccess;
}

// W, H and X all f32: the kernels' F32 mode (when the GEMM is float32).
bool all_f32(const Operands& o) { return !o.state_bf16 && o.x_kind == X_F32; }

}  // namespace
