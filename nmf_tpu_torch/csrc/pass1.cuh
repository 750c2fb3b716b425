// K1/K2's pass 1: one body per Mode and side, for any walk.
//
// A pass-1 block owns 64 output columns of W^T Z (K1's side, the H
// numerator) or 64 output rows of Z H^T (K2's side, the W numerator) and a
// k chunk, and walks a run of 64 x 64 steps, each one tile of W H, Z =
// X / max(W H, eps) and the contraction, summed into its raw f32 partial
// (simt_tile.cuh, mma_tile.cuh).  The walk says where each step's operands
// come from (simt_tile.cuh: Walk):
//
//   the dense walk (fused_mu.cu): K1/K2 over a contiguous run of M or N
//     tiles of a dense X, one split of the planner's;
//   the plan walk (tile_sparse.cu): K5 over the 64-row (H target) or
//     64-column (W target) sub-tiles of a piece of a sweep plan.
//
// K3 (fused_mu.cu) is K1's side up to Z: the same walk and staging, each
// step's W H summed into the cost's terms instead of contracted (kl_walk,
// below).
//
// Here: the launch bounds and shared memory of each instance, the dispatch
// of a Mode to its body (BF16 and SPLIT3 on the tensor cores, F32 and ANY
// on the SIMT units), K3's body, and the host's switches from a runtime
// chunk width or Mode to an instance.  Both units include this file and
// compile their own copies (anonymous namespace).

#pragma once

#include <algorithm>
#include <type_traits>

#include "mma_tile.cuh"   // and mu_tile.cuh
#include "simt_tile.cuh"

namespace {

// BF16 holds to two blocks an SM (128 registers), and F32 below KC = 256;
// at KC = 256 F32's resident block and W or H rows take 167 KiB of shared
// memory, one block an SM (so up to 255 registers), and SPLIT3's two
// planes ~174 KiB.
template <int R, Mode MODE>
constexpr int MIN_BLOCKS = MODE == Mode::BF16 || (MODE == Mode::F32 && R < 16) ? 2 : 1;

// The body of K1's side (H) or K2's (W) in MODE at chunk width 16 R.
template <bool H, int R, Mode MODE, typename Walk, typename Ops>
__device__ __forceinline__ void pass1(const Ops& o, const Walk& walk) {
  if constexpr (MODE == Mode::BF16 || MODE == Mode::SPLIT3) {
    if constexpr (H)
      h_partial_mma<R, MODE == Mode::SPLIT3>(o, walk);
    else
      w_partial_mma<R, MODE == Mode::SPLIT3>(o, walk);
  } else if constexpr (H) {
    h_partial_simt<R, MODE>(o, walk);
  } else {
    w_partial_simt<R, MODE>(o, walk);
  }
}

// Dynamic shared memory of an instance, in bytes.  SIMT: f32 words
// (simt_smem_words).  BF16 and SPLIT3 in bf16 words (mma_tile.cuh): Z, X,
// the walking chunk, and the resident block or one streamed W H step, each
// but X in two planes under SPLIT3 (96 KiB at KC = 256: two blocks an SM;
// SPLIT3 174 KiB).
template <bool H, int R, Mode MODE>
constexpr size_t pass1_smem_bytes() {
  if constexpr (MODE == Mode::BF16 || MODE == Mode::SPLIT3) {
    constexpr bool S3 = MODE == Mode::SPLIT3;
    constexpr size_t P = S3 ? 2 : 1, KC = 16 * R;
    constexpr size_t walking = H ? TILE * (KC + BPAD) : KC * (TILE + BPAD);
    constexpr size_t fixed = H ? KC * HS_LD : TILE * (KC + BPAD);
    return (P * Z_WORDS + X_WORDS + P * walking + std::max<size_t>(P * fixed, STEP_BUF<S3>)) *
           sizeof(bf16);
  }
  return simt_smem_words<R>() * sizeof(float);
}

constexpr int MODES = static_cast<int>(Mode::BF16) + 1;  // the last Mode

// K3's terms at a thread's positions of one step, from X in xs
// [TILE][XS_LD], summed in a fixed order (16 a thread): the SIMT recon's
// s[r][c] at row ty + 16 r, column 4 tx + c (X read as LDS.128: a warp's 4
// rows in 4 wavefronts), or the tensor cores' y[0][u][2 half + e] at row
// 16 wm + lane / 4 + 8 half, column 32 wn + 8 u + 2 (lane % 4) + e (X read
// in pairs, conflict-free).  An element outside the step's X limits (the
// ragged edge) adds nothing, not even +y.
__device__ __forceinline__ float kl_terms(float eps, const float (&s)[4][4], const float* xs,
                                          const XSrc& x) {
  const int ty = grid_ty(), tx = grid_tx();
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 xv = ld4(xs + (ty + 16 * r) * XS_LD + 4 * tx);
    const bool row_in = x.r0 + ty + 16 * r < x.rlim;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (row_in && x.c0 + 4 * tx + c < x.clim) t += kl_term(at(xv, c), s[r][c], eps);
  }
  return t;
}
__device__ __forceinline__ float kl_terms(float eps, const float (&y)[1][4][4], const float* xs,
                                          const XSrc& x) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp & 3, wn = warp >> 2;
  float t = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * wm + (lane >> 2) + 8 * half, j = 32 * wn + 8 * u + 2 * (lane & 3);
      const float2 xv = *reinterpret_cast<const float2*>(xs + i * XS_LD + j);
      const bool row_in = x.r0 + i < x.rlim;
      if (row_in && x.c0 + j < x.clim) t += kl_term(xv.x, y[0][u][2 * half], eps);
      if (row_in && x.c0 + j + 1 < x.clim) t += kl_term(xv.y, y[0][u][2 * half + 1], eps);
    }
  return t;
}

// K3's shared memory at chunk width 16 R, in bytes: X of this step and the
// next, f32 [2][TILE][XS_LD], then the block's resident H (or a streamed
// W H step) and the step's W rows, f32 (SIMT: K1's, [KC][SLD] and
// [TILE][KC + 4]) or bf16 (BF16: [TILE][KC + BPAD], [KC][HS_LD]).
template <int R, Mode MODE>
constexpr size_t kl_smem_bytes() {
  constexpr size_t KC = 16 * R, X = 2 * TILE * XS_LD * sizeof(float);
  if constexpr (MODE == Mode::BF16)
    return X + (TILE * (KC + BPAD) + std::max<size_t>(KC * HS_LD, STEP_BUF<false>)) * sizeof(bf16);
  return X + (KC * SLD + TILE * (KC + 4)) * sizeof(float);
}

// K3 holds no accumulator: two blocks an SM wherever shared memory allows
// (all but the SIMT instances at KC = 256, 171 KiB).
template <int R, Mode MODE>
constexpr int KL_MIN_BLOCKS = MODE == Mode::BF16 || R < 16 ? 2 : 1;

// bf16 bits of a ROWS x COLS block of p (row stride `stride`) from (r0, c0)
// into dst [ROWS][LD]: by cp.async, 16 bytes (8 elements) a copy, zero
// filled at rows >= rlim and columns >= clim, where p, the stride and c0
// sit on 16 bytes; else loaded and stored an element at a time.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_bits(const bf16* p, int r0, int c0, int rlim, int clim,
                                           int stride, bf16* dst) {
  if (vec_ok(p, stride, 8) && (c0 & 7) == 0) {
    constexpr int CPR = COLS / 8, STEP = THREADS / CPR;
    static_assert(COLS % 8 == 0 && THREADS % CPR == 0, "whole rows of 16-byte runs");
    const int cv = 8 * (threadIdx.x % CPR), gc = c0 + cv;
    const int bytes = 2 * max(0, min(8, clim - gc));
#pragma unroll 4
    for (int r = threadIdx.x / CPR; r < ROWS; r += STEP) {
      const bool in = r0 + r < rlim && bytes > 0;
      cp_async16(reinterpret_cast<float*>(dst + r * LD + cv),
                 reinterpret_cast<const float*>(in ? p + (r0 + r) * stride + gc : p), in ? bytes : 0);
    }
  } else {
    stage_rows<ROWS, COLS, LD, 4>(Bf16Bits{p}, r0, c0, rlim, clim, stride, dst);
  }
}

// A step's X into xs [TILE][XS_LD] as f32, for K3: f32 by cp.async (in
// flight until waited for), else loaded, widened and stored: bf16 in
// 16-byte vectors (8 elements), uint8 codes 4 a load with their 4 scales as
// one float4 (float(q) * scale, as U8In), where the rows and columns allow;
// an element at a time otherwise.
template <Mode MODE, typename Ops>
__device__ __forceinline__ void stage_x_kl(const Ops& o, const XSrc& x, float* xs) {
  if constexpr (MODE != Mode::F32) {
    if (o.x_kind == X_BF16 && vec_ok(x.p, x.stride, 8) && ((x.c0 | x.clim) & 7) == 0)
      return stage_x_vec<8, bf16>(x, xs);
    if (o.x_kind == X_U8 && x.stride % 4 == 0 && (reinterpret_cast<uintptr_t>(x.p) & 3) == 0 &&
        (reinterpret_cast<uintptr_t>(o.scales) & 15) == 0 && ((x.c0 | x.clim) & 3) == 0) {
      constexpr int TPR = TILE / 4, STEP = THREADS / TPR;
      const uint8_t* p = static_cast<const uint8_t*>(x.p);
      const int i = threadIdx.x / TPR, jv = threadIdx.x % TPR * 4, gc = x.c0 + jv;
      const bool col_in = gc < x.clim;  // the whole run of 4
      const float4 sc = col_in ? *reinterpret_cast<const float4*>(o.scales + gc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      float* d = xs + i * XS_LD + jv;
#pragma unroll
      for (int s = 0; s < TILE / STEP; ++s) {
        const int gr = x.r0 + i + s * STEP;
        const uchar4 q = col_in && gr < x.rlim ? *reinterpret_cast<const uchar4*>(p + gr * x.stride + gc)
                                               : make_uchar4(0, 0, 0, 0);
        *reinterpret_cast<float4*>(d + s * STEP * XS_LD) =
            make_float4((float)q.x * sc.x, (float)q.y * sc.y, (float)q.z * sc.z, (float)q.w * sc.w);
      }
      return;
    }
  }
  stage_xs<MODE, XS_LD>(o, x, xs);
}

// K3's body in MODE at chunk width KC = 16 R (K <= KC: the block's H stays
// resident; above, W H streams both operands): the block's walk of K1's side
// (its 64 columns, a run of M tiles), each step's W H at the thread's
// positions turned into the cost's terms.  Returns the thread's sum.
// BF16 takes W and H as bf16 bits (bf16 state, or f32 state rounded once a
// call by nmf_kl_cost).
//
// Per step t: W H (SIMT: recon_groups, LDS.128 fragments a step ahead,
// each copy group of KSL k waited for where it is read; BF16: mma.sync,
// each k-step summed apart); a barrier; then the copies of step t + 1 (its
// X into the other X buffer, its W rows into the one W buffer, by
// cp.async) issued, in flight while the step's 16 terms a thread are
// formed and summed.
//
// The sum.  Each step's 16 terms are summed first, and that step sum is
// added into the thread's running sum with Kahan's compensation
// (KahanSum): a chain of 16 adds a step, and about one rounding over the
// whole walk, however long (303 steps on an hour of audio held tall).
template <int R, Mode MODE, typename Walk, typename Ops>
__device__ __forceinline__ float kl_walk(const Ops& o, const Walk& walk) {
  static_assert(MODE != Mode::SPLIT3, "K3's recon is true f32 under float32_fast");
  constexpr bool MMA = MODE == Mode::BF16;
  constexpr int KC = 16 * R, LDW = KC + (MMA ? BPAD : 4);
  constexpr int NG = KC > KSL ? KC / KSL : 1, GW = KC / NG;
  extern __shared__ float4 smem_raw[];
  float* xb = reinterpret_cast<float*>(smem_raw);  // [2][TILE][XS_LD]: steps t, t + 1
  float* ops = xb + 2 * TILE * XS_LD;
  bf16* wc = reinterpret_cast<bf16*>(ops);         // BF16: [TILE][LDW] the step's W
  bf16* hb = wc + TILE * LDW;                      // BF16: [KC][HS_LD] resident H, or a step
  float* hr = ops;                                 // SIMT: [KC][SLD] resident H, or W H's steps
  float* wt = hr + KC * SLD;                       // SIMT: [TILE][LDW] the step's W

  const int steps = walk.steps();
  const bool resident = o.k <= KC;
  // the W rows of step t (resident only), committed: one copy group, or
  // (SIMT) NG of KSL k each
  auto stage_w_of = [&](int t) {
    const WalkStep st = walk.step(t);
    if constexpr (MMA) {
      stage_bits<TILE, KC, LDW>(static_cast<const bf16*>(o.w), st.r0, 0, st.lim, o.k, o.k, wc);
      cp_commit();
    } else {
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        stage_w<MODE, TILE, GW, LDW>(o, st.r0, g * GW, st.lim, wt + g * GW);
        cp_commit();
      }
    }
  };
  KahanSum total;
  if (steps > 0) {
    if (resident) {
      if constexpr (MMA)
        stage_bits<KC, TILE, HS_LD>(static_cast<const bf16*>(o.h), 0, walk.res0, o.k,
                                    walk.res_lim, o.n, hb);
      else
        stage_h<MODE, KC, TILE, SLD>(o, 0, walk.res0, walk.res_lim, hr);
    }
    stage_x_kl<MODE>(o, walk.step(0).x, xb);
    cp_commit();
    if (resident) stage_w_of(0);
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const WalkStep st = walk.step(t);
    float y[1][4][4] = {}, s[4][4] = {};
    if constexpr (MMA) {
      cp_wait<0>();  // the step's W and X (and the resident H) in
      __syncthreads();
      if (resident)
        recon_resident<LDW, HS_LD, 2, 0, 0, true>(o, wc, hb, y);
      else
        recon_streamed<false>(o, st.r0, st.lim, walk.res0, walk.res_lim, hb, y);
    } else if (resident) {  // the first group's wait takes the step's X with it
      recon_groups<NG, LDW, true>(wt, hr, (o.k + 3) & ~3, s);
    } else {  // ends with every copy group in
      recon_streamed<MODE>(o, st.r0, st.lim, walk.res0, walk.res_lim, (o.k + 3) & ~3, hr, s);
    }
    __syncthreads();  // W (and H steps) read, and the last step's X: restaged below
    if (t + 1 < steps) {
      stage_x_kl<MODE>(o, walk.step(t + 1).x, xb + ((t + 1) & 1) * TILE * XS_LD);
      cp_commit();
      if (resident) stage_w_of(t + 1);
    }
    const float* xs = xb + (t & 1) * TILE * XS_LD;
    if constexpr (MMA)
      total.add(kl_terms(o.eps, y, xs, st.x));
    else
      total.add(kl_terms(o.eps, s, xs, st.x));
  }
  return total.sum;
}

// f(std::integral_constant<int, R>) for chunk width kc = 16 R.
template <typename F>
cudaError_t at_width(int kc, F&& f) {
  switch (kc) {
    case 16: return f(std::integral_constant<int, 1>{});
    case 32: return f(std::integral_constant<int, 2>{});
    case 64: return f(std::integral_constant<int, 4>{});
    case 128: return f(std::integral_constant<int, 8>{});
    case 256: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<Mode, MODE>) for a Mode's value.
template <typename F>
cudaError_t at_mode(int mode, F&& f) {
  switch (mode) {
    case static_cast<int>(Mode::F32): return f(std::integral_constant<Mode, Mode::F32>{});
    case static_cast<int>(Mode::ANY): return f(std::integral_constant<Mode, Mode::ANY>{});
    case static_cast<int>(Mode::SPLIT3): return f(std::integral_constant<Mode, Mode::SPLIT3>{});
    case static_cast<int>(Mode::BF16): return f(std::integral_constant<Mode, Mode::BF16>{});
    default: return cudaErrorInvalidValue;
  }
}

// The Mode a call's operands run in: the GEMM policy's tensor-core Mode,
// F32 for all-f32 operands under f32 GEMMs, else ANY.
Mode mode_of(const Operands& o, int gemm) {
  if (gemm == GEMM_SPLIT3) return Mode::SPLIT3;
  if (gemm == GEMM_BF16) return Mode::BF16;
  return all_f32(o) ? Mode::F32 : Mode::ANY;
}

// out[4] = registers, dynamic shared memory (bytes), resident blocks an SM
// and local memory a thread (bytes: spills) of kernel fn, as the runtime
// reports them on the current device.
cudaError_t kernel_info(const void* fn, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes a;
  int blocks = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, THREADS, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)smem;
  out[2] = blocks;
  out[3] = (int)a.localSizeBytes;
  return cudaSuccess;
}

}  // namespace
