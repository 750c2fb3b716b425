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
// Here: the launch bounds and shared memory of each instance, the dispatch
// of a Mode to its body (BF16 and SPLIT3 on the tensor cores, F32 and ANY
// on the SIMT units), and the host's switches from a runtime chunk width
// or Mode to an instance.  Both units include this file and compile their
// own copies (anonymous namespace).

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

// The body of K1's side (H) or K2's (W) in MODE at chunk width 16 R.  The
// f32-GEMM instances take ANY only under f32 GEMMs: the bf16 rounding,
// constant off there, leaves the staging rules' RoundBf16 arms out of them.
template <bool H, int R, Mode MODE, typename Walk>
__device__ __forceinline__ void pass1(Operands o, const Walk& walk) {
  if constexpr (MODE == Mode::ANY) o.round_bf16 = 0;
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
