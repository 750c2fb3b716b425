// Fused KL multiplicative-update kernels for Hopper (sm_90a).
//
// These replace the three Pallas TPU kernels of nmf_tpu/ops/pallas/fused_mu.py:
//
//   K1  nmf_h_update   <- _h_kernel  / update_h_fused  (fused_mu.py:245, :285)
//       H' = H * (W^T (X / max(W H, eps))) / max(colsum W, eps)[:, None]
//   K2  nmf_w_update   <- _w_kernel  / update_w_fused  (fused_mu.py:378, :412)
//       W' = W * ((X / max(W H, eps)) H^T) / max(rowsum H, eps)[None, :]
//   K3  nmf_kl_cost    <- _kl_kernel / kl_cost_fused   (fused_mu.py:516, :551)
//       sum x (log x - log y) - x + y,  y = max(W H, eps),  x -> 0 limit
//
// K1 and K2 also have the TPU kernels' numerator_only mode (fused_mu.py:294,
// :421): the f32 numerator W^T (X / max(W H, eps)) or (X / max(W H, eps)) H^T
// with no epilogue, for callers that sum it over column blocks (the
// out-of-core solve) or devices before dividing.
//
// What they keep out of device memory: the M x N reconstruction W H and the
// quotient Z = X / max(W H, eps).  Each block recomputes its 64 x 64 tile of
// W H in registers, forms Z in shared memory and contracts it at once, so X
// is the only M x N stream (read once per kernel).
//
// What bounds them on this card.  One half-update costs ~4 M N K flop (two
// GEMMs) against ~4 M N bytes of X (2 for bf16 X, 1 for uint8 codes).  On
// the SIMT FMA units (~67 TFLOP/s on an H100 SXM at 700 W) that is
// compute-bound from K ~ 30; on the tensor cores (989 TFLOP/s bf16) the
// bytes bound it below K ~ 500.  K1/K2 pass 1 under the bfloat16 and
// float32_fast policies (Mode::BF16, Mode::SPLIT3) runs both products of a
// tile on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate;
// mma_tile.cuh; split3 three mma a k-step); the float32 policy, and K3, run
// on the SIMT units: 4 x 4 (W H) and 4 x R (the contraction) register
// tiles fed from shared memory.  K1/K2's f32-GEMM pass 1 (simt_tile.cuh)
// reads its fragments as 16-byte vectors, stages f32 operands by cp.async
// with the next copies in flight beside the FMAs, and keeps the block's
// fixed operand resident; the tensor-core kernels and K3 wait for each
// staging step's global loads (the latency, not the tensor cores, bounds
// BF16).  None uses TMA or wgmma.
//
// Modes, as the TPU kernels have them, applied at staging (where a value is
// written to shared memory), outside the inner FMA loops:
//
//   state  W and H are f32 or bf16 in memory; every value is widened to f32
//          on load.  The epilogue multiplies by the state value itself, not
//          by its GEMM copy, and rounds to the state dtype (nearest even):
//          out = state(h * acc / sum) (fused_mu.py:276-278, 405-407).
//   X      f32, bf16, or uint8 codes with per-column f32 scales, dequantized
//          in register as float(q) * scale[col].
//   GEMM   float32: operands as they are.  bfloat16: each staged W, H and Z
//          value rounded to bf16 (__float2bfloat16_rn, the casts' rounding);
//          K1/K2 stage them as bf16 and multiply on the tensor cores (bf16
//          mma, f32 accumulation); K3 fmaf's them in f32, which is the same
//          up to the order of the sum (a product of two bf16 values is exact
//          in f32).  float32_fast (split3): each operand split into
//          hi = bf16(a), lo = bf16(a - hi), and each product taken as
//          hi*bh + hi*bl + lo*bh (the lo*lo term dropped, as _kdot): K1/K2
//          stage hi and lo as two bf16 planes and run three mma a k-step
//          (mma_tile.cuh); K3 takes the true-f32 recon (below).
//   K3     recon in true f32 under both f32 policies, on bf16-rounded
//          inputs under bfloat16 (fused_mu.py:586-591).
//
// The pass-1 kernels are instantiated per Mode (below): F32, the all-f32
// main path; ANY, f32 GEMMs on bf16 state or bf16/uint8 X as runtime
// choices; and SPLIT3 and BF16, the float32_fast and bfloat16 GEMM policies
// on the tensor cores for every state dtype and X storage (both runtime
// choices).  Not the cross product of dtypes, rounding and chunk widths: 40
// partial kernels in all.
//
// Design against the TPU kernel.  Pallas runs its grid in order and carries
// the K x bn (or bm x K) accumulator across the innermost grid axis.  CUDA
// blocks run in no order, so a block walks its share of the contraction
// axis in a loop instead.  At the reference shape N is only 350 (6 column
// tiles), so that axis is also split across a fixed number of blocks; each
// writes an f32 partial and a second pass sums the partials IN A FIXED ORDER
// and applies the epilogue.  No float atomics anywhere: the same inputs give
// the same bits on every run, in every mode.  The split count comes from the
// shape alone (the Python planner), never from the card.
//
// Numerics, as the reference kernels have them: the clamp is `v < eps ? eps
// : v` so NaN stays NaN (fmaxf would return eps); eps arrives as a C float
// (float32(2.2204e-16)); the epilogue is h * acc / sum (the TPU kernel's
// order); the log is the accurate logf (no fast math); the cost masks the
// ragged edge by logical (m, n) so padding adds nothing.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().
//
// The tile steps (recon_tile, ratio_tile), the staging rules and Mode live in
// mu_tile.cuh, shared with K5 (tile_sparse.cu, whose float32_fast keeps
// the SIMT (hi, lo) pairs); the tensor-core pieces of Mode::BF16 and
// Mode::SPLIT3 in mma_tile.cuh, which only this file includes.

#include <algorithm>
#include <atomic>

#include "mma_tile.cuh"   // and mu_tile.cuh
#include "simt_tile.cuh"

namespace {

// Loads of the walking W or H block a thread has in flight at once beside
// the accumulators (KC / 4 elements a thread in all): elements, or 16-byte
// vectors.  K2's BF16 instances stage one element at a time: their
// 16-byte loads (of W, H or X) spilled at KC = 256.  SPLIT3's take them,
// but at R = 4, where they cost the second block an SM (119 -> 153
// registers) and ran slower.
constexpr int WALK_UNROLL = 4, WALK_VECTORS = 2;

// K1 pass 1 on the tensor cores (Mode::BF16, and Mode::SPLIT3 with S3):
// the same walk and partials as h_partial_simt.  Per M tile: X to xs,
// Wc = W[m0 .., kc0 .. +KC] to wc (bf16 [TILE][KC + BPAD], k contiguous),
// W H into registers, Z to zs, then acc (KC x TILE) += Wc^T Z over the
// tile's 64 rows (A = Wc^T and B = Z both stored i-major: ldmatrix.trans;
// each k-step summed apart and added in f32, mma_panel's FRESH, however
// long the walk).  With one k chunk (K <= KC) Wc is the whole W block of
// the tile, and the block's H columns H[.., n0 .. +64] stay in shared
// memory for its whole walk (hr), so W H reads both from shared memory;
// above it W H streams both per k step.  S3: every staged block (wc, hr or
// the step, zs) is two planes, hi then lo, and each k-step of W H too is
// summed apart.
template <int R, bool S3>
__device__ __forceinline__ void h_partial_mma(const Operands& o, float* __restrict__ part,
                                              int tiles_per_split) {
  using L = HTiling<R>;
  constexpr int KC = 16 * R, WC_LD = KC + BPAD, P = S3 ? 2 : 1;
  // the lo planes' offsets (0: no split)
  constexpr int ZP = S3 ? Z_WORDS : 0, WP = S3 ? TILE * WC_LD : 0, HP = S3 ? KC * HS_LD : 0;
  extern __shared__ float4 smem_raw[];
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);
  float* xs = reinterpret_cast<float*>(zs + P * Z_WORDS);
  bf16* wc = zs + P * Z_WORDS + X_WORDS;
  bf16* hr = wc + P * TILE * WC_LD;  // [P][KC][HS_LD] resident H, or one streamed step

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % L::WM, wn = warp / L::WM;
  const int n0 = blockIdx.x * TILE, kc0 = blockIdx.y * KC;
  const int m_tiles = (o.m + TILE - 1) / TILE;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, m_tiles);
  const bool resident = o.k <= KC;
  if (resident)  // read after the first tile's __syncthreads
    stage_bf16<KC, TILE, HS_LD, WALK_UNROLL, WALK_VECTORS, HP>(o, o.h, 0, n0, o.k, o.n, o.n, hr);

  float acc[L::TM][L::TN][4];
#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][u][c] = 0.f;

#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * TILE;
    stage_x<true>(o, m0, n0, xs);
    stage_bf16<TILE, KC, WC_LD, WALK_UNROLL, WALK_VECTORS, WP>(o, o.w, m0, kc0, o.m, o.k, o.k, wc);
    float y[1][4][4] = {};
    if (resident) {
      __syncthreads();
      recon_resident<WC_LD, HS_LD, R >= 8 ? 1 : 2, WP, HP>(o, wc, hr, y);
    } else {
      recon_streamed<S3>(o, m0, n0, hr, y);
    }
    ratio_z<ZP>(o, y, xs, zs);
    __syncthreads();
    mma_panel<L::TM, L::TN, true, true, WC_LD, ZS_LD, true, 1, WP, ZP>(
        acc, wc + 16 * L::TM * wm, zs + 8 * L::TN * wn, TILE);
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.z * o.k * o.n;
#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gk = kc0 + 16 * (L::TM * wm + t) + (lane >> 2) + 8 * (c >> 1);
        const int gn = n0 + 8 * (L::TN * wn + u) + 2 * (lane & 3) + (c & 1);
        if (gk < o.k && gn < o.n) dst[(size_t)gk * o.n + gn] = acc[t][u][c];
      }
}

// K2 pass 1 on the tensor cores.  Per N tile: X to xs, Hc = H[kc0 .. +KC,
// n0 ..] to hc (bf16 [KC][TILE + BPAD], n contiguous), W H, Z, then
// acc (TILE x KC) += Z Hc^T over the tile's 64 columns (A = Z and B = Hc^T
// both stored with the contraction axis contiguous: plain ldmatrix; FRESH,
// as K1).  With one k chunk Hc is the tile's whole H block, and the
// block's W rows W[m0 .. +64, ..] stay in shared memory for its walk (wr).
// S3: two planes each, as K1.
template <int R, bool S3>
__device__ __forceinline__ void w_partial_mma(const Operands& o, float* __restrict__ part,
                                              int tiles_per_split) {
  using L = WTiling<R>;
  constexpr int KC = 16 * R, HC_LD = TILE + BPAD, WR_LD = KC + BPAD, P = S3 ? 2 : 1;
  constexpr int ZP = S3 ? Z_WORDS : 0, HP = S3 ? KC * HC_LD : 0, WP = S3 ? TILE * WR_LD : 0;
  constexpr bool VEC = S3 && R != 4;  // 16-byte staging loads (above)
  constexpr int VU = VEC ? WALK_VECTORS : 0;
  extern __shared__ float4 smem_raw[];
  bf16* zs = reinterpret_cast<bf16*>(smem_raw);
  float* xs = reinterpret_cast<float*>(zs + P * Z_WORDS);
  bf16* hc = zs + P * Z_WORDS + X_WORDS;
  bf16* wr = hc + P * KC * HC_LD;  // [P][TILE][WR_LD] resident W, or one streamed step

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % L::WM, wn = warp / L::WM;
  const int m0 = blockIdx.x * TILE, kc0 = blockIdx.y * KC;
  const int n_tiles = (o.n + TILE - 1) / TILE;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);
  const bool resident = o.k <= KC;
  if (resident)
    stage_bf16<TILE, KC, WR_LD, WALK_UNROLL, VU, WP>(o, o.w, m0, 0, o.m, o.k, o.k, wr);

  float acc[L::TM][L::TN][4];
#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][u][c] = 0.f;

#pragma unroll 1
  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * TILE;
    stage_x<VEC>(o, m0, n0, xs);
    stage_bf16<KC, TILE, HC_LD, WALK_UNROLL, VU, HP>(o, o.h, kc0, n0, o.k, o.n, o.n, hc);
    float y[1][4][4] = {};
    if (resident) {
      __syncthreads();
      recon_resident<WR_LD, HC_LD, R >= 8 ? 1 : 2, WP, HP>(o, wr, hc, y);
    } else {
      recon_streamed<S3>(o, m0, n0, wr, y);
    }
    ratio_z<ZP>(o, y, xs, zs);
    __syncthreads();
    mma_panel<L::TM, L::TN, false, false, ZS_LD, HC_LD, true, 1, ZP, HP>(
        acc, zs + 16 * L::TM * wm * ZS_LD, hc + 8 * L::TN * wn * HC_LD, TILE);
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.z * o.m * o.k;
#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm = m0 + 16 * (L::TM * wm + t) + (lane >> 2) + 8 * (c >> 1);
        const int gk = kc0 + 8 * (L::TN * wn + u) + 2 * (lane & 3) + (c & 1);
        if (gm < o.m && gk < o.k) dst[(size_t)gm * o.k + gk] = acc[t][u][c];
      }
}

// The pass-1 kernels: BF16 and SPLIT3 run on the tensor cores, F32 and ANY
// on the SIMT units.  BF16 holds to two blocks an SM (128 registers), and
// F32 below KC = 256; at KC = 256 F32's resident block and W or H rows take
// 167 KiB of shared memory, one block an SM (so up to 255 registers), and
// SPLIT3's two planes ~174 KiB.  K1/K2 take ANY only under f32 GEMMs
// (update()): the bf16 rounding, constant off there, leaves the staging
// rules' RoundBf16 arms out of those instances.
template <int R, Mode MODE>
constexpr int MIN_BLOCKS = MODE == Mode::BF16 || (MODE == Mode::F32 && R < 16) ? 2 : 1;

template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    h_update_partial(Operands o, float* __restrict__ part, int tiles_per_split) {
  if constexpr (MODE == Mode::ANY) o.round_bf16 = 0;
  if constexpr (MODE == Mode::BF16 || MODE == Mode::SPLIT3)
    h_partial_mma<R, MODE == Mode::SPLIT3>(o, part, tiles_per_split);
  else
    h_partial_simt<R, MODE>(o, part, tiles_per_split);
}

template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    w_update_partial(Operands o, float* __restrict__ part, int tiles_per_split) {
  if constexpr (MODE == Mode::ANY) o.round_bf16 = 0;
  if constexpr (MODE == Mode::BF16 || MODE == Mode::SPLIT3)
    w_partial_mma<R, MODE == Mode::SPLIT3>(o, part, tiles_per_split);
  else
    w_partial_simt<R, MODE>(o, part, tiles_per_split);
}

// Pass 2 of K1 and K2: out = base * (sum_s part[s]) / denom, the sum taken
// in split order 0, 1, ... (fixed, so the bits never depend on scheduling).
// base and out are in the state dtype (out rounded to nearest even); denom
// is indexed by row (K1: sum_w[k] for out[k][n]) or by column (K2: sum_h[k]
// for out[m][k]).
__global__ void __launch_bounds__(THREADS)
    finalize(const void* __restrict__ base, int state_bf16,
             const float* __restrict__ part, const float* __restrict__ denom,
             void* __restrict__ out, int rows, int cols, int splits,
             int denom_by_row) {
  const size_t total = (size_t)rows * cols;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(size_t)s * total + idx];
    const float d = denom_by_row ? denom[idx / cols] : denom[idx % cols];
    // h * acc / sumw: fused_mu.py:277, 406
    const float b = state_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx])
                               : static_cast<const float*>(base)[idx];
    const float v = b * acc / d;
    if (state_bf16)
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[idx] = v;
  }
}

// Pass 2 of K1 and K2 in numerator_only mode: out = sum_s part[s] in f32,
// the same split-ordered sum finalize takes, with no epilogue
// (fused_mu.py:280-282, 408-409).  base and denom are not read.
__global__ void __launch_bounds__(THREADS)
    sum_splits(const float* __restrict__ part, float* __restrict__ out,
               size_t total, int splits) {
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(size_t)s * total + idx];
    out[idx] = acc;
  }
}

// Block-wide sum of one float per thread, in a fixed tree order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) red[threadIdx.x] += red[threadIdx.x + stride];
    __syncthreads();
  }
  return red[0];
}

// K3 pass 1: one f32 partial per 64 x 64 tile of the cost.  The recon is
// never split: true f32, or bf16-rounded inputs under bfloat16 (MODE is F32
// or ANY).
template <Mode MODE>
__global__ void __launch_bounds__(THREADS)
    kl_partial(Operands o, float* __restrict__ partials) {
  __shared__ float ws[KS * WS_STRIDE];
  __shared__ float hs[KS * TILE];
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  float s[4][4];
  recon_tile<MODE>(o, m0, n0, ws, hs, s);
  float t = 0.f;
  with_x<MODE>(o, [&](auto x) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm = m0 + ty + 16 * r, gn = n0 + tx + 16 * c;
        if (gm < o.m && gn < o.n) {  // padding adds nothing, not even +y
          const float xv = x((size_t)gm * o.n + gn, gn);
          const float y = clamp_eps(s[r][c], o.eps);
          const float xlog = xv > 0.f ? xv * (logf(xv) - logf(y)) : 0.f;
          t += xlog - xv + y;
        }
      }
  });
  const float sum = block_sum(t, red);
  if (tid == 0) partials[blockIdx.y * gridDim.x + blockIdx.x] = sum;
}

// K3 pass 2: one block sums the partials, strided then by tree: fixed order.
__global__ void __launch_bounds__(THREADS)
    kl_final(const float* __restrict__ partials, int count,
             float* __restrict__ out) {
  __shared__ float red[THREADS];
  float t = 0.f;
  for (int i = threadIdx.x; i < count; i += THREADS) t += partials[i];
  const float sum = block_sum(t, red);
  if (threadIdx.x == 0) out[0] = sum;
}

// Shared memory in f32 words, as bytes; BF16's and SPLIT3's in bf16 words
// (mma_tile.cuh): Z, X, the walking chunk, and the resident block or one
// streamed W H step, each but X in two planes under SPLIT3 (96 KiB at
// KC = 256: two blocks an SM; SPLIT3 174 KiB).
template <int R, Mode MODE>
size_t h_smem_bytes() {
  if constexpr (MODE == Mode::BF16 || MODE == Mode::SPLIT3) {
    constexpr bool S3 = MODE == Mode::SPLIT3;
    constexpr size_t P = S3 ? 2 : 1;
    return (P * Z_WORDS + X_WORDS + P * TILE * (16 * R + BPAD) +
            std::max<size_t>(P * 16 * R * HS_LD, STEP_BUF<S3>)) * sizeof(bf16);
  }
  return simt_smem_words<R>() * sizeof(float);
}

template <int R, Mode MODE>
size_t w_smem_bytes() {
  if constexpr (MODE == Mode::BF16 || MODE == Mode::SPLIT3) {
    constexpr bool S3 = MODE == Mode::SPLIT3;
    constexpr size_t P = S3 ? 2 : 1;
    return (P * Z_WORDS + X_WORDS + P * 16 * R * (TILE + BPAD) +
            std::max<size_t>(P * TILE * (16 * R + BPAD), STEP_BUF<S3>)) * sizeof(bf16);
  }
  return simt_smem_words<R>() * sizeof(float);
}

template <int R, Mode MODE>
cudaError_t launch_h(const Operands& o, float* part, int splits,
                     int tiles_per_split, cudaStream_t st) {
  const size_t smem = h_smem_bytes<R, MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      h_update_partial<R, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((o.n + TILE - 1) / TILE, (o.k + 16 * R - 1) / (16 * R), splits);
  h_update_partial<R, MODE><<<grid, THREADS, smem, st>>>(o, part, tiles_per_split);
  return cudaGetLastError();
}

template <int R, Mode MODE>
cudaError_t launch_w(const Operands& o, float* part, int splits,
                     int tiles_per_split, cudaStream_t st) {
  const size_t smem = w_smem_bytes<R, MODE>();
  cudaError_t err = cudaFuncSetAttribute(
      w_update_partial<R, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((o.m + TILE - 1) / TILE, (o.k + 16 * R - 1) / (16 * R), splits);
  w_update_partial<R, MODE><<<grid, THREADS, smem, st>>>(o, part, tiles_per_split);
  return cudaGetLastError();
}

// Pass-1 launches of K1 (0) and K2 (1) per Mode, counted on the host as
// each is launched: which instance a call ran (nmf_partial_launches).  The
// kernel names of a torch.profiler trace would say the same, but on the
// H100 a short trace lost its first kernels (PERF.md section 6).
constexpr int MODES = static_cast<int>(Mode::BF16) + 1;  // the last Mode
std::atomic<int> partial_launches[2][MODES];

// Pass 1 of K1 (H) or K2 (W) at chunk width kc.
template <bool H, Mode MODE>
cudaError_t launch_partial(int kc, const Operands& o, float* part, int splits,
                           int per, cudaStream_t st) {
  cudaError_t err;
  switch (kc) {
    case 16: err = H ? launch_h<1, MODE>(o, part, splits, per, st) : launch_w<1, MODE>(o, part, splits, per, st); break;
    case 32: err = H ? launch_h<2, MODE>(o, part, splits, per, st) : launch_w<2, MODE>(o, part, splits, per, st); break;
    case 64: err = H ? launch_h<4, MODE>(o, part, splits, per, st) : launch_w<4, MODE>(o, part, splits, per, st); break;
    case 128: err = H ? launch_h<8, MODE>(o, part, splits, per, st) : launch_w<8, MODE>(o, part, splits, per, st); break;
    case 256: err = H ? launch_h<16, MODE>(o, part, splits, per, st) : launch_w<16, MODE>(o, part, splits, per, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) ++partial_launches[H ? 0 : 1][static_cast<int>(MODE)];
  return err;
}

// Registers, dynamic shared memory (bytes), resident blocks an SM and
// local memory a thread (bytes: spills) of one pass-1 instance, as the
// runtime reports them (nmf_partial_info).
template <bool H, int R, Mode MODE>
cudaError_t partial_info(int* out) {
  const void* fn = H ? reinterpret_cast<const void*>(h_update_partial<R, MODE>)
                     : reinterpret_cast<const void*>(w_update_partial<R, MODE>);
  const size_t smem = H ? h_smem_bytes<R, MODE>() : w_smem_bytes<R, MODE>();
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

template <bool H, Mode MODE>
cudaError_t info_at(int kc, int* out) {
  switch (kc) {
    case 16: return partial_info<H, 1, MODE>(out);
    case 32: return partial_info<H, 2, MODE>(out);
    case 64: return partial_info<H, 4, MODE>(out);
    case 128: return partial_info<H, 8, MODE>(out);
    case 256: return partial_info<H, 16, MODE>(out);
    default: return cudaErrorInvalidValue;
  }
}

template <bool H>
cudaError_t info_of(int mode, int kc, int* out) {
  switch (mode) {
    case static_cast<int>(Mode::F32): return info_at<H, Mode::F32>(kc, out);
    case static_cast<int>(Mode::ANY): return info_at<H, Mode::ANY>(kc, out);
    case static_cast<int>(Mode::SPLIT3): return info_at<H, Mode::SPLIT3>(kc, out);
    case static_cast<int>(Mode::BF16): return info_at<H, Mode::BF16>(kc, out);
    default: return cudaErrorInvalidValue;
  }
}

// Blocks of a grid-stride pass over `total` elements.
unsigned pass_blocks(size_t total) {
  size_t blocks = (total + THREADS - 1) / THREADS;
  return (unsigned)(blocks > 65535 ? 65535 : blocks);  // the loop covers the rest
}

// Pass 2: the epilogue into the state dtype, or (numerator_only) the f32 sum.
cudaError_t launch_finalize(const void* base, int state_bf16, const float* part,
                            const float* denom, void* out, int rows, int cols,
                            int splits, int denom_by_row, int numerator_only,
                            cudaStream_t st) {
  const size_t total = (size_t)rows * cols;
  if (numerator_only)
    sum_splits<<<pass_blocks(total), THREADS, 0, st>>>(
        part, static_cast<float*>(out), total, splits);
  else
    finalize<<<pass_blocks(total), THREADS, 0, st>>>(base, state_bf16, part, denom,
                                                     out, rows, cols, splits,
                                                     denom_by_row);
  return cudaGetLastError();
}

template <bool H>
int update(const void* w, const void* h, const void* x, const float* scales,
           const float* denom, float* part, void* out, int m, int n, int k,
           int kc, int splits, int tiles_per_split, float eps, int state_bf16,
           int x_kind, int gemm, int numerator_only, int device, void* stream) {
  Operands o;
  cudaError_t err = make_operands(w, h, x, scales, m, n, k, state_bf16, x_kind,
                                  gemm, eps, &o);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gemm == GEMM_SPLIT3)
    err = launch_partial<H, Mode::SPLIT3>(kc, o, part, splits, tiles_per_split, st);
  else if (gemm == GEMM_BF16)  // every state dtype, X kind and numerator_only
    err = launch_partial<H, Mode::BF16>(kc, o, part, splits, tiles_per_split, st);
  else if (all_f32(o) && gemm == GEMM_F32)
    err = launch_partial<H, Mode::F32>(kc, o, part, splits, tiles_per_split, st);
  else
    err = launch_partial<H, Mode::ANY>(kc, o, part, splits, tiles_per_split, st);
  if (err != cudaSuccess) return err;
  return H ? launch_finalize(h, state_bf16, part, denom, out, k, n, splits, 1,
                            numerator_only, st)
           : launch_finalize(w, state_bf16, part, denom, out, m, k, splits, 0,
                             numerator_only, st);
}

}  // namespace

extern "C" {

// Tile edge and largest K chunk the launchers were compiled for; the Python
// planner checks them at load so the two sides cannot drift.
int nmf_tile() { return TILE; }
int nmf_max_chunk() { return 16 * 16; }

const char* nmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Pass-1 launches of K1 (h = 1) or K2 (h = 0) in Mode `mode` (its value in
// mu_tile.cuh) since the library loaded or the last reset; -1 for a Mode
// out of range.
int nmf_partial_launches(int h, int mode) {
  return mode < 0 || mode >= MODES ? -1 : partial_launches[h ? 0 : 1][mode].load();
}

// out[4] = registers, dynamic shared memory (bytes), resident blocks an
// SM, local memory a thread (bytes) of the pass-1 kernel of K1 (h = 1) or
// K2 (h = 0) in Mode `mode` at chunk width kc, on the current device.
int nmf_partial_info(int h, int mode, int kc, int* out) {
  return h ? info_of<true>(mode, kc, out) : info_of<false>(mode, kc, out);
}

void nmf_reset_partial_launches() {
  for (auto& row : partial_launches)
    for (auto& n : row) n = 0;
}

// K1.  w (m,k), h (k,n) in the state dtype; x (m,n) f32 | bf16 | uint8 with
// scales (n,); sum_w (k,) = max(colsum w, eps) in f32; part (splits,k,n)
// f32 scratch; out (k,n) state dtype.  kc in {16,32,64,128,256};
// state_bf16 0|1; x_kind 0 f32, 1 bf16, 2 uint8; gemm 0 float32,
// 1 float32_fast (split3), 2 bfloat16.  numerator_only 1: out (k,n) is f32
// and receives the numerator, sum_w is not read (may be null).
int nmf_h_update(const void* w, const void* h, const void* x,
                 const float* scales, const float* sum_w, float* part,
                 void* out, int m, int n, int k, int kc, int splits,
                 int tiles_per_split, float eps, int state_bf16, int x_kind,
                 int gemm, int numerator_only, int device, void* stream) {
  return update<true>(w, h, x, scales, sum_w, part, out, m, n, k, kc, splits,
                      tiles_per_split, eps, state_bf16, x_kind, gemm,
                      numerator_only, device, stream);
}

// K2.  sum_h (k,) = max(rowsum h, eps), part (splits,m,k), out (m,k); the
// rest as K1 (numerator_only: out (m,k) f32, sum_h not read).
int nmf_w_update(const void* w, const void* h, const void* x,
                 const float* scales, const float* sum_h, float* part,
                 void* out, int m, int n, int k, int kc, int splits,
                 int tiles_per_split, float eps, int state_bf16, int x_kind,
                 int gemm, int numerator_only, int device, void* stream) {
  return update<false>(w, h, x, scales, sum_h, part, out, m, n, k, kc, splits,
                       tiles_per_split, eps, state_bf16, x_kind, gemm,
                       numerator_only, device, stream);
}

// K3.  partials has one float per 64 x 64 tile; out is one float.  gemm as
// K1; split3 takes the true-f32 recon, as float32.
int nmf_kl_cost(const void* w, const void* h, const void* x,
                const float* scales, float* partials, float* out, int m, int n,
                int k, float eps, int state_bf16, int x_kind, int gemm,
                int device, void* stream) {
  Operands o;
  cudaError_t err = make_operands(w, h, x, scales, m, n, k, state_bf16, x_kind,
                                  gemm, eps, &o);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  if (all_f32(o) && !o.round_bf16)
    kl_partial<Mode::F32><<<grid, THREADS, 0, st>>>(o, partials);
  else
    kl_partial<Mode::ANY><<<grid, THREADS, 0, st>>>(o, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kl_final<<<1, THREADS, 0, st>>>(partials, (int)(grid.x * grid.y), out);
  return cudaGetLastError();
}

}  // extern "C"
