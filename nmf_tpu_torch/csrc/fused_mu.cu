// Fused KL multiplicative-update kernels for Hopper (sm_90a), true f32 SIMT.
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
// What they keep out of device memory: the M x N reconstruction W H and the
// quotient Z = X / max(W H, eps).  Each block recomputes its 64 x 64 tile of
// W H in registers, forms Z in shared memory and contracts it at once, so X
// is the only M x N stream (read once per kernel).
//
// What bounds them on this card.  One half-update costs ~4 M N K flop (two
// GEMMs) against ~4 M N bytes of X, so at K >= 30 it is compute-bound; in
// true f32 there are no tensor cores (TF32 is not f32), so the ceiling is
// the SIMT FMA rate (~67 TFLOP/s on an H100 SXM at 700 W).  This first
// version is simple and right rather than fast: 4 x 4 (phase A) and 4 x R
// (phase B) register tiles fed from shared memory, no cp.async/TMA.
//
// Design against the TPU kernel.  Pallas runs its grid in order and carries
// the K x bn (or bm x K) accumulator across the innermost grid axis.  CUDA
// blocks run in no order, so a block walks its share of the contraction
// axis in a loop instead.  At the reference shape N is only 350 (6 column
// tiles), so that axis is also split across a fixed number of blocks; each
// writes an f32 partial and a second pass sums the partials IN A FIXED ORDER
// and applies the epilogue.  No float atomics anywhere: the same inputs give
// the same bits on every run.  The split count comes from the shape alone
// (the Python planner), never from the card.
//
// Numerics, as the reference kernels have them: the clamp is `v < eps ? eps
// : v` so NaN stays NaN (fmaxf would return eps); eps arrives as a C float
// (float32(2.2204e-16)); the epilogue is h * acc / sum (the TPU kernel's
// order, fused_mu.py:277, 406); the log is the accurate logf (no fast math);
// the cost masks the ragged edge by logical (m, n) so padding adds nothing.
//
// Every entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE = 64;      // BM = BN: one block's output/recon tile edge
constexpr int KS = 16;        // K slice staged per phase-A step
constexpr int THREADS = 256;  // 16 x 16; tx = tid % 16, ty = tid / 16
constexpr int WS_STRIDE = TILE + 1;  // padded transposed W slice

__device__ __forceinline__ float clamp_eps(float v, float eps) {
  return v < eps ? eps : v;  // keeps NaN, like the reference's `a < EPS`
}

// Phase A: s[r][c] = sum_k W[m0 + ty + 16 r, k] * H[k, n0 + tx + 16 c] over
// all k < K, out-of-range rows, columns and k read as 0.  ws holds the
// W slice transposed ([KS][TILE + 1]), hs the H slice ([KS][TILE]).
__device__ __forceinline__ void recon_tile(
    const float* __restrict__ w, const float* __restrict__ h, int m, int n,
    int k, int m0, int n0, float* ws, float* hs, float s[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
  for (int k0 = 0; k0 < k; k0 += KS) {
    for (int e = tid; e < TILE * KS; e += THREADS) {
      const int i = e / KS, kk = e % KS;  // neighbours along k: coalesced
      const int gm = m0 + i, gk = k0 + kk;
      ws[kk * WS_STRIDE + i] =
          (gm < m && gk < k) ? w[(size_t)gm * k + gk] : 0.f;
    }
    for (int e = tid; e < KS * TILE; e += THREADS) {
      const int kk = e / TILE, j = e % TILE;  // neighbours along n
      const int gk = k0 + kk, gn = n0 + j;
      hs[kk * TILE + j] = (gk < k && gn < n) ? h[(size_t)gk * n + gn] : 0.f;
    }
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

// Z = X / clamp(W H) for the tile into zs ([TILE][TILE + 1]).  Positions
// outside (m, n) hold X = 0 and W H = 0, so Z = 0 / eps = 0 there exactly.
__device__ __forceinline__ void ratio_tile(const float* __restrict__ x, int m,
                                           int n, int m0, int n0,
                                           const float s[4][4], float eps,
                                           float* zs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = ty + 16 * r, j = tx + 16 * c;
      const int gm = m0 + i, gn = n0 + j;
      const float xv = (gm < m && gn < n) ? x[(size_t)gm * n + gn] : 0.f;
      zs[i * (TILE + 1) + j] = xv / clamp_eps(s[r][c], eps);
    }
}

constexpr size_t staging_floats() {
  return (size_t)KS * WS_STRIDE + (size_t)KS * TILE + (size_t)TILE * (TILE + 1);
}

// K1 pass 1.  Block (n tile, k chunk, split): for its run of M tiles,
// acc[kk][j] += sum_i W[m0 + i, kc0 + kk] * Z[i, j], then the raw partial
// goes to part[split][k][n].  R = KC / 16 accumulator rows per thread.
template <int R>
__global__ void __launch_bounds__(THREADS)
    h_update_partial(const float* __restrict__ w, const float* __restrict__ h,
                     const float* __restrict__ x, float* __restrict__ part,
                     int m, int n, int k, int tiles_per_split, float eps) {
  constexpr int KC = 16 * R;
  extern __shared__ float smem[];
  float* ws = smem;
  float* hs = ws + KS * WS_STRIDE;
  float* zs = hs + KS * TILE;
  float* wc = zs + TILE * (TILE + 1);  // [TILE][KC]: W rows, this k chunk

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TILE, kc0 = blockIdx.y * KC;
  const int m_tiles = (m + TILE - 1) / TILE;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, m_tiles);

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int m0 = t * TILE;
    float s[4][4];
    recon_tile(w, h, m, n, k, m0, n0, ws, hs, s);
    ratio_tile(x, m, n, m0, n0, s, eps, zs);
    for (int e = tid; e < TILE * KC; e += THREADS) {
      const int i = e / KC, kk = e % KC;
      const int gm = m0 + i, gk = kc0 + kk;
      wc[e] = (gm < m && gk < k) ? w[(size_t)gm * k + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < TILE; ++i) {
      float a[R], b[4];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = wc[i * KC + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = zs[i * (TILE + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.z * k * n;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gk = kc0 + ty + 16 * r, gn = n0 + tx + 16 * c;
      if (gk < k && gn < n) dst[(size_t)gk * n + gn] = acc[r][c];
    }
}

// K2 pass 1.  Block (m tile, k chunk, split): for its run of N tiles,
// acc[i][kk] += sum_j Z[i, j] * H[kc0 + kk, n0 + j], partial to
// part[split][m][k].  hc holds the H chunk transposed ([TILE][KC + 1]).
template <int R>
__global__ void __launch_bounds__(THREADS)
    w_update_partial(const float* __restrict__ w, const float* __restrict__ h,
                     const float* __restrict__ x, float* __restrict__ part,
                     int m, int n, int k, int tiles_per_split, float eps) {
  constexpr int KC = 16 * R;
  extern __shared__ float smem[];
  float* ws = smem;
  float* hs = ws + KS * WS_STRIDE;
  float* zs = hs + KS * TILE;
  float* hc = zs + TILE * (TILE + 1);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * TILE, kc0 = blockIdx.y * KC;
  const int n_tiles = (n + TILE - 1) / TILE;
  const int t_begin = blockIdx.z * tiles_per_split;
  const int t_end = min(t_begin + tiles_per_split, n_tiles);

  float acc[4][R];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int n0 = t * TILE;
    float s[4][4];
    recon_tile(w, h, m, n, k, m0, n0, ws, hs, s);
    ratio_tile(x, m, n, m0, n0, s, eps, zs);
    for (int e = tid; e < KC * TILE; e += THREADS) {
      const int kk = e / TILE, j = e % TILE;  // neighbours along n
      const int gk = kc0 + kk, gn = n0 + j;
      hc[j * (KC + 1) + kk] = (gk < k && gn < n) ? h[(size_t)gk * n + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < TILE; ++j) {
      float a[4], b[R];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = zs[(ty + 16 * r) * (TILE + 1) + j];
#pragma unroll
      for (int c = 0; c < R; ++c) b[c] = hc[j * (KC + 1) + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* dst = part + (size_t)blockIdx.z * m * k;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int gm = m0 + ty + 16 * r, gk = kc0 + tx + 16 * c;
      if (gm < m && gk < k) dst[(size_t)gm * k + gk] = acc[r][c];
    }
}

// Pass 2 of K1 and K2: out = base * (sum_s part[s]) / denom, the sum taken
// in split order 0, 1, ... (fixed, so the bits never depend on scheduling).
// denom is indexed by row (K1: sum_w[k] for out[k][n]) or by column (K2:
// sum_h[k] for out[m][k]).
__global__ void __launch_bounds__(THREADS)
    finalize(const float* __restrict__ base, const float* __restrict__ part,
             const float* __restrict__ denom, float* __restrict__ out,
             int rows, int cols, int splits, int denom_by_row) {
  const size_t total = (size_t)rows * cols;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(size_t)s * total + idx];
    const float d = denom_by_row ? denom[idx / cols] : denom[idx % cols];
    out[idx] = base[idx] * acc / d;  // h * acc / sumw: fused_mu.py:277, 406
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

// K3 pass 1: one f32 partial per 64 x 64 tile of the cost.
__global__ void __launch_bounds__(THREADS)
    kl_partial(const float* __restrict__ w, const float* __restrict__ h,
               const float* __restrict__ x, float* __restrict__ partials,
               int m, int n, int k, float eps) {
  __shared__ float ws[KS * WS_STRIDE];
  __shared__ float hs[KS * TILE];
  __shared__ float red[THREADS];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  float s[4][4];
  recon_tile(w, h, m, n, k, m0, n0, ws, hs, s);
  float t = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gm = m0 + ty + 16 * r, gn = n0 + tx + 16 * c;
      if (gm < m && gn < n) {  // padding adds nothing, not even +y
        const float xv = x[(size_t)gm * n + gn];
        const float y = clamp_eps(s[r][c], eps);
        const float xlog = xv > 0.f ? xv * (logf(xv) - logf(y)) : 0.f;
        t += xlog - xv + y;
      }
    }
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

template <int R>
size_t h_smem_bytes() {
  return (staging_floats() + (size_t)TILE * 16 * R) * sizeof(float);
}

template <int R>
size_t w_smem_bytes() {
  return (staging_floats() + (size_t)TILE * (16 * R + 1)) * sizeof(float);
}

template <int R>
cudaError_t launch_h(const float* w, const float* h, const float* x,
                     float* part, int m, int n, int k, int splits,
                     int tiles_per_split, float eps, cudaStream_t st) {
  const size_t smem = h_smem_bytes<R>();
  cudaError_t err = cudaFuncSetAttribute(
      h_update_partial<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + TILE - 1) / TILE, (k + 16 * R - 1) / (16 * R), splits);
  h_update_partial<R><<<grid, THREADS, smem, st>>>(w, h, x, part, m, n, k,
                                                   tiles_per_split, eps);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_w(const float* w, const float* h, const float* x,
                     float* part, int m, int n, int k, int splits,
                     int tiles_per_split, float eps, cudaStream_t st) {
  const size_t smem = w_smem_bytes<R>();
  cudaError_t err = cudaFuncSetAttribute(
      w_update_partial<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((m + TILE - 1) / TILE, (k + 16 * R - 1) / (16 * R), splits);
  w_update_partial<R><<<grid, THREADS, smem, st>>>(w, h, x, part, m, n, k,
                                                   tiles_per_split, eps);
  return cudaGetLastError();
}

cudaError_t launch_finalize(const float* base, const float* part,
                            const float* denom, float* out, int rows, int cols,
                            int splits, int denom_by_row, cudaStream_t st) {
  const size_t total = (size_t)rows * cols;
  size_t blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  finalize<<<(unsigned)blocks, THREADS, 0, st>>>(base, part, denom, out, rows,
                                                 cols, splits, denom_by_row);
  return cudaGetLastError();
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

// K1.  w (m,k), h (k,n), x (m,n), sum_w (k,) = max(colsum w, eps),
// part (splits,k,n) scratch, out (k,n).  kc in {16,32,64,128,256}.
int nmf_h_update(const float* w, const float* h, const float* x,
                 const float* sum_w, float* part, float* out, int m, int n,
                 int k, int kc, int splits, int tiles_per_split, float eps,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 16: err = launch_h<1>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 32: err = launch_h<2>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 64: err = launch_h<4>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 128: err = launch_h<8>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 256: err = launch_h<16>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_finalize(h, part, sum_w, out, k, n, splits, 1, st);
}

// K2.  sum_h (k,) = max(rowsum h, eps), part (splits,m,k), out (m,k).
int nmf_w_update(const float* w, const float* h, const float* x,
                 const float* sum_h, float* part, float* out, int m, int n,
                 int k, int kc, int splits, int tiles_per_split, float eps,
                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 16: err = launch_w<1>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 32: err = launch_w<2>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 64: err = launch_w<4>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 128: err = launch_w<8>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    case 256: err = launch_w<16>(w, h, x, part, m, n, k, splits, tiles_per_split, eps, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_finalize(w, part, sum_h, out, m, k, splits, 0, st);
}

// K3.  partials has one float per 64 x 64 tile; out is one float.
int nmf_kl_cost(const float* w, const float* h, const float* x,
                float* partials, float* out, int m, int n, int k, float eps,
                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
  kl_partial<<<grid, THREADS, 0, st>>>(w, h, x, partials, m, n, k, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kl_final<<<1, THREADS, 0, st>>>(partials, (int)(grid.x * grid.y), out);
  return cudaGetLastError();
}

}  // extern "C"
