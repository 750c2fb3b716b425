// Tile-sparse numerator sweeps for Hopper (sm_90a), SIMT: kernel K5.
//
// This replaces the Pallas TPU kernel of nmf_tpu/ops/pallas/tile_sparse.py:
//
//   K5  nmf_h_sweep / nmf_w_sweep  <- _sweep_kernel (tile_sparse.py:122),
//       via h_numerator (:224) / w_numerator (:236)
//
// X is kept as its occupied bm x bn tiles (T, bm, bn); a sweep plan (perm,
// rb, cb), sorted by output block, lists them with one perm = -1 sentinel
// for each output block that has none (tile_sparse.sweep_plan).  For each
// plan entry, with W_r = W[rb * bm : +bm] and H_c = H[:, cb * bn : +bn]:
//
//   Y = W_r H_c,  Z = X_tile[perm] / max(Y, eps),
//   H target: W_r^T Z added into numerator block cb, out (K, Np)
//   W target: Z H_c^T added into numerator block rb, out (Mp, K)
//
// The output is the f32 numerator; the caller applies the update.
//
// Design.  The TPU kernel runs the plan as its grid, in order, carrying one
// output block in VMEM across the run of entries that share it.  Here one
// CUDA block owns one output sub-block -- for the H target (column block cb,
// a 64-column slice of it, a K chunk), for the W target (row block rb, a
// 64-row slice, a K chunk) -- finds its run in the sorted plan by binary
// search, and walks it in plan order, covering each tile in 64 x 64
// sub-tiles: Y into registers and Z into shared memory by K1/K2's own
// recon_tile and ratio_tile (mu_tile.cuh), then the contraction, as K1's and
// K2's pass 1 do over a contiguous run of tiles.  A run is contiguous and
// has one owner, so the sum order is fixed: no atomics and no second pass,
// and the same inputs give the same bits on every run.  A sentinel (or an
// entry outside the arrays) contributes nothing, so a block whose run holds
// only a sentinel writes zeros.
//
// Any tile shape: a 64 x 64 sub-tile that runs past the tile's bm or bn
// reads W rows / H columns of the neighbouring block for Y, but those
// positions take Y = 1 and X = 0, so Z = 0 exactly there, and the staged W
// rows / H columns past the tile are 0.
//
// What bounds it on this card.  Each occupied tile costs 4 bm bn K flop
// (two GEMMs) against bm bn 4 bytes of X (2 for bf16): compute-bound at
// any K worth solving, on the SIMT FMA units (~67 TFLOP/s f32 on an H100
// SXM at 700 W) in every mode, as K1/K2.  The launch is one block per output
// sub-block and K chunk: at 8192 x 8192, K = 128, 128 x 128 tiles, the H
// sweep runs 64 column blocks x 2 slices x 1 chunk = 128 blocks, about one
// per SM, and the longest run (9 tiles at occupancy 0.08, seed 0) sets its
// time.  Splitting long runs across blocks, tensor cores and TMA are later
// speed work.
//
// Modes, as K1/K2 have them (mu_tile.cuh): W and H f32 or bf16; tiles f32 or
// bf16 (per-tile uint8 codes take the plain sweep); GEMMs f32, split3 or
// bf16.  Every entry point launches on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include "mu_tile.cuh"

namespace {

// One sweep's plan.  key is the output block id of each entry (cb for the
// H target, rb for the W target), sorted; other is the remaining id.
struct Plan {
  const int* perm;   // (steps,) tile index, -1 for a sentinel
  const int* key;    // (steps,)
  const int* other;  // (steps,)
  int steps;
  int n_tiles;       // T
  int n_other;       // blocks along the other axis: mb (H target), nb (W)
  int bm, bn;
};

// First t in [0, steps) with key[t] >= b.
__device__ __forceinline__ int lower_bound(const int* key, int steps, int b) {
  int lo = 0, hi = steps;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key[mid] < b) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Whether entry t contributes: a real tile, with the other block id inside
// the grid (a sentinel, or a plan not from sweep_plan, reads nothing).
__device__ __forceinline__ bool live(const Plan& pl, int t, int* p, int* other) {
  *p = pl.perm[t];
  *other = pl.other[t];
  return *p >= 0 && *p < pl.n_tiles && *other >= 0 && *other < pl.n_other;
}

// s := 1 where the 64 x 64 sub-tile lies outside the tile (rows >= rows_left
// or columns >= cols_left), so that Z = 0 / 1 = 0 there exactly.
__device__ __forceinline__ void outside_to_one(float s[4][4], int rows_left,
                                               int cols_left) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (ty + 16 * r >= rows_left || tx + 16 * c >= cols_left) s[r][c] = 1.f;
}

// The X operand of ratio_tile for rows i0.. of tile p: its rows masked at
// bm - i0 and its columns at bn (the tile's stride), so that
// ratio_tile(tile_rows(...), 0, j0, ...) reads X[p][i0 + i][j0 + j] inside
// the tile and 0 outside.
__device__ __forceinline__ Operands tile_rows(const Operands& o, const Plan& pl,
                                              int p, int i0) {
  Operands t = o;
  const size_t off = ((size_t)p * pl.bm + i0) * pl.bn;
  t.x = static_cast<const char*>(o.x) + off * (o.x_kind == X_BF16 ? 2 : 4);
  t.m = pl.bm - i0;
  t.n = pl.bn;
  return t;
}

// H target.  Block (cb * slices + slice, k chunk): acc[kk][j] +=
// sum_i W[r0 + i, kc0 + kk] * Z[i, j] over the run of cb, then written to
// out[k][cb * bn + j0 + j].  o holds W (Mp, K), H (K, Np) and the tiles.
template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS)
    sweep_h(Operands o, Plan pl, float* __restrict__ out) {
  using T = StagedT<MODE>;
  constexpr bool S3 = MODE == Mode::SPLIT3;
  constexpr int KC = 16 * R;
  extern __shared__ float4 smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* hs = ws + KS * WS_STRIDE;
  T* zs = hs + KS * TILE;
  T* wc = zs + TILE * (TILE + 1);  // [TILE][KC]: the tile's W rows, this k chunk

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int slices = (pl.bn + TILE - 1) / TILE;
  const int cb = blockIdx.x / slices, j0 = (blockIdx.x % slices) * TILE;
  const int n0 = cb * pl.bn + j0, kc0 = blockIdx.y * KC;
  const int t_end = lower_bound(pl.key, pl.steps, cb + 1);

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  for (int t = lower_bound(pl.key, pl.steps, cb); t < t_end; ++t) {
    int p, rb;
    if (!live(pl, t, &p, &rb)) continue;
    for (int i0 = 0; i0 < pl.bm; i0 += TILE) {
      const int m0 = rb * pl.bm + i0, rows = min(TILE, pl.bm - i0);
      float s[4][4];
      recon_tile<MODE>(o, m0, n0, ws, hs, s);
      outside_to_one(s, rows, pl.bn - j0);
      ratio_tile<MODE>(tile_rows(o, pl, p, i0), 0, j0, s, zs);
      with_state<MODE>(o.w, o, [&](auto w, auto rule) {
        for (int e = tid; e < TILE * KC; e += THREADS) {
          const int i = e / KC, kk = e % KC;
          const int gk = kc0 + kk;
          wc[e] = rule((i < rows && gk < o.k) ? w((size_t)(m0 + i) * o.k + gk) : 0.f);
        }
      });
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < TILE; ++i) {
        Val<S3> a[R], b[4];
#pragma unroll
        for (int r = 0; r < R; ++r) a[r].load(wc[i * KC + ty + 16 * r]);
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c].load(zs[i * (TILE + 1) + tx + 16 * c]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = mac(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gk = kc0 + ty + 16 * r, j = j0 + tx + 16 * c;
      if (gk < o.k && j < pl.bn) out[(size_t)gk * o.n + cb * pl.bn + j] = acc[r][c];
    }
}

// W target.  Block (rb * slices + slice, k chunk): acc[i][kk] +=
// sum_j Z[i, j] * H[kc0 + kk, c0 + j] over the run of rb, then written to
// out[rb * bm + i0 + i][k].  hc holds the H chunk transposed ([TILE][KC + 1]).
template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS)
    sweep_w(Operands o, Plan pl, float* __restrict__ out) {
  using T = StagedT<MODE>;
  constexpr bool S3 = MODE == Mode::SPLIT3;
  constexpr int KC = 16 * R;
  extern __shared__ float4 smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);
  T* hs = ws + KS * WS_STRIDE;
  T* zs = hs + KS * TILE;
  T* hc = zs + TILE * (TILE + 1);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int slices = (pl.bm + TILE - 1) / TILE;
  const int rb = blockIdx.x / slices, i0 = (blockIdx.x % slices) * TILE;
  const int m0 = rb * pl.bm + i0, rows = min(TILE, pl.bm - i0);
  const int kc0 = blockIdx.y * KC;
  const int t_end = lower_bound(pl.key, pl.steps, rb + 1);

  float acc[4][R];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;

  for (int t = lower_bound(pl.key, pl.steps, rb); t < t_end; ++t) {
    int p, cb;
    if (!live(pl, t, &p, &cb)) continue;
    for (int j0 = 0; j0 < pl.bn; j0 += TILE) {
      const int n0 = cb * pl.bn + j0, cols = min(TILE, pl.bn - j0);
      float s[4][4];
      recon_tile<MODE>(o, m0, n0, ws, hs, s);
      outside_to_one(s, rows, cols);
      ratio_tile<MODE>(tile_rows(o, pl, p, i0), 0, j0, s, zs);
      with_state<MODE>(o.h, o, [&](auto h, auto rule) {
        for (int e = tid; e < KC * TILE; e += THREADS) {
          const int kk = e / TILE, j = e % TILE;  // neighbours along n
          const int gk = kc0 + kk;
          hc[j * (KC + 1) + kk] =
              rule((gk < o.k && j < cols) ? h((size_t)gk * o.n + n0 + j) : 0.f);
        }
      });
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        Val<S3> a[4], b[R];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r].load(zs[(ty + 16 * r) * (TILE + 1) + j]);
#pragma unroll
        for (int c = 0; c < R; ++c) b[c].load(hc[j * (KC + 1) + tx + 16 * c]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < R; ++c) acc[r][c] = mac(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int i = ty + 16 * r, gk = kc0 + tx + 16 * c;
      if (i < rows && gk < o.k) out[(size_t)(m0 + i) * o.k + gk] = acc[r][c];
    }
}

template <bool H, int R, Mode MODE>
cudaError_t launch_sweep(const Operands& o, const Plan& pl, float* out,
                         cudaStream_t st) {
  // K1's and K2's shared memory: the staging plus the W chunk ([TILE][KC])
  // or the transposed H chunk ([TILE][KC + 1]), in 4-byte words
  const size_t words = staging_words() + (size_t)TILE * (16 * R + (H ? 0 : 1));
  const size_t smem = words * sizeof(float);
  auto kernel = H ? sweep_h<R, MODE> : sweep_w<R, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_out = H ? o.n / pl.bn : o.m / pl.bm;
  const int slices = ((H ? pl.bn : pl.bm) + TILE - 1) / TILE;
  const dim3 grid(n_out * slices, (o.k + 16 * R - 1) / (16 * R));
  kernel<<<grid, THREADS, smem, st>>>(o, pl, out);
  return cudaGetLastError();
}

template <bool H, Mode MODE>
cudaError_t launch_width(int kc, const Operands& o, const Plan& pl, float* out,
                         cudaStream_t st) {
  switch (kc) {
    case 16: return launch_sweep<H, 1, MODE>(o, pl, out, st);
    case 32: return launch_sweep<H, 2, MODE>(o, pl, out, st);
    case 64: return launch_sweep<H, 4, MODE>(o, pl, out, st);
    case 128: return launch_sweep<H, 8, MODE>(o, pl, out, st);
    case 256: return launch_sweep<H, 16, MODE>(o, pl, out, st);
    default: return cudaErrorInvalidValue;
  }
}

template <bool H>
int sweep(const void* w, const void* h, const void* tiles, const int* perm,
          const int* rb, const int* cb, float* out, int mp, int np, int k,
          int bm, int bn, int n_tiles, int steps, int kc, float eps,
          int state_bf16, int x_kind, int gemm, int device, void* stream) {
  if (x_kind == X_U8 || bm < 1 || bn < 1 || mp % bm || np % bn)
    return cudaErrorInvalidValue;
  Operands o;
  cudaError_t err = make_operands(w, h, tiles, nullptr, mp, np, k, state_bf16,
                                  x_kind, gemm, eps, &o);
  if (err != cudaSuccess) return err;
  const Plan pl{perm, H ? cb : rb, H ? rb : cb, steps, n_tiles,
                H ? mp / bm : np / bn, bm, bn};
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gemm == GEMM_SPLIT3) return launch_width<H, Mode::SPLIT3>(kc, o, pl, out, st);
  if (all_f32(o) && gemm == GEMM_F32) return launch_width<H, Mode::F32>(kc, o, pl, out, st);
  return launch_width<H, Mode::ANY>(kc, o, pl, out, st);
}

}  // namespace

extern "C" {

// K5, H target.  w (mp,k), h (k,np) in the state dtype, mp and np multiples
// of bm and bn; tiles (n_tiles,bm,bn) f32 | bf16 (x_kind 0 | 1); perm, rb, cb
// (steps,) int32, a sweep plan sorted by cb; out (k,np) f32.  kc, state_bf16
// and gemm as nmf_h_update.
int nmf_h_sweep(const void* w, const void* h, const void* tiles, const int* perm,
                const int* rb, const int* cb, float* out, int mp, int np, int k,
                int bm, int bn, int n_tiles, int steps, int kc, float eps,
                int state_bf16, int x_kind, int gemm, int device, void* stream) {
  return sweep<true>(w, h, tiles, perm, rb, cb, out, mp, np, k, bm, bn, n_tiles,
                     steps, kc, eps, state_bf16, x_kind, gemm, device, stream);
}

// K5, W target: the plan sorted by rb; out (mp,k) f32; the rest as above.
int nmf_w_sweep(const void* w, const void* h, const void* tiles, const int* perm,
                const int* rb, const int* cb, float* out, int mp, int np, int k,
                int bm, int bn, int n_tiles, int steps, int kc, float eps,
                int state_bf16, int x_kind, int gemm, int device, void* stream) {
  return sweep<false>(w, h, tiles, perm, rb, cb, out, mp, np, k, bm, bn, n_tiles,
                      steps, kc, eps, state_bf16, x_kind, gemm, device, stream);
}

}  // extern "C"
