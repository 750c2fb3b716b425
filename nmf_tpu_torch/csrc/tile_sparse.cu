// Tile-sparse numerator sweeps for Hopper (sm_90a): kernel K5.
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
// What bounds it on this card.  Each occupied tile costs 4 bm bn K flop
// (two GEMMs) against bm bn 4 bytes of X (2 for bf16): under float32 the
// SIMT FMA units bound it (~67 TFLOP/s on an H100 SXM at 700 W); under
// bfloat16 and float32_fast, on the tensor cores, the bytes do at K = 128.
//
// Design.  A plan entry's work is one step of K1's (H target) or K2's (W
// target) pass 1 per 64-row or 64-column sub-tile, so K5 runs that pass 1
// (pass1.cuh: the tensor cores under bfloat16 and float32_fast, the SIMT
// body with cp.async staging under float32) over a plan walk instead of a
// dense one.  The TPU kernel carries one output block across its run of
// entries in order; here the runs are cut into pieces spread over blocks:
//
//   pass 1  the plan is cut into chunks of `per` consecutive entries, and
//           each chunk again where the output block changes.  A piece that
//           starts a chunk takes the chunk's slot; one that starts a run
//           inside a chunk takes slot n_chunks + its output block: at most
//           n_chunks + n_out slots, found on the card from the sorted plan
//           by binary search.  One block per (slot, 64-wide slice of the
//           output block, k chunk) walks its piece in plan order and writes
//           its raw f32 partial, (K, bn) or (bm, K), to its slot; a slot
//           with no piece launches a block that exits at once;
//   pass 2  sums each output block's pieces in plan order into the output
//           (a run that is one sentinel, or none, gives exact zeros).
//
// No atomics: the same inputs give the same bits on every run.  The
// wrapper picks `per` from sizes it knows without reading the plan (steps,
// the slices, the k chunks), so the launch never waits on the card.  A
// sentinel, or an entry outside the arrays, is a step of zeros (W rows and
// X staged as 0: Z = 0 / eps = 0 exactly), so it adds exact zeros.  Any
// tile shape: a sub-tile past the tile's bm or bn stages W rows, H columns
// and X as 0 from the tile's edge on, and writes nothing there.
//
// Modes, as K1/K2 have them (mu_tile.cuh, pass1.cuh): Mode::BF16 under
// bfloat16 and Mode::SPLIT3 under float32_fast (tensor cores, every state
// dtype and tile storage), Mode::F32 for f32 state and tiles under float32,
// Mode::ANY for bf16 state or tiles under float32 (per-tile uint8 codes
// take the plain sweep).  Every entry point launches on the caller's
// stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError().

#include <atomic>

#include "pass1.cuh"

namespace {

// One sweep's plan and how it is cut.  key is the output block id of each
// entry (cb for the H target, rb for the W target), sorted; other is the
// remaining id.
struct Plan {
  const int* perm;   // (steps,) tile index, -1 for a sentinel
  const int* key;    // (steps,)
  const int* other;  // (steps,)
  int steps;
  int n_tiles;       // T
  int n_out;         // output blocks: nb (H target), mb (W)
  int n_other;       // blocks along the other axis: mb (H target), nb (W)
  int bm, bn;
  int per;           // plan entries a chunk
  int n_chunks;      // ceil(steps / per)
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

// The piece of slot `slot`: entries [*e0, *e1), all of output block *b;
// false where the slot holds none (a run that starts on a chunk's start
// has no slot of its own) or its block lies outside the output.
__device__ __forceinline__ bool piece_of(const Plan& pl, int slot, int* e0, int* e1, int* b) {
  int start;
  if (slot < pl.n_chunks) {
    start = slot * pl.per;
  } else {
    start = lower_bound(pl.key, pl.steps, slot - pl.n_chunks);
    if (start >= pl.steps || pl.key[start] != slot - pl.n_chunks || start % pl.per == 0)
      return false;
  }
  *b = pl.key[start];
  if (*b < 0 || *b >= pl.n_out) return false;
  const int chunk_end = min((start / pl.per + 1) * pl.per, pl.steps);
  *e0 = start;
  *e1 = max(start + 1, min(lower_bound(pl.key, pl.steps, *b + 1), chunk_end));
  return true;
}

// K5's walk (pass1.cuh): the sub-tiles of a piece's entries in plan order,
// ceil(bm / 64) of them an entry for the H target (rows i0 of the tile,
// the block's 64 columns j0), ceil(bn / 64) for the W target (columns j0,
// the block's rows i0).  The resident operand is output block b's H
// columns (H target) or W rows (W target) of the block's slice, clipped at
// the block's edge; the partial is the slot's (K, bn) or (bm, K).
template <bool H>
struct PlanWalk {
  const int* perm;
  const int* other;
  const char* tiles;
  int x_bytes, n_tiles, n_other, bm, bn;
  int e0, subs, count, slice0;  // slice0: j0 (H target) or i0 (W target)
  int res0, res_lim;
  float* out;
  int ld, out0, out_lim;

  __device__ PlanWalk(const Operands& o, const Plan& pl, float* part, int slot, int e0_, int e1,
                      int b, int slice)
      : perm(pl.perm), other(pl.other), tiles(static_cast<const char*>(o.x)),
        x_bytes(o.x_kind == X_BF16 ? 2 : 4), n_tiles(pl.n_tiles), n_other(pl.n_other),
        bm(pl.bm), bn(pl.bn), e0(e0_) {
    subs = ((H ? bm : bn) + TILE - 1) / TILE;
    count = (e1 - e0_) * subs;
    slice0 = out0 = slice * TILE;
    const int edge = H ? bn : bm;
    res0 = b * edge + slice0;
    res_lim = b * edge + edge;
    out = part + (size_t)slot * o.k * edge;
    ld = bn;
    out_lim = edge;
  }
  __device__ int steps() const { return count; }
  __device__ WalkStep step(int t) const {
    const int e = e0 + t / subs, w0 = (t % subs) * TILE;
    const int p = perm[e], ob = other[e];
    if (p < 0 || p >= n_tiles || ob < 0 || ob >= n_other)
      return {0, 0, {tiles, bn, 0, 0, 0, 0}};  // a step of zeros
    const char* x = tiles + (size_t)p * bm * bn * x_bytes;
    if constexpr (H)
      return {ob * bm + w0, ob * bm + bm, {x, bn, w0, slice0, bm, bn}};
    else
      return {ob * bn + w0, ob * bn + bn, {x, bn, slice0, w0, bm, bn}};
  }
};

// Pass 1: block (slot * slices + slice, k chunk), K1's body (H target) or
// K2's (W target) over the slot's piece.
template <bool H, int R, Mode MODE>
__device__ __forceinline__ void sweep_partial(const Operands& o, const Plan& pl, float* part) {
  const int slices = ((H ? pl.bn : pl.bm) + TILE - 1) / TILE;
  const int slot = blockIdx.x / slices;
  int e0, e1, b;
  if (!piece_of(pl, slot, &e0, &e1, &b)) return;
  pass1<H, R, MODE>(o, PlanWalk<H>(o, pl, part, slot, e0, e1, b, blockIdx.x % slices));
}

template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    h_sweep_partial(Operands o, Plan pl, float* __restrict__ part) {
  sweep_partial<true, R, MODE>(o, pl, part);
}

template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    w_sweep_partial(Operands o, Plan pl, float* __restrict__ part) {
  sweep_partial<false, R, MODE>(o, pl, part);
}

// Pass 2: block (output block b, a share of its elements).  Each element
// of the block's numerator is the sum of its pieces' partials in plan
// order: the run's first piece (a chunk's slot, or b's own), then each
// chunk that starts inside the run.  out (K, Np) for the H target, (Mp, K)
// for the W target.
template <bool H>
__global__ void __launch_bounds__(THREADS)
    sweep_sum(Plan pl, const float* __restrict__ part, float* __restrict__ out, int k, int np) {
  const int b = blockIdx.x;
  const int t0 = lower_bound(pl.key, pl.steps, b), t1 = lower_bound(pl.key, pl.steps, b + 1);
  const bool zero = t1 <= t0 || (t1 - t0 == 1 && pl.perm[t0] < 0);
  const int first = t0 % pl.per == 0 ? t0 / pl.per : pl.n_chunks + b;
  const int c_last = (t1 - 1) / pl.per;
  const int edge = H ? pl.bn : pl.bm;
  const size_t block = (size_t)k * edge;
  for (size_t e = (size_t)blockIdx.y * THREADS + threadIdx.x; e < block;
       e += (size_t)gridDim.y * THREADS) {
    float acc = 0.f;
    if (!zero) {
      acc += part[(size_t)first * block + e];
      for (int c = t0 / pl.per + 1; c <= c_last; ++c) acc += part[(size_t)c * block + e];
    }
    if constexpr (H)
      out[(e / edge) * np + (size_t)b * edge + e % edge] = acc;
    else
      out[(size_t)b * block + e] = acc;
  }
}

template <bool H, int R, Mode MODE>
auto sweep_kernel() {
  return H ? h_sweep_partial<R, MODE> : w_sweep_partial<R, MODE>;
}

// Pass-1 launches of K5's H (0) and W (1) targets per Mode, counted on the
// host as each is launched (nmf_sweep_launches), as K1/K2's.
std::atomic<int> sweep_launches[2][MODES];

template <bool H, Mode MODE>
cudaError_t launch_sweep(int kc, const Operands& o, const Plan& pl, float* part, int slices,
                         cudaStream_t st) {
  cudaError_t err = at_width(kc, [&](auto r) {
    constexpr int R = decltype(r)::value;
    constexpr size_t smem = pass1_smem_bytes<H, R, MODE>();
    auto kernel = sweep_kernel<H, R, MODE>();
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((pl.n_chunks + pl.n_out) * slices, (o.k + 16 * R - 1) / (16 * R));
    kernel<<<grid, THREADS, smem, st>>>(o, pl, part);
    return cudaGetLastError();
  });
  if (err == cudaSuccess) ++sweep_launches[H ? 0 : 1][static_cast<int>(MODE)];
  return err;
}

template <bool H>
cudaError_t sweep_info(int mode, int kc, int* out) {
  return at_mode(mode, [&](auto m) {
    constexpr Mode MODE = decltype(m)::value;
    return at_width(kc, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return kernel_info(reinterpret_cast<const void*>(sweep_kernel<H, R, MODE>()),
                         pass1_smem_bytes<H, R, MODE>(), out);
    });
  });
}

template <bool H>
int sweep(const void* w, const void* h, const void* tiles, const int* perm, const int* rb,
          const int* cb, float* part, float* out, int mp, int np, int k, int bm, int bn,
          int n_tiles, int steps, int per, int kc, float eps, int state_bf16, int x_kind,
          int gemm, int device, void* stream) {
  if (x_kind == X_U8 || bm < 1 || bn < 1 || mp % bm || np % bn || per < 1 || steps < 0)
    return cudaErrorInvalidValue;
  Operands o;
  cudaError_t err = make_operands(w, h, tiles, nullptr, mp, np, k, state_bf16, x_kind, gemm,
                                  eps, &o);
  if (err != cudaSuccess) return err;
  const int n_out = H ? np / bn : mp / bm;
  const Plan pl{perm, H ? cb : rb, H ? rb : cb, steps, n_tiles, n_out,
                H ? mp / bm : np / bn, bm, bn, per, (steps + per - 1) / per};
  err = cudaSetDevice(device);
  if (err != cudaSuccess || n_out == 0 || k == 0) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slices = ((H ? bn : bm) + TILE - 1) / TILE;
  err = at_mode(static_cast<int>(mode_of(o, gemm)), [&](auto m) {
    return launch_sweep<H, decltype(m)::value>(kc, o, pl, part, slices, st);
  });
  if (err != cudaSuccess) return err;
  const size_t block = (size_t)k * (H ? bn : bm);
  const size_t shares = (block + 4 * THREADS - 1) / (4 * THREADS);
  sweep_sum<H><<<dim3(n_out, (unsigned)(shares > 65535 ? 65535 : shares)), THREADS, 0, st>>>(
      pl, part, out, k, np);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K5, H target.  w (mp,k), h (k,np) in the state dtype, mp and np multiples
// of bm and bn; tiles (n_tiles,bm,bn) f32 | bf16 (x_kind 0 | 1); perm, rb, cb
// (steps,) int32, a sweep plan sorted by cb; part (ceil(steps / per) +
// np / bn, k, bn) f32 scratch; out (k,np) f32.  kc, state_bf16 and gemm as
// nmf_h_update.
int nmf_h_sweep(const void* w, const void* h, const void* tiles, const int* perm, const int* rb,
                const int* cb, float* part, float* out, int mp, int np, int k, int bm, int bn,
                int n_tiles, int steps, int per, int kc, float eps, int state_bf16, int x_kind,
                int gemm, int device, void* stream) {
  return sweep<true>(w, h, tiles, perm, rb, cb, part, out, mp, np, k, bm, bn, n_tiles, steps,
                     per, kc, eps, state_bf16, x_kind, gemm, device, stream);
}

// K5, W target: the plan sorted by rb; part (ceil(steps / per) + mp / bm,
// bm, k); out (mp,k) f32; the rest as above.
int nmf_w_sweep(const void* w, const void* h, const void* tiles, const int* perm, const int* rb,
                const int* cb, float* part, float* out, int mp, int np, int k, int bm, int bn,
                int n_tiles, int steps, int per, int kc, float eps, int state_bf16, int x_kind,
                int gemm, int device, void* stream) {
  return sweep<false>(w, h, tiles, perm, rb, cb, part, out, mp, np, k, bm, bn, n_tiles, steps,
                      per, kc, eps, state_bf16, x_kind, gemm, device, stream);
}

// Pass-1 launches of K5's H target (h = 1) or W target (h = 0) in Mode
// `mode` since the library loaded or the last reset; -1 for a Mode out of
// range.
int nmf_sweep_launches(int h, int mode) {
  return mode < 0 || mode >= MODES ? -1 : sweep_launches[h ? 0 : 1][mode].load();
}

void nmf_reset_sweep_launches() {
  for (auto& row : sweep_launches)
    for (auto& n : row) n = 0;
}

// Adds n (either sign) to the pass-1 launches of K5's H target (h = 1) or
// W target (h = 0) in Mode `mode`: a replayed CUDA graph runs K5 without
// its host launcher, so its caller adds the launches that the capture
// recorded at every replay, and takes them back from the capture itself
// (models/solver.py); 0, or -1 for a Mode out of range.
int nmf_add_sweep_launches(int h, int mode, int n) {
  if (mode < 0 || mode >= MODES) return -1;
  sweep_launches[h ? 0 : 1][mode] += n;
  return 0;
}

// out[4] = registers, dynamic shared memory (bytes), resident blocks an
// SM, local memory a thread (bytes) of K5's pass-1 kernel for the H target
// (h = 1) or the W target (h = 0) in Mode `mode` at chunk width kc.
int nmf_sweep_info(int h, int mode, int kc, int* out) {
  return h ? sweep_info<true>(mode, kc, out) : sweep_info<false>(mode, kc, out);
}

}  // extern "C"
