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
// W H in registers, forms Z in shared memory and contracts it at once (K3:
// sums its terms at once), so X is the only M x N stream (read once per
// kernel).
//
// What bounds them on this card.  One half-update costs ~4 M N K flop (two
// GEMMs) against ~4 M N bytes of X (2 for bf16 X, 1 for uint8 codes); the
// cost ~2 M N K flop and two accurate logf an element.  On the SIMT FMA
// units (~67 TFLOP/s on an H100 SXM at 700 W) that is compute-bound from
// K ~ 30; on the tensor cores (989 TFLOP/s bf16) the bytes bound it below
// K ~ 500.  Under the bfloat16 and float32_fast policies (Mode::BF16,
// Mode::SPLIT3) K1/K2's pass 1 runs both products of a tile on the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate; mma_tile.cuh; split3
// three mma a k-step), and under bfloat16 K3 its recon; f32 GEMMs run on
// the SIMT units: 4 x 4 (W H) and 4 x R (the contraction) register tiles
// fed from shared memory (simt_tile.cuh), fragments read as 16-byte
// vectors, f32 operands staged by cp.async with the next copies in flight
// beside the FMAs, the block's fixed operand resident.  The tensor-core
// kernels wait for each step's W staging loads (the latency, not the
// tensor cores, bounds BF16).  None uses TMA or wgmma.
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
//          value rounded to bf16 (__float2bfloat16_rn, the casts' rounding),
//          staged as bf16 and multiplied on the tensor cores (bf16 mma, f32
//          accumulation).  float32_fast (split3): each operand split into
//          hi = bf16(a), lo = bf16(a - hi), and each product taken as
//          hi*bh + hi*bl + lo*bh (the lo*lo term dropped, as _kdot): K1/K2
//          stage hi and lo as two bf16 planes and run three mma a k-step
//          (mma_tile.cuh); K3 takes the true-f32 recon (below).
//   K3     recon in true f32 under both f32 policies (Mode::F32 or ANY),
//          on bf16-rounded inputs under bfloat16 (Mode::BF16: the tensor
//          cores) (fused_mu.py:586-591).
//
// The pass-1 kernels are instantiated per Mode (below): F32, the all-f32
// main path; ANY, f32 GEMMs on bf16 state or bf16/uint8 X as runtime
// choices; and SPLIT3 and BF16, the float32_fast and bfloat16 GEMM policies
// on the tensor cores for every state dtype and X storage (both runtime
// choices).  Not the cross product of dtypes, rounding and chunk widths: 40
// partial kernels in all, and 15 of K3 (F32, ANY, BF16; no SPLIT3).
//
// Design against the TPU kernel.  Pallas runs its grid in order and carries
// the K x bn (or bm x K) accumulator (K3: one scalar) across the grid.  CUDA
// blocks run in no order, so a block walks its share of the contraction
// axis in a loop instead (K3: K1's walk, a run of M tiles under 64
// columns).  At the reference shape N is only 350 (6 column tiles), so that
// axis is also split across a fixed number of blocks; each writes an f32
// partial (K3: one float a block) and a second pass sums the partials IN A
// FIXED ORDER and applies the epilogue.  No float atomics anywhere: the same
// inputs give the same bits on every run, in every mode.  The split count
// comes from the shape alone (the Python planner), never from the card.
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
// The *_batched entry points take a member axis in front of every operand,
// as jax.vmap gives the TPU kernels one (the batched, restart and rank-sweep
// solves): one pass-1 and one pass-2 launch serve all members, each member
// walked at the plan of its own shape, X per member or shared by all
// (struct Members).  The 2-D entry points are the one-member case.
//
// The pass-1 bodies, K3's cost walk and their dispatch live in pass1.cuh
// (with mma_tile.cuh's tensor-core pieces and simt_tile.cuh's SIMT ones),
// shared with K5 (tile_sparse.cu), which walks them over a sweep plan; here
// they walk a dense X.  The staging rules, Mode and K3's terms live in
// mu_tile.cuh.

#include <atomic>

#include "pass1.cuh"

namespace {

// The member axis of a batched call, the counterpart of jax.vmap over the
// TPU kernels: one launch serves every member.  The grid's z holds `splits`
// blocks of each member (member = blockIdx.z / splits); member b's W, H, X
// and scales lie b byte strides past the first member's (X's and the
// scales' strides 0 when all members share one X, jax.vmap's in_axes=None),
// its partial slice b * part floats past the first.  Each member runs the
// 2-D call's plan on its own shape, so member b of a batched launch gives
// the bits of the 2-D call on member b; the 2-D call is one member.
struct Members {
  int splits;                   // blocks of one member along z
  size_t w, h, x, scales;       // bytes from one member to the next
  size_t part;                  // floats from one member's partials to the next

  __device__ int member() const { return blockIdx.z / splits; }
  __device__ int split() const { return blockIdx.z % splits; }
  __host__ __device__ Operands of(Operands o, int b) const {
    o.w = static_cast<const char*>(o.w) + b * w;
    o.h = static_cast<const char*>(o.h) + b * h;
    o.x = static_cast<const char*>(o.x) + b * x;
    if (o.scales != nullptr)
      o.scales = reinterpret_cast<const float*>(reinterpret_cast<const char*>(o.scales) + b * scales);
    return o;
  }
};

// A block's member, in shared memory: its operands and its split's partial,
// written once by member_block.
struct MemberBlock {
  Operands o;
  float* out;
};

// One member's operands as the walk reads them: the shapes and modes are
// the launch's, in the parameter space as the 2-D kernels read them; the
// pointers the member's, read from the block's MemberBlock where each is
// used.  So no member offset holds a register across the walk (held in
// registers, or the shapes read from shared memory too, the BF16 Mode's
// R = 16 kernels and K3's ANY ones spilled).
struct MemberOperands {
  const void* const& w;
  const void* const& h;
  const void* const& x;
  const float* const& scales;
  const int& m;
  const int& n;
  const int& k;
  const int& state_bf16;
  const int& x_kind;
  const float& eps;
};

__device__ __forceinline__ MemberOperands member_view(const Operands& o, const MemberBlock& blk) {
  return {blk.o.w, blk.o.h, blk.o.x, blk.o.scales, o.m, o.n, o.k, o.state_bf16, o.x_kind, o.eps};
}

// The block's MemberBlock: member b's operands and split s's (k, n) (K1,
// K3) or (m, k) (K2) slice of part.
template <bool H>
__device__ __forceinline__ void member_block(const Operands& o, float* part, const Members& b,
                                             MemberBlock& blk) {
  if (threadIdx.x == 0) {
    const int mb = b.member();
    blk.o = b.of(o, mb);
    blk.out = part + mb * b.part + (size_t)b.split() * o.k * (H ? o.n : o.m);
  }
  __syncthreads();
}

// walk.out[i]: the split's partial, its pointer read from shared memory
// where the partial is written.
struct SharedPartial {
  float* const* p;
  __device__ float& operator[](size_t i) const { return (*p)[i]; }
};

// K1's (H) or K2's (W) dense walk: block (64-wide output tile, k chunk,
// member x split) over the split's run of M tiles (K1) or N tiles (K2) of
// X, in order; the resident operand is the block's H columns (K1) or W
// rows (K2), the partial its split's slice of part.  The member's X and
// partial pointers are read from its MemberBlock; the shapes are the
// launch's.
template <bool H>
struct DenseWalk {
  const void* const* x;
  int m, n, t_begin, t_end;
  int res0, res_lim;  // n0, n (K1) or m0, m (K2)
  SharedPartial out;
  int ld, out0, out_lim;

  __device__ DenseWalk(const Operands& o, const MemberBlock& blk, int tiles_per_split, int split)
      : x(&blk.o.x), m(o.m), n(o.n), out{&blk.out} {
    const int walk_tiles = ((H ? o.m : o.n) + TILE - 1) / TILE;
    t_begin = split * tiles_per_split;
    t_end = min(t_begin + tiles_per_split, walk_tiles);
    res0 = out0 = blockIdx.x * TILE;
    res_lim = out_lim = H ? o.n : o.m;
    ld = o.n;
  }
  __device__ int steps() const { return t_end - t_begin; }
  __device__ WalkStep step(int t) const {
    const int w0 = (t_begin + t) * TILE;
    if constexpr (H)
      return {w0, m, {*x, n, w0, res0, m, n}};
    else
      return {w0, n, {*x, n, res0, w0, m, n}};
  }
};

// The pass-1 kernels: BF16 and SPLIT3 run on the tensor cores, F32 and ANY
// on the SIMT units (pass1.cuh).
template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    h_update_partial(const __grid_constant__ Operands o, float* __restrict__ part,
                     int tiles_per_split, Members b) {
  __shared__ MemberBlock blk;
  member_block<true>(o, part, b, blk);
  pass1<true, R, MODE>(member_view(o, blk), DenseWalk<true>(o, blk, tiles_per_split, b.split()));
}

template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    w_update_partial(const __grid_constant__ Operands o, float* __restrict__ part,
                     int tiles_per_split, Members b) {
  __shared__ MemberBlock blk;
  member_block<false>(o, part, b, blk);
  pass1<false, R, MODE>(member_view(o, blk), DenseWalk<false>(o, blk, tiles_per_split, b.split()));
}

// Pass 2 of K1 and K2: out = base * (sum_s part[s]) / denom, the sum taken
// in split order 0, 1, ... (fixed, so the bits never depend on scheduling).
// base and out are in the state dtype (out rounded to nearest even); denom
// is indexed by row (K1: sum_w[k] for out[k][n]) or by column (K2: sum_h[k]
// for out[m][k]).  Over `members` members, each rows x cols with its own
// partials (splits of them) and denominator, one after another.
__global__ void __launch_bounds__(THREADS)
    finalize(const void* __restrict__ base, int state_bf16,
             const float* __restrict__ part, const float* __restrict__ denom,
             void* __restrict__ out, int rows, int cols, int splits,
             int denom_by_row, int members) {
  const size_t per = (size_t)rows * cols, total = per * members;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t b = idx / per, i = idx - b * per;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(b * splits + s) * per + i];
    const float d = denom_by_row ? denom[b * rows + i / cols] : denom[b * cols + i % cols];
    // h * acc / sumw: fused_mu.py:277, 406
    const float v = (state_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[idx])
                                : static_cast<const float*>(base)[idx]) * acc / d;
    if (state_bf16)
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[idx] = v;
  }
}

// Pass 2 of K1 and K2 in numerator_only mode: out = sum_s part[s] in f32,
// the same split-ordered sum finalize takes, with no epilogue
// (fused_mu.py:280-282, 408-409), over `members` members of `per` values.
// base and denom are not read.
__global__ void __launch_bounds__(THREADS)
    sum_splits(const float* __restrict__ part, float* __restrict__ out,
               size_t per, int splits, int members) {
  const size_t total = per * members;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const size_t b = idx / per, i = idx - b * per;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += part[(b * splits + s) * per + i];
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

// K3 pass 1 (pass1.cuh: kl_walk): block (64-wide column block, 1, member
// x split) walks the split's run of M tiles as K1's does and writes one
// partial, its threads' sums added by a fixed tree, to slot blockIdx.z *
// gridDim.x + column block: each member's slots in a run of their own.
template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, KL_MIN_BLOCKS<R, MODE>)
    kl_partial(const __grid_constant__ Operands o, float* __restrict__ partials,
               int tiles_per_split, Members b) {
  __shared__ float red[THREADS];
  __shared__ MemberBlock blk;
  // the walk's partial pointer is K1's and never written here
  member_block<true>(o, partials, b, blk);
  const float t = kl_walk<R, MODE>(member_view(o, blk), DenseWalk<true>(o, blk, tiles_per_split,
                                                                         b.split()));
  const float sum = block_sum(t, red);
  if (threadIdx.x == 0) partials[blockIdx.z * gridDim.x + blockIdx.x] = sum;
}

// K3 pass 2: block b sums member b's `count` slots, strided then by tree:
// fixed order.
__global__ void __launch_bounds__(THREADS)
    kl_final(const float* __restrict__ partials, int count,
             float* __restrict__ out) {
  __shared__ float red[THREADS];
  const float* p = partials + (size_t)blockIdx.x * count;
  float t = 0.f;
  for (int i = threadIdx.x; i < count; i += THREADS) t += p[i];
  const float sum = block_sum(t, red);
  if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

// K3 under bfloat16 on f32 state: W or H of `members` members, `len`
// values each, rounded to bf16 (nearest even, the casts' rounding) once a
// call into the caller's scratch, member b's at dst + b * ld (ld a multiple
// of 8: each member's copy on 16 bytes), so that every step of the walk
// stages bf16 bits by cp.async.
__global__ void __launch_bounds__(THREADS)
    to_bf16(const float* __restrict__ src, size_t len, int members,
            __nv_bfloat16* __restrict__ dst, size_t ld) {
  const size_t total = len * members;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / len;
    dst[b * ld + (i - b * len)] = __float2bfloat16_rn(src[i]);
  }
}

// K3's pass-1 launches per Mode (nmf_kl_launches), counted on the host as
// K1/K2's are.
std::atomic<int> kl_launches[MODES];

// The Mode of K3 on a call's operands: BF16 under bfloat16, else F32 for
// all-f32 operands and ANY (float32_fast takes the f32 recon).
Mode kl_mode_of(const Operands& o, int gemm) {
  return gemm == GEMM_BF16 ? Mode::BF16 : all_f32(o) ? Mode::F32 : Mode::ANY;
}

// f(std::integral_constant<Mode, MODE>, std::integral_constant<int, R>) for
// a K3 instance; SPLIT3 has none.
template <typename F>
cudaError_t at_kl(int mode, int kc, F&& f) {
  return at_mode(mode, [&](auto m) {
    if constexpr (decltype(m)::value == Mode::SPLIT3)
      return cudaErrorInvalidValue;
    else
      return at_width(kc, [&](auto r) { return f(m, r); });
  });
}

template <bool H, int R, Mode MODE>
auto partial_kernel() {
  return H ? h_update_partial<R, MODE> : w_update_partial<R, MODE>;
}

// Pass-1 launches of K1 (0) and K2 (1) per Mode, counted on the host as
// each is launched: which instance a call ran (nmf_partial_launches).  The
// kernel names of a torch.profiler trace would say the same, but on the
// H100 a short trace lost its first kernels (PERF.md section 6).
std::atomic<int> partial_launches[2][MODES];

// Pass 1 of K1 (H) or K2 (W) at chunk width kc, for `members` members.
template <bool H, Mode MODE>
cudaError_t launch_partial(int kc, const Operands& o, float* part, int splits,
                           int per, const Members& b, int members, cudaStream_t st) {
  cudaError_t err = at_width(kc, [&](auto r) {
    constexpr int R = decltype(r)::value;
    constexpr size_t smem = pass1_smem_bytes<H, R, MODE>();
    auto kernel = partial_kernel<H, R, MODE>();
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(((H ? o.n : o.m) + TILE - 1) / TILE, (o.k + 16 * R - 1) / (16 * R),
                    splits * members);
    kernel<<<grid, THREADS, smem, st>>>(o, part, per, b);
    return cudaGetLastError();
  });
  if (err == cudaSuccess) ++partial_launches[H ? 0 : 1][static_cast<int>(MODE)];
  return err;
}

// Registers, dynamic shared memory, blocks an SM and local memory of one
// pass-1 instance (nmf_partial_info).
template <bool H>
cudaError_t partial_info(int mode, int kc, int* out) {
  return at_mode(mode, [&](auto m) {
    constexpr Mode MODE = decltype(m)::value;
    return at_width(kc, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return kernel_info(reinterpret_cast<const void*>(partial_kernel<H, R, MODE>()),
                         pass1_smem_bytes<H, R, MODE>(), out);
    });
  });
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
                            int members, cudaStream_t st) {
  const size_t per = (size_t)rows * cols;
  if (numerator_only)
    sum_splits<<<pass_blocks(per * members), THREADS, 0, st>>>(
        part, static_cast<float*>(out), per, splits, members);
  else
    finalize<<<pass_blocks(per * members), THREADS, 0, st>>>(
        base, state_bf16, part, denom, out, rows, cols, splits, denom_by_row, members);
  return cudaGetLastError();
}

size_t x_bytes(int x_kind) { return x_kind == X_F32 ? 4 : x_kind == X_BF16 ? 2 : 1; }

// The member strides of a call: W (m, k) and H (k, n) per member in the
// state dtype, X (m, n) and its scales (n,) per member or shared
// (x_shared: stride 0).
Members members_of(const Operands& o, int x_shared, int splits, size_t part) {
  const size_t state = o.state_bf16 ? 2 : 4;
  return Members{splits, (size_t)o.m * o.k * state, (size_t)o.k * o.n * state,
                 x_shared ? 0 : (size_t)o.m * o.n * x_bytes(o.x_kind),
                 x_shared ? 0 : (size_t)o.n * sizeof(float), part};
}

// Members a launch takes: gridDim.z (splits a member) is at most 65535, so
// a batch past that is launched in groups of this many members.
int group_of(int splits) { return 65535 / splits; }

template <bool H>
int update(const void* w, const void* h, const void* x, const float* scales,
           const float* denom, float* part, void* out, int m, int n, int k,
           int kc, int splits, int tiles_per_split, float eps, int state_bf16,
           int x_kind, int gemm, int numerator_only, int device, void* stream,
           int members, int x_shared) {
  if (members < 1 || splits < 1 || splits > 65535 || (x_shared != 0 && x_shared != 1))
    return cudaErrorInvalidValue;
  Operands o;
  cudaError_t err = make_operands(w, h, x, scales, m, n, k, state_bf16, x_kind,
                                  gemm, eps, &o);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the output's rows x cols: (k, n) for K1, (m, k) for K2
  const int rows = H ? k : m, cols = H ? n : k;
  const size_t per = (size_t)rows * cols;
  const Members b = members_of(o, x_shared, splits, per * splits);
  const size_t out_bytes = per * (numerator_only ? sizeof(float) : state_bf16 ? 2 : 4);
  const int group = group_of(splits);
  for (int g0 = 0; g0 < members && err == cudaSuccess; g0 += group) {
    const int gb = std::min(group, members - g0);
    const Operands og = b.of(o, g0);
    float* pg = part + g0 * b.part;
    err = at_mode(static_cast<int>(mode_of(o, gemm)), [&](auto md) {
      return launch_partial<H, decltype(md)::value>(kc, og, pg, splits, tiles_per_split, b,
                                                    gb, st);
    });
    if (err != cudaSuccess) return err;
    err = launch_finalize(H ? og.h : og.w, state_bf16, pg, denom == nullptr ? nullptr : denom + (size_t)g0 * k,
                          static_cast<char*>(out) + g0 * out_bytes, rows, cols, splits, H ? 1 : 0,
                          numerator_only, gb, st);
  }
  return err;
}

// K3 over `members` members (kl_split's plan of one member), one f32 a
// member into out.
int kl_cost(const void* w, const void* h, const void* x, const float* scales,
            float* partials, void* scratch, float* out, int m, int n, int k, int kc,
            int splits, int tiles_per_split, float eps, int state_bf16, int x_kind,
            int gemm, int device, void* stream, int members, int x_shared) {
  const int m_tiles = (m + TILE - 1) / TILE;
  if (splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (splits - 1) * tiles_per_split >= m_tiles || splits * tiles_per_split < m_tiles)
    return cudaErrorInvalidValue;  // every split non-empty, every M tile walked once
  if (members < 1 || (x_shared != 0 && x_shared != 1)) return cudaErrorInvalidValue;
  Operands o;
  cudaError_t err = make_operands(w, h, x, scales, m, n, k, state_bf16, x_kind,
                                  gemm, eps, &o);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Mode mode = kl_mode_of(o, gemm);
  const int col_blocks = (n + TILE - 1) / TILE, slots = splits * col_blocks;
  Members b = members_of(o, x_shared, splits, slots);
  if (mode == Mode::BF16 && !o.state_bf16) {  // the BF16 walk stages bf16 bits
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const size_t mk = (size_t)m * k, kn = (size_t)k * n;
    const size_t wld = (mk + 7) / 8 * 8, hld = (kn + 7) / 8 * 8;  // on 16 bytes
    __nv_bfloat16* wb = static_cast<__nv_bfloat16*>(scratch);
    __nv_bfloat16* hb = wb + wld * members;
    to_bf16<<<pass_blocks(mk * members), THREADS, 0, st>>>(static_cast<const float*>(w), mk,
                                                           members, wb, wld);
    to_bf16<<<pass_blocks(kn * members), THREADS, 0, st>>>(static_cast<const float*>(h), kn,
                                                           members, hb, hld);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    o.w = wb;
    o.h = hb;
    o.state_bf16 = 1;
    b.w = wld * sizeof(__nv_bfloat16);
    b.h = hld * sizeof(__nv_bfloat16);
  }
  const int group = group_of(splits);
  for (int g0 = 0; g0 < members; g0 += group) {
    const int gb = std::min(group, members - g0);
    const Operands og = b.of(o, g0);
    float* pg = partials + (size_t)g0 * slots;
    const dim3 grid(col_blocks, 1, splits * gb);
    err = at_kl(static_cast<int>(mode), kc, [&](auto md, auto r) {
      constexpr Mode MODE = decltype(md)::value;
      constexpr int R = decltype(r)::value;
      constexpr size_t smem = kl_smem_bytes<R, MODE>();
      auto kernel = kl_partial<R, MODE>;
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
      kernel<<<grid, THREADS, smem, st>>>(og, pg, tiles_per_split, b);
      return cudaGetLastError();
    });
    if (err != cudaSuccess) return err;
    ++kl_launches[static_cast<int>(mode)];
    kl_final<<<gb, THREADS, 0, st>>>(pg, slots, out + g0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return err;
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
  return h ? partial_info<true>(mode, kc, out) : partial_info<false>(mode, kc, out);
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
                      numerator_only, device, stream, 1, 0);
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
                       numerator_only, device, stream, 1, 0);
}

// K1 and K2 over a member axis: as nmf_h_update / nmf_w_update on
// `members` members stacked in front of every operand (w (B,m,k), h
// (B,k,n), the denominator (B,k), part (B,splits,...), out (B,...)), each
// member at the 2-D call's plan (splits, tiles_per_split of its shape);
// x (m,n) and scales (n,) shared by all members when x_shared is 1, else
// (B,m,n) and (B,n).  One pass-1 and one pass-2 launch for all members
// (a group of 65535 / splits members a launch past gridDim.z's limit).
int nmf_h_update_batched(const void* w, const void* h, const void* x,
                         const float* scales, const float* sum_w, float* part,
                         void* out, int m, int n, int k, int kc, int splits,
                         int tiles_per_split, float eps, int state_bf16, int x_kind,
                         int gemm, int numerator_only, int device, void* stream,
                         int members, int x_shared) {
  return update<true>(w, h, x, scales, sum_w, part, out, m, n, k, kc, splits,
                      tiles_per_split, eps, state_bf16, x_kind, gemm,
                      numerator_only, device, stream, members, x_shared);
}

int nmf_w_update_batched(const void* w, const void* h, const void* x,
                         const float* scales, const float* sum_h, float* part,
                         void* out, int m, int n, int k, int kc, int splits,
                         int tiles_per_split, float eps, int state_bf16, int x_kind,
                         int gemm, int numerator_only, int device, void* stream,
                         int members, int x_shared) {
  return update<false>(w, h, x, scales, sum_h, part, out, m, n, k, kc, splits,
                       tiles_per_split, eps, state_bf16, x_kind, gemm,
                       numerator_only, device, stream, members, x_shared);
}

// K3.  w, h, x, scales, state_bf16, x_kind and gemm as K1 (float32_fast
// takes the true-f32 recon, as float32); kc the chunk width (K <= kc: H
// resident); the M tiles walked in `splits` runs of tiles_per_split
// (fused_mu.kl_split); partials (splits * ceil(n / 64),) f32 scratch, one
// slot a block; out one float.  scratch: under bfloat16 on f32 state,
// (ceil(m k / 8) * 8 + k n,) bf16 for W and H rounded; else not read (may
// be null).
int nmf_kl_cost(const void* w, const void* h, const void* x,
                const float* scales, float* partials, void* scratch, float* out,
                int m, int n, int k, int kc, int splits, int tiles_per_split,
                float eps, int state_bf16, int x_kind, int gemm, int device,
                void* stream) {
  return kl_cost(w, h, x, scales, partials, scratch, out, m, n, k, kc, splits,
                 tiles_per_split, eps, state_bf16, x_kind, gemm, device, stream, 1, 0);
}

// K3 over a member axis: out (B,) f32, one cost a member; partials (B *
// splits * ceil(n / 64),); scratch under bfloat16 on f32 state (B *
// (ceil(m k / 8) + ceil(k n / 8)) * 8,) bf16; the rest as
// nmf_h_update_batched.  One kl_partial and one kl_final launch (one
// block a member) for all members.
int nmf_kl_cost_batched(const void* w, const void* h, const void* x,
                        const float* scales, float* partials, void* scratch, float* out,
                        int m, int n, int k, int kc, int splits, int tiles_per_split,
                        float eps, int state_bf16, int x_kind, int gemm, int device,
                        void* stream, int members, int x_shared) {
  return kl_cost(w, h, x, scales, partials, scratch, out, m, n, k, kc, splits,
                 tiles_per_split, eps, state_bf16, x_kind, gemm, device, stream, members,
                 x_shared);
}

// K3's pass-1 launches in Mode `mode` since the library loaded or the last
// reset (0 for SPLIT3, which has no instance); -1 for a Mode out of range.
int nmf_kl_launches(int mode) {
  return mode < 0 || mode >= MODES ? -1 : kl_launches[mode].load();
}

void nmf_reset_kl_launches() {
  for (auto& n : kl_launches) n = 0;
}

// out[4] = registers, dynamic shared memory (bytes), resident blocks an
// SM, local memory a thread (bytes) of K3's pass-1 kernel in Mode `mode`
// at chunk width kc, on the current device; an error for SPLIT3.
int nmf_kl_info(int mode, int kc, int* out) {
  return at_kl(mode, kc, [&](auto md, auto r) {
    constexpr Mode MODE = decltype(md)::value;
    constexpr int R = decltype(r)::value;
    auto kernel = kl_partial<R, MODE>;
    return kernel_info(reinterpret_cast<const void*>(kernel), kl_smem_bytes<R, MODE>(), out);
  });
}

}  // extern "C"
