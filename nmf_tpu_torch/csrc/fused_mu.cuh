// K1/K2's kernels and their host launchers, shared by the two units that
// build them: fused_mu.cu (the 2-D entry points, and K3's) and
// fused_mu_batched.cu (K1/K2's member-axis entry points).  Each unit
// compiles its own copy (anonymous namespace) and instantiates only the
// pass-1 instances its launches take, so the two sets build in parallel.
// What the kernels compute, and how, is told in fused_mu.cu.

#pragma once

#include <atomic>

#include "pass1.cuh"

// Pass-1 launches of K1 (0) and K2 (1) per Mode, counted on the host as
// each is launched, by both units (defined in fused_mu.cu): which instance
// a call ran (nmf_partial_launches).  The kernel names of a torch.profiler
// trace would say the same, but on the H100 a short trace lost its first
// kernels (PERF.md section 6).
namespace nmf_counts {
extern std::atomic<int> partial_launches[2][4];
}  // namespace nmf_counts

namespace {

static_assert(MODES == 4, "nmf_counts holds one counter a Mode");

// The member axis of a batched call, the counterpart of jax.vmap over the
// TPU kernels: one launch serves every member.  The grid's z holds `splits`
// blocks of each member (member = blockIdx.z / splits); member b's W, H, X
// and scales lie b byte strides past the first member's (X's and the
// scales' strides 0 when all members share one X, jax.vmap's in_axes=None),
// its partial slice b * part floats past the first.  Each member runs the
// 2-D call's plan on its own shape, so member b of a batched launch gives
// the bits of the 2-D call on member b.
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
// R = 16 kernels and K3's ANY ones spilled).  K1/K2's 2-D instances take
// none of this: through shared memory the walk's loads and stores of X, W,
// H and the partial became generic ones and each pointer was reloaded after
// every store to shared memory, which cost the bfloat16 flagship's K2 twice
// its time (PERF.md).
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

// walk.out[i] of a member: the split's partial, its pointer read from
// shared memory where the partial is written.
struct SharedPartial {
  float* const* p;
  __device__ float& operator[](size_t i) const { return (*p)[i]; }
};

// K1's (H) or K2's (W) dense walk: block (64-wide output tile, k chunk,
// split, or member x split) over the split's run of M tiles (K1) or N
// tiles (K2) of X, in order; the resident operand is the block's H columns
// (K1) or W rows (K2), the partial its split's (k, n) or (m, k) slice of
// part.  The 2-D call's walk holds X's and the partial's pointers; a
// member's (MEMBERS) reads them from its MemberBlock.  The shapes are the
// launch's.
template <bool H, bool MEMBERS>
struct DenseWalk {
  std::conditional_t<MEMBERS, const void* const*, const void*> x;
  int m, n, t_begin, t_end;
  int res0, res_lim;  // n0, n (K1) or m0, m (K2)
  std::conditional_t<MEMBERS, SharedPartial, float*> out;
  int ld, out0, out_lim;

  // the 2-D call: split blockIdx.z of part
  __device__ DenseWalk(const Operands& o, float* part, int tiles_per_split)
      : x(o.x), m(o.m), n(o.n), out(part + (size_t)blockIdx.z * o.k * (H ? o.n : o.m)) {
    init(o, tiles_per_split, blockIdx.z);
  }
  // a member: split `split` of the block's MemberBlock
  __device__ DenseWalk(const Operands& o, const MemberBlock& blk, int tiles_per_split, int split)
      : x(&blk.o.x), m(o.m), n(o.n), out{&blk.out} {
    init(o, tiles_per_split, split);
  }
  __device__ void init(const Operands& o, int tiles_per_split, int split) {
    const int walk_tiles = ((H ? o.m : o.n) + TILE - 1) / TILE;
    t_begin = split * tiles_per_split;
    t_end = min(t_begin + tiles_per_split, walk_tiles);
    res0 = out0 = blockIdx.x * TILE;
    res_lim = out_lim = H ? o.n : o.m;
    ld = o.n;
  }
  __device__ const void* x_ptr() const {
    if constexpr (MEMBERS)
      return *x;
    else
      return x;
  }
  __device__ int steps() const { return t_end - t_begin; }
  __device__ WalkStep step(int t) const {
    const int w0 = (t_begin + t) * TILE;
    if constexpr (H)
      return {w0, m, {x_ptr(), n, w0, res0, m, n}};
    else
      return {w0, n, {x_ptr(), n, res0, w0, m, n}};
  }
};

// The pass-1 kernels: BF16 and SPLIT3 run on the tensor cores, F32 and ANY
// on the SIMT units (pass1.cuh).  MEMBERS: a batched launch's instance
// (grid z: member x split), else the 2-D call's (z: split; b not read).
template <int R, Mode MODE, bool MEMBERS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    h_update_partial(const __grid_constant__ Operands o, float* __restrict__ part,
                     int tiles_per_split, Members b) {
  if constexpr (MEMBERS) {
    __shared__ MemberBlock blk;
    member_block<true>(o, part, b, blk);
    pass1<true, R, MODE>(member_view(o, blk),
                         DenseWalk<true, true>(o, blk, tiles_per_split, b.split()));
  } else {
    pass1<true, R, MODE>(o, DenseWalk<true, false>(o, part, tiles_per_split));
  }
}

template <int R, Mode MODE, bool MEMBERS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<R, MODE>)
    w_update_partial(const __grid_constant__ Operands o, float* __restrict__ part,
                     int tiles_per_split, Members b) {
  if constexpr (MEMBERS) {
    __shared__ MemberBlock blk;
    member_block<false>(o, part, b, blk);
    pass1<false, R, MODE>(member_view(o, blk),
                          DenseWalk<false, true>(o, blk, tiles_per_split, b.split()));
  } else {
    pass1<false, R, MODE>(o, DenseWalk<false, false>(o, part, tiles_per_split));
  }
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

template <bool H, int R, Mode MODE, bool MEMBERS>
auto partial_kernel() {
  return H ? h_update_partial<R, MODE, MEMBERS> : w_update_partial<R, MODE, MEMBERS>;
}

// Pass 1 of K1 (H) or K2 (W) at chunk width kc, for `members` members.
template <bool H, Mode MODE, bool MEMBERS>
cudaError_t launch_partial(int kc, const Operands& o, float* part, int splits,
                           int per, const Members& b, int members, cudaStream_t st) {
  cudaError_t err = at_width(kc, [&](auto r) {
    constexpr int R = decltype(r)::value;
    constexpr size_t smem = pass1_smem_bytes<H, R, MODE>();
    auto kernel = partial_kernel<H, R, MODE, MEMBERS>();
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(((H ? o.n : o.m) + TILE - 1) / TILE, (o.k + 16 * R - 1) / (16 * R),
                    splits * members);
    kernel<<<grid, THREADS, smem, st>>>(o, part, per, b);
    return cudaGetLastError();
  });
  if (err == cudaSuccess) ++nmf_counts::partial_launches[H ? 0 : 1][static_cast<int>(MODE)];
  return err;
}

// Registers, dynamic shared memory, blocks an SM and local memory of one
// pass-1 instance of K1 (H) or K2.
template <bool H, bool MEMBERS>
cudaError_t partial_info(int mode, int kc, int* out) {
  return at_mode(mode, [&](auto m) {
    constexpr Mode MODE = decltype(m)::value;
    return at_width(kc, [&](auto r) {
      constexpr int R = decltype(r)::value;
      return kernel_info(reinterpret_cast<const void*>(partial_kernel<H, R, MODE, MEMBERS>()),
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

// K1 (H) or K2 over `members` members: the 2-D call (one member) on the
// 2-D instances, a batched call on the MEMBERS ones (each unit
// instantiates the ones it launches).
template <bool H, bool MEMBERS>
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
      return launch_partial<H, decltype(md)::value, MEMBERS>(kc, og, pg, splits, tiles_per_split,
                                                             b, gb, st);
    });
    if (err != cudaSuccess) return err;
    err = launch_finalize(H ? og.h : og.w, state_bf16, pg, denom == nullptr ? nullptr : denom + (size_t)g0 * k,
                          static_cast<char*>(out) + g0 * out_bytes, rows, cols, splits, H ? 1 : 0,
                          numerator_only, gb, st);
  }
  return err;
}

}  // namespace
