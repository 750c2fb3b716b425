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
// partial kernels in all, each built twice (for the 2-D call here and for a
// member axis in fused_mu_batched.cu), and 15 of K3 (F32, ANY, BF16; no
// SPLIT3), which serve both.
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
// The *_batched entry points (K1/K2's in fused_mu_batched.cu) take a
// member axis in front of every operand, as jax.vmap gives the TPU kernels
// one (the batched, restart and rank-sweep solves): one pass-1 and one
// pass-2 launch serve all members, each member walked at the plan of its
// own shape, X per member or shared by all (struct Members), and member b
// gives the bits of the 2-D call on member b.  K1/K2's two kinds of call
// run different pass-1 instances of the same bodies (fused_mu.cuh): a
// member's block reads its operands' pointers from shared memory (what
// keeps the member instances from spilling), the 2-D call's from the
// parameter space and its walk's registers, as the kernels had them before
// the member axis (through shared memory the pointers' loads and stores
// became generic ones, reloaded after every store to shared memory: the
// bfloat16 flagship's K2 took 4.0 ms on the H100 against 1.8).  A batched
// call of one member is the 2-D call.  K3's one instance serves both kinds
// (kl_partial).
//
// The pass-1 bodies, K3's cost walk and their dispatch live in pass1.cuh
// (with mma_tile.cuh's tensor-core pieces and simt_tile.cuh's SIMT ones),
// shared with K5 (tile_sparse.cu), which walks them over a sweep plan; here
// they walk a dense X (fused_mu.cuh: the kernels and their launchers).  The
// staging rules, Mode and K3's terms live in mu_tile.cuh.

#include "fused_mu.cuh"

namespace nmf_counts {
std::atomic<int> partial_launches[2][4];
}  // namespace nmf_counts

namespace {

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
// One instance serves the 2-D call (one member) and a batched one: unlike
// K1/K2, K3 read no slower at the flagship through its MemberBlock than
// with plain operands in the parameter space (PERF.md).
template <int R, Mode MODE>
__global__ void __launch_bounds__(THREADS, KL_MIN_BLOCKS<R, MODE>)
    kl_partial(const __grid_constant__ Operands o, float* __restrict__ partials,
               int tiles_per_split, Members b) {
  __shared__ float red[THREADS];
  __shared__ MemberBlock blk;
  // the walk's partial pointer is K1's and never written here
  member_block<true>(o, partials, b, blk);
  const float t = kl_walk<R, MODE>(member_view(o, blk),
                                   DenseWalk<true, true>(o, blk, tiles_per_split, b.split()));
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

// K3's pass-1 launches per Mode (nmf_kl_launches), counted on the host as
// K1/K2's are.
std::atomic<int> kl_launches[MODES];

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
  return mode < 0 || mode >= MODES ? -1 : nmf_counts::partial_launches[h ? 0 : 1][mode].load();
}

// out[4] = registers, dynamic shared memory (bytes), resident blocks an
// SM, local memory a thread (bytes) of the 2-D call's pass-1 kernel of K1
// (h = 1) or K2 (h = 0) in Mode `mode` at chunk width kc, on the current
// device (nmf_member_partial_info: a batched call's).
int nmf_partial_info(int h, int mode, int kc, int* out) {
  return h ? partial_info<true, false>(mode, kc, out) : partial_info<false, false>(mode, kc, out);
}

void nmf_reset_partial_launches() {
  for (auto& row : nmf_counts::partial_launches)
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
  return update<true, false>(w, h, x, scales, sum_w, part, out, m, n, k, kc, splits,
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
  return update<false, false>(w, h, x, scales, sum_h, part, out, m, n, k, kc, splits,
                              tiles_per_split, eps, state_bf16, x_kind, gemm,
                              numerator_only, device, stream, 1, 0);
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

// Adds n (either sign) to the pass-1 launches of K1 (counter 0), K2 (1) or
// K3 (2) in Mode `mode`: a replayed CUDA graph runs its kernels without
// their host launchers, so its caller adds the launches that the capture
// recorded at every replay, and takes them back from the capture itself
// (models/solver.py); 0, or -1 for a counter or Mode out of range.
int nmf_add_launches(int counter, int mode, int n) {
  if (mode < 0 || mode >= MODES || counter < 0 || counter > 2) return -1;
  if (counter == 2)
    kl_launches[mode] += n;
  else
    nmf_counts::partial_launches[counter][mode] += n;
  return 0;
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
