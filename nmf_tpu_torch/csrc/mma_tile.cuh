// Warp-level tensor-core pieces of K1/K2's bfloat16 and float32_fast modes
// (Mode::BF16 and Mode::SPLIT3; fused_mu.cu, and K5 in tile_sparse.cu
// through pass1.cuh; K3's bfloat16 recon takes the staging and W H): bf16 staging in shared memory, ldmatrix fragment
// loads, the mma.sync m16n8k16 (bf16 in, f32 accumulate) wrapper, the tile
// steps built from them (staging, W H from resident blocks or streamed, the
// ratio Z = X / max(W H, eps), the warp tilings of the 64-deep contraction
// of Z with a W or H chunk), and the two pass-1 bodies, each over a Walk
// (simt_tile.cuh says what a Walk gives).
//
// The bfloat16 policy is what a bf16 mma computes: W, H and Z rounded to
// bf16 (nearest even; bf16 state is taken as its bits), each product exact
// in f32, sums in f32 (nmf_tpu/ops/pallas/fused_mu.py:215-230, 266-269).
// The tensor core adds the 16 products of a k-step in its own order, so the
// sums match the SIMT kernels' fmaf chains up to the order of the sum.
//
// The float32_fast policy is _kdot's split3 (fused_mu.py:215-237): each
// operand a = hi + lo, hi = bf16(a), lo = bf16(a - hi), staged as two bf16
// planes of the same layout (PLANE words apart), and each product
// hi bh + hi bl + lo bh (lo bl dropped): three mma a k-step.  Z is formed
// in f32 and split, never rounded to bf16 first; bf16 state splits as f32
// state does (its lo is 0), so every state dtype takes one code path.
//
// Layout.  Every staged row starts on 16 bytes (ldmatrix's rule): rows are
// padded by BPAD = 8 bf16, which also spreads the 8 rows of one 8 x 8
// fragment over all 32 banks (a row stride of 4 mod 32 words).  Operands
// stored with the contraction axis contiguous load with plain ldmatrix;
// those stored with it strided load with ldmatrix.trans.  Out-of-range rows,
// columns and k are staged as 0 (both planes), so W H = 0 and Z = 0 / eps =
// 0 there.

#pragma once

#include "mu_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BPAD = 8;              // bf16 pad per staged row: 16 bytes
constexpr int RK = KS;               // k depth of one streamed W H step (16)
constexpr int WS_LD = RK + BPAD;     // ws [TILE][WS_LD]: W slice, k contiguous
constexpr int HS_LD = TILE + BPAD;   // hs [RK][HS_LD], H [k][HS_LD]: n contiguous
constexpr int ZS_LD = TILE + BPAD;   // zs [TILE][ZS_LD]: Z, n contiguous
constexpr int XS_LD = TILE + 8;      // xs [TILE][XS_LD]: X as f32 (conflict-free pairs)

// Shared memory in bf16 words, each a multiple of 8 (16 bytes), so the
// buffers after them stay aligned: Z, X (f32), and one streamed W H step.
constexpr int Z_WORDS = TILE * ZS_LD;
constexpr int X_WORDS = 2 * TILE * XS_LD;
constexpr int STEP_WORDS = TILE * WS_LD + RK * HS_LD;

__device__ __forceinline__ bf16 bf16_zero() { return __ushort_as_bfloat16(0); }

// W or H elements staged as bf16: the bits of bf16 state, or f32 state
// rounded to nearest even (the casts' rounding).  Indices are 32-bit here:
// the wrapper refuses operands of 2**31 elements or more, and 64-bit
// offsets cost the staging loops registers.
struct Bf16Bits {
  const bf16* p;
  __device__ __forceinline__ bf16 operator()(int i) const { return p[i]; }
};
struct F32ToBf16 {
  const float* p;
  __device__ __forceinline__ bf16 operator()(int i) const { return __float2bfloat16_rn(p[i]); }
};
// The same elements as f32, for the split: bf16 state widened.
struct Bf16Wide {
  const bf16* p;
  __device__ __forceinline__ float operator()(int i) const { return __bfloat162float(p[i]); }
};
struct F32At {
  const float* p;
  __device__ __forceinline__ float operator()(int i) const { return p[i]; }
};

// split3 of v into d (hi) and d + plane (lo); of a pair into two bf16 pairs.
__device__ __forceinline__ void put_split(bf16* d, int plane, float v) {
  const bf16 hi = __float2bfloat16_rn(v);
  d[0] = hi;
  d[plane] = __float2bfloat16_rn(v - __bfloat162float(hi));
}
__device__ __forceinline__ void put_split2(bf16* d, int plane, float a, float b) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  const float2 h = __bfloat1622float2(hi);
  *reinterpret_cast<__nv_bfloat162*>(d) = hi;
  *reinterpret_cast<__nv_bfloat162*>(d + plane) = __floats2bfloat162_rn(a - h.x, b - h.y);
}

__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix at a shared-memory byte address: each lane passes the address of
// one 8-element row; .x4 loads four 8 x 8 matrices (rows from lanes 0-7,
// 8-15, 16-23, 24-31), .x2 two (lanes 0-15).  .trans hands each lane the
// transposed elements.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a b for one m16n8k16 tile: a row-major 16 x 16, b column-major
// 16 x 8, bf16; d f32.  Lane (g, t) = (lane / 4, lane % 4) holds d at rows
// g and g + 8, columns 2t and 2t + 1.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b: in the mma, or (FRESH) summed into zeros and added in f32.
template <bool FRESH>
__device__ __forceinline__ void mma_step(float (&acc)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (FRESH) {
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16(d, a, b);
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] += d[c];
  } else {
    mma_bf16(acc, a, b);
  }
}

// acc += a b under split3, a = (ah, al) and b = (bh, bl): one k-step's
// three products chained in one mma started from zeros, the corrections
// al bh and ah bl first and the main term ah bh last, and the sum added to
// acc in f32.  The tensor core truncates each add (to the largest addend),
// so the chain costs up to an ulp of the one k-step, never of the running
// acc; the corrections, 2**-8 of the main term, are aligned to it once.
__device__ __forceinline__ void mma_split3(float (&acc)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(d, al, bh);
  mma_bf16(d, ah, bl);
  mma_bf16(d, ah, bh);
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] += d[c];
}

// One warp's acc[TM][TN] m16n8 tiles += A (16 TM x depth) B (depth x 8 TN),
// depth a multiple of 16.  a points at A's element (0, 0), stored [m][k]
// (AT false) or [k][m] (AT true) with row stride LDA; b at B's (0, 0),
// stored [n][k] (BT false) or [k][n] (BT true).  TN is 1 or even.  Each
// lane converts its row address to a shared-memory offset once; every
// fragment after that sits a compile-time distance from it.  PA, PB > 0:
// split3 operands, A's lo plane PA bf16 words past a and B's PB past b,
// each k-step taken by mma_split3 (FRESH is then implied).
//
// FRESH: each k-step's 16 products are summed by an mma into zeros and
// added to acc in f32 (round to nearest), instead of accumulating in the
// mma.  The tensor core aligns its addends to the largest and drops the low
// bits (toward zero), so a long chain of mma accumulations drifts low by up
// to an ulp a step: K / 16 steps of W H at K = 2048 moved the bf16-state
// results past their limit.  The contraction's sums run over a block's
// whole walk (4 steps a tile, 300 tiles and more on a tall or wide X), so
// it is FRESH too; only K1/K2's bfloat16 W H from a resident block (K <= 256:
// at most 16 steps, started afresh each tile) accumulates in the mma (split3's
// three mma a step would triple that chain's drift).  UNROLL k-steps
// are unrolled (and their fragments loaded ahead): one where the
// accumulators already hold many registers, or FRESH holds a sum a step
// (K1's R = 8 contraction spilled at 4).
template <int TM, int TN, bool AT, bool BT, int LDA, int LDB, bool FRESH = false,
          int UNROLL = (FRESH || TM * TN >= 16 ? 1 : 4), int PA = 0, int PB = 0>
__device__ __forceinline__ void mma_panel(float (&acc)[TM][TN][4], const bf16* a, const bf16* b,
                                          int depth) {
  constexpr int E = sizeof(bf16);
  constexpr bool S3 = PA > 0;
  static_assert(S3 == (PB > 0), "both operands split, or neither");
  const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
  // the lane's row: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
  // (m 8-15, k 8-15) of A; (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
  // (n 8-15, k 8-15) of a pair of B tiles, or the first two of one tile
  const uint32_t a0 = smem_addr(a) + E * (AT ? ((q >> 1) * 8 + r) * LDA + (q & 1) * 8
                                             : (lane & 15) * LDA + (lane >> 4) * 8);
  const uint32_t b0 = smem_addr(b) + E * (BT ? ((q & 1) * 8 + r) * LDB + (TN == 1 ? 0 : (q >> 1) * 8)
                                             : ((TN == 1 ? 0 : (q >> 1) * 8) + r) * LDB + (q & 1) * 8);
  // A's fragments (both planes under split3) of the k-step at offset off
  auto load_a = [&](uint32_t (&f)[4], int off) {
    if constexpr (AT)
      ldsm_x4_t(f, a0 + E * off);
    else
      ldsm_x4(f, a0 + E * off);
  };
  // each B fragment used as soon as it is loaded
#pragma unroll UNROLL
  for (int k = 0; k < depth; k += 16) {
    uint32_t af[TM][4], al[S3 ? TM : 1][4];
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int off = AT ? k * LDA + 16 * t : 16 * t * LDA + k;
      load_a(af[t], off);
      if constexpr (S3) load_a(al[t], PA + off);
    }
    if constexpr (TN == 1) {
      uint32_t bfr[2], bl[2];
      const int off = BT ? k * LDB : k;
      if constexpr (BT)
        ldsm_x2_t(bfr, b0 + E * off);
      else
        ldsm_x2(bfr, b0 + E * off);
      if constexpr (S3) {
        if constexpr (BT)
          ldsm_x2_t(bl, b0 + E * (PB + off));
        else
          ldsm_x2(bl, b0 + E * (PB + off));
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        if constexpr (S3)
          mma_split3(acc[t][0], af[t], al[t], bfr, bl);
        else
          mma_step<FRESH>(acc[t][0], af[t], bfr);
      }
    } else {
#pragma unroll
      for (int u = 0; u < TN; u += 2) {
        uint32_t x[4], xl[4];
        const int off = BT ? k * LDB + 8 * u : 8 * u * LDB + k;
        if constexpr (BT)
          ldsm_x4_t(x, b0 + E * off);
        else
          ldsm_x4(x, b0 + E * off);
        if constexpr (S3) {
          if constexpr (BT)
            ldsm_x4_t(xl, b0 + E * (PB + off));
          else
            ldsm_x4(xl, b0 + E * (PB + off));
        }
        // the two n tiles u and u + 1
        const uint32_t b0f[2] = {x[0], x[1]}, b1f[2] = {x[2], x[3]};
#pragma unroll
        for (int t = 0; t < TM; ++t) {
          if constexpr (S3) {
            const uint32_t b0l[2] = {xl[0], xl[1]}, b1l[2] = {xl[2], xl[3]};
            mma_split3(acc[t][u], af[t], al[t], b0f, b0l);
            mma_split3(acc[t][u + 1], af[t], al[t], b1f, b1l);
          } else {
            mma_step<FRESH>(acc[t][u], af[t], b0f);
            mma_step<FRESH>(acc[t][u + 1], af[t], b1f);
          }
        }
      }
    }
  }
}

// Whether a ROWS x COLS block splits into whole passes of the block's
// threads, V elements a thread.
template <int V, int ROWS, int COLS>
constexpr bool WHOLE_PASSES =
    COLS % V == 0 && THREADS % (COLS / V) == 0 && ROWS % (THREADS / (COLS / V)) == 0;

// V elements of W or H at p as bf16 into d (2V bytes, aligned): f32 state
// rounded (V = 4), bf16 state copied as bits (V = 8); or V zeros.
__device__ __forceinline__ void put_vec(const float* p, bf16* d) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  reinterpret_cast<__nv_bfloat162*>(d)[0] = __floats2bfloat162_rn(a.x, a.y);
  reinterpret_cast<__nv_bfloat162*>(d)[1] = __floats2bfloat162_rn(a.z, a.w);
}
__device__ __forceinline__ void put_vec(const bf16* p, bf16* d) {
  *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(p);
}
template <int V>
__device__ __forceinline__ void put_zeros(bf16* d) {
  if constexpr (V == 4)
    *reinterpret_cast<uint2*>(d) = make_uint2(0, 0);
  else
    *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
}
// The same V elements split3, hi at d and lo at d + plane.
__device__ __forceinline__ void put_vec_split(const float* p, bf16* d, int plane) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  put_split2(d, plane, a.x, a.y);
  put_split2(d + 2, plane, a.z, a.w);
}
__device__ __forceinline__ void put_vec_split(const bf16* p, bf16* d, int plane) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    put_split2(d + 2 * q, plane, f.x, f.y);
  }
}

// The staging loops of stage_bf16.  A thread keeps its columns and walks
// rows STEP apart: one shared address and compile-time offsets from it.
// Element (r, c) is p[(r0 + r) * stride + c0 + c], or 0 where r0 + r >=
// rlim or c0 + c >= clim; the vector loop needs c0 and clim multiples of V.
// PLANE > 0: src gives f32 values, staged split3 into two planes.
template <int ROWS, int COLS, int LD, int UNROLL, int PLANE = 0, typename Src>
__device__ __forceinline__ void stage_rows(Src src, int r0, int c0, int rlim, int clim,
                                           int stride, bf16* dst) {
  constexpr int STEP = THREADS / COLS;
  static_assert(WHOLE_PASSES<1, ROWS, COLS>, "whole passes of the block");
  const int r = threadIdx.x / COLS, c = c0 + threadIdx.x % COLS;
  const bool col_in = c < clim;
  bf16* d = dst + r * LD + threadIdx.x % COLS;
#pragma unroll UNROLL
  for (int s = 0; s < ROWS / STEP; ++s) {
    const int gr = r0 + r + s * STEP;
    if constexpr (PLANE > 0)
      put_split(d + s * STEP * LD, PLANE, (col_in && gr < rlim) ? src(gr * stride + c) : 0.f);
    else
      d[s * STEP * LD] = (col_in && gr < rlim) ? src(gr * stride + c) : bf16_zero();
  }
}

template <int V, int ROWS, int COLS, int LD, int UNROLL, int PLANE, typename T>
__device__ __forceinline__ void stage_rows_vec(const T* p, int r0, int c0, int rlim, int clim,
                                               int stride, bf16* dst) {
  constexpr int TPR = COLS / V, STEP = THREADS / TPR;
  const int r = threadIdx.x / TPR, cv = threadIdx.x % TPR * V, c = c0 + cv;
  const bool col_in = c < clim;  // the whole vector
  bf16* d = dst + r * LD + cv;
#pragma unroll UNROLL
  for (int s = 0; s < ROWS / STEP; ++s) {
    const int gr = r0 + r + s * STEP;
    if (col_in && gr < rlim) {
      if constexpr (PLANE > 0)
        put_vec_split(p + gr * stride + c, d + s * STEP * LD, PLANE);
      else
        put_vec(p + gr * stride + c, d + s * STEP * LD);
    } else {
      put_zeros<V>(d + s * STEP * LD);
      if constexpr (PLANE > 0) put_zeros<V>(d + s * STEP * LD + PLANE);
    }
  }
}

// Stages a ROWS x COLS block of W or H (p, the state dtype) as bf16 into
// dst [ROWS][LD]; PLANE > 0: split3, hi into dst and lo into dst + PLANE.
// Neighbouring threads take neighbouring columns (coalesced), in 16-byte
// vectors where the rows and columns allow (vec_ok, and c0 and clim on a
// vector), else one element at a time; UNROLL elements a thread in flight
// at once, or VU vectors (4 or 8 elements each; VU = 0: elements only): as
// many as the registers beside K1/K2's accumulators allow.
template <int ROWS, int COLS, int LD, int UNROLL, int VU, int PLANE = 0, typename Ops>
__device__ __forceinline__ void stage_bf16(const Ops& o, const void* p, int r0, int c0,
                                           int rlim, int clim, int stride, bf16* dst) {
  if (o.state_bf16) {
    const bf16* src = static_cast<const bf16*>(p);
    if constexpr (VU > 0 && WHOLE_PASSES<8, ROWS, COLS>) {
      if (vec_ok(src, stride, 8) && ((c0 | clim) & 7) == 0) {
        stage_rows_vec<8, ROWS, COLS, LD, VU, PLANE>(src, r0, c0, rlim, clim, stride, dst);
        return;
      }
    }
    if constexpr (PLANE > 0)
      stage_rows<ROWS, COLS, LD, UNROLL, PLANE>(Bf16Wide{src}, r0, c0, rlim, clim, stride, dst);
    else
      stage_rows<ROWS, COLS, LD, UNROLL>(Bf16Bits{src}, r0, c0, rlim, clim, stride, dst);
  } else {
    const float* src = static_cast<const float*>(p);
    if constexpr (VU > 0 && WHOLE_PASSES<4, ROWS, COLS>) {
      if (vec_ok(src, stride, 4) && ((c0 | clim) & 3) == 0) {
        stage_rows_vec<4, ROWS, COLS, LD, VU, PLANE>(src, r0, c0, rlim, clim, stride, dst);
        return;
      }
    }
    if constexpr (PLANE > 0)
      stage_rows<ROWS, COLS, LD, UNROLL, PLANE>(F32At{src}, r0, c0, rlim, clim, stride, dst);
    else
      stage_rows<ROWS, COLS, LD, UNROLL>(F32ToBf16{src}, r0, c0, rlim, clim, stride, dst);
  }
}

// V elements of X at p as f32 into d (16-byte aligned): f32 (V = 4) or bf16
// widened (V = 8); or zeros.
__device__ __forceinline__ void put_x_vec(const float* p, float* d) {
  *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void put_x_vec(const bf16* p, float* d) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float2 lo = __bfloat1622float2(h[2 * q]), hi = __bfloat1622float2(h[2 * q + 1]);
    reinterpret_cast<float4*>(d)[q] = make_float4(lo.x, lo.y, hi.x, hi.y);
  }
}

template <int V, typename T>
__device__ __forceinline__ void stage_x_vec(const XSrc& x, float* xs) {
  constexpr int TPR = TILE / V, STEP = THREADS / TPR;
  const T* p = static_cast<const T*>(x.p);
  const int i = threadIdx.x / TPR, jv = threadIdx.x % TPR * V, gc = x.c0 + jv;
  const bool col_in = gc < x.clim;  // the whole vector
  float* d = xs + i * XS_LD + jv;
#pragma unroll 2
  for (int s = 0; s < TILE / STEP; ++s) {
    const int gr = x.r0 + i + s * STEP;
    if (col_in && gr < x.rlim) {
      put_x_vec(p + gr * x.stride + gc, d + s * STEP * XS_LD);
    } else {
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<float4*>(d + s * STEP * XS_LD)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The step's X (XSrc) into xs [TILE][XS_LD] as f32, in its storage's value
// (uint8 codes dequantized, one at a time; with VEC, f32 and bf16 in
// 16-byte vectors where the rows and columns allow), 0 outside its limits.
// Staged whole before W H, so that no X load is in flight beside the W H
// accumulators (the ratio's own X loads spilled at KC = 256); two elements
// a thread in flight (four spilled K2 at KC = 256).
template <bool VEC, typename Ops>
__device__ __forceinline__ void stage_x(const Ops& o, const XSrc& x, float* xs) {
  if constexpr (VEC) {
    if (o.x_kind == X_F32 && vec_ok(x.p, x.stride, 4) && ((x.c0 | x.clim) & 3) == 0)
      return stage_x_vec<4, float>(x, xs);
    if (o.x_kind == X_BF16 && vec_ok(x.p, x.stride, 8) && ((x.c0 | x.clim) & 7) == 0)
      return stage_x_vec<8, bf16>(x, xs);
  }
  constexpr int STEP = THREADS / TILE;
  const int i = threadIdx.x / TILE, gc = x.c0 + threadIdx.x % TILE;  // neighbours along n
  const bool col_in = gc < x.clim;
  float* d = xs + i * XS_LD + threadIdx.x % TILE;
  with_x<Mode::BF16>(o, x.p, [&](auto src) {
#pragma unroll 2
    for (int s = 0; s < TILE / STEP; ++s) {
      const int gr = x.r0 + i + s * STEP;
      d[s * STEP * XS_LD] = (col_in && gr < x.rlim) ? src(gr * x.stride + gc, gc) : 0.f;
    }
  });
}

// The tile's W H into y, on the tensor cores: warp (wm, wn) = (warp % 4,
// warp / 4) holds rows 16 wm .. +16 and columns 32 wn .. +32 as four m16n8
// tiles.  From a W block a [TILE][LDA] (k contiguous) and an H block
// b [k][LDB] (n contiguous) already in shared memory, depth K rounded up
// to 16 (their rows past K are 0).  UNROLL as mma_panel's: 1 beside
// K1/K2's 32 or 64 accumulators.  PA, PB > 0: split3 planes (mma_panel's),
// each k-step summed apart; else W H accumulates in the mma, or (FRESH:
// K3, whose cost adds up every recon of X, so that a drift of each one the
// same way would add up too) each k-step is summed apart.
template <int LDA, int LDB, int UNROLL, int PA = 0, int PB = 0, bool FRESH = false, typename Ops>
__device__ __forceinline__ void recon_resident(const Ops& o, const bf16* a, const bf16* b,
                                               float (&y)[1][4][4]) {
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  mma_panel<1, 4, false, true, LDA, LDB, FRESH, UNROLL, PA, PB>(y, a + 16 * wm * LDA,
                                                                b + 32 * wn, (o.k + 15) & ~15);
}

// The bf16 words of one streamed W H step: the W slice, then the H slice,
// each hi then lo under split3.
template <bool S3>
constexpr int STEP_BUF = (S3 ? 2 : 1) * STEP_WORDS;

// The same, streaming W rows m0.. (below mlim) and H columns n0.. (below
// nlim) through ws/hs (STEP_BUF) RK deep a step: for K above one chunk,
// where neither block fits.
template <bool S3, typename Ops>
__device__ __forceinline__ void recon_streamed(const Ops& o, int m0, int mlim, int n0,
                                               int nlim, bf16* ws, float (&y)[1][4][4]) {
  constexpr int WP = S3 ? TILE * WS_LD : 0, HP = S3 ? RK * HS_LD : 0;
  bf16* hs = ws + (S3 ? 2 : 1) * TILE * WS_LD;
#pragma unroll 1
  for (int k0 = 0; k0 < o.k; k0 += RK) {
    stage_bf16<TILE, RK, WS_LD, RK * TILE / THREADS, 1, WP>(o, o.w, m0, k0, mlim, o.k, o.k, ws);
    stage_bf16<RK, TILE, HS_LD, RK * TILE / THREADS, 1, HP>(o, o.h, k0, n0, o.k, nlim, o.n, hs);
    __syncthreads();
    const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
    mma_panel<1, 4, false, true, WS_LD, HS_LD, true, 1, WP, HP>(
        y, ws + 16 * wm * WS_LD, hs + 32 * wn, min(RK, (o.k - k0 + 15) & ~15));
    __syncthreads();
  }
}

// Z = X / max(W H, eps) at each lane's accumulator positions, from xs into
// zs [TILE][ZS_LD] as bf16 pairs: rounded to bf16, or (PLANE > 0) split3 in
// f32, lo into zs + PLANE.  Not synchronised.
template <int PLANE = 0, typename Ops>
__device__ __forceinline__ void ratio_z(const Ops& o, const float (&y)[1][4][4],
                                        const float* xs, bf16* zs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, wm = warp & 3, wn = warp >> 2;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 16 * wm + (lane >> 2) + 8 * half;
      const int j = 32 * wn + 8 * u + 2 * (lane & 3);
      const float2 xv = *reinterpret_cast<const float2*>(xs + i * XS_LD + j);
      const float z0 = xv.x / clamp_eps(y[0][u][2 * half], o.eps);
      const float z1 = xv.y / clamp_eps(y[0][u][2 * half + 1], o.eps);
      if constexpr (PLANE > 0)
        put_split2(zs + i * ZS_LD + j, PLANE, z0, z1);
      else
        *reinterpret_cast<__nv_bfloat162*>(zs + i * ZS_LD + j) = __floats2bfloat162_rn(z0, z1);
    }
}

// Warp tilings of the contraction: the (KC/16) x 8 m16n8 output tiles of K1
// (acc (KC x TILE) = Wc^T Z) and the 4 x (KC/8) of K2 (acc (TILE x KC) =
// Z Hc^T), R = KC / 16 per warp, as WM x WN warps of TM x TN tiles each
// (at KC = 256 both 4 x 4 a warp: 4 A and 2 B ldmatrix for 16 mma).
template <int R>
struct HTiling {
  static constexpr int TN = R < 4 ? R : 4, WM = TN, WN = 8 / TN, TM = R / TN;
};
template <int R>
struct WTiling {
  static constexpr int TM = R < 4 ? R : 4, WM = 4 / TM, WN = 8 / WM, TN = 2 * R / WN;
};

// Loads of the walking W or H block a thread has in flight at once beside
// the accumulators (KC / 4 elements a thread in all): elements, or 16-byte
// vectors.  K2's BF16 instances stage one element at a time: their
// 16-byte loads (of W, H or X) spilled at KC = 256.  SPLIT3's take them,
// but at R = 4, where they cost the second block an SM (119 -> 153
// registers) and ran slower.
constexpr int WALK_UNROLL = 4, WALK_VECTORS = 2;

// K1 pass 1 on the tensor cores (Mode::BF16, and Mode::SPLIT3 with S3):
// the same walk and partials as h_partial_simt.  Per step: X to xs,
// Wc = W[st.r0 .., kc0 .. +KC] to wc (bf16 [TILE][KC + BPAD], k contiguous),
// W H into registers, Z to zs, then acc (KC x TILE) += Wc^T Z over the
// step's 64 rows (A = Wc^T and B = Z both stored i-major: ldmatrix.trans;
// each k-step summed apart and added in f32, mma_panel's FRESH, however
// long the walk).  With one k chunk (K <= KC) Wc is the whole W block of
// the step, and the block's H columns (walk.res0 ..) stay in shared memory
// for its whole walk (hr), so W H reads both from shared memory; above it
// W H streams both per k step.  S3: every staged block (wc, hr or the
// step, zs) is two planes, hi then lo, and each k-step of W H too is
// summed apart.
template <int R, bool S3, typename Walk, typename Ops>
__device__ __forceinline__ void h_partial_mma(const Ops& o, const Walk& walk) {
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
  const int kc0 = blockIdx.y * KC;
  const int steps = walk.steps();
  const bool resident = o.k <= KC;
  if (resident)  // read after the first step's __syncthreads
    stage_bf16<KC, TILE, HS_LD, WALK_UNROLL, WALK_VECTORS, HP>(o, o.h, 0, walk.res0, o.k,
                                                               walk.res_lim, o.n, hr);

  float acc[L::TM][L::TN][4];
#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][u][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const WalkStep st = walk.step(t);
    stage_x<true>(o, st.x, xs);
    stage_bf16<TILE, KC, WC_LD, WALK_UNROLL, WALK_VECTORS, WP>(o, o.w, st.r0, kc0, st.lim, o.k,
                                                               o.k, wc);
    float y[1][4][4] = {};
    if (resident) {
      __syncthreads();
      recon_resident<WC_LD, HS_LD, R >= 8 ? 1 : 2, WP, HP>(o, wc, hr, y);
    } else {
      recon_streamed<S3>(o, st.r0, st.lim, walk.res0, walk.res_lim, hr, y);
    }
    ratio_z<ZP>(o, y, xs, zs);
    __syncthreads();
    mma_panel<L::TM, L::TN, true, true, WC_LD, ZS_LD, true, 1, WP, ZP>(
        acc, wc + 16 * L::TM * wm, zs + 8 * L::TN * wn, TILE);
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gk = kc0 + 16 * (L::TM * wm + t) + (lane >> 2) + 8 * (c >> 1);
        const int gn = walk.out0 + 8 * (L::TN * wn + u) + 2 * (lane & 3) + (c & 1);
        if (gk < o.k && gn < walk.out_lim) walk.out[(size_t)gk * walk.ld + gn] = acc[t][u][c];
      }
}

// K2 pass 1 on the tensor cores.  Per step: X to xs, Hc = H[kc0 .. +KC,
// st.r0 ..] to hc (bf16 [KC][TILE + BPAD], n contiguous), W H, Z, then
// acc (TILE x KC) += Z Hc^T over the step's 64 columns (A = Z and B = Hc^T
// both stored with the contraction axis contiguous: plain ldmatrix; FRESH,
// as K1).  With one k chunk Hc is the step's whole H block, and the
// block's W rows (walk.res0 ..) stay in shared memory for its walk (wr).
// S3: two planes each, as K1.
template <int R, bool S3, typename Walk, typename Ops>
__device__ __forceinline__ void w_partial_mma(const Ops& o, const Walk& walk) {
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
  const int kc0 = blockIdx.y * KC;
  const int steps = walk.steps();
  const bool resident = o.k <= KC;
  if (resident)
    stage_bf16<TILE, KC, WR_LD, WALK_UNROLL, VU, WP>(o, o.w, walk.res0, 0, walk.res_lim, o.k,
                                                     o.k, wr);

  float acc[L::TM][L::TN][4];
#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][u][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const WalkStep st = walk.step(t);
    stage_x<VEC>(o, st.x, xs);
    stage_bf16<KC, TILE, HC_LD, WALK_UNROLL, VU, HP>(o, o.h, kc0, st.r0, o.k, st.lim, o.n, hc);
    float y[1][4][4] = {};
    if (resident) {
      __syncthreads();
      recon_resident<WR_LD, HC_LD, R >= 8 ? 1 : 2, WP, HP>(o, wr, hc, y);
    } else {
      recon_streamed<S3>(o, walk.res0, walk.res_lim, st.r0, st.lim, wr, y);
    }
    ratio_z<ZP>(o, y, xs, zs);
    __syncthreads();
    mma_panel<L::TM, L::TN, false, false, ZS_LD, HC_LD, true, 1, ZP, HP>(
        acc, zs + 16 * L::TM * wm * ZS_LD, hc + 8 * L::TN * wn * HC_LD, TILE);
    __syncthreads();
  }

#pragma unroll
  for (int t = 0; t < L::TM; ++t)
#pragma unroll
    for (int u = 0; u < L::TN; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gm = walk.out0 + 16 * (L::TM * wm + t) + (lane >> 2) + 8 * (c >> 1);
        const int gk = kc0 + 8 * (L::TN * wn + u) + 2 * (lane & 3) + (c & 1);
        if (gm < walk.out_lim && gk < o.k) walk.out[(size_t)gm * o.k + gk] = acc[t][u][c];
      }
}

}  // namespace
