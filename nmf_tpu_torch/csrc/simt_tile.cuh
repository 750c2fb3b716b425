// SIMT pieces of K1/K2's pass 1 under f32 GEMMs (Mode::F32 and Mode::ANY;
// fused_mu.cu, and K5 in tile_sparse.cu through pass1.cuh; K3's f32 recon
// takes the staging and W H), staged for
// Hopper's shared memory and its asynchronous copies.  The float32 policy has no tensor-core form (TF32 keeps ~10 bits),
// so both products of a tile run as true IEEE f32 FMAs on the SIMT units.
//
// What bounds them.  One warp-FMA a clock on each of an SM's four
// schedulers against one 128-byte shared-memory wavefront a clock for the
// whole SM: fragments read one float at a time (PR 1's kernels: 8 loads for
// 16 FMAs) leave the FMA units waiting on the load unit.  Here every
// fragment is a 16-byte LDS.128 and a warp's reads of one operand fall in
// one wavefront: its 32 lanes are 4 rows (ty) by 8 column runs (tx) of the
// thread grid, rows read at one k hit four distinct bank groups (row
// strides of 4 mod 8 words: SLD = 68, LDW = KC + 4), and the 8 column runs
// of a row are 128 contiguous bytes.  W H then costs 8 wavefronts per 64
// warp-FMAs (4-deep runs of k of 4 W rows, 4 rows of H of 4 columns); K1's
// contraction R/4 + 1 per 4R (runs of kk of W, j of Z), K2's 4 + R per 16R
// (runs of j of Z and of H).
//
// Staging.  f32 operands go to shared memory by cp.async, 16 bytes a copy
// where the array and its row stride allow it (vec_ok), 4 bytes else, with
// src-size 0 (zero fill) outside the matrix: the copies of the next k slice
// and the next tile's X are in flight while the current ones are
// multiplied, and each group is waited for only where it is read.  bf16
// state, bf16 X and uint8 codes (Mode::ANY) are widened as they are loaded
// and stored synchronously: the widening (and the codes' scale) would
// otherwise move into every fragment read of the FMA loops.
//
// Each operand is staged once a tile.  With one K chunk (K <= KC: every
// shape of the main path) the block's fixed operand stays in shared memory
// for its whole walk (K1: H[:, n0 .. +64]; K2: W[m0 .. +64, :]) and the
// tile's walking operand (K1: W rows; K2: H columns) is staged once and
// read by both products.  Above one chunk W H streams both operands through
// the resident buffer RS deep a step.
//
// Bits.  Each output's FMAs run in the order of PR 1's kernels: W H over k
// ascending from 0 (staged zeros past K add exact zeros), the contraction
// over the tile's 64 rows (K1) or columns (K2) ascending, padding included;
// the walk and the split are the planner's.  So every result equals the
// earlier kernels' bit for bit.
//
// The walk.  A body takes its steps from a Walk (pass1.cuh): K1/K2's dense
// walk over a run of M or N tiles, or K5's over the sub-tiles of a piece of
// a sweep plan (tile_sparse.cu).  Walk gives steps() and step(t) (a
// WalkStep: the walked W rows or H columns and their limit, the step's X),
// res0 and res_lim (the resident H columns or W rows and their limit), and
// the partial: out, ld (K1's row stride), out0 and out_lim (the block's
// first output column (K1) or row (K2) and the limit).

#pragma once

#include <type_traits>

#include "mu_tile.cuh"

namespace {

constexpr int SLD = TILE + 4;  // row stride of H rows, Z and X: [..][SLD], n contiguous
constexpr int KSL = 64;        // k depth of one copy group of the walking operand
constexpr int RS = 32;         // k depth of one streamed W H step (K > KC)

// The thread's place in the 16 x 16 grid: a warp is 4 ty by 8 tx.
__device__ __forceinline__ int grid_ty() {
  return 4 * (threadIdx.x >> 6) + ((threadIdx.x >> 3) & 3);
}
__device__ __forceinline__ int grid_tx() {
  return 8 * ((threadIdx.x >> 5) & 1) + (threadIdx.x & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (cg) or 4 (ca) bytes, of which `bytes` are read from src
// and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// Waits until at most n of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    default: cp_wait<3>();
  }
}

// Element (r, c) of a ROWS x COLS block into dst [ROWS][LD]: src at
// (r0 + r) * stride + c0 + c, or 0 where r0 + r >= rlim or c0 + c >= clim.
// An f32 source is copied by cp.async (in flight until waited for; 16
// bytes a copy where p, stride and c0 allow it), any other widened in
// register and stored.
template <int ROWS, int COLS, int LD, typename Src>
__device__ __forceinline__ void stage(Src src, int r0, int c0, int rlim, int clim, int stride,
                                      float* dst) {
  if constexpr (std::is_same<Src, F32In>::value) {
    const float* p = src.p;
    if (vec_ok(p, stride, 4) && (c0 & 3) == 0) {  // a run never leaves its row
      constexpr int CPR = COLS / 4, STEP = THREADS / CPR;
      static_assert(COLS % 4 == 0 && THREADS % CPR == 0, "whole rows of 16-byte runs");
      const int cv = 4 * (threadIdx.x % CPR), gc = c0 + cv;
      const int bytes = 4 * max(0, min(4, clim - gc));
#pragma unroll 4
      for (int r = threadIdx.x / CPR; r < ROWS; r += STEP) {
        const bool in = r0 + r < rlim && bytes > 0;
        cp_async16(dst + r * LD + cv, in ? p + (r0 + r) * stride + gc : p, in ? bytes : 0);
      }
    } else {
#pragma unroll 4
      for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
        const int r = e / COLS, c = e % COLS;
        const bool in = r0 + r < rlim && c0 + c < clim;
        cp_async4(dst + r * LD + c, in ? p + (r0 + r) * stride + c0 + c : p, in ? 4 : 0);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, c = e % COLS, gr = r0 + r, gc = c0 + c;
      dst[r * LD + c] = (gr < rlim && gc < clim) ? src((size_t)gr * stride + gc, gc) : 0.f;
    }
  }
}

// W (rows r0.. below rlim, columns k0..) or H (rows k0.., columns c0..
// below clim) in the state dtype, and a step's X ([TILE][LD]), staged by
// stage(); f32 GEMMs, so no rounding.
template <Mode MODE, int ROWS, int COLS, int LD, typename Ops>
__device__ __forceinline__ void stage_w(const Ops& o, int r0, int k0, int rlim, float* dst) {
  with_state<MODE>(o.w, o, [&](auto w) {
    stage<ROWS, COLS, LD>(w, r0, k0, rlim, o.k, o.k, dst);
  });
}
template <Mode MODE, int ROWS, int COLS, int LD, typename Ops>
__device__ __forceinline__ void stage_h(const Ops& o, int k0, int c0, int clim, float* dst) {
  with_state<MODE>(o.h, o, [&](auto h) {
    stage<ROWS, COLS, LD>(h, k0, c0, o.k, clim, o.n, dst);
  });
}
template <Mode MODE, int LD = SLD, typename Ops>
__device__ __forceinline__ void stage_xs(const Ops& o, const XSrc& x, float* xs) {
  with_x<MODE>(o, x.p, [&](auto src) {
    stage<TILE, TILE, LD>(src, x.r0, x.c0, x.rlim, x.clim, x.stride, xs);
  });
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// s[r][c] += sum_{k0 <= k < k1} a[(ty + 16 r) LDA + k] b[k SLD + 4 tx + c],
// k ascending; k1 - k0 a multiple of 4.  a: W rows (k contiguous), b: H
// rows (n contiguous).  AHEAD: each step's fragments are loaded during the
// step before (the last step's loads read past k1: padding, or the next
// buffer of the shared memory, never used); else at the step itself: at
// R <= 2 the loads ahead cost K2 the third block an SM (80 -> 102
// registers) and ran slower at the streamed block.
template <int LDA, bool AHEAD>
__device__ __forceinline__ void recon_f32(const float* a, const float* b, int k0, int k1,
                                          float (&s)[4][4]) {
  const float* ap = a + grid_ty() * LDA;
  const float* bp = b + 4 * grid_tx();
  auto load = [&](int k, float4 (&x)[4], float4 (&y)[4]) {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ld4(ap + 16 * r * LDA + k);
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = ld4(bp + (k + e) * SLD);
  };
  auto step = [&](const float4 (&av)[4], const float4 (&bv)[4]) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(at(av[r], e), at(bv[e], c), s[r][c]);
  };
  float4 av[4], bv[4];
  if constexpr (AHEAD) {
    if (k0 < k1) load(k0, av, bv);
#pragma unroll 2
    for (int k = k0; k < k1; k += 4) {
      float4 an[4], bn[4];
      load(k + 4, an, bn);
      step(av, bv);
#pragma unroll
      for (int r = 0; r < 4; ++r) av[r] = an[r], bv[r] = bn[r];
    }
  } else {
#pragma unroll 2
    for (int k = k0; k < k1; k += 4) {
      load(k, av, bv);
      step(av, bv);
    }
  }
}

// W H over a resident pair whose walking side arrived in NG copy groups of
// KSL k each (the oldest first): each group waited for where it is read.
// The last wait takes every older group with it (X, the resident block).
template <int NG, int LDA, bool AHEAD>
__device__ __forceinline__ void recon_groups(const float* a, const float* b, int depth,
                                             float (&s)[4][4]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    cp_wait(NG - 1 - g);
    __syncthreads();
    recon_f32<LDA, AHEAD>(a, b, g * KSL, min((g + 1) * KSL, depth), s);
  }
}

// W H with both operands streamed RS deep a step through buf (K > KC): W
// rows m0.. below mlim, H columns n0.. below nlim.  Ends synchronised with
// every copy group in.
template <Mode MODE, typename Ops>
__device__ __forceinline__ void recon_streamed(const Ops& o, int m0, int mlim, int n0,
                                               int nlim, int depth, float* buf,
                                               float (&s)[4][4]) {
  constexpr int LDA = RS + 4;
  float* hs = buf + TILE * LDA;
#pragma unroll 1
  for (int k0 = 0; k0 < depth; k0 += RS) {
    stage_w<MODE, TILE, RS, LDA>(o, m0, k0, mlim, buf);
    stage_h<MODE, RS, TILE, SLD>(o, k0, n0, nlim, hs);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    recon_f32<LDA, true>(buf, hs, 0, min(RS, depth - k0), s);
    __syncthreads();
  }
}

// Z = X / max(W H, eps) at the thread's positions, from xs into zs.
__device__ __forceinline__ void ratio_f32(float eps, const float (&s)[4][4], const float* xs,
                                          float* zs) {
  const int off = grid_ty() * SLD + 4 * grid_tx();
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float4 x = ld4(xs + off + 16 * r * SLD);
    *reinterpret_cast<float4*>(zs + off + 16 * r * SLD) =
        make_float4(x.x / clamp_eps(s[r][0], eps), x.y / clamp_eps(s[r][1], eps),
                    x.z / clamp_eps(s[r][2], eps), x.w / clamp_eps(s[r][3], eps));
  }
}

// K1's accumulator rows: runs of KR kk, NQ runs a thread.  Row q KR + e of
// acc is kk = KR ty + 16 KR q + e; column c is j = 4 tx + c.
template <int R>
struct HRuns {
  static constexpr int KR = R < 4 ? R : 4, NQ = R / KR;
};

// K1: acc[kk][j] += sum_i W[i][kk] Z[i][j] over the tile's 64 rows in
// order, each row's fragments loaded during the row before (row 64 lies in
// the next buffer: read, never used).
template <int R, int LDW>
__device__ __forceinline__ void contract_h(const float* wt, const float* zs, float (&acc)[R][4]) {
  using L = HRuns<R>;
  const float* wp = wt + L::KR * grid_ty();
  const float* zp = zs + 4 * grid_tx();
  auto load = [&](int i, float4& z, float (&wv)[L::NQ][L::KR]) {
    z = ld4(zp + i * SLD);
#pragma unroll
    for (int q = 0; q < L::NQ; ++q) {
      const float* w = wp + i * LDW + 16 * L::KR * q;
      if constexpr (L::KR == 4) {
        const float4 v = ld4(w);
        wv[q][0] = v.x, wv[q][1] = v.y, wv[q][2] = v.z, wv[q][3] = v.w;
      } else if constexpr (L::KR == 2) {
        const float2 v = *reinterpret_cast<const float2*>(w);
        wv[q][0] = v.x, wv[q][1] = v.y;
      } else {
        wv[q][0] = w[0];
      }
    }
  };
  float4 z;
  float wv[L::NQ][L::KR];
  load(0, z, wv);
#pragma unroll 2
  for (int i = 0; i < TILE; ++i) {
    float4 zn;
    float wn[L::NQ][L::KR];
    load(i + 1, zn, wn);
#pragma unroll
    for (int q = 0; q < L::NQ; ++q)
#pragma unroll
      for (int e = 0; e < L::KR; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[q * L::KR + e][c] = fmaf(wv[q][e], at(z, c), acc[q * L::KR + e][c]);
    z = zn;
#pragma unroll
    for (int q = 0; q < L::NQ; ++q)
#pragma unroll
      for (int e = 0; e < L::KR; ++e) wv[q][e] = wn[q][e];
  }
}

// K2: acc[i][kk] += sum_j Z[i][j] H[kk][j] over the tile's 64 columns in
// order, 4 a step; row r of acc is i = ty + 16 r, column c is kk = tx + 16 c.
// From R = 4 the H runs are loaded 4 at a time, a group (64 FMAs) ahead,
// and the Z runs a step ahead (past the last: padding or the next buffer,
// never used); below, each step's loads come first, as in W H (registers).
template <int R>
__device__ __forceinline__ void contract_w(const float* zs, const float* ht, float (&acc)[4][R]) {
  const float* zp = zs + grid_ty() * SLD;
  const float* hp = ht + grid_tx() * SLD;
  if constexpr (R >= 4) {
    constexpr int G = R / 4;
    // runs 4 g .. 4 g + 3 of the step at column j
    auto load_h = [&](int g, int j, float4 (&h)[4]) {
#pragma unroll
      for (int u = 0; u < 4; ++u) h[u] = ld4(hp + 16 * (4 * g + u) * SLD + j);
    };
    float4 z[4], h[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) z[r] = ld4(zp + 16 * r * SLD);
    load_h(0, 0, h);
#pragma unroll 1
    for (int j = 0; j < TILE; j += 4) {
      float4 zn[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) zn[r] = ld4(zp + 16 * r * SLD + j + 4);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4 hn[4];
        if (g + 1 < G)
          load_h(g + 1, j, hn);
        else
          load_h(0, j + 4, hn);
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              acc[r][4 * g + u] = fmaf(at(z[r], e), at(h[u], e), acc[r][4 * g + u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) h[u] = hn[u];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) z[r] = zn[r];
    }
  } else {
#pragma unroll 1
    for (int j = 0; j < TILE; j += 4) {
      float4 z[4], h[R];
#pragma unroll
      for (int r = 0; r < 4; ++r) z[r] = ld4(zp + 16 * r * SLD + j);
#pragma unroll
      for (int c = 0; c < R; ++c) h[c] = ld4(hp + 16 * c * SLD + j);
#pragma unroll
      for (int c = 0; c < R; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(at(z[r], e), at(h[c], e), acc[r][c]);
    }
  }
}

// Shared memory of either kernel at chunk width KC = 16 R, in floats: the
// resident block (K1: H [KC][SLD]; K2: W [TILE][KC + 4]), the tile's
// walking block (the other), Z and X.  At KC = 256, 167 KiB: one block an
// SM; at KC <= 128 at most 101 KiB: two.
template <int R>
constexpr size_t simt_smem_words() {
  return (size_t)16 * R * SLD + (size_t)TILE * (16 * R + 4) + 2 * (size_t)TILE * SLD;
}

// K1 pass 1 (SIMT): the block's walk (its 64 columns, a k chunk); per step
// X and W rows staged (X of the next step already in flight during this
// one's contraction), W H, Z, then acc (KC x TILE) += Wc^T Z; the raw
// partial to walk.out[k][out0 ..].
template <int R, Mode MODE, typename Walk, typename Ops>
__device__ __forceinline__ void h_partial_simt(const Ops& o, const Walk& walk) {
  static_assert(MODE == Mode::F32 || MODE == Mode::ANY, "f32 GEMMs only");
  constexpr int KC = 16 * R, LDW = KC + 4, NG = KC > KSL ? KC / KSL : 1, GW = KC / NG;
  using L = HRuns<R>;
  extern __shared__ float4 smem_raw[];
  float* hr = reinterpret_cast<float*>(smem_raw);  // [KC][SLD] resident H, or W H's steps
  float* wt = hr + KC * SLD;                        // [TILE][LDW] the step's W, this chunk
  float* zs = wt + TILE * LDW;
  float* xs = zs + TILE * SLD;

  const int kc0 = blockIdx.y * KC;
  const int steps = walk.steps();
  const bool resident = R < 16 || o.k <= KC;  // the planner's chunk covers K below 256
  const int depth = (o.k + 3) & ~3;            // staged k past K are zeros

  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  if (steps > 0) {
    if (resident) stage_h<MODE, KC, TILE, SLD>(o, 0, walk.res0, walk.res_lim, hr);
    stage_xs<MODE>(o, walk.step(0).x, xs);
    cp_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const WalkStep st = walk.step(t);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      stage_w<MODE, TILE, GW, LDW>(o, st.r0, kc0 + g * GW, st.lim, wt + g * GW);
      cp_commit();
    }
    float s[4][4] = {};
    if (resident)
      recon_groups<NG, LDW, (R > 2)>(wt, hr, depth, s);
    else
      recon_streamed<MODE>(o, st.r0, st.lim, walk.res0, walk.res_lim, depth, hr, s);
    ratio_f32(o.eps, s, xs, zs);
    __syncthreads();  // Z in; X read
    if (t + 1 < steps) {
      stage_xs<MODE>(o, walk.step(t + 1).x, xs);
      cp_commit();
    }
    contract_h<R, LDW>(wt, zs, acc);
    __syncthreads();  // W and Z read
  }

  const int ty = grid_ty(), tx = grid_tx();
#pragma unroll
  for (int q = 0; q < L::NQ; ++q)
#pragma unroll
    for (int e = 0; e < L::KR; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int gk = kc0 + L::KR * ty + 16 * L::KR * q + e, gn = walk.out0 + 4 * tx + c;
        if (gk < o.k && gn < walk.out_lim) walk.out[(size_t)gk * walk.ld + gn] = acc[q * L::KR + e][c];
      }
}

// K2 pass 1 (SIMT): the block's walk (its 64 rows, a k chunk); per step X
// and H columns staged, W H, Z, then acc (TILE x KC) += Z Hc^T; the raw
// partial to walk.out[out0 ..][k].
template <int R, Mode MODE, typename Walk, typename Ops>
__device__ __forceinline__ void w_partial_simt(const Ops& o, const Walk& walk) {
  static_assert(MODE == Mode::F32 || MODE == Mode::ANY, "f32 GEMMs only");
  constexpr int KC = 16 * R, LDW = KC + 4, NG = KC > KSL ? KC / KSL : 1, GW = KC / NG;
  extern __shared__ float4 smem_raw[];
  float* wr = reinterpret_cast<float*>(smem_raw);  // [TILE][LDW] resident W, or W H's steps
  float* ht = wr + TILE * LDW;                      // [KC][SLD] the step's H, this chunk
  float* zs = ht + KC * SLD;
  float* xs = zs + TILE * SLD;

  const int kc0 = blockIdx.y * KC;
  const int steps = walk.steps();
  const bool resident = R < 16 || o.k <= KC;
  const int depth = (o.k + 3) & ~3;

  float acc[4][R];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;

  if (steps > 0) {
    if (resident) stage_w<MODE, TILE, KC, LDW>(o, walk.res0, 0, walk.res_lim, wr);
    stage_xs<MODE>(o, walk.step(0).x, xs);
    cp_commit();
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const WalkStep st = walk.step(t);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      stage_h<MODE, GW, TILE, SLD>(o, kc0 + g * GW, st.r0, st.lim, ht + g * GW * SLD);
      cp_commit();
    }
    float s[4][4] = {};
    if (resident)
      recon_groups<NG, LDW, (R > 2)>(wr, ht, depth, s);
    else
      recon_streamed<MODE>(o, walk.res0, walk.res_lim, st.r0, st.lim, depth, wr, s);
    ratio_f32(o.eps, s, xs, zs);
    __syncthreads();
    if (t + 1 < steps) {
      stage_xs<MODE>(o, walk.step(t + 1).x, xs);
      cp_commit();
    }
    contract_w<R>(zs, ht, acc);
    __syncthreads();
  }

  const int ty = grid_ty(), tx = grid_tx();
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int gm = walk.out0 + ty + 16 * r, gk = kc0 + tx + 16 * c;
      if (gm < walk.out_lim && gk < o.k) walk.out[(size_t)gm * o.k + gk] = acc[r][c];
    }
}

}  // namespace
