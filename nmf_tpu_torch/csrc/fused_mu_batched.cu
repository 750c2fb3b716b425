// K1 and K2 over a member axis for Hopper (sm_90a): nmf_h_update_batched
// and nmf_w_update_batched (K3's, nmf_kl_cost_batched, is in fused_mu.cu).
//
// These replace the TPU kernels of nmf_tpu/ops/pallas/fused_mu.py under
// jax.vmap (the batched, restart and rank-sweep solves), as fused_mu.cu's
// 2-D entry points replace them on one problem: one pass-1 and one pass-2
// launch serve all members, each member walked at the plan of its own
// shape, X per member or shared by all (fused_mu.cuh: struct Members).
// Member b gives the bits of the 2-D call on member b; a call of one member
// is the 2-D call.  This unit builds the member instances of the pass-1
// kernels (each block reads its member's operand pointers from shared
// memory), beside fused_mu.cu's 2-D ones, so that the two sets compile in
// parallel.

#include "fused_mu.cuh"

extern "C" {

int nmf_h_update(const void* w, const void* h, const void* x, const float* scales,
                 const float* sum_w, float* part, void* out, int m, int n, int k, int kc,
                 int splits, int tiles_per_split, float eps, int state_bf16, int x_kind,
                 int gemm, int numerator_only, int device, void* stream);
int nmf_w_update(const void* w, const void* h, const void* x, const float* scales,
                 const float* sum_h, float* part, void* out, int m, int n, int k, int kc,
                 int splits, int tiles_per_split, float eps, int state_bf16, int x_kind,
                 int gemm, int numerator_only, int device, void* stream);

// out[4] of a batched call's pass-1 kernel of K1 (h = 1) or K2 (h = 0), as
// nmf_partial_info gives the 2-D call's.
int nmf_member_partial_info(int h, int mode, int kc, int* out) {
  return h ? partial_info<true, true>(mode, kc, out) : partial_info<false, true>(mode, kc, out);
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
  if (members == 1 && (x_shared == 0 || x_shared == 1))
    return nmf_h_update(w, h, x, scales, sum_w, part, out, m, n, k, kc, splits,
                        tiles_per_split, eps, state_bf16, x_kind, gemm, numerator_only,
                        device, stream);
  return update<true, true>(w, h, x, scales, sum_w, part, out, m, n, k, kc, splits,
                            tiles_per_split, eps, state_bf16, x_kind, gemm,
                            numerator_only, device, stream, members, x_shared);
}

int nmf_w_update_batched(const void* w, const void* h, const void* x,
                         const float* scales, const float* sum_h, float* part,
                         void* out, int m, int n, int k, int kc, int splits,
                         int tiles_per_split, float eps, int state_bf16, int x_kind,
                         int gemm, int numerator_only, int device, void* stream,
                         int members, int x_shared) {
  if (members == 1 && (x_shared == 0 || x_shared == 1))
    return nmf_w_update(w, h, x, scales, sum_h, part, out, m, n, k, kc, splits,
                        tiles_per_split, eps, state_bf16, x_kind, gemm, numerator_only,
                        device, stream);
  return update<false, true>(w, h, x, scales, sum_h, part, out, m, n, k, kc, splits,
                             tiles_per_split, eps, state_bf16, x_kind, gemm,
                             numerator_only, device, stream, members, x_shared);
}

}  // extern "C"
