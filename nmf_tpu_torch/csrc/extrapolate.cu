// The accelerated loop's extrapolation of both factors, in one pass (sm_90a).
//
// This replaces no Pallas kernel: it is the elementwise `_extrap` of the JAX
// loop (nmf_tpu/models/solver.py:557-559), which XLA fuses into one loop over
// each factor, with the momentum read from the device.  For each pair
// (next, prev, ex) of one factor, element by element:
//
//   ex   = state(max(fma(f32(next) - f32(prev), m, f32(next)), f32(eps)))
//   prev = next
//
// with `m` the loop's momentum, f32 on the device (the host never reads
// it), and the result rounded to the state dtype (bf16: to nearest even, as
// torch's cast on sm_80+).  On a member axis (the batched loop, the
// counterpart of `jax.vmap` over `_extrap`) each factor is a stack of
// `members` equal slices and member i's elements take `m[i]`: each member
// gets the bits of the 2-D extrapolation at its own momentum.  It gives the bits of
// models/solver.py::extrapolate (torch.add(n, n - o, alpha=m), one FMA, and
// clamp_min, which keeps a NaN) with `prev = next` added: the carry and the
// iterate of one accelerated step, written where a CUDA graph of the loop
// keeps them.  `next` may be `ex` (the H-only step returns its W unchanged):
// each thread reads its element of every operand before it writes.
//
// What bounds it on this card.  Two elementwise maps: per element it reads
// two values and writes two (16 bytes in f32, 8 in bf16) for three flops,
// so the bytes bound it (3.35 TB/s on an H100 SXM).
//
// Design.  One launch for both factors (W's elements, then H's, in one
// index range of 16-byte units: 4 f32 or 8 bf16 values), a grid-stride loop
// of 16-byte loads and stores where every operand is 16-byte aligned and
// the unit is whole, element by element otherwise.  One member: the
// momentum is one load a thread.  Several: a unit reads the momentum of its
// first element's member, and of each element's where the unit crosses
// into the next member (two integer divisions a unit; the momenta are
// `members` floats, cached).  The plain torch version takes three
// elementwise passes a factor and two copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even
}

// One element: the extrapolation of `next` against `prev`.
template <typename T>
__device__ __forceinline__ T extrapolated(T next, T prev, float m, float eps) {
  const float n = to_f32(next);
  const float d = __fsub_rn(n, to_f32(prev));
  const float e = __fmaf_rn(d, m, n);
  return from_f32<T>(e < eps ? eps : e);   // a NaN stays NaN, as clamp_min keeps it
}

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;

template <typename T>
__global__ void __launch_bounds__(THREADS)
extrapolate_kernel(const T* next0, T* prev0, T* ex0, int n0,
                   const T* next1, T* prev1, T* ex1, int n1,
                   const float* momentum, int members, float eps, bool vec) {
  constexpr int L = 16 / sizeof(T);      // values a unit
  const float m0 = *momentum;
  // each member's slice of a factor
  const unsigned per0 = static_cast<unsigned>(n0 / members);
  const unsigned per1 = static_cast<unsigned>(n1 / members);
  const long long units0 = (n0 + L - 1) / L;
  const long long total = units0 + (n1 + L - 1) / L;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long u = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x; u < total;
       u += stride) {
    const bool first = u < units0;
    const long long j = (first ? u : u - units0) * L;
    const int n = first ? n0 : n1;
    const unsigned per = first ? per0 : per1;
    const T* next = first ? next0 : next1;
    T* prev = first ? prev0 : prev1;
    T* ex = first ? ex0 : ex1;
    // the momentum of element j; one member takes m0
    const unsigned uj = static_cast<unsigned>(j);
    const float mj = members == 1 ? m0 : __ldg(momentum + uj / per);
    const bool one = members == 1 || uj / per == (uj + L - 1) / per;
    if (vec && j + L <= n) {
      // every load before any store: `next` may be `ex`
      const uint4 a = *reinterpret_cast<const uint4*>(next + j);
      const uint4 b = *reinterpret_cast<const uint4*>(prev + j);
      const T* av = reinterpret_cast<const T*>(&a);
      const T* bv = reinterpret_cast<const T*>(&b);
      uint4 e;
      T* ev = reinterpret_cast<T*>(&e);
#pragma unroll
      for (int l = 0; l < L; ++l)
        ev[l] = extrapolated(av[l], bv[l], one ? mj : __ldg(momentum + (uj + l) / per), eps);
      *reinterpret_cast<uint4*>(prev + j) = a;
      *reinterpret_cast<uint4*>(ex + j) = e;
    } else {
      for (long long k = j; k < j + L && k < n; ++k) {
        const T a = next[k];
        const T b = prev[k];
        const float mk = one ? mj : __ldg(momentum + static_cast<unsigned>(k) / per);
        prev[k] = a;
        ex[k] = extrapolated(a, b, mk, eps);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch(const void* next0, void* prev0, void* ex0, int n0, const void* next1, void* prev1,
           void* ex1, int n1, const void* momentum, int members, float eps, cudaStream_t st) {
  constexpr int L = 16 / sizeof(T);
  const long long units = (static_cast<long long>(n0) + L - 1) / L + (n1 + L - 1) / L;
  const long long want = (units + THREADS - 1) / THREADS;
  const int blocks = static_cast<int>(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  const bool vec = aligned16(next0) && aligned16(prev0) && aligned16(ex0) &&
                   (n1 == 0 || (aligned16(next1) && aligned16(prev1) && aligned16(ex1)));
  extrapolate_kernel<T><<<blocks, THREADS, 0, st>>>(
      static_cast<const T*>(next0), static_cast<T*>(prev0), static_cast<T*>(ex0), n0,
      static_cast<const T*>(next1), static_cast<T*>(prev1), static_cast<T*>(ex1), n1,
      static_cast<const float*>(momentum), members, eps, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// next0, prev0, ex0, n0 (W's pair), next1, prev1, ex1, n1 (H's; n1 may be
// 0), the f32 momenta on the device (`members` of them: member i of a
// factor is its i-th slice of n / members elements), eps, state_bf16,
// device, stream.  Returns a cudaError_t (0: launched).
int nmf_extrapolate(const void* next0, void* prev0, void* ex0, int n0, const void* next1,
                    void* prev1, void* ex1, int n1, const void* momentum, int members,
                    float eps, int state_bf16, int device, void* stream) {
  if (n0 < 1 || n1 < 0 || members < 1 || n0 % members || n1 % members)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (state_bf16)
    return launch<__nv_bfloat16>(next0, prev0, ex0, n0, next1, prev1, ex1, n1, momentum,
                                 members, eps, st);
  return launch<float>(next0, prev0, ex0, n0, next1, prev1, ex1, n1, momentum, members, eps, st);
}

}  // extern "C"
