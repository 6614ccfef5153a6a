// Batched Riccati backward pass: one CTA per problem, reversed time inside
// the kernel.
//
// Replaces: crocoddyl_tpu/ops/fused_scans.py::riccati_backward_lanes (the
// Pallas kernel whose grid steps over reversed t with the (Vx, Vxx, failed)
// carry in VMEM scratch).  The per-step math and the failure flag are
// riccati_cta of riccati_pass.cuh, shared with the single-problem kernel.
//
// Bound on this card: latency of the T dependent steps, then memory: each
// step reads ~28 KB (f64) of derivatives per problem and writes Vxx and K.
// Problems sit on the last (lane) axis, so a CTA reads its own problem at
// stride B: every 4- or 8-byte value costs a 32-byte sector.
//
// Inputs are read through a (time stride, element stride) pair each, with
// the lane axis unit-stride: the solver hands the node kernel's (…, (T+1)·B)
// outputs over as strided (T, …, B) views, with no copy.
//
// Design: B CTAs of 256 threads, CTA b runs riccati_cta for problem b;
// Vxx and the step's blocks sit in dynamic shared memory (~59 KB in f64,
// above the 48 KB default, so the launcher raises the limit).
#include "riccati_pass.cuh"

namespace croc {

template <class T>
__global__ void __launch_bounds__(256)
riccati_kernel(int Tn, int B, int ndx, int nu, LaneStrides S, const T* Fx, const T* Fu,
               const T* Lx, const T* Lu, const T* Lxx, const T* Lxu,
               const T* Luu, const T* LxT, const T* LxxT, const T* fs,
               const T* xreg_b, const T* ureg_b, T* Vx_o, T* Vxx_o, T* Qu_o,
               T* k_o, T* K_o, T* Quuk_o, unsigned char* failed_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int bad;
  const int b = blockIdx.x;
  riccati_cta<T>(Tn, B, b, ndx, nu, S, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT,
                 LxxT, fs, xreg_b[b], ureg_b[b], Vx_o, Vxx_o, Qu_o, k_o, K_o,
                 Quuk_o, failed_o, reinterpret_cast<T*>(smem_raw), bad);
}

template <class T>
int launch_riccati(int Tn, int B, int ndx, int nu, const long long* strides,
                   const T* Fx, const T* Fu,
                   const T* Lx, const T* Lu, const T* Lxx, const T* Lxu,
                   const T* Luu, const T* LxT, const T* LxxT, const T* fs,
                   const T* xreg, const T* ureg, T* Vx, T* Vxx, T* Qu, T* k,
                   T* K, T* Quuk, unsigned char* failed, void* stream) {
  if (nu > 32) return (int)cudaErrorInvalidValue;  // one warp factors Quu
  size_t smem = riccati_smem(ndx, nu, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      riccati_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  LaneStrides S;
  for (int k = 0; k < 10; ++k) {
    S.ts[k] = strides[2 * k];
    S.es[k] = strides[2 * k + 1];
  }
  riccati_kernel<T><<<B, 256, smem, (cudaStream_t)stream>>>(
      Tn, B, ndx, nu, S, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, xreg,
      ureg, Vx, Vxx, Qu, k, K, Quuk, failed);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_RICCATI(NAME, T)                                                \
  extern "C" int NAME(int Tn, int B, int ndx, int nu,                       \
                      const long long* strides, const T* Fx,                 \
                      const T* Fu, const T* Lx, const T* Lu, const T* Lxx,   \
                      const T* Lxu, const T* Luu, const T* LxT,              \
                      const T* LxxT, const T* fs, const T* xreg,             \
                      const T* ureg, T* Vx, T* Vxx, T* Qu, T* k, T* K,       \
                      T* Quuk, unsigned char* failed, void* stream) {        \
    return croc::launch_riccati<T>(Tn, B, ndx, nu, strides, Fx, Fu, Lx, Lu,  \
                                   Lxx, Lxu, Luu, LxT, LxxT, fs, xreg, ureg, \
                                   Vx, Vxx, Qu, k, K, Quuk, failed, stream); \
  }
CROC_RICCATI(croc_riccati_f32, float)
CROC_RICCATI(croc_riccati_f64, double)
