// Batched Riccati backward pass: one CTA per problem, reversed time inside
// the kernel.
//
// Replaces: crocoddyl_tpu/ops/fused_scans.py::riccati_backward_lanes (the
// Pallas kernel whose grid steps over reversed t with the (Vx, Vxx, failed)
// carry in VMEM scratch).  The per-step math and the failure flag are
// riccati_cta of riccati_pass.cuh, shared with the single-problem kernel.
//
// Bound on this card: the latency of the T dependent steps.  Each step
// reads ~3.7k values of derivatives per problem (~15 KB in f32) and writes
// Vxx and K; a step's dependent chain (36-long dots, the 12-column
// Cholesky, two 12-row solves, the Vxx and Vx updates) is ~550 links.  The
// bytes bound (inputs read once, outputs written once) is ~0.18 ms at
// B = 256 in f32.
//
// Inputs are read through a (time stride, element stride) pair each, with
// the lane axis unit-stride: the solver hands the node kernel's (…, (T+1)·B)
// outputs over as strided (T, …, B) views, with no copy.  Problem b reads
// its values at stride B, so each 4-byte (8-byte) value costs a 32-byte
// sector in L1; the B CTAs run together (all resident: at most 2 per SM),
// so the neighbours of a sector are read from L2 by the CTAs of problems
// b ± 1.. while it is there, and HBM moves each sector about once.
//
// Design: B CTAs of 256 threads, CTA b runs riccati_cta for problem b: the
// next step's blocks come into a shared-memory double buffer by cp.async
// while the current step runs, five CTA barriers a step, the 12x12
// Cholesky and the gains' solves in warp 0's registers (riccati_pass.cuh).
// Shared memory: ~44 KB (f32) / ~88 KB (f64) a CTA, above the 48 KB
// default in f64, so the launcher raises the limit.  Not used, and why:
// tensor cores and TF32 (float32 parity with the plain version is the rule
// of this port, and TF32 moves the line search's decisions).
#include "riccati_pass.cuh"

#ifdef __CUDACC__
#include "cta.cuh"

namespace croc {

constexpr int kRiccatiThreads = 256;

template <class T, int NU>
__global__ void __launch_bounds__(kRiccatiThreads, 2)
riccati_kernel(int Tn, int B, int ndx, int nu, LaneStrides S, const T* Fx, const T* Fu,
               const T* Lx, const T* Lu, const T* Lxx, const T* Lxu,
               const T* Luu, const T* LxT, const T* LxxT, const T* fs,
               const T* xreg_b, const T* ureg_b, T* Vx_o, T* Vxx_o, T* Qu_o,
               T* k_o, T* K_o, T* Quuk_o, unsigned char* failed_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  riccati_cta<T, NU>(BlockCta{}, AsyncPipe{}, Tn, B, b, ndx, nu, S, Fx, Fu, Lx,
                 Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, xreg_b[b], ureg_b[b], Vx_o,
                 Vxx_o, Qu_o, k_o, K_o, Quuk_o, failed_o,
                 reinterpret_cast<T*>(smem_raw));
}

template <class T, int NU>
int launch_riccati(int Tn, int B, int ndx, int nu, const long long* strides,
                   const T* Fx, const T* Fu,
                   const T* Lx, const T* Lu, const T* Lxx, const T* Lxu,
                   const T* Luu, const T* LxT, const T* LxxT, const T* fs,
                   const T* xreg, const T* ureg, T* Vx, T* Vxx, T* Qu, T* k,
                   T* K, T* Quuk, unsigned char* failed, void* stream) {
  if (nu > kRiccatiMaxNu || ndx + 1 > 64) return (int)cudaErrorInvalidValue;
  size_t smem = riccati_smem(ndx, nu, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      riccati_kernel<T, NU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  LaneStrides S;
  for (int k = 0; k < 10; ++k) {
    S.ts[k] = strides[2 * k];
    S.es[k] = strides[2 * k + 1];
  }
  riccati_kernel<T, NU><<<B, kRiccatiThreads, smem, (cudaStream_t)stream>>>(
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
    auto launch = croc::riccati_nu_pad(nu) == 12                             \
                      ? croc::launch_riccati<T, 12>                          \
                      : croc::launch_riccati<T, 16>;                         \
    return launch(Tn, B, ndx, nu, strides, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu,    \
                  LxT, LxxT, fs, xreg, ureg, Vx, Vxx, Qu, k, K, Quuk, failed, \
                  stream);                                                   \
  }
CROC_RICCATI(croc_riccati_f32, float)
CROC_RICCATI(croc_riccati_f64, double)

// CTAs, threads per CTA and dynamic shared memory of a launch at B problems
extern "C" void croc_riccati_shape(int B, int ndx, int nu, int elem, int* out) {
  out[0] = B;
  out[1] = croc::kRiccatiThreads;
  out[2] = (int)croc::riccati_smem(ndx, nu, (size_t)elem);
}
#endif  // __CUDACC__
