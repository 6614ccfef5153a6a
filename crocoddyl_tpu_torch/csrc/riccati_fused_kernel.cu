// Single-problem Riccati backward pass: the whole reversed-time loop in one
// CTA (the b=1 MPC replan's backward pass and every ladder probe).
//
// Replaces: crocoddyl_tpu/ops/fused_scans.py::riccati_backward_fused (the
// Pallas kernel that runs the T-loop in a fori inside one grid step, with
// the (Vx, Vxx, failed) carry in VMEM).  Per step the math and the failure
// flag of fused_scans.py:106-136: riccati_cta of riccati_pass.cuh, shared
// with the batched kernel (riccati_kernel.cu).
//
// Bound on this card: latency.  The launch is one CTA on one of 132 SMs,
// and its T = 108 steps are dependent; each step is ~0.3 MFLOP of 36x36
// products split over the CTA plus a 12-row Cholesky and the gains' solves
// in warp 0's registers, with five CTA barriers.  Its bytes (~2.4 MB in f32
// for the whole pass) would take under a microsecond at 3.35 TB/s.
//
// Design: one CTA of 256 threads, the batched kernel's CTA body on one
// problem: the step's blocks come in by cp.async one step ahead, and the
// critical path is warp 0's factorization and solves; a CTA of 512 threads
// took longer (more threads only lengthen the five barriers of a step).
// Inputs are contiguous single-problem arrays (T, ...): riccati_cta reads
// them with element stride 1 and time stride = the step's element count,
// problem index 0 of 1.  xreg and ureg are read from device memory (two
// 0-d tensors, so a solve's regularization never goes through the host);
// ``failed`` is one byte.
//
// Over P problems (a batch of solves, the counterpart of the Pallas
// kernel's batching rule under jax.vmap: one program instance a problem)
// the launch is P CTAs; CTA p runs the same body on problem p's arrays,
// which follow each other in memory (a leading problem axis), with its own
// xreg[p] and ureg[p].  At P = 1 the launch and the arithmetic are the
// single problem's.
#include "riccati_pass.cuh"

#ifdef __CUDACC__
#include "cta.cuh"

namespace croc {

constexpr int kRiccatiB1Threads = 256;

template <class T, int NU>
__global__ void __launch_bounds__(kRiccatiB1Threads)
riccati_b1_kernel(int Tn, int ndx, int nu, LaneStrides S, const T* Fx,
                  const T* Fu, const T* Lx, const T* Lu, const T* Lxx,
                  const T* Lxu, const T* Luu, const T* LxT, const T* LxxT,
                  const T* fs, const T* xreg_p, const T* ureg_p, T* Vx_o,
                  T* Vxx_o, T* Qu_o,
                  T* k_o, T* K_o, T* Quuk_o, unsigned char* failed_o) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // problem p's arrays: one problem's elements past problem p - 1's
  const long long p = blockIdx.x, t = Tn, x = ndx, u = nu;
  const T xreg = xreg_p[p], ureg = ureg_p[p];
  riccati_cta<T, NU>(BlockCta{}, AsyncPipe{}, Tn, 1, 0, ndx, nu, S,
                 Fx + p * t * x * x, Fu + p * t * x * u, Lx + p * t * x,
                 Lu + p * t * u, Lxx + p * t * x * x, Lxu + p * t * x * u,
                 Luu + p * t * u * u, LxT + p * x, LxxT + p * x * x,
                 fs + p * (t + 1) * x, xreg, ureg, Vx_o + p * (t + 1) * x,
                 Vxx_o + p * (t + 1) * x * x, Qu_o + p * t * u,
                 k_o + p * t * u, K_o + p * t * u * x, Quuk_o + p * t * u,
                 failed_o + p, reinterpret_cast<T*>(smem_raw));
}

template <class T, int NU>
int launch_riccati_b1(int P, int Tn, int ndx, int nu, const T* Fx, const T* Fu,
                      const T* Lx, const T* Lu, const T* Lxx, const T* Lxu,
                      const T* Luu, const T* LxT, const T* LxxT, const T* fs,
                      const T* xreg, const T* ureg, T* Vx, T* Vxx, T* Qu, T* k,
                      T* K, T* Quuk, unsigned char* failed, void* stream) {
  if (nu > kRiccatiMaxNu || ndx + 1 > 64) return (int)cudaErrorInvalidValue;
  size_t smem = riccati_smem(ndx, nu, sizeof(T));
  cudaError_t e = cudaFuncSetAttribute(
      riccati_b1_kernel<T, NU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  // contiguous (T, elems...) inputs: time stride = elements per step
  const long long step[10] = {
      (long long)ndx * ndx, (long long)ndx * nu, ndx, nu,
      (long long)ndx * ndx, (long long)ndx * nu, (long long)nu * nu,
      0, 0, ndx};
  LaneStrides S;
  for (int k = 0; k < 10; ++k) {
    S.ts[k] = step[k];
    S.es[k] = 1;
  }
  riccati_b1_kernel<T, NU><<<P, kRiccatiB1Threads, smem, (cudaStream_t)stream>>>(
      Tn, ndx, nu, S, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, xreg,
      ureg, Vx, Vxx, Qu, k, K, Quuk, failed);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_RICCATI_B1(NAME, T)                                             \
  extern "C" int NAME(int P, int Tn, int ndx, int nu, const T* Fx,          \
                      const T* Fu,                                           \
                      const T* Lx, const T* Lu, const T* Lxx, const T* Lxu,  \
                      const T* Luu, const T* LxT, const T* LxxT,             \
                      const T* fs, const T* xreg, const T* ureg, T* Vx,      \
                      T* Vxx,                                                \
                      T* Qu, T* k, T* K, T* Quuk, unsigned char* failed,     \
                      void* stream) {                                        \
    auto launch = croc::riccati_nu_pad(nu) == 12                             \
                      ? croc::launch_riccati_b1<T, 12>                       \
                      : croc::launch_riccati_b1<T, 16>;                      \
    return launch(P, Tn, ndx, nu, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT,  \
                  fs,                                                        \
                  xreg, ureg, Vx, Vxx, Qu, k, K, Quuk, failed, stream);      \
  }
CROC_RICCATI_B1(croc_riccati_b1_f32, float)
CROC_RICCATI_B1(croc_riccati_b1_f64, double)

// CTAs (of one problem; P problems launch P), threads per CTA and dynamic
// shared memory of a launch
extern "C" void croc_riccati_b1_shape(int ndx, int nu, int elem, int* out) {
  out[0] = 1;
  out[1] = croc::kRiccatiB1Threads;
  out[2] = (int)croc::riccati_smem(ndx, nu, (size_t)elem);
}
#endif  // __CUDACC__
