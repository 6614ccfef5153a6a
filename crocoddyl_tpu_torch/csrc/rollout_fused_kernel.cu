// Single-problem trial rollout: the T-loop on one warp (the b=1 MPC
// replan's line-search trial).
//
// Replaces: crocoddyl_tpu/ops/fused_scans.py::trial_rollout_fused (the
// Pallas kernel that runs the T-loop in a fori inside one grid step).  The
// step is rollout_step.cuh's, the same as kernel 3's (rollout_kernel.cu):
// x_try = xnext ⊕ (α − 1)·f_t, u_try = u_t − α·k_t − K_t·(x_try ⊖ x_t), then
// the node primal, the cost sum and the failure flag; the terminal node
// stays with the caller.  α is read from device memory (a 0-d tensor).
//
// Bound on this card: latency of one chain.  The T = 108 node primals are
// dependent, and each is a chain of small dependent operations; the pass
// moves ~0.3 MB and its ~13 MFLOP would take well under a microsecond
// spread over the card, so the bounds of bytes and operations are far out
// of reach.  The design's own floor is T × the critical path of one step's
// primal on a warp (rollout_kernel.cu gives the link count).
//
// Design: one CTA of one warp, B = 1 in kernel 3's layout (contiguous
// rows).  The warp runs the node primal as kernel 3's warps do; the
// descriptor is staged in shared memory once, and the knot parameters and
// the rows of step t + 1 (xs, us, k, K, fs) are copied by cp.async into a
// double buffer while step t runs, so no read of device memory sits on the
// chain.  Not used, and why: tensor cores (matrices of at most 18x18);
// TF32 (float32 parity with the plain version is the rule of this port).
#include "rollout_step.cuh"

#ifdef __CUDACC__
namespace croc {

template <class T>
__global__ void __launch_bounds__(32)
rollout_b1_kernel(int Tn, int nmeta, int nrobot, int ws, const int* meta,
                  const T* robot, const T* par, const T* x0, const T* xs,
                  const T* us, const T* k, const T* K, const T* fs,
                  const T* alpha_p, T* xs_try, T* us_try, T* x_last, T* cost,
                  unsigned char* failed) {
  const T alpha = *alpha_p;  // the step length, from device memory
  rollout_cta<T, 1>(Tn, 1, nmeta, nrobot, ws, meta, robot, par, x0, xs, us,
                    k, K, fs, alpha, xs_try, us_try, x_last, cost, failed);
}

template <class T>
int launch_rollout_b1(int Tn, int nmeta, int nrobot, int P, int ws,
                      const int* meta, const T* robot, const T* par,
                      const T* x0, const T* xs, const T* us, const T* k,
                      const T* K, const T* fs, const T* alpha, T* xs_try,
                      T* us_try, T* x_last, T* cost, unsigned char* failed,
                      void* stream) {
  const int smem = (int)rollout_smem<T>(nmeta, nrobot, P, ws, 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rollout_b1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  rollout_b1_kernel<T><<<1, 32, smem, (cudaStream_t)stream>>>(
      Tn, nmeta, nrobot, ws, meta, robot, par, x0, xs, us, k, K, fs,
      alpha, xs_try, us_try, x_last, cost, failed);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_ROLLOUT_B1(NAME, T)                                             \
  extern "C" int NAME(int Tn, int nmeta, int nrobot, int P, int ws,          \
                      const int* meta, const T* robot, const T* par,         \
                      const T* x0, const T* xs, const T* us, const T* k,     \
                      const T* K, const T* fs, const T* alpha, T* xs_try,      \
                      T* us_try, T* x_last, T* cost, unsigned char* failed,  \
                      void* stream) {                                        \
    return croc::launch_rollout_b1<T>(Tn, nmeta, nrobot, P, ws, meta, robot, \
                                      par, x0, xs, us, k, K, fs, alpha,      \
                                      xs_try, us_try, x_last, cost, failed,  \
                                      stream);                               \
  }
CROC_ROLLOUT_B1(croc_rollout_b1_f32, float)
CROC_ROLLOUT_B1(croc_rollout_b1_f64, double)
#endif  // __CUDACC__
