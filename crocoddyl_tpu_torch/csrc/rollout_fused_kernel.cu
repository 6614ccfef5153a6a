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
// Over P problems (a batch of solves, the counterpart of the Pallas
// kernel's batching rule under jax.vmap: one program instance a problem)
// the launch is P CTAs: CTA p runs problem p, at its own α[p], from its
// own x0, rows and knot parameters (a leading problem axis; xs and fs may
// be the first T rows of (P, T+1, ...) arrays, so their problem strides
// are arguments).  The descriptor's meta and robot are shared.  At P = 1
// the launch and the arithmetic are the single problem's.
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
rollout_b1_kernel(int Tn, int nmeta, int nrobot, int npar, int ws, int nx,
                  int nu, int ndx, long long xs_ps, long long fs_ps,
                  const int* meta, const T* robot, const T* par, const T* x0,
                  const T* xs, const T* us, const T* k, const T* K,
                  const T* fs, const T* alpha_p, T* xs_try, T* us_try,
                  T* x_last, T* cost, unsigned char* failed) {
  // problem p's arrays, its knots' parameters and its step length
  const long long p = blockIdx.x, t = Tn;
  const T alpha = alpha_p[p];
  rollout_cta<T, 1>(Tn, 1, nmeta, nrobot, ws, meta, robot,
                    par + p * t * npar, x0 + p * nx, xs + p * xs_ps,
                    us + p * t * nu, k + p * t * nu, K + p * t * nu * ndx,
                    fs + p * fs_ps, alpha, xs_try + p * t * nx,
                    us_try + p * t * nu, x_last + p * nx, cost + p,
                    failed + p, 0);
}

template <class T>
int launch_rollout_b1(int P, int Tn, int nmeta, int nrobot, int npar, int ws,
                      int nx, int nu, int ndx, long long xs_ps,
                      long long fs_ps, const int* meta, const T* robot,
                      const T* par, const T* x0, const T* xs, const T* us,
                      const T* k, const T* K, const T* fs, const T* alpha,
                      T* xs_try, T* us_try, T* x_last, T* cost,
                      unsigned char* failed, void* stream) {
  const int smem = (int)rollout_smem<T>(nmeta, nrobot, npar, ws, 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rollout_b1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  rollout_b1_kernel<T><<<P, 32, smem, (cudaStream_t)stream>>>(
      Tn, nmeta, nrobot, npar, ws, nx, nu, ndx, xs_ps, fs_ps, meta, robot,
      par, x0, xs, us, k, K, fs, alpha, xs_try, us_try, x_last, cost,
      failed);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_ROLLOUT_B1(NAME, T)                                             \
  extern "C" int NAME(int P, int Tn, int nmeta, int nrobot, int npar,        \
                      int ws, int nx, int nu, int ndx, long long xs_ps,      \
                      long long fs_ps, const int* meta, const T* robot,      \
                      const T* par, const T* x0, const T* xs, const T* us,   \
                      const T* k, const T* K, const T* fs, const T* alpha,   \
                      T* xs_try, T* us_try, T* x_last, T* cost,              \
                      unsigned char* failed, void* stream) {                 \
    return croc::launch_rollout_b1<T>(P, Tn, nmeta, nrobot, npar, ws, nx,    \
                                      nu, ndx, xs_ps, fs_ps, meta, robot,    \
                                      par, x0, xs, us, k, K, fs, alpha,      \
                                      xs_try, us_try, x_last, cost, failed,  \
                                      stream);                               \
  }
CROC_ROLLOUT_B1(croc_rollout_b1_f32, float)
CROC_ROLLOUT_B1(croc_rollout_b1_f64, double)
#endif  // __CUDACC__
