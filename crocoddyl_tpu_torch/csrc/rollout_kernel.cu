// Trial rollout of B problems: one warp per problem, two problems per CTA,
// the T-loop inside the kernel.
//
// Replaces: crocoddyl_tpu/ops/fused_scans.py::trial_rollout_lanes (the
// Pallas kernel whose grid steps over t with the rollout state in VMEM
// scratch).  The step is rollout_step.cuh's: x_try = xnext ⊕ (α − 1)·f_t,
// u_try = u_t − α·k_t − K_t·(x_try ⊖ x_t), then the node primal, the cost
// sum and the failure flag.  α is read from device memory (a 0-d tensor),
// so the line search's step length never goes through the host.
//
// Bound on this card: latency.  The T steps of a problem are a dependent
// chain, and each step's node primal is a chain of small dependent
// operations; the operations bound (the card's float32 rate over the whole
// batch's work) ignores both.  The design's own floor is T × the critical
// path of one step.  Counted from the code, with the primal on a warp, a
// step is 48 warp barriers, 1 CTA barrier, 13 team sums (5 shuffles each)
// and 30 broadcasts, around ~2k dependent arithmetic operations: the two
// SE(3) maps on lane 0 (integrate, state_diff: ~150 each, twice for
// integrate), the kinematic sweep's 4 levels (~70 each), a mass-matrix
// entry (78 FMAs), the 18 Cholesky columns (~190), a 13-column triangular
// solve column (~340), the 12x12 Schur complement, its Cholesky and solve
// (~300), the heaviest cost term (~150).  PERF.md gives the measured time
// per link (kernel time / (T × links)).
//
// Design: each problem's primal runs on one warp (node_math.cuh's
// node_primal on a WarpTeam): joints of one tree level, dof columns, matrix
// entries, Cholesky rows, right-hand-side columns and cost terms go over
// the lanes.  Two warps per CTA: at B = 256 that is 128 CTAs on 128 of the
// 132 SMs; a CTA whose second warp lies past B runs problem B − 1 again
// and stores nothing.  Shared memory holds the descriptor (staged once per
// CTA), the knot parameters of steps t and t + 1 (shared by the CTA's two
// problems) and each warp's workspace: the primal's scratch, F and DX, and
// the double-buffered rows of its problem, which cp.async fills for step
// t + 1 while step t runs.  Nothing goes to device memory but the outputs.
//
// Not used, and why: tensor cores (each problem's matrices are at most
// 18x18 and differ from problem to problem); TF32 (float32 parity with the
// plain version is the rule of this port).
#include "rollout_step.cuh"

#ifdef __CUDACC__
namespace croc {

constexpr int kRolloutWarps = 2;

template <class T>
__global__ void __launch_bounds__(32 * kRolloutWarps)
rollout_kernel(int Tn, int B, int nmeta, int nrobot, int ws, const int* meta,
               const T* robot, const T* par, const T* x0, const T* xs,
               const T* us, const T* k, const T* K, const T* fs,
               const T* alpha_p, T* xs_try, T* us_try, T* x_last, T* cost,
               unsigned char* failed) {
  const T alpha = *alpha_p;  // the step length, from device memory
  rollout_cta<T, kRolloutWarps>(Tn, B, nmeta, nrobot, ws, meta, robot, par,
                                x0, xs, us, k, K, fs, alpha, xs_try, us_try,
                                x_last, cost, failed);
}

// grid, threads per CTA and dynamic shared memory of a launch at B
template <class T>
void rollout_shape(int B, int nmeta, int nrobot, int P, int ws, int* out) {
  out[0] = (B + kRolloutWarps - 1) / kRolloutWarps;
  out[1] = 32 * kRolloutWarps;
  out[2] = (int)rollout_smem<T>(nmeta, nrobot, P, ws, kRolloutWarps);
}

template <class T>
int launch_rollout(int Tn, int B, int nmeta, int nrobot, int P, int ws,
                   const int* meta, const T* robot, const T* par, const T* x0,
                   const T* xs, const T* us, const T* k, const T* K,
                   const T* fs, const T* alpha, T* xs_try, T* us_try,
                   T* x_last, T* cost, unsigned char* failed, void* stream) {
  int shape[3];
  rollout_shape<T>(B, nmeta, nrobot, P, ws, shape);
  if (shape[2] > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rollout_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shape[2]);
    if (e != cudaSuccess) return (int)e;
  }
  rollout_kernel<T><<<shape[0], shape[1], shape[2], (cudaStream_t)stream>>>(
      Tn, B, nmeta, nrobot, ws, meta, robot, par, x0, xs, us, k, K, fs,
      alpha, xs_try, us_try, x_last, cost, failed);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_ROLLOUT(NAME, T)                                                \
  extern "C" int NAME(int Tn, int B, int nmeta, int nrobot, int P, int ws,   \
                      const int* meta, const T* robot, const T* par,         \
                      const T* x0, const T* xs, const T* us, const T* k,     \
                      const T* K, const T* fs, const T* alpha, T* xs_try,      \
                      T* us_try, T* x_last, T* cost, unsigned char* failed,  \
                      void* stream) {                                        \
    return croc::launch_rollout<T>(Tn, B, nmeta, nrobot, P, ws, meta, robot, \
                                   par, x0, xs, us, k, K, fs, alpha, xs_try, \
                                   us_try, x_last, cost, failed, stream);    \
  }                                                                          \
  extern "C" void NAME##_shape(int B, int nmeta, int nrobot, int P, int ws,  \
                               int* out) {                                   \
    croc::rollout_shape<T>(B, nmeta, nrobot, P, ws, out);                    \
  }
CROC_ROLLOUT(croc_rollout_f32, float)
CROC_ROLLOUT(croc_rollout_f64, double)
#endif  // __CUDACC__
