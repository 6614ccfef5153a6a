// Single-problem trial rollout: the T-loop in one CTA, the rollout state
// and the node primal's scratch in shared memory (the b=1 MPC replan's
// line-search trial).
//
// Replaces: crocoddyl_tpu/ops/fused_scans.py::trial_rollout_fused (the
// Pallas kernel that runs the T-loop in a fori inside one grid step).  Per
// step t, at a scalar step length α (fused_scans.py:252-265):
//   x_try = xnext ⊕ (α − 1)·f_t,  u_try = u_t − α·k_t − K_t·(x_try ⊖ x_t),
//   (xnext, c) = node primal at (x_try, u_try) with knot t's parameters,
// plus the running cost sum and the failure flag (|cost| or |xnext| ≥ 1e30
// or NaN).  The terminal node stays with the caller.
//
// Bound on this card: latency of one serial chain.  The T = 108 node
// primals are dependent, and each is a long chain of small dependent
// operations (kinematic sweep, 18x18 Cholesky, 12x12 KKT) on one thread;
// the pass moves ~0.3 MB, and its ~5 MFLOP would take well under a
// microsecond spread over the card.  Kernel 3 (rollout_kernel.cu) runs the
// same chain with its scratch in device memory at stride B, so every step
// of the chain waits on L2; here the chain waits on shared memory.
//
// Design: one CTA of 128 threads.  The primal's scratch (node_math.cuh's
// Lay, ~2k values: ~8 KB in f32, ~16 KB in f64) and the step vectors live
// in dynamic shared memory, read through Arr<T> at stride 1.  Thread 0 runs
// integrate, state_diff and the node primal; the CTA shares the loads and
// stores of the step and the K·dx product (warp w takes rows w, w + 4, ...,
// its lanes split the ndx columns and reduce with shuffles).  Spreading the
// node primal itself over a warp is later work.
#include "node_math.cuh"

namespace croc {

constexpr int kRolloutB1Threads = 128;

template <class T>
__global__ void __launch_bounds__(kRolloutB1Threads)
rollout_b1_kernel(int Tn, const int* meta, const T* robot, const T* par,
                  const T* x0, const T* xs, const T* us, const T* k,
                  const T* K, const T* fs, T alpha, T* xs_try, T* us_try,
                  T* x_last, T* cost, unsigned char* failed) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = nth >> 5;
  const Desc<T> d{meta, robot};
  const int nv = d.nv(), nq = d.nq(), nx = nq + nv, ndx = 2 * nv, nu = d.nu();
  const Lay L(d);
  Arr<T> W{reinterpret_cast<T*>(smem_raw), 1};
  Arr<T> X = W.at(L.x), U = W.at(L.u), XN = W.at(L.xn), R = W.at(L.R);
  Arr<T> F = W.at(L.size), DX = W.at(L.size + ndx);
  for (int i = tid; i < nx; i += nth) XN.st(i, x0[i]);
  T c_sum = 0;      // thread 0's
  bool bad = false;  // thread 0's
  for (int t = 0; t < Tn; ++t) {
    const T* kp = par + (long)t * d.P();
    for (int i = tid; i < ndx; i += nth)
      F.st(i, (alpha - T(1)) * fs[(long)t * ndx + i]);
    __syncthreads();
    if (tid == 0) {
      integrate(d, XN, F, X);
      state_diff(d, xs + (long)t * nx, 1L, X, DX, 0);
    }
    __syncthreads();
    for (int i = warp; i < nu; i += nwarp) {
      const T* Ki = K + ((long)t * nu + i) * ndx;
      T s = 0;
      for (int j = lane; j < ndx; j += 32) s += Ki[j] * DX.ld(j);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
      if (lane == 0) {
        const long o = (long)t * nu + i;
        const T ui = us[o] - alpha * k[o] - s;
        U.st(i, ui);
        us_try[o] = ui;
      }
    }
    for (int i = tid; i < nx; i += nth) xs_try[(long)t * nx + i] = X.ld(i);
    __syncthreads();
    if (tid == 0) {
      node_primal(d, kp, W);
      const T dt = kp[d.m[H_DT]];
      const T rate = cost_rate(d, kp, R, false, R, R);
      c_sum += dt == T(0) ? rate : dt * rate;
      bool nan_x = false;
      for (int i = 0; i < nx; ++i) nan_x |= !(fabs(XN.ld(i)) < T(1e30));
      bad |= !(fabs(c_sum) < T(1e30)) || nan_x;
    }
  }
  __syncthreads();
  for (int i = tid; i < nx; i += nth) x_last[i] = XN.ld(i);
  if (tid == 0) {
    *cost = c_sum;
    *failed = bad ? 1 : 0;
  }
}

template <class T>
int launch_rollout_b1(int Tn, int scratch_elems, const int* meta,
                      const T* robot, const T* par, const T* x0, const T* xs,
                      const T* us, const T* k, const T* K, const T* fs,
                      double alpha, T* xs_try, T* us_try, T* x_last, T* cost,
                      unsigned char* failed, void* stream) {
  const size_t smem = (size_t)scratch_elems * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rollout_b1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rollout_b1_kernel<T><<<1, kRolloutB1Threads, smem, (cudaStream_t)stream>>>(
      Tn, meta, robot, par, x0, xs, us, k, K, fs, T(alpha), xs_try, us_try,
      x_last, cost, failed);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_ROLLOUT_B1(NAME, T)                                             \
  extern "C" int NAME(int Tn, int scratch_elems, const int* meta,            \
                      const T* robot, const T* par, const T* x0,             \
                      const T* xs, const T* us, const T* k, const T* K,      \
                      const T* fs, double alpha, T* xs_try, T* us_try,       \
                      T* x_last, T* cost, unsigned char* failed,             \
                      void* stream) {                                        \
    return croc::launch_rollout_b1<T>(Tn, scratch_elems, meta, robot, par,   \
                                      x0, xs, us, k, K, fs, alpha, xs_try,   \
                                      us_try, x_last, cost, failed, stream); \
  }
CROC_ROLLOUT_B1(croc_rollout_b1_f32, float)
CROC_ROLLOUT_B1(croc_rollout_b1_f64, double)
