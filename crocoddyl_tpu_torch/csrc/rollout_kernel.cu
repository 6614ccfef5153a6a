// Trial rollout: one thread per problem, the T-loop inside the kernel.
//
// Replaces: crocoddyl_tpu/ops/fused_scans.py::trial_rollout_lanes (the
// Pallas kernel whose grid steps over t with the rollout state in VMEM
// scratch).  Per step t, at a scalar step length α:
//   x_try = xnext ⊕ (α − 1)·f_t,  u_try = u_t − α·k_t − K_t·(x_try ⊖ x_t),
//   (xnext, c) = node primal at (x_try, u_try) with knot t's parameters,
// plus the running cost sum and the failure flag (|cost| or |xnext| ≥ 1e30
// or NaN).
//
// Bound on this card: latency and occupancy.  The T steps are a dependent
// chain, so the parallelism is the B problems: at B = 256 the launch is two
// 128-thread blocks on two of the 132 SMs, and each step runs the serial
// primal of node_math.cuh (kinematics, 18x18 Cholesky, 12x12 KKT) from
// device-memory scratch.  Most of the card idles; spreading one problem's
// node over a warp (or the B·T node primals of the next candidate over the
// card) is the first thing a later PR improves.
//
// Design: node-last layout (problem b at address i·B + b), knot parameters
// by knot index t from the packed (T, P) table, scratch of Lay::size + 2·ndx
// values per problem allocated by the wrapper.
#include "node_math.cuh"

namespace croc {

template <class T>
__global__ void __launch_bounds__(128)
rollout_kernel(int Tn, int B, const int* meta, const T* robot, const T* par,
               const T* x0, const T* xs, const T* us, const T* k, const T* K,
               const T* fs, T alpha, T* xs_try, T* us_try, T* x_last,
               T* cost, unsigned char* failed, T* scratch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const Desc<T> d{meta, robot};
  const int nv = d.nv(), nq = d.nq(), nx = nq + nv, ndx = 2 * nv, nu = d.nu();
  const Lay L(d);
  Arr<T> W{scratch + b, B};
  Arr<T> X = W.at(L.x), U = W.at(L.u), XN = W.at(L.xn), R = W.at(L.R);
  Arr<T> F = W.at(L.size), DX = W.at(L.size + ndx);
  for (int i = 0; i < nx; ++i) XN.st(i, x0[(long)i * B + b]);
  T c_sum = 0;
  bool bad = false;
  for (int t = 0; t < Tn; ++t) {
    const T* kp = par + (long)t * d.P();
    for (int i = 0; i < ndx; ++i)
      F.st(i, (alpha - T(1)) * fs[((long)t * ndx + i) * B + b]);
    integrate(d, XN, F, X);
    state_diff(d, xs + (long)t * nx * B + b, (long)B, X, DX, 0);
    for (int i = 0; i < nu; ++i) {
      long o = ((long)t * nu + i) * B + b;
      T ui = us[o] - alpha * k[o];
      for (int j = 0; j < ndx; ++j)
        ui -= K[(((long)t * nu + i) * ndx + j) * B + b] * DX.ld(j);
      U.st(i, ui);
      us_try[o] = ui;
    }
    for (int i = 0; i < nx; ++i) xs_try[((long)t * nx + i) * B + b] = X.ld(i);
    node_primal(d, kp, W);
    T dt = kp[d.m[H_DT]];
    T rate = cost_rate(d, kp, R, false, R, R);
    c_sum += dt == T(0) ? rate : dt * rate;
    T xmax = 0;
    bool nan_x = false;
    for (int i = 0; i < nx; ++i) {
      T a = fabs(XN.ld(i));
      nan_x |= !(a < T(1e30));
      xmax = a > xmax ? a : xmax;
    }
    bad |= !(fabs(c_sum) < T(1e30)) || nan_x;
  }
  for (int i = 0; i < nx; ++i) x_last[(long)i * B + b] = XN.ld(i);
  cost[b] = c_sum;
  failed[b] = bad ? 1 : 0;
}

template <class T>
int launch_rollout(int Tn, int B, const int* meta, const T* robot,
                   const T* par, const T* x0, const T* xs, const T* us,
                   const T* k, const T* K, const T* fs, double alpha,
                   T* xs_try, T* us_try, T* x_last, T* cost,
                   unsigned char* failed, T* scratch, void* stream) {
  rollout_kernel<T><<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      Tn, B, meta, robot, par, x0, xs, us, k, K, fs, T(alpha), xs_try,
      us_try, x_last, cost, failed, scratch);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_ROLLOUT(NAME, T)                                                \
  extern "C" int NAME(int Tn, int B, const int* meta, const T* robot,        \
                      const T* par, const T* x0, const T* xs, const T* us,   \
                      const T* k, const T* K, const T* fs, double alpha,     \
                      T* xs_try, T* us_try, T* x_last, T* cost,              \
                      unsigned char* failed, T* scratch, void* stream) {     \
    return croc::launch_rollout<T>(Tn, B, meta, robot, par, x0, xs, us, k,   \
                                   K, fs, alpha, xs_try, us_try, x_last,     \
                                   cost, failed, scratch, stream);           \
  }
CROC_ROLLOUT(croc_rollout_f32, float)
CROC_ROLLOUT(croc_rollout_f64, double)
