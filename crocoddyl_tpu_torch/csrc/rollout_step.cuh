// The trial rollout of one problem on one team of lanes: the T-loop shared
// by kernel 3 (rollout_kernel.cu, one warp per problem), kernel 5
// (rollout_fused_kernel.cu, one warp for the one problem) and the host
// build of tests/test_torch_fused_scans.py (a team of std::threads).
//
// Per step t, at a scalar step length α (fused_scans.py:252-265):
//   x_try = xnext ⊕ (α − 1)·f_t,  u_try = u_t − α·k_t − K_t·(x_try ⊖ x_t),
//   (xnext, c) = node primal at (x_try, u_try) with knot t's parameters,
// plus the running cost sum and the failure flag (|cost| or |xnext| ≥ 1e30
// or NaN).  The terminal node stays with the caller.
//
// The inputs are node-last: element i of step t of problem b at
// (t·n + i)·B + b (B = 1 for kernel 5).  The rows of step t + 1 (xs, us, k,
// K, fs of the problem, and the knot parameters, which the problems of a
// CTA share) are copied into the other half of a double buffer while step
// t runs: none of them depends on the chain, so their latency leaves it.
#pragma once
#include "cta.cuh"
#include "node_math.cuh"

namespace croc {

// Elements of T of one step's rows of one problem (xs, us, k, K, fs)
template <class T> __device__ inline int step_row_elems(const Desc<T>& d) {
  const int nx = d.nq() + d.nv(), ndx = 2 * d.nv(), nu = d.nu();
  return nx + 2 * nu + nu * ndx + ndx;
}

// One problem's rollout.  ``tm`` is the problem's team; ``pipe`` copies one
// element (copy), closes a batch of copies (commit) and waits for them and
// for every thread of the CTA (wait); the CTA's threads ``cta_tid`` of
// ``cta_n`` share the copies of the knot parameters into ``parbuf`` (2·P).
// ``ws`` is the team's workspace of rollout_workspace_elems() values
// (ops/cuda_kernels.py).  A team with ``active`` false runs problem b
// without storing anything (the ragged edge of a CTA).
template <class T, class Team, class Pipe>
__device__ void rollout_problem(const Team& tm, const Pipe& pipe, int cta_tid, int cta_n,
                                const Desc<T>& d, int Tn, int B, int b, bool active,
                                const T* par, T* parbuf, T* ws, const T* x0,
                                const T* xs, const T* us, const T* k, const T* K,
                                const T* fs, T alpha, T* xs_try, T* us_try,
                                T* x_last, T* cost, unsigned char* failed) {
  const int ln = tm.lane(), nl = tm.size();
  const int nv = d.nv(), nq = d.nq(), nx = nq + nv, ndx = 2 * nv, nu = d.nu();
  const int P = d.P(), nrow = step_row_elems(d);
  const long sB = B;
  const Lay L(d);
  Arr<T> W{ws, 1};
  Arr<T> X = W.at(L.x), U = W.at(L.u), XN = W.at(L.xn), R = W.at(L.R);
  Arr<T> F = W.at(L.size), DX = W.at(L.size + ndx);
  T* rows = ws + L.size + 2 * ndx;

  auto fetch = [&](int t) {  // issue the copies of step t's rows
    T* r = rows + (t & 1) * nrow;
    T* pb = parbuf + (t & 1) * P;
    for (int i = cta_tid; i < P; i += cta_n) pipe.copy(pb + i, par + (long)t * P + i);
    for (int i = ln; i < nx; i += nl) pipe.copy(r + i, xs + ((long)t * nx + i) * sB + b);
    r += nx;
    for (int i = ln; i < nu; i += nl) {
      pipe.copy(r + i, us + ((long)t * nu + i) * sB + b);
      pipe.copy(r + nu + i, k + ((long)t * nu + i) * sB + b);
    }
    r += 2 * nu;
    for (int i = ln; i < nu * ndx; i += nl)
      pipe.copy(r + i, K + ((long)t * nu * ndx + i) * sB + b);
    r += nu * ndx;
    for (int i = ln; i < ndx; i += nl) pipe.copy(r + i, fs + ((long)t * ndx + i) * sB + b);
    pipe.commit();
  };

  for (int i = ln; i < nx; i += nl) XN.st(i, x0[i * sB + b]);
  fetch(0);
  T c_sum = 0;       // the same on every lane
  bool bad = false;  // this lane's share of the failure checks
  for (int t = 0; t < Tn; ++t) {
    pipe.wait();  // step t's rows are in, and the CTA is past step t - 1
    if (t + 1 < Tn) fetch(t + 1);
    const T* rx = rows + (t & 1) * nrow;
    const T *ru = rx + nx, *rk = ru + nu, *rK = rk + nu, *rf = rK + nu * ndx;
    const T* kp = parbuf + (t & 1) * P;
    for (int i = ln; i < ndx; i += nl) F.st(i, (alpha - T(1)) * rf[i]);
    tm.sync();
    integrate(tm, d, XN, F, X);
    tm.sync();
    state_diff(tm, d, rx, 1L, X, DX, 0);
    if (active)
      for (int i = ln; i < nx; i += nl) xs_try[((long)t * nx + i) * sB + b] = X.ld(i);
    tm.sync();
    // u_try: lanes over the columns of K, a team sum per row
    for (int i = 0; i < nu; ++i) {
      T s = 0;
      for (int j = ln; j < ndx; j += nl) s += rK[i * ndx + j] * DX.ld(j);
      s = tm.sum(s);
      if (ln == i % nl) {
        const T ui = ru[i] - alpha * rk[i] - s;
        U.st(i, ui);
        if (active) us_try[((long)t * nu + i) * sB + b] = ui;
      }
    }
    tm.sync();
    node_primal(tm, d, kp, W);
    const T dt = kp[d.m[H_DT]];
    const T rate = cost_rate(tm, d, kp, R, false, R, R);
    c_sum += dt == T(0) ? rate : dt * rate;
    bool nan_x = false;
    for (int i = ln; i < nx; i += nl) nan_x |= !(fabs(XN.ld(i)) < T(1e30));
    bad |= !(fabs(c_sum) < T(1e30)) || nan_x;
  }
  const bool any_bad = tm.sum(T(bad ? 1 : 0)) > T(0);
  if (active) {
    for (int i = ln; i < nx; i += nl) x_last[i * sB + b] = XN.ld(i);
    if (ln == 0) {
      cost[b] = c_sum;
      failed[b] = any_bad ? 1 : 0;
    }
  }
}

}  // namespace croc

#ifdef __CUDACC__
namespace croc {

// Dynamic shared memory of a rollout CTA: the descriptor (meta ints, robot
// floats), the double-buffered knot parameters, one workspace per warp.
template <class T>
__host__ __device__ inline size_t rollout_smem(int nmeta, int nrobot, int P, int ws, int warps) {
  return (size_t)up4(nmeta) * sizeof(int) +
         sizeof(T) * ((size_t)up4(nrobot) + 2 * (size_t)up4(P) + (size_t)warps * up4(ws));
}

// The body of a rollout CTA of WARPS warps, one problem per warp: stage the
// descriptor, then each warp runs its problem's rollout: problem
// blockIdx.x·WARPS + warp of B, or problem ``b`` where the caller names it.
template <class T, int WARPS>
__device__ void rollout_cta(int Tn, int B, int nmeta, int nrobot, int ws, const int* meta,
                            const T* robot, const T* par, const T* x0, const T* xs,
                            const T* us, const T* k, const T* K, const T* fs, T alpha,
                            T* xs_try, T* us_try, T* x_last, T* cost,
                            unsigned char* failed, int b = -1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_meta = reinterpret_cast<int*>(smem_raw);
  T* s_robot = reinterpret_cast<T*>(smem_raw + up4(nmeta) * sizeof(int));
  for (int i = threadIdx.x; i < nmeta; i += blockDim.x) s_meta[i] = meta[i];
  for (int i = threadIdx.x; i < nrobot; i += blockDim.x) s_robot[i] = robot[i];
  __syncthreads();
  const Desc<T> d{s_meta, s_robot};
  T* s_par = s_robot + up4(nrobot);
  const int warp = threadIdx.x >> 5;
  T* s_ws = s_par + 2 * up4(d.P()) + warp * up4(ws);
  if (b < 0) b = blockIdx.x * WARPS + warp;
  rollout_problem(WarpTeam{}, AsyncPipe{}, (int)threadIdx.x, (int)blockDim.x, d, Tn, B,
                  b < B ? b : B - 1, b < B, par, s_par, s_ws, x0, xs, us, k, K, fs,
                  alpha, xs_try, us_try, x_last, cost, failed);
}

}  // namespace croc
#endif  // __CUDACC__
