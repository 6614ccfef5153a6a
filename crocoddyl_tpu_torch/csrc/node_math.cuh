// Per-node spatial algebra shared by the node-linearization kernel
// (node_kernel.cu) and the trial-rollout kernels (rollout_kernel.cu,
// rollout_fused_kernel.cu, through rollout_step.cuh).
//
// Ports the lane math of crocoddyl_tpu/ops/fused_node.py (lane_kin,
// lane_mass_matrix, lane_bias_forces, the Contact3D KKT solve, the cost
// residuals, lane_integrate, _lane_state_diff) and the SE(3) Jacobians of
// the chain rule (ljac_se3_right, ljac_se3_right_inv) for ONE node,
// templated on the scalar (float or double) and, for the node primal, on a
// Team: the lanes that compute one node together (see "Teams" below).
//
// Memory: per-node arrays live in a workspace W read through Arr<T>: the
// team's slice of shared memory (stride 1) in the node and rollout
// kernels.  Only 3- and 6-vectors, 3x3 blocks and a few 6x6 blocks are
// kept in registers.
//
// The descriptor layout (meta ints, robot floats, packed knot parameters)
// is built by crocoddyl_tpu_torch/ops/cuda_kernels.py; keep both in sync.
#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#else
// Host build of the per-node math: tests/test_torch_fused_node.py and
// test_torch_fused_scans.py compile node_kernel.cu and rollout_kernel.cu
// with a C++ compiler and hold them to the JAX lane code.
#ifndef __device__
#define __device__
#endif
#endif
#include <math.h>

namespace croc {

// ---------------------------------------------------------------------------
// Scalar math for float and double
// ---------------------------------------------------------------------------

__device__ inline float dsqrt(float x) { return sqrtf(x); }
__device__ inline double dsqrt(double x) { return sqrt(x); }
__device__ inline float dsin(float x) { return sinf(x); }
__device__ inline double dsin(double x) { return sin(x); }
__device__ inline float dcos(float x) { return cosf(x); }
__device__ inline double dcos(double x) { return cos(x); }
__device__ inline float datan2(float y, float x) { return atan2f(y, x); }
__device__ inline double datan2(double y, double x) { return atan2(y, x); }

// ---------------------------------------------------------------------------
// Node-last array views
// ---------------------------------------------------------------------------

// An array of S for one node: element i at p[i * s].
template <class S> struct Arr {
  S* p; long s;
  __device__ S ld(int i) const { return p[(long)i * s]; }
  __device__ void st(int i, S x) const { p[(long)i * s] = x; }
  __device__ Arr at(int off) const { return Arr{p + (long)off * s, s}; }
};

// ---------------------------------------------------------------------------
// Small register types: 3-vectors, 6-vectors ([lin; ang]), 3x3 (row-major)
// ---------------------------------------------------------------------------

template <class S> struct V3 { S a[3]; };
template <class S> struct V6 { S a[6]; };
template <class S> struct M3 { S a[9]; };
template <class S> struct TF { M3<S> R; V3<S> p; };

template <class S> __device__ inline V3<S> v3(S x, S y, S z) { V3<S> r; r.a[0] = x; r.a[1] = y; r.a[2] = z; return r; }
template <class S> __device__ inline V3<S> add(V3<S> x, V3<S> y) { return v3<S>(x.a[0] + y.a[0], x.a[1] + y.a[1], x.a[2] + y.a[2]); }
template <class S> __device__ inline V3<S> sub(V3<S> x, V3<S> y) { return v3<S>(x.a[0] - y.a[0], x.a[1] - y.a[1], x.a[2] - y.a[2]); }
template <class S> __device__ inline V3<S> scl(S c, V3<S> x) { return v3<S>(c * x.a[0], c * x.a[1], c * x.a[2]); }
template <class S> __device__ inline V3<S> cross(V3<S> a, V3<S> b) {
  return v3<S>(a.a[1] * b.a[2] - a.a[2] * b.a[1], a.a[2] * b.a[0] - a.a[0] * b.a[2],
               a.a[0] * b.a[1] - a.a[1] * b.a[0]);
}
template <class S> __device__ inline S dot3(V3<S> a, V3<S> b) { return a.a[0] * b.a[0] + a.a[1] * b.a[1] + a.a[2] * b.a[2]; }
template <class S> __device__ inline V3<S> mv(const M3<S>& R, V3<S> x) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r.a[i] = R.a[3 * i] * x.a[0] + R.a[3 * i + 1] * x.a[1] + R.a[3 * i + 2] * x.a[2];
  return r;
}
template <class S> __device__ inline V3<S> mtv(const M3<S>& R, V3<S> x) {
  V3<S> r;
  for (int i = 0; i < 3; ++i) r.a[i] = R.a[i] * x.a[0] + R.a[3 + i] * x.a[1] + R.a[6 + i] * x.a[2];
  return r;
}
template <class S> __device__ inline M3<S> mm(const M3<S>& A, const M3<S>& B) {
  M3<S> C;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C.a[3 * i + j] = A.a[3 * i] * B.a[j] + A.a[3 * i + 1] * B.a[3 + j] + A.a[3 * i + 2] * B.a[6 + j];
  return C;
}
template <class S> __device__ inline M3<S> tr(const M3<S>& A) {
  M3<S> C;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) C.a[3 * i + j] = A.a[3 * j + i];
  return C;
}
template <class S> __device__ inline M3<S> eye3() {
  M3<S> C;
  for (int i = 0; i < 9; ++i) C.a[i] = S(i % 4 == 0 ? 1 : 0);
  return C;
}
template <class S> __device__ inline M3<S> skew(V3<S> v) {
  M3<S> K;
  K.a[0] = S(0); K.a[1] = -v.a[2]; K.a[2] = v.a[1];
  K.a[3] = v.a[2]; K.a[4] = S(0); K.a[5] = -v.a[0];
  K.a[6] = -v.a[1]; K.a[7] = v.a[0]; K.a[8] = S(0);
  return K;
}
template <class S> __device__ inline V3<S> lin(const V6<S>& m) { return v3<S>(m.a[0], m.a[1], m.a[2]); }
template <class S> __device__ inline V3<S> ang(const V6<S>& m) { return v3<S>(m.a[3], m.a[4], m.a[5]); }
template <class S> __device__ inline V6<S> v6(V3<S> l, V3<S> a) {
  V6<S> r;
  for (int i = 0; i < 3; ++i) { r.a[i] = l.a[i]; r.a[3 + i] = a.a[i]; }
  return r;
}
template <class S> __device__ inline V6<S> add6(V6<S> x, V6<S> y) {
  V6<S> r;
  for (int i = 0; i < 6; ++i) r.a[i] = x.a[i] + y.a[i];
  return r;
}

// spatial transform actions (dynamics/spatial.py)
template <class S> __device__ inline TF<S> compose(const TF<S>& A, const TF<S>& B) {
  TF<S> C; C.R = mm(A.R, B.R); C.p = add(A.p, mv(A.R, B.p)); return C;
}
template <class S> __device__ inline TF<S> inverse(const TF<S>& A) {
  TF<S> C; C.R = tr(A.R); C.p = scl(S(-1), mv(C.R, A.p)); return C;
}
template <class S> __device__ inline V6<S> act_motion(const TF<S>& X, const V6<S>& m) {
  V3<S> Ra = mv(X.R, ang(m));
  return v6(add(mv(X.R, lin(m)), cross(X.p, Ra)), Ra);
}
template <class S> __device__ inline V6<S> act_motion_inv(const TF<S>& X, const V6<S>& m) {
  return v6(mtv(X.R, sub(lin(m), cross(X.p, ang(m)))), mtv(X.R, ang(m)));
}
template <class S> __device__ inline V6<S> act_force(const TF<S>& X, const V6<S>& f) {
  V3<S> Rl = mv(X.R, lin(f));
  return v6(Rl, add(mv(X.R, ang(f)), cross(X.p, Rl)));
}
template <class S> __device__ inline V6<S> cross_motion(const V6<S>& v, const V6<S>& m) {
  return v6(add(cross(ang(v), lin(m)), cross(lin(v), ang(m))), cross(ang(v), ang(m)));
}
template <class S> __device__ inline V6<S> cross_force(const V6<S>& v, const V6<S>& f) {
  return v6(cross(ang(v), lin(f)), add(cross(ang(v), ang(f)), cross(lin(v), lin(f))));
}
// I·v for an inertia (m, c, Ic) (LInertia.mul_motion)
template <class S> __device__ inline V6<S> mul_motion(S m, V3<S> c, const M3<S>& Ic, const V6<S>& v) {
  V3<S> vl = lin(v), w = ang(v);
  V3<S> fl = scl(m, sub(vl, cross(c, w)));
  V3<S> fa = sub(add(scl(m, cross(c, vl)), mv(Ic, w)), scl(m, cross(c, cross(c, w))));
  return v6(fl, fa);
}

template <class S> __device__ inline V3<S> ld3(Arr<S> A, int o) { return v3<S>(A.ld(o), A.ld(o + 1), A.ld(o + 2)); }
template <class S> __device__ inline void st3(Arr<S> A, int o, V3<S> x) { for (int i = 0; i < 3; ++i) A.st(o + i, x.a[i]); }
template <class S> __device__ inline V6<S> ld6(Arr<S> A, int o) { V6<S> r; for (int i = 0; i < 6; ++i) r.a[i] = A.ld(o + i); return r; }
template <class S> __device__ inline void st6(Arr<S> A, int o, V6<S> x) { for (int i = 0; i < 6; ++i) A.st(o + i, x.a[i]); }
template <class S> __device__ inline M3<S> ldm(Arr<S> A, int o) { M3<S> r; for (int i = 0; i < 9; ++i) r.a[i] = A.ld(o + i); return r; }
template <class S> __device__ inline void stm(Arr<S> A, int o, const M3<S>& x) { for (int i = 0; i < 9; ++i) A.st(o + i, x.a[i]); }
template <class S, class T> __device__ inline V3<S> cv3(const T* p) { return v3<S>(S(p[0]), S(p[1]), S(p[2])); }
template <class S, class T> __device__ inline M3<S> cm3(const T* p) { M3<S> r; for (int i = 0; i < 9; ++i) r.a[i] = S(p[i]); return r; }

// ---------------------------------------------------------------------------
// Lie-group ops (dynamics/lie.py)
// ---------------------------------------------------------------------------

#define CROC_EPS2 1e-14

// q = (x, y, z, w)
template <class S> __device__ inline M3<S> quat_to_rot(S x, S y, S z, S w) {
  S xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  S wx = w * x, wy = w * y, wz = w * z;
  M3<S> R;
  R.a[0] = S(1) - S(2) * (yy + zz); R.a[1] = S(2) * (xy - wz); R.a[2] = S(2) * (xz + wy);
  R.a[3] = S(2) * (xy + wz); R.a[4] = S(1) - S(2) * (xx + zz); R.a[5] = S(2) * (yz - wx);
  R.a[6] = S(2) * (xz - wy); R.a[7] = S(2) * (yz + wx); R.a[8] = S(1) - S(2) * (xx + yy);
  return R;
}

// Shepperd with the where-chain of lrot_to_quat; q[4] out, w >= 0
template <class S> __device__ inline void rot_to_quat(const M3<S>& R, S* q) {
  const S* r = R.a;
  S c[4][4] = {
      {r[7] - r[5], r[2] - r[6], r[3] - r[1], S(1) + r[0] + r[4] + r[8]},
      {S(1) + r[0] - r[4] - r[8], r[1] + r[3], r[2] + r[6], r[7] - r[5]},
      {r[1] + r[3], S(1) - r[0] + r[4] - r[8], r[5] + r[7], r[2] - r[6]},
      {r[2] + r[6], r[5] + r[7], S(1) - r[0] - r[4] + r[8], r[3] - r[1]}};
  int best = 0;
  S bn = c[0][0] * c[0][0] + c[0][1] * c[0][1] + c[0][2] * c[0][2] + c[0][3] * c[0][3];
  for (int k = 1; k < 4; ++k) {
    S nk = c[k][0] * c[k][0] + c[k][1] * c[k][1] + c[k][2] * c[k][2] + c[k][3] * c[k][3];
    if (nk > bn) { best = k; bn = nk; }
  }
  S n = dsqrt(bn);
  S sg = S(c[best][3] / n < 0 ? -1 : 1);
  for (int i = 0; i < 4; ++i) q[i] = c[best][i] / n * sg;
}

template <class S> __device__ inline V3<S> quat_log(const S* q) {
  S sg = S(q[3] < 0 ? -1 : 1);
  V3<S> vec = v3<S>(q[0] * sg, q[1] * sg, q[2] * sg);
  S w = q[3] * sg;
  S n2 = dot3(vec, vec);
  bool small = n2 < CROC_EPS2;
  S scale;
  if (small) {
    scale = S(2) / w - S(2) * n2 / (S(3) * w * w * w);
  } else {
    S n = dsqrt(n2);
    scale = S(2) * datan2(n, w) / n;
  }
  return scl(scale, vec);
}

template <class S> __device__ inline V3<S> log3(const M3<S>& R) {
  S q[4];
  rot_to_quat(R, q);
  return quat_log(q);
}

// theta2, theta (masked to 1 when small), small
template <class S> __device__ inline bool theta_of(V3<S> w, S& t2, S& th) {
  t2 = dot3(w, w);
  bool small = t2 < CROC_EPS2;
  th = small ? S(1) : dsqrt(t2);
  return small;
}

template <class S> __device__ inline M3<S> exp3(V3<S> w) {
  S t2, th;
  bool small = theta_of(w, t2, th);
  S s = small ? S(1) - t2 / S(6) : dsin(th) / th;
  S c = small ? S(0.5) - t2 / S(24) : (S(1) - dcos(th)) / t2;
  M3<S> W = skew(w), W2 = mm(W, W), R = eye3<S>();
  for (int i = 0; i < 9; ++i) R.a[i] = R.a[i] + s * W.a[i] + c * W2.a[i];
  return R;
}

template <class S> __device__ inline M3<S> se3_v(V3<S> w, bool inverse) {
  S t2, th;
  bool small = theta_of(w, t2, th);
  M3<S> W = skew(w), W2 = mm(W, W), V = eye3<S>();
  S c1, c2;
  if (inverse) {
    c1 = S(-0.5);
    c2 = small ? S(1) / S(12) + t2 / S(720)
               : S(1) / t2 - (S(1) + dcos(th)) / (S(2) * th * dsin(th));
  } else {
    c1 = small ? S(0.5) - t2 / S(24) : (S(1) - dcos(th)) / t2;
    c2 = small ? S(1) / S(6) - t2 / S(120) : (th - dsin(th)) / (t2 * th);
  }
  for (int i = 0; i < 9; ++i) V.a[i] = V.a[i] + c1 * W.a[i] + c2 * W2.a[i];
  return V;
}

template <class S> __device__ inline TF<S> exp6(const V6<S>& xi) {
  TF<S> X; X.R = exp3(ang(xi)); X.p = mv(se3_v(ang(xi), false), lin(xi)); return X;
}

template <class S> __device__ inline V6<S> log6(const TF<S>& X) {
  V3<S> w = log3(X.R);
  return v6(mv(se3_v(w, true), X.p), w);
}

// ---------------------------------------------------------------------------
// SE(3) Jacobians (lie.py: jac_se3_right, jac_se3_right_inv, adjoint), as
// 6x6 row-major blocks
// ---------------------------------------------------------------------------

template <class S> struct M6 { S a[36]; };

// [[A, B], [0, A]]
template <class S> __device__ inline M6<S> block_upper(const M3<S>& A, const M3<S>& Bm) {
  M6<S> X;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      X.a[6 * i + j] = A.a[3 * i + j];
      X.a[6 * i + 3 + j] = Bm.a[3 * i + j];
      X.a[6 * (3 + i) + j] = S(0);
      X.a[6 * (3 + i) + 3 + j] = A.a[3 * i + j];
    }
  return X;
}

template <class S> __device__ inline M3<S> so3_right_inv(V3<S> w) {
  S t2, th;
  bool small = theta_of(w, t2, th);
  S c = small ? S(1) / S(12) + t2 / S(720)
              : S(1) / t2 - (S(1) + dcos(th)) / (S(2) * th * dsin(th));
  M3<S> W = skew(w), W2 = mm(W, W), J = eye3<S>();
  for (int i = 0; i < 9; ++i) J.a[i] = J.a[i] + S(0.5) * W.a[i] + c * W2.a[i];
  return J;
}

// the off-diagonal block Q(v, w) of the left SE(3) Jacobian
template <class S> __device__ inline M3<S> se3_q_left(V3<S> v, V3<S> w) {
  S t2, th;
  bool small = theta_of(w, t2, th);
  S c1, m2, m3;
  if (small) {
    c1 = S(1) / S(6) - t2 / S(120);
    m2 = S(-1) / S(24) + t2 / S(720);
    m3 = S(-1) / S(120) + t2 / S(5040);
  } else {
    S sn = dsin(th), cs = dcos(th);
    c1 = (th - sn) / (t2 * th);
    m2 = (S(1) - S(0.5) * t2 - cs) / (t2 * t2);
    m3 = (th - sn - t2 * th / S(6)) / (t2 * t2 * th);
  }
  M3<S> V = skew(v), W = skew(w);
  M3<S> WV = mm(W, V), VW = mm(V, W), WVW = mm(WV, W);
  M3<S> WWV = mm(W, WV), VWW = mm(VW, W), WVWW = mm(WVW, W), WWVW = mm(W, WVW);
  M3<S> Q;
  for (int i = 0; i < 9; ++i)
    Q.a[i] = S(0.5) * V.a[i] + c1 * (WV.a[i] + VW.a[i] + WVW.a[i])
             - m2 * (WWV.a[i] + VWW.a[i] - S(3) * WVW.a[i])
             - S(0.5) * (m2 - S(3) * m3) * (WVWW.a[i] + WWVW.a[i]);
  return Q;
}

// Jr(xi) = Jl(-xi)
template <class S> __device__ inline M6<S> jac_se3_right(const V6<S>& xi) {
  V3<S> v = scl(S(-1), lin(xi)), w = scl(S(-1), ang(xi));
  return block_upper(se3_v(w, false), se3_q_left(v, w));
}

template <class S> __device__ inline M6<S> jac_se3_right_inv(const V6<S>& xi) {
  V3<S> v = lin(xi), w = ang(xi);
  M3<S> Jri = so3_right_inv(w);
  M3<S> Qr = se3_q_left(scl(S(-1), v), scl(S(-1), w));
  M3<S> top = mm(Jri, mm(Qr, Jri));
  for (int i = 0; i < 9; ++i) top.a[i] = -top.a[i];
  return block_upper(Jri, top);
}

// Ad(R, p) = [[R, [p]x R], [0, R]]
template <class S> __device__ inline M6<S> se3_adjoint(const TF<S>& X) {
  return block_upper(X.R, mm(skew(X.p), X.R));
}


// ---------------------------------------------------------------------------
// Descriptor (built once per problem by ops/cuda_kernels.py)
// ---------------------------------------------------------------------------

enum MetaHeader {
  H_NJ = 0, H_NV, H_NQ, H_FF, H_NF, H_NCON, H_NCOST, H_P, H_NU, H_FULLACT,
  H_DT, H_ARM, H_NR, H_NC, H_NLEV, H_LEN = 16
};
enum JointType { J_FF = 0, J_REV = 1, J_PRIS = 2 };
enum CostType { C_STATE = 0, C_CONTROL, C_COM, C_FTRANS, C_FVEL, C_CONE, C_FORCE };
enum ActType { A_QUAD = 0, A_WQUAD, A_BARRIER, A_WBARRIER };
// per-cost ints: type, activation, fid/contact, weight, active, ref,
// act weights, act lb, act ub, nr, first residual row
enum CostField { CF_TYPE = 0, CF_ACT, CF_IDX, CF_W, CF_ON, CF_REF, CF_AW,
                 CF_ALB, CF_AUB, CF_NR, CF_ROW, CF_LEN = 12 };

// The header's sizes and the tables' offsets are read once, at
// construction, and kept in registers: the tables may sit in shared memory
// beside the workspace, and the compiler cannot keep a value loaded from
// there across the workspace's stores.
template <class T> struct Desc {
  const int* m;      // meta ints
  const T* rb;       // robot floats
  int nj_, nv_, nq_, nf_, ncon_, ncost_, P_, nu_, nr_, nc_, nlev_;
  int o_mask, o_fpar, o_con, o_cost, o_dofj, o_depth;
  bool ff_;
  __device__ Desc(const int* meta, const T* robot) : m(meta), rb(robot) {
    nj_ = m[H_NJ]; nv_ = m[H_NV]; nq_ = m[H_NQ]; ff_ = m[H_FF] != 0;
    nf_ = m[H_NF]; ncon_ = m[H_NCON]; ncost_ = m[H_NCOST]; P_ = m[H_P];
    nu_ = m[H_NU]; nr_ = m[H_NR]; nc_ = m[H_NC]; nlev_ = m[H_NLEV];
    o_mask = H_LEN + 4 * nj_;
    o_fpar = o_mask + nj_ * nv_;
    o_con = o_fpar + nf_;
    o_cost = o_con + 4 * ncon_;
    o_dofj = o_cost + CF_LEN * ncost_;
    o_depth = o_dofj + nv_;
  }
  __device__ int nj() const { return nj_; }
  __device__ int nv() const { return nv_; }
  __device__ int nq() const { return nq_; }
  __device__ bool ff() const { return ff_; }
  __device__ int nf() const { return nf_; }
  __device__ int ncon() const { return ncon_; }
  __device__ int ncost() const { return ncost_; }
  __device__ int P() const { return P_; }
  __device__ int nu() const { return nu_; }
  __device__ int nr() const { return nr_; }
  __device__ int nc() const { return nc_; }
  __device__ int jt(int j) const { return m[H_LEN + 4 * j]; }
  __device__ int jpar(int j) const { return m[H_LEN + 4 * j + 1]; }
  __device__ int voff(int j) const { return m[H_LEN + 4 * j + 2]; }
  __device__ bool amask(int i, int dof) const { return m[o_mask + i * nv_ + dof] != 0; }
  __device__ int fpar(int f) const { return m[o_fpar + f]; }
  __device__ int con(int c, int k) const { return m[o_con + 4 * c + k]; }
  __device__ int cost(int c, int k) const { return m[o_cost + CF_LEN * c + k]; }
  // the joint that owns dof k
  __device__ int dofj(int k) const { return m[o_dofj + k]; }
  // depth of joint j in the tree (the base is 0); nlev() levels in all
  __device__ int nlev() const { return nlev_; }
  __device__ int depth(int j) const { return m[o_depth + j]; }
  // robot floats: jp_R | jp_p | axis | mass | com | inertia | fp_R | fp_p |
  // gravity | kkt_damping
  __device__ const T* jpR(int j) const { return rb + 9 * j; }
  __device__ const T* jpp(int j) const { return rb + 9 * nj_ + 3 * j; }
  __device__ const T* axis(int j) const { return rb + 12 * nj_ + 3 * j; }
  __device__ T mass(int j) const { return rb[15 * nj_ + j]; }
  __device__ const T* com(int j) const { return rb + 16 * nj_ + 3 * j; }
  __device__ const T* inertia(int j) const { return rb + 19 * nj_ + 9 * j; }
  __device__ const T* fpR(int f) const { return rb + 28 * nj_ + 9 * f; }
  __device__ const T* fpp(int f) const { return rb + 28 * nj_ + 9 * nf_ + 3 * f; }
  __device__ const T* gravity() const { return rb + 28 * nj_ + 12 * nf_; }
  __device__ T damping() const { return rb[28 * nj_ + 12 * nf_ + 3]; }
};

// ---------------------------------------------------------------------------
// Teams: the lanes that compute one node primal together
// ---------------------------------------------------------------------------
//
// A Team gives lane() in [0, size()), sync() (a barrier of the team that
// also orders its memory accesses), sum(x) (the team's sum, the same value
// on every lane) and bcast(x) (lane 0's x on every lane).  Every lane must
// reach every sync, sum and bcast: control flow around them is uniform.
// Each phase below splits its work over the lanes by its own structure and
// ends in a sync.  Team1 is one lane: a serial reference (the host builds
// run it beside a team of 32), or one lane of a larger team running a small
// piece alone; with it, every phase runs its items in order and computes
// what a serial loop would.  WarpTeam is
// the 32 lanes of a warp: the node kernel's and the rollouts' team.  The
// host builds (tests/test_torch_fused_node.py, test_torch_fused_scans.py)
// bring a team of std::threads.
struct Team1 {
  __device__ int lane() const { return 0; }
  __device__ int size() const { return 1; }
  __device__ void sync() const {}
  template <class S> __device__ S sum(S x) const { return x; }
  template <class S> __device__ S bcast(S x) const { return x; }
};

#ifdef __CUDACC__
struct WarpTeam {
  __device__ int lane() const { return threadIdx.x & 31; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
  // butterfly: lanes i and i^o add the same two values, so every lane ends
  // with the same bits
  template <class S> __device__ S sum(S x) const {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  }
  template <class S> __device__ S bcast(S x) const { return __shfl_sync(0xffffffffu, x, 0); }
};
#endif

// The lane order reversed: loops that run beside a lane-0 or low-lane task
// start from the last lane.
template <class Team> __device__ inline int rlane(const Team& tm) { return tm.size() - 1 - tm.lane(); }

// (row a, column b) of entry e of a row-major lower triangle
__device__ inline void tri_index(int e, int& a, int& b) {
  a = (int)((dsqrt(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  while (a * (a + 1) / 2 > e) --a;
  while ((a + 1) * (a + 2) / 2 <= e) ++a;
  b = e - a * (a + 1) / 2;
}

// Scratch layout of the primal, in elements of T per node.  The total
// (``size``) must equal primal_scratch_elems() in ops/cuda_kernels.py.
// FI holds the products I_i·J_b of joint i's inertia with dof column b,
// FW joint i's bias wrench, YI the inverse placement of each contact frame.
struct Lay {
  int x, u, oR, op, vel, bias, vw, cw, Icw, J, M, tau, Jc, a0, X, Sk, lam,
      acc, ds, xn, R, FI, FW, YI, size;
  template <class T> __device__ explicit Lay(const Desc<T>& d) {
    int nj = d.nj(), nv = d.nv(), nx = d.nq() + nv, nc = d.nc();
    int o = 0;
    x = o; o += nx;      u = o; o += d.nu();
    oR = o; o += 9 * nj; op = o; o += 3 * nj; vel = o; o += 6 * nj;
    bias = o; o += 6 * nj; vw = o; o += 6 * nj; cw = o; o += 3 * nj;
    Icw = o; o += 9 * nj; J = o; o += 6 * nv; M = o; o += nv * nv;
    tau = o; o += nv;    Jc = o; o += nc * nv; a0 = o; o += nc;
    X = o; o += nv * (nc + 1); Sk = o; o += nc * nc; lam = o; o += nc;
    acc = o; o += nv;    ds = o; o += 2 * nv; xn = o; o += nx;     R = o; o += d.nr();
    FI = o; o += 6 * nj * nv; FW = o; o += 6 * nj; YI = o; o += 4 * nc;
    size = o;
  }
};

// ---------------------------------------------------------------------------
// Cholesky and triangular solves on scratch arrays (lchol / lcho_solve)
// ---------------------------------------------------------------------------

// In-place lower Cholesky of the n x n row-major A (only the lower triangle
// is read or written).  Column by column: the lanes take the rows from the
// pivot down, lane 0 holds the pivot row and broadcasts its square root.  A
// negative pivot gives NaN, which propagates: the failure signal.
template <class S, class Team> __device__ void chol_inplace(const Team& tm, Arr<S> A, int n) {
  const int ln = tm.lane(), nl = tm.size();
  for (int j = 0; j < n; ++j) {
    S dj = S(0);
    for (int i0 = j; i0 < n; i0 += nl) {
      const int i = i0 + ln;
      S t = S(0);
      if (i < n) {
        t = A.ld(i * n + j);
#pragma unroll 4
        for (int k = 0; k < j; ++k) t = t - A.ld(i * n + k) * A.ld(j * n + k);
      }
      if (i0 == j) dj = dsqrt(tm.bcast(t));
      if (i < n) A.st(i * n + j, i == j ? dj : t / dj);
    }
    tm.sync();
  }
}

// Column c of B (n rows, row stride ldb) <- (L Lᵀ)⁻¹ B, in place.
template <class S>
__device__ void cho_solve_col(Arr<S> L, int n, Arr<S> B, int c, int ldb) {
  for (int i = 0; i < n; ++i) {
    S s = B.ld(i * ldb + c);
#pragma unroll 4
    for (int k = 0; k < i; ++k) s = s - L.ld(i * n + k) * B.ld(k * ldb + c);
    B.st(i * ldb + c, s / L.ld(i * n + i));
  }
  for (int i = n - 1; i >= 0; --i) {
    S s = B.ld(i * ldb + c);
#pragma unroll 4
    for (int k = i + 1; k < n; ++k) s = s - L.ld(k * n + i) * B.ld(k * ldb + c);
    B.st(i * ldb + c, s / L.ld(i * n + i));
  }
}

// B (n x m, row-major, column stride ldb) <- (L Lᵀ)⁻¹ B, in place; the lanes
// take the columns.  No sync: the caller syncs before reading B.
template <class S, class Team>
__device__ void cho_solve(const Team& tm, Arr<S> L, int n, Arr<S> B, int m, int ldb) {
  for (int c = tm.lane(); c < m; c += tm.size()) cho_solve_col(L, n, B, c, ldb);
}

// ---------------------------------------------------------------------------
// State manifold ops on scratch arrays (lane_integrate, _lane_state_diff):
// the free-flyer SE(3) part on lane 0, the joint coordinates over the other
// lanes.  No sync: the caller syncs before reading ``out``.
// ---------------------------------------------------------------------------

// out = x ⊕ dx  (out may not alias x)
template <class T, class Team>
__device__ void integrate(const Team& tm, const Desc<T>& d, Arr<T> x, Arr<T> dx, Arr<T> out) {
  const int nq = d.nq(), nv = d.nv(), rl = rlane(tm), nl = tm.size();
  int i0 = 0;
  if (d.ff()) {
    if (tm.lane() == 0) {
      TF<T> Mff;
      Mff.R = quat_to_rot(x.ld(3), x.ld(4), x.ld(5), x.ld(6));
      Mff.p = ld3(x, 0);
      TF<T> Mn = compose(Mff, exp6(ld6(dx, 0)));
      T q[4];
      rot_to_quat(Mn.R, q);
      T n = dsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
      st3(out, 0, Mn.p);
      for (int i = 0; i < 4; ++i) out.st(3 + i, q[i] / n);
    }
    for (int i = 7 + rl; i < nq; i += nl) out.st(i, x.ld(i) + dx.ld(i - 1));
    i0 = nq;
  }
  for (int i = i0 + rl; i < nq; i += nl) out.st(i, x.ld(i) + dx.ld(i));
  for (int i = rl; i < nv; i += nl) out.st(nq + i, x.ld(nq + i) + dx.ld(nv + i));
}

// out[o:o+ndx] = x ⊖ xref for a constant xref read at stride ``xs``
template <class T, class Team>
__device__ void state_diff(const Team& tm, const Desc<T>& d, const T* xref, long xs,
                           Arr<T> x, Arr<T> out, int o) {
  const int nq = d.nq(), nv = d.nv(), rl = rlane(tm), nl = tm.size();
  int i0 = 0;
  if (d.ff()) {
    if (tm.lane() == 0) {
      TF<T> M0, M1;
      M0.R = quat_to_rot(xref[3 * xs], xref[4 * xs], xref[5 * xs], xref[6 * xs]);
      M0.p = v3<T>(xref[0], xref[xs], xref[2 * xs]);
      M1.R = quat_to_rot(x.ld(3), x.ld(4), x.ld(5), x.ld(6));
      M1.p = ld3(x, 0);
      st6(out, o, log6(compose(inverse(M0), M1)));
    }
    for (int i = 7 + rl; i < nq; i += nl) out.st(o + i - 1, x.ld(i) - xref[i * xs]);
    i0 = nq;
  }
  for (int i = i0 + rl; i < nq; i += nl) out.st(o + i, x.ld(i) - xref[i * xs]);
  for (int i = rl; i < nv; i += nl) out.st(o + nv + i, x.ld(nq + i) - xref[(nq + i) * xs]);
}

// ---------------------------------------------------------------------------
// The node primal: kinematics, dynamics (contact KKT), cost residuals, Euler
// step.  Reads x, u from W (layout Lay), knot parameters from kp; writes the
// residual stack R and xnext (x itself for dt = 0 nodes) into W.  Every
// lane of ``tm`` calls it; it ends in a sync.
// ---------------------------------------------------------------------------

// One joint of the kinematic sweep (lane_kin): its world placement,
// velocity and bias acceleration from its parent's.
template <class T>
__device__ void joint_kin(const Desc<T>& d, const Lay& L, Arr<T> W, int j) {
  Arr<T> X = W.at(L.x);
  const int nq = d.nq(), vo = d.voff(j), par = d.jpar(j), type = d.jt(j);
  const M3<T> jR = cm3<T>(d.jpR(j));
  const V3<T> jp = cv3<T>(d.jpp(j));
  TF<T> Xpl;
  V6<T> vJ;
  if (type == J_FF) {
    Xpl.R = mm(jR, quat_to_rot(X.ld(3), X.ld(4), X.ld(5), X.ld(6)));
    Xpl.p = add(jp, mv(jR, ld3(X, 0)));
    for (int i = 0; i < 6; ++i) vJ.a[i] = X.ld(nq + i);
  } else {
    const T qj = X.ld(vo + (d.ff() ? 1 : 0));
    const V3<T> ax = cv3<T>(d.axis(j)), z = v3<T>(T(0), T(0), T(0));
    V6<T> S6;
    if (type == J_REV) {
      M3<T> K = skew(ax), K2 = mm(K, K), RJ = eye3<T>();
      T s = dsin(qj), c = T(1) - dcos(qj);
      for (int i = 0; i < 9; ++i) RJ.a[i] = RJ.a[i] + s * K.a[i] + c * K2.a[i];
      Xpl.R = mm(jR, RJ);
      Xpl.p = jp;
      S6 = v6(z, ax);
    } else {
      Xpl.R = jR;
      Xpl.p = add(jp, mv(jR, scl(qj, ax)));
      S6 = v6(ax, z);
    }
    const T vj = X.ld(nq + vo);
    for (int i = 0; i < 6; ++i) vJ.a[i] = S6.a[i] * vj;
  }
  TF<T> Xw;
  V6<T> vel, bias;
  if (par < 0) {
    Xw = Xpl;
    vel = vJ;
    bias = cross_motion(vJ, vJ);
  } else {
    TF<T> Xp;
    Xp.R = ldm(W, L.oR + 9 * par);
    Xp.p = ld3(W, L.op + 3 * par);
    Xw = compose(Xp, Xpl);
    const TF<T> Xup = inverse(Xpl);
    vel = add6(act_motion(Xup, ld6(W, L.vel + 6 * par)), vJ);
    bias = add6(act_motion(Xup, ld6(W, L.bias + 6 * par)), cross_motion(vel, vJ));
  }
  stm(W, L.oR + 9 * j, Xw.R);
  st3(W, L.op + 3 * j, Xw.p);
  st6(W, L.vel + 6 * j, vel);
  st6(W, L.bias + 6 * j, bias);
}

// What follows from one joint's placement and velocity alone: its Jacobian
// columns, world velocity, world CoM and world inertia.
template <class T>
__device__ void joint_out(const Desc<T>& d, const Lay& L, Arr<T> W, int j) {
  Arr<T> J = W.at(L.J);
  const int vo = d.voff(j), type = d.jt(j);
  TF<T> Xw;
  Xw.R = ldm(W, L.oR + 9 * j);
  Xw.p = ld3(W, L.op + 3 * j);
  if (type == J_FF) {
    for (int k = 0; k < 6; ++k) {
      V6<T> e;
      for (int i = 0; i < 6; ++i) e.a[i] = T(i == k ? 1 : 0);
      st6(J, 6 * (vo + k), act_motion(Xw, e));
    }
  } else {
    const V3<T> ax = cv3<T>(d.axis(j)), z = v3<T>(T(0), T(0), T(0));
    st6(J, 6 * vo, act_motion(Xw, type == J_REV ? v6(z, ax) : v6(ax, z)));
  }
  st6(W, L.vw + 6 * j, act_motion(Xw, ld6(W, L.vel + 6 * j)));
  st3(W, L.cw + 3 * j, add(Xw.p, mv(Xw.R, cv3<T>(d.com(j)))));
  stm(W, L.Icw + 9 * j, mm(mm(Xw.R, cm3<T>(d.inertia(j))), tr(Xw.R)));
}

template <class T, class Team>
__device__ void node_primal(const Team& tm, const Desc<T>& d, const T* kp, Arr<T> W) {
  const Lay L(d);
  const int nj = d.nj(), nv = d.nv(), nq = d.nq(), nc = d.nc(), ncon = d.ncon();
  const int ln = tm.lane(), nl = tm.size(), rl = rlane(tm);
  Arr<T> X = W.at(L.x), U = W.at(L.u), J = W.at(L.J), M = W.at(L.M);
  Arr<T> TAU = W.at(L.tau), ACC = W.at(L.acc), LAM = W.at(L.lam);

  // ---- kinematic sweep by depth level: the joints of a level go over the
  // lanes (a team of one walks the joints in order: parents come first) ----
  const int nlev = nl == 1 ? 1 : d.nlev();
  for (int lev = 0; lev < nlev; ++lev) {
    for (int j = ln; j < nj; j += nl)
      if (nl == 1 || d.depth(j) == lev) joint_kin(d, L, W, j);
    tm.sync();
  }
  for (int j = ln; j < nj; j += nl) joint_out(d, L, W, j);
  tm.sync();

  // ---- products I_i·J_b (lanes over dofs b), bias wrenches (lanes over
  // joints, from the last lane) and contact frames -------------------------
  const V6<T> g6 = v6(v3<T>(-d.gravity()[0], -d.gravity()[1], -d.gravity()[2]),
                      v3<T>(T(0), T(0), T(0)));
  for (int i = 0; i < nj; ++i) {
    const T m = d.mass(i);
    const V3<T> c = ld3(W, L.cw + 3 * i);
    const M3<T> Ic = ldm(W, L.Icw + 9 * i);
    for (int b = ln; b < nv; b += nl)
      if (d.amask(i, b)) st6(W, L.FI + 6 * (i * nv + b), mul_motion(m, c, Ic, ld6(J, 6 * b)));
  }
  Arr<T> A0 = W.at(L.a0);
  for (int q = rl; q < nj + ncon; q += nl) {
    if (q < nj) {
      const T m = d.mass(q);
      const V3<T> c = ld3(W, L.cw + 3 * q);
      const M3<T> Ic = ldm(W, L.Icw + 9 * q);
      TF<T> Xw;
      Xw.R = ldm(W, L.oR + 9 * q);
      Xw.p = ld3(W, L.op + 3 * q);
      const V6<T> vw = ld6(W, L.vw + 6 * q);
      const V6<T> aw = add6(act_motion(Xw, ld6(W, L.bias + 6 * q)), g6);
      st6(W, L.FW + 6 * q, add6(mul_motion(m, c, Ic, aw),
                                cross_force(vw, mul_motion(m, c, Ic, vw))));
    } else {
      const int ci = q - nj, f = d.con(ci, 0), j = d.fpar(f);
      const T on = kp[d.con(ci, 3)];
      const T* pref = kp + d.con(ci, 1);
      const T* gains = kp + d.con(ci, 2);
      TF<T> Xj, fX;
      Xj.R = ldm(W, L.oR + 9 * j);
      Xj.p = ld3(W, L.op + 3 * j);
      fX.R = cm3<T>(d.fpR(f));
      fX.p = cv3<T>(d.fpp(f));
      const TF<T> Y = compose(Xj, fX), Yi = inverse(Y);
      stm(W, L.YI + 12 * ci, Yi.R);
      st3(W, L.YI + 12 * ci + 9, Yi.p);
      const V6<T> vf = act_motion_inv(fX, ld6(W, L.vel + 6 * j));
      const V6<T> ab = act_motion_inv(fX, ld6(W, L.bias + 6 * j));
      V3<T> a0 = add(lin(ab), cross(ang(vf), lin(vf)));
      a0 = add(a0, scl(gains[0], sub(Y.p, cv3<T>(pref))));
      a0 = add(a0, scl(gains[1], lin(vf)));
      st3(A0, 3 * ci, scl(on, a0));
    }
  }
  tm.sync();

  // ---- mass matrix M = Σ_i J_iᵀ I_i J_i (its lower triangle, the sum over
  // joints in joint order inside each entry) and tau - b, over the lanes ---
  const int ntri = nv * (nv + 1) / 2, arm = d.m[H_ARM];
  const int nu = d.nu(), u0 = d.m[H_FULLACT] ? 0 : 6;
  for (int e = ln; e < ntri + nv; e += nl) {
    if (e < ntri) {
      int a, b;
      tri_index(e, a, b);
      T acc = T(0);
      for (int i = 0; i < nj; ++i) {
        if (!d.amask(i, a) || !d.amask(i, b)) continue;
        for (int r = 0; r < 6; ++r) acc = acc + J.ld(6 * a + r) * W.ld(L.FI + 6 * (i * nv + b) + r);
      }
      if (arm >= 0 && a == b) acc = acc + kp[arm + a];
      M.st(a * nv + b, acc);
    } else {
      const int a = e - ntri;
      T acc = T(0);
      for (int i = 0; i < nj; ++i) {
        if (!d.amask(i, a)) continue;
        for (int r = 0; r < 6; ++r) acc = acc - J.ld(6 * a + r) * W.ld(L.FW + 6 * i + r);
      }
      if (a >= u0 && a < u0 + nu) acc = acc + U.ld(a - u0);
      TAU.st(a, acc);
    }
  }
  tm.sync();

  // ---- forward dynamics: Contact3D KKT via two Choleskys -----------------
  chol_inplace(tm, M, nv);
  if (nc) {
    Arr<T> JC = W.at(L.Jc), XS = W.at(L.X), SK = W.at(L.Sk);
    // X = M⁻¹ [Jcᵀ | tau - b]: the contact Jacobian by (contact, dof)
    for (int q = ln; q < ncon * nv + nv; q += nl) {
      if (q < ncon * nv) {
        const int ci = q / nv, a = q % nv, j = d.fpar(d.con(ci, 0));
        const T on = kp[d.con(ci, 3)];
        TF<T> Yi;
        Yi.R = ldm(W, L.YI + 12 * ci);
        Yi.p = ld3(W, L.YI + 12 * ci + 9);
        const V6<T> col = act_motion(Yi, ld6(J, 6 * a));
        for (int r = 0; r < 3; ++r) {
          const T v = d.amask(j, a) ? col.a[r] * on : T(0);
          JC.st((3 * ci + r) * nv + a, v);
          XS.st(a * (nc + 1) + 3 * ci + r, v);
        }
      } else {
        const int a = q - ncon * nv;
        XS.st(a * (nc + 1) + nc, TAU.ld(a));
      }
    }
    tm.sync();
    cho_solve(tm, M, nv, XS, nc + 1, nc + 1);
    tm.sync();
    // the Schur complement (lower triangle) and its right-hand side
    const T damp = d.damping();
    const int stri = nc * (nc + 1) / 2;
    for (int e = ln; e < stri + nc; e += nl) {
      if (e < stri) {
        int r, s;
        tri_index(e, r, s);
        const T mr = kp[d.con(r / 3, 3)], ms = kp[d.con(s / 3, 3)];
        T acc = T(0);
#pragma unroll 6
        for (int a = 0; a < nv; ++a) acc = acc + JC.ld(r * nv + a) * XS.ld(a * (nc + 1) + s);
        acc = acc * (mr * ms) + (r == s ? (T(1) - mr) + damp * mr * ms : T(0));
        SK.st(r * nc + s, acc);
      } else {
        const int r = e - stri;
        const T mr = kp[d.con(r / 3, 3)];
        T bl = A0.ld(r);
#pragma unroll 6
        for (int a = 0; a < nv; ++a) bl = bl + JC.ld(r * nv + a) * XS.ld(a * (nc + 1) + nc);
        LAM.st(r, -bl * mr);
      }
    }
    tm.sync();
    chol_inplace(tm, SK, nc);
    cho_solve(tm, SK, nc, LAM, 1, 1);
    tm.sync();
    for (int a = ln; a < nv; a += nl) {
      T acc = XS.ld(a * (nc + 1) + nc);
#pragma unroll 6
      for (int r = 0; r < nc; ++r) acc = acc + XS.ld(a * (nc + 1) + r) * LAM.ld(r);
      ACC.st(a, acc);
    }
  } else {
    for (int a = ln; a < nv; a += nl) ACC.st(a, TAU.ld(a));
    tm.sync();
    cho_solve(tm, M, nv, ACC, 1, 1);
  }
  tm.sync();

  // ---- cost residuals into the stack R: one cost term per lane -----------
  Arr<T> R = W.at(L.R);
  for (int ci = ln; ci < d.ncost(); ci += nl) {
    const int type = d.cost(ci, CF_TYPE), idx = d.cost(ci, CF_IDX);
    const int row = d.cost(ci, CF_ROW), nr = d.cost(ci, CF_NR);
    const T* ref = kp + d.cost(ci, CF_REF);
    if (type == C_STATE) {
      state_diff(Team1{}, d, ref, 1, X, R, row);
    } else if (type == C_CONTROL) {
      for (int i = 0; i < nr; ++i) R.st(row + i, U.ld(i) - ref[i]);
    } else if (type == C_COM) {
      V3<T> acc = v3<T>(T(0), T(0), T(0));
      T mt = 0;
      for (int i = 0; i < nj; ++i) {
        acc = add(acc, scl(d.mass(i), ld3(W, L.cw + 3 * i)));
        mt += d.mass(i);
      }
      st3(R, row, sub(scl(T(T(1) / mt), acc), cv3<T>(ref)));
    } else if (type == C_FTRANS || type == C_FVEL) {
      const int j = d.fpar(idx);
      TF<T> Xj, fX;
      Xj.R = ldm(W, L.oR + 9 * j);
      Xj.p = ld3(W, L.op + 3 * j);
      fX.R = cm3<T>(d.fpR(idx));
      fX.p = cv3<T>(d.fpp(idx));
      if (type == C_FTRANS) {
        st3(R, row, sub(compose(Xj, fX).p, cv3<T>(ref)));
      } else {
        const V6<T> vf = act_motion_inv(fX, ld6(W, L.vel + 6 * j));
        for (int i = 0; i < 6; ++i) R.st(row + i, vf.a[i] - ref[i]);
      }
    } else if (type == C_CONE) {
      for (int i = 0; i < nr; ++i) {
        T acc = T(0);
        for (int k = 0; k < 3; ++k) acc = acc + ref[3 * i + k] * LAM.ld(3 * idx + k);
        R.st(row + i, acc);
      }
    } else {  // C_FORCE
      for (int i = 0; i < nr; ++i) R.st(row + i, LAM.ld(3 * idx + i) - ref[i]);
    }
  }

  // ---- semi-implicit Euler step (dt = 0: xnext = x) ----------------------
  const T dt = kp[d.m[H_DT]];
  Arr<T> XN = W.at(L.xn);
  if (dt == T(0)) {
    for (int i = rl; i < nq + nv; i += nl) XN.st(i, X.ld(i));
  } else {
    Arr<T> DS = W.at(L.ds);
    for (int a = rl; a < nv; a += nl) {
      const T acc = ACC.ld(a);
      DS.st(a, X.ld(nq + a) * dt + acc * (dt * dt));
      DS.st(nv + a, acc * dt);
    }
    tm.sync();
    integrate(tm, d, X, DS, XN);
  }
  tm.sync();
}

// (a, Ar, Arr) of one activation on residual values r (values only: the
// derivatives never differentiate the activation, Gauss-Newton style).
// Ar/Arr are written when ``grad`` is set.
template <class T>
__device__ T activation(int type, int nr, Arr<T> r, const T* w, const T* lb,
                        const T* ub, bool grad, Arr<T> Ar, Arr<T> Arr2) {
  T a = 0;
  for (int i = 0; i < nr; ++i) {
    T ri = r.ld(i);
    if (type == A_QUAD || type == A_WQUAD) {
      T wi = type == A_QUAD ? T(1) : w[i];
      a += T(0.5) * ri * (wi * ri);
      if (grad) { Ar.st(i, wi * ri); Arr2.st(i, wi); }
    } else {
      T rlb = ri - lb[i] < T(0) ? ri - lb[i] : T(0);
      T rub = ri - ub[i] > T(0) ? ri - ub[i] : T(0);
      T on = (ri - lb[i] <= T(0) || ri - ub[i] >= T(0)) ? T(1) : T(0);
      if (type == A_BARRIER) {
        a += T(0.5) * rlb * rlb + T(0.5) * rub * rub;
        if (grad) { Ar.st(i, rlb + rub); Arr2.st(i, on); }
      } else {
        T rb = rlb + rub;
        a += T(0.5) * rb * (w[i] * rb);
        if (grad) { Ar.st(i, w[i] * rb); Arr2.st(i, w[i] * on); }
      }
    }
  }
  return a;
}

// cost rate Σ active·weight·a(R) from the residual values of W, one cost
// term per lane and a team sum; with ``grad``, Ar/Arr of every residual
// row go to AR/ARR
template <class T, class Team>
__device__ T cost_rate(const Team& tm, const Desc<T>& d, const T* kp, Arr<T> R, bool grad,
                       Arr<T> AR, Arr<T> ARR) {
  T part = 0;
  for (int ci = tm.lane(); ci < d.ncost(); ci += tm.size()) {
    const int row = d.cost(ci, CF_ROW), nr = d.cost(ci, CF_NR);
    const T* w = kp + d.cost(ci, CF_AW);
    const T* lb = kp + d.cost(ci, CF_ALB);
    const T* ub = kp + d.cost(ci, CF_AUB);
    const T a = activation(d.cost(ci, CF_ACT), nr, R.at(row), w, lb, ub, grad,
                           AR.at(row), ARR.at(row));
    part += kp[d.cost(ci, CF_ON)] * kp[d.cost(ci, CF_W)] * a;
  }
  return tm.sum(part);
}

}  // namespace croc
