// Node linearization: one thread per node over N = K·B nodes.
//
// Replaces: crocoddyl_tpu/ops/fused_node.py::calc_both_lanes (the Pallas
// kernel over lane_calc_both): per node, the kinematic sweep, mass matrix
// and bias forces, the Contact3D KKT solve, the closed-form tangents
// (lane_gforce_derivatives, lane_frame_tangents), the seven cost residuals
// and their Jacobians, the Gauss-Newton Lx/Lu/Lxx/Lxu/Luu and the Euler /
// free-flyer chain rule, with the dt=0 terminal semantics (Fx = I, Fu = 0,
// xnext = x, cost not scaled).
//
// Bound on this card: latency.  One thread per node gives 27,904 threads at
// bench size (about 6.6 warps per SM), and each thread works through a long
// chain of dependent loads and stores on its node-last scratch, which far
// exceeds L2 at that size.  The outputs (~14.7 KB per node in f32) would
// take ~0.12 ms at full bandwidth; they are not what bounds the kernel.
//
// Design: the derivatives are the closed-form tangents of the JAX lane code,
// evaluated once per node after one primal pass (node_math.cuh).  Node-last
// layout everywhere (thread n reads and writes address i·N + n), so a warp's
// accesses coalesce as the TPU lanes did.  Knot parameters are read by knot
// index k = n / B from a packed (K, P) table instead of being broadcast to
// lane width.  Intermediates go to a wrapper-allocated node-last scratch
// tensor: the primal's Lay plus the TanLay below; the only per-thread local
// arrays are one residual row (nd ≤ 64 values) and a few 6x6 blocks.
// The primal is node_math.cuh's node_primal on a team of one (Team1), the
// same code the rollout kernels run on a warp.  Spreading a node's
// tangents over a warp (one thread per dof column) is the first thing a
// later PR does about the latency.
#include "node_math.cuh"

namespace croc {

// Scratch layout of the tangent pass, after the primal's Lay, in elements
// of T per node.  The total (``size``) must equal tangent_scratch_elems() in
// ops/cuda_kernels.py.
struct TanLay {
  int bw, ua, PS, F, cw, cu, zq, zv, da, dl, JR, AR, ARR, size;
  template <class T> __device__ TanLay(const Desc<T>& d, int o) {
    int nj = d.nj(), nv = d.nv(), nd = 2 * nv + d.nu(), nc = d.nc();
    int nr = d.nr();
    bw = o; o += 6 * nj;   ua = o; o += 6 * nj;   PS = o; o += 36 * nj;
    F = o; o += 6 * nv;    cw = o; o += 6 * nv;   cu = o; o += 6 * nv;
    zq = o; o += 6 * nv;   zv = o; o += 6 * nv;   da = o; o += nv * nd;
    dl = o; o += nc * nd;  JR = o; o += nr * nd;  AR = o; o += nr;
    ARR = o; o += nr;
    size = o;
  }
};

template <class S> __device__ inline V6<S> zero6() {
  V6<S> r;
  for (int i = 0; i < 6; ++i) r.a[i] = S(0);
  return r;
}
template <class S> __device__ inline V6<S> sub6(V6<S> x, V6<S> y) {
  V6<S> r;
  for (int i = 0; i < 6; ++i) r.a[i] = x.a[i] - y.a[i];
  return r;
}
template <class S> __device__ inline V6<S> scl6(S c, V6<S> x) {
  V6<S> r;
  for (int i = 0; i < 6; ++i) r.a[i] = c * x.a[i];
  return r;
}
template <class S> __device__ inline S dot6(const V6<S>& x, const V6<S>& y) {
  S s = S(0);
  for (int i = 0; i < 6; ++i) s += x.a[i] * y.a[i];
  return s;
}
// P·s for a 6x6 row-major block in scratch
template <class T> __device__ inline V6<T> mv6(Arr<T> P, const V6<T>& s) {
  V6<T> r;
  for (int i = 0; i < 6; ++i) {
    T acc = T(0);
    for (int c = 0; c < 6; ++c) acc += P.ld(6 * i + c) * s.a[c];
    r.a[i] = acc;
  }
  return r;
}
template <class T> __device__ inline int dof_width(const Desc<T>& d, int j) {
  return d.jt(j) == J_FF ? 6 : 1;
}

// The per-joint and per-dof context of the tangents (lane_tan_ctx): world
// bias accelerations bw, the world accelerations ua of the joint
// accelerations a, PS = Σ over ancestors of (vJ ×)(vw ×) + (vw ×)(vJ ×),
// and per dof k: cw = S_k × v_parent, cu = S_k × u_parent, the zetas.
template <class T>
__device__ void tangent_context(const Desc<T>& d, const Lay& L,
                                const TanLay& G, Arr<T> W) {
  const int nj = d.nj(), nv = d.nv();
  Arr<T> J = W.at(L.J), ACC = W.at(L.acc);
  for (int j = 0; j < nj; ++j) {
    TF<T> Xw;
    Xw.R = ldm(W, L.oR + 9 * j);
    Xw.p = ld3(W, L.op + 3 * j);
    st6(W, G.bw + 6 * j, act_motion(Xw, ld6(W, L.bias + 6 * j)));
    const int p = d.jpar(j);
    V6<T> ua = p >= 0 ? ld6(W, G.ua + 6 * p) : zero6<T>();
    for (int k = d.voff(j); k < d.voff(j) + dof_width(d, j); ++k)
      ua = add6(ua, scl6(ACC.ld(k), ld6(J, 6 * k)));
    st6(W, G.ua + 6 * j, ua);
    V6<T> vw = ld6(W, L.vw + 6 * j);
    V6<T> vJ = p >= 0 ? sub6(vw, ld6(W, L.vw + 6 * p)) : vw;
    for (int c = 0; c < 6; ++c) {  // column c of PS[j] = PS[p] + Kk e_c
      V6<T> e = zero6<T>();
      e.a[c] = T(1);
      V6<T> col = add6(cross_motion(cross_motion(e, vw), vJ),
                       cross_motion(vw, cross_motion(e, vJ)));
      for (int r = 0; r < 6; ++r) {
        T prev = p >= 0 ? W.ld(G.PS + 36 * p + 6 * r + c) : T(0);
        W.st(G.PS + 36 * j + 6 * r + c, prev + col.a[r]);
      }
    }
  }
  for (int k = 0; k < nv; ++k) {
    const int jk = d.dofj(k), pk = d.jpar(jk);
    V6<T> Sk = ld6(J, 6 * k);
    V6<T> wv = pk >= 0 ? ld6(W, L.vw + 6 * pk) : zero6<T>();
    V6<T> uw = pk >= 0 ? ld6(W, G.ua + 6 * pk) : zero6<T>();
    V6<T> PSs = pk >= 0 ? mv6(W.at(G.PS + 36 * pk), Sk) : zero6<T>();
    V6<T> cw = cross_motion(Sk, wv), cu = cross_motion(Sk, uw);
    st6(W, G.cw + 6 * k, cw);
    st6(W, G.cu + 6 * k, cu);
    st6(W, G.zq + 6 * k, add6(sub6(scl6(T(-1), cu), PSs), cross_motion(cw, wv)));
    st6(W, G.zv + 6 * k, add6(scl6(T(-1), cw),
                              cross_motion(ld6(W, L.vw + 6 * jk), Sk)));
  }
}

// r1 = [−dG/dq | −dG/dv | dtau/du] (nv x nd) into DA
// (lane_gforce_derivatives; the contact wrenches enter as ext_w)
template <class T>
__device__ void gforce_derivatives(const Desc<T>& d, const T* kp,
                                   const Lay& L, const TanLay& G, Arr<T> W) {
  const int nj = d.nj(), nv = d.nv(), ndx = 2 * nv, nu = d.nu();
  const int nd = ndx + nu;
  Arr<T> J = W.at(L.J), DA = W.at(G.da), F = W.at(G.F), LAM = W.at(L.lam);
  for (int i = 0; i < nv * nd; ++i) DA.st(i, T(0));
  for (int i = 0; i < 6 * nv; ++i) F.st(i, T(0));
  const V6<T> g6 = v6(v3<T>(-d.gravity()[0], -d.gravity()[1], -d.gravity()[2]),
                      v3<T>(T(0), T(0), T(0)));
  for (int j = 0; j < nj; ++j) {
    const T m = d.mass(j);
    const V3<T> c = ld3(W, L.cw + 3 * j);
    const M3<T> Ic = ldm(W, L.Icw + 9 * j);
    const V6<T> vw = ld6(W, L.vw + 6 * j);
    const V6<T> biasg = add6(ld6(W, G.bw + 6 * j), g6);
    const V6<T> h = mul_motion(m, c, Ic, add6(biasg, ld6(W, G.ua + 6 * j)));
    const V6<T> h2 = mul_motion(m, c, Ic, vw);
    V6<T> ext = zero6<T>();
    for (int ci = 0; ci < d.ncon(); ++ci) {
      const int f = d.con(ci, 0);
      if (d.fpar(f) != j) continue;
      TF<T> fX, Y;
      fX.R = cm3<T>(d.fpR(f));
      fX.p = cv3<T>(d.fpp(f));
      Y.R = ldm(W, L.oR + 9 * j);
      Y.p = ld3(W, L.op + 3 * j);
      Y = compose(Y, fX);
      V6<T> w = v6(ld3(LAM, 3 * ci), v3<T>(T(0), T(0), T(0)));
      ext = add6(ext, act_force(Y, w));
    }
    const V6<T> f = sub6(add6(h, cross_force(vw, h2)), ext);
    for (int k = 0; k < nv; ++k)
      if (d.amask(j, k)) st6(F, 6 * k, add6(ld6(F, 6 * k), f));
    const Arr<T> PS = W.at(G.PS + 36 * j);
    // G_q·s and G_v·s as operators (lCF(h)·s = s ×* h, lCM(m)·s = s × m,
    // lAD(v)·s = v × s, lADs(v)·s = v ×* s)
    auto Gq = [&](const V6<T>& s) {
      V6<T> r = cross_force(s, h);
      r = sub6(r, mul_motion(m, c, Ic, cross_motion(s, biasg)));
      r = add6(r, mul_motion(m, c, Ic, mv6(PS, s)));
      r = add6(r, cross_force(cross_motion(s, vw), h2));
      r = add6(r, cross_force(vw, cross_force(s, h2)));
      return sub6(r, cross_force(s, ext));
    };
    auto Gv = [&](const V6<T>& s) {
      V6<T> r = cross_force(s, h2);
      r = add6(r, cross_force(vw, mul_motion(m, c, Ic, s)));
      return add6(r, mul_motion(m, c, Ic, cross_motion(s, vw)));
    };
    for (int b = 0; b < nv; ++b) {
      if (!d.amask(j, b)) continue;
      const V6<T> Sb = ld6(J, 6 * b);
      const V6<T> yq = sub6(add6(Gq(Sb), mul_motion(m, c, Ic, ld6(W, G.zq + 6 * b))),
                            Gv(ld6(W, G.cw + 6 * b)));
      const V6<T> yv = add6(Gv(Sb), mul_motion(m, c, Ic, ld6(W, G.zv + 6 * b)));
      for (int a = 0; a < nv; ++a) {
        if (!d.amask(j, a)) continue;
        const V6<T> Sa = ld6(J, 6 * a);
        DA.st(a * nd + b, DA.ld(a * nd + b) - dot6(Sa, yq));
        DA.st(a * nd + nv + b, DA.ld(a * nd + nv + b) - dot6(Sa, yv));
      }
    }
  }
  // T1[a, b] = (S_a ×* F_a)·S_b for b an ancestor dof of a
  for (int a = 0; a < nv; ++a) {
    const V6<T> QF = cross_force(ld6(J, 6 * a), ld6(F, 6 * a));
    const int ja = d.dofj(a);
    for (int b = 0; b < nv; ++b)
      if (d.amask(ja, b))
        DA.st(a * nd + b, DA.ld(a * nd + b) - dot6(QF, ld6(J, 6 * b)));
  }
  const int u0 = d.m[H_FULLACT] ? 0 : 6;
  for (int i = 0; i < nu; ++i) DA.st((u0 + i) * nd + ndx + i, T(1));
}

// Closed-form tangents of frame f's quantities along dof k (columns k of
// the q-part and, for dv/dab, of the v-part; lane_frame_tangents).
template <class T> struct FrameTan {
  V3<T> dp_q;
  V6<T> dv_q, dv_v, dab_q, dab_v, dJa_q;
};

template <class T>
__device__ FrameTan<T> frame_tangent(const Desc<T>& d, const Lay& L,
                                     const TanLay& G, Arr<T> W, int f, int k) {
  FrameTan<T> r;
  const int j = d.fpar(f);
  if (!d.amask(j, k)) {
    r.dp_q = v3<T>(T(0), T(0), T(0));
    r.dv_q = r.dv_v = r.dab_q = r.dab_v = r.dJa_q = zero6<T>();
    return r;
  }
  TF<T> Y, fX;
  Y.R = ldm(W, L.oR + 9 * j);
  Y.p = ld3(W, L.op + 3 * j);
  fX.R = cm3<T>(d.fpR(f));
  fX.p = cv3<T>(d.fpp(f));
  Y = compose(Y, fX);
  const TF<T> Yi = inverse(Y);
  const int jk = d.dofj(k), pk = d.jpar(jk);
  const V6<T> Sk = ld6(W, L.J + 6 * k), cw = ld6(W, G.cw + 6 * k);
  const V6<T> wv = pk >= 0 ? ld6(W, L.vw + 6 * pk) : zero6<T>();
  const V6<T> PSpd = pk >= 0 ? mv6(W.at(G.PS + 36 * pk), Sk) : zero6<T>();
  const V6<T> wdiff = sub6(ld6(W, L.vw + 6 * j), wv);
  r.dp_q = add(lin(Sk), cross(ang(Sk), Y.p));
  r.dv_q = scl6(T(-1), act_motion(Yi, cw));
  r.dv_v = act_motion(Yi, Sk);
  r.dJa_q = scl6(T(-1), act_motion(Yi, ld6(W, G.cu + 6 * k)));
  V6<T> db = sub6(sub6(mv6(W.at(G.PS + 36 * j), Sk), PSpd), cross_motion(cw, wdiff));
  r.dab_q = act_motion(Yi, sub6(db, cross_motion(Sk, ld6(W, G.bw + 6 * j))));
  r.dab_v = act_motion(Yi, add6(cross_motion(Sk, wdiff),
                                cross_motion(ld6(W, L.vw + 6 * jk), Sk)));
  return r;
}

// DA <- da/d(dx, u): M⁻¹·r1, plus the Contact3D KKT correction through dlam
// (DL, nc x nd) when the node has contacts
template <class T>
__device__ void acceleration_tangent(const Desc<T>& d, const T* kp,
                                     const Lay& L, const TanLay& G, Arr<T> W) {
  const int nv = d.nv(), ndx = 2 * nv, nd = ndx + d.nu(), nc = d.nc();
  Arr<T> DA = W.at(G.da);
  cho_solve(Team1{}, W.at(L.M), nv, DA, nd, nd);
  if (!nc) return;
  Arr<T> DL = W.at(G.dl), JC = W.at(L.Jc), XS = W.at(L.X);
  for (int ci = 0; ci < d.ncon(); ++ci) {
    const int f = d.con(ci, 0), j = d.fpar(f);
    const T on = kp[d.con(ci, 3)];
    const T* gains = kp + d.con(ci, 2);
    TF<T> fX;
    fX.R = cm3<T>(d.fpR(f));
    fX.p = cv3<T>(d.fpp(f));
    const V6<T> vf = act_motion_inv(fX, ld6(W, L.vel + 6 * j));
    const V3<T> vv = lin(vf), vwf = ang(vf);
    for (int k = 0; k < nv; ++k) {
      const FrameTan<T> ft = frame_tangent(d, L, G, W, f, k);
      // −(dJa + da0), da0 = dab + dω × v + ω × dv + g0·dp + g1·dv
      V3<T> rq = add(add(lin(ft.dJa_q), lin(ft.dab_q)),
                     add(cross(ang(ft.dv_q), vv), cross(vwf, lin(ft.dv_q))));
      rq = add(rq, add(scl(gains[0], ft.dp_q), scl(gains[1], lin(ft.dv_q))));
      V3<T> rv = add(lin(ft.dab_v),
                     add(cross(ang(ft.dv_v), vv), cross(vwf, lin(ft.dv_v))));
      rv = add(rv, scl(gains[1], lin(ft.dv_v)));
      for (int r = 0; r < 3; ++r) {
        DL.st((3 * ci + r) * nd + k, -on * rq.a[r]);
        DL.st((3 * ci + r) * nd + nv + k, -on * rv.a[r]);
      }
    }
    for (int r = 0; r < 3; ++r)
      for (int col = ndx; col < nd; ++col) DL.st((3 * ci + r) * nd + col, T(0));
  }
  // dlam = S⁻¹ (r2 − Jc·M⁻¹r1)·mask,  da += M⁻¹Jcᵀ·dlam
  for (int r = 0; r < nc; ++r) {
    const T mr = kp[d.con(r / 3, 3)];
    for (int col = 0; col < nd; ++col) {
      T s = DL.ld(r * nd + col);
      for (int a = 0; a < nv; ++a) s -= JC.ld(r * nv + a) * DA.ld(a * nd + col);
      DL.st(r * nd + col, s * mr);
    }
  }
  cho_solve(Team1{}, W.at(L.Sk), nc, DL, nd, nd);
  for (int a = 0; a < nv; ++a)
    for (int col = 0; col < nd; ++col) {
      T s = DA.ld(a * nd + col);
      for (int r = 0; r < nc; ++r) s += XS.ld(a * (nc + 1) + r) * DL.ld(r * nd + col);
      DA.st(a * nd + col, s);
    }
}

// Residual Jacobians of the cost stack into JR (nr x nd, row-major)
template <class T>
__device__ void cost_jacobians(const Desc<T>& d, const T* kp, const Lay& L,
                               const TanLay& G, Arr<T> W) {
  const int nj = d.nj(), nv = d.nv(), ndx = 2 * nv, nd = ndx + d.nu();
  Arr<T> JR = W.at(G.JR), R = W.at(L.R), DL = W.at(G.dl), J = W.at(L.J);
  for (int i = 0; i < d.nr() * nd; ++i) JR.st(i, T(0));
  for (int ci = 0; ci < d.ncost(); ++ci) {
    const int type = d.cost(ci, CF_TYPE), idx = d.cost(ci, CF_IDX);
    const int row = d.cost(ci, CF_ROW), nr = d.cost(ci, CF_NR);
    auto put = [&](int r, int col, T v) { JR.st((row + r) * nd + col, v); };
    if (type == C_STATE) {
      int i0 = 0;
      if (d.ff()) {
        const M6<T> Jri = jac_se3_right_inv(ld6(R, row));
        for (int r = 0; r < 6; ++r)
          for (int c = 0; c < 6; ++c) put(r, c, Jri.a[6 * r + c]);
        i0 = 6;
      }
      for (int r = i0; r < ndx; ++r) put(r, r, T(1));
    } else if (type == C_CONTROL) {
      for (int r = 0; r < nr; ++r) put(r, ndx + r, T(1));
    } else if (type == C_COM) {
      T mt = 0;
      for (int i = 0; i < nj; ++i) mt += d.mass(i);
      for (int k = 0; k < nv; ++k) {
        T msub = 0;
        V3<T> csub = v3<T>(T(0), T(0), T(0));
        for (int i = 0; i < nj; ++i) {
          if (!d.amask(i, k)) continue;
          msub += d.mass(i);
          csub = add(csub, scl(d.mass(i), ld3(W, L.cw + 3 * i)));
        }
        const V6<T> Sk = ld6(J, 6 * k);
        const V3<T> dc = add(scl(msub, lin(Sk)), cross(ang(Sk), csub));
        for (int r = 0; r < 3; ++r) put(r, k, dc.a[r] / mt);
      }
    } else if (type == C_FTRANS || type == C_FVEL) {
      for (int k = 0; k < nv; ++k) {
        const FrameTan<T> ft = frame_tangent(d, L, G, W, idx, k);
        if (type == C_FTRANS) {
          for (int r = 0; r < 3; ++r) put(r, k, ft.dp_q.a[r]);
        } else {
          for (int r = 0; r < 6; ++r) {
            put(r, k, ft.dv_q.a[r]);
            put(r, nv + k, ft.dv_v.a[r]);
          }
        }
      }
    } else if (d.nc()) {  // C_CONE (A·dlam) or C_FORCE (dlam rows)
      const T* A = kp + d.cost(ci, CF_REF);
      for (int r = 0; r < nr; ++r)
        for (int col = 0; col < nd; ++col) {
          T s;
          if (type == C_CONE) {
            s = T(0);
            for (int k = 0; k < 3; ++k) s += A[3 * r + k] * DL.ld((3 * idx + k) * nd + col);
          } else {
            s = DL.ld((3 * idx + r) * nd + col);
          }
          put(r, col, s);
        }
    }
  }
}

template <class T>
__device__ void node_one(int n, int N, int B, const Desc<T>& d, const T* par,
                         const T* x, const T* u, T* Fx, T* Fu, T* Lx, T* Lu,
                         T* Lxx, T* Lxu, T* Luu, T* xnext, T* cost,
                         T* scratch) {
  const T* kp = par + (long)(n / B) * d.P();
  const int nv = d.nv(), nq = d.nq(), nx = nq + nv, ndx = 2 * nv;
  const int nu = d.nu(), nd = ndx + nu;
  const Lay L(d);
  const TanLay G(d, L.size);
  Arr<T> W{scratch + n, N};
  Arr<T> X = W.at(L.x), U = W.at(L.u), XN = W.at(L.xn), R = W.at(L.R);
  Arr<T> JR = W.at(G.JR), AR = W.at(G.AR), ARR = W.at(G.ARR), DA = W.at(G.da);
  const T dt = kp[d.m[H_DT]];
  const T scale = dt == T(0) ? T(1) : dt;
  auto out = [&](T* p, int i) -> T& { return p[(long)i * N + n]; };

  // ---- primal: kinematics, KKT dynamics, residuals, Euler step -----------
  for (int i = 0; i < nx; ++i) X.st(i, x[(long)i * N + n]);
  for (int i = 0; i < nu; ++i) U.st(i, u[(long)i * N + n]);
  node_primal(Team1{}, d, kp, W);
  for (int i = 0; i < nx; ++i) out(xnext, i) = XN.ld(i);
  const T rate = cost_rate(Team1{}, d, kp, R, true, AR, ARR);
  cost[n] = dt == T(0) ? rate : dt * rate;

  // ---- closed-form tangents -------------------------------------------------
  tangent_context(d, L, G, W);
  gforce_derivatives(d, kp, L, G, W);
  acceleration_tangent(d, kp, L, G, W);
  cost_jacobians(d, kp, L, G, W);

  // ---- Gauss-Newton: L = Σ w·Jᵀ·Ar, H = Σ w·Jᵀ·diag(Arr)·J ---------------
  for (int i = 0; i < ndx; ++i) {
    out(Lx, i) = T(0);
    for (int j = 0; j < ndx; ++j) out(Lxx, i * ndx + j) = T(0);
    for (int j = 0; j < nu; ++j) out(Lxu, i * nu + j) = T(0);
  }
  for (int i = 0; i < nu; ++i) {
    out(Lu, i) = T(0);
    for (int j = 0; j < nu; ++j) out(Luu, i * nu + j) = T(0);
  }
  T row[64];
  unsigned char nz[64];
  for (int ci = 0; ci < d.ncost(); ++ci) {
    T w = kp[d.cost(ci, CF_ON)] * kp[d.cost(ci, CF_W)];
    if (w == T(0)) continue;
    int r0 = d.cost(ci, CF_ROW), nrc = d.cost(ci, CF_NR);
    for (int r = r0; r < r0 + nrc; ++r) {
      int k = 0;
      for (int i = 0; i < nd; ++i) {
        row[i] = JR.ld(r * nd + i);
        if (row[i] != T(0)) nz[k++] = (unsigned char)i;
      }
      T ar = w * AR.ld(r), arr = w * ARR.ld(r);
      for (int a = 0; a < k; ++a) {
        int i = nz[a];
        T gi = row[i] * ar;
        if (i < ndx) out(Lx, i) += gi; else out(Lu, i - ndx) += gi;
        T hi = row[i] * arr;
        for (int b = a; b < k; ++b) {
          int j = nz[b];
          T h = hi * row[j];
          if (j < ndx) out(Lxx, i * ndx + j) += h;
          else if (i < ndx) out(Lxu, i * nu + j - ndx) += h;
          else out(Luu, (i - ndx) * nu + j - ndx) += h;
        }
      }
    }
  }
  // mirror the upper triangles and scale by dt (1 at dt = 0)
  for (int i = 0; i < ndx; ++i) {
    out(Lx, i) *= scale;
    for (int j = i; j < ndx; ++j) {
      T h = out(Lxx, i * ndx + j) * scale;
      out(Lxx, i * ndx + j) = h;
      out(Lxx, j * ndx + i) = h;
    }
    for (int j = 0; j < nu; ++j) out(Lxu, i * nu + j) *= scale;
  }
  for (int i = 0; i < nu; ++i) {
    out(Lu, i) *= scale;
    for (int j = i; j < nu; ++j) {
      T h = out(Luu, i * nu + j) * scale;
      out(Luu, i * nu + j) = h;
      out(Luu, j * nu + i) = h;
    }
  }

  // ---- Euler + manifold chain rule (Fx = I, Fu = 0 at dt = 0) -------------
  auto F = [&](int i, int col) -> T& {
    return col < ndx ? out(Fx, i * ndx + col) : out(Fu, i * nu + col - ndx);
  };
  if (dt == T(0)) {
    for (int i = 0; i < ndx; ++i)
      for (int col = 0; col < nd; ++col) F(i, col) = T(i == col ? 1 : 0);
    return;
  }
  // d(dstep)/d(dx, u): [dt·[0 I] + dt²·da; dt·da]
  auto dstep = [&](int i, int col) -> T {
    if (i < nv) return (col == nv + i ? dt : T(0)) + dt * dt * DA.ld(i * nd + col);
    return dt * DA.ld((i - nv) * nd + col);
  };
  int i0 = 0;
  if (d.ff()) {
    const V6<T> xi = ld6(W.at(L.ds), 0);
    const M6<T> Jx = se3_adjoint(exp6(scl6(T(-1), xi)));
    const M6<T> Jdx = jac_se3_right(xi);
    for (int col = 0; col < nd; ++col) {
      T ds[6];
      for (int m = 0; m < 6; ++m) ds[m] = dstep(m, col);
      for (int i = 0; i < 6; ++i) {
        T s = col < 6 ? Jx.a[6 * i + col] : T(0);
        for (int m = 0; m < 6; ++m) s += Jdx.a[6 * i + m] * ds[m];
        F(i, col) = s;
      }
    }
    i0 = 6;
  }
  for (int i = i0; i < ndx; ++i)
    for (int col = 0; col < nd; ++col)
      F(i, col) = dstep(i, col) + T(i == col ? 1 : 0);
}

}  // namespace croc

#ifdef __CUDACC__
namespace croc {

template <class T>
__global__ void __launch_bounds__(128)
node_kernel(int N, int B, const int* meta, const T* robot, const T* par,
            const T* x, const T* u, T* Fx, T* Fu, T* Lx, T* Lu, T* Lxx,
            T* Lxu, T* Luu, T* xnext, T* cost, T* scratch) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Desc<T> d{meta, robot};
  node_one(n, N, B, d, par, x, u, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost,
           scratch);
}

template <class T>
int launch_node(int N, int B, const int* meta, const T* robot, const T* par,
                const T* x, const T* u, T* Fx, T* Fu, T* Lx, T* Lu, T* Lxx,
                T* Lxu, T* Luu, T* xnext, T* cost, T* scratch, void* stream) {
  node_kernel<T><<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      N, B, meta, robot, par, x, u, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext,
      cost, scratch);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_NODE(NAME, T)                                                   \
  extern "C" int NAME(int N, int B, const int* meta, const T* robot,         \
                      const T* par, const T* x, const T* u, T* Fx, T* Fu,    \
                      T* Lx, T* Lu, T* Lxx, T* Lxu, T* Luu, T* xnext,        \
                      T* cost, T* scratch, void* stream) {                   \
    return croc::launch_node<T>(N, B, meta, robot, par, x, u, Fx, Fu, Lx,    \
                                Lu, Lxx, Lxu, Luu, xnext, cost, scratch,     \
                                stream);                                     \
  }
CROC_NODE(croc_node_f32, float)
CROC_NODE(croc_node_f64, double)
#endif  // __CUDACC__
