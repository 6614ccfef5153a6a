// Node linearization: one node per warp, its workspace in shared memory.
//
// Replaces: crocoddyl_tpu/ops/fused_node.py::calc_both_lanes (the Pallas
// kernel over lane_calc_both): per node, the kinematic sweep, mass matrix
// and bias forces, the Contact3D KKT solve, the closed-form tangents
// (lane_gforce_derivatives, lane_frame_tangents), the seven cost residuals
// and their Jacobians, the Gauss-Newton Lx/Lu/Lxx/Lxu/Luu and the Euler /
// free-flyer chain rule, with the dt=0 terminal semantics (Fx = I, Fu = 0,
// xnext = x, cost not scaled).
//
// Bound on this card: the latency of one node's chain on its warp, and the
// warps an SM holds.  A node is ~10⁶ operations (counted on the plain
// version), ~3·10⁴ a lane, most of them dependent shared-memory loads
// and FMAs; the operations bound over the whole batch (0.4 ms at N =
// 27,904 in f32) assumes none of that chain.  At N = 109 (one problem) the
// launch is 109 warps on 109 SMs and its time is one node's critical path:
// the primal (the kinematic sweep's levels, the 18-column Cholesky and the
// KKT solves, as in the rollouts) and then the tangent phases below, each
// a loop over a lane's share of columns or entries, ended by a warp sync.
//
// Design: node n runs on one warp (node_math.cuh's WarpTeam) of a CTA of W
// warps, W consecutive nodes a CTA (W = 8 in f32, 4 in f64 at bench size;
// fewer when N is small, so that small launches spread over the SMs).  The
// descriptor is staged once per CTA in shared memory; each warp's
// workspace (NodeLay: the primal's Lay, then the tangent blocks over the
// primal's dead FI/FW/YI) is a slice of shared memory, ~27 KB (f32) /
// ~54 KB (f64) a node.  The primal is node_primal on the warp, as in the
// rollout kernels.  The tangent phases spread over the lanes by their own
// structure: joints by depth level (tangent_context), dof columns
// (gforce_derivatives), the nd = 48 columns of the acceleration tangent and
// its KKT correction, contact-frame tangents by (contact, dof), and the
// Gauss-Newton sum by cost term: each term's dense Jacobian rows go to a
// small block (at most kJBRows rows, built by the lanes by column), and
// each lane adds them into the lower-triangle entries of H = Σ w·Jᵀ·Arr·J it
// owns; the unit rows of the state and control costs go straight to H's
// diagonal.  Each entry's sum runs over the cost terms and rows in order,
// as the serial loop did.  The outputs leave through a CTA-wide pass:
// thread t writes element t / W of node t % W, so consecutive nodes' values
// go out together (32 bytes a sector in both dtypes at W = 8 / 4); Fx and
// Fu are formed there from the acceleration tangent and the two 6x6
// free-flyer Jacobians.  The inputs x, u come in the same way.  Where a
// node's time goes on its warp (PERF.md, §6): the primal and the
// acceleration tangent first (their in-place triangular solves), then the
// write pass, the Gauss-Newton sums and the gforce columns, all of it
// chains of dependent shared-memory loads.
//
// Not used, and why: tensor cores (a node's matrices are at most 48x48 and
// differ from node to node); TF32 (float32 parity with the plain version
// is the rule of this port).
#include "cta.cuh"
#include "node_math.cuh"

namespace croc {

// rows of one dense cost block of the Gauss-Newton phase
constexpr int kJBRows = 8;

// The workspace of one node, in elements of T: the primal's Lay, then from
// L.FI on (FI, FW and YI serve the primal alone) the tangent blocks.  The
// total (``size``) must equal node_workspace_elems() in
// ops/cuda_kernels.py.
struct NodeLay {
  int bw, ua, PS, F, cw, cu, zq, zv, JH, da, dl, AR, ARR, H, g, JB, Jx, Jdx, C,
      size;
  template <class T> __device__ NodeLay(const Desc<T>& d, const Lay& L) {
    const int nj = d.nj(), nv = d.nv(), nd = 2 * nv + d.nu(), nc = d.nc();
    const int nr = d.nr();
    int o = L.FI;
    bw = o; o += 6 * nj;   ua = o; o += 6 * nj;   PS = o; o += 36 * nj;
    F = o; o += 6 * nv;    cw = o; o += 6 * nv;   cu = o; o += 6 * nv;
    zq = o; o += 6 * nv;   zv = o; o += 6 * nv;   JH = o; o += 18 * nj;
    da = o; o += nv * nd;  dl = o; o += nc * nd;  AR = o; o += nr;
    ARR = o; o += nr;      H = o; o += nd * (nd + 1) / 2;
    g = o; o += nd;        JB = o; o += kJBRows * nd;
    Jx = o; o += 36;       Jdx = o; o += 36;      C = o; o += 1;
    size = o > L.size ? o : L.size;
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
// Joints go over the lanes by depth level (a parent's ua and PS come
// first), then dofs.
template <class T, class Team>
__device__ void tangent_context(const Team& tm, const Desc<T>& d, const Lay& L,
                                const NodeLay& G, Arr<T> W) {
  const int nj = d.nj(), nv = d.nv(), ln = tm.lane(), nl = tm.size();
  Arr<T> J = W.at(L.J), ACC = W.at(L.acc);
  const int nlev = nl == 1 ? 1 : d.nlev();
  for (int lev = 0; lev < nlev; ++lev) {
    for (int j = ln; j < nj; j += nl) {
      if (nl > 1 && d.depth(j) != lev) continue;
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
    tm.sync();
  }
  for (int k = ln; k < nv; k += nl) {
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
  tm.sync();
}

// r1 = [−dG/dq | −dG/dv | dtau/du] (nv x nd) into DA
// (lane_gforce_derivatives; the contact wrenches enter as ext_w).  First
// each joint's wrenches h, h2 and contact wrench ext (lanes over joints);
// then the columns b of the q- and v-parts, one dof column per lane with
// the joints in order inside it, and the wrench sums F per dof; then the
// rows a of the ancestor term.
template <class T, class Team>
__device__ void gforce_derivatives(const Team& tm, const Desc<T>& d, const T* kp,
                                   const Lay& L, const NodeLay& G, Arr<T> W) {
  const int nj = d.nj(), nv = d.nv(), ndx = 2 * nv, nu = d.nu();
  const int nd = ndx + nu, ln = tm.lane(), nl = tm.size(), rl = rlane(tm);
  Arr<T> J = W.at(L.J), DA = W.at(G.da), F = W.at(G.F), LAM = W.at(L.lam);
  Arr<T> JH = W.at(G.JH);
  const V6<T> g6 = v6(v3<T>(-d.gravity()[0], -d.gravity()[1], -d.gravity()[2]),
                      v3<T>(T(0), T(0), T(0)));
  for (int i = ln; i < nv * nd; i += nl) DA.st(i, T(0));
  for (int j = rl; j < nj; j += nl) {
    const T m = d.mass(j);
    const V3<T> c = ld3(W, L.cw + 3 * j);
    const M3<T> Ic = ldm(W, L.Icw + 9 * j);
    const V6<T> vw = ld6(W, L.vw + 6 * j);
    const V6<T> biasg = add6(ld6(W, G.bw + 6 * j), g6);
    st6(JH, 18 * j, mul_motion(m, c, Ic, add6(biasg, ld6(W, G.ua + 6 * j))));
    st6(JH, 18 * j + 6, mul_motion(m, c, Ic, vw));
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
    st6(JH, 18 * j + 12, ext);
  }
  tm.sync();
  // F_k = Σ over the joints j that move with dof k of h + vw ×* h2 − ext
  for (int k = rl; k < nv; k += nl) {
    V6<T> Fk = zero6<T>();
    for (int j = 0; j < nj; ++j) {
      if (!d.amask(j, k)) continue;
      const V6<T> h = ld6(JH, 18 * j), h2 = ld6(JH, 18 * j + 6);
      const V6<T> f = sub6(add6(h, cross_force(ld6(W, L.vw + 6 * j), h2)),
                           ld6(JH, 18 * j + 12));
      Fk = add6(Fk, f);
    }
    st6(F, 6 * k, Fk);
  }
  for (int b = ln; b < nv; b += nl) {
    const V6<T> Sb = ld6(J, 6 * b);
    const V6<T> zqb = ld6(W, G.zq + 6 * b), zvb = ld6(W, G.zv + 6 * b);
    const V6<T> cwb = ld6(W, G.cw + 6 * b);
    for (int j = 0; j < nj; ++j) {
      if (!d.amask(j, b)) continue;
      const T m = d.mass(j);
      const V3<T> c = ld3(W, L.cw + 3 * j);
      const M3<T> Ic = ldm(W, L.Icw + 9 * j);
      const V6<T> vw = ld6(W, L.vw + 6 * j);
      const V6<T> biasg = add6(ld6(W, G.bw + 6 * j), g6);
      const V6<T> h = ld6(JH, 18 * j), h2 = ld6(JH, 18 * j + 6);
      const V6<T> ext = ld6(JH, 18 * j + 12);
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
      const V6<T> yq = sub6(add6(Gq(Sb), mul_motion(m, c, Ic, zqb)), Gv(cwb));
      const V6<T> yv = add6(Gv(Sb), mul_motion(m, c, Ic, zvb));
      for (int a = 0; a < nv; ++a) {
        if (!d.amask(j, a)) continue;
        const V6<T> Sa = ld6(J, 6 * a);
        DA.st(a * nd + b, DA.ld(a * nd + b) - dot6(Sa, yq));
        DA.st(a * nd + nv + b, DA.ld(a * nd + nv + b) - dot6(Sa, yv));
      }
    }
  }
  tm.sync();
  // T1[a, b] = (S_a ×* F_a)·S_b for b an ancestor dof of a; the actuation
  for (int a = ln; a < nv; a += nl) {
    const V6<T> QF = cross_force(ld6(J, 6 * a), ld6(F, 6 * a));
    const int ja = d.dofj(a);
    for (int b = 0; b < nv; ++b)
      if (d.amask(ja, b))
        DA.st(a * nd + b, DA.ld(a * nd + b) - dot6(QF, ld6(J, 6 * b)));
  }
  const int u0 = d.m[H_FULLACT] ? 0 : 6;
  for (int i = rl; i < nu; i += nl) DA.st((u0 + i) * nd + ndx + i, T(1));
  tm.sync();
}

// Closed-form tangents of frame f's quantities along dof k (columns k of
// the q-part and, for dv/dab, of the v-part; lane_frame_tangents).
template <class T> struct FrameTan {
  V3<T> dp_q;
  V6<T> dv_q, dv_v, dab_q, dab_v, dJa_q;
};

template <class T>
__device__ FrameTan<T> frame_tangent(const Desc<T>& d, const Lay& L,
                                     const NodeLay& G, Arr<T> W, int f, int k) {
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
// (DL, nc x nd) when the node has contacts.  The lanes take DA's columns
// (M⁻¹·r1), the contact-frame tangents by (contact, dof), then the columns
// again: each lane forms, solves and applies dlam for its own columns.
template <class T, class Team>
__device__ void acceleration_tangent(const Team& tm, const Desc<T>& d, const T* kp,
                                     const Lay& L, const NodeLay& G, Arr<T> W) {
  const int nv = d.nv(), ndx = 2 * nv, nd = ndx + d.nu(), nc = d.nc();
  const int ln = tm.lane(), nl = tm.size(), rl = rlane(tm);
  Arr<T> DA = W.at(G.da), M = W.at(L.M);
  for (int col = ln; col < nd; col += nl) cho_solve_col(M, nv, DA, col, nd);
  if (!nc) {
    tm.sync();
    return;
  }
  Arr<T> DL = W.at(G.dl), JC = W.at(L.Jc), XS = W.at(L.X), SK = W.at(L.Sk);
  const int ncon = d.ncon();
  for (int q = rl; q < ncon * nv; q += nl) {
    const int ci = q / nv, k = q % nv;
    const int f = d.con(ci, 0), j = d.fpar(f);
    const T on = kp[d.con(ci, 3)];
    const T* gains = kp + d.con(ci, 2);
    TF<T> fX;
    fX.R = cm3<T>(d.fpR(f));
    fX.p = cv3<T>(d.fpp(f));
    const V6<T> vf = act_motion_inv(fX, ld6(W, L.vel + 6 * j));
    const V3<T> vv = lin(vf), vwf = ang(vf);
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
  for (int q = ln; q < nc * (nd - ndx); q += nl)
    DL.st((q / (nd - ndx)) * nd + ndx + q % (nd - ndx), T(0));
  tm.sync();
  // dlam = S⁻¹ (r2 − Jc·M⁻¹r1)·mask,  da += M⁻¹Jcᵀ·dlam, column by column
  for (int col = ln; col < nd; col += nl) {
    for (int r = 0; r < nc; ++r) {
      const T mr = kp[d.con(r / 3, 3)];
      T s = DL.ld(r * nd + col);
      for (int a = 0; a < nv; ++a) s -= JC.ld(r * nv + a) * DA.ld(a * nd + col);
      DL.st(r * nd + col, s * mr);
    }
    cho_solve_col(SK, nc, DL, col, nd);
    for (int a = 0; a < nv; ++a) {
      T s = DA.ld(a * nd + col);
      for (int r = 0; r < nc; ++r) s += XS.ld(a * (nc + 1) + r) * DL.ld(r * nd + col);
      DA.st(a * nd + col, s);
    }
  }
  tm.sync();
}

// The Gauss-Newton sums L = Σ w·Jᵀ·Ar and H = Σ w·Jᵀ·diag(Arr)·J over the
// cost terms (lower triangle of H, (nd x nd), row-major; g = L), unscaled.
// A term's dense Jacobian rows are built into JB (the lanes by column,
// frame tangents by dof), then each lane adds them into the H entries and
// g elements it owns, row by row, over the columns the term's type can
// reach (the free-flyer block, the q or the x part, or all); the unit rows
// of the state (past the free-flyer block) and control terms go straight to
// H's diagonal.  Each entry's sum runs over the terms and their rows in
// order, as the serial loop over the residual rows did; the products it
// skipped as zero either lie outside the term's columns or add a zero.  The last lane also forms the
// free-flyer chain-rule blocks Jx and Jdx for the outputs.
template <class T, class Team>
__device__ void gauss_newton(const Team& tm, const Desc<T>& d, const T* kp,
                             const Lay& L, const NodeLay& G, Arr<T> W) {
  const int nj = d.nj(), nv = d.nv(), ndx = 2 * nv, nd = ndx + d.nu();
  const int ntri = nd * (nd + 1) / 2, ln = tm.lane(), nl = tm.size();
  Arr<T> H = W.at(G.H), g = W.at(G.g), JB = W.at(G.JB), R = W.at(L.R);
  Arr<T> AR = W.at(G.AR), ARR = W.at(G.ARR), DL = W.at(G.dl), J = W.at(L.J);
  for (int e = ln; e < ntri; e += nl) H.st(e, T(0));
  for (int i = ln; i < nd; i += nl) g.st(i, T(0));
  const T dt = kp[d.m[H_DT]];
  if (rlane(tm) == 0 && d.ff() && dt != T(0)) {
    const V6<T> xi = ld6(W.at(L.ds), 0);
    const M6<T> Jx = se3_adjoint(exp6(scl6(T(-1), xi)));
    const M6<T> Jdx = jac_se3_right(xi);
    for (int i = 0; i < 36; ++i) {
      W.st(G.Jx + i, Jx.a[i]);
      W.st(G.Jdx + i, Jdx.a[i]);
    }
  }
  int i0, j0;  // this lane's first entry of H
  tri_index(ln, i0, j0);
  for (int ci = 0; ci < d.ncost(); ++ci) {
    const T w = kp[d.cost(ci, CF_ON)] * kp[d.cost(ci, CF_W)];
    if (w == T(0)) continue;
    const int type = d.cost(ci, CF_TYPE), idx = d.cost(ci, CF_IDX);
    const int row = d.cost(ci, CF_ROW), nrc = d.cost(ci, CF_NR);
    if ((type == C_CONE || type == C_FORCE) && !d.nc()) continue;
    // dense rows [0, nb), then the unit rows of a state or control term
    const int nb = type == C_STATE ? (d.ff() ? 6 : 0) : type == C_CONTROL ? 0 : nrc;
    if (nb) {
      tm.sync();  // JB is free
      for (int q = ln; q < nb * nd; q += nl) JB.st(q, T(0));
      tm.sync();
      if (type == C_STATE) {
        if (ln == 0) {
          const M6<T> Jri = jac_se3_right_inv(ld6(R, row));
          for (int r = 0; r < 6; ++r)
            for (int c = 0; c < 6; ++c) JB.st(r * nd + c, Jri.a[6 * r + c]);
        }
      } else if (type == C_COM) {
        T mt = 0;
        for (int i = 0; i < nj; ++i) mt += d.mass(i);
        for (int k = ln; k < nv; k += nl) {
          T msub = 0;
          V3<T> csub = v3<T>(T(0), T(0), T(0));
          for (int i = 0; i < nj; ++i) {
            if (!d.amask(i, k)) continue;
            msub += d.mass(i);
            csub = add(csub, scl(d.mass(i), ld3(W, L.cw + 3 * i)));
          }
          const V6<T> Sk = ld6(J, 6 * k);
          const V3<T> dc = add(scl(msub, lin(Sk)), cross(ang(Sk), csub));
          for (int r = 0; r < 3; ++r) JB.st(r * nd + k, dc.a[r] / mt);
        }
      } else if (type == C_FTRANS || type == C_FVEL) {
        for (int k = ln; k < nv; k += nl) {
          const FrameTan<T> ft = frame_tangent(d, L, G, W, idx, k);
          if (type == C_FTRANS) {
            for (int r = 0; r < 3; ++r) JB.st(r * nd + k, ft.dp_q.a[r]);
          } else {
            for (int r = 0; r < 6; ++r) {
              JB.st(r * nd + k, ft.dv_q.a[r]);
              JB.st(r * nd + nv + k, ft.dv_v.a[r]);
            }
          }
        }
      } else {  // C_CONE (A·dlam) or C_FORCE (dlam rows)
        const T* A = kp + d.cost(ci, CF_REF);
        for (int col = ln; col < nd; col += nl)
          for (int r = 0; r < nrc; ++r) {
            T s;
            if (type == C_CONE) {
              s = T(0);
              for (int k = 0; k < 3; ++k) s += A[3 * r + k] * DL.ld((3 * idx + k) * nd + col);
            } else {
              s = DL.ld((3 * idx + r) * nd + col);
            }
            JB.st(r * nd + col, s);
          }
      }
      tm.sync();
      // H[p, q] (p ≥ q) += Σ_r (J[r, q]·w·Arr_r)·J[r, p] over the entries of
      // the columns the term reaches (a prefix of the lower triangle)
      const int cmax = type == C_STATE ? 6 : type == C_COM || type == C_FTRANS ? nv
                       : type == C_FVEL ? ndx : nd;
      T wa[kJBRows], wg[kJBRows];
#pragma unroll
      for (int r = 0; r < kJBRows; ++r) {
        wa[r] = r < nb ? w * ARR.ld(row + r) : T(0);
        wg[r] = r < nb ? w * AR.ld(row + r) : T(0);
      }
      for (int e = ln, p = i0, q = j0; e < cmax * (cmax + 1) / 2; e += nl) {
        T acc = H.ld(e);
#pragma unroll
        for (int r = 0; r < kJBRows; ++r)
          if (r < nb) acc += JB.ld(r * nd + q) * wa[r] * JB.ld(r * nd + p);
        H.st(e, acc);
        q += nl;  // the entry nl further on
        while (q > p) { q -= p + 1; ++p; }
      }
      for (int i = ln; i < cmax; i += nl) {
        T acc = g.ld(i);
#pragma unroll
        for (int r = 0; r < kJBRows; ++r)
          if (r < nb) acc += JB.ld(r * nd + i) * wg[r];
        g.st(i, acc);
      }
    }
    if (nb < nrc) {
      tm.sync();  // the dense rows' updates are in
      const int c0 = type == C_CONTROL ? ndx : 0;
      for (int r = nb + ln; r < nrc; r += nl) {
        const int c = c0 + r, e = c * (c + 1) / 2 + c;
        g.st(c, g.ld(c) + w * AR.ld(row + r));
        H.st(e, H.ld(e) + w * ARR.ld(row + r));
      }
    }
  }
  tm.sync();
}

// One node on the team: the primal, the cost and its activation terms, the
// tangents and the Gauss-Newton sums, all into W (layout NodeLay); x and u
// are in W already.  Every lane calls it; it ends in a sync.
template <class T, class Team>
__device__ void node_body(const Team& tm, const Desc<T>& d, const T* kp, Arr<T> W) {
  const Lay L(d);
  const NodeLay G(d, L);
  node_primal(tm, d, kp, W);
  const T dt = kp[d.m[H_DT]];
  const T rate = cost_rate(tm, d, kp, W.at(L.R), true, W.at(G.AR), W.at(G.ARR));
  if (tm.lane() == 0) W.st(G.C, dt == T(0) ? rate : dt * rate);
  tm.sync();
  tangent_context(tm, d, L, G, W);
  gforce_derivatives(tm, d, kp, L, G, W);
  acceleration_tangent(tm, d, kp, L, G, W);
  gauss_newton(tm, d, kp, L, G, W);
}

// The outputs of a node, in the order of the kernel's arguments
enum NodeOut { O_FX = 0, O_FU, O_LX, O_LU, O_LXX, O_LXU, O_LUU, O_XN, O_COST, O_N };

// Rows and columns of output o
template <class T> __device__ inline void node_out_shape(const Desc<T>& d, int o, int& R, int& C) {
  const int ndx = 2 * d.nv(), nu = d.nu();
  const int rc[O_N][2] = {{ndx, ndx}, {ndx, nu}, {ndx, 1}, {nu, 1}, {ndx, ndx},
                          {ndx, nu}, {nu, nu}, {d.nq() + d.nv(), 1}, {1, 1}};
  R = rc[o][0];
  C = rc[o][1];
}

// Entry (r, c) of output o of the node whose workspace is W (after
// node_body) and whose knot has time step dt: the Gauss-Newton blocks mirrored from H's lower triangle and
// scaled by dt (1 at dt = 0), Fx and Fu from the Euler step and the
// free-flyer chain rule (Fx = I, Fu = 0 at dt = 0).
template <class T>
__device__ T node_out(const Desc<T>& d, const Lay& L, const NodeLay& G, T dt,
                      Arr<T> W, int o, int r, int c) {
  const int nv = d.nv(), ndx = 2 * nv, nd = ndx + d.nu();
  const T scale = dt == T(0) ? T(1) : dt;
  auto h = [&](int a, int b) {  // H[a, b], either triangle
    return a >= b ? W.ld(G.H + a * (a + 1) / 2 + b) : W.ld(G.H + b * (b + 1) / 2 + a);
  };
  switch (o) {
    case O_LX: return W.ld(G.g + r) * scale;
    case O_LU: return W.ld(G.g + ndx + r) * scale;
    case O_LXX: return h(r, c) * scale;
    case O_LXU: return h(r, ndx + c) * scale;
    case O_LUU: return h(ndx + r, ndx + c) * scale;
    case O_XN: return W.ld(L.xn + r);
    case O_COST: return W.ld(G.C);
    default: break;
  }
  // Fx (o = O_FX) or Fu: entry (r, col) of [Fx | Fu] (ndx x nd)
  const int col = o == O_FX ? c : ndx + c;
  if (dt == T(0)) return T(r == col ? 1 : 0);
  // d(dstep)/d(dx, u): [dt·[0 I] + dt²·da; dt·da]
  auto dstep = [&](int m) -> T {
    if (m < nv) return (col == nv + m ? dt : T(0)) + dt * dt * W.ld(G.da + m * nd + col);
    return dt * W.ld(G.da + (m - nv) * nd + col);
  };
  if (d.ff() && r < 6) {
    T s = col < 6 ? W.ld(G.Jx + 6 * r + col) : T(0);
    for (int m = 0; m < 6; ++m) s += W.ld(G.Jdx + 6 * r + m) * dstep(m);
    return s;
  }
  return dstep(r) + T(r == col ? 1 : 0);
}

}  // namespace croc

#ifdef __CUDACC__
namespace croc {

constexpr int kNodeMaxWarps = 8;

template <class T>
__device__ inline T* node_out_ptr(int o, T* Fx, T* Fu, T* Lx, T* Lu, T* Lxx,
                                  T* Lxu, T* Luu, T* xnext, T* cost) {
  T* const p[O_N] = {Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost};
  return p[o];
}

// CTA of W warps over nodes [W·blockIdx.x, W·blockIdx.x + W): stage the
// descriptor, bring in x and u, each warp runs its node, then the CTA
// writes the outputs with consecutive nodes side by side.
template <class T>
__global__ void __launch_bounds__(32 * kNodeMaxWarps)
node_kernel(int N, int B, int nmeta, int nrobot, int ws, const int* meta,
            const T* robot, const T* par, const T* x, const T* u, T* Fx,
            T* Fu, T* Lx, T* Lu, T* Lxx, T* Lxu, T* Luu, T* xnext, T* cost) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* s_meta = reinterpret_cast<int*>(smem_raw);
  T* s_robot = reinterpret_cast<T*>(smem_raw + up4(nmeta) * sizeof(int));
  const int tid = threadIdx.x, nth = blockDim.x, W = nth >> 5;
  for (int i = tid; i < nmeta; i += nth) s_meta[i] = meta[i];
  for (int i = tid; i < nrobot; i += nth) s_robot[i] = robot[i];
  T* s_ws = s_robot + up4(nrobot);
  const int n0 = blockIdx.x * W, wsp = up4(ws);
  __syncthreads();
  const Desc<T> d{s_meta, s_robot};
  const Lay L(d);
  const NodeLay G(d, L);
  const int nx = d.nq() + d.nv(), nu = d.nu(), P = d.P();
  for (int q = tid; q < (nx + nu) * W; q += nth) {
    const int w = q % W, i = q / W, n = n0 + w < N ? n0 + w : N - 1;
    s_ws[w * wsp + L.x + i] = i < nx ? x[(long)i * N + n] : u[(long)(i - nx) * N + n];
  }
  __syncthreads();
  const int warp = tid >> 5, n = n0 + warp;
  if (n < N)
    node_body(WarpTeam{}, d, par + (long)(n / B) * P, Arr<T>{s_ws + warp * wsp, 1});
  __syncthreads();
  // thread t writes entries of node t mod W (W a power of two): stepping
  // by the CTA's size keeps the node and moves 32 entries along
  const int w = tid & (W - 1), nn = n0 + w;
  if (nn < N) {
    const T dt = par[(long)(nn / B) * P + d.m[H_DT]];
    const Arr<T> Wn{s_ws + w * wsp, 1};
    for (int o = 0; o < O_N; ++o) {
      T* out = node_out_ptr(o, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost);
      int R, C;
      node_out_shape(d, o, R, C);
      int i = tid / W, r = i / C, c = i - r * C;
      for (; i < R * C; i += 32) {
        out[(long)i * N + nn] = node_out(d, L, G, dt, Wn, o, r, c);
        c += 32;
        while (c >= C) { c -= C; ++r; }
      }
    }
  }
}

// Dynamic shared memory of a CTA of W warps
template <class T> inline size_t node_smem(int nmeta, int nrobot, int ws, int W) {
  return (size_t)up4(nmeta) * sizeof(int) +
         sizeof(T) * ((size_t)up4(nrobot) + (size_t)W * up4(ws));
}

// CTAs, threads per CTA, nodes (warps) per CTA and dynamic shared memory of
// a launch over N nodes: a power of two of warps a CTA, up to
// kNodeMaxWarps (half that in float64), no more than N spread over the SMs
// needs, and no more than fit in a CTA's shared memory; 0 CTAs if one node
// does not fit.
template <class T>
int node_shape(int N, int nmeta, int nrobot, int ws, int* out) {
  int dev, sms, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int Wmax = sizeof(T) == 4 ? kNodeMaxWarps : kNodeMaxWarps / 2;
  const int spread = (N + sms - 1) / sms;  // warps an SM needs to hold N
  int W = 1;
  while (2 * W <= Wmax && 2 * W <= spread) W *= 2;
  while (W > 1 && node_smem<T>(nmeta, nrobot, ws, W) > (size_t)optin) W /= 2;
  const size_t smem = node_smem<T>(nmeta, nrobot, ws, W);
  out[0] = smem > (size_t)optin ? 0 : (N + W - 1) / W;
  out[1] = 32 * W;
  out[2] = W;
  out[3] = (int)smem;
  return 0;
}

template <class T>
int launch_node(int N, int B, int nmeta, int nrobot, int ws, const int* meta,
                const T* robot, const T* par, const T* x, const T* u, T* Fx,
                T* Fu, T* Lx, T* Lu, T* Lxx, T* Lxu, T* Luu, T* xnext, T* cost,
                void* stream) {
  int shape[4];
  int err = node_shape<T>(N, nmeta, nrobot, ws, shape);
  if (err) return err;
  if (shape[0] == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      node_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, shape[3]);
  if (e != cudaSuccess) return (int)e;
  node_kernel<T><<<shape[0], shape[1], shape[3], (cudaStream_t)stream>>>(
      N, B, nmeta, nrobot, ws, meta, robot, par, x, u, Fx, Fu, Lx, Lu, Lxx,
      Lxu, Luu, xnext, cost);
  return (int)cudaGetLastError();
}

}  // namespace croc

#define CROC_NODE(NAME, T)                                                   \
  extern "C" int NAME(int N, int B, int nmeta, int nrobot, int ws,           \
                      const int* meta, const T* robot, const T* par,         \
                      const T* x, const T* u, T* Fx, T* Fu, T* Lx, T* Lu,    \
                      T* Lxx, T* Lxu, T* Luu, T* xnext, T* cost,             \
                      void* stream) {                                        \
    return croc::launch_node<T>(N, B, nmeta, nrobot, ws, meta, robot, par,  \
                                x, u, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext,  \
                                cost, stream);                               \
  }                                                                          \
  extern "C" int NAME##_shape(int N, int nmeta, int nrobot, int ws,          \
                              int* out) {                                    \
    return croc::node_shape<T>(N, nmeta, nrobot, ws, out);                   \
  }
CROC_NODE(croc_node_f32, float)
CROC_NODE(croc_node_f64, double)
#endif  // __CUDACC__
