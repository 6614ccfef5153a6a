// The Riccati backward pass of one problem, run by one CTA: the reversed-
// time loop shared by the batched kernel (riccati_kernel.cu, one CTA per
// problem), the single-problem kernel (riccati_fused_kernel.cu) and the
// host build of tests/test_torch_fused_scans.py (a CTA of std::threads).
//
// Per step: the Q-terms, Quu += ureg·I, Jacobi equilibration and a 12x12
// Cholesky, the gains K, k and Quuk, then Vxx = sym(Qxx − Qxu·K) + xreg·I
// and Vx = Qx + Kᵀ·Quuk − 2·Kᵀ·Qu + Vxx·f.  The failure flag keeps
// crocoddyl_tpu/ops/fused_scans.py:106-136 (and :391-409) exactly: a NaN in
// the Cholesky (the square root of a negative pivot) or |V| ≥ 1e30 / NaN.
// No library Cholesky and no info code: NaN propagation is the signal.
//
// Layout: Vxx, Vx and the step's blocks sit in dynamic shared memory
// (riccati_smem bytes).  The blocks of step t − 1 (Fx, Fu, Lxx, Lxu, Luu,
// Lx, Lu, f) are copied into the other half of a double buffer by the pipe
// while step t runs, so no read of device memory sits on the chain; each
// step's Q-terms overwrite its own half in place (Qxx over Lxx, ...).
//
// A step is five phases, each ended by one CTA barrier:
//   A  tmp = Fxᵀ·Vxx, FuV = Fuᵀ·Vxx, Qx, Qu;
//   B  Qxu = Lxu + tmp·Fu, Quu = Luu + FuV·Fu + ureg·I;
//   C  warp 0: the equilibrated Cholesky of Quu with lane i holding row i
//      of the factor in registers (each finished column also goes to a
//      small shared table Ls, the pivot by shuffle), then the ndx + 1
//      right-hand sides (Qxuᵀ | Qu) solved in registers, lane c holding
//      columns c and c + 32, multiplying by the pivots' and the scales'
//      reciprocals (one IEEE division each, off the solves' chains);
//      meanwhile the other warps issue the copies of step t − 1 (their
//      issue stalls while the memory system is busy: the chain of warp 0
//      hides it) and form Qxx = Lxx + tmp·Fx;
//   D  G = Qxx − Qxu·K (into tmp), Quuk = Quu·k, the gains' outputs;
//   E  Vxx = ½(G + Gᵀ) + xreg·I and Vx = Qx + Kᵀ·Quuk − 2·Kᵀ·Qu + Vxx·f,
//      Vxx·f's entries formed from G as Vxx's are (the same values).
// The next step's pipe wait is E's barrier.  In the products a thread
// forms one column's entries of four neighbouring rows (four independent
// sums); the lanes of a warp take neighbouring columns, so the operand they
// share is one broadcast and the other is read without bank conflicts.
// Warp 0's registers hold NU rows, NU a compile-time size (12 or 16, ≥ nu):
// rows nu..NU−1 are those of the identity, whose zeros leave the true
// rows' sums unchanged, so the loops unroll with compile-time indices and
// no branch around a shuffle or warp barrier.  Every sum keeps the previous kernel's order (over k
// ascending, left-looking factorization); a division there is a product
// with a reciprocal here, which moves a result by an ulp at most.
#pragma once

#include <math.h>
#ifndef __CUDACC__
#ifndef __device__
#define __device__
#endif
#ifndef __host__
#define __host__
#endif
#endif

namespace croc {

// Largest nu whose Quu rows fit the register arrays of phase C.
constexpr int kRiccatiMaxNu = 16;

// The register rows of phase C for nu controls: 12 or 16
__host__ __device__ inline int riccati_nu_pad(int nu) { return nu <= 12 ? 12 : 16; }

// Strides of the inputs Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs: value
// (t, e) of problem b sits at p[t·ts + e·es + b], e the row-major index of
// the element axes.  Outputs are written at ((t·size + e)·B + b).
struct LaneStrides {
  long long ts[10], es[10];
};

// Elements of one buffered step: Fx, Fu, Lxx, Lxu, Luu, Lx, Lu, f
__host__ __device__ inline int riccati_step_elems(int ndx, int nu) {
  return 2 * ndx * ndx + 2 * ndx * nu + nu * nu + 2 * ndx + nu;
}

__host__ __device__ inline size_t riccati_smem(int ndx, int nu, size_t elem) {
  size_t n = (size_t)ndx * ndx + ndx + 2 * (size_t)riccati_step_elems(ndx, nu) +
             (size_t)ndx * ndx + (size_t)ndx * nu + (size_t)nu * (ndx + 1) + nu +
             kRiccatiMaxNu * (kRiccatiMaxNu + 1);
  return n * elem;
}

// Problem b of B; ``sm`` holds riccati_smem(ndx, nu, sizeof(T)) bytes.
// Every thread of the CTA calls it; the CTA has at least two warps,
// nu ≤ NU (riccati_nu_pad) and ndx + 1 ≤ 64.
template <class T, int NU, class Cta, class Pipe>
__device__ void riccati_cta(const Cta& cta, const Pipe& pipe, int Tn, int B, int b,
                            int ndx, int nu, const LaneStrides& S, const T* Fx,
                            const T* Fu, const T* Lx, const T* Lu, const T* Lxx,
                            const T* Lxu, const T* Luu, const T* LxT,
                            const T* LxxT, const T* fs, T xreg, T ureg,
                            T* Vx_o, T* Vxx_o, T* Qu_o, T* k_o, T* K_o,
                            T* Quuk_o, unsigned char* failed_o, T* sm) {
  const int tid = cta.tid(), nth = cta.size();
  const int n2 = ndx * ndx, nxu = ndx * nu, nr = ndx + 1;
  const int qx = (ndx + 3) / 4, qu = (nu + 3) / 4;  // row quads
  const int nstep = riccati_step_elems(ndx, nu);
  T* Vxx = sm;          T* Vx = Vxx + n2;      T* buf = Vx + ndx;
  T* tmp = buf + 2 * nstep;                    T* FuV = tmp + n2;
  T* Y = FuV + nxu;     T* Qk = Y + nu * nr;
  // L's rows below the diagonal, 1 / L's diagonal on it; 1 / the scales
  T* Ls = Qk + nu;      T* Dinv = Ls + NU * NU;
  auto at = [&](const T* p, int k, long t, long e) {
    return p + (t * S.ts[k] + e * S.es[k] + b);
  };
  // the blocks of step t in its half of the buffer
  struct Blocks { T *Fx, *Fu, *Lxx, *Lxu, *Luu, *Lx, *Lu, *f; };
  auto blocks = [&](int t) {
    Blocks r;
    r.Fx = buf + (t & 1) * nstep;  r.Fu = r.Fx + n2;   r.Lxx = r.Fu + nxu;
    r.Lxu = r.Lxx + n2;            r.Luu = r.Lxu + nxu; r.Lx = r.Luu + nu * nu;
    r.Lu = r.Lx + ndx;             r.f = r.Lu + nu;
    return r;
  };
  // the copies of step t's blocks, by threads id of n
  auto fetch = [&](int t, int id, int n) {
    const Blocks r = blocks(t);
    auto stream = [&](T* dst, const T* p, int k, int m) {  // elements [0, m)
      const long long jump = (long long)n * S.es[k];
      const T* src = at(p, k, t, id);
      for (int e = id; e < m; e += n, src += jump) pipe.copy(dst + e, src);
    };
    stream(r.Fx, Fx, 0, n2);
    stream(r.Lxx, Lxx, 4, n2);
    stream(r.Fu, Fu, 1, nxu);
    stream(r.Lxu, Lxu, 5, nxu);
    stream(r.Luu, Luu, 6, nu * nu);
    stream(r.Lx, Lx, 2, ndx);
    stream(r.f, fs, 9, ndx);
    stream(r.Lu, Lu, 3, nu);
    pipe.commit();
  };

  bool bad = false;  // this thread's share of the failure checks
  if (Tn > 0) fetch(Tn - 1, tid, nth);
  // ---- terminal: Vxx = LxxT + xreg·I, Vx = LxT + Vxx·f_T -----------------
  T* fT = tmp;  // f_T, read before tmp is first written
  for (int e = tid; e < n2; e += nth)
    Vxx[e] = *at(LxxT, 8, 0, e) + (e / ndx == e % ndx ? xreg : T(0));
  for (int e = tid; e < ndx; e += nth) fT[e] = *at(fs, 9, Tn, e);
  cta.sync();
  for (int i = tid; i < ndx; i += nth) {
    T s = *at(LxT, 7, 0, i);
    for (int j = 0; j < ndx; ++j) s += Vxx[i * ndx + j] * fT[j];
    Vx[i] = s;
    Vx_o[((long)Tn * ndx + i) * B + b] = s;
    bad |= !(fabs(s) < T(1e30));
  }
  for (int e = tid; e < n2; e += nth) {
    Vxx_o[((long)Tn * n2 + e) * B + b] = Vxx[e];
    bad |= !(fabs(Vxx[e]) < T(1e30));
  }

  for (int t = Tn - 1; t >= 0; --t) {
    pipe.wait();  // step t's blocks are in, and the CTA is past step t + 1
    const Blocks q = blocks(t);
    T *Qxx = q.Lxx, *Qxu = q.Lxu, *Quu = q.Luu, *Qx = q.Lx, *Qu = q.Lu;
    // ---- A: tmp = Fxᵀ·Vxx, FuV = Fuᵀ·Vxx (nu x ndx), Qx, Qu --------------
    for (int w = tid; w < (qx + qu) * ndx + ndx + nu; w += nth) {
      if (w < (qx + qu) * ndx) {  // rows i0.. of tmp or FuV, column j
        const bool x = w < qx * ndx;
        const int v = x ? w : w - qx * ndx, i0 = 4 * (v / ndx), j = v % ndx;
        const int m = x ? ndx : nu;
        const T* A = (x ? q.Fx : q.Fu) + i0;
        T s[4] = {T(0), T(0), T(0), T(0)};
        for (int kk = 0; kk < ndx; ++kk) {
          const T vj = Vxx[kk * ndx + j];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (i0 + c < m) s[c] += A[kk * m + c] * vj;
        }
        T* o = (x ? tmp : FuV) + i0 * ndx + j;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + c < m) o[c * ndx] = s[c];
      } else {  // Qx[i] or Qu[i]
        const int v = w - (qx + qu) * ndx;
        const bool x = v < ndx;
        const int i = x ? v : v - ndx, m = x ? ndx : nu;
        const T* A = (x ? q.Fx : q.Fu) + i;
        T s = 0;
        for (int kk = 0; kk < ndx; ++kk) s += A[kk * m] * Vx[kk];
        (x ? Qx : Qu)[i] += s;
      }
    }
    cta.sync();
    // ---- B: Qxu += tmp·Fu, Quu += FuV·Fu + ureg·I (rows i0.., column j) -
    for (int w = tid; w < (qx + qu) * nu; w += nth) {
      const bool x = w < qx * nu;
      const int v = x ? w : w - qx * nu, i0 = 4 * (v / nu), j = v % nu;
      const int m = x ? ndx : nu;
      const T* A = (x ? tmp : FuV) + i0 * ndx;
      T s[4] = {T(0), T(0), T(0), T(0)};
      for (int kk = 0; kk < ndx; ++kk) {
        const T f = q.Fu[kk * nu + j];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + c < m) s[c] += A[c * ndx + kk] * f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = i0 + c;
        if (i >= m) continue;
        if (x)
          Qxu[i * nu + j] += s[c];
        else
          Quu[i * nu + j] += s[c] + (i == j ? ureg : T(0));
      }
    }
    cta.sync();
    if (tid < 32) {
      // ---- C, warp 0: equilibrated Cholesky, lane i holding row i --------
      const int ln = tid;
      const bool row = ln < nu;
      T dsi = T(1);
      if (row) {
        const T qd = Quu[ln * nu + ln];
        dsi = sqrt(qd > T(1e-30) ? qd : T(1e-30));
      }
      const T dinv = T(1) / dsi;
      if (ln < NU) Dinv[ln] = dinv;
      cta.wsync();
      T r[NU];  // row ln of Quu equilibrated, overwritten column by column by L's
#pragma unroll
      for (int k = 0; k < NU; ++k)
        r[k] = row && k < nu ? Quu[ln * nu + k] * dinv * Dinv[k] : T(ln == k ? 1 : 0);
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T s = r[j];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= r[k] * Ls[j * NU + k];
        const T dj = sqrt(cta.shfl(s, j));
        const T rj = T(1) / dj;
        r[j] = ln == j ? dj : ln > j ? s * rj : r[j];
        if (ln < NU && ln >= j) Ls[ln * NU + j] = ln == j ? rj : r[j];
        bad |= row && ln >= j && isnan(r[j]);
        cta.wsync();
      }
      // ---- K = Quu⁻¹·Qxuᵀ and k = Quu⁻¹·Qu: lane c solves columns c and
      // c + 32 of (Qxuᵀ | Qu) in registers, reading L from Ls ----------------
      const int ca = ln, cb = ln + 32;
      T ya[NU], yb[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T sa = T(0), sb = T(0);
        if (i < nu) {
          if (ca < nr) sa = (ca < ndx ? Qxu[ca * nu + i] : Qu[i]) * Dinv[i];
          if (cb < nr) sb = (cb < ndx ? Qxu[cb * nu + i] : Qu[i]) * Dinv[i];
        }
#pragma unroll
        for (int k = 0; k < i; ++k) {
          const T l = Ls[i * NU + k];
          sa -= l * ya[k];
          sb -= l * yb[k];
        }
        const T linv = Ls[i * NU + i];
        ya[i] = sa * linv;
        yb[i] = sb * linv;
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        T sa = ya[i], sb = yb[i];
#pragma unroll
        for (int k = i + 1; k < NU; ++k) {
          const T l = Ls[k * NU + i];
          sa -= l * ya[k];
          sb -= l * yb[k];
        }
        const T linv = Ls[i * NU + i];
        ya[i] = sa * linv;
        yb[i] = sb * linv;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (i < nu) {
          if (ca < nr) Y[i * nr + ca] = ya[i] * Dinv[i];
          if (cb < nr) Y[i * nr + cb] = yb[i] * Dinv[i];
        }
      }
    } else {
      // ---- C, the other warps: the copies of step t − 1, Qxx += tmp·Fx ----
      if (t > 0) fetch(t - 1, tid - 32, nth - 32);
      for (int w = tid - 32; w < qx * ndx; w += nth - 32) {
        const int i0 = 4 * (w / ndx), j = w % ndx;
        const T* A = tmp + i0 * ndx;
        T s[4] = {T(0), T(0), T(0), T(0)};
        for (int kk = 0; kk < ndx; ++kk) {
          const T f = q.Fx[kk * ndx + j];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (i0 + c < ndx) s[c] += A[c * ndx + kk] * f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + c < ndx) Qxx[(i0 + c) * ndx + j] += s[c];
      }
    }
    cta.sync();
    // ---- D: G = Qxx − Qxu·K into tmp, Quuk = Quu·k; the gains' outputs --
    for (int w = tid; w < qx * ndx + nu; w += nth) {
      if (w < qx * ndx) {
        const int i0 = 4 * (w / ndx), j = w % ndx;
        T g[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) g[c] = i0 + c < ndx ? Qxx[(i0 + c) * ndx + j] : T(0);
        for (int kk = 0; kk < nu; ++kk) {
          const T y = Y[kk * nr + j];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (i0 + c < ndx) g[c] -= Qxu[(i0 + c) * nu + kk] * y;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (i0 + c < ndx) tmp[(i0 + c) * ndx + j] = g[c];
      } else {
        const int i = w - qx * ndx;
        T s = 0;
        for (int j = 0; j < nu; ++j) s += Quu[i * nu + j] * Y[j * nr + ndx];
        Qk[i] = s;
        Qu_o[((long)t * nu + i) * B + b] = Qu[i];
        k_o[((long)t * nu + i) * B + b] = Y[i * nr + ndx];
        Quuk_o[((long)t * nu + i) * B + b] = s;
      }
    }
    for (int e = tid; e < nu * ndx; e += nth)
      K_o[((long)t * nu * ndx + e) * B + b] = Y[(e / ndx) * nr + e % ndx];
    cta.sync();
    // ---- E: Vxx = sym(G) + xreg·I; Vx = Qx + Kᵀ·Quuk − 2·Kᵀ·Qu + Vxx·f,
    // the entries of Vxx·f formed again from G as in Vxx ---------------------
    auto vxx = [&](int i, int j) {
      return T(0.5) * (tmp[i * ndx + j] + tmp[j * ndx + i]) + (i == j ? xreg : T(0));
    };
    for (int w = tid; w < ndx + n2; w += nth) {
      if (w < ndx) {
        const int i = w;
        T s1 = 0, s2 = 0;
        for (int kk = 0; kk < nu; ++kk) {
          s1 += Y[kk * nr + i] * Qk[kk];
          s2 += Y[kk * nr + i] * Qu[kk];
        }
        const T h = Qx[i] + s1 - T(2) * s2;
        T s = 0;
        for (int j = 0; j < ndx; ++j) s += vxx(i, j) * q.f[j];
        const T v = h + s;
        Vx[i] = v;
        Vx_o[((long)t * ndx + i) * B + b] = v;
        bad |= !(fabs(v) < T(1e30));
      } else {
        const int e = w - ndx;
        const T v = vxx(e / ndx, e % ndx);
        Vxx[e] = v;
        Vxx_o[((long)t * n2 + e) * B + b] = v;
        bad |= !(fabs(v) < T(1e30));
      }
    }
  }
  const bool any_bad = cta.any(bad);
  if (tid == 0) failed_o[b] = any_bad ? 1 : 0;
}

}  // namespace croc
