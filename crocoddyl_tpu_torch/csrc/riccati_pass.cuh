// The Riccati backward pass of one problem, run by one CTA: the reversed-
// time loop shared by the batched kernel (riccati_kernel.cu, one CTA per
// problem) and the single-problem kernel (riccati_fused_kernel.cu).
//
// Per step: the Q-terms, Quu += ureg·I, Jacobi equilibration and a 12x12
// Cholesky, the gains K, k and Quuk, then Vxx = sym(Qxx − Qxu·K) + xreg·I
// and Vx = Qx + Kᵀ·Quuk − 2·Kᵀ·Qu + Vxx·f.  The failure flag keeps
// crocoddyl_tpu/ops/fused_scans.py:106-136 (and :391-409) exactly: a NaN in
// the Cholesky (the square root of a negative pivot) or |V| ≥ 1e30 / NaN.
//
// Vxx and the step's Fx, Fu, Lxx, Lxu, Luu blocks sit in dynamic shared
// memory (riccati_smem bytes).  The CTA's threads split the 36x36 products;
// warp 0 factors the equilibrated 12x12 Quu (lane i owns row i, one column
// per step), and the ndx + 1 right-hand sides (Qxuᵀ | Qu) are solved one
// per thread.  No library Cholesky and no info code: NaN propagation is the
// failure signal.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace croc {

// Strides of the inputs Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs: value
// (t, e) of problem b sits at p[t·ts + e·es + b], e the row-major index of
// the element axes.  Outputs are written at ((t·size + e)·B + b).
struct LaneStrides {
  long long ts[10], es[10];
};

inline size_t riccati_smem(int ndx, int nu, size_t elem) {
  size_t n = 4 * (size_t)ndx * ndx + ndx + 3 * (size_t)ndx * nu + nu * nu +
             ndx + nu + ndx + nu * nu + nu + nu * (ndx + 1) + nu;
  return n * elem;
}

// Problem b of B; ``sm`` holds riccati_smem(ndx, nu, sizeof(T)) bytes and
// ``bad`` is a shared int.  Every thread of the CTA calls it.
template <class T>
__device__ void riccati_cta(int Tn, int B, int b, int ndx, int nu,
                            const LaneStrides& S, const T* Fx, const T* Fu,
                            const T* Lx, const T* Lu, const T* Lxx,
                            const T* Lxu, const T* Luu, const T* LxT,
                            const T* LxxT, const T* fs, T xreg, T ureg,
                            T* Vx_o, T* Vxx_o, T* Qu_o, T* k_o, T* K_o,
                            T* Quuk_o, unsigned char* failed_o, T* sm,
                            int& bad) {
  const int tid = threadIdx.x, nth = blockDim.x;
  const int n2 = ndx * ndx, nxu = ndx * nu, nr = ndx + 1;
  T* Vxx = sm;            T* Vx = Vxx + n2;
  T* sFx = Vx + ndx;      T* Qxx = sFx + n2;     T* tmp = Qxx + n2;
  T* sFu = tmp + n2;      T* Qxu = sFu + nxu;    T* FuV = Qxu + nxu;
  T* Quu = FuV + nxu;     T* Qx = Quu + nu * nu; T* Qu = Qx + ndx;
  T* f = Qu + nu;         T* Lc = f + ndx;       T* ds = Lc + nu * nu;
  T* Y = ds + nu;         T* Qk = Y + nu * nr;
  auto at = [&](const T* p, int k, long t, long e) {
    return p[t * S.ts[k] + e * S.es[k] + b];
  };

  // ---- terminal: Vxx = LxxT + xreg·I, Vx = LxT + Vxx·f_T -----------------
  if (tid == 0) bad = 0;
  for (int e = tid; e < n2; e += nth)
    Vxx[e] = at(LxxT, 8, 0, e) + (e / ndx == e % ndx ? xreg : T(0));
  for (int e = tid; e < ndx; e += nth) f[e] = at(fs, 9, Tn, e);
  __syncthreads();
  for (int i = tid; i < ndx; i += nth) {
    T s = at(LxT, 7, 0, i);
    for (int j = 0; j < ndx; ++j) s += Vxx[i * ndx + j] * f[j];
    Vx[i] = s;
  }
  __syncthreads();
  for (int e = tid; e < n2; e += nth) {
    Vxx_o[((long)Tn * n2 + e) * B + b] = Vxx[e];
    if (!(fabs(Vxx[e]) < T(1e30))) bad = 1;
  }
  for (int i = tid; i < ndx; i += nth) {
    Vx_o[((long)Tn * ndx + i) * B + b] = Vx[i];
    if (!(fabs(Vx[i]) < T(1e30))) bad = 1;
  }

  for (int t = Tn - 1; t >= 0; --t) {
    __syncthreads();
    // ---- load the step's blocks (Lxx → Qxx, Lxu → Qxu, Luu → Quu, ...)
    for (int e = tid; e < n2; e += nth) {
      sFx[e] = at(Fx, 0, t, e);
      Qxx[e] = at(Lxx, 4, t, e);
    }
    for (int e = tid; e < nxu; e += nth) {
      sFu[e] = at(Fu, 1, t, e);
      Qxu[e] = at(Lxu, 5, t, e);
    }
    for (int e = tid; e < nu * nu; e += nth) Quu[e] = at(Luu, 6, t, e);
    for (int e = tid; e < ndx; e += nth) {
      Qx[e] = at(Lx, 2, t, e);
      f[e] = at(fs, 9, t, e);
    }
    for (int e = tid; e < nu; e += nth) Qu[e] = at(Lu, 3, t, e);
    __syncthreads();
    // tmp = Fxᵀ·Vxx, FuV = Fuᵀ·Vxx (nu x ndx)
    for (int e = tid; e < n2 + nxu; e += nth) {
      const bool x = e < n2;
      const int i = x ? e / ndx : (e - n2) / ndx, j = (x ? e : e - n2) % ndx;
      const T* A = x ? sFx : sFu;
      const int lda = x ? ndx : nu;
      T s = 0;
      for (int kk = 0; kk < ndx; ++kk) s += A[kk * lda + i] * Vxx[kk * ndx + j];
      (x ? tmp : FuV)[i * ndx + j] = s;
    }
    __syncthreads();
    // Qxx += tmp·Fx, Qxu += tmp·Fu, Quu += FuV·Fu + ureg·I, Qx, Qu
    for (int e = tid; e < n2 + nxu + nu * nu + ndx + nu; e += nth) {
      if (e < n2) {
        int i = e / ndx, j = e % ndx;
        T s = 0;
        for (int kk = 0; kk < ndx; ++kk) s += tmp[i * ndx + kk] * sFx[kk * ndx + j];
        Qxx[e] += s;
      } else if (e < n2 + nxu) {
        int r = e - n2, i = r / nu, j = r % nu;
        T s = 0;
        for (int kk = 0; kk < ndx; ++kk) s += tmp[i * ndx + kk] * sFu[kk * nu + j];
        Qxu[r] += s;
      } else if (e < n2 + nxu + nu * nu) {
        int r = e - n2 - nxu, i = r / nu, j = r % nu;
        T s = 0;
        for (int kk = 0; kk < ndx; ++kk) s += FuV[i * ndx + kk] * sFu[kk * nu + j];
        Quu[r] += s + (i == j ? ureg : T(0));
      } else if (e < n2 + nxu + nu * nu + ndx) {
        int i = e - n2 - nxu - nu * nu;
        T s = 0;
        for (int kk = 0; kk < ndx; ++kk) s += sFx[kk * ndx + i] * Vx[kk];
        Qx[i] += s;
      } else {
        int i = e - n2 - nxu - nu * nu - ndx;
        T s = 0;
        for (int kk = 0; kk < ndx; ++kk) s += sFu[kk * nu + i] * Vx[kk];
        Qu[i] += s;
      }
    }
    __syncthreads();
    // ---- equilibrated Cholesky of Quu (warp 0: lane i owns row i) ----------
    if (tid < 32) {
      if (tid < nu) {
        T q = Quu[tid * nu + tid];
        ds[tid] = sqrt(q > T(1e-30) ? q : T(1e-30));
      }
      __syncwarp();
      for (int j = 0; j < nu; ++j) {
        if (tid == j) {
          T s = Quu[j * nu + j] / ds[j] / ds[j];
          for (int kk = 0; kk < j; ++kk) s -= Lc[j * nu + kk] * Lc[j * nu + kk];
          T dj = sqrt(s);
          Lc[j * nu + j] = dj;
          if (isnan(dj)) bad = 1;
        }
        __syncwarp();
        if (tid > j && tid < nu) {
          T v = Quu[tid * nu + j] / ds[tid] / ds[j];
          for (int kk = 0; kk < j; ++kk) v -= Lc[tid * nu + kk] * Lc[j * nu + kk];
          v = v / Lc[j * nu + j];
          Lc[tid * nu + j] = v;
          if (isnan(v)) bad = 1;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // ---- K = Quu⁻¹·Qxuᵀ and k = Quu⁻¹·Qu, one right-hand side per thread
    for (int c = tid; c < nr; c += nth) {
      for (int i = 0; i < nu; ++i) {
        T s = (c < ndx ? Qxu[c * nu + i] : Qu[i]) / ds[i];
        for (int kk = 0; kk < i; ++kk) s -= Lc[i * nu + kk] * Y[kk * nr + c];
        Y[i * nr + c] = s / Lc[i * nu + i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        T s = Y[i * nr + c];
        for (int kk = i + 1; kk < nu; ++kk) s -= Lc[kk * nu + i] * Y[kk * nr + c];
        Y[i * nr + c] = s / Lc[i * nu + i];
      }
      for (int i = 0; i < nu; ++i) Y[i * nr + c] /= ds[i];
    }
    __syncthreads();
    // Quuk = Quu·k
    for (int i = tid; i < nu; i += nth) {
      T s = 0;
      for (int j = 0; j < nu; ++j) s += Quu[i * nu + j] * Y[j * nr + ndx];
      Qk[i] = s;
    }
    __syncthreads();
    // ---- Vxx = sym(Qxx − Qxu·K) + xreg·I; Vx = Qx + Kᵀ·Quuk − 2·Kᵀ·Qu ----
    for (int e = tid; e < n2; e += nth) {
      int i = e / ndx, j = e % ndx;
      T a = Qxx[i * ndx + j], c = Qxx[j * ndx + i];
      for (int kk = 0; kk < nu; ++kk) {
        a -= Qxu[i * nu + kk] * Y[kk * nr + j];
        c -= Qxu[j * nu + kk] * Y[kk * nr + i];
      }
      Vxx[e] = T(0.5) * (a + c) + (i == j ? xreg : T(0));
    }
    for (int i = tid; i < ndx; i += nth) {
      T s = Qx[i];
      T s1 = 0, s2 = 0;
      for (int kk = 0; kk < nu; ++kk) {
        s1 += Y[kk * nr + i] * Qk[kk];
        s2 += Y[kk * nr + i] * Qu[kk];
      }
      tmp[i] = s + s1 - T(2) * s2;
    }
    __syncthreads();
    for (int i = tid; i < ndx; i += nth) {
      T s = 0;
      for (int j = 0; j < ndx; ++j) s += Vxx[i * ndx + j] * f[j];
      Vx[i] = tmp[i] + s;
    }
    __syncthreads();
    // ---- outputs and the |V| ≥ 1e30 / NaN check ---------------------------
    for (int e = tid; e < n2; e += nth) {
      Vxx_o[((long)t * n2 + e) * B + b] = Vxx[e];
      if (!(fabs(Vxx[e]) < T(1e30))) bad = 1;
    }
    for (int i = tid; i < ndx; i += nth) {
      Vx_o[((long)t * ndx + i) * B + b] = Vx[i];
      if (!(fabs(Vx[i]) < T(1e30))) bad = 1;
    }
    for (int e = tid; e < nu * ndx; e += nth)
      K_o[((long)t * nu * ndx + e) * B + b] = Y[(e / ndx) * nr + e % ndx];
    for (int i = tid; i < nu; i += nth) {
      Qu_o[((long)t * nu + i) * B + b] = Qu[i];
      k_o[((long)t * nu + i) * B + b] = Y[i * nr + ndx];
      Quuk_o[((long)t * nu + i) * B + b] = Qk[i];
    }
  }
  __syncthreads();
  if (tid == 0) failed_o[b] = bad ? 1 : 0;
}

}  // namespace croc
