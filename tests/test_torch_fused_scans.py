"""Riccati backward pass and trial rollout: the port's plain versions of
kernels 2 and 3 vs the JAX lane functions (``interpret=True``, whose CPU
path is the plain lax.scan), float64 on CPU, on the reduced walk's
derivatives.  Tolerance 1e-10 of each output's max-abs, except the gains k
and K: they solve Quu·k = Qu with cond(Quu) up to ~1e6 on this walk (the
dt=0 switch knots weigh the friction-cone terms against a 1e-3 control
weight), so a last-bit difference in Quu moves them by ~1e-9 of their
max-abs (measured 9e-10 at the warm start); they are held to 1e-8, the
slice's own bar for K and k.  Failure flags equal, including lanes whose
Quu is not positive definite.

The rollout kernels' step loop (csrc/rollout_step.cuh with node_math.cuh's
team primal) is also built for the host with a team of std::threads, at
team sizes 1 and 32, and the Riccati kernels' CTA body
(csrc/riccati_pass.cuh) on a CTA of 64 std::threads (two warps: warp 0
factors Quu with lane shuffles while the other forms Qxx); both are held
to the same JAX references: a wrong partition, index or missing sync shows
up here before a chip run."""

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import (jax_walk_problem, max_rel, node_inputs, np_,
                                 t64, to_port)

FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "crocoddyl_tpu_torch", "csrc")

# A host loop over the problems around the rollout kernels' step loop: each
# problem runs on a team of std::threads with a barrier and a shared buffer
# for sums and broadcasts; the copies of step rows happen at once.
_ROLLOUT_HOST = """
#include <barrier>
#include <thread>
#include <vector>

namespace {
struct HostTeam {
  int l, n;
  std::barrier<>* bar;
  double* buf;
  int lane() const { return l; }
  int size() const { return n; }
  void sync() const { bar->arrive_and_wait(); }
  template <class S> S sum(S x) const {
    buf[l] = x;
    sync();
    S s = 0;
    for (int i = 0; i < n; ++i) s += buf[i];
    sync();
    return s;
  }
  template <class S> S bcast(S x) const {
    if (l == 0) buf[0] = x;
    sync();
    const S r = buf[0];
    sync();
    return r;
  }
};

struct HostPipe {
  const HostTeam* tm;
  template <class T> void copy(T* dst, const T* src) const { *dst = *src; }
  void commit() const {}
  void wait() const { tm->sync(); }
};
}  // namespace

// -1 if the workspace size differs from the kernels' layout
extern "C" int rollout_host_f64(
    int team, int Tn, int B, int ws, const int* meta, const double* robot,
    const double* par, const double* x0, const double* xs, const double* us,
    const double* k, const double* K, const double* fs, double alpha,
    double* xs_try, double* us_try, double* x_last, double* cost,
    unsigned char* failed) {
  const croc::Desc<double> d{meta, robot};
  const croc::Lay L(d);
  if (L.size + 4 * d.nv() + 2 * croc::step_row_elems(d) != ws) return -1;
  for (int b = 0; b < B; ++b) {
    std::vector<double> parbuf(2 * d.P()), work(ws), buf(team);
    std::barrier<> bar(team);
    std::vector<std::thread> lanes;
    for (int l = 0; l < team; ++l)
      lanes.emplace_back([&, l] {
        const HostTeam tm{l, team, &bar, buf.data()};
        croc::rollout_problem(tm, HostPipe{&tm}, l, team, d, Tn, B, b, true,
                              par, parbuf.data(), work.data(), x0, xs, us, k,
                              K, fs, alpha, xs_try, us_try, x_last, cost,
                              failed);
      });
    for (auto& t : lanes) t.join();
  }
  return 0;
}
"""


def _lanes(a, B):
    """(..., K·B) → (K, ..., B)."""
    a = np.asarray(a)
    return np.moveaxis(a.reshape(a.shape[:-1] + (-1, B)), -2, 0)


# A host loop over the problems around the Riccati kernels' CTA body: each
# problem runs on a CTA of std::threads with a barrier, a 32-thread barrier
# and a shared buffer for the shuffles of warp 0, and the copies of step
# blocks happen at once.
_RICCATI_HOST = """
#include <atomic>
#include <barrier>
#include <thread>
#include <vector>

namespace {
struct HostCta {
  int t, n;
  std::barrier<>* bar;
  std::barrier<>* wbar;
  double* buf;
  std::atomic<int>* flag;
  int tid() const { return t; }
  int size() const { return n; }
  void sync() const { bar->arrive_and_wait(); }
  bool any(bool p) const {
    if (p) flag->store(1);
    sync();
    const bool r = flag->load() != 0;
    sync();
    return r;
  }
  void wsync() const { wbar->arrive_and_wait(); }
  template <class S> S shfl(S x, int src) const {
    buf[t] = x;
    wbar->arrive_and_wait();
    const S r = buf[src];
    wbar->arrive_and_wait();
    return r;
  }
};

struct HostPipe {
  const HostCta* c;
  template <class T> void copy(T* dst, const T* src) const { *dst = *src; }
  void commit() const {}
  void wait() const { c->sync(); }
};
}  // namespace

template <int NU>
void riccati_problems(
    int team, int Tn, int B, int ndx, int nu, const long long* strides,
    const double* Fx, const double* Fu, const double* Lx, const double* Lu,
    const double* Lxx, const double* Lxu, const double* Luu,
    const double* LxT, const double* LxxT, const double* fs,
    const double* xreg, const double* ureg, double* Vx, double* Vxx,
    double* Qu, double* k, double* K, double* Quuk, unsigned char* failed) {
  croc::LaneStrides S;
  for (int i = 0; i < 10; ++i) {
    S.ts[i] = strides[2 * i];
    S.es[i] = strides[2 * i + 1];
  }
  for (int b = 0; b < B; ++b) {
    std::vector<double> sm(croc::riccati_smem(ndx, nu, 1)), buf(32);
    std::barrier<> bar(team), wbar(32);
    std::atomic<int> flag{0};
    std::vector<std::thread> threads;
    for (int l = 0; l < team; ++l)
      threads.emplace_back([&, l] {
        const HostCta cta{l, team, &bar, &wbar, buf.data(), &flag};
        croc::riccati_cta<double, NU>(cta, HostPipe{&cta}, Tn, B, b, ndx, nu,
                                      S, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT,
                                      LxxT, fs, xreg[b], ureg[b], Vx, Vxx,
                                      Qu, k, K, Quuk, failed, sm.data());
      });
    for (auto& t : threads) t.join();
  }
}

// the factor's register rows padded to NU = 12 or 16
extern "C" void riccati_host_f64(
    int NU, int team, int Tn, int B, int ndx, int nu, const long long* strides,
    const double* Fx, const double* Fu, const double* Lx, const double* Lu,
    const double* Lxx, const double* Lxu, const double* Luu,
    const double* LxT, const double* LxxT, const double* fs,
    const double* xreg, const double* ureg, double* Vx, double* Vxx,
    double* Qu, double* k, double* K, double* Quuk, unsigned char* failed) {
  (NU == 12 ? riccati_problems<12> : riccati_problems<16>)(
      team, Tn, B, ndx, nu, strides, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT,
      LxxT, fs, xreg, ureg, Vx, Vxx, Qu, k, K, Quuk, failed);
}
"""

RICCATI_OUT = ("Vx", "Vxx", "Qu", "k", "K", "Quuk")


def _host_lib(tmp_path_factory, name, header, body):
    """``header`` (a csrc file) with ``body`` appended, built for the host
    by the C++ compiler that builds native/urdf_loader.cpp."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler is needed (it also builds the URDF parser)"
    d = tmp_path_factory.mktemp(name)
    src, so = d / f"{name}.cpp", d / f"lib{name}.so"
    src.write_text(f'#include "{CSRC}/{header}"\n' + body)
    res = subprocess.run([cxx, "-O1", "-std=c++20", "-pthread", "-shared",
                          "-fPIC", "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def riccati_case():
    return _riccati_case()


@functools.lru_cache(maxsize=None)
def _riccati_case():
    """Derivatives (T, ..., B) + terminal, gaps, regularizations; lane 0 of
    the second regularization set has a non-PD Quu.  The derivatives are
    the port's plain node linearization of the nodes of ``jax_node_case``
    (held to JAX's by tests/test_torch_fused_node.py); the JAX and the
    port's Riccati passes both take them."""
    from crocoddyl_tpu.core.action import NodeDerivs as JD
    from crocoddyl_tpu_torch.core.action import NodeDerivs as TD
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    B = 2
    knots, xn, un = node_inputs(jax_walk_problem(), B)
    d_lin, _, _ = tfn.calc_both_lanes_plain(to_port(knots), t64(xn.T),
                                            t64(un.T))
    d = {f: _lanes(np_(getattr(d_lin, f)), B) for f in FIELDS}
    T = d["Fx"].shape[0] - 1
    ndx = d["Fx"].shape[1]
    rng = np.random.default_rng(5)
    fs = 1e-3 * rng.standard_normal((T + 1, ndx, B))
    run = {f: v[:T] for f, v in d.items()}
    jd = (JD(**{f: jnp.asarray(v) for f, v in run.items()}),
          JD(**{f: jnp.asarray(v[T]) for f, v in d.items()}))
    td = (TD(**{f: t64(v) for f, v in run.items()}),
          TD(**{f: t64(v[T]) for f, v in d.items()}))
    return jd, td, fs, B


def _regs(B, nonpd):
    """(xreg, ureg) of the Riccati checks; with ``nonpd`` lane 0's Quu is
    made indefinite."""
    xreg = np.full(B, 1e-9)
    ureg = xreg.copy()
    if nonpd:
        ureg[0] = -1e6
    return xreg, ureg


@functools.lru_cache(maxsize=None)
def _riccati_ref(nonpd):
    """JAX ``riccati_backward_lanes(..., interpret=True)`` on riccati_case,
    as numpy arrays."""
    from crocoddyl_tpu.ops import fused_scans as jfs
    (jd, jterm), _, fs, B = _riccati_case()
    xreg, ureg = _regs(B, nonpd)
    ref = jfs.riccati_backward_lanes(jd, jterm, jnp.asarray(fs),
                                     jnp.asarray(xreg), jnp.asarray(ureg),
                                     interpret=True)
    return tuple(np.asarray(a) for a in ref)


def _check_riccati(ref, out, nonpd):
    """Failure flags equal (lane 0 fails iff ``nonpd``); the other outputs
    on the lanes that did not fail, k and K within 1e-8 and the rest within
    1e-10 of their max-abs."""
    np.testing.assert_array_equal(ref[-1], np_(out[-1]).astype(bool))
    assert bool(np_(out[-1])[0]) == nonpd
    ok = ~ref[-1]
    for name, a, b in zip(RICCATI_OUT, ref[:-1], out[:-1]):
        tol = 1e-8 if name in ("k", "K") else 1e-10
        assert max_rel(a[..., ok], np_(b)[..., ok]) < tol, name


@pytest.mark.parametrize("nonpd", [False, True])
def test_plain_riccati_matches_jax(riccati_case, nonpd):
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    _, (td, tterm), fs, B = riccati_case
    xreg, ureg = _regs(B, nonpd)
    out = tfs.riccati_backward_lanes(td, tterm, t64(fs), t64(xreg),
                                     t64(ureg))
    _check_riccati(_riccati_ref(nonpd), out, nonpd)


@pytest.fixture(scope="module")
def riccati_host(tmp_path_factory):
    """csrc/riccati_pass.cuh (the Riccati kernels' CTA body) built for the
    host, with a CTA of std::threads."""
    return _host_lib(tmp_path_factory, "riccati_host", "riccati_pass.cuh",
                     _RICCATI_HOST)


@pytest.mark.parametrize("pad", [12, 16])
@pytest.mark.parametrize("nonpd", [False, True])
def test_riccati_kernel_source_matches_jax(riccati_case, riccati_host,
                                           nonpd, pad):
    """The Riccati kernels' CTA body (prefetched step blocks, the Cholesky
    and the gains' solves on warp 0's lane shuffles, with the factor's
    register rows at nu = 12 and padded to 16), run on the host by a CTA of
    64 threads over the B=3 problems, against the JAX lane pass and
    the port's plain version: failure flags equal, outputs within the
    tolerances of test_plain_riccati_matches_jax of both.  (Vx sums terms
    of Vxx·f up to ~1e3 times its own max-abs, so a summation order other
    than the plain version's moves it by ~1e-11 of its max-abs.)"""
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    _, (td, tterm), fs, B = riccati_case
    xreg, ureg = _regs(B, nonpd)
    ins = dict(Fx=td.Fx, Fu=td.Fu, Lx=td.Lx, Lu=td.Lu, Lxx=td.Lxx,
               Lxu=td.Lxu, Luu=td.Luu, LxT=tterm.Lx, LxxT=tterm.Lxx,
               fs=t64(fs))
    strides = np.array([s for key, a in ins.items()
                        for s in ck._lane_strides(
                            "riccati_host", key, a,
                            key not in ("LxT", "LxxT"))], dtype=np.int64)
    T, ndx, nu = td.Fx.shape[0], td.Fx.shape[1], td.Lu.shape[1]

    def e(*s):
        return torch.zeros(s, dtype=torch.float64)
    out = dict(Vx=e(T + 1, ndx, B), Vxx=e(T + 1, ndx, ndx, B),
               Qu=e(T, nu, B), k=e(T, nu, B), K=e(T, nu, ndx, B),
               Quuk=e(T, nu, B), failed=torch.zeros(B, dtype=torch.uint8))

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())
    regs = [t64(xreg), t64(ureg)]
    riccati_host.riccati_host_f64(
        pad, 64, T, B, ndx, nu, strides.ctypes.data_as(ctypes.c_void_p),
        *[ptr(a) for a in ins.values()], *[ptr(r) for r in regs],
        *[ptr(t) for t in out.values()])
    got = tuple(out.values())
    _check_riccati(_riccati_ref(nonpd), got, nonpd)
    plain = tfs.riccati_backward_lanes_plain(td, tterm, t64(fs), *regs)
    _check_riccati(tuple(np_(a) for a in plain), got, nonpd)


@functools.lru_cache(maxsize=None)
def _jax_rollout():
    """The JAX lane rollout ``trial_rollout_lanes(..., interpret=True)``
    jitted once, the step length an argument: both step lengths of the
    checks share one executable."""
    from crocoddyl_tpu.ops import fused_scans as jfs
    return jax.jit(lambda seg, *a: jfs.trial_rollout_lanes(
        seg, *a, interpret=True))


@functools.lru_cache(maxsize=None)
def _rollout_case(alpha):
    """Rollout inputs (T, ..., B) on the gains of riccati_case at
    regularization 1e-9 and the JAX lane rollout of them."""
    _, _, fs, B = _riccati_case()
    _, _, _, k, K, _, _ = _riccati_ref(False)
    prob = jax_walk_problem()
    knots, xn, un = node_inputs(prob, B)
    seg = prob.segments[0]
    T = prob.T
    xs = _lanes(xn.T, B)[:T]
    us = _lanes(un.T, B)[:T]
    x0 = xs[0]
    ref = _jax_rollout()(seg, *map(jnp.asarray, (
        x0, xs, us, k, K, fs[:-1], fs[-1], alpha)))
    ins = (x0, xs, us, k, K, fs[:-1])
    return seg, ins, fs[-1], tuple(np.asarray(a) for a in ref)


@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_plain_rollout_matches_jax(alpha):
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    seg, ins, fsT, ref = _rollout_case(alpha)
    out = tfs.trial_rollout_lanes(to_port(seg), *[t64(a) for a in ins],
                                  t64(fsT), alpha)
    np.testing.assert_array_equal(ref[-1], np_(out[-1]))
    for a, b in zip(ref[:-1], out[:-1]):
        assert max_rel(a, b) < 1e-10


@pytest.fixture(scope="module")
def rollout_host(tmp_path_factory):
    """csrc/rollout_kernel.cu (the rollout step loop and the team primal)
    built for the host, with a team of std::threads."""
    return _host_lib(tmp_path_factory, "rollout_host", "rollout_kernel.cu",
                     _ROLLOUT_HOST)


@pytest.mark.parametrize("team", [1, 32])
def test_rollout_kernel_source_matches_jax(rollout_host, team):
    """The rollout kernels' step loop, run on the host by a team of 1 and
    of 32 threads on the reduced walk's B=3 problems at α=0.25, against the
    JAX lane rollout: xs_try, us_try, x_last and cost within 1e-10 of each
    output's max-abs, failure flags equal."""
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    alpha = 0.25
    seg, ins, _, ref = _rollout_case(alpha)
    port = to_port(seg)
    desc = ck.descriptor(port, torch.device("cpu"), torch.float64)
    x0, xs, us, k, K, fs = [t64(a).contiguous() for a in ins]
    T, B = us.shape[0], x0.shape[-1]
    out = dict(xs_try=torch.zeros(T, desc.nx, B, dtype=torch.float64),
               us_try=torch.zeros(T, desc.nu, B, dtype=torch.float64),
               x_last=torch.zeros(desc.nx, B, dtype=torch.float64),
               cost=torch.zeros(B, dtype=torch.float64),
               failed=torch.zeros(B, dtype=torch.uint8))

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())
    fn = rollout_host.rollout_host_f64
    fn.restype = ctypes.c_int
    rc = fn(team, T, B, desc.ws, ptr(desc.meta), ptr(desc.robot),
            ptr(desc.par), *[ptr(t) for t in (x0, xs, us, k, K, fs)],
            ctypes.c_double(alpha), *[ptr(t) for t in out.values()])
    assert rc == 0, "workspace size differs from the kernels' layout"
    np.testing.assert_array_equal(ref[-1], np_(out["failed"]).astype(bool))
    for name, a in zip(("xs_try", "us_try", "x_last", "cost"), ref[:-1]):
        assert max_rel(a, out[name]) < 1e-10, name


def test_scan_wrappers_take_plain_versions_on_cpu(riccati_case):
    from crocoddyl_tpu_torch.ops import cuda_kernels
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    _, (td, tterm), fs, B = riccati_case
    before = tfs.riccati_backward_lanes_plain.calls
    reg = torch.full((B,), 1e-9, dtype=torch.float64)
    tfs.riccati_backward_lanes(td, tterm, t64(fs), reg, reg)
    assert tfs.riccati_backward_lanes_plain.calls == before + 1
    assert cuda_kernels.riccati_backward.launches == 0
    assert cuda_kernels.trial_rollout.launches == 0


def test_b1_wrappers_take_plain_versions_on_cpu(riccati_case):
    """The single-problem wrappers send CPU tensors to their plain versions
    (kernels 4 and 5 never launch), and those equal the lane plain versions
    at B=1."""
    from crocoddyl_tpu_torch.ops import cuda_kernels
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    from crocoddyl_tpu_torch.utils.struct import tree_map
    _, (td, tterm), fs, _ = riccati_case
    one = tree_map(lambda a: a[..., 0].contiguous(), (td, tterm))
    reg = torch.full((1,), 1e-9, dtype=torch.float64)
    before = tfs.riccati_backward_fused_plain.calls
    out = tfs.riccati_backward_fused(*one, t64(fs[..., 0]), 1e-9, 1e-9)
    assert tfs.riccati_backward_fused_plain.calls == before + 1
    lane = tfs.riccati_backward_lanes_plain(
        *tree_map(lambda a: a[..., :1], (td, tterm)), t64(fs[..., :1]), reg,
        reg)
    for a, b in zip(lane, out):
        assert torch.equal(a[..., 0], b)
    prob = to_port(jax_walk_problem())
    T = prob.T
    x0 = prob.x0
    xs = x0[None].expand(T + 1, -1).contiguous()
    us = torch.zeros(T, prob.nu, dtype=torch.float64)
    before = tfs.trial_rollout_fused_plain.calls
    ro = tfs.trial_rollout_fused(prob.running, x0, xs, us, out[3], out[4],
                                 t64(fs[..., 0]), 0.5)
    assert tfs.trial_rollout_fused_plain.calls == before + 1
    assert ro[0].shape == (T, 37) and ro[3].shape == () and ro[4].dtype == \
        torch.bool
    assert cuda_kernels.riccati_backward_b1.launches == 0
    assert cuda_kernels.trial_rollout_b1.launches == 0
