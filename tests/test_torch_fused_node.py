"""Node linearization: the port's plain version of kernel 1
(``calc_both_lanes_plain``), and the per-node body of the CUDA kernel
compiled for the host and run on a team of 1 and of 32 lanes, vs the JAX
lane body (``calc_both_lanes(..., "jnp")``), float64 on CPU.

Tolerances: derivative fields within 1e-10 of each field's max-abs (both
sides run the same closed-form math; only summation order and libm differ),
xnext and cost within 1e-12 relative."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import jax_node_case, max_rel, np_, t64, to_port

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "crocoddyl_tpu_torch", "csrc")

# A host loop over the nodes around the CUDA kernel's per-node body: each
# node runs on a team of lanes with a shared buffer for sums and
# broadcasts, its workspace filled with NaN first; then the outputs are
# read off the workspace as the kernel's write pass does.  The lanes are
# fibers of one host thread (ucontext): a round runs each lane from its
# last sync() to its next, which is one phase between two barriers, the
# lanes in order on even nodes and in reverse on odd ones, so that a read
# that a missing sync leaves ahead of its writer shows, whichever lane
# writes.  Fibers, not threads: 32 threads meeting at every barrier took
# over a minute on a busy machine (a few tenths of a second alone).
_HOST_LOOP = """
#include <limits>
#include <ucontext.h>
#include <vector>

namespace {
struct Fibers {
  std::vector<ucontext_t> ctx;
  ucontext_t main;
  std::vector<int> done;
};

struct HostTeam {
  int l, n;
  Fibers* f;
  double* buf;
  int lane() const { return l; }
  int size() const { return n; }
  void sync() const { swapcontext(&f->ctx[l], &f->main); }
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

struct Job {
  const croc::Desc<double>* d;
  const double* kp;
  croc::Arr<double> W;
  Fibers* f;
  double* buf;
  int n;
};
Job* job;

void lane_main(int l) {
  croc::node_body(HostTeam{l, job->n, job->f, job->buf}, *job->d, job->kp,
                  job->W);
  job->f->done[l] = 1;
}
}  // namespace

// -1 if the workspace size differs from the kernel's layout, -2 if a lane
// ended while others waited at a sync
extern "C" int node_host_f64(
    int team, int N, int B, int ws, const int* meta, const double* robot,
    const double* par, const double* x, const double* u, double* Fx,
    double* Fu, double* Lx, double* Lu, double* Lxx, double* Lxu,
    double* Luu, double* xnext, double* cost) {
  const croc::Desc<double> d{meta, robot};
  const croc::Lay L(d);
  const croc::NodeLay G(d, L);
  if (G.size != ws) return -1;
  double* outs[croc::O_N] = {Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost};
  const int nx = d.nq() + d.nv(), nu = d.nu();
  std::vector<double> work(ws), buf(team);
  const croc::Arr<double> W{work.data(), 1};
  Fibers f;
  f.ctx.resize(team);
  f.done.resize(team);
  std::vector<std::vector<char>> stacks(team, std::vector<char>(1 << 20));
  for (int n = 0; n < N; ++n) {
    std::fill(work.begin(), work.end(),
              std::numeric_limits<double>::quiet_NaN());
    for (int i = 0; i < nx; ++i) work[L.x + i] = x[(long)i * N + n];
    for (int i = 0; i < nu; ++i) work[L.u + i] = u[(long)i * N + n];
    Job j{&d, par + (long)(n / B) * d.P(), W, &f, buf.data(), team};
    job = &j;
    for (int l = 0; l < team; ++l) {
      getcontext(&f.ctx[l]);
      f.ctx[l].uc_stack.ss_sp = stacks[l].data();
      f.ctx[l].uc_stack.ss_size = stacks[l].size();
      f.ctx[l].uc_link = &f.main;
      makecontext(&f.ctx[l], (void (*)())lane_main, 1, l);
      f.done[l] = 0;
    }
    for (;;) {
      for (int k = 0; k < team; ++k) {
        const int l = n % 2 ? team - 1 - k : k;
        if (!f.done[l]) swapcontext(&f.main, &f.ctx[l]);
      }
      int done = 0;
      for (int l = 0; l < team; ++l) done += f.done[l];
      if (done == team) break;
      if (done) return -2;
    }
    const double* kp = j.kp;
    for (int o = 0; o < croc::O_N; ++o) {
      int R, C;
      croc::node_out_shape(d, o, R, C);
      for (int r = 0; r < R; ++r)
        for (int c = 0; c < C; ++c)
          outs[o][(long)(r * C + c) * N + n] = croc::node_out(d, L, G, kp[d.m[croc::H_DT]], W, o, r, c);
    }
  }
  return 0;
}
"""

FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")


@pytest.fixture(scope="module")
def case():
    knots, xn, un, B, ref = jax_node_case()
    return to_port(knots), t64(xn.T), t64(un.T), B, ref


def test_plain_node_matches_jax(case):
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    seg, x, u, B, (d_ref, x_ref, c_ref) = case
    d, xnext, cost = tfn.calc_both_lanes(seg, x, u)
    for f in FIELDS:
        assert max_rel(getattr(d_ref, f), getattr(d, f)) < 1e-10, f
    assert max_rel(x_ref, xnext) < 1e-12
    assert max_rel(c_ref, cost) < 1e-12


def test_dt0_nodes_are_terminal(case):
    """dt=0 nodes give Fx = I and Fu = 0 exactly and xnext = x."""
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    seg, x, u, B, _ = case
    d, xnext, _ = tfn.calc_both_lanes(seg, x, u)
    term = slice(x.shape[-1] - B, x.shape[-1])
    Fx, Fu = np_(d.Fx)[..., term], np_(d.Fu)[..., term]
    np.testing.assert_array_equal(Fx, np.broadcast_to(
        np.eye(Fx.shape[0])[:, :, None], Fx.shape))
    np.testing.assert_array_equal(Fu, 0.0)
    np.testing.assert_array_equal(np_(xnext)[:, term], np_(x)[:, term])


def test_node_wrapper_takes_plain_version_on_cpu(case):
    """On CPU tensors the wrapper calls the plain version, never the
    kernel."""
    from crocoddyl_tpu_torch.ops import cuda_kernels
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    seg, x, u, _, _ = case
    before = tfn.calc_both_lanes_plain.calls
    tfn.calc_both_lanes(seg, x, u)
    assert tfn.calc_both_lanes_plain.calls == before + 1
    assert cuda_kernels.node_calc_both.launches == 0


def test_node_rejects_ragged_nodes(case):
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    seg, x, u, _, _ = case
    with pytest.raises(ValueError):
        tfn.calc_both_lanes(seg, x[:, 1:], u[:, 1:])


@pytest.mark.parametrize("knot", [1, -1])
def test_node_methods_match_lanes(case, knot):
    """RigidBodyNode.calc / calc_both on one knot and one (x, u) give that
    node's column of the lane linearization (running and dt=0 knots)."""
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    from crocoddyl_tpu_torch.utils.struct import tree_map
    seg, x, u, B, _ = case
    d, xnext, cost = tfn.calc_both_lanes(seg, x, u)
    K = seg.dt.shape[0]
    k = knot % K
    node = tree_map(lambda l: l[k], seg)
    n = k * B + 1
    d1, x1, c1 = node.calc_both(x[:, n], u[:, n])
    for f in FIELDS:
        assert max_rel(getattr(d, f)[..., n], getattr(d1, f)) < 1e-12, f
    assert max_rel(xnext[:, n], x1) < 1e-12
    assert max_rel(cost[n], c1) < 1e-12
    x2, c2 = node.calc(x[:, n], u[:, n])
    assert max_rel(xnext[:, n], x2) < 1e-12
    assert max_rel(cost[n], c2) < 1e-12


@pytest.fixture(scope="module")
def node_host(tmp_path_factory):
    """csrc/node_kernel.cu's per-node body (``node_body``, ``node_out``),
    built for the host by the C++ compiler that builds
    native/urdf_loader.cpp, with a team of fibers."""
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "a C++ compiler is needed (it also builds the URDF parser)"
    d = tmp_path_factory.mktemp("node_host")
    src, so = d / "node_host.cpp", d / "libnode_host.so"
    src.write_text(f'#include "{CSRC}/node_kernel.cu"\n' + _HOST_LOOP)
    res = subprocess.run([cxx, "-O1", "-std=c++20", "-pthread", "-shared",
                          "-fPIC", "-o", str(so), str(src)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    return ctypes.CDLL(str(so))


@pytest.mark.parametrize("team", [1, 32])
def test_node_kernel_source_matches_jax(case, node_host, team):
    """The CUDA node kernel's math (descriptor, team primal, closed-form
    tangents over the lanes, Gauss-Newton by cost term, chain rule and the
    write pass's output mapping), run on the host by a team of 1 and of 32
    lanes over the same nodes, against the JAX lane code; dt=0 nodes give
    Fx = I and Fu = 0 exactly.  Also checks the workspace size against the
    C++ layout, and that every lane reaches every sync."""
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    seg, x, u, B, (d_ref, x_ref, c_ref) = case
    x, u = x.contiguous(), u.contiguous()
    desc = ck.descriptor(seg, torch.device("cpu"), torch.float64)
    N, ndx, nu = x.shape[-1], desc.ndx, desc.nu

    def e(*s):
        return torch.zeros(s + (N,), dtype=torch.float64)
    out = dict(Fx=e(ndx, ndx), Fu=e(ndx, nu), Lx=e(ndx), Lu=e(nu),
               Lxx=e(ndx, ndx), Lxu=e(ndx, nu), Luu=e(nu, nu),
               xnext=e(desc.nx), cost=e())

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())
    fn = node_host.node_host_f64
    fn.restype = ctypes.c_int
    rc = fn(team, N, B, desc.node_ws, ptr(desc.meta), ptr(desc.robot),
            ptr(desc.par), ptr(x), ptr(u), *[ptr(t) for t in out.values()])
    assert rc == 0, {-1: "workspace size differs from the kernel's layout",
                     -2: "a lane ended while others waited at a sync"}[rc]
    for f in FIELDS:
        assert max_rel(getattr(d_ref, f), out[f]) < 1e-10, f
    assert max_rel(x_ref, out["xnext"]) < 1e-12
    assert max_rel(c_ref, out["cost"]) < 1e-12
    term = slice(N - B, N)
    np.testing.assert_array_equal(np_(out["Fx"])[..., term], np.broadcast_to(
        np.eye(ndx)[:, :, None], (ndx, ndx, B)))
    np.testing.assert_array_equal(np_(out["Fu"])[..., term], 0.0)
