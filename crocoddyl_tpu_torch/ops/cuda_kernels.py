"""Build, bind and launch the CUDA kernels of the port.

``csrc/*.cu`` are compiled at first use, one ``nvcc -gencode
arch=compute_90a,code=sm_90a -c`` per source, all started together, and
linked into one shared library with a plain C interface
(``crocoddyl_tpu_torch/build/kernels/``), loaded with ctypes; a file lock
keeps processes from building at once.  Nothing here touches nvcc or the
library at import time.

Kernels: node linearization (``node_calc_both``), the batched Riccati pass
(``riccati_backward``) and trial rollout (``trial_rollout``) of the batch
lane, and the single-problem Riccati pass (``riccati_backward_b1``) and
trial rollout (``trial_rollout_b1``) of the b=1 lane.

Each kernel is a ``torch.library`` custom op of the namespace
``crocoddyl_tpu_torch`` (``torch.ops.crocoddyl_tpu_torch.<name>``), whose
arguments are tensors and ints only, with a fake implementation giving its
outputs' shapes and dtypes: ``torch.export`` records one node per launch,
and the exported program carries the node and rollout kernels' descriptor
(``meta``, ``robot``, ``par``: built once per stacked segment from the
dataclasses, see ``descriptor``; layout mirrored in csrc/node_math.cuh).
The scalars a solve decides (the step length α of kernels 3 and 5, the
regularization of kernels 2 and 4) are tensors on the device, which the
kernels read there.  The CUDA implementation checks device, dtype, shape
and contiguity, allocates its outputs with ``torch.empty``, launches on
the current CUDA stream, raises if the launch reports an error, and adds
one to the ``launches`` count of its wrapper (the functions of the same
name here, which take the port's dataclasses).  The Riccati ops' CPU
implementation is their plain version (registered by ops/fused_scans.py);
the node and rollout ops have none: on the CPU their callers take the plain
versions, which read the dataclasses themselves.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np
import torch

from ..core.solvers import control
from ..dynamics.algorithms import _tree_meta
from ..dynamics.model import JointType

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib = None
_build_log = ""


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit with sm_90a support")
    return nvcc


def build(verbose: bool = False) -> float:
    """Compile (if needed) and load the kernel library; returns the seconds
    spent.  ``verbose`` adds ``-Xptxas -v`` (registers, spills) to the
    compile; its output is kept in :func:`build_log`."""
    global _lib, _build_log
    t0 = time.perf_counter()
    with _lock:
        if _lib is not None:
            return 0.0
        h = hashlib.sha256()
        for src in _sources():
            with open(src, "rb") as f:
                h.update(f.read())
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libcroc_kernels_{h.hexdigest()[:16]}.so")
        # one build at a time across processes (the ranks of
        # parallel/mesh.py): a second process waits, then loads the first's
        with open(os.path.join(BUILD_DIR, "build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.exists(so):
                _build_log = _compile(so, verbose)
        lib = ctypes.CDLL(so)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for t in ("f32", "f64"):
            fn = getattr(lib, f"croc_riccati_{t}")
            fn.argtypes = [I, I, I, I] + [P] * 20 + [P]
            fn.restype = I
            fn = getattr(lib, f"croc_node_{t}")
            fn.argtypes = [I] * 5 + [P] * 14 + [P]
            fn.restype = I
            fn = getattr(lib, f"croc_node_{t}_shape")
            fn.argtypes = [I] * 4 + [P]
            fn.restype = I
            fn = getattr(lib, f"croc_rollout_{t}")
            fn.argtypes = [I] * 6 + [P] * 15 + [P]
            fn.restype = I
            fn = getattr(lib, f"croc_rollout_{t}_shape")
            fn.argtypes = [I] * 5 + [P]
            fn.restype = None
            fn = getattr(lib, f"croc_riccati_b1_{t}")
            fn.argtypes = [I] * 4 + [P] * 19 + [P]
            fn.restype = I
            fn = getattr(lib, f"croc_rollout_b1_{t}")
            fn.argtypes = [I] * 9 + [L, L] + [P] * 15 + [P]
            fn.restype = I
        lib.croc_riccati_shape.argtypes = [I] * 4 + [P]
        lib.croc_riccati_shape.restype = None
        lib.croc_riccati_b1_shape.argtypes = [I] * 3 + [P]
        lib.croc_riccati_b1_shape.restype = None
        _lib = lib
    return time.perf_counter() - t0


def _compile(so, verbose):
    """One ``nvcc -c`` per source, all running at once, then one link into
    ``so``; returns the compilers' output."""
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        flags = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        cus = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in cus]
        procs = [subprocess.Popen(flags + ["-c", "-o", o, s],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(cus, objs)]
        log, failed = "", []
        for s, proc in zip(cus, procs):
            out = proc.communicate()[0]
            log += f"== {os.path.basename(s)}\n{out}"
            if proc.returncode != 0:
                failed.append(os.path.basename(s))
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = os.path.join(tmpdir, "lib.so")
        res = subprocess.run([_nvcc()] + NVCC_FLAGS[:2] + ["-shared", "-o",
                                                            tmp] + objs,
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + log)
        os.replace(tmp, so)
        return log
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def build_log() -> str:
    return _build_log


def _fn(name, dtype, suffix=""):
    build()
    t = "f64" if dtype == torch.float64 else "f32"
    return getattr(_lib, f"{name}_{t}{suffix}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _launch(name, dtype, device, *args):
    """Call C launcher ``name`` on ``device`` and its current stream (the
    stream goes last); raise if the launch reports a CUDA error."""
    fn = _fn(name, dtype)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _check(name, tensors, dtype, device, shapes=None, strided=()):
    """Device, dtype, shape and contiguity of the inputs; the keys in
    ``strided`` may be strided views (see :func:`_lane_strides`)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {dtype}")
    for key, t in tensors.items():
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} is {t.dtype}, not {dtype}")
        if key not in strided and not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
        if shapes is not None and key in shapes and \
                tuple(t.shape) != tuple(shapes[key]):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[key])}")


def _lane_strides(name, key, a, timed):
    """(time stride, element stride) of ``a``, laid out ([T,] elems..., B):
    the lane axis must be unit-stride and the element axes must collapse
    into one axis of uniform stride (a contiguous tensor, or a (T, ..., B)
    view of a node-layout (..., (T+1)·B) tensor)."""
    sh, st = a.shape, a.stride()
    lead = 1 if timed else 0
    ok = st[-1] == 1
    for k in range(lead, a.dim() - 2):
        ok = ok and st[k] == st[k + 1] * sh[k + 1]
    if not ok:
        raise ValueError(f"{name}: {key} has strides {st}, which do not "
                         "collapse to (time, element, lane)")
    return (st[0] if timed else 0), st[-2]


def _custom_op(name, impl, schema):
    """The op ``crocoddyl_tpu_torch::<name>`` with ``impl`` as its CUDA
    implementation."""
    return torch.library.custom_op(f"crocoddyl_tpu_torch::{name}", impl,
                                   mutates_args=(), device_types="cuda",
                                   schema=schema)


# ---------------------------------------------------------------------------
# Kernel 2: Riccati backward pass
# ---------------------------------------------------------------------------

# csrc/riccati_pass.cuh: Quu's rows sit in registers (kRiccatiMaxNu) and one
# lane solves two right-hand-side columns
RICCATI_MAX_NU, RICCATI_MAX_NDX = 16, 63


def _riccati_dims(name, ndx, nu):
    if nu > RICCATI_MAX_NU or ndx > RICCATI_MAX_NDX:
        raise ValueError(f"{name}: the kernel takes nu <= {RICCATI_MAX_NU} "
                         f"and ndx <= {RICCATI_MAX_NDX}, got {nu}, {ndx}")


def riccati_backward_op(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, xreg,
                        ureg):
    """Kernel 2's CUDA implementation (the op ``riccati_backward``): the
    leaves of derivs_l and dterm_l, fs_l, and xreg/ureg (B,) on the
    device."""
    T, ndx = Fx.shape[0], fs.shape[1]
    nu, B = Lu.shape[1], fs.shape[-1]
    dt, dev = fs.dtype, fs.device
    _riccati_dims("riccati_backward", ndx, nu)
    ins = dict(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu, Luu=Luu,
               LxT=LxT, LxxT=LxxT, fs=fs, xreg=xreg, ureg=ureg)
    strided = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu", "LxT", "LxxT",
               "fs")
    _check("riccati_backward", ins, dt, dev, dict(
        Fx=(T, ndx, ndx, B), Fu=(T, ndx, nu, B), Lx=(T, ndx, B),
        Lu=(T, nu, B), Lxx=(T, ndx, ndx, B), Lxu=(T, ndx, nu, B),
        Luu=(T, nu, nu, B), LxT=(ndx, B), LxxT=(ndx, ndx, B),
        fs=(T + 1, ndx, B), xreg=(B,), ureg=(B,)), strided)
    strides = np.array([s for key in strided for s in _lane_strides(
        "riccati_backward", key, ins[key], key not in ("LxT", "LxxT"))],
        dtype=np.int64)
    Vx, Vxx, Qu, k, K, Quuk, failed = riccati_outs(T, ndx, nu, (B,), fs,
                                                    torch.uint8)
    _launch("croc_riccati", dt, dev,
            T, B, ndx, nu, strides.ctypes.data_as(ctypes.c_void_p),
            *[_ptr(t) for t in ins.values()],
            *[_ptr(t) for t in (Vx, Vxx, Qu, k, K, Quuk, failed)])
    riccati_backward.launches += 1
    return Vx, Vxx, Qu, k, K, Quuk, failed.bool()


def riccati_outs(T, ndx, nu, lane, like, flag=torch.bool, lead=()):
    """Empty (Vx, Vxx, Qu, k, K, Quuk, failed) of a Riccati pass, with the
    trailing lane axes ``lane`` ((B,) or ()) or the leading problem axes
    ``lead`` ((P,) or ())."""
    def e(*s):
        return like.new_empty(lead + s + lane)
    return (e(T + 1, ndx), e(T + 1, ndx, ndx), e(T, nu), e(T, nu),
            e(T, nu, ndx), e(T, nu), like.new_empty(lead + lane, dtype=flag))


RICCATI_SCHEMA = ("(Tensor Fx, Tensor Fu, Tensor Lx, Tensor Lu, Tensor Lxx, "
                   "Tensor Lxu, Tensor Luu, Tensor LxT, Tensor LxxT, "
                   "Tensor fs, Tensor xreg, Tensor ureg) -> (" + ", ".join(
                       ["Tensor"] * 7) + ")")
_op_riccati = _custom_op("riccati_backward", riccati_backward_op,
                         RICCATI_SCHEMA)


@_op_riccati.register_fake
def _(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, xreg, ureg):
    return riccati_outs(Fx.shape[0], fs.shape[1], Lu.shape[1],
                         (fs.shape[-1],), fs)


def riccati_args(derivs, dterm, fs):
    """The Riccati ops' tensor arguments before xreg and ureg."""
    d = derivs
    return (d.Fx, d.Fu, d.Lx, d.Lu, d.Lxx, d.Lxu, d.Luu, dterm.Lx, dterm.Lxx,
            fs)


def riccati_trees(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT):
    """(derivs, dterm) of the Riccati ops' arguments (``riccati_args``'
    inverse, fs left out)."""
    from ..core.action import NodeDerivs
    return (NodeDerivs(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu,
                       Luu=Luu),
            NodeDerivs(Fx=None, Fu=None, Lx=LxT, Lu=None, Lxx=LxxT, Lxu=None,
                       Luu=None))


def _on_card(name, t):
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one "
                         f"on {t.device}")


def riccati_backward(derivs_l, dterm_l, fs_l, xreg, ureg):
    """CUDA twin of fused_scans.riccati_backward_lanes_plain, through the op
    ``torch.ops.crocoddyl_tpu_torch.riccati_backward``."""
    _riccati_dims("riccati_backward", fs_l.shape[1], derivs_l.Lu.shape[1])
    _on_card("riccati_backward", fs_l)
    return torch.ops.crocoddyl_tpu_torch.riccati_backward(
        *riccati_args(derivs_l, dterm_l, fs_l), xreg, ureg)


riccati_backward.launches = 0


# ---------------------------------------------------------------------------
# The node descriptor (layout mirrored in csrc/node_math.cuh)
# ---------------------------------------------------------------------------

_COST_TYPES = ("CostState", "CostControl", "CostCoM", "CostFrameTranslation",
               "CostFrameVelocity", "CostContactFrictionCone",
               "CostContactForce")
_ACT_TYPES = ("ActivationQuad", "ActivationWeightedQuad",
              "ActivationQuadraticBarrier",
              "ActivationWeightedQuadraticBarrier")
_HEADER = 16


def primal_scratch_elems(nj, nv, nq, nu, nc, nr):
    """Elements of the scratch scalar per node of node_math.cuh's Lay."""
    nx = nq + nv
    return (nx + nu + 42 * nj + 6 * nv + nv * nv + nv + nc * nv + nc
            + nv * (nc + 1) + nc * nc + nc + nv + 2 * nv + nx + nr
            + 6 * nj * nv + 6 * nj + 4 * nc)


def rollout_workspace_elems(prim, nx, nu, ndx):
    """Elements per problem of a rollout team's workspace
    (csrc/rollout_step.cuh): the primal's Lay, F and DX, and two buffers of
    one step's rows (xs, us, k, K, fs)."""
    return prim + 2 * ndx + 2 * (nx + 2 * nu + nu * ndx + ndx)


def _depths(parents):
    """Depth of each joint in the tree (the root is 0)."""
    depth = []
    for p in parents:
        depth.append(0 if p < 0 else depth[p] + 1)
    return depth


# rows of one dense cost block of the node kernel's Gauss-Newton phase
NODE_JB_ROWS = 8


def node_workspace_elems(nj, nv, nq, nu, nc, nr):
    """Elements per node of node_kernel.cu's NodeLay: the primal's Lay, with
    the tangent blocks over its last part (FI, FW, YI)."""
    nd = 2 * nv + nu
    prim = primal_scratch_elems(nj, nv, nq, nu, nc, nr)
    tan = (66 * nj + 30 * nv + (nv + nc + NODE_JB_ROWS) * nd + 2 * nr
           + nd * (nd + 1) // 2 + nd + 73)
    return max(prim, prim - (6 * nj * nv + 6 * nj + 4 * nc) + tan)


class _Descriptor:
    """meta (int32), robot (T) and packed knot parameters (K, P) on the
    device, plus the dims the wrappers need."""

    def __init__(self, seg, device, dtype):
        from ..models.multibody.actuations import FullActuation
        from ..models.multibody.costs import cost_nr
        from ..ops.fused_node import supports
        if not supports(seg):
            raise ValueError("node structure not covered by the kernels")
        st = seg.state_
        m = st.model
        nj, nv, nq = m.njoints, m.nv, m.nq
        ndx, nu = 2 * nv, seg.actuation.nu
        K = seg.dt.shape[0]
        cols = []
        width = [0]

        def add(leaf):
            if leaf is None:
                return -1
            a = leaf.reshape(K, -1)
            cols.append(a)
            width[0] += a.shape[1]
            return width[0] - a.shape[1]

        dt_off = add(seg.dt)
        arm_off = add(seg.armature)
        contacts = tuple(seg.contacts.contacts) if seg.contacts is not None \
            else ()
        con_ints = []
        for c in contacts:
            con_ints += [c.fid, add(c.pref), add(c.gains), add(c.active)]
        cost_ints, row, dense = [], 0, 0
        for ci in seg.costs.items:
            ctype = _COST_TYPES.index(type(ci).__name__)
            act = ci.activation
            ref = {0: "xref", 1: "uref", 2: "cref", 3: "pref", 4: "vref",
                   6: "fref"}.get(ctype)
            ref_off = add(ci.cone.A if ctype == 5 else getattr(ci, ref))
            idx = getattr(ci, "fid", getattr(ci, "contact_idx", 0))
            nr = cost_nr(ci, st)
            if ctype > 1:
                dense = max(dense, nr)
            cost_ints += [ctype, _ACT_TYPES.index(type(act).__name__), idx,
                          add(ci.weight), add(ci.active), ref_off,
                          add(getattr(act, "weights", None)),
                          add(getattr(act, "lb", None)),
                          add(getattr(act, "ub", None)), nr, row, 0]
            row += nr
        _, v_off, _, amask, dof_joint, _, _, _ = _tree_meta(
            tuple(m.parents), tuple(m.joint_types), tuple(m.frame_parents))
        nc = 3 * len(contacts)
        depth = _depths([int(p) for p in m.parents])
        header = [nj, nv, nq, int(JointType(m.joint_types[0])
                                  == JointType.FREE_FLYER),
                  len(m.frame_parents), len(contacts), len(seg.costs.items),
                  width[0], nu, int(isinstance(seg.actuation, FullActuation)),
                  dt_off, arm_off, row, nc, max(depth) + 1, 0]
        assert len(header) == _HEADER
        joints = []
        for j in range(nj):
            joints += [int(m.joint_types[j]), int(m.parents[j]),
                       int(v_off[j]), 0]
        meta = (header + joints + amask.astype(int).reshape(-1).tolist()
                + list(m.frame_parents) + con_ints + cost_ints
                + [int(j) for j in dof_joint] + depth)
        r = [m.jp_R, m.jp_p, m.axis, m.mass, m.com, m.inertia, m.fp_R,
             m.fp_p, m.gravity]
        robot = torch.cat([a[0].reshape(-1).to(torch.float64) for a in r]
                          + [torch.tensor([float(seg.kkt_damping)],
                                          dtype=torch.float64,
                                          device=seg.dt.device)])
        self.meta = torch.tensor(meta, dtype=torch.int32, device=device)
        self.robot = robot.to(device=device, dtype=dtype).contiguous()
        self.par = torch.cat([c.to(dtype) for c in cols], 1).to(
            device).contiguous()
        self.K, self.nx, self.ndx, self.nu, self.nr = K, nq + nv, ndx, nu, row
        self.prim = primal_scratch_elems(nj, nv, nq, nu, nc, row)
        self.ws = rollout_workspace_elems(self.prim, nq + nv, nu, ndx)
        self.nmeta, self.nrobot, self.P = len(meta), robot.numel(), width[0]
        self.node_ws = node_workspace_elems(nj, nv, nq, nu, nc, row)
        if ndx + nu > 64 or dense > NODE_JB_ROWS:
            raise ValueError("the node kernel takes ndx + nu <= 64 and at "
                             f"most {NODE_JB_ROWS} rows a cost term (other "
                             "than state and control)")


_DESC = collections.OrderedDict()


def descriptor(seg, device, dtype) -> _Descriptor:
    """The descriptor of ``seg`` on (device, dtype), built once and kept for
    the last few segments (the key holds a reference to ``seg``, so its id
    cannot be reused while cached).  Under ``torch.export`` a cached
    descriptor is read as it is, and a new one is kept for that export only
    (``control.cached``), so no traced tensor stays in the cache."""
    key = (id(seg), str(device), dtype)
    hit = _DESC.get(key)
    if hit is not None and hit[0] is seg:
        if not control.exporting():
            _DESC.move_to_end(key)
        return hit[1]
    if control.exporting():
        return control.cached(seg, ("descriptor", str(device), dtype),
                              lambda: _Descriptor(seg, device, dtype))
    desc = _Descriptor(seg, device, dtype)
    _DESC[key] = (seg, desc)
    while len(_DESC) > 8:
        _DESC.popitem(last=False)
    return desc


# ---------------------------------------------------------------------------
# Kernel 1: node linearization
# ---------------------------------------------------------------------------

def node_calc_both_op(meta, robot, par, x, u, ndx, node_ws, leaves, spec):
    """Kernel 1's CUDA implementation (the op ``node_calc_both``): the
    descriptor's tensors, x (nx, N), u (nu, N), and the descriptor's ndx
    and workspace size.  ``leaves``/``spec`` (the stack as
    ``utils/struct.flat_spec`` gives it) are the CPU implementation's."""
    dt, dev = x.dtype, x.device
    N, K = x.shape[-1], par.shape[0]
    if N % K:
        raise ValueError(f"{N} nodes do not split into {K} knots")
    _check("node_calc_both", dict(x=x, u=u, robot=robot, par=par), dt, dev,
           dict(u=(u.shape[0], N)))
    Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost = _node_outs(x, u.shape[0],
                                                            ndx)
    _launch("croc_node", dt, dev,
            N, N // K, meta.numel(), robot.numel(), node_ws, _ptr(meta),
            _ptr(robot), _ptr(par), _ptr(x), _ptr(u),
            *[_ptr(t) for t in (Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost)])
    node_calc_both.launches += 1
    return Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost


def _node_outs(x, nu, ndx):
    N = x.shape[-1]

    def e(*s):
        return x.new_empty(s + (N,))
    return (e(ndx, ndx), e(ndx, nu), e(ndx), e(nu), e(ndx, ndx), e(ndx, nu),
            e(nu, nu), e(x.shape[0]), e())


_op_node = _custom_op(
    "node_calc_both", node_calc_both_op,
    "(Tensor? meta, Tensor? robot, Tensor? par, Tensor x, Tensor u, int ndx, "
    "int node_ws, Tensor[] leaves, str spec) -> ("
    + ", ".join(["Tensor"] * 9) + ")")


@_op_node.register_fake
def _(meta, robot, par, x, u, ndx, node_ws, leaves, spec):
    return _node_outs(x, u.shape[0], ndx)


def node_calc_both(seg, x_l, u_l):
    """CUDA twin of fused_node.calc_both_lanes_plain, through the op
    ``torch.ops.crocoddyl_tpu_torch.node_calc_both``."""
    from ..core.action import NodeDerivs
    _on_card("node_calc_both", x_l)
    desc = descriptor(seg, x_l.device, x_l.dtype)
    if x_l.shape[0] != desc.nx:
        raise ValueError(f"node_calc_both: x has {x_l.shape[0]} rows, the "
                         f"model {desc.nx}")
    Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, xnext, cost = \
        torch.ops.crocoddyl_tpu_torch.node_calc_both(
            desc.meta, desc.robot, desc.par, x_l, u_l, desc.ndx,
            desc.node_ws, [], "")
    return (NodeDerivs(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu,
                       Luu=Luu), xnext, cost)


node_calc_both.launches = 0


def node_launch_shape(seg, N, dtype, device=None):
    """(CTAs, threads per CTA, nodes per CTA, dynamic shared memory bytes)
    of kernel 1's launch over N nodes on ``device``'s card, from the
    launcher itself (builds the library)."""
    desc = descriptor(seg, torch.device("cpu"), dtype)
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(device):
        err = _fn("croc_node", dtype, "_shape")(N, desc.nmeta, desc.nrobot,
                                                desc.node_ws, out)
    if err != 0:
        raise RuntimeError(f"croc_node_shape: CUDA error {err}")
    return tuple(out)


def riccati_launch_shape(B, ndx, nu, dtype):
    """(CTAs, threads per CTA, dynamic shared memory bytes) of kernel 2's
    launch at B problems and of kernel 4's launch, from the launchers."""
    build()
    elem = torch.tensor([], dtype=dtype).element_size()
    k2, k4 = (ctypes.c_int * 3)(), (ctypes.c_int * 3)()
    _lib.croc_riccati_shape(B, ndx, nu, elem, k2)
    _lib.croc_riccati_b1_shape(ndx, nu, elem, k4)
    return tuple(k2), tuple(k4)


# ---------------------------------------------------------------------------
# Kernel 3: trial rollout
# ---------------------------------------------------------------------------

def _rollout_outs(x0, T, nu, flag=torch.bool):
    """Empty (xs_try, us_try, x_last, cost, failed) of a rollout, with the
    lane axes of x0 ((nx, B) or (nx,))."""
    lane = tuple(x0.shape[1:])

    def e(*s):
        return x0.new_empty(s + lane)
    return (e(T, x0.shape[0]), e(T, nu), e(x0.shape[0]), e(),
            x0.new_empty(lane, dtype=flag))


def _rollout_launch(name, meta, robot, par, x0, xs, us, k, K, fs, alpha, ws):
    """Check and launch kernel 3 (``croc_rollout``, problems on lanes);
    returns its outputs."""
    dt, dev = x0.dtype, x0.device
    T, nx, nu, ndx = us.shape[0], x0.shape[0], us.shape[1], fs.shape[1]
    lane = tuple(x0.shape[1:])
    if T != par.shape[0]:
        raise ValueError(f"{T} steps for {par.shape[0]} knots")
    _check(name, dict(x0=x0, xs=xs, us=us, k=k, K=K, fs=fs, alpha=alpha,
                      robot=robot, par=par), dt, dev,
           dict(xs=(T, nx) + lane, us=(T, nu) + lane, k=(T, nu) + lane,
                K=(T, nu, ndx) + lane, fs=(T, ndx) + lane, alpha=()))
    xs_try, us_try, x_last, cost, failed = _rollout_outs(x0, T, nu,
                                                         torch.uint8)
    dims = (T,) + lane + (meta.numel(), robot.numel(), par.shape[1], ws)
    _launch(name, dt, dev, *dims, _ptr(meta), _ptr(robot), _ptr(par),
            *[_ptr(t) for t in (x0, xs, us, k, K, fs, alpha, xs_try, us_try,
                                x_last, cost, failed)])
    return xs_try, us_try, x_last, cost, failed.bool()


_ROLLOUT_SCHEMA = ("(Tensor? meta, Tensor? robot, Tensor? par, Tensor x0, "
                   "Tensor xs, Tensor us, Tensor k, Tensor K, Tensor fs, "
                   "Tensor alpha, int ws, Tensor[] leaves, str spec) -> ("
                   + ", ".join(["Tensor"] * 5) + ")")


def trial_rollout_op(meta, robot, par, x0, xs, us, k, K, fs, alpha, ws,
                     leaves, spec):
    """Kernel 3's CUDA implementation (the op ``trial_rollout``): the
    descriptor's tensors, the lane-layout rows, α a 0-d tensor; ``leaves``
    and ``spec`` are the CPU implementation's."""
    out = _rollout_launch("croc_rollout", meta, robot, par, x0, xs, us, k, K,
                          fs, alpha, ws)
    trial_rollout.launches += 1
    return out


_op_rollout = _custom_op("trial_rollout", trial_rollout_op, _ROLLOUT_SCHEMA)


@_op_rollout.register_fake
def _(meta, robot, par, x0, xs, us, k, K, fs, alpha, ws, leaves, spec):
    return _rollout_outs(x0, us.shape[0], us.shape[1])


def as_scalar(v, like, shape=()):
    """``v`` (a float or a tensor) as a 0-d tensor of like's dtype on its
    device, or as one per problem (``shape`` (P,))."""
    return torch.as_tensor(v, dtype=like.dtype, device=like.device).reshape(
        shape)


def trial_rollout(seg, x0_l, xs_l, us_l, k_l, K_l, fs_l, alpha):
    """CUDA twin of fused_scans.trial_rollout_lanes_plain, through the op
    ``torch.ops.crocoddyl_tpu_torch.trial_rollout``; α a float or a 0-d
    tensor."""
    _on_card("trial_rollout", x0_l)
    desc = descriptor(seg, x0_l.device, x0_l.dtype)
    return torch.ops.crocoddyl_tpu_torch.trial_rollout(
        desc.meta, desc.robot, desc.par, x0_l, xs_l, us_l, k_l, K_l, fs_l,
        as_scalar(alpha, x0_l), desc.ws, [], "")


trial_rollout.launches = 0


def rollout_launch_shape(seg, B, dtype):
    """(CTAs, threads per CTA, dynamic shared memory bytes) of kernel 3's
    launch at B problems, from the launcher itself (builds the library)."""
    desc = descriptor(seg, torch.device("cpu"), dtype)
    out = (ctypes.c_int * 3)()
    _fn("croc_rollout", dtype, "_shape")(B, desc.nmeta, desc.nrobot, desc.P,
                                        desc.ws, out)
    return tuple(out)


# ---------------------------------------------------------------------------
# Kernel 4: single-problem Riccati backward pass
# ---------------------------------------------------------------------------

def riccati_backward_b1_op(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs,
                           xreg, ureg):
    """Kernel 4's CUDA implementation (the op ``riccati_backward_b1``):
    contiguous single-problem inputs, xreg and ureg 0-d tensors that the
    kernel reads on the device; or P problems, every input with a leading
    problem axis and xreg/ureg (P,): one launch of P CTAs, one problem
    each."""
    lead = tuple(xreg.shape)
    T, ndx = Fx.shape[len(lead)], fs.shape[-1]
    nu = Lu.shape[-1]
    dt, dev = fs.dtype, fs.device
    _riccati_dims("riccati_backward_b1", ndx, nu)
    ins = dict(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu, Luu=Luu,
               LxT=LxT, LxxT=LxxT, fs=fs, xreg=xreg, ureg=ureg)
    _check("riccati_backward_b1", ins, dt, dev, {k: lead + v for k, v in dict(
        Fx=(T, ndx, ndx), Fu=(T, ndx, nu), Lx=(T, ndx), Lu=(T, nu),
        Lxx=(T, ndx, ndx), Lxu=(T, ndx, nu), Luu=(T, nu, nu), LxT=(ndx,),
        LxxT=(ndx, ndx), fs=(T + 1, ndx), xreg=(), ureg=()).items()})
    Vx, Vxx, Qu, k, K, Quuk, failed = riccati_outs(T, ndx, nu, (), fs,
                                                    torch.uint8, lead)
    _launch("croc_riccati_b1", dt, dev, int(np.prod(lead)), T, ndx, nu,
            *[_ptr(t) for t in ins.values()],
            *[_ptr(t) for t in (Vx, Vxx, Qu, k, K, Quuk, failed)])
    riccati_backward_b1.launches += 1
    return Vx, Vxx, Qu, k, K, Quuk, failed.bool()


_op_riccati_b1 = _custom_op("riccati_backward_b1", riccati_backward_b1_op,
                            RICCATI_SCHEMA)


@_op_riccati_b1.register_fake
def _(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, xreg, ureg):
    return riccati_outs(Fx.shape[xreg.dim()], fs.shape[-1], Lu.shape[-1], (),
                        fs, lead=tuple(xreg.shape))


def riccati_backward_b1(derivs, dterm, fs, xreg, ureg):
    """CUDA twin of fused_scans.riccati_backward_fused_plain, through the op
    ``torch.ops.crocoddyl_tpu_torch.riccati_backward_b1``: derivs leaves
    (T, ...), dterm Lx (ndx,) / Lxx (ndx, ndx), fs (T+1, ndx); xreg and
    ureg floats or 0-d tensors, read by the kernel on the device.  Over P
    problems every tensor carries a leading problem axis, xreg/ureg
    (P,)."""
    _riccati_dims("riccati_backward_b1", fs.shape[-1], derivs.Lu.shape[-1])
    _on_card("riccati_backward_b1", fs)
    lead = fs.shape[:-2]
    return torch.ops.crocoddyl_tpu_torch.riccati_backward_b1(
        *riccati_args(derivs, dterm, fs), as_scalar(xreg, fs, lead),
        as_scalar(ureg, fs, lead))


riccati_backward_b1.launches = 0


# ---------------------------------------------------------------------------
# Kernel 5: single-problem trial rollout
# ---------------------------------------------------------------------------

def _problem_stride(name, key, a, lead):
    """The stride between a's problems: its trailing (T, n) block must be
    contiguous (the prefix ``[:, :T]`` of a contiguous (P, T+1, n) tensor
    is)."""
    if a.stride()[len(lead):] != (a.shape[-1], 1):
        raise ValueError(f"{name}: {key} has strides {a.stride()}; its "
                         "steps must be contiguous rows")
    return a.stride(0) if lead else 0


def trial_rollout_b1_op(meta, robot, par, x0, xs, us, k, K, fs, alpha, ws,
                        leaves, spec):
    """Kernel 5's CUDA implementation (the op ``trial_rollout_b1``): the
    descriptor's tensors, x0 (nx,), xs (T, nx), us/k (T, nu), K (T, nu,
    ndx), fs (T, ndx), all contiguous; α a 0-d tensor; ``leaves`` and
    ``spec`` are the CPU implementation's.  Over P problems every array
    has a leading problem axis (xs and fs may be the (P, T, ...) prefixes
    of (P, T+1, ...) tensors), α is (P,) and ``par`` holds the P·T knots
    problem by problem: one launch of P CTAs, one problem each."""
    name = "trial_rollout_b1"
    dt, dev = x0.dtype, x0.device
    lead = tuple(x0.shape[:-1])
    T, nx, nu, ndx = us.shape[-2], x0.shape[-1], us.shape[-1], fs.shape[-1]
    P = int(np.prod(lead))
    if P * T != par.shape[0]:
        raise ValueError(f"{P} x {T} steps for {par.shape[0]} knots")
    _check(name, dict(x0=x0, xs=xs, us=us, k=k, K=K, fs=fs, alpha=alpha,
                      robot=robot, par=par), dt, dev,
           {key: lead + v for key, v in dict(
               xs=(T, nx), us=(T, nu), k=(T, nu), K=(T, nu, ndx),
               fs=(T, ndx), alpha=()).items()}, strided=("xs", "fs"))
    xs_ps = _problem_stride(name, "xs", xs, lead)
    fs_ps = _problem_stride(name, "fs", fs, lead)
    xs_try, us_try, x_last, cost, failed = (
        x0.new_empty(lead + (T, nx)), x0.new_empty(lead + (T, nu)),
        x0.new_empty(lead + (nx,)), x0.new_empty(lead),
        x0.new_empty(lead, dtype=torch.uint8))
    _launch("croc_rollout_b1", dt, dev, P, T, meta.numel(), robot.numel(),
            par.shape[1], ws, nx, nu, ndx, xs_ps, fs_ps, _ptr(meta),
            _ptr(robot), _ptr(par),
            *[_ptr(t) for t in (x0, xs, us, k, K, fs, alpha, xs_try, us_try,
                                x_last, cost, failed)])
    trial_rollout_b1.launches += 1
    return xs_try, us_try, x_last, cost, failed.bool()


_op_rollout_b1 = _custom_op("trial_rollout_b1", trial_rollout_b1_op,
                            _ROLLOUT_SCHEMA)


@_op_rollout_b1.register_fake
def _(meta, robot, par, x0, xs, us, k, K, fs, alpha, ws, leaves, spec):
    lead = tuple(x0.shape[:-1])
    T, nx, nu = us.shape[-2], x0.shape[-1], us.shape[-1]
    return (x0.new_empty(lead + (T, nx)), x0.new_empty(lead + (T, nu)),
            x0.new_empty(lead + (nx,)), x0.new_empty(lead),
            x0.new_empty(lead, dtype=torch.bool))


def trial_rollout_b1(seg, x0, xs, us, k, K, fs, alpha):
    """CUDA twin of fused_scans.trial_rollout_fused_plain, through the op
    ``torch.ops.crocoddyl_tpu_torch.trial_rollout_b1``: seg holds the T
    running knots (no terminal knot); α a float or a 0-d tensor.  Over P
    problems (x0 (P, nx)) seg holds their P·T knots, problem by problem,
    and α is (P,)."""
    _on_card("trial_rollout_b1", x0)
    desc = descriptor(seg, x0.device, x0.dtype)
    return torch.ops.crocoddyl_tpu_torch.trial_rollout_b1(
        desc.meta, desc.robot, desc.par, x0, xs, us, k, K, fs,
        as_scalar(alpha, x0, x0.shape[:-1]), desc.ws, [], "")


trial_rollout_b1.launches = 0

WRAPPERS = (node_calc_both, riccati_backward, trial_rollout,
            riccati_backward_b1, trial_rollout_b1)


def reset_counts():
    """Zero the launch counts of the kernel wrappers."""
    for w in WRAPPERS:
        w.launches = 0
