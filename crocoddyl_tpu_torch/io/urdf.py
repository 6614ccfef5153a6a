"""URDF → RobotModel through the shared native parser (native/urdf_loader.cpp).

The C++ parser flattens the kinematic tree (merging fixed joints and
compositing their inertias) and returns JSON; this module freezes it into a
:class:`~crocoddyl_tpu_torch.dynamics.model.RobotModel` of tensors.

The shared library is built with g++ into ``crocoddyl_tpu_torch/build/``.
One process builds at a time (a file lock), into a temporary file that it
renames into place, so several processes that load the parser at once
never see a half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "urdf_loader.cpp")
BUILD_DIR = os.path.join(_PKG, "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, "liburdf_loader.so")
        # one build at a time across processes
        with open(os.path.join(BUILD_DIR, "urdf.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if (not os.path.exists(so)
                    or os.path.getmtime(so) < os.path.getmtime(_SRC)):
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC",
                                    "-shared", _SRC, "-o", tmp], check=True,
                                   capture_output=True)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        lib = ctypes.CDLL(so)
        lib.crocotpu_parse_urdf.restype = ctypes.c_void_p
        lib.crocotpu_parse_urdf.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.crocotpu_free.argtypes = [ctypes.c_void_p]
        lib.crocotpu_free.restype = None
        _lib = lib
        return lib


def _decode(x):
    """JSON 'inf'/'-inf' strings → floats."""
    return float(x) if isinstance(x, str) else x


def load_urdf_string(urdf_text: str, floating_base: bool = True,
                     dtype=torch.float64):
    """Parse URDF text into a RobotModel (native C++ parse)."""
    from ..dynamics.model import RobotModel

    lib = _load_lib()
    ptr = lib.crocotpu_parse_urdf(urdf_text.encode(), int(floating_base))
    try:
        raw = ctypes.cast(ptr, ctypes.c_char_p).value.decode()
    finally:
        lib.crocotpu_free(ptr)
    d = json.loads(raw)
    if "error" in d:
        raise ValueError(f"URDF parse error: {d['error']}")
    np_dt = np.float32 if dtype == torch.float32 else np.float64

    def arr(key, shape=None):
        a = np.asarray([[_decode(v) for v in row] if isinstance(row, list)
                        else _decode(row) for row in d[key]], np_dt)
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(a)

    nj = len(d["joint_types"])
    nf = max(len(d["frame_names"]), 1)
    fp_R = (arr("fp_R", (nf, 3, 3)) if d["frame_names"]
            else torch.eye(3, dtype=dtype)[None])
    fp_p = (arr("fp_p", (nf, 3)) if d["frame_names"]
            else torch.zeros((1, 3), dtype=dtype))
    return RobotModel(
        joint_types=tuple(d["joint_types"]),
        parents=tuple(d["parents"]),
        joint_names=tuple(d["joint_names"]),
        frame_names=tuple(d["frame_names"]) or ("__world__",),
        frame_parents=tuple(d["frame_parents"]) or (0,),
        jp_R=arr("jp_R", (nj, 3, 3)),
        jp_p=arr("jp_p", (nj, 3)),
        axis=arr("axis", (nj, 3)),
        mass=arr("mass", (nj,)),
        com=arr("com", (nj, 3)),
        inertia=arr("inertia", (nj, 3, 3)),
        fp_R=fp_R,
        fp_p=fp_p,
        gravity=torch.tensor([0.0, 0.0, -9.81], dtype=dtype),
        q_lb=arr("q_lb"),
        q_ub=arr("q_ub"),
        v_limit=arr("v_limit"),
        effort_limit=arr("effort_limit"),
    )


def load_urdf(path: str, floating_base: bool = True, dtype=torch.float64):
    """Load a .urdf file into a RobotModel."""
    with open(path) as f:
        return load_urdf_string(f.read(), floating_base, dtype)
