"""Trajectory visualization (port of crocoddyl_tpu/io/display.py).

Reference: ``GepettoDisplay`` (bindings/python/crocoddyl/__init__.py:64),
``MeshcatDisplay`` (:322) and ``CallbackDisplay`` (:345) render solved
trajectories on a live viewer.  As in the JAX package, the port renders
after the solve from the solution's arrays:

* :func:`skeleton` — the forward kinematics of every knot in one
  ``torch.func.vmap`` sweep on the device of the states, to world joint
  and frame positions: the data every renderer consumes.
* :func:`animate_matplotlib` — a 3D animation (GIF, or MP4 with ffmpeg)
  of the kinematic skeleton, foot frames highlighted.
* :func:`export_html` — a standalone, offline HTML file with an embedded
  canvas player (no CDN, no server).
* :class:`DisplayLog` and :class:`CallbackDisplay` — collect states across
  MPC replans, or the candidate of every few solver iterations, and render
  them once.

matplotlib and Pillow are imported inside the functions that draw.
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.solvers.fddp import cast
from ..dynamics.algorithms import KinData


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def skeleton(model, xs, frame_names: Optional[Sequence[str]] = None):
    """World positions along a trajectory, via one vmapped FK sweep on the
    device of ``xs`` (a tensor; anything else becomes one on the CPU in the
    model's dtype).

    Returns numpy ``(joints (N, nj, 3), frames (N, nf_sel, 3), parents
    (nj,))`` where ``parents[i]`` is the parent joint index (−1 for the
    root) — the bone list for skeleton rendering.
    """
    if not isinstance(xs, torch.Tensor):
        xs = torch.as_tensor(np.asarray(xs), dtype=model.mass.dtype)
    model = cast(model, xs.device, xs.dtype)
    nq = model.nq
    fids = [model.frame_id(n) for n in frame_names or ()]

    def fk(x):
        kin = KinData(model, x[:nq], x.new_zeros((model.nv,)))
        joints = kin.oMi.p
        if fids:
            fpos = torch.stack([kin.frame_placement(f).p for f in fids])
        else:
            fpos = x.new_zeros((0, 3))
        return joints, fpos

    joints, frames = torch.func.vmap(fk)(xs)
    return (_np(joints), _np(frames),
            np.asarray(model.parents, dtype=np.int64))


def _bones(parents):
    return [(int(p), i) for i, p in enumerate(parents) if p >= 0]


def animate_matplotlib(model, xs, path: str,
                       frame_names: Optional[Sequence[str]] = None,
                       fps: int = 25, stride: int = 1,
                       elev: float = 18.0, azim: float = -70.0):
    """Render the trajectory as a 3D skeleton animation (GIF via pillow,
    MP4 if ffmpeg is available).  Returns the output path."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    joints, frames, parents = skeleton(model, xs, frame_names)
    joints = joints[::stride]
    frames = frames[::stride]
    bones = _bones(parents)

    fig = plt.figure(figsize=(6, 5))
    ax = fig.add_subplot(projection="3d")
    lo = joints.reshape(-1, 3).min(0) - 0.1
    hi = joints.reshape(-1, 3).max(0) + 0.1
    mid, rng = (lo + hi) / 2, float((hi - lo).max()) / 2

    lines = [ax.plot([], [], [], "o-", lw=2, ms=2, color="#2a6fdb")[0]
             for _ in bones]
    pts = ax.plot([], [], [], "o", ms=5, color="#d1342f")[0]
    trails = ax.plot([], [], [], "-", lw=0.8, color="#d1342f", alpha=0.5)[0]

    ax.set_xlim(mid[0] - rng, mid[0] + rng)
    ax.set_ylim(mid[1] - rng, mid[1] + rng)
    ax.set_zlim(mid[2] - rng, mid[2] + rng)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")

    def update(t):
        for ln, (p, c) in zip(lines, bones):
            seg = joints[t][[p, c]]
            ln.set_data(seg[:, 0], seg[:, 1])
            ln.set_3d_properties(seg[:, 2])
        if frames.shape[1]:
            pts.set_data(frames[t, :, 0], frames[t, :, 1])
            pts.set_3d_properties(frames[t, :, 2])
            trails.set_data(frames[: t + 1, :, 0].ravel(),
                            frames[: t + 1, :, 1].ravel())
            trails.set_3d_properties(frames[: t + 1, :, 2].ravel())
        return lines + [pts, trails]

    anim = animation.FuncAnimation(fig, update, frames=len(joints),
                                   interval=1000 / fps, blit=True)
    if path.endswith(".mp4"):
        try:
            anim.save(path, writer="ffmpeg", fps=fps)
        except (RuntimeError, FileNotFoundError):
            path = path[:-4] + ".gif"
            anim.save(path, writer="pillow", fps=fps)
    else:
        anim.save(path, writer="pillow", fps=fps)
    plt.close(fig)
    return path


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>crocoddyl_tpu trajectory</title>
<style>body{font-family:sans-serif;margin:12px;background:#fafafa}
canvas{border:1px solid #ccc;background:#fff}
.bar{margin:8px 0}</style></head><body>
<h3>crocoddyl_tpu trajectory player</h3>
<canvas id="c" width="760" height="560"></canvas>
<div class="bar">
<button id="play">pause</button>
<input id="scrub" type="range" min="0" value="0" style="width:480px">
<span id="lab"></span></div>
<p>drag on the canvas to orbit the view; dependency-free offline player
(the MeshcatDisplay-static analogue).</p>
<script>
const DATA = __DATA__;
const J = DATA.joints, B = DATA.bones, F = DATA.frames, dt = DATA.dt;
const cv = document.getElementById('c'), cx = cv.getContext('2d');
const scrub = document.getElementById('scrub'); scrub.max = J.length-1;
let t = 0, playing = true, yaw = -0.9, pitch = 0.35;
const mid = DATA.mid, rng = DATA.rng, scale = 240/rng;
function proj(p){
  const x=p[0]-mid[0], y=p[1]-mid[1], z=p[2]-mid[2];
  const cx1=Math.cos(yaw), sx=Math.sin(yaw);
  const cp=Math.cos(pitch), sp=Math.sin(pitch);
  const u = cx1*x + sx*y, v = -sx*x + cx1*y;
  const w = cp*z - sp*v,  d = sp*z + cp*v;
  return [380 + u*scale, 300 - w*scale, d];
}
function draw(){
  cx.clearRect(0,0,cv.width,cv.height);
  const js = J[t];
  // links as depth-sorted capsules (width from link mass; the URDF ships
  // no visual meshes, so geometry is synthesized from the kinematics)
  const segs = [];
  for (let i=0;i<B.length;i++){
    const a=proj(js[B[i][0]]), b=proj(js[B[i][1]]);
    segs.push([a,b,(DATA.widths||[])[i]||2,(a[2]+b[2])/2]);
  }
  segs.sort((x,y)=>x[3]-y[3]);
  cx.lineCap='round';
  for (const [a,b,w,d] of segs){
    const sh = Math.max(30, Math.min(200, 120 - d*scale*0.4));
    cx.strokeStyle='rgb('+(sh-10)+','+(sh+20)+','+(sh+90)+')';
    cx.lineWidth=w;
    cx.beginPath(); cx.moveTo(a[0],a[1]); cx.lineTo(b[0],b[1]); cx.stroke();
    cx.fillStyle='rgb('+(sh-10)+','+(sh+20)+','+(sh+90)+')';
    for (const e of [a,b]){ cx.beginPath();
      cx.arc(e[0],e[1],w*0.55,0,6.283); cx.fill(); }
  }
  cx.fillStyle='#d1342f';
  for (const f of (F[t]||[])){
    const a=proj(f); cx.beginPath();
    cx.arc(a[0],a[1],4,0,6.283); cx.fill();
  }
  document.getElementById('lab').textContent =
    't = ' + (t*dt).toFixed(3) + ' s  (' + t + '/' + (J.length-1) + ')';
  scrub.value = t;
}
setInterval(()=>{ if(playing){ t=(t+1)%J.length; draw(); } },
            Math.max(16, dt*1000));
scrub.oninput = e => { t = +e.target.value; draw(); };
document.getElementById('play').onclick = e => {
  playing = !playing; e.target.textContent = playing ? 'pause' : 'play'; };
let drag=null;
cv.onmousedown = e => drag=[e.clientX,e.clientY];
window.onmouseup = () => drag=null;
window.onmousemove = e => { if(drag){
  yaw += (e.clientX-drag[0])*0.01; pitch += (e.clientY-drag[1])*0.01;
  drag=[e.clientX,e.clientY]; draw(); } };
draw();
</script></body></html>
"""


def export_html(model, xs, path: str,
                frame_names: Optional[Sequence[str]] = None,
                dt: float = 0.01, stride: int = 1) -> str:
    """Write a standalone offline HTML player for the trajectory (the
    MeshcatDisplay analogue without a server: trajectory data is embedded,
    rendering is a dependency-free JS canvas)."""
    joints, frames, parents = skeleton(model, xs, frame_names)
    joints = joints[::stride]
    frames = frames[::stride]
    lo = joints.reshape(-1, 3).min(0)
    hi = joints.reshape(-1, 3).max(0)
    bones = _bones(parents)
    # capsule widths from the child link's mass (m^(1/3) scaling): the
    # vendored URDFs carry no visual meshes, so the renderer synthesizes
    # link geometry from the kinematic tree + inertial data
    mass = _np(model.mass).astype(np.float64)
    widths = [float(np.clip(3.0 * np.cbrt(max(mass[c], 1e-3)), 1.5, 10.0))
              for (_, c) in bones]
    data = {
        "joints": np.round(joints, 4).tolist(),
        "frames": np.round(frames, 4).tolist(),
        "bones": bones,
        "widths": widths,
        "dt": dt * stride,
        "mid": ((lo + hi) / 2).tolist(),
        "rng": float(max((hi - lo).max() / 2, 1e-3)),
    }
    with open(path, "w") as f:
        f.write(_HTML_TEMPLATE.replace("__DATA__", json.dumps(data)))
    return path


class DisplayLog:
    """CallbackDisplay analogue for MPC/replan loops: the reference renders
    the candidate trajectory every N solver iterations
    (bindings __init__.py:345-355); this collects executed states across
    replans and renders once."""

    def __init__(self, model, frame_names: Optional[Sequence[str]] = None):
        self.model = model
        self.frame_names = frame_names
        self.xs = []

    def push(self, x):
        self.xs.append(_np(x))

    def render(self, path: str, dt: float = 0.01, **kw):
        xs = np.stack(self.xs)
        if path.endswith(".html"):
            return export_html(self.model, xs, path, self.frame_names,
                               dt=dt, **kw)
        return animate_matplotlib(self.model, xs, path, self.frame_names,
                                  **kw)


class CallbackDisplay:
    """During-solve candidate renderer — the reference's ``CallbackDisplay``
    (bindings/python/crocoddyl/__init__.py:345-355: re-render the candidate
    trajectory every N solver iterations).

    Pass as ``SolverSettings(iter_callback=CallbackDisplay(model, ...))``:
    ``solve`` calls it after every iteration with the iteration, the cost
    and the candidate xs, tensors that may sit on the card (they are moved
    to the CPU here).  Every ``every`` iterations the candidate xs is
    snapshotted; ``render()`` writes the iteration-by-iteration animation
    (each snapshot is one "frame set" of the evolving candidate), the
    offline analogue of watching the viewer during a solve."""

    def __init__(self, model, every: int = 5,
                 frame_names: Optional[Sequence[str]] = None):
        self.model = model
        self.every = max(1, int(every))
        self.frame_names = frame_names
        self.snapshots = []          # (iter, cost, xs)

    def __call__(self, it, cost, xs):
        it = int(_np(it))
        if it % self.every == 0:
            self.snapshots.append((it, float(_np(cost)), _np(xs)))

    def render(self, path_prefix: str, dt: float = 0.01, **kw):
        """One HTML player per snapshot: ``{prefix}_iter{k}.html``."""
        out = []
        for it, cost, xs in self.snapshots:
            p = f"{path_prefix}_iter{it:03d}.html"
            export_html(self.model, xs, p, self.frame_names, dt=dt, **kw)
            out.append(p)
        return out
