"""One rank of the port's sharded-map checks (tests/test_torch_parallel*.py),
and the helpers that start them.

    python tests/torch_parallel_workers.py CASE RANK WORLD INIT IN_NPZ OUT_NPZ

runs CASE as rank RANK of WORLD gloo ranks on the CPU, rendezvous at INIT (a
``file://`` path; the "slam" case reads torchrun's variables from the
environment instead), reads its inputs from IN_NPZ and writes its outputs to
OUT_NPZ. This module imports no JAX: the test process runs the JAX side.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mm3dgs_slam_torch.models import gaussians as G  # noqa: E402
from mm3dgs_slam_torch.ops.camera import Camera  # noqa: E402
from mm3dgs_slam_torch.ops.render import (ActivatedGaussians, RenderSettings,  # noqa: E402
                                          project_for_pose)
from mm3dgs_slam_torch.parallel.mesh import make_mesh  # noqa: E402
from mm3dgs_slam_torch.parallel.shard_local import (append_gaussians_sharded,  # noqa: E402
                                                    prune_compact_sharded)
from mm3dgs_slam_torch.parallel.sharded import (make_sharded_train_step,  # noqa: E402
                                                replicate_proj, shard_rows)
from mm3dgs_slam_torch.parallel.tile_sharded import (build_window_bins,  # noqa: E402
                                                     composite_tiles_sharded,
                                                     render_tiles_pose_sharded)

SCENE = ("xyz", "scales", "rotations", "opacity", "shs", "alive")


def _t(a):
    return torch.as_tensor(np.asarray(a)).clone()


def _settings(inp):
    h, w, fx, fy, cx, cy = inp["cam"].tolist()
    return RenderSettings(cam=Camera(int(h), int(w), fx, fy, cx, cy))


def _setup(inp, mesh):
    """(this rank's rows of the scene, render settings)."""
    lo, k = shard_rows(inp["xyz"].shape[0], mesh.size)[mesh.rank]
    g = ActivatedGaussians(*(_t(inp[f][lo:lo + k]) for f in SCENE))
    return g, _settings(inp)


def composite(inp, mesh):
    """The sharded composite of the scene at `pose`: the image and, for
    loss = mean((image - gt)^2), this rank's rows of d loss / d packed, with
    the bins built inline and cached."""
    g, rs = _setup(inp, mesh)
    proj = project_for_pose(g, _t(inp["pose"]), rs)
    out = {}
    for tag, cached in (("", False), ("_cached", True)):
        leaf = proj.packed.detach().clone().requires_grad_(True)
        full = replicate_proj(proj._replace(packed=leaf), mesh)
        bins = build_window_bins(full, rs.cam, mesh) if cached else None
        img = composite_tiles_sharded(full, rs, mesh, nc=6, bins=bins)
        torch.mean((img - _t(inp["gt"])) ** 2).backward()
        out[f"image{tag}"] = img.detach().numpy()
        out[f"dpacked{tag}"] = leaf.grad.numpy()
    return out


def pose(inp, mesh):
    """The sharded fused-pose render at (q, T) and (dq, dT) of
    loss = sum(wgrid * out)."""
    g, rs = _setup(inp, mesh)
    nc = int(inp["nc"])
    q = _t(inp["q"]).requires_grad_(True)
    T = _t(inp["T"]).requires_grad_(True)
    with torch.no_grad():
        bins = build_window_bins(
            replicate_proj(project_for_pose(g, torch.cat([q, T]), rs), mesh), rs.cam, mesh)
    out = render_tiles_pose_sharded(g, q, T, rs, bins, mesh, nc)
    dq, dT = torch.autograd.grad((out * _t(inp["wgrid"])).sum(), (q, T))
    return {"out": out.detach().numpy(), "dq": dq.numpy(), "dT": dT.numpy()}


def shard_ops(inp, mesh):
    """Prune this rank's rows (the JAX shard of the same index), then append
    its share of the candidates."""
    r = mesh.rank
    leaves = lambda p: G.GaussianMap(*(_t(inp[f"{p}{f}_{r}"]) for f in G.PARAM_FIELDS))  # noqa: E731
    m, adam = leaves("m_"), G.AdamState(leaves("mu_"), leaves("nu_"), 3)
    m, adam, (stat,) = prune_compact_sharded(m, adam, _t(inp[f"keep_{r}"]), mesh,
                                             extras=(_t(inp[f"stat_{r}"]),))
    out = {f"pruned_{f}": getattr(m, f).numpy() for f in G.PARAM_FIELDS}
    out["pruned_stat"] = stat.numpy()
    new = G.NewGaussians(*(_t(inp[f"new_{f}"]) for f in G.PARAM_FIELDS), mask=_t(inp["new_mask"]))
    m, adam, n_added, added = append_gaussians_sharded(m, adam, new, mesh)
    out.update({f"appended_{f}": getattr(m, f).numpy() for f in G.PARAM_FIELDS})
    out.update(appended_mu_xyz=adam.mu.xyz.numpy(), n_added=np.asarray(n_added),
               added=added.numpy())
    return out


def train_step(inp, mesh):
    """Two steps of make_sharded_train_step on this rank's rows of a map."""
    rs = _settings(inp)
    lo, k = shard_rows(inp["m_xyz"].shape[0], mesh.size)[mesh.rank]
    m = G.GaussianMap(*(_t(inp[f"m_{f}"][lo:lo + k]) for f in G.PARAM_FIELDS))
    adam = G.init_adam(m)
    hyper = G.MapOptHyper(*[float(v) for v in inp["hyper"]])
    step = make_sharded_train_step(rs, hyper, mesh)
    losses = []
    for _ in range(2):
        m, adam, loss = step(m, adam, _t(inp["pose"]), _t(inp["gt"]))
        losses.append(float(loss))
    out = {f"m_{f}": getattr(m, f).numpy() for f in G.PARAM_FIELDS}
    out["losses"] = np.asarray(losses)
    return out


def slam(inp, _mesh):
    """The SLAM at tpu.mesh_devices = WORLD on the CPU (torchrun's variables
    in the environment)."""
    from mm3dgs_slam_torch.slam.slam import SLAM

    cfg = json.loads(str(inp["cfg"]))
    scene = {k[6:]: inp[k] for k in inp.files if k.startswith("scene_")}
    s = SLAM(cfg, device="cpu", scene=scene or None)
    s.run()
    return {"pose_est": s.estimate_pose_list, "rows": np.asarray(s.gaussians.n),
            "keyframes": np.asarray([kf.idx for kf in s.mapper.keyframes])}


CASES = {f.__name__: f for f in (composite, pose, shard_ops, train_step, slam)}
ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start(case: str, world: int, tmp_path: Path, inputs: dict, torchrun_env: bool = False):
    """Start `case` on `world` ranks, each its own process, with torchrun's
    variables in the environment when `torchrun_env`; returns the handle
    that `finish` takes."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    in_npz = tmp_path / f"{case}_in.npz"
    np.savez(in_npz, **inputs)
    init = f"file://{tmp_path / (case + '_rdzv')}"
    base = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    base.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(base)
        if torchrun_env:
            env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, case, str(r), str(world), init, str(in_npz),
             str(tmp_path / f"{case}_out{r}.npz")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return case, tmp_path, procs


def finish(handle, timeout: float = 240) -> list:
    """Wait for every rank (killing the rest once one fails or the time is
    up); returns each rank's outputs, or fails with the failed rank's log."""
    case, tmp_path, procs = handle
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            log = logs[r] if r < len(logs) else ""
            raise AssertionError(f"rank {r} of {case} failed ({p.returncode}):\n{log}")
    return [np.load(tmp_path / f"{case}_out{r}.npz") for r in range(len(procs))]


def launch(case: str, world: int, tmp_path: Path, inputs: dict, **kw) -> list:
    """`start` then `finish`."""
    return finish(start(case, world, tmp_path, inputs, **kw))


def main(argv):
    case, rank, world, init, in_npz, out_npz = argv
    torch.set_num_threads(1)
    inp = np.load(in_npz, allow_pickle=False)
    mesh = None if case == "slam" else make_mesh(int(world), "cpu", rank=int(rank),
                                                 init_method=init, timeout_s=180)
    np.savez(out_npz, **CASES[case](inp, mesh))
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
