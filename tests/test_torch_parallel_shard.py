"""The port's shard-local map surgery and sharded train step
(mm3dgs_slam_torch/parallel/shard_local.py, sharded.py) on W gloo ranks
(processes running tests/torch_parallel_workers.py, which imports no JAX),
held against the JAX package's parallel/shard_local.py on a mesh of the same
size: the same rows per shard, in the same order, and the same per-shard
counts where JAX's capacity does not bind."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mm3dgs_slam_tpu.models import gaussians as JG
from mm3dgs_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from mm3dgs_slam_tpu.parallel.shard_local import append_gaussians_sharded as jappend_sharded
from mm3dgs_slam_tpu.parallel.shard_local import prune_compact_sharded as jprune_sharded

from mm3dgs_slam_torch.models import gaussians as TG
from mm3dgs_slam_torch.ops.binning import build_bins
from mm3dgs_slam_torch.ops.render import background, from_tiles, project_for_pose
from mm3dgs_slam_torch.parallel.shard_local import waterfill_quota

from test_torch_parallel import POSE, _scene, needs_mesh
from torch_parallel_workers import launch

torch.set_num_threads(1)


def _jax_shard_layout(world, counts, seed):
    """A JAX map of capacity 96 W with per-shard alive prefixes `counts`,
    Adam moments and a per-row stat, all random."""
    cap = 96 * world
    block = cap // world
    rng = np.random.default_rng(seed)
    m = JG.empty_map(cap)
    leaves = {f: rng.normal(size=np.asarray(getattr(m, f)).shape).astype(np.float32)
              for f in JG._PARAM_FIELDS}
    m = m._replace(**{f: jnp.asarray(v) for f, v in leaves.items()},
                   n_alive=jnp.asarray(counts, jnp.int32))
    mu = m._replace(**{f: jnp.asarray(rng.normal(size=v.shape).astype(np.float32))
                       for f, v in leaves.items()})
    nu = m._replace(**{f: jnp.asarray(rng.uniform(size=v.shape).astype(np.float32))
                       for f, v in leaves.items()})
    adam = JG.AdamState(mu=mu, nu=nu, step=jnp.asarray(3, jnp.int32))
    keep = rng.uniform(size=cap) > 0.3
    stat = rng.normal(size=cap).astype(np.float32)
    return m, adam, keep, stat, block


def _shard_rows_of(m, s, block, count, extra=None):
    sl = slice(s * block, s * block + count)
    rows = {f: np.asarray(getattr(m, f))[sl] for f in JG._PARAM_FIELDS}
    if extra is not None:
        rows["stat"] = np.asarray(extra)[sl]
    return rows


@needs_mesh
@pytest.mark.parametrize("world", [2, 3])
def test_shard_local_prune_and_append_match_jax(world, tmp_path):
    """prune_compact_sharded then append_gaussians_sharded on W ranks, each
    holding the alive rows of the JAX shard of its index: the same rows per
    shard, in the same order, and the same per-shard counts as JAX's on a
    W-device mesh (whose capacity does not bind)."""
    counts = [40, 17, 29][:world]
    m, adam, keep, stat, block = _jax_shard_layout(world, counts, seed=world)
    mesh = jmake_mesh(world)
    m2, adam2, (stat2,) = jprune_sharded(m, adam, jnp.asarray(keep), mesh,
                                         extras=(jnp.asarray(stat),))
    counts2 = np.asarray(m2.n_alive).tolist()
    rng = np.random.default_rng(11)
    n_new = 64
    new = {f: rng.normal(size=(n_new,) + np.asarray(getattr(m, f)).shape[1:]).astype(np.float32)
           for f in JG._PARAM_FIELDS}
    new_mask = rng.uniform(size=n_new) > 0.4
    jnew = JG.NewGaussians(**{f: jnp.asarray(v) for f, v in new.items()},
                           mask=jnp.asarray(new_mask))
    m3, adam3, n_added, _ = jappend_sharded(m2, adam2, jnew, mesh)
    counts3 = np.asarray(m3.n_alive).tolist()
    assert max(counts3) < block   # the capacity did not bind
    assert [c3 - c2 for c2, c3 in zip(counts2, counts3)] == waterfill_quota(
        counts2, int(new_mask.sum()))

    inputs = dict(new_mask=new_mask, **{f"new_{f}": v for f, v in new.items()})
    for s in range(world):
        for prefix, st in (("m_", m), ("mu_", adam.mu), ("nu_", adam.nu)):
            rows = _shard_rows_of(st, s, block, counts[s])
            inputs.update({f"{prefix}{f}_{s}": v for f, v in rows.items()})
        sl = slice(s * block, s * block + counts[s])
        inputs[f"keep_{s}"] = keep[sl]
        inputs[f"stat_{s}"] = stat[sl]
    outs = launch("shard_ops", world, tmp_path, inputs)
    for s, o in enumerate(outs):
        want = _shard_rows_of(m2, s, block, counts2[s], stat2)
        for f in JG._PARAM_FIELDS:
            np.testing.assert_array_equal(o[f"pruned_{f}"], want[f])
        np.testing.assert_array_equal(o["pruned_stat"], want["stat"])
        want = _shard_rows_of(m3, s, block, counts3[s])
        for f in JG._PARAM_FIELDS:
            np.testing.assert_array_equal(o[f"appended_{f}"], want[f])
        np.testing.assert_array_equal(o["appended_mu_xyz"],
                                      np.asarray(adam3.mu.xyz)[s * block:s * block + counts3[s]])
        assert int(o["n_added"]) == int(n_added)
        assert int(o["added"].sum()) == counts3[s] - counts2[s]


def test_waterfill_quota_balances():
    assert waterfill_quota([5, 0, 3], 0) == [0, 0, 0]
    q = waterfill_quota([5, 0, 3], 10)
    assert sum(q) == 10 and [c + k for c, k in zip([5, 0, 3], q)] == [6, 6, 6]
    q = waterfill_quota([2, 2], 5)
    assert q == [3, 2]
    assert waterfill_quota([0, 9, 1], 4) == [3, 0, 1]


def test_sharded_train_step_matches_one_rank(tmp_path):
    """Two steps of make_sharded_train_step on 2 ranks against the same
    steps on one process (the plain render, L1 + SSIM, Adam)."""
    from mm3dgs_slam_torch.ops.losses import l1_loss, ssim
    from mm3dgs_slam_torch.ops.render import composite_packed

    cam, g, jrs, arrays, rs = _scene()
    rng = np.random.default_rng(13)
    n = 300
    m_np = {"xyz": arrays["xyz"], "features_dc": arrays["shs"][:, :1],
            "features_rest": np.zeros((n, 1, 3), np.float32),
            "scaling": np.log(arrays["scales"]), "rotation": arrays["rotations"],
            "opacity": np.log(arrays["opacity"] / (1 - arrays["opacity"]))[:, None],
            "rgb": rng.uniform(size=(n, 3)).astype(np.float32)}
    gt = rng.uniform(size=(3, cam.height, cam.width)).astype(np.float32)
    hyper = TG.MapOptHyper(0.001, 0.0025, 0.000125, 0.001, 0.001, 0.05, 0.0025)
    m = TG.GaussianMap(*(torch.as_tensor(m_np[f]).clone() for f in TG.PARAM_FIELDS))
    adam = TG.init_adam(m)
    pose = torch.as_tensor(POSE)
    losses = []
    for _ in range(2):
        leaves = [t.detach().requires_grad_(True) for t in m]
        proj = project_for_pose(TG.GaussianMap(*leaves).activated(), pose, rs)
        with torch.no_grad():
            bins = build_bins(proj, rs.cam)
        acc, tfin = composite_packed(proj.packed, bins, rs.cam, 3)
        img = from_tiles(acc + tfin * background(rs)[:3][None, :, None], rs.cam)
        loss = 0.8 * l1_loss(img, torch.as_tensor(gt)) + 0.2 * (1 - ssim(img, torch.as_tensor(gt)))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads)]
        losses.append(float(loss))
        with torch.no_grad():
            m, adam = TG.adam_update(m, TG.GaussianMap(*grads), adam, hyper)
    outs = launch("train_step", 2, tmp_path, dict(
        {f"m_{f}": v for f, v in m_np.items()}, cam=np.asarray(list(cam[:6]), np.float64),
        pose=POSE, gt=gt, hyper=np.asarray(hyper, np.float64)))
    assert np.array_equal(outs[0]["losses"], outs[1]["losses"])
    np.testing.assert_allclose(outs[0]["losses"], losses, rtol=1e-5)
    for f in TG.PARAM_FIELDS:
        got = np.concatenate([o[f"m_{f}"] for o in outs])
        # Adam turns float noise in near-zero gradients into steps of up to
        # 2 lr: hold each entry to 2 lr beyond the gradient tolerance
        lr = getattr(hyper, "lr_" + f)
        np.testing.assert_allclose(got, getattr(m, f).numpy(), atol=2 * 2 * lr + 1e-6, rtol=0)
