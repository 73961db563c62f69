"""The port's multi-device paths over torch.distributed: two gloo processes on
the CPU, started the way tests/test_multihost.py starts its workers (a free
port, a timeout of its own). One launch serves every test of the file.

- collectives of ``parallel/``: ``all_sum``, ``all_gather_rows``,
  ``replicate``, ``shard_batch``, ``broadcast_from_primary``;
- sharded ``bundle_adjust`` (landmark axis split over the two processes)
  equal to the unsharded run at atol 1e-4 (tests/test_ba.py:162-163), and to
  the JAX package's ``bundle_adjust(mesh=make_device_mesh(2))``;
- sharded ``register`` (hypothesis axis split) equal to the unsharded run:
  ranked poses and scores at atol 1e-3 (tests/test_sharded_register.py:76-84),
  pads at the tail, funnel pads excluded; geometric mode at a small CPU size
  (42 hypotheses padded to 64, 32 px crops, 4 iterations), the learned hybrid
  ``slow``. Cut to that size, registration misses the 10 % ADD-S gate of the
  JAX test in both packages (at the JAX test's own 126 hypotheses and 64 px
  the funnel lands 27.6 mm off in both, on this frame), so these tests hold
  the sharded run to the unsharded one; accuracy is gated at full size by
  tests/test_torch_geometric.py and chip_smoke.py.
"""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from foundationpose_tpu.parallel.mesh import make_device_mesh as jax_mesh
from foundationpose_tpu.slam import ba as jba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_ba import make_problem  # noqa: E402

_WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(2)
from foundationpose_tpu_torch.parallel import mesh as pm, multihost

rank, tmp, learned = int(sys.argv[1]), sys.argv[2], sys.argv[3] == "1"
multihost.initialize({coord!r}, num_processes=2, process_id=rank, device="cpu")
assert multihost.process_count() == 2 and multihost.process_index() == rank
mesh = multihost.make_global_mesh(("batch",))
out = {{}}

# ---- collectives
out["all_sum"] = pm.all_sum(mesh, torch.full((2, 1), float(rank + 1))).numpy()
out["gathered"] = pm.all_gather_rows(mesh, torch.full((2, 3), float(rank))).numpy()
out["replicated"] = pm.replicate(mesh, {{"a": torch.full((3,), float(rank + 7))}})["a"].numpy()
out["shard"] = pm.shard_batch(mesh, np.arange(8.0))[:].numpy()
out["bcast_obj"] = np.asarray(multihost.broadcast_from_primary({{"r": rank}})["r"])
multihost.sync_hosts("collectives")

# ---- bundle adjustment, landmarks split over the two processes
from foundationpose_tpu_torch.slam import ba
p = np.load(tmp + "/ba.npz")
args = [p[k] for k in ("poses", "X", "kf", "pt", "w")]
cfg = ba.BAConfig(n_iters=5)
one = ba.bundle_adjust(*args, config=cfg, device="cpu")
sharded = ba.bundle_adjust(*args, config=cfg, mesh=mesh)
for name, t in zip(("poses", "X", "costs"), one):
    out["ba_one_" + name] = t.numpy()
for name, t in zip(("poses", "X", "costs"), sharded):
    out["ba_sharded_" + name] = t.numpy()

# ---- register, hypotheses split over the two processes
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch
from foundationpose_tpu_torch.engine.geometric import (GeometricConfig, GeometricRefiner,
                                                        GeometricScorer)
s = np.load(tmp + "/scene.npz")
obj = meshio.Mesh(s["verts"], s["faces"])
obj.vertex_colors = np.full((len(obj.vertices), 3), 180, np.uint8)
frame = (s["K"], s["rgb"], s["depth"], s["mask"])

def make(device_mesh, **cfg):
    config = EstimatorConfig(min_n_views=12, inplane_step=360, register_iterations=4, **cfg)
    if learned:
        from foundationpose_tpu_torch.apps import demo_synthetic as demo
        return demo.build_estimator(obj, device="cpu", input_size=64, config=config,
                                    device_mesh=device_mesh)
    g = GeometricConfig(input_size=32)
    return FoundationPoseTorch(obj, config=config, refiner=GeometricRefiner(g, device="cpu"),
                               scorer=GeometricScorer(g, device="cpu"), device="cpu",
                               device_mesh=device_mesh)

for tag, cfg in (("full", {{}}), ("funnel", dict(funnel_top_k=8, funnel_coarse_iterations=2))):
    for kind, dm in (("one", None), ("sharded", mesh)):
        est = make(dm, **cfg)
        pose = est.register(*frame)
        out[f"reg_{{tag}}_{{kind}}_pose"] = pose
        out[f"reg_{{tag}}_{{kind}}_poses"] = est.poses
        out[f"reg_{{tag}}_{{kind}}_scores"] = est.scores
        out[f"reg_{{tag}}_{{kind}}_order"] = est.hyp_order
        out[f"reg_{{tag}}_n_grid"] = np.asarray(len(est.rot_grid))
multihost.sync_hosts("done")
np.savez(f"{{tmp}}/rank{{rank}}.npz", **out)
print("RANK%d_OK" % rank, flush=True)
"""


def _scene(tmp_path):
    """The two-box object of tests/test_sharded_register.py rendered at
    120x160 by the port's plain rasterizer."""
    from foundationpose_tpu_torch.core import meshio, poses as poses_mod
    from foundationpose_tpu_torch.ops import raster

    a = meshio.make_box((0.12, 0.04, 0.04))
    b = meshio.make_box((0.04, 0.09, 0.04)).translated([0.04, 0.065, 0.0])
    verts = np.concatenate([a.vertices, b.vertices])
    faces = np.concatenate([a.faces, b.faces + len(a.vertices)])
    obj = meshio.Mesh(verts, faces)
    obj.vertex_colors = np.full((len(verts), 3), 180, np.uint8)
    K = np.array([[250.0, 0, 80], [0, 250.0, 60], [0, 0, 1]])
    gt = poses_mod.euler_matrix_np(0.3, -0.2, 0.5)
    gt[:3, 3] = [0.01, -0.02, 0.55]
    out = raster.render_full_frame(raster.make_mesh_tensors(obj, device="cpu"),
                                   gt[None].astype(np.float32), K, (120, 160))
    np.savez(tmp_path / "scene.npz", verts=verts, faces=faces, K=K,
             rgb=out["rgb"][0].numpy() * 255.0, depth=out["depth"][0].numpy(),
             mask=out["mask"][0].numpy())


def _launch(tmp_path, learned, timeout):
    _, _, poses, X, kf, pt, w = make_problem(K_poses=4, L=51, pose_err=0.05, seed=4)
    np.savez(tmp_path / "ba.npz", poses=poses, X=X, kf=kf, pt=pt, w=w)
    _scene(tmp_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(root=ROOT, coord=f"localhost:{port}"))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path),
                               "1" if learned else "0"],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {rank} timed out")
        assert p.returncode == 0 and f"RANK{rank}_OK" in out, f"rank {rank} failed:\n{out}"
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)], (poses, X, kf, pt, w)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("parallel"), learned=False, timeout=300)


def test_collectives(run):
    ranks, *_ = run
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["all_sum"], np.full((2, 1), 3.0))
        np.testing.assert_array_equal(out["gathered"], np.repeat([[0.0], [1.0]], [2, 2], axis=0)
                                      * np.ones((4, 3)))
        np.testing.assert_array_equal(out["replicated"], np.full(3, 7.0))
        np.testing.assert_array_equal(out["shard"], np.arange(4.0) + 4 * r)
        assert int(out["bcast_obj"]) == 0


def test_sharded_bundle_adjust_matches_unsharded_and_jax(run):
    ranks, (poses, X, kf, pt, w), *_ = run
    for out in ranks:
        assert out["ba_sharded_X"].shape == X.shape  # the pad landmark is dropped
        np.testing.assert_allclose(out["ba_sharded_poses"], out["ba_one_poses"], atol=1e-4)
        np.testing.assert_allclose(out["ba_sharded_X"], out["ba_one_X"], atol=1e-4)
        np.testing.assert_allclose(out["ba_sharded_costs"], out["ba_one_costs"], rtol=1e-3,
                                   atol=1e-8)
    for k in ("ba_sharded_poses", "ba_sharded_X", "ba_sharded_costs"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    assert jax.device_count() >= 2
    pj, xj, cj = jba.bundle_adjust(poses, X, kf, pt, w, config=jba.BAConfig(n_iters=5),
                                   mesh=jax_mesh(2))
    np.testing.assert_allclose(ranks[0]["ba_sharded_poses"], np.asarray(pj), atol=1e-4)
    np.testing.assert_allclose(ranks[0]["ba_sharded_X"], np.asarray(xj), atol=1e-4)
    np.testing.assert_allclose(ranks[0]["ba_sharded_costs"], np.asarray(cj), rtol=1e-3, atol=1e-8)


def _check_register(ranks, tag):
    n_grid = int(ranks[0][f"reg_{tag}_n_grid"])
    assert n_grid % 32 and n_grid % 2 == 0  # pads exist; both processes get real entries
    for out in ranks:
        sh, one = (lambda k: out[f"reg_{tag}_sharded_{k}"]), (lambda k: out[f"reg_{tag}_one_{k}"])
        # pads ranked at the tail and dropped: every kept entry is a real
        # hypothesis with a finite score
        assert len(sh("scores")) == n_grid and np.isfinite(sh("scores")).all()
        assert sorted(sh("order").tolist()) == list(range(n_grid))
        np.testing.assert_allclose(sh("scores"), one("scores"), atol=1e-3)
        np.testing.assert_allclose(sh("poses"), one("poses"), atol=1e-3)
        np.testing.assert_allclose(sh("pose"), one("pose"), atol=1e-3)
    for k in ("pose", "poses", "scores", "order"):
        np.testing.assert_array_equal(ranks[0][f"reg_{tag}_sharded_{k}"],
                                      ranks[1][f"reg_{tag}_sharded_{k}"])
    return ranks[0]


def test_sharded_register_matches_unsharded(run):
    _check_register(run[0], "full")


def test_sharded_funnel_register_excludes_pads(run):
    """With the funnel, pads take no fine-pass slot: exactly the funnel's
    survivors carry the polish's +100 lift or the funnel's, none of them a
    pad, and the ranked list equals the unsharded run's."""
    out = _check_register(run[0], "funnel")
    scores = out["reg_funnel_sharded_scores"]
    assert int(np.sum(scores >= 100.0 + scores.min())) >= 1


@pytest.mark.slow
def test_sharded_learned_register_matches_unsharded(tmp_path):
    """The learned hybrid (shipped weights, float32 nets, 64 px) sharded over
    two processes: ScoreNet's attention sees every hypothesis on each."""
    ranks = _launch(tmp_path, learned=True, timeout=1800)[0]
    for tag in ("full", "funnel"):
        _check_register(ranks, tag)
