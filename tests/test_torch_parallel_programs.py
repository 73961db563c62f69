"""The port's data-parallel programs over torch.distributed, the counterparts
of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``): two gloo
processes on the CPU, one launch for the whole file (a free port, a timeout
of its own), as tests/test_torch_parallel.py starts its workers.

- ``parallel.mesh``: ``shard_rows`` (halo clipped at the ends, or wrapped)
  and ``all_reduce_grads`` (one buffer, summed);
- the data-parallel refiner step (``refiner_train_step(mesh=)``, 32 px,
  global batch 4, float32): each process's slice made by
  ``datagen.make_refine_batch(mesh=)`` equals the slice of the unsharded
  batch; three sharded steps against three unsharded ones from the same
  weights — losses at rtol 1e-5 and step 1's all-reduced gradient within
  1e-5 x its norm, with plain Adam and with clip-by-global-norm +
  ``apply_if_finite`` (a clip that triggers: it must see the global
  gradient); both against the JAX package's ``refiner_train_step`` on the
  global batch (step 1's loss at rtol 1e-4; later losses and the
  parameters after 3 steps within the JAX step's own spread under a 1e-7
  perturbation, see ``test_dp_refiner_step_matches_jax``);
- the sharded field step at ``dryrun_multichip``'s tiny config (16 rays per
  process): loss and gradients against the unsharded port step on the same
  draws (rtol 1e-4; gradients within 1e-5 x their norm), and its loss
  against the JAX ``_train_step`` on JAX's draws (rtol 1e-4, the dry run's
  gate); also with the eikonal term (its denominator summed over the
  processes), the pose regulariser (added once) and the hash encoder; five
  sharded steps against five unsharded ones on the runner's own draws;
- ``MultiObjectTracker(device_mesh=)`` on four objects, two per process,
  against the unsharded tracker (float32 RefineNet, 32 px): poses at 1e-5;
  the unsharded tracker is held against JAX in tests/test_torch_multi.py;
- ``register``'s split work: the row-sharded preprocess bit for bit (and a
  row count that does not split, processed whole); the sharded scorers —
  geometric with a cut between hypotheses whose observed validity differs,
  where a slice scored without the halo is wrong; learned (float32
  ScoreNet) and hybrid — against the unsharded scores at 1e-5;
- a batch, object count or ray count that does not split raises.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.field.runner import FieldConfig as JFieldConfig
from foundationpose_tpu.field.runner import NeRFRunnerTPU
from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu.models import training as jtraining
from foundationpose_tpu.models.refine_net import RefineNet as JRefineNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_run_field import _grad_keeping_tx, _jax_draws  # noqa: E402

PX = 32          # the refiner's crop size here
B_GLOBAL = 4     # the refiner's global batch
LR = 1e-4        # make_refiner_train_state's Adam
N_STEPS = 3
FIELD_STEPS = 5
# __graft_entry__.py:100-116 at two processes
FIELD_HW = (24, 32)
FIELD_K = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
FIELD_CFG = dict(n_step=1, n_rand=32, n_samples=8, n_samples_around_depth=8, num_levels=2,
                 log2_hashmap_size=8, base_res=4, finest_res=8, triplane_resolutions=(4, 8),
                 triplane_channels=2, occ_resolution=8, mask_dilate_first=0, mask_dilate=0)
FIELD_VARIANTS = {"dryrun": {},
                  "eikonal_posereg_hash": dict(eikonal_weight=0.1, pose_reg_weight=0.1,
                                               encoder="hash")}
MULTI_K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])

_WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import dataclasses
import numpy as np
import torch
torch.set_num_threads(2)
from foundationpose_tpu_torch.parallel import mesh as pm, multihost

rank, tmp = int(sys.argv[1]), sys.argv[2]
multihost.initialize({coord!r}, num_processes=2, process_id=rank, device="cpu")
mesh = multihost.make_global_mesh(("batch",))
out = {{}}

def raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False

# ---- helpers of parallel.mesh
x = torch.arange(8.0)[:, None].expand(8, 2).contiguous()
for halo in (1, 3, 5):
    rows, (lo, hi) = pm.shard_rows(mesh, x, halo)
    out[f"rows_h{{halo}}"], out[f"lohi_h{{halo}}"] = rows.numpy(), np.array([lo, hi])
    rows, (lo, hi) = pm.shard_rows(mesh, x, halo, wrap=True)
    out[f"wrows_h{{halo}}"], out[f"wlohi_h{{halo}}"] = rows.numpy(), np.array([lo, hi])
lin = torch.nn.Linear(3, 2)
lin.weight.grad = torch.full((2, 3), float(rank + 1))
# the bias has no gradient on this process: it contributes zeros
out["grad_bytes"] = np.array(pm.all_reduce_grads(mesh, lin.parameters()))
out["grad_w"], out["grad_b"] = lin.weight.grad.numpy(), lin.bias.grad.numpy()
out["raises_shard_rows"] = np.array(raises(lambda: pm.shard_rows(mesh, torch.zeros(5, 2), 1)))

# ---- data-parallel refiner step
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.models import convert, datagen, training
from foundationpose_tpu_torch.models.refine_net import RefineNet
from foundationpose_tpu_torch.ops import raster

box = meshio.make_box((0.08, 0.1, 0.06))
box.vertex_colors = np.random.default_rng(0).integers(50, 220, (8, 3)).astype(np.uint8)
mt = raster.make_mesh_tensors(box, device="cpu")
K = np.array([[120.0, 0, 16], [0, 120.0, 16], [0, 0, 1]], np.float32)
diam = meshio.compute_mesh_diameter(mesh=box)
full = datagen.make_refine_batch(torch.Generator().manual_seed(3), mt, K, diam, batch=4,
                                 input_size={px}, augment=True)
mine = datagen.make_refine_batch(torch.Generator().manual_seed(3), mt, K, diam, batch=4,
                                 input_size={px}, augment=True, mesh=mesh)
for k in ("A", "B", "trans_gt", "rot_gt"):
    out[f"datagen_full_{{k}}"], out[f"datagen_mine_{{k}}"] = full[k].numpy(), mine[k].numpy()
out["raises_datagen"] = np.array(raises(lambda: datagen.make_refine_batch(
    torch.Generator().manual_seed(3), mt, K, diam, batch=3, input_size={px}, mesh=mesh)))

b = np.load(tmp + "/refiner_batch.npz")
batch = {{k: torch.tensor(b[k]) for k in b.files}}
for recipe, okw in (("adam", {{}}), ("clip", dict(clip_norm=1e-3, max_consecutive_errors=2))):
    for kind, dm in (("one", None), ("sharded", mesh)):
        net = RefineNet()
        convert.load_flax_npz(tmp + "/refiner_params.npz", net)
        opt = training.Optimizer(net.parameters(), {lr}, **okw)
        data = batch if dm is None else pm.shard_batch(mesh, batch)
        losses = []
        for step in range({n_steps}):
            losses.append(float(training.refiner_train_step(net, opt, data, 0.2, mesh=dm)))
            if step == 0:
                out[f"dp_{{recipe}}_{{kind}}_grad"] = torch.cat(
                    [p.grad.reshape(-1) for p in net.parameters()]).numpy()
        out[f"dp_{{recipe}}_{{kind}}_losses"] = np.array(losses)
        out[f"dp_{{recipe}}_{{kind}}_params"] = torch.cat(
            [p.detach().reshape(-1) for p in net.parameters()]).numpy()
        if recipe == "adam" and kind == "one":
            flat = convert.state_dict_to_flax_params(net)
            out.update({{"dp_flax/" + k: v for k, v in flat.items()}})

# ---- the field step, rays sharded
from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner

f = np.load(tmp + "/field.npz")
fargs = (f["rgbs"], f["depths"], f["masks"], f["poses"], f["K"], f["occ"], 1.0, np.zeros(3))
for name, kw in {variants!r}.items():
    cfg = FieldConfig(**{field_cfg!r}, **kw)
    sd = torch.load(f"{{tmp}}/field_{{name}}.pt")
    runners = {{}}
    for kind, dm in (("one", None), ("sharded", mesh)):
        r = NeRFRunner(cfg, *fargs, device="cpu", device_mesh=dm)
        r.field.load_state_dict(sd)
        runners[kind] = r
        draws = {{k: torch.tensor(f[f"{{name}}_draws_{{k}}"]) for k in ("ids", "u_uniform", "u_depth")}}
        loss, aux = r.grads(draws)
        out[f"field_{{name}}_{{kind}}_loss"] = np.array(float(loss))
        for k, v in aux.items():
            out[f"field_{{name}}_{{kind}}_aux_{{k}}"] = np.array(float(v))
        out[f"field_{{name}}_{{kind}}_grad"] = torch.cat(
            [p.grad.reshape(-1) for p in r.field.parameters()]).numpy()
    # five steps each on the runner's own draws (one generator, seeded alike)
    for kind, r in runners.items():
        r.field.load_state_dict(sd)
        r._make_optimizers()
        out[f"field_{{name}}_{{kind}}_steps"] = np.array(
            [float(r.train_step()[0]) for _ in range({field_steps})])
cfg_odd = FieldConfig(**dict({field_cfg!r}, n_rand=33))
out["raises_field"] = np.array(raises(lambda: NeRFRunner(cfg_odd, *fargs, device="cpu",
                                                          device_mesh=mesh)))

# ---- multi-object tracking, objects sharded
from foundationpose_tpu_torch.engine.multi import MultiObjectTracker
from foundationpose_tpu_torch.engine.refiner import PoseRefiner, RefinerConfig

m = np.load(tmp + "/multi.npz")
objs = []
for i in range(4):
    o = meshio.Mesh(m[f"v{{i}}"], m[f"f{{i}}"])
    o.vertex_colors = m[f"c{{i}}"]
    objs.append(o)
refiner = PoseRefiner(RefinerConfig(input_size={px}, dtype="float32"), device="cpu")
for kind, dm in (("one", None), ("sharded", mesh)):
    tr = MultiObjectTracker(objs, refiner=refiner, device="cpu", device_mesh=dm)
    tr.set_poses(m["poses"])
    out[f"multi_{{kind}}_poses"] = tr.track(m["rgbs"], m["depths"], m["Ks"], iteration=2)
    out[f"multi_{{kind}}_n_mesh"] = np.array(len(tr.mesh_tensors))
out["raises_multi"] = np.array(raises(lambda: MultiObjectTracker(
    objs[:3], refiner=refiner, device="cpu", device_mesh=mesh)))

# ---- register's split work: preprocess and scorers
from foundationpose_tpu_torch.engine import estimator
from foundationpose_tpu_torch.engine.geometric import GeometricConfig, GeometricScorer, _geo_score
from foundationpose_tpu_torch.engine.scorer import HybridScorer, PoseScorer, ScorerConfig

s = np.load(tmp + "/register.npz")
Kr = torch.tensor(s["K"], dtype=torch.float32)
for tag, d in (("even", s["depth"]), ("odd", s["depth"][:119])):
    for kind, dm in (("one", None), ("sharded", mesh)):
        filtered, xyz_map = estimator.preprocess_depth(torch.tensor(d), Kr, dm)
        out[f"pre_{{tag}}_{{kind}}"] = torch.cat([filtered[None], xyz_map.permute(2, 0, 1)]).numpy()
obj = meshio.Mesh(s["verts"], s["faces"])
obj.vertex_colors = np.full((len(obj.vertices), 3), 180, np.uint8)
smt = raster.make_mesh_tensors(obj, max_faces=4096, bucket=True, device="cpu")
depth_f, xyz = estimator.preprocess_depth(torch.tensor(s["depth"]), Kr)
obs = (torch.tensor(s["rgb"], dtype=torch.float32), xyz, Kr)
poses = torch.tensor(s["hyp"])
sdiam = float(s["diameter"])
geo = GeometricScorer(GeometricConfig(input_size={px}), device="cpu")
learned = PoseScorer(ScorerConfig(input_size={px}, dtype="float32"), device="cpu")
hybrid = HybridScorer(learned)
for name, sc in (("geo", geo), ("learned", learned), ("hybrid", hybrid)):
    out[f"score_{{name}}_one"] = sc.score(smt, *obs, poses, sdiam).numpy()
    out[f"score_{{name}}_sharded"] = sc.score(smt, *obs, poses, sdiam, device_mesh=mesh).numpy()
# a slice scored without its halo, gathered: what the halo is for
per = poses.shape[0] // 2
naive = _geo_score(geo.cfg, smt, poses[rank * per:(rank + 1) * per], Kr, obs[0], xyz, sdiam)
out["score_geo_no_halo"] = pm.all_gather_rows(mesh, naive).numpy()
multihost.sync_hosts("done")
np.savez(f"{{tmp}}/rank{{rank}}.npz", **out)
print("RANK%d_OK" % rank, flush=True)
"""


def _refiner_inputs(tmp_path):
    """The JAX refiner's initial parameters and a global batch (as
    ``dryrun_multichip`` builds one), saved for the processes; returns the
    JAX package's losses and parameters after N_STEPS of its step."""
    net = JRefineNet(c_in=6, dtype=jnp.float32)
    params, tx, opt_state = jtraining.make_refiner_train_state(net, jax.random.PRNGKey(0),
                                                               input_size=PX, lr=LR)
    jagnostic.save_params_npz(str(tmp_path / "refiner_params.npz"), params, dtype=None)
    rng = np.random.default_rng(0)
    batch = {"A": rng.normal(size=(B_GLOBAL, PX, PX, 6)).astype(np.float32),
             "B": rng.normal(size=(B_GLOBAL, PX, PX, 6)).astype(np.float32),
             "trans_gt": rng.normal(size=(B_GLOBAL, 3)).astype(np.float32) * 0.01,
             "rot_gt": np.tile(np.eye(3, dtype=np.float32)[None], (B_GLOBAL, 1, 1))}
    np.savez(tmp_path / "refiner_batch.npz", **batch)
    params = jax.tree.map(np.asarray, params)  # the step donates its inputs
    runs = []
    for seed in (None, 1, 2):  # the run, and two from parameters 1e-7 off it
        p = jax.tree.map(jnp.asarray, params if seed is None else jax.tree.map(
            lambda a: a * (1 + 1e-7 * np.random.default_rng(seed).standard_normal(
                a.shape).astype(np.float32)), params))
        state, losses = tx.init(p), []
        for _ in range(N_STEPS):
            p, state, loss = jtraining.refiner_train_step(net, tx, p, state, batch)
            losses.append(float(loss))
        runs.append((np.array(losses), {
            "/".join(str(getattr(q, "key", q)) for q in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(p)[0]}))
    return runs


def _field_inputs(tmp_path):
    """``dryrun_multichip``'s field scene and, per variant, the JAX runner's
    parameters (saved for the processes as the port's state dict), JAX's
    draws for one step and that step's loss."""
    from foundationpose_tpu_torch.field.runner import FieldConfig, NeRFRunner
    from foundationpose_tpu_torch.models import convert

    H, W = FIELD_HW
    n = 2
    rgbs = np.full((n, H, W, 3), 0.5, np.float32)
    depths = np.full((n, H, W), 0.5, np.float32)
    masks = np.ones((n, H, W), np.uint8)
    poses = np.tile(np.eye(4)[None], (n, 1, 1))
    poses[:, 2, 3] = -0.5
    occ = np.random.default_rng(0).uniform(-0.3, 0.3, (64, 3))
    args = (rgbs, depths, masks, poses, FIELD_K, occ, 1.0, np.zeros(3))
    save = dict(rgbs=rgbs, depths=depths, masks=masks, poses=poses, K=FIELD_K, occ=occ)
    jloss = {}
    for name, kw in FIELD_VARIANTS.items():
        cfg = dict(FIELD_CFG, **kw)
        jr = NeRFRunnerTPU(JFieldConfig(**cfg), *args)
        pr = NeRFRunner(FieldConfig(**cfg), *args, device="cpu")
        sd = convert.field_params_to_state_dict(jax.device_get(jr.params), pr.field)
        torch.save(sd, tmp_path / f"field_{name}.pt")
        key = jax.random.PRNGKey(1)
        ids = np.random.default_rng(1).integers(0, jr.rays.shape[0], cfg["n_rand"])
        jr.tx = _grad_keeping_tx()
        jr.opt_state = jr.tx.init(jr.params)
        _, _, loss, _ = jr._make_train_step()(jr.params, jr.opt_state, key, jr.rays[ids])
        jloss[name] = float(loss)
        draws = _jax_draws(cfg, key)
        save[f"{name}_draws_ids"] = ids
        for k, v in draws.items():
            save[f"{name}_draws_{k}"] = v.numpy()
    np.savez(tmp_path / "field.npz", **save)
    return jloss


def _multi_inputs(tmp_path):
    """Four objects, each rendered into its own 48x64 stream a little off
    its start pose (the plain rasterizer)."""
    from foundationpose_tpu_torch.core import geometry as geo, meshio
    from foundationpose_tpu_torch.ops import raster

    objs = [meshio.make_box((0.08, 0.1, 0.06)), meshio.make_icosphere_mesh(2, 0.05),
            meshio.make_box((0.05, 0.04, 0.09)), meshio.make_icosphere_mesh(1, 0.04)]
    save = {}
    for i, o in enumerate(objs):
        o.vertex_colors = (np.abs(o.vertices) / np.abs(o.vertices).max() * 200 + 30).astype(
            np.uint8)
        save.update({f"v{i}": o.vertices, f"f{i}": o.faces, f"c{i}": o.vertex_colors})
    poses = np.tile(np.eye(4)[None], (4, 1, 1))
    poses[:, :3, 3] = [[0.01, 0.0, 0.5], [-0.02, 0.01, 0.55], [0.0, -0.01, 0.45],
                       [0.02, 0.02, 0.6]]
    poses[:, :3, :3] = geo.so3_exp_map(np.float32(
        [[0.3, -0.2, 0.1], [0.0, 0.4, -0.3], [-0.5, 0.1, 0.2], [0.2, 0.2, 0.2]])).numpy()
    rgbs, depths = [], []
    for o, p in zip(objs, poses):
        seen = p.copy()
        seen[:3, 3] += [0.004, -0.003, 0.006]
        r = raster.render_full_frame(raster.make_mesh_tensors(o, device="cpu"),
                                     seen[None].astype(np.float32), MULTI_K, (48, 64))
        rgbs.append(r["rgb"][0].numpy() * 255)
        depths.append(r["depth"][0].numpy())
    np.savez(tmp_path / "multi.npz", poses=poses, rgbs=np.stack(rgbs), depths=np.stack(depths),
             Ks=np.stack([MULTI_K] * 4), **save)


def _register_inputs(tmp_path):
    """The two-box object of tests/test_sharded_register.py rendered at
    120x160 with sensor holes, and 8 hypotheses around its pose; the cut's
    neighbours (3 and 4) sit on the object a few mm apart, so each has
    depth inliers and their crop windows see other holes."""
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
    depth = out["depth"][0].numpy()
    rng = np.random.default_rng(2)
    depth = np.where(rng.random(depth.shape) < 0.05, 0.0, depth).astype(np.float32)
    hyp = np.tile(gt[None], (8, 1, 1)).astype(np.float32)
    hyp[:, 0, 3] += np.array([0.03, 0.01, -0.04, 0.0, 0.004, 0.02, 0.0, -0.02])
    hyp[:, 2, 3] += np.array([-0.05, 0.02, 0.06, 0.0, 0.003, 0.01, 0.0, 0.0])
    diameter = meshio.compute_mesh_diameter(mesh=obj)
    np.savez(tmp_path / "register.npz", verts=verts, faces=faces, K=K,
             rgb=out["rgb"][0].numpy() * 255.0, depth=depth, hyp=hyp, diameter=diameter)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("programs")
    ref = {"refiner": _refiner_inputs(tmp), "field": _field_inputs(tmp)}
    _multi_inputs(tmp)
    _register_inputs(tmp)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp / "worker.py"
    script.write_text(_WORKER.format(
        root=ROOT, coord=f"localhost:{port}", px=PX, lr=LR, n_steps=N_STEPS,
        field_steps=FIELD_STEPS, field_cfg=FIELD_CFG, variants=FIELD_VARIANTS))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(tmp)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for rank, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"rank {rank} timed out")
        assert p.returncode == 0 and f"RANK{rank}_OK" in out, f"rank {rank} failed:\n{out}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)], ref


def test_shard_rows_and_all_reduce_grads(run):
    ranks, _ = run
    x = np.arange(8.0)[:, None] * np.ones(2)
    for r, out in enumerate(ranks):
        for halo in (1, 3, 5):
            lo, hi = out[f"lohi_h{halo}"]
            rows = out[f"rows_h{halo}"]
            # clipped at the ends: the first process has no rows before its slice
            assert (lo, hi) == ((0, min(halo, 4)) if r == 0 else (min(halo, 4), 0))
            np.testing.assert_array_equal(rows, x[4 * r - lo:4 * r + 4 + hi])
            np.testing.assert_array_equal(rows[lo:len(rows) - hi], x[4 * r:4 * r + 4])
            wrows = out[f"wrows_h{halo}"]
            assert tuple(out[f"wlohi_h{halo}"]) == (halo, halo)
            np.testing.assert_array_equal(wrows, x[np.arange(4 * r - halo, 4 * r + 4 + halo) % 8])
        np.testing.assert_array_equal(out["grad_w"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(out["grad_b"], np.zeros(2))
        assert int(out["grad_bytes"]) == 8 * 4
        assert bool(out["raises_shard_rows"])


def test_indivisible_batches_raise(run):
    for out in run[0]:
        assert bool(out["raises_datagen"]) and bool(out["raises_multi"])
        assert bool(out["raises_field"])


def test_dp_refiner_batch_is_the_slice_of_the_global_batch(run):
    for r, out in enumerate(run[0]):
        for k in ("A", "B", "trans_gt", "rot_gt"):
            full, mine = out[f"datagen_full_{k}"], out[f"datagen_mine_{k}"]
            assert mine.shape[0] == 2
            np.testing.assert_allclose(mine, full[2 * r:2 * r + 2], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("recipe", ["adam", "clip"])
def test_dp_refiner_step_matches_unsharded(run, recipe):
    """Three steps: losses at rtol 1e-5; step 1's all-reduced gradient within
    1e-5 x the gradient's norm of the single-process one (the order of
    summation differs). With ``clip`` the clip triggers (norm >> 1e-3): a
    clip of each process's own gradient would give another update."""
    ranks, _ = run
    for out in ranks:
        one, sh = (lambda k: out[f"dp_{recipe}_one_{k}"]), (lambda k: out[f"dp_{recipe}_sharded_{k}"])
        np.testing.assert_allclose(sh("losses"), one("losses"), rtol=1e-5)
        g = one("grad")
        if recipe == "clip":
            assert np.linalg.norm(g) > 10 * 1e-3
        assert np.abs(sh("grad") - g).max() <= 1e-5 * np.linalg.norm(g)
        # past step 1 Adam may move an entry whose gradient is rounding noise
        # by lr x its sign either way; all other entries agree closely
        d = np.abs(sh("params") - one("params"))
        assert d.max() <= 2 * N_STEPS * LR and np.mean(d > 1e-6) < 1e-3
    np.testing.assert_array_equal(ranks[0][f"dp_{recipe}_sharded_params"],
                                  ranks[1][f"dp_{recipe}_sharded_params"])


def test_dp_refiner_step_matches_jax(run):
    """The port's three steps on the global batch, unsharded and sharded,
    against the JAX package's ``refiner_train_step`` (``dryrun_multichip``
    holds its sharded step to it). Step 1 starts from the same parameters:
    loss at rtol 1e-4. Past it the trajectory is chaotic: Adam's first update
    is lr x sign(g), and float32 rounding of the GroupNorm-fed gradients (a
    few per cent of a leaf in either package, tests/test_torch_training.py)
    flips the sign of entries whose gradient is rounding noise. The JAX step
    itself, started from parameters 1e-7 (relative) off, moves its third loss
    by ~8e-4 relative. Gate: the port's losses and parameters are within
    1.5 x the widest distance between the JAX run and those two perturbed JAX
    runs, + 1e-4 relative (losses) / 1e-6 (parameters)."""
    ranks, ref = run
    (jl, jp), *perturbed = ref["refiner"]
    spread_l = np.max([np.abs(l - jl) for l, _ in perturbed], axis=0)
    spread_p = max(float(np.abs(q[k] - jp[k]).max()) for _, q in perturbed for k in jp)
    out = ranks[0]
    got = {k[len("dp_flax/"):]: v for k, v in out.items() if k.startswith("dp_flax/")}
    assert set(got) == set(jp)
    for kind in ("one", "sharded"):
        losses = out[f"dp_adam_{kind}_losses"]
        np.testing.assert_allclose(losses[0], jl[0], rtol=1e-4)
        assert (np.abs(losses - jl) <= 1.5 * spread_l + 1e-4 * np.abs(jl)).all(), (
            losses, jl, spread_l)
    d = max(float(np.abs(got[k] - jp[k]).max()) for k in jp)
    assert d <= 1.5 * spread_p + 1e-6, (d, spread_p)


@pytest.mark.parametrize("variant", list(FIELD_VARIANTS))
def test_sharded_field_step_matches_unsharded_and_jax(run, variant):
    ranks, ref = run
    for out in ranks:
        one = lambda k: out[f"field_{variant}_one_{k}"]  # noqa: E731
        sh = lambda k: out[f"field_{variant}_sharded_{k}"]  # noqa: E731
        assert np.isfinite(sh("loss"))
        np.testing.assert_allclose(sh("loss"), one("loss"), rtol=1e-4)
        np.testing.assert_allclose(sh("loss"), ref["field"][variant], rtol=1e-4)
        for k in ("rgb_loss", "fs_loss", "sdf_loss", "empty_loss", "valid_rays",
                  "valid_samples"):
            np.testing.assert_allclose(sh(f"aux_{k}"), one(f"aux_{k}"), rtol=1e-4, atol=1e-9,
                                       err_msg=k)
        g = one("grad")
        assert np.linalg.norm(g) > 0
        assert np.abs(sh("grad") - g).max() <= 1e-5 * np.linalg.norm(g)
        np.testing.assert_allclose(sh("steps"), one("steps"), rtol=1e-4)
    np.testing.assert_array_equal(ranks[0][f"field_{variant}_sharded_grad"],
                                  ranks[1][f"field_{variant}_sharded_grad"])


def test_sharded_multi_object_tracker_matches_unsharded(run):
    ranks, _ = run
    for out in ranks:
        assert int(out["multi_sharded_n_mesh"]) == 2 and int(out["multi_one_n_mesh"]) == 4
        assert np.isfinite(out["multi_sharded_poses"]).all()
        np.testing.assert_allclose(out["multi_sharded_poses"], out["multi_one_poses"], atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["multi_sharded_poses"], ranks[1]["multi_sharded_poses"])


def test_row_sharded_preprocess_bit_for_bit(run):
    for out in run[0]:
        for tag in ("even", "odd"):
            a, b = out[f"pre_{tag}_sharded"], out[f"pre_{tag}_one"]
            assert (b[0] > 0).any() and (b[0] == 0).any()  # holes and depth both present
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scorer", ["geo", "learned", "hybrid"])
def test_sharded_scorers_match_unsharded(run, scorer):
    for out in run[0]:
        one, sh = out[f"score_{scorer}_one"], out[f"score_{scorer}_sharded"]
        assert one.shape == (8,) and np.isfinite(sh).all()
        np.testing.assert_allclose(sh, one, atol=1e-5)


def test_geo_score_needs_its_halo(run):
    """At the cut (hypotheses 3 | 4) the observed validity of the two
    neighbours differs, so a slice scored alone scores its end entries
    otherwise; with the wrapped one-hypothesis halo they agree."""
    out = run[0][0]
    naive, one = out["score_geo_no_halo"], out["score_geo_one"]
    assert np.abs(naive[[3, 4]] - one[[3, 4]]).max() > 1e-4
