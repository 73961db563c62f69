"""Port parity for the object-agnostic trainer and the formats that carry its
output: ``models/agnostic.py``, ``apps/train_agnostic.py``,
``models/checkpoint.py``, ``models/h5data.py`` and the harness's per-scene
training fallback.

- A checkpoint directory written by the port's ``save_agnostic`` (float16)
  is read by the JAX package's ``load_agnostic``; both packages' float32
  nets then give the same outputs on the same inputs within the nets' gate
  (atol 2e-4 + rtol 1e-3, as tests/test_torch_nets.py holds them).
- A ``train_agnostic_refiner`` run cut after two chunks and resumed from its
  snapshot ends bit for bit where the uncut run ends (parameters, Adam
  moments, step count, the losses after the cut), on the CPU.
- ``prepare_corpus`` keeps the JAX package's meshes, diameters and surface
  samples (bit for bit) and its two appearance groups; the chunk schedule is
  the JAX package's deterministic interleave.
- h5 archives written by either package read in the other, element for
  element.
- ``save_engine`` / ``load_engine`` round trip exactly; ``run_track
  --weights`` reads such a file.
- The harness's learned fallback (no agnostic checkpoint) trains a net pair
  per ``learned`` scene and writes the JAX package's block, key for key as
  ``ACCURACY_r04.json`` has it.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu.models import h5data as jh5data
from foundationpose_tpu.models.refine_net import RefineNet as JRefineNet
from foundationpose_tpu.models.score_net import ScoreNetMultiPair as JScoreNet
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch
from foundationpose_tpu_torch.engine.scorer import HybridScorer, PoseScorer, ScorerConfig
from foundationpose_tpu_torch.models import agnostic, checkpoint, convert, h5data
from foundationpose_tpu_torch.models.refine_net import RefineNet
from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[300.0, 0, 160.0], [0, 300.0, 120.0], [0, 0, 1.0]])
S = 32
ATOL, RTOL = 2e-4, 1e-3


def test_save_agnostic_reads_in_the_jax_package(tmp_path):
    net_r = convert.flax_init(RefineNet(), 1)
    net_s = convert.flax_init(ScoreNetMultiPair(norm="group", residual_attn=True), 2)
    agnostic.save_agnostic(str(tmp_path), net_r, net_s, {"input_size": S, "n_meshes": 1})
    with np.load(tmp_path / "refiner.npz") as z:
        assert {z[k].dtype for k in z.files} == {np.dtype(np.float16)}
    jref, jsco, meta = jagnostic.load_agnostic(str(tmp_path))
    assert meta["input_size"] == S
    pref, psco, _ = agnostic.load_agnostic(str(tmp_path), device="cpu")
    rng = np.random.default_rng(0)
    A = rng.uniform(0, 1, (4, S, S, 6)).astype(np.float32)
    B = rng.uniform(0, 1, (4, S, S, 6)).astype(np.float32)
    jr = JRefineNet(c_in=6, dtype=jnp.float32).apply(jref.params, A, B)
    js = JScoreNet(c_in=6, dtype=jnp.float32, norm="group",
                   residual_attn=True).apply(jsco.params, A, B, 4)
    with torch.no_grad():
        pr = pref.net.float()(torch.tensor(A), torch.tensor(B))
        ps = psco.net.float()(torch.tensor(A), torch.tensor(B), 4)
    for key in ("trans", "rot"):
        np.testing.assert_allclose(pr[key].numpy(), np.asarray(jr[key]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ps["score_logit"].numpy(), np.asarray(js["score_logit"]),
                               atol=ATOL, rtol=RTOL)
    # the port reads it back into nets equal to the float16-rounded originals
    for k, v in pref.net.state_dict().items():
        np.testing.assert_array_equal(v.float().numpy(),
                                      net_r.state_dict()[k].half().float().numpy())


@pytest.fixture(scope="module")
def corpus8():
    return agnostic.prepare_corpus(8, seed=7, max_faces=256, n_pts=64, device="cpu")


def test_prepare_corpus_matches_jax(corpus8):
    ref = jagnostic.prepare_corpus(8, seed=7, max_faces=256, n_pts=64)
    assert [p["textured"] for p in corpus8] == [p["textured"] for p in ref]
    assert {p["textured"] for p in corpus8} == {True, False}
    for p, r in zip(corpus8, ref):
        assert p["diameter"] == r["diameter"]
        np.testing.assert_array_equal(p["pts"].numpy(), r["pts"])
        np.testing.assert_array_equal(p["mesh"].vertices, r["mesh"].vertices)
        # each mesh keeps its own bucket: the JAX package pads every mesh of
        # the corpus to the largest; the real faces are the same
        f = p["mt"]["faces"].shape[0]
        assert f <= r["mt"]["faces"].shape[0]
        np.testing.assert_array_equal(p["mt"]["faces"].numpy(), np.asarray(r["mt"]["faces"])[:f])
    groups = agnostic._groups(corpus8)
    assert [g["n"] for g in groups] == [6, 2]
    sched = agnostic.chunk_schedule(groups, 100, 5)
    assert len(sched) == 20 and sched.count(1) == 5  # 6 : 2 interleaved


def _train(corpus8, **kw):
    return agnostic.train_agnostic_refiner(corpus8, K, steps=8, batch=2, input_size=S, chunk=2,
                                           seed=3, **kw)


def test_cut_and_resumed_refiner_run_equals_the_uncut_one(corpus8, tmp_path):
    snap = str(tmp_path / "resume_refiner.pt")
    calls = []
    net_u, stats_u = _train(corpus8, log_cb=lambda step, loss: calls.append(step))
    assert stats_u["steps"] == 8 and len(stats_u["chunk_means"]) == 4
    assert np.isfinite(stats_u["chunk_means"]).all() and calls[-1] == 8
    net_c, stats_c = _train(corpus8, resume_path=snap, ckpt_every=2, stop_after=2)
    assert stats_c["steps"] == 4 and os.path.exists(snap)  # cut after two chunks
    state = torch.load(snap, weights_only=True)
    assert state["done"] == 4 and int(state["opt"]["count"]) == 4
    net_r, stats_r = _train(corpus8, resume_path=snap, ckpt_every=2)
    assert not os.path.exists(snap)  # finished: the snapshot is removed
    assert stats_r["steps"] == 4  # only the chunks after the cut ran
    assert stats_r["chunk_means"] == stats_u["chunk_means"][2:]
    for (k, a), b in zip(net_u.state_dict().items(), net_r.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_agnostic_cli_writes_a_checkpoint_both_packages_read(tmp_path):
    from foundationpose_tpu_torch.apps import train_agnostic

    args = train_agnostic.build_parser().parse_args([])
    assert (args.n_meshes, args.corpus_seed, args.steps_refiner, args.steps_scorer, args.batch,
            args.n_hyp, args.input_size, args.lr_refiner, args.lr_scorer, args.max_faces,
            args.chunk, args.resume, args.device) == (40, 7, 20000, 10000, 32, 16, 160, 2e-4,
                                                       5e-4, 2048, 25, False, None)
    out = str(tmp_path / "agnostic")
    argv = ["--out", out, "--device", "cpu", "--n-meshes", "2", "--steps-refiner", "4",
            "--steps-scorer", "4", "--batch", "2", "--n-hyp", "3", "--input-size", str(S),
            "--chunk", "2", "--max-faces", "256"]
    meta = train_agnostic.main(argv)
    assert sorted(os.listdir(out)) == ["meta.json", "refiner.npz", "scorer.npz",
                                       "train_stats.json"]
    with open(os.path.join(out, "train_stats.json")) as f:
        stats = json.load(f)
    for net in ("refiner", "scorer"):
        assert stats[net]["steps"] == 4 and np.isfinite(stats[net]["loss_last"])
        assert meta[net]["loss_first"] == stats[net]["loss_first"]
    jagnostic.load_agnostic(out)
    ref1, _, _ = agnostic.load_agnostic(out, device="cpu")
    # --resume skips the finished refiner phase and keeps its weights
    meta2 = train_agnostic.main(argv + ["--resume"])
    assert meta2["refiner"] == meta["refiner"]
    ref2, _, _ = agnostic.load_agnostic(out, device="cpu")
    for a, b in zip(ref1.net.state_dict().values(), ref2.net.state_dict().values()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# engine checkpoints


def _engine(scorer=None):
    return FoundationPoseTorch(meshio.make_box((0.1, 0.08, 0.05)), device="cpu", scorer=scorer,
                               config=EstimatorConfig(min_n_views=4, inplane_step=180))


def test_save_and_load_engine_round_trip(tmp_path):
    src = _engine()
    with torch.no_grad():
        for p in list(src.refiner.net.parameters()) + list(src.scorer.net.parameters()):
            p.add_(0.01)
    path = str(tmp_path / "ckpt" / "engine.pt")
    checkpoint.save_engine(src, path)
    assert checkpoint.is_engine_checkpoint(path)
    dst = _engine()
    checkpoint.load_engine(dst, path)
    for a, b in ((src.refiner.net, dst.refiner.net), (src.scorer.net, dst.scorer.net)):
        for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), k
    # a HybridScorer saves and loads its learned half
    hyb = _engine(scorer=HybridScorer(PoseScorer(ScorerConfig(), device="cpu")))
    checkpoint.load_engine(hyb, path)
    assert torch.equal(hyb.scorer.net.linear.weight, src.scorer.net.linear.weight)
    with pytest.raises(ValueError, match="npz"):
        checkpoint.load_engine(dst, str(tmp_path))  # a directory: an orbax checkpoint
    (tmp_path / "junk.pt").write_bytes(b"not a checkpoint")
    assert not checkpoint.is_engine_checkpoint(str(tmp_path / "junk.pt"))


# ---------------------------------------------------------------------------
# h5 archives across the packages


def _pairs(rng, n, with_adds):
    b = {"A": rng.normal(size=(n, S, S, 6)).astype(np.float32),
         "B": rng.normal(size=(n, S, S, 6)).astype(np.float32),
         "trans_gt": rng.normal(size=(n, 3)).astype(np.float32),
         "rot_gt": rng.normal(size=(n, 3, 3)).astype(np.float32)}
    if with_adds:
        b["adds"] = rng.uniform(size=(n,)).astype(np.float32)
    return b


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_h5_archives_read_across_packages(tmp_path, writer, reader):
    wmod, rmod = (h5data, jh5data) if writer == "port" else (jh5data, h5data)
    path = str(tmp_path / "pairs.h5")
    rng = np.random.default_rng(0)
    batches = [_pairs(rng, 3, with_adds=True) for _ in range(2)]
    w = wmod.PairH5Writer(path, input_size=S)
    for b in batches:
        w.append(b)
    w.close()
    ds = rmod.PairH5Dataset(path)
    assert len(ds) == 6 and ds.input_size == S and ds.rot_normalizer == pytest.approx(0.349065850)
    got = ds.sample_batch(np.random.default_rng(1), 6)  # every sample, in order
    for k in ("A", "B", "trans_gt", "rot_gt", "adds"):
        want = np.concatenate([b[k] for b in batches])
        if k in ("A", "B"):
            want = want.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    ds.close()


def test_generate_dataset_and_prefetch_loader_on_the_cpu(tmp_path):
    mesh = meshio.make_box((0.08, 0.1, 0.06))
    mesh.vertex_colors = np.random.default_rng(0).integers(50, 220, (8, 3)).astype(np.uint8)
    Ks = np.array([[120.0, 0, 16], [0, 120.0, 16], [0, 0, 1]])
    path = h5data.generate_dataset(str(tmp_path / "gen.h5"), mesh, Ks, n_batches=2, batch=4,
                                   input_size=S, with_scores=True, device="cpu")
    ds = jh5data.PairH5Dataset(path)  # the JAX package reads what the port rendered
    assert len(ds) == 8
    b = ds.sample_batch(np.random.default_rng(0), 8)
    assert (b["adds"] >= 0).all() and np.abs(b["A"]).sum() > 0
    assert np.abs(b["trans_gt"]).max() <= 0.02 + 1e-6
    ds.close()
    with h5data.PrefetchLoader(path, batch_size=4, n_workers=2, prefetch=3, seed=0) as ld:
        got = [next(ld) for _ in range(3)]
    assert all(g["A"].shape == (4, S, S, 6) and g["A"].dtype == np.float32 for g in got)
    assert all(not t.is_alive() for t in ld._workers)


# ---------------------------------------------------------------------------
# the harness's per-scene training fallback


def _key_tree(d):
    return {k: _key_tree(v) for k, v in d.items()} if isinstance(d, dict) else None


def test_harness_learned_fallback_trains_per_scene(monkeypatch):
    from foundationpose_tpu_torch.evalsuite import harness, scenes

    # the quick suite holds no ``learned`` scene: one of the full suite's,
    # rendered at the quick suite's quarter resolution
    spec = [s for s in scenes.build_suite() if s.name == "box_gray"][0]
    assert spec.learned
    monkeypatch.setattr(scenes, "build_suite",
                        lambda quick=False: [dataclasses.replace(spec, n_register=1, n_track=2)])
    res = harness.run_accuracy(quick=True, modes=("learned",), agnostic_dir=None, learned_px=S,
                               learned_steps=(3, 3), hyp_grid=dict(min_n_views=4,
                                                                   inplane_step=180),
                               device="cpu")
    with open(os.path.join(ROOT, "ACCURACY_r04.json")) as f:
        ref = json.load(f)["modes"]["learned"]
    block = res["modes"]["learned"]
    assert block["meta"] == {"px": S, "steps": [3, 3]} and set(block) == set(ref)
    assert set(block["register"]) == set(ref["register"])
    for sched, got in block["register"].items():
        want = ref["register"][sched]
        assert set(got) == set(want)
        name = next(iter(want["scenes"]))
        assert _key_tree(got["scenes"][spec.name]) == _key_tree(want["scenes"][name])
        assert np.isfinite(got["scenes"][spec.name]["adds"]).all()
    want_track = ref["track"]["scenes"][next(iter(ref["track"]["scenes"]))]
    assert _key_tree(block["track"]["scenes"][spec.name]) == _key_tree(want_track)
    assert set(block["track"]) == set(ref["track"])
