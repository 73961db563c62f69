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
- ``train_agnostic_scorer(dtype=torch.bfloat16)`` runs ScoreNet's compute
  in bf16 and stays within bf16's own spread of the JAX package's bf16 run
  on the same draws (float32 parameters); its net's every layer puts out the
  dtype the JAX bf16 module's does, and its first block lies nearer JAX's
  bf16 activations than float32 does by more than ten times.
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

import jax
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


BF16_STEPS, BF16_LR, BF16_HYP = 20, 2e-6, 4


def _score_batches(n):
    rng = np.random.default_rng(21)
    return [{"A": rng.uniform(-1, 1, (BF16_HYP, S, S, 6)).astype(np.float32),
             "B": rng.uniform(-1, 1, (BF16_HYP, S, S, 6)).astype(np.float32),
             "adds": rng.uniform(0.001, 0.05, (BF16_HYP,)).astype(np.float32)}
            for _ in range(n)]


def _port_scorer_run(monkeypatch, prepped, batches, dtype, chunk=5):
    """``train_agnostic_scorer`` fed ``batches`` in order for its draws;
    returns (net, per-step losses)."""
    from foundationpose_tpu_torch.models import datagen, training

    it, losses = iter(batches), []
    step = training.scorer_train_step
    monkeypatch.setattr(datagen, "make_score_batch",
                        lambda *a, **k: {key: torch.tensor(v) for key, v in next(it).items()})
    monkeypatch.setattr(training, "scorer_train_step",
                        lambda *a, **k: losses.append(step(*a, **k)) or losses[-1])
    net, stats = agnostic.train_agnostic_scorer(prepped, K, steps=len(batches),
                                                n_hyp=BF16_HYP, input_size=S, lr=BF16_LR,
                                                seed=0, chunk=chunk, dtype=dtype)
    assert stats["steps"] == len(batches)
    return net, np.array([float(x) for x in losses])


def _update_rel(net, ref_sd, init):
    """|| (net - init) - (ref - init) || / || ref - init || over every parameter."""
    num = den = 0.0
    for k, v in net.state_dict().items():
        d, r = v.float() - init[k], ref_sd[k].float() - init[k]
        num += float(((d - r) ** 2).sum())
        den += float((r ** 2).sum())
    return (num / den) ** 0.5


def test_bf16_scorer_run_matches_jax_bf16_on_the_same_draws(monkeypatch, tmp_path):
    """``train_agnostic_scorer(dtype=torch.bfloat16)`` against the JAX
    package's ``dtype=jnp.bfloat16`` recipe (warmup-cosine, clip 1, adam,
    apply_if_finite) from the same initial parameters on the same 20 batches
    (a small lr keeps the random-data run out of its chaotic regime). bf16
    rounds otherwise in XLA's CPU convolutions and in oneDNN's, as much as
    bf16 differs from float32 in either package (both ~1 % per loss, 0.11-0.13
    of the parameter update's norm on this case). Gate: every step's loss
    within 5 % relative, the parameter update within 0.2 of its norm; the
    parameters stay float32, and the bf16 run is not the float32 one."""
    import optax

    from foundationpose_tpu.models import training as jtraining

    prepped = agnostic.prepare_corpus(2, seed=7, max_faces=256, n_pts=64, device="cpu")
    batches = _score_batches(BF16_STEPS)
    net_b, loss_b = _port_scorer_run(monkeypatch, prepped, batches, torch.bfloat16)
    net_f, _ = _port_scorer_run(monkeypatch, prepped, batches, torch.float32)
    assert all(p.dtype == torch.float32 for p in net_b.parameters())

    init = convert.flax_init(ScoreNetMultiPair(c_in=6, norm="group", residual_attn=True), 0)
    path = str(tmp_path / "init.npz")
    agnostic.save_params_npz(path, init, dtype=None)
    jnet = JScoreNet(c_in=6, dtype=jnp.bfloat16, norm="group", residual_attn=True)
    z = jnp.zeros((2, S, S, 6))
    params = jagnostic.load_params_npz(path, jnet.init(jax.random.PRNGKey(0), z, z, 2))
    sched = optax.warmup_cosine_decay_schedule(
        0.0, BF16_LR, min(500, max(BF16_STEPS // 20, 1)), BF16_STEPS, BF16_LR * 0.02)
    tx = optax.apply_if_finite(optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched)),
                               max_consecutive_errors=200)
    state, jloss = tx.init(params), []
    for b in batches:
        params, state, loss = jtraining.scorer_train_step(jnet, tx, params, state, b)
        jloss.append(float(loss))
    np.testing.assert_allclose(loss_b, jloss, rtol=5e-2)
    flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    jsd = convert.flax_params_to_state_dict(flat, net_b)
    i0 = {k: v.float() for k, v in init.state_dict().items()}
    assert _update_rel(net_b, jsd, i0) < 0.2
    assert _update_rel(net_b, net_f.state_dict(), i0) > 0.02


def _port_activations(net, A, B, L):
    """{module name: output} of every sub-module of ``net`` in one forward."""
    out, hooks = {}, []
    for name, mod in net.named_modules():
        if name:
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: out.__setitem__(name, o)))
    with torch.no_grad():
        net(torch.tensor(A), torch.tensor(B), L)
    for h in hooks:
        h.remove()
    return out


def _jax_activations(path, dtype, A, B, L):
    """{module path joined by '.': output} of every sub-module of the JAX
    scorer built with ``dtype`` on the parameters saved at ``path``, run
    op by op (a jit program's fusions round fewer times)."""
    jnet = JScoreNet(c_in=6, dtype=dtype, norm="group", residual_attn=True)
    z = jnp.zeros((2, S, S, 6))
    params = jagnostic.load_params_npz(path, jnet.init(jax.random.PRNGKey(0), z, z, 2))
    _, state = jnet.apply(params, A, B, L, capture_intermediates=True)
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if k == "__call__":
                if prefix:  # the root's output is the net's result dict
                    out[".".join(prefix)] = v[0]
            else:
                walk(v, prefix + [k])

    walk(state["intermediates"], [])
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_scorer_rounds_where_the_jax_bf16_scorer_does(monkeypatch, tmp_path):
    """The net ``train_agnostic_scorer(dtype=torch.bfloat16)`` returns,
    against the JAX scorer built with ``dtype=jnp.bfloat16`` on the same
    parameters, one forward on the same crops, layer by layer (the flax
    module paths are the port's module names). Every layer's output has the
    JAX layer's dtype (bf16 everywhere, the logits float32), so no layer is
    cast where JAX does not cast. In the first block (``encoderA.conv0``:
    conv, group norm, activation), before the two packages' rounding drifts
    apart, the port lies within 4e-4 of JAX's bf16 activations, and JAX's
    own float32 run more than six times that away: the gate was set from
    the port's reading there, 1.2e-4-1.6e-4, and float32's, 2.7e-3-3.2e-3.
    A float32 run, or norm statistics taken in bf16, fails there. Deeper layers are not gated:
    XLA's fusions round fewer times than eager kernels, and the packages
    part within bf16's own spread."""
    prepped = agnostic.prepare_corpus(2, seed=7, max_faces=256, n_pts=64, device="cpu")
    batches = _score_batches(3)
    net, _ = _port_scorer_run(monkeypatch, prepped, batches[:2], torch.bfloat16, chunk=2)
    path = str(tmp_path / "trained.npz")
    agnostic.save_params_npz(path, net, dtype=None)
    A, B = batches[2]["A"], batches[2]["B"]
    port = _port_activations(net, A, B, BF16_HYP)
    jb = _jax_activations(path, jnp.bfloat16, A, B, BF16_HYP)
    jf = _jax_activations(path, jnp.float32, A, B, BF16_HYP)
    tensors = {k: v for k, v in port.items() if isinstance(v, torch.Tensor)}
    assert set(tensors) == set(jb), set(tensors) ^ set(jb)
    for name, v in tensors.items():
        assert str(v.dtype).split(".")[-1] == str(jb[name].dtype), name
    assert port["linear"].dtype == torch.bfloat16
    first = [k for k in tensors if k.startswith("encoderA.conv0")]
    assert len(first) == 3, first
    for name in first:
        p = tensors[name].float().permute(0, 2, 3, 1).numpy()  # NCHW -> NHWC
        f = np.asarray(jf[name], np.float32)
        gap = _rel(np.asarray(jb[name], np.float32), f)
        assert _rel(p, np.asarray(jb[name], np.float32)) < 4e-4 < gap / 6, (name, gap)


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
