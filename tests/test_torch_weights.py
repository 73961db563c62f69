"""Port parity for the torch-checkpoint import (``models/weights.py``).

A reference-layout state dict (``fake_refine_sd`` / ``fake_score_sd``, with
and without BatchNorm: the layout and distributions of tests/test_weights.py,
but drawn from seeds that are a fixed function of each parameter's name —
tests/test_weights.py seeds with ``hash(prefix)``, which Python salts per
process) goes through the JAX package's import into its flax nets and through
the port's import into the port's nets; both forwards run the same numpy
inputs in float32 on the CPU.
Gate: atol 2e-4 + rtol 1e-3, as tests/test_torch_nets.py holds the nets.
``load_engine_params`` reads ``refiner.pth`` / ``scorer.pth``, the JAX
package's flax ``.msgpack`` files (exactly) and the port's engine checkpoint
file into an engine.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.models import weights as jweights
from foundationpose_tpu.models.refine_net import RefineNet as JRefineNet
from foundationpose_tpu.models.score_net import ScoreNetMultiPair as JScoreNet
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.engine.estimator import EstimatorConfig, FoundationPoseTorch
from foundationpose_tpu_torch.models import weights
from foundationpose_tpu_torch.models.refine_net import RefineNet
from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

torch.set_num_threads(1)
ATOL, RTOL = 2e-4, 1e-3


# ---- reference-layout fake state dicts, seeded by zlib.crc32 of the name


def _rng(prefix):
    return np.random.default_rng(zlib.crc32(prefix.encode()))


def _fake_conv(sd, prefix, cin, cout, k):
    rng = _rng(prefix)
    sd[f"{prefix}.weight"] = rng.normal(size=(cout, cin, k, k)).astype(np.float32) * 0.05
    sd[f"{prefix}.bias"] = rng.normal(size=(cout,)).astype(np.float32) * 0.05


def _fake_bn(sd, prefix, c):
    rng = _rng(prefix)
    sd[f"{prefix}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    sd[f"{prefix}.bias"] = rng.normal(size=c).astype(np.float32) * 0.1
    sd[f"{prefix}.running_mean"] = rng.normal(size=c).astype(np.float32) * 0.1
    sd[f"{prefix}.running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)


def _fake_linear(sd, prefix, cin, cout):
    rng = _rng(prefix)
    sd[f"{prefix}.weight"] = rng.normal(size=(cout, cin)).astype(np.float32) * 0.05
    sd[f"{prefix}.bias"] = rng.normal(size=(cout,)).astype(np.float32) * 0.05


def _fake_mha(sd, prefix, d):
    rng = _rng(prefix)
    sd[f"{prefix}.in_proj_weight"] = rng.normal(size=(3 * d, d)).astype(np.float32) * 0.05
    sd[f"{prefix}.in_proj_bias"] = np.zeros(3 * d, np.float32)
    _fake_linear(sd, f"{prefix}.out_proj", d, d)


def _fake_tf_layer(sd, prefix, d=512, ff=512):
    _fake_mha(sd, f"{prefix}.self_attn", d)
    _fake_linear(sd, f"{prefix}.linear1", d, ff)
    _fake_linear(sd, f"{prefix}.linear2", ff, d)
    for norm in ("norm1", "norm2"):
        sd[f"{prefix}.{norm}.weight"] = np.ones(d, np.float32)
        sd[f"{prefix}.{norm}.bias"] = np.zeros(d, np.float32)


def _fake_encoder_a(sd, prefix, c_in, bn):
    _fake_conv(sd, f"{prefix}.0.net.0", c_in, 64, 7)
    _fake_conv(sd, f"{prefix}.1.net.0", 64, 128, 3)
    if bn:
        _fake_bn(sd, f"{prefix}.0.net.1", 64)
        _fake_bn(sd, f"{prefix}.1.net.1", 128)
    for i in (2, 3):
        _fake_conv(sd, f"{prefix}.{i}.conv1", 128, 128, 3)
        _fake_conv(sd, f"{prefix}.{i}.conv2", 128, 128, 3)
        if bn:
            _fake_bn(sd, f"{prefix}.{i}.bn1", 128)
            _fake_bn(sd, f"{prefix}.{i}.bn2", 128)


def _fake_encoder_ab(sd, prefix, bn):
    for i in (0, 1):
        _fake_conv(sd, f"{prefix}.{i}.conv1", 256, 256, 3)
        _fake_conv(sd, f"{prefix}.{i}.conv2", 256, 256, 3)
        if bn:
            _fake_bn(sd, f"{prefix}.{i}.bn1", 256)
            _fake_bn(sd, f"{prefix}.{i}.bn2", 256)
    _fake_conv(sd, f"{prefix}.2.net.0", 256, 512, 3)
    if bn:
        _fake_bn(sd, f"{prefix}.2.net.1", 512)
    for i in (3, 4):
        _fake_conv(sd, f"{prefix}.{i}.conv1", 512, 512, 3)
        _fake_conv(sd, f"{prefix}.{i}.conv2", 512, 512, 3)
        if bn:
            _fake_bn(sd, f"{prefix}.{i}.bn1", 512)
            _fake_bn(sd, f"{prefix}.{i}.bn2", 512)


def fake_refine_sd(bn=False, c_in=6):
    sd = {}
    _fake_encoder_a(sd, "encodeA", c_in, bn)
    _fake_encoder_ab(sd, "encodeAB", bn)
    _fake_tf_layer(sd, "trans_head.0")
    _fake_linear(sd, "trans_head.1", 512, 3)
    _fake_tf_layer(sd, "rot_head.0")
    _fake_linear(sd, "rot_head.1", 512, 3)
    return sd


def fake_score_sd(bn=False, c_in=6):
    sd = {}
    _fake_encoder_a(sd, "encoderA", c_in, bn)
    _fake_encoder_ab(sd, "encoderAB", bn)
    _fake_mha(sd, "att", 512)
    _fake_mha(sd, "att_cross", 512)
    _fake_linear(sd, "linear", 512, 1)
    return sd


def test_fake_weights_do_not_depend_on_the_process():
    """Two interpreters with different string-hash salts draw the same fake
    weights (tests/test_weights.py's ``hash(prefix)`` seeds do not)."""
    import os
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, 'tests'); import test_torch_weights as t; "
            "print(float(t.fake_refine_sd(bn=True)['encodeAB.3.conv1.weight'].sum()))")
    outs = {subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                           cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           env={**os.environ, "PYTHONHASHSEED": str(seed)},
                           timeout=300).stdout.strip() for seed in (1, 2)}
    assert len(outs) == 1 and outs != {""}


def _inputs(n, px, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1, 1, (n, px, px, 6)).astype(np.float32)
    B = rng.uniform(-1, 1, (n, px, px, 6)).astype(np.float32)
    return A, B


@pytest.mark.parametrize("bn", [False, True])
def test_refine_import_matches_flax_forward(bn):
    sd = fake_refine_sd(bn=bn)
    A, B = _inputs(2, 64, seed=1)
    ref = JRefineNet(c_in=6, dtype=jnp.float32).apply(
        jax.tree.map(jnp.asarray, jweights.refine_params_from_torch(sd, use_bn=bn)), A, B)
    net = RefineNet(c_in=6, norm=None).eval()
    net.load_state_dict(weights.refine_state_dict(sd, net, use_bn=bn), strict=True)
    with torch.no_grad():
        out = net(torch.tensor(A), torch.tensor(B))
    for k in ("trans", "rot"):
        assert np.abs(np.asarray(ref[k])).max() > 1e-3  # not a trivially zero output
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("bn", [False, True])
def test_score_import_matches_flax_forward(bn):
    sd = fake_score_sd(bn=bn)
    A, B = _inputs(2, 64, seed=2)
    ref = np.asarray(JScoreNet(c_in=6, dtype=jnp.float32).apply(
        jax.tree.map(jnp.asarray, jweights.score_params_from_torch(sd, use_bn=bn)),
        A, B, 2)["score_logit"])
    net = ScoreNetMultiPair(c_in=6, norm=None).eval()
    net.load_state_dict(weights.score_state_dict(sd, net, use_bn=bn), strict=True)
    with torch.no_grad():
        out = net(torch.tensor(A), torch.tensor(B), 2)["score_logit"].numpy()
    assert out.shape == ref.shape == (1, 2)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind,bn", [("refiner", False), ("refiner", True),
                                     ("scorer", False), ("scorer", True)])
def test_load_weights_from_pth_matches_flax_forward(tmp_path, kind, bn):
    """One fake ``.pth`` through JAX ``load_{kind}_weights`` -> flax forward and
    through the port's (default-width net) -> torch forward; float32, the
    nets' gate (atol 2e-4 + rtol 1e-3)."""
    sd = fake_refine_sd(bn=bn) if kind == "refiner" else fake_score_sd(bn=bn)
    path = str(tmp_path / f"{kind}.pth")
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}}, path)
    A, B = _inputs(2, 64, seed=3)
    if kind == "refiner":
        params = jweights.load_refiner_weights(path, use_bn=bn)
        ref = JRefineNet(c_in=6, dtype=jnp.float32).apply(params, A, B)
        net = RefineNet(c_in=6).eval()
        net.load_state_dict(weights.load_refiner_weights(path, use_bn=bn), strict=True)
        with torch.no_grad():
            out = net(torch.tensor(A), torch.tensor(B))
        pairs = [(out[k].numpy(), np.asarray(ref[k])) for k in ("trans", "rot")]
    else:
        params = jweights.load_scorer_weights(path, use_bn=bn)
        ref = JScoreNet(c_in=6, dtype=jnp.float32).apply(params, A, B, 2)
        net = ScoreNetMultiPair(c_in=6).eval()
        net.load_state_dict(weights.load_scorer_weights(path, use_bn=bn), strict=True)
        with torch.no_grad():
            out = net(torch.tensor(A), torch.tensor(B), 2)
        pairs = [(out["score_logit"].numpy(), np.asarray(ref["score_logit"]))]
    for got, want in pairs:
        assert np.abs(want).max() > 1e-3  # not a trivially zero output
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_fold_bn_matches_jax():
    sd = fake_refine_sd(bn=True)
    a = weights._fold_bn(weights._conv(sd, "encodeA.0.net.0"), sd, "encodeA.0.net.1")
    b = jweights._fold_bn(jweights._conv(sd, "encodeA.0.net.0"), sd, "encodeA.0.net.1")
    for k in ("kernel", "bias"):
        assert np.array_equal(a[k], b[k])


def test_load_engine_params(tmp_path, caplog):
    torch.save({"model": {k: torch.tensor(v) for k, v in fake_refine_sd().items()}},
               tmp_path / "refiner.pth")
    torch.save({k: torch.tensor(v) for k, v in fake_score_sd().items()}, tmp_path / "scorer.pth")
    est = FoundationPoseTorch(meshio.make_box((0.1, 0.08, 0.05)), device="cpu",
                              config=EstimatorConfig(min_n_views=4, inplane_step=180))
    weights.load_engine_params(est, str(tmp_path))
    sd = weights.refine_state_dict(fake_refine_sd(), est.refiner.net)
    for k, v in est.refiner.net.state_dict().items():
        assert torch.equal(v, sd[k].to(v.dtype)), k
    w = est.scorer.net.state_dict()["linear.weight"]
    assert torch.equal(w, torch.tensor(fake_score_sd()["linear.weight"]).to(w.dtype))
    (tmp_path / "empty").mkdir()
    weights.load_engine_params(est, str(tmp_path / "empty"))  # warns, keeps the weights
    assert "no refiner weights" in caplog.text
    # flax-serialised parameters of the JAX package (``.msgpack``), read by
    # the port's own decoder, and an engine checkpoint file of the port
    from flax import serialization

    from foundationpose_tpu_torch.models import checkpoint, convert

    (tmp_path / "flax").mkdir()
    z = jnp.zeros((1, 32, 32, 6))
    jparams = {"refiner": JRefineNet(c_in=6, dtype=jnp.float32).init(jax.random.PRNGKey(1), z, z),
               "scorer": JScoreNet(c_in=6, dtype=jnp.float32).init(jax.random.PRNGKey(2), z, z, 1)}
    for name, p in jparams.items():
        (tmp_path / "flax" / f"{name}.msgpack").write_bytes(serialization.to_bytes(p))
    weights.load_engine_params(est, str(tmp_path / "flax"))
    for name, net in (("refiner", est.refiner.net), ("scorer", est.scorer.net)):
        flat = {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_flatten_with_path(jparams[name])[0]}
        want = convert.flax_params_to_state_dict(flat, net)
        for k, v in net.state_dict().items():
            assert torch.equal(v, want[k].to(v.dtype)), (name, k)
    path = str(tmp_path / "engine.pt")
    checkpoint.save_engine(est, path)
    est2 = FoundationPoseTorch(meshio.make_box((0.1, 0.08, 0.05)), device="cpu",
                               config=EstimatorConfig(min_n_views=4, inplane_step=180))
    weights.load_engine_params(est2, path)
    for a, b in zip(est.scorer.net.state_dict().values(), est2.scorer.net.state_dict().values()):
        assert torch.equal(a, b)
