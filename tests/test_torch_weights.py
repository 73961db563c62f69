"""Port parity for the torch-checkpoint import (``models/weights.py``).

A reference-layout state dict (``fake_refine_sd`` / ``fake_score_sd`` of
tests/test_weights.py, with and without BatchNorm) goes through the JAX
package's import into its flax nets and through the port's import into the
port's nets; both forwards run the same numpy inputs in float32 on the CPU.
Gate: atol 2e-4 + rtol 1e-3, as tests/test_torch_nets.py holds the nets.
``load_engine_params`` reads ``refiner.pth`` / ``scorer.pth``, the JAX
package's flax ``.msgpack`` files (exactly) and the port's engine checkpoint
file into an engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_weights import fake_refine_sd, fake_score_sd

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
