"""Port parity for the nets and for carrying weights across.

Seeded flax parameters are written with the JAX package's own
``save_params_npz`` (the flat ``"params/a/b/kernel"`` file format), read
with the port's ``flax_params_to_state_dict`` and both nets run the same
numpy inputs in float32 on the CPU. Gate: atol 2e-4 + rtol 1e-3 — float32
convolutions and matmuls summed in different orders through ~20 layers.
The shipped ``weights/agnostic`` checkpoint must load with no missing or
unexpected key and agree with the JAX package's ``load_agnostic``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu.models.refine_net import RefineNet as JRefineNet
from foundationpose_tpu.models.score_net import ScoreNetMultiPair as JScoreNet
from foundationpose_tpu_torch.models import convert
from foundationpose_tpu_torch.models.agnostic import load_agnostic
from foundationpose_tpu_torch.models.layers import regrid_positions, sinusoidal_positions
from foundationpose_tpu_torch.models.refine_net import RefineNet
from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

torch.set_num_threads(1)
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "weights", "agnostic")
ATOL, RTOL = 2e-4, 1e-3


def _inputs(n, px, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(0, 1, (n, px, px, 6)).astype(np.float32)
    B = rng.uniform(0, 1, (n, px, px, 6)).astype(np.float32)
    A[..., 3:] = A[..., 3:] * 2 - 1
    B[..., 3:] = B[..., 3:] * 2 - 1
    return A, B


def _carry_across(tmp_path, jparams, net):
    path = str(tmp_path / "params.npz")
    jagnostic.save_params_npz(path, jparams, dtype=None)
    convert.load_flax_npz(path, net)
    return net.eval()


@pytest.mark.parametrize("rot_rep,px", [("axis_angle", 160), ("axis_angle", 64), ("6d", 64)])
def test_refine_net_forward_parity(tmp_path, rot_rep, px):
    jnet = JRefineNet(rot_rep=rot_rep, norm=None, dtype=jnp.float32)
    A, B = _inputs(2, px, seed=1)
    jparams = jnet.init(jax.random.PRNGKey(3), A[:1], B[:1])
    ref = jnet.apply(jparams, A, B)
    net = _carry_across(tmp_path, jparams, RefineNet(rot_rep=rot_rep, norm=None))
    with torch.no_grad():
        out = net(torch.tensor(A), torch.tensor(B))
    for k in ("trans", "rot"):
        assert out[k].dtype == torch.float32
        assert np.abs(np.asarray(ref[k])).max() > 1e-3  # not a trivially zero output
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=RTOL)
    assert out["rot"].shape == (2, 3 if rot_rep == "axis_angle" else 6)


@pytest.mark.parametrize("norm,residual,px", [("group", True, 160), ("group", True, 64),
                                              (None, False, 64)])
def test_score_net_forward_parity(tmp_path, norm, residual, px):
    jnet = JScoreNet(norm=norm, dtype=jnp.float32, residual_attn=residual)
    A, B = _inputs(2, px, seed=2)
    jparams = jnet.init(jax.random.PRNGKey(4), A, B, 2)
    ref = np.asarray(jnet.apply(jparams, A, B, 2)["score_logit"])
    net = _carry_across(tmp_path, jparams, ScoreNetMultiPair(norm=norm, residual_attn=residual))
    with torch.no_grad():
        out = net(torch.tensor(A), torch.tensor(B), 2)["score_logit"].numpy()
    assert out.shape == ref.shape == (1, 2)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_flat_pos_grid_mode_slices_the_table():
    jnet = JRefineNet(norm=None, dtype=jnp.float32, pos_grid_mode="flat")
    A, B = _inputs(1, 64, seed=5)
    jparams = jnet.init(jax.random.PRNGKey(0), A, B)
    net = RefineNet(norm=None, pos_grid_mode="flat")
    flat = {"/".join(str(getattr(p, "key", p)) for p in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    net.load_state_dict(convert.flax_params_to_state_dict(flat, net))
    with torch.no_grad():
        out = net.eval()(torch.tensor(A), torch.tensor(B))
    ref = jnet.apply(jparams, A, B)
    np.testing.assert_allclose(out["trans"].numpy(), np.asarray(ref["trans"]), atol=ATOL, rtol=RTOL)


def test_positional_tables_equal():
    from foundationpose_tpu.models import layers as jlayers

    pe = sinusoidal_positions(400, 512)
    np.testing.assert_array_equal(pe, jlayers.sinusoidal_positions(400, 512))
    np.testing.assert_array_equal(
        regrid_positions(pe, (20, 20), (8, 8)), jlayers.regrid_positions(pe, (20, 20), (8, 8))
    )


def test_convert_rejects_wrong_trees():
    net = RefineNet(norm=None)
    good = {k: v.numpy() for k, v in net.state_dict().items()}
    flat = {}
    for k, v in good.items():
        parts = k.split(".")
        leaf = "bias" if parts[-1] == "bias" else ("scale" if "norm" in parts[-2] else "kernel")
        if leaf == "kernel":
            v = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v.T
        flat["params/" + "/".join(parts[:-1] + [leaf])] = v
    sd = convert.flax_params_to_state_dict(flat, net)  # the inverse map round-trips
    for k in good:
        np.testing.assert_array_equal(sd[k].numpy(), good[k])
    missing = dict(flat)
    missing.pop("params/rot_out/bias")
    with pytest.raises(KeyError, match="missing"):
        convert.flax_params_to_state_dict(missing, net)
    extra = dict(flat)
    extra["params/encodeA/conv0/GroupNorm_0/scale"] = np.ones(64, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        convert.flax_params_to_state_dict(extra, net)
    bad = dict(flat)
    bad["params/rot_out/bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.flax_params_to_state_dict(bad, net)


def test_shipped_checkpoint_loads_and_agrees_with_jax():
    """``load_state_dict(strict=True)`` inside the loader proves there is no
    missing or unexpected key. One forward at 64 px (regridded positions):
    float32 flax nets with the JAX loader's parameters within the float32
    gate; the JAX loader's own bf16 nets within 5e-2 absolute, bf16 carrying
    8 mantissa bits through ~20 layers."""
    refiner, scorer, meta = load_agnostic(WEIGHTS, device="cpu", input_size=64)
    jrefiner, jscorer, jmeta = jagnostic.load_agnostic(WEIGHTS, input_size=64)
    assert meta == jmeta and meta["input_size"] == 160
    assert refiner.cfg.dtype == "float32" and refiner.cfg.input_size == 64
    assert scorer.cfg.norm == "group" and scorer.cfg.residual_attn
    for name, net in (("refiner.npz", refiner.net), ("scorer.npz", scorer.net)):
        with np.load(os.path.join(WEIGHTS, name)) as f:
            assert len(f.files) == len(net.state_dict())
    A, B = _inputs(2, 64, seed=7)
    with torch.no_grad():
        out_r = refiner.net(torch.tensor(A), torch.tensor(B))
        out_s = scorer.net(torch.tensor(A), torch.tensor(B), 2)["score_logit"].numpy()
    ref_r = JRefineNet(norm=None, dtype=jnp.float32).apply(jrefiner.params, A, B)
    ref_s = JScoreNet(norm="group", residual_attn=True, dtype=jnp.float32).apply(
        jscorer.params, A, B, 2)["score_logit"]
    for k in ("trans", "rot"):
        np.testing.assert_allclose(out_r[k].numpy(), np.asarray(ref_r[k]), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out_s, np.asarray(ref_s), atol=ATOL, rtol=RTOL)
    bf_r = jrefiner.net.apply(jrefiner.params, A, B)
    bf_s = jscorer.net.apply(jscorer.params, A, B, 2)["score_logit"]
    for k in ("trans", "rot"):
        np.testing.assert_allclose(out_r[k].numpy(), np.asarray(bf_r[k]), atol=5e-2)
    np.testing.assert_allclose(out_s, np.asarray(bf_s), atol=5e-2, rtol=5e-2)


def test_bf16_forward_close_to_float32():
    """The card runs the nets in bfloat16 with float32 parameters cast at
    use; on the CPU the same module in bf16 stays within bf16's reach of its
    float32 self (5e-2 absolute on O(0.1-1) outputs)."""
    refiner, _, _ = load_agnostic(WEIGHTS, device="cpu", input_size=64)
    A, B = _inputs(2, 64, seed=8)
    with torch.no_grad():
        f32 = refiner.net(torch.tensor(A), torch.tensor(B))
        refiner.net.dtype = torch.bfloat16
        bf16 = refiner.net(torch.tensor(A), torch.tensor(B))
    for k in ("trans", "rot"):
        assert bf16[k].dtype == torch.float32
        assert (bf16[k] - f32[k]).abs().max() < 5e-2
    assert all(p.dtype == torch.float32 for p in refiner.net.parameters())
