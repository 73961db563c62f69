"""Port parity for the training stack: ``models/training.py`` (losses,
gradients, the optimiser) and ``models/convert.py`` (both directions, the
flax-style initialiser) against the JAX package and optax.

Gates (float32, CPU):
- losses: 1e-4 relative;
- gradients: held against the exact gradient (the JAX package in float64).
  Parameters that feed a GroupNorm get gradients that largely cancel, so
  float32 rounding moves them by up to a few per cent of the leaf's largest
  entry in EITHER package (4.3 % seen for the JAX package's own float32
  gradient of the listwise scorer loss). Gate: the port's worst leaf (error
  over the leaf's largest entry) within 1.5x the JAX package's float32 worst
  leaf + 2e-3;
- optimiser: fed the SAME gradients as optax, five steps of each recipe
  agree on parameters, both moments and the counts within 1e-6 (relative to
  the parameter scale); the step with an injected NaN leaves parameters,
  moments and count exactly as they were, as optax's ``apply_if_finite``;
- converter round trip torch -> flax -> torch: exact, with the same keys and
  shapes as the flax nets' own trees;
- initialiser: each kernel's standard deviation within 10 % of flax's
  ``net.init`` (kernels of >= 1000 entries; sampling noise), biases 0, norm
  scales 1.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from foundationpose_tpu.core import meshio as jmeshio
from foundationpose_tpu.models import agnostic as jagnostic
from foundationpose_tpu.models import datagen as jdatagen
from foundationpose_tpu.models import training as jtraining
from foundationpose_tpu.models.refine_net import RefineNet as JRefineNet
from foundationpose_tpu.models.score_net import ScoreNetMultiPair as JScoreNet
from foundationpose_tpu.ops import raster as jraster
from foundationpose_tpu_torch.models import convert, training
from foundationpose_tpu_torch.models.refine_net import RefineNet
from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

torch.set_num_threads(1)
K = np.array([[120.0, 0, 16], [0, 120.0, 16], [0, 0, 1]])
S = 32


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _carry(tmp_path, jparams, net):
    path = str(tmp_path / "p.npz")
    jagnostic.save_params_npz(path, jparams, dtype=None)
    convert.load_flax_npz(path, net)
    return net


def _grads_as_flax(net):
    g = copy.deepcopy(net)
    for p, q in zip(g.parameters(), net.parameters()):
        p.data = q.grad.detach().clone()
    return convert.state_dict_to_flax_params(g)


def _exact_grads(jnet_cls, kw, jparams, batch, loss_fn):
    """The JAX package's gradient in float64: the reference both float32
    gradients are held against."""
    with jax.enable_x64():
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), jparams)
        b64 = {k: jnp.asarray(np.asarray(v), jnp.float64) for k, v in batch.items()}
        jnet = jnet_cls(c_in=6, dtype=jnp.float64, **kw)
        return _flat(jax.grad(lambda p: loss_fn(jnet, p, b64))(p64))


def _check_grads(net, jgrads, exact):
    got, ref = _grads_as_flax(net), _flat(jgrads)
    assert set(got) == set(ref) == set(exact)

    def worst(g):
        return max(float(np.abs(g[k] - exact[k]).max()) / max(float(np.abs(exact[k]).max()), 1e-12)
                   for k in exact)

    assert worst(got) <= 1.5 * worst(ref) + 2e-3, (worst(got), worst(ref))


@pytest.fixture(scope="module")
def box():
    mesh = jmeshio.make_box((0.08, 0.1, 0.06))
    mesh.vertex_colors = np.random.default_rng(0).integers(50, 220, (8, 3)).astype(np.uint8)
    return mesh, jraster.make_mesh_tensors(mesh), jmeshio.compute_mesh_diameter(mesh=mesh)


def test_refiner_loss_and_gradients_match_jax(tmp_path, box):
    mesh, jmt, diameter = box
    data = jdatagen.make_refine_batch(jax.random.PRNGKey(0), jmt, jnp.asarray(K, jnp.float32),
                                      diameter, batch=3, input_size=S)
    batch = {k: data[k] for k in ("A", "B", "trans_gt", "rot_gt")}
    jnet = JRefineNet(c_in=6, dtype=jnp.float32)
    jparams = jnet.init(jax.random.PRNGKey(1), batch["A"][:1], batch["B"][:1])
    loss_fn = lambda n, p, b: jtraining.refiner_loss(n, p, b, diameter)  # noqa: E731
    jloss, jgrads = jax.value_and_grad(lambda p: loss_fn(jnet, p, batch))(jparams)
    exact = _exact_grads(JRefineNet, {}, jparams, batch, loss_fn)
    net = _carry(tmp_path, jparams, RefineNet())
    tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
    for diam in (diameter, torch.tensor(diameter, dtype=torch.float32)):  # float / 0-d tensor
        net.zero_grad()
        loss = training.refiner_loss(net, tb, diam)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
        _check_grads(net, jgrads, exact)


@pytest.mark.parametrize("mode", ["listwise", "pairwise"])
def test_scorer_loss_and_gradients_match_jax(tmp_path, box, mode):
    mesh, jmt, diameter = box
    data = jdatagen.make_score_batch(jax.random.PRNGKey(2), jmt, jnp.asarray(K, jnp.float32),
                                     diameter, jnp.asarray(mesh.vertices, jnp.float32),
                                     n_hyp=4, input_size=S)
    batch = {k: data[k] for k in ("A", "B", "adds")}
    jnet = JScoreNet(c_in=6, dtype=jnp.float32, norm="group", residual_attn=True)
    jparams = jnet.init(jax.random.PRNGKey(3), batch["A"], batch["B"], 4)
    loss_fn = lambda n, p, b: jtraining.scorer_loss(n, p, b, mode=mode)  # noqa: E731
    jloss, jgrads = jax.value_and_grad(lambda p: loss_fn(jnet, p, batch))(jparams)
    exact = _exact_grads(JScoreNet, dict(norm="group", residual_attn=True), jparams, batch,
                         loss_fn)
    net = _carry(tmp_path, jparams, ScoreNetMultiPair(norm="group", residual_attn=True))
    loss = training.scorer_loss(net, {k: torch.tensor(np.asarray(v)) for k, v in batch.items()},
                                mode=mode)
    loss.backward()
    assert float(jloss) > 0
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    _check_grads(net, jgrads, exact)


# ---------------------------------------------------------------------------
# the optimiser against optax on the same gradients


def _tree(rng):
    return {"a": rng.normal(0, 0.5, (4, 3)).astype(np.float32),
            "b": rng.normal(0, 0.5, (7,)).astype(np.float32),
            "c": rng.normal(0, 0.5, (2, 2, 3)).astype(np.float32)}


def _recipes():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-2 * 0.02)
    tsched = training.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 5, 1e-2 * 0.02)
    chain = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    return {
        "adam": (optax.adam(3e-3), dict(lr=3e-3)),
        "clip_warmup_cosine": (chain, dict(lr=tsched, clip_norm=1.0)),
        "apply_if_finite": (optax.apply_if_finite(chain, max_consecutive_errors=200),
                            dict(lr=tsched, clip_norm=1.0, max_consecutive_errors=200)),
    }


def _inner_adam_state(state):
    """(count, mu, nu) of the ScaleByAdamState inside any of the recipes."""
    for s in jax.tree_util.tree_leaves(state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(s, "mu"):
            return int(s.count), s.mu, s.nu
    raise AssertionError("no adam state")


@pytest.mark.parametrize("recipe", ["adam", "clip_warmup_cosine", "apply_if_finite"])
def test_five_optimizer_steps_match_optax(recipe):
    rng = np.random.default_rng(4)
    params = _tree(rng)
    tx, kw = _recipes()[recipe]
    state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.tensor(params[k])) for k in "abc"]
    opt = training.Optimizer(tparams, **kw)
    scales = [0.1, 3.0, 0.5, 2.0, 0.05, 4.0]  # global norms below and above the clip
    nan_step = 3 if recipe == "apply_if_finite" else None
    for i, sc in enumerate(scales):
        grads = {k: (rng.normal(0, 1, v.shape) * sc).astype(np.float32) for k, v in params.items()}
        if i == nan_step:
            grads["b"][2] = np.nan
            before = ([p.detach().clone() for p in tparams], [m.clone() for m in opt.mu],
                      opt.count.clone())
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.tensor(grads[k]) for k in "abc"])
        count, mu, nu = _inner_adam_state(state)
        assert int(opt.count) == count
        for j, k in enumerate("abc"):
            np.testing.assert_allclose(tparams[j].detach().numpy(), np.asarray(params[k]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(opt.mu[j].numpy(), np.asarray(mu[k]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(opt.nu[j].numpy(), np.asarray(nu[k]), rtol=1e-6, atol=1e-7)
        if i == nan_step:
            assert int(state.notfinite_count) == 1 == int(opt.notfinite_count)
            assert torch.equal(opt.count, before[2])
            for p, q in zip(tparams, before[0]):
                assert torch.equal(p.detach(), q)
            for m, q in zip(opt.mu, before[1]):
                assert torch.equal(m, q)
        if recipe == "apply_if_finite" and i == nan_step + 1:
            assert int(state.notfinite_count) == 0 == int(opt.notfinite_count)
    if recipe == "apply_if_finite":
        assert int(opt.total_notfinite) == int(state.total_notfinite) == 1


def test_make_refiner_train_state_is_flax_init_and_optax_adam():
    """The port's train state: the net re-drawn by ``flax_init`` from the
    seed, and an optimiser that takes five steps as the JAX package's
    ``make_refiner_train_state`` optimiser (``optax.adam(lr)``) does from the
    same parameters on the same gradients (1e-6, as the recipes above)."""
    net, opt = training.make_refiner_train_state(RefineNet(c_in=6), 3, input_size=S, lr=1e-3)
    ref = convert.flax_init(RefineNet(c_in=6), 3)
    for (k, a), b in zip(net.state_dict().items(), ref.state_dict().values()):
        assert torch.equal(a, b), k
    _, tx, _ = jtraining.make_refiner_train_state(
        JRefineNet(c_in=6, dtype=jnp.float32), jax.random.PRNGKey(0), input_size=S, lr=1e-3)
    names = [n for n, _ in net.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    state = tx.init(params)
    rng = np.random.default_rng(6)
    for sc in (0.1, 3.0, 0.5, 2.0, 0.05):
        grads = {n: (rng.normal(0, 1, v.shape) * sc).astype(np.float32) for n, v in params.items()}
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.tensor(grads[n]) for n in names])
    count, mu, nu = _inner_adam_state(state)
    assert int(opt.count) == count == 5
    for j, (n, p) in enumerate(net.named_parameters()):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(opt.mu[j].numpy(), np.asarray(mu[n]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt.nu[j].numpy(), np.asarray(nu[n]), rtol=1e-6, atol=1e-7)


def test_apply_if_finite_gives_way_after_max_consecutive_errors():
    """Past ``max_consecutive_errors`` non-finite steps in a row the update
    is applied anyway (and poisons the parameters), as in optax."""
    rng = np.random.default_rng(5)
    params = _tree(rng)
    tx = optax.apply_if_finite(optax.adam(1e-3), max_consecutive_errors=2)
    state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.tensor(params[k])) for k in "abc"]
    opt = training.Optimizer(tparams, 1e-3, max_consecutive_errors=2)
    for i in range(3):
        grads = {k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
        grads["a"][0, 0] = np.inf
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.tensor(grads[k]) for k in "abc"])
        for j, k in enumerate("abc"):
            np.testing.assert_array_equal(np.isfinite(tparams[j].detach().numpy()),
                                          np.isfinite(np.asarray(params[k])))
    assert not np.isfinite(np.asarray(params["a"])).all()  # the third step went through
    assert int(opt.notfinite_count) == int(state.notfinite_count) == 3


def test_schedule_matches_optax():
    for args in ((0.0, 2e-4, 500, 20000, 4e-6), (0.0, 1e-3, 3, 10, 5e-5)):
        ref = optax.warmup_cosine_decay_schedule(*args)
        ours = training.warmup_cosine_decay_schedule(*args)
        for c in (0, 1, 2, 3, 4, 250, 499, 500, 501, 9, 10, 12000, 19999, 20000, 25000):
            np.testing.assert_allclose(float(ours(torch.tensor(c, dtype=torch.int32))),
                                       float(ref(jnp.asarray(c, jnp.int32))), rtol=1e-6,
                                       atol=1e-12)
    assert float(training.warmup_cosine_decay_schedule(0.0, 1.0, 5, 10)(
        torch.tensor(0, dtype=torch.int32))) == 0.0


# ---------------------------------------------------------------------------
# weights in both directions, and the initialiser


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_converter_round_trip_and_flax_tree(kind):
    if kind == "refiner":
        net, jnet = RefineNet(), JRefineNet(c_in=6, dtype=jnp.float32)
        jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 6)), jnp.zeros((1, S, S, 6)))
    else:
        net = ScoreNetMultiPair(norm="group", residual_attn=True)
        jnet = JScoreNet(c_in=6, dtype=jnp.float32, norm="group", residual_attn=True)
        jparams = jnet.init(jax.random.PRNGKey(0), jnp.zeros((2, S, S, 6)),
                            jnp.zeros((2, S, S, 6)), 2)
    convert.flax_init(net, seed=3)
    flat = convert.state_dict_to_flax_params(net)
    ref = _flat(jparams)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
    back = convert.flax_params_to_state_dict(flat, net)
    for k, v in net.state_dict().items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("kind", ["refiner", "scorer"])
def test_flax_init_matches_flax_statistics(kind):
    if kind == "refiner":
        net, jnet = RefineNet(), JRefineNet(c_in=6, dtype=jnp.float32)
        jparams = jnet.init(jax.random.PRNGKey(7), jnp.zeros((1, S, S, 6)), jnp.zeros((1, S, S, 6)))
    else:
        net = ScoreNetMultiPair(norm="group", residual_attn=True)
        jnet = JScoreNet(c_in=6, dtype=jnp.float32, norm="group", residual_attn=True)
        jparams = jnet.init(jax.random.PRNGKey(7), jnp.zeros((2, S, S, 6)),
                            jnp.zeros((2, S, S, 6)), 2)
    ours = convert.state_dict_to_flax_params(convert.flax_init(net, seed=0))
    ref = _flat(jparams)
    n_checked = 0
    for k, r in ref.items():
        o = ours[k]
        if k.endswith("/bias"):
            assert not r.any() and not o.any(), k
        elif k.endswith("/scale"):
            assert (r == 1).all() and (o == 1).all(), k
        else:
            fan_in = int(np.prod(r.shape[:-1]))
            assert np.abs(o).max() <= 2 * np.sqrt(1.0 / fan_in) / 0.8796 + 1e-6, k  # truncated at 2 sd
            if r.size >= 1000:
                n_checked += 1
                assert abs(o.std() / r.std() - 1) < 0.1, (k, o.std(), r.std())
                assert abs(o.std() * np.sqrt(fan_in) - 1) < 0.1, k
    assert n_checked >= 10
    # seeded: the same seed draws the same parameters
    again = convert.state_dict_to_flax_params(convert.flax_init(copy.deepcopy(net), seed=0))
    assert all(np.array_equal(again[k], ours[k]) for k in ours)


def test_train_steps_run_and_update(box):
    """One step of each kind moves the parameters and returns a finite loss
    that stays on the device."""
    mesh, jmt, diameter = box
    from foundationpose_tpu_torch.models import datagen
    from foundationpose_tpu_torch.ops import raster

    mt = raster.make_mesh_tensors(mesh, device="cpu")
    gen = torch.Generator().manual_seed(0)
    net = convert.flax_init(RefineNet(), 0)
    opt = training.Optimizer(net.parameters(), 1e-4)
    w0 = net.trans_out.weight.detach().clone()
    data = datagen.make_refine_batch(gen, mt, torch.tensor(K, dtype=torch.float32), diameter,
                                     batch=2, input_size=S)
    loss = training.refiner_train_step(net, opt, data, mesh_diameter=diameter)
    assert loss.ndim == 0 and torch.isfinite(loss) and not loss.requires_grad
    assert not torch.equal(w0, net.trans_out.weight)
    loss = training.refiner_train_step_multimesh(net, opt, data, torch.tensor(diameter))
    assert torch.isfinite(loss) and int(opt.count) == 2
    snet = convert.flax_init(ScoreNetMultiPair(norm="group", residual_attn=True), 0)
    sopt = training.Optimizer(snet.parameters(), 1e-4, clip_norm=1.0)
    sdata = datagen.make_score_batch(gen, mt, torch.tensor(K, dtype=torch.float32), diameter,
                                     torch.tensor(mesh.vertices, dtype=torch.float32), n_hyp=3,
                                     input_size=S)
    for mode in ("listwise", "pairwise"):
        assert torch.isfinite(training.scorer_train_step(snet, sopt, sdata, mode=mode))
