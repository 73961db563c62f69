"""Port parity for the neural object field's modules: ``field/encoders.py``,
``ops/hashgrid.py``, ``field/nerf.py``, ``field/sampling.py``,
``field/losses.py``, ``field/bounds.py`` and ``field/meshing.py`` against the
JAX package on the same numpy inputs, on the CPU.

Gates (float32):
- ``sh_encode``, ``freq_encode``, the triplane forward: 1e-6;
- triplane plane gradients 1e-5, point gradients 1e-4 against JAX's
  ``custom_vjp``; the analytic backward against autograd of the plain
  forward (1e-5 / 1e-4), and its double backward against autograd's (1e-5
  relative + 1e-4);
- hash grid forward 1e-6 and table gradient 1e-5, at a dense level and at a
  level whose hash wraps around 2^32;
- ``ObjectField`` with the JAX parameters carried across: ``query``, ``sdf``
  and ``pose_corrections`` within 1e-5;
- sampling with the JAX package's ``jax.random`` draws fed in: 1e-6
  relative to the depth range; losses 1e-6 relative;
- bounds: ``sc_factor`` and translation 1e-6, the same cluster size;
  ``biggest_cluster`` equal to sklearn's DBSCAN; marching tetrahedra bit for
  bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_field import _sphere_scene

from foundationpose_tpu.field import bounds as jbounds
from foundationpose_tpu.field import encoders as jenc
from foundationpose_tpu.field import losses as jlosses
from foundationpose_tpu.field import meshing as jmeshing
from foundationpose_tpu.field import sampling as jsampling
from foundationpose_tpu.field.nerf import ObjectField as JObjectField
from foundationpose_tpu.ops import hashgrid as jhash
from foundationpose_tpu_torch.field import bounds, encoders, losses, meshing, sampling
from foundationpose_tpu_torch.field.nerf import ObjectField
from foundationpose_tpu_torch.models import convert
from foundationpose_tpu_torch.ops import hashgrid

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# encoders


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_encode_matches_jax(degree):
    d = np.random.default_rng(degree).normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jenc.sh_encode(jnp.asarray(d), degree))
    np.testing.assert_allclose(encoders.sh_encode(_t(d), degree).numpy(), ref, atol=1e-6)


def test_freq_encode_matches_jax():
    x = np.random.default_rng(0).uniform(-1.2, 1.2, (64, 3)).astype(np.float32)
    for incl in (True, False):
        ref = np.asarray(jenc.freq_encode(jnp.asarray(x), 4, include_input=incl))
        out = encoders.freq_encode(_t(x), 4, include_input=incl).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
        assert out.shape[-1] == encoders.freq_out_dim(4, include_input=incl)


RES, C = (8, 16, 32), 3


def _triplane_inputs(seed=0, n=96):
    rng = np.random.default_rng(seed)
    planes = tuple(rng.normal(0, 0.1, (3, R + 1, R + 1, C)).astype(np.float32) for R in RES)
    pts = rng.uniform(-0.97, 0.97, (n, 3)).astype(np.float32)
    # the edges: a point on the box, one outside it, exact grid lines
    pts[0] = [1.0, -1.0, 0.0]
    pts[1] = [1.2, 0.5, -1.3]
    pts[2] = [0.5, -0.5, 0.25]
    g = rng.normal(0, 1, (n, len(RES) * C)).astype(np.float32)
    return planes, pts, g


def test_triplane_forward_matches_jax():
    planes, pts, _ = _triplane_inputs()
    ref = np.asarray(jenc._triplane_eval(tuple(map(jnp.asarray, planes)), jnp.asarray(pts),
                                         RES, C))
    out = encoders.triplane_eval(tuple(map(_t, planes)), _t(pts), RES, C)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)


def test_triplane_grads_match_jax_custom_vjp():
    """Plane and point gradients of the port's ``_TriplaneEval`` against the
    JAX package's analytic VJP (both sides' own backward)."""
    planes, pts, g = _triplane_inputs(1)

    def f(pl, p):
        return (jenc._triplane_eval(pl, p, RES, C) * g).sum()

    gp_j, gx_j = jax.grad(f, argnums=(0, 1))(tuple(map(jnp.asarray, planes)), jnp.asarray(pts))
    tp = [_t(p).requires_grad_(True) for p in planes]
    tx = _t(pts).requires_grad_(True)
    (encoders.triplane_eval(tp, tx, RES, C) * _t(g)).sum().backward()
    for a, b in zip(tp, gp_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx_j), atol=1e-4)


def test_triplane_custom_backward_matches_autograd():
    """The analytic backward against autograd of the same forward (mirror of
    tests/test_field.py::test_triplane_custom_vjp_matches_autodiff)."""
    planes, pts, g = _triplane_inputs(2)
    pts = pts[3:]  # away from the box's faces, where the derivative taps are one-sided
    g = g[3:]
    grads = []
    for fn in (encoders.triplane_eval, encoders.triplane_forward):
        tp = [_t(p).requires_grad_(True) for p in planes]
        tx = _t(pts).requires_grad_(True)
        (fn(tp, tx, RES, C) * _t(g)).sum().backward()
        grads.append(([p.grad for p in tp], tx.grad))
    for a, b in zip(grads[0][0], grads[1][0]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(), atol=1e-4)


def test_triplane_double_backward_matches_autograd():
    """A loss on the point gradient (the eikonal term) differentiated again:
    through the custom backward it is finite and equals autograd's double
    backward of the plain forward."""
    planes, pts, _ = _triplane_inputs(3)
    pts = pts[3:]
    w = _t(np.random.default_rng(4).normal(0, 1, len(RES) * C).astype(np.float32))
    out = []
    for fn in (encoders.triplane_eval, encoders.triplane_forward):
        tp = [_t(p).requires_grad_(True) for p in planes]
        tx = _t(pts).requires_grad_(True)
        s = (fn(tp, tx, RES, C) * w).sum()
        gx = torch.autograd.grad(s, tx, create_graph=True)[0]
        ((gx.norm(dim=-1) - 1.0) ** 2).sum().backward()
        out.append(([p.grad for p in tp], tx.grad))
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4)
    assert torch.isfinite(out[0][1]).all()
    # second derivatives along the points scale with R^2 (~1e3 here)
    np.testing.assert_allclose(out[0][1].numpy(), out[1][1].numpy(), rtol=1e-5, atol=1e-4)


def test_axis_taps_mirror_the_float32_clamp():
    """``min(g, R - 1e-6)`` is float32: for R >= 32 it is R itself, so a
    point at 1 takes tap i0 = R with weight 1 (the JAX one-hot rows)."""
    for R in (16, 32, 128):
        x = torch.tensor([0.0, 0.5, 1.0])
        i0, f = encoders._axis_taps(x, R)
        rows = np.asarray(jenc._axis_taps(jnp.asarray(x.numpy()), R))
        for n in range(3):
            want = np.zeros(R + 1, np.float32)
            want[i0[n]] += 1 - f[n].item()
            if i0[n] + 1 <= R:
                want[i0[n] + 1] += f[n].item()
            np.testing.assert_array_equal(want, rows[n])
    assert encoders._axis_taps(torch.tensor([1.0]), 128)[0].item() == 128


# ---------------------------------------------------------------------------
# hash grid


def test_grid_index_matches_jax_uint32_wrap():
    """The hashed index of corners whose products pass 2^32 equals the JAX
    package's uint32 arithmetic."""
    c = np.random.default_rng(0).integers(0, 513, (500, 3)).astype(np.int32)
    c[0] = [512, 512, 512]
    for R, size in ((512, 2**19), (64, 1000), (4, 1000)):
        ref = np.asarray(jhash._grid_index(jnp.asarray(c), R, size))
        out = hashgrid._grid_index(torch.tensor(c, dtype=torch.int64), R, size).numpy()
        np.testing.assert_array_equal(out, ref)
    assert 512 * hashgrid._PRIMES[1] > 2**32


@pytest.mark.parametrize("cfg", [
    dict(num_levels=2, base_resolution=4, desired_resolution=8, log2_hashmap_size=12),
    dict(num_levels=3, base_resolution=4, desired_resolution=64, log2_hashmap_size=10),
], ids=["dense", "hashed_with_wrap"])
def test_hash_encode_matches_jax(cfg):
    enc_j = jhash.HashGridEncoder(level_dim=2, **cfg)
    x = np.random.default_rng(1).uniform(-1.05, 1.05, (200, 3)).astype(np.float32)
    params = enc_j.init(jax.random.PRNGKey(0), jnp.asarray(x))
    table = np.asarray(jax.random.normal(jax.random.PRNGKey(1), params["params"]["table"].shape))
    params = {"params": {"table": jnp.asarray(table)}}
    g = np.random.default_rng(2).normal(size=(200, cfg["num_levels"] * 2)).astype(np.float32)
    ref = np.asarray(enc_j.apply(params, jnp.asarray(x)))
    gref = np.asarray(jax.grad(lambda p: (enc_j.apply(p, jnp.asarray(x)) * g).sum())(params)
                      ["params"]["table"])

    enc = hashgrid.HashGridEncoder(level_dim=2, **cfg)
    assert enc.resolutions == jhash.level_resolutions(
        cfg["num_levels"], cfg["base_resolution"], cfg["desired_resolution"])
    hashed = [(R + 1) ** 3 > s for R, s in zip(enc.resolutions, enc.table_sizes)]
    assert any(hashed) == (cfg["log2_hashmap_size"] == 10)
    with torch.no_grad():
        enc.table.copy_(_t(table))
    out = enc(_t(x))
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(enc.table.grad.numpy(), gref, atol=1e-5)
    assert np.abs(gref).sum() > 0


def test_hash_table_init_range():
    enc = hashgrid.HashGridEncoder(num_levels=2, base_resolution=4, desired_resolution=8,
                                   log2_hashmap_size=10, generator=torch.Generator().manual_seed(0))
    t = enc.table.detach()
    assert t.abs().max() <= 1e-4 and t.std() > 3e-5
    assert enc.out_dim == 4


# ---------------------------------------------------------------------------
# the field


def _field_pair(encoder, seed=0):
    kw = dict(num_frames=5, frame_features=2, sh_degree=3, max_trans=0.05, max_rot_deg=10.0,
              num_levels=3, level_dim=2, base_resolution=4, desired_resolution=32,
              log2_hashmap_size=10, encoder=encoder, triplane_resolutions=(8, 16),
              triplane_channels=2, triplane_freqs=4)
    jf = JObjectField(**kw)
    params = jax.device_get(jf.init(jax.random.PRNGKey(seed), jnp.zeros((2, 4, 3)),
                                    jnp.zeros((2, 3)), jnp.zeros((2,), jnp.int32)))
    rng = np.random.default_rng(seed)
    params["params"]["pose_array"] = rng.normal(0, 0.5, (5, 6)).astype(np.float32)
    if encoder == "hash":
        tab = params["params"]["grid"]["table"]
        params["params"]["grid"]["table"] = rng.normal(0, 0.1, tab.shape).astype(np.float32)
    f = ObjectField(**kw)
    f.load_state_dict(convert.field_params_to_state_dict(params, f))
    return jf, params, f


@pytest.mark.parametrize("encoder", ["triplane", "hash"])
def test_object_field_matches_jax(encoder):
    jf, params, f = _field_pair(encoder)
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.1, 1.1, (6, 7, 3)).astype(np.float32)
    vd = rng.normal(size=(6, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    fid = np.array([0, 1, 2, 3, 4, 1])
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        raw = f.query(_t(pts), _t(vd), torch.tensor(fid))
        sdf = f.sdf(_t(pts[0]))
        tf = f.pose_corrections(torch.tensor(fid))
    np.testing.assert_allclose(raw.numpy(), np.asarray(jf.apply(jp, pts, vd, fid)), atol=1e-5)
    np.testing.assert_allclose(
        sdf.numpy(), np.asarray(jf.apply(jp, pts[0], method=JObjectField.sdf)), atol=1e-5)
    np.testing.assert_allclose(
        tf.numpy(), np.asarray(jf.apply(jp, fid, method=JObjectField.pose_corrections)), atol=1e-5)
    np.testing.assert_array_equal(tf[0].numpy(), np.eye(4))  # frame 0 pinned


def test_field_params_round_trip():
    _, params, f = _field_pair("triplane", seed=3)
    back = convert.state_dict_to_field_params(f)
    flat = lambda t: {"/".join(str(getattr(p, "key", p)) for p in kp): np.asarray(v)  # noqa: E731
                      for kp, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_field_init_distributions():
    """The port's own draws follow the JAX package's initialisers: planes
    N(0, 1e-2), feature array N(0, 1), pose array 0, last sigma bias 0.1."""
    f = ObjectField(num_frames=50, encoder="triplane", triplane_resolutions=(32,), seed=1)
    assert abs(f.grid.planes_32.std().item() - 1e-2) < 1e-3
    assert abs(f.feature_array.std().item() - 1.0) < 0.2
    assert torch.equal(f.pose_array, torch.zeros(50, 6))
    assert torch.equal(f.mlp.sigma_1.bias, torch.full((16,), 0.1))
    assert torch.equal(f.mlp.sigma_0.bias, torch.zeros(64))


# ---------------------------------------------------------------------------
# sampling and losses


def _rays(n=40, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = (-o + rng.normal(0, 0.5, (n, 3))).astype(np.float32)
    d[0] = [1e-13, -1e-13, 1.0]  # tiny components of both signs
    d[1] = [0.0, 0.0, 1.0]
    depth = rng.uniform(0.5, 4.0, n).astype(np.float32)
    depth[2] = 0.0
    depth[3] = 99.0
    return o, d, depth


def test_ray_box_intersect_matches_jax():
    o, d, _ = _rays()
    tj = [np.asarray(a) for a in jsampling.ray_box_intersect(jnp.asarray(o), jnp.asarray(d))]
    tp = [a.numpy() for a in sampling.ray_box_intersect(_t(o), _t(d))]
    for a, b in zip(tp, tj):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    assert (tp[0] == -1).any() and (tp[0] >= 0).any()


def test_ray_box_tiny_negative_direction_becomes_positive():
    """Pinned quirk: a direction component with |d| < 1e-12 of EITHER sign
    is replaced by +1e-12, so a ray outside the slab along that axis hits
    on one side only — as in the JAX package."""
    o = np.array([[0.0, 1.5, -3.0], [0.0, -1.5, -3.0]], np.float32)
    d = np.array([[0.0, -1e-13, 1.0], [0.0, -1e-13, 1.0]], np.float32)
    tmin, _ = sampling.ray_box_intersect(_t(o), _t(d))
    tj, _ = jsampling.ray_box_intersect(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(tj))
    assert tmin[0].item() == -1.0 and tmin[1].item() == -1.0  # both miss: o_y outside


def test_occupancy_dilation_wraps_around_the_grid():
    """Pinned quirk: the dilation is np.roll, so a point on one face of the
    grid marks the opposite face; the "clear the wrapped faces" lines of the
    JAX package change nothing."""
    pts = np.array([[-0.999, 0.0, 0.0]])
    grid = sampling.build_occupancy_grid(pts, resolution=16, dilate=1)
    np.testing.assert_array_equal(grid, jsampling.build_occupancy_grid(pts, 16, 1))
    assert grid[0, 8, 8] and grid[15, 8, 8]  # wrapped to the far face


def test_occupancy_dilation_is_6_neighbour():
    """Pinned quirk: each pass adds the 6 face neighbours (not 26, although
    the JAX docstring says 26); two passes reach the 18 + 6 ... diamond."""
    pts = np.array([[0.01, 0.01, 0.01]])
    for dilate in (1, 2):
        grid = sampling.build_occupancy_grid(pts, resolution=16, dilate=dilate)
        np.testing.assert_array_equal(grid, jsampling.build_occupancy_grid(pts, 16, dilate))
        assert grid.sum() == {1: 7, 2: 25}[dilate]
    assert not grid[9, 9, 9]  # a corner neighbour is never set by one pass


def test_occupancy_lookup_matches_jax():
    rng = np.random.default_rng(3)
    grid = rng.random((16, 16, 16)) > 0.6
    p = rng.uniform(-1.2, 1.2, (7, 9, 3)).astype(np.float32)
    ref = np.asarray(jsampling.occupancy_lookup(jnp.asarray(grid), jnp.asarray(p)))
    np.testing.assert_array_equal(sampling.occupancy_lookup(torch.tensor(grid), _t(p)).numpy(),
                                  ref)


def test_linspace_matches_jnp():
    for n in (2, 8, 24, 128, 129):
        np.testing.assert_array_equal(sampling.linspace01(n).numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_sample_rays_matches_jax_on_its_draws():
    o, d, depth = _rays(seed=1)
    grid = sampling.build_occupancy_grid(
        np.random.default_rng(0).uniform(-0.6, 0.6, (300, 3)), resolution=16, dilate=1)
    key = jax.random.PRNGKey(7)
    for sort in (False, True):
        z_j, v_j = jsampling.sample_rays(key, jnp.asarray(o), jnp.asarray(d), jnp.asarray(depth),
                                         jnp.asarray(grid), 10, 6, 0.05, neg_trunc_ratio=0.5,
                                         far_default=3.0, sort=sort)
        k1, k2 = jax.random.split(key)
        u1 = np.asarray(jax.random.uniform(k1, (len(o), 10)))
        u2 = np.asarray(jax.random.uniform(k2, (len(o), 6)))
        z, v = sampling.sample_rays(_t(u1), _t(u2), _t(o), _t(d), _t(depth), torch.tensor(grid),
                                    0.05, neg_trunc_ratio=0.5, far_default=3.0, sort=sort)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_j))
        assert v.any()


def test_sample_pdf_matches_jax_on_its_draws():
    rng = np.random.default_rng(2)
    bins = np.sort(rng.uniform(0, 2, (12, 9)), axis=-1).astype(np.float32)
    w = rng.random((12, 8)).astype(np.float32)
    w[3] = 0.0
    w[4, :7] = 0.0
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 16))
    u = np.asarray(jax.random.uniform(key, (12, 16)))
    np.testing.assert_allclose(sampling.sample_pdf(_t(u), _t(bins), _t(w)).numpy(), ref,
                               rtol=1e-5, atol=1e-5)
    ref_d = np.asarray(jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 16,
                                            deterministic=True))
    np.testing.assert_allclose(
        sampling.sample_pdf(None, _t(bins), _t(w), 16, deterministic=True).numpy(), ref_d,
        rtol=1e-5, atol=1e-5)


def test_losses_match_jax():
    rng = np.random.default_rng(4)
    N, S = 16, 12
    z = np.sort(rng.uniform(0.2, 2.0, (N, S)), axis=-1).astype(np.float32)
    d = rng.uniform(0.3, 2.5, N).astype(np.float32)
    sdf = rng.normal(0, 1, (N, S)).astype(np.float32)
    sw = (rng.random((N, S)) > 0.3).astype(np.float32)
    raw = rng.normal(0, 2, (N, S, 4)).astype(np.float32)
    ref = jlosses.sdf_losses(*map(jnp.asarray, (z, d, sdf)), 0.1, jnp.asarray(sw), 0.2, 2.0,
                             0.7, 1.0)
    out = losses.sdf_losses(*map(_t, (z, d, sdf)), 0.1, _t(sw), 0.2, 2.0, 0.7, 1.0)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-8)
    wj = jlosses.depth_band_weights(jnp.asarray(z), jnp.asarray(d), 0.1, 5.0, 2.0, 0.7)
    wp = losses.depth_band_weights(_t(z), _t(d), 0.1, 5.0, 2.0, 0.7)
    np.testing.assert_allclose(wp.numpy(), np.asarray(wj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(losses.render_rgb(_t(raw), wp).numpy(),
                               np.asarray(jlosses.render_rgb(jnp.asarray(raw), wj)),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# bounds and meshing


def test_scene_bounds_match_jax():
    K, cams, rgbs, depths, masks = _sphere_scene(n_views=6)
    tj, sj, cj = jbounds.compute_scene_bounds(depths, masks, K, cams, voxel=0.02)
    tp, sp, cp = bounds.compute_scene_bounds(depths, masks, K, cams, voxel=0.02)
    np.testing.assert_allclose(tp, tj, atol=1e-6)
    np.testing.assert_allclose(sp, sj, rtol=1e-6)
    assert cp.shape == cj.shape
    np.testing.assert_allclose(cp, cj, atol=1e-6)
    a = jbounds.preprocess_data(rgbs, depths, masks, cams, sj, tj)
    b = bounds.preprocess_data(rgbs, depths, masks, cams, sj, tj)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _clusters(seed, sizes, spacing=0.5):
    rng = np.random.default_rng(seed)
    parts = [rng.normal(0, 0.01, (n, 3)) + np.array([spacing * i, 0, 0])
             for i, n in enumerate(sizes)]
    pts = np.concatenate(parts)
    return pts[rng.permutation(len(pts))]


@pytest.mark.parametrize("sizes", [(40, 90, 25), (60, 60, 30), (30, 50, 50, 50), (1,)],
                         ids=["distinct", "tie_of_two", "tie_of_three", "single_point"])
def test_biggest_cluster_matches_sklearn_dbscan(sizes):
    """Connected components of the eps-graph equal DBSCAN(eps,
    min_samples=1), the biggest one picked with DBSCAN's tie-break (the
    cluster whose first point comes first)."""
    from sklearn.cluster import DBSCAN

    pts = _clusters(sum(sizes), sizes)
    labels = DBSCAN(eps=0.06, min_samples=1).fit(pts).labels_
    np.testing.assert_array_equal(bounds.cluster_labels(pts, 0.06), labels)
    np.testing.assert_array_equal(bounds.biggest_cluster(pts, 0.06),
                                  jbounds.biggest_cluster(pts, 0.06))


def test_marching_tetrahedra_bit_for_bit():
    rng = np.random.default_rng(0)
    n = 20
    ax = np.linspace(-1, 1, n)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sdf = np.sqrt(X**2 + 1.3 * Y**2 + Z**2) - 0.6 + 0.03 * rng.normal(size=X.shape)
    a = meshing.marching_tetrahedra(sdf, iso=0.0, origin=(-1, -1, -1), spacing=2 / (n - 1))
    b = jmeshing.marching_tetrahedra(sdf, iso=0.0, origin=(-1, -1, -1), spacing=2 / (n - 1))
    assert len(a.faces) > 100
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.vertex_normals, b.vertex_normals)


def test_extract_sdf_grid_mesh_matches_jax():
    def sdf_np(p):
        return np.linalg.norm(p, axis=-1) - 0.5

    valid = lambda p: np.abs(p).max(axis=-1) < 0.8  # noqa: E731
    b = np.array([[-1.0, -1, -1], [1, 1, 1]])
    a = meshing.extract_sdf_grid_mesh(lambda p: torch.tensor(sdf_np(p)), b, 0.1, chunk=1000,
                                      valid_fn=lambda p: torch.tensor(valid(p)))
    ref = jmeshing.extract_sdf_grid_mesh(sdf_np, b, 0.1, chunk=1000, valid_fn=valid)
    np.testing.assert_array_equal(a.vertices, ref.vertices)
    np.testing.assert_array_equal(a.faces, ref.faces)
