"""Port parity for texture baking (``field/texture.py``) and the rasterizer's
``tri`` / ``bary`` outputs it reads, against the JAX package on the CPU.

Gates:
- ``unwrap_triangle_atlas``: equal to the JAX package's, bit for bit;
- the plain rasterizer's ``tri`` equal to the JAX package's plain output
  except at shared-edge ties (pinned: tests/test_torch_raster.py), masks
  as that file's gate, ``bary`` on same-winner pixels within 5e-4;
- ``bake_texture``: on the JAX package's renders, its texture bit for bit;
  on its own renders, within one grey level of the JAX package's on >= 99 %
  of the texels both observe; re-rendered at a training view, the baked
  sphere's mean colour error below 0.08 (the JAX gate,
  tests/test_texture_slam.py:65).
"""

import jax
import numpy as np
import pytest
import torch

from foundationpose_tpu.core import meshio as jmeshio
from foundationpose_tpu.core.icosphere import sample_views_icosphere
from foundationpose_tpu.field import texture as jtexture
from foundationpose_tpu.ops import raster as jraster
from foundationpose_tpu_torch.core import meshio
from foundationpose_tpu_torch.field import texture
from foundationpose_tpu_torch.ops import raster, raster_cuda

torch.set_num_threads(1)
K = np.array([[200.0, 0, 64], [0, 200.0, 64], [0, 0, 1]])
HW = (128, 128)


@pytest.mark.parametrize("mesh", ["box", "icosphere"])
def test_unwrap_triangle_atlas_matches_jax(mesh):
    if mesh == "box":
        a, b = meshio.make_box((0.1, 0.2, 0.1)), jmeshio.make_box((0.1, 0.2, 0.1))
    else:  # an odd face count: the last cell holds one triangle
        a = meshio.make_icosphere_mesh(subdivisions=1, radius=0.05)
        b = jmeshio.make_icosphere_mesh(subdivisions=1, radius=0.05)
        keep = np.arange(len(a.faces) - 1)
        a = meshio.Mesh(a.vertices, a.faces[keep])
        b = jmeshio.Mesh(b.vertices, b.faces[keep])
    ua, ub = texture.unwrap_triangle_atlas(a, tex_res=256), jtexture.unwrap_triangle_atlas(b, 256)
    np.testing.assert_array_equal(ua.uv, ub.uv)
    np.testing.assert_array_equal(ua.vertices, ub.vertices)
    np.testing.assert_array_equal(ua.faces, ub.faces)
    assert ua.uv.min() >= 0 and ua.uv.max() <= 1


def _sphere():
    mesh = meshio.make_icosphere_mesh(subdivisions=2, radius=0.06)
    mesh.vertex_colors = ((mesh.vertices / 0.06 * 0.5 + 0.5) * 255).astype(np.uint8)
    return mesh


def _cams(n=12):
    cams = np.asarray(sample_views_icosphere(n_views=n), np.float64)
    cams[:, :3, 3] *= 0.5  # 0.5 m away
    return cams


def test_render_outputs_unchanged_by_default():
    """``with_tri`` / ``with_bary`` are off by default: the public renderer
    returns exactly the keys it returned before."""
    mt = raster.make_mesh_tensors(_sphere(), device="cpu")
    pose = np.linalg.inv(_cams()[0])[None]
    out = raster_cuda.render_full_frame(mt, pose, K, (32, 32))
    assert set(out) == {"rgb", "depth", "xyz", "mask", "normal"}
    both = raster_cuda.render_full_frame(mt, pose, K, (32, 32), with_tri=True, with_bary=True)
    assert set(both) == set(out) | {"tri", "bary"}
    assert both["tri"].dtype == torch.int32
    for k in out:
        assert torch.equal(out[k], both[k])


@pytest.fixture(scope="module")
def views():
    """The colored sphere seen from 12 views (the port's plain renders), the
    JAX package's plain renders of its unwrapped mesh (one jitted call), and
    the port's own."""
    mesh = _sphere()
    mt = raster.make_mesh_tensors(mesh, device="cpu")
    cams = _cams()
    poses = np.stack([np.linalg.inv(c) for c in cams]).astype(np.float32)
    out = raster_cuda.render_full_frame(mt, poses, K, HW, use_light=False)
    images, masks = out["rgb"].numpy() * 255, out["mask"].numpy()
    un = jtexture.unwrap_triangle_atlas(jmeshio.Mesh(mesh.vertices, mesh.faces), tex_res=256)
    jmt = jraster.make_mesh_tensors(un)
    ref = jax.jit(lambda m, p: jraster.render_full_frame(m, p, K, HW, use_light=False))(jmt, poses)
    ref = {k: np.asarray(ref[k]) for k in ("tri", "bary", "mask", "xyz")}
    mine = raster_cuda.render_full_frame(
        raster.make_mesh_tensors(texture.unwrap_triangle_atlas(mesh, 256), device="cpu"),
        poses, K, HW, use_light=False, with_tri=True, with_bary=True)
    return mesh, mt, cams, images, masks, ref, mine


def _replay(module, ref, as_torch):
    """Make ``module``'s render_full_frame hand back the precomputed views in
    order (each call may ask for several)."""
    state = {"i": 0}

    def render(mt, poses, K_, hw, **kw):
        i, n = state["i"], len(poses)
        state["i"] += n
        out = {k: v[i:i + n] for k, v in ref.items()}
        if as_torch:
            out = {k: torch.tensor(v) for k, v in out.items()}
            out["tri"] = out["tri"].int()
        return out

    return render


def test_plain_tri_and_bary_match_jax(views):
    """On the unwrapped sphere (split vertices, every edge a shared edge):
    masks as the pinned plain-vs-XLA gate (>= 0.9999 of pixels), winners on
    > 0.99 of common pixels (shared-edge ties, pinned), and the barycentrics
    of same-winner pixels within 5e-4 — 99 % of them within 1e-4 (w = a px
    + b py + c cancels terms ~1e2 times larger on small, grazing faces)."""
    *_, ref, mine = views
    m, mj = mine["mask"].numpy(), ref["mask"]
    assert (m == mj).mean() >= 0.9999
    both = m & mj
    tri, trij = mine["tri"].numpy(), ref["tri"]
    same = both & (tri == trij)
    assert same.sum() > 0.99 * both.sum()
    d = np.abs(mine["bary"].numpy() - ref["bary"]).max(axis=-1)[same]
    assert d.max() <= 5e-4 and (d <= 1e-4).mean() >= 0.99, (d.max(), (d <= 1e-4).mean())
    assert (mine["bary"].numpy()[~m] == 0).all() and (tri[~m] == -1).all()
    np.testing.assert_allclose(mine["bary"].numpy()[m].sum(-1), 1.0, atol=1e-5)


def test_bake_texture_matches_jax_on_the_same_renders(views, monkeypatch):
    """Given the JAX package's renders, the port's bake (atlas, incidence
    weights, float64 accumulation, nearest fill) gives its texture bit for
    bit."""
    mesh, _, cams, images, masks, ref, _ = views
    jmesh = jmeshio.Mesh(mesh.vertices, mesh.faces, vertex_colors=mesh.vertex_colors)
    monkeypatch.setattr(jtexture.raster, "render_full_frame", _replay(jtexture, ref, False))
    want = jtexture.bake_texture(jmesh, images, masks, cams, K, tex_res=256)
    monkeypatch.setattr(texture.raster_cuda, "render_full_frame", _replay(texture, ref, True))
    got = texture.bake_texture(mesh, images, masks, cams, K, tex_res=256, device="cpu")
    np.testing.assert_array_equal(got.uv, want.uv)
    np.testing.assert_array_equal(got.texture, want.texture)


def test_bake_texture_matches_jax(views, monkeypatch):
    """The port's bake with its own renders against the JAX package's bake:
    on texels both observe, >= 99 % within one grey level; the observed sets
    agree on >= 98.5 % of them. The rest move with the shared-edge winner
    flips, and the nearest fill carries each such texel over the empty atlas
    around it, so the filled texels are not compared."""
    mesh, _, cams, images, masks, ref, _ = views
    jmesh = jmeshio.Mesh(mesh.vertices, mesh.faces, vertex_colors=mesh.vertex_colors)
    seen = {}

    def spy(name, fn):
        def fill(tex, filled):
            seen[name] = (tex.copy(), filled.copy())
            return fn(tex, filled)
        return fill

    monkeypatch.setattr(jtexture.raster, "render_full_frame", _replay(jtexture, ref, False))
    monkeypatch.setattr(jtexture, "nearest_fill", spy("jax", jtexture.nearest_fill))
    monkeypatch.setattr(texture, "nearest_fill", spy("port", texture.nearest_fill))
    want = jtexture.bake_texture(jmesh, images, masks, cams, K, tex_res=256)
    got = texture.bake_texture(mesh, images, masks, cams, K, tex_res=256, device="cpu")
    np.testing.assert_array_equal(got.uv, want.uv)
    (tj, fj), (tp, fp) = seen["jax"], seen["port"]
    both = fj & fp
    assert both.sum() >= 0.985 * (fj | fp).sum()
    d = np.abs(tp - tj).max(axis=-1)[both]
    assert (d <= 1.0).mean() >= 0.99, (d <= 1.0).mean()


def test_bake_texture_recovers_color(views):
    """Mirror of tests/test_texture_slam.py::test_bake_texture_recovers_color
    on the port: bake from 12 views, re-render a training view."""
    mesh, mt, cams, images, masks, *_ = views
    textured = texture.bake_texture(mesh, images, masks, cams, K, tex_res=512, device="cpu")
    mt2 = raster.make_mesh_tensors(textured, device="cpu")
    assert "tex" in mt2
    pose = np.linalg.inv(cams[3])[None]
    a = raster_cuda.render_full_frame(mt, pose, K, HW, use_light=False)
    b = raster_cuda.render_full_frame(mt2, pose, K, HW, use_light=False)
    m = (a["mask"][0] & b["mask"][0]).numpy()
    err = np.abs(a["rgb"][0].numpy()[m] - b["rgb"][0].numpy()[m]).mean()
    assert err < 0.08, f"mean color error {err}"


def test_bake_views_batched_per_call(views, monkeypatch):
    """Views are rendered in calls sized by the bins budget; any batching
    gives the same texture."""
    mesh, _, cams, images, masks, *_ = views
    cams, images, masks = cams[:4], images[:4], masks[:4]
    views_per_call = []
    render = raster_cuda.render_full_frame

    def counted(mt, poses, *args, **kw):
        views_per_call.append(len(poses))
        return render(mt, poses, *args, **kw)

    monkeypatch.setattr(raster_cuda, "render_full_frame", counted)
    one = texture.bake_texture(mesh, images, masks, cams, K, tex_res=128, device="cpu")
    assert views_per_call == [len(cams)]
    assert texture._views_per_call(len(mesh.faces), HW, 1) == 1
    views_per_call.clear()
    monkeypatch.setattr(texture, "BINS_BUDGET", 1)
    many = texture.bake_texture(mesh, images, masks, cams, K, tex_res=128, device="cpu")
    assert views_per_call == [1] * len(cams)
    np.testing.assert_array_equal(one.texture, many.texture)
