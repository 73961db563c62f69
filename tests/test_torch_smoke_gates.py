"""The gate ``chip_smoke.py::compare_with_plain`` puts on K1r at the texture
bake's shape, held on the CPU with K1r stood in for by the plain rasterizer
limited to the faces the plain binning (``tile_bins``) gives each pixel's
tile — what K1r computes.

The scene is a backdrop of two triangles at 0.5 m and, in front of it, 40
faces of about a thousandth of a pixel (vertices 6e-7 m apart, the size of
the faces marching tetrahedra leaves in a reconstructed mesh). Their float32
barycentric coefficients are noise, so the unlimited plain version "hits"
wedges of pixels far outside them. The gate must excuse exactly those
(with the bake's cap) and must fail when the cap is 0, when the kernel's
winner is a face that holds its pixel by neither test, and when the kernel
drops the backdrop behind the noise.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import pytest
import torch

from foundationpose_tpu_torch.core.meshio import Mesh
from foundationpose_tpu_torch.ops import raster, raster_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (480, 640)
K = torch.tensor([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
KW = dict(out_hw=HW, backface_cull=False, with_normal=False, use_light=False, with_bary=True)


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_gates",
                                                  os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scene():
    rng = np.random.default_rng(0)
    z = 0.5
    corners = np.array([[-0.2, -0.2, z], [0.35, -0.2, z], [0.35, 0.2, z], [-0.2, 0.2, z]])
    tris = [corners[[0, 1, 2]], corners[[0, 2, 3]]]
    for _ in range(40):  # faces of ~1e-3 px in front of the backdrop
        u, v, d = rng.uniform(300, 620), rng.uniform(150, 460), 0.45 + rng.uniform(-0.01, 0.01)
        c = np.array([(u - 320) / 600 * d, (v - 240) / 600 * d, d], np.float32)
        tris.append(np.stack([c, c + [0, -6e-7, 0], c + [6e-7, 0, 0]]).astype(np.float32))
    v = np.concatenate(tris).astype(np.float64)
    return raster.make_mesh_tensors(Mesh(v, np.arange(len(v)).reshape(-1, 3).astype(np.int32)),
                                    device="cpu")


def _bake_case():
    mt = _scene()
    pose, tfs = torch.eye(4)[None], torch.eye(3)[None]
    rec = raster_cuda.make_kernel_inputs(mt, pose, K, tfs)["rec"]
    bins = raster_cuda.tile_bins(rec, *HW)
    H, W = HW
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    tile = ((ys // raster_cuda.TILE) * -(-W // raster_cuda.TILE) + xs // raster_cuda.TILE)
    face_ok = raster_cuda.unpack_bins(bins, mt["faces"].shape[0])[:, tile.reshape(-1)]
    args = raster.prepare_render_args(mt, pose, K, tfs)
    kernel = raster._render_chunk(mt, *args, H, W, False, False, 0.8, 0.5, (0.0, 0.0, 1.0),
                                  False, 256, face_ok=face_ok, with_bary=True)
    plain = raster.render_crops(mt, pose, K, tfs, **KW)
    return mt, pose, tfs, {"bins": bins}, kernel, plain


@pytest.fixture(scope="module")
def bake_case():
    return _bake_case()


def _compare(monkeypatch, bake_case, kernel, cap):
    smoke = _load_smoke()
    mt, pose, tfs, scratch, _, _ = bake_case
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(raster_cuda, "rasterize_cuda",
                        lambda *a, **k: {key: v.clone() for key, v in kernel.items()})
    return smoke.compare_with_plain(raster, raster_cuda, torch, mt, pose, K, tfs, KW,
                                    {"case": "bake gate"}, scratch, excuse_cap=cap)


def test_noise_faces_hit_outside_their_boxes(bake_case):
    """The scene shows the fault the gate is about: the unlimited plain
    version gives pixels to noise faces that the limited one (K1r's
    stand-in) never offers them."""
    *_, kernel, plain = bake_case
    assert int((plain["mask"] & (plain["tri"] >= 2) & (plain["tri"] != kernel["tri"])).sum()) > 100


def test_bake_gate_excuses_coefficient_noise(monkeypatch, bake_case):
    *_, kernel, _ = bake_case
    row = _compare(monkeypatch, bake_case, kernel, _load_smoke().EXCUSE_CAP)
    assert row["excused_px"] > 100 and row["winners_lost_to_binning"] == 0
    assert row["excused_noise_winners"]["plain"] == row["excused_px"]
    assert row["excused_agree_without_noise_faces"] == 1.0
    assert row["winner_flips_with_differing_values_of_common"] == 0.0


@pytest.mark.parametrize("fault", ["no_cap", "winner_not_covering", "drops_backdrop"])
def test_bake_gate_fails_a_wrong_kernel(monkeypatch, bake_case, fault):
    """With the cap at 0 (every shape but the bake's) the noise fails the
    gate; a kernel whose winner holds its pixel by neither test, or that
    drops the backdrop behind the noise, fails it at the bake's cap."""
    *_, kernel, plain = bake_case
    cap = 0.0 if fault == "no_cap" else _load_smoke().EXCUSE_CAP
    bad = {k: v.clone() for k, v in kernel.items()}
    if fault == "winner_not_covering":
        on0 = bad["mask"] & (bad["tri"] == 0)
        bad["tri"][on0] = 1  # the backdrop's other triangle
        bad["depth"][on0] += 0.01
    elif fault == "drops_backdrop":
        under = plain["mask"] & (plain["tri"] >= 2) & kernel["mask"] & (kernel["tri"] < 2)
        bad["mask"][under], bad["tri"][under] = False, -1
        for key in ("depth", "xyz", "rgb", "bary"):
            bad[key][under] = 0.0
    with pytest.raises(SystemExit):
        _compare(monkeypatch, bake_case, bad, cap)
