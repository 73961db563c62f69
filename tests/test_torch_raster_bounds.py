"""The K1 bounds (``ops/raster_bounds.py``) and the K1 parts timer's shapes
(``apps/profile_raster.py``) on the CPU, where the kernels do not run.

- ``k1_bounds`` gives the numbers the smoke script printed before the bounds
  moved into the package: the formula is kept here as it stood, and both are
  evaluated on the plain version's scratch and output, exactly.
- ``k1_part_bounds``: the full kernels' parts carry the full kernels' bounds
  (and the whole call's), and each earlier part moves no more bytes and does no more work.
- Every shape of the parts timer builds at its size (B, pixels, faces, flags).
- Without a card the timer exits non-zero and prints no row.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from foundationpose_tpu_torch.apps import demo_synthetic as demo, profile_raster
from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.ops import raster, raster_bounds as rb, raster_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _reference_k1_bounds(mt, poses, K, tfs, scratch, out, H, W):
    """The smoke script's bound formula as it stood before the move."""
    B, V, F = poses.shape[0], mt["pos"].shape[0], mt["faces"].shape[0]
    rec, bins = scratch["rec"], scratch["bins"]
    tests = raster_cuda.tile_face_tests(rec, H, W)
    n_valid = int((rec[..., 12] <= rec[..., 13]).sum().item())
    hit = int(out["mask"].sum().item())
    px_ops = hit * (rb.OPS_PER_HIT_PIXEL + (rb.OPS_PER_TEXEL_PIXEL if "tex" in mt else 0))
    raster_ops = tests * rb.OPS_PER_TEST + 2 * hit * rb.OPS_PER_INSIDE + px_ops
    setup_ops = B * (V * rb.OPS_PER_VERTEX + F * rb.OPS_PER_FACE
                     + F * bins.shape[1] * rb.OPS_PER_FACE_TILE)
    geometry = rb.tensor_bytes(mt["pos"], mt["vnormals"], mt["faces"], poses, K, tfs)
    colour = rb.tensor_bytes({k: v for k, v in mt.items() if k in ("tex", "uv", "vertex_color")})
    rec_written = n_valid * 64 + (B * F - n_valid) * 16
    scratch_read = n_valid * 48 + rb.tensor_bytes(bins, scratch["vtab"])
    extra = {"pixel_face_tests": tests, "pixel_face_tests_untiled": B * H * W * F,
             "valid_faces": n_valid, "hit_pixels": hit}
    return {
        "call": rb.bound(geometry + colour + rb.tensor_bytes(out), setup_ops + raster_ops,
                         **extra),
        "K1s": rb.bound(geometry + rec_written + rb.tensor_bytes(bins, scratch["vtab"]),
                        setup_ops),
        "K1r": rb.bound(scratch_read + rb.tensor_bytes(mt["faces"]) + colour
                        + rb.tensor_bytes(out), raster_ops),
    }


def _case(textured, normals):
    mesh = profile_raster.textured_sphere() if textured else demo.make_l_shape()
    mt = raster.make_mesh_tensors(mesh, max_faces=1024, bucket=True, device="cpu")
    rng = np.random.default_rng(3)
    poses = np.tile(demo.default_gt_pose().astype(np.float32), (4, 1, 1))
    poses[:, :3, 3] += rng.normal(0, 0.01, (4, 3)).astype(np.float32)
    poses = torch.tensor(poses)
    K = torch.tensor(demo.default_intrinsics((480, 640)), dtype=torch.float32)
    tfs = geo.compute_crop_window_tf_batch(poses, K, 1.2, 0.2, (48, 48))
    ki = raster_cuda.make_kernel_inputs(mt, poses, K, tfs, backface_cull=True)
    scratch = {"rec": ki["rec"], "vtab": ki["vtab"], "bins": raster_cuda.tile_bins(ki["rec"], 48, 48)}
    out = raster_cuda.render_crops(mt, poses, K, tfs, out_hw=(48, 48), backface_cull=True,
                                   with_normal=normals)
    return mt, poses, K, tfs, scratch, out


@pytest.mark.parametrize("textured,normals", [(False, False), (True, True)])
def test_bounds_are_the_smoke_scripts_numbers(textured, normals):
    mt, poses, K, tfs, scratch, out = _case(textured, normals)
    assert int(out["mask"].sum()) > 0
    got = rb.k1_bounds(mt, poses, K, tfs, scratch, out, (48, 48))
    assert got == _reference_k1_bounds(mt, poses, K, tfs, scratch, out, 48, 48)


def test_part_bounds_build_up_to_the_full_kernels():
    mt, poses, K, tfs, scratch, out = _case(True, False)
    full = rb.k1_bounds(mt, poses, K, tfs, scratch, out, (48, 48))
    parts = rb.k1_part_bounds(mt, poses, K, tfs, scratch, out, (48, 48))
    assert set(parts) == set(rb.K1S_PARTS) | set(rb.K1R_PARTS) | {"call"}
    assert parts["call"] == full["call"]
    assert parts["setup+bins"] == full["K1s"]
    assert parts["+attributes"] == parts["+staged stores"] == full["K1r"]
    assert parts["setup"]["bytes"] < full["K1s"]["bytes"]
    assert parts["setup"]["operations"] < full["K1s"]["operations"]
    assert parts["bins+background"]["operations"] == 0
    assert parts["bins+background"]["bytes"] <= full["K1r"]["bytes"]
    assert 0 < parts["+coverage+depth"]["operations"] < full["K1r"]["operations"]
    assert parts["+coverage+depth"]["bytes"] < full["K1r"]["bytes"]


def test_every_timer_shape_builds_at_its_size():
    meshes = profile_raster._Meshes(torch.device("cpu"))
    for name, spec in profile_raster.SHAPES.items():
        mt, poses, K, tfs, hw, flags = profile_raster.make_case(name, meshes, torch.device("cpu"))
        B = int(name.split("_B")[1].split("_")[0])
        assert poses.shape == (B, 4, 4) and tfs.shape == (B, 3, 3), name
        assert hw == ((spec["crop"],) * 2 if spec["crop"] else profile_raster.HW_FRAME), name
        assert flags["cull"] == spec["cull"] and flags["normals"] == spec["normals"], name
        assert torch.isfinite(poses).all() and torch.isfinite(tfs).all(), name
    faces = {n: int(m[0]["faces"].shape[0]) for n, m in meshes.cache.items() if n != "corpus"}
    assert faces["textured_4096"] == 4096 and faces["demo"] == 256
    assert faces["corpus_textured"] == faces["corpus_vcol"] == 2048
    assert faces["bake_81920"] == 81920 and faces["depth_grid_7938"] == 7938


def test_parts_timer_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "foundationpose_tpu_torch.apps.profile_raster",
                          "--shape", "main_B256_160px"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and "profile_raster" not in out.stdout
