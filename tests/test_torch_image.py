"""Port parity for foundationpose_tpu_torch/ops/image.py against
foundationpose_tpu/ops/image.py on the same numpy inputs (fixed seed).

Stencils on noisy depth with holes agree to 1e-6 (same shift stack, same
accumulation order, float32); ``dilate_mask`` and the nearest warp are
exact; the bilinear warp agrees to 1e-4 on 0-255 values (the JAX function
sums taps through two matmuls, the port through a gather).
"""

import numpy as np
import pytest
import torch

from foundationpose_tpu.core import geometry as jgeo
from foundationpose_tpu.ops import image as jimops
from foundationpose_tpu_torch.ops import image as imops

torch.set_num_threads(1)


def _noisy_depth(seed=0, hw=(96, 128)):
    rng = np.random.default_rng(seed)
    H, W = hw
    yy, xx = np.mgrid[0:H, 0:W]
    depth = 0.6 + 0.002 * xx + 0.001 * yy + rng.normal(0, 0.0015, hw)
    depth[20:50, 30:70] -= 0.15                      # a step edge
    depth[rng.uniform(size=hw) < 0.08] = 0.0         # holes
    depth[60:70, 90:100] = 0.0
    depth[5, 5] = 150.0                              # beyond zfar
    return depth.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_erode_depth(seed):
    d = _noisy_depth(seed)
    ref = np.asarray(jimops.erode_depth(d, radius=2))
    out = imops.erode_depth(d, radius=2).numpy()
    assert (ref == 0).sum() > (d == 0).sum()  # it did erode something
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_bilateral_filter_depth(seed):
    d = np.asarray(jimops.erode_depth(_noisy_depth(seed), radius=2))
    ref = np.asarray(jimops.bilateral_filter_depth(d, radius=2))
    out = imops.bilateral_filter_depth(d, radius=2).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert np.abs(ref - d)[d > 0].max() > 1e-5  # it did smooth something


def test_stencils_on_all_zero_depth():
    z = np.zeros((32, 40), np.float32)
    assert (imops.erode_depth(z).numpy() == 0).all()
    assert (imops.bilateral_filter_depth(z).numpy() == 0).all()


@pytest.mark.parametrize("radius", [1, 10])
def test_dilate_mask_exact(radius):
    rng = np.random.default_rng(2)
    m = rng.uniform(size=(60, 80)) < 0.01
    m[0, 0] = m[-1, -1] = True
    ref = np.asarray(jimops.dilate_mask(m, radius=radius))
    out = imops.dilate_mask(torch.tensor(m), radius=radius).numpy()
    assert (ref == out).all()
    outb = imops.dilate_mask(torch.tensor(m)[None].expand(2, -1, -1), radius).numpy()
    assert (outb == ref[None]).all()


def _half_pixel_tfs():
    """Crop tfs as compute_crop_window_tf_batch makes them, including windows
    whose inverse lands sample positions exactly on .5 (a 64 px crop of a
    96 px or 32 px window) and windows hanging over the image border."""
    K = np.array([[420.0, 0, 64], [0, 420.0, 48], [0, 0, 1]])
    rng = np.random.default_rng(4)
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (6, 1, 1))
    poses[:, :3, 3] = rng.uniform([-0.06, -0.05, 0.4], [0.06, 0.05, 0.9], (6, 3))
    tfs = np.asarray(jgeo.compute_crop_window_tf_batch(poses, K, 1.2, 0.12, (64, 64)))
    manual = np.tile(np.eye(3, dtype=np.float32)[None], (3, 1, 1))
    for i, (left, top, size) in enumerate([(10, 5, 96), (40, 30, 32), (-20, -10, 128)]):
        s = 64.0 / size
        manual[i] = [[s, 0, -left * s], [0, s, -top * s], [0, 0, 1]]
    return np.concatenate([tfs, manual]).astype(np.float32)


def test_warp_crop_affine_bilinear():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (96, 128, 3)).astype(np.float32)
    tfs = _half_pixel_tfs()
    ref = np.asarray(jimops.warp_crop_affine(img, tfs, (64, 64), mode="bilinear"))
    out = imops.warp_crop_affine(img, tfs, (64, 64), mode="bilinear").numpy()
    assert out.shape == ref.shape == (9, 64, 64, 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_warp_crop_affine_nearest_exact():
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-1, 1, (96, 128, 4)).astype(np.float32)
    tfs = _half_pixel_tfs()
    ref = np.asarray(jimops.warp_crop_affine(xyz, tfs, (64, 64), mode="nearest"))
    out = imops.warp_crop_affine(xyz, tfs, (64, 64), mode="nearest").numpy()
    assert (out == ref).all()
    assert (ref[-1][:5, :5] == 0).all()  # outside the image reads zero


def test_warp_crop_affine_2d_and_single_tf():
    rng = np.random.default_rng(7)
    depth = rng.uniform(0.3, 1.0, (96, 128)).astype(np.float32)
    tf = _half_pixel_tfs()[0]
    ref = np.asarray(jimops.warp_crop_affine(depth, tf, (64, 64), mode="nearest"))
    out = imops.warp_crop_affine(depth, tf, (64, 64), mode="nearest").numpy()
    assert out.shape == ref.shape == (64, 64)
    assert (out == ref).all()
