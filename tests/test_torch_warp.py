"""The port's general perspective warp (``ops/image.py::warp_perspective``)
against the JAX package's, and the port's separable ``warp_crop_affine``
against it, as tests/test_warp_fast.py holds the JAX pair. Tolerances on a
0..255 image: 1e-3 between the two packages' warps under crop transforms,
1e-2 under general perspective ones (the inverse's LU rounds differently in
torch and XLA, and a sample position 1e-6 px off moves a texel step of 255 by
that much times the step; tests/test_warp_fast.py's own tolerance at this
scale), and the JAX test's for the separable warp."""

import numpy as np
import pytest
import torch

from foundationpose_tpu.ops import image as jimops
from foundationpose_tpu_torch.ops import image as imops


def _crop_tfs(rng, n):
    tfs = np.zeros((n, 3, 3), np.float32)
    scale = rng.uniform(0.2, 1.5, size=n)
    tfs[:, 0, 0] = scale
    tfs[:, 1, 1] = scale
    tfs[:, 0, 2] = rng.uniform(-80, 30, size=n)
    tfs[:, 1, 2] = rng.uniform(-60, 30, size=n)
    tfs[:, 2, 2] = 1.0
    return tfs


def _perspective_tfs(rng, n):
    tfs = _crop_tfs(rng, n)
    tfs[:, :2, :2] += rng.normal(0, 0.05, (n, 2, 2)).astype(np.float32)
    tfs[:, 2, :2] = rng.normal(0, 2e-3, (n, 2)).astype(np.float32)
    return tfs


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("kind", ["crop", "perspective"])
def test_warp_perspective_matches_jax(mode, kind):
    rng = np.random.default_rng({"crop": 0, "perspective": 1}[kind])
    img = rng.uniform(0, 255, size=(48, 64, 3)).astype(np.float32)
    tfs = (_crop_tfs if kind == "crop" else _perspective_tfs)(rng, 6)
    if mode == "nearest":  # away from .5 ties, whose side the last ulp decides
        tfs[:, 0, 2] = np.round(tfs[:, 0, 2]) + 0.25
        tfs[:, 1, 2] = np.round(tfs[:, 1, 2]) + 0.25
    ref = np.asarray(jimops.warp_perspective(img, tfs, (40, 40), mode=mode))
    out = imops.warp_perspective(img, tfs, (40, 40), mode=mode).numpy()
    assert out.shape == ref.shape == (6, 40, 40, 3)
    if mode == "bilinear":
        np.testing.assert_allclose(out, ref, atol=1e-3 if kind == "crop" else 1e-2)
    else:
        assert np.isclose(out, ref).mean() > 0.995


def test_crop_affine_matches_general_warp_bilinear():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, size=(48, 64, 3)).astype(np.float32)
    tfs = torch.tensor(_crop_tfs(rng, 7))
    ref = imops.warp_perspective(img, tfs, (40, 40), mode="bilinear")
    fast = imops.warp_crop_affine(img, tfs, (40, 40), mode="bilinear")
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), atol=1e-2)


def test_crop_affine_matches_general_warp_nearest():
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 2.0, size=(48, 64, 3)).astype(np.float32)
    tfs = _crop_tfs(rng, 5)
    tfs[:, 0, 2] = np.round(tfs[:, 0, 2]) + 0.25
    tfs[:, 1, 2] = np.round(tfs[:, 1, 2]) + 0.25
    ref = imops.warp_perspective(img, tfs, (40, 40), mode="nearest").numpy()
    fast = imops.warp_crop_affine(img, tfs, (40, 40), mode="nearest").numpy()
    assert np.isclose(fast, ref).mean() > 0.995


def test_2d_image_and_single_tf():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, size=(32, 32)).astype(np.float32)
    tf = _crop_tfs(rng, 1)[0]
    ref = imops.warp_perspective(img, tf, (16, 16), mode="bilinear")
    fast = imops.warp_crop_affine(img, tf, (16, 16), mode="bilinear")
    assert fast.shape == ref.shape == (16, 16)
    np.testing.assert_allclose(fast.numpy(), ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jimops.warp_perspective(
        img, tf, (16, 16), mode="bilinear")), atol=1e-5)


def test_zero_outside():
    img = np.ones((20, 20, 1), np.float32)
    tf = np.eye(3, dtype=np.float32)
    tf[0, 2] = -15.0  # shifts the sampling window past the right edge
    out = imops.warp_perspective(img, tf[None], (20, 20)).numpy()
    assert out[:, :, 6:].max() == 0.0 and out[:, :, :4].min() == 1.0
