"""The port's host C++ pose clustering (foundationpose_tpu_torch/native/cluster.cpp,
built with g++ at first use) against its numpy plain version and the JAX
package's clustering, bit for bit (the kept poses are copies of the inputs,
so equal sets are equal bits), as tests/test_poses_mesh.py:52 holds the JAX
package's native library."""

import os
import shutil

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from foundationpose_tpu.core import poses as jposes
from foundationpose_tpu_torch import native
from foundationpose_tpu_torch.core import poses
from foundationpose_tpu_torch.ops import kernels

CONTINUOUS_Z = {"symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]}


def random_poses(n, seed, trans_sigma):
    rng = np.random.default_rng(seed)
    ps = np.tile(np.eye(4)[None], (n, 1, 1))
    ps[:, :3, :3] = Rotation.random(n, rng=rng).as_matrix()
    ps[:, :3, 3] = rng.normal(0, trans_sigma, (n, 3))
    return ps


@pytest.mark.parametrize("case", ["rotations only", "translation gate", "z symmetry"])
def test_native_matches_numpy_and_jax(case):
    ps = random_poses(300, {"rotations only": 0, "translation gate": 1, "z symmetry": 2}[case],
                      0.0 if case == "rotations only" else 0.05)
    sym = poses.symmetry_tfs_from_info(CONTINUOUS_Z, 20) if case == "z symmetry" else np.eye(4)[None]
    dist = 99999.0 if case == "rotations only" else 0.05
    calls = native.CALLS["fp_cluster_poses"]
    kept = poses.cluster_poses(30.0, dist, ps, sym)
    assert native.CALLS["fp_cluster_poses"] == calls + 1  # through the library
    plain = poses.cluster_poses_plain(30.0, dist, ps, sym)
    assert 1 < len(kept) < len(ps)
    np.testing.assert_array_equal(kept, plain)
    np.testing.assert_array_equal(kept, jposes.cluster_poses(30.0, dist, ps, sym))


def test_rotation_grid_matches_jax():
    for kw in ({}, dict(min_n_views=12, inplane_step=120),
               dict(symmetry_tfs=poses.symmetry_tfs_from_info(CONTINUOUS_Z, 5))):
        np.testing.assert_array_equal(poses.make_rotation_grid(**kw),
                                      jposes.make_rotation_grid(**kw))


def test_edge_cases_match_numpy():
    one = random_poses(1, 3, 0.0)
    np.testing.assert_array_equal(poses.cluster_poses(30.0, 1.0, one), one)
    dup = np.concatenate([one, one, random_poses(2, 4, 0.0)])
    np.testing.assert_array_equal(poses.cluster_poses(30.0, 1.0, dup),
                                  poses.cluster_poses_plain(30.0, 1.0, dup))


def test_a_failed_build_raises(monkeypatch, tmp_path):
    """No compiler, or a source that does not compile: the call raises and
    nothing gives way to the numpy version. The card kernels' build
    (``ops/kernels.py``, through the same ``compile_libraries``; g++ stands
    in for nvcc) raises the same way, naming the source, and loads and keeps
    nothing."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "FLAGS", native.FLAGS + ["-DFP_TEST_NO_COMPILER"])
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        poses.cluster_poses(30.0, 1.0, random_poses(4, 5, 0.0))
    monkeypatch.undo()
    bad = tmp_path / "cluster.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        poses.cluster_poses(30.0, 1.0, random_poses(4, 5, 0.0))
    bad_cu = tmp_path / "bad.cu"
    bad_cu.write_text("this is not CUDA\n")
    monkeypatch.setattr(kernels, "LIBRARIES", {
        "K1s": kernels.Library(str(bad_cu), (), "fp_bad_launch", (), "raster.K1s")})
    monkeypatch.setattr(kernels, "nvcc", lambda: shutil.which("g++"))
    monkeypatch.setattr(kernels, "NVCC_FLAGS", ["-x", "c++", "-shared", "-fPIC"])
    monkeypatch.setattr(kernels, "_paths", None)
    monkeypatch.setattr(kernels, "_fns", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for .*bad.cu"):
        kernels.launch("K1s", "cpu")
    assert kernels._paths is None and kernels._fns is None
    assert not [f for f in os.listdir(tmp_path / "_build") if f.endswith(".so")]
