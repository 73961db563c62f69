"""Faults planted in the pose engine, underneath a run, to show that the
judge fails them: a refine step that returns its poses unchanged, half of
the hypotheses of every refine call left unrefined, and the returned pose
altered (1 mm) where it is produced. Each patches the engine's classes and
puts them back after the block."""

import contextlib

import numpy as np
import torch

from .spans import Patches


def _unchanged(fn, self, mesh_tensors, rgb, xyz_map, K, poses, *args, **kwargs):
    return poses.float().clone()


def _half(fn, self, mesh_tensors, rgb, xyz_map, K, poses, *args, **kwargs):
    out = fn(self, mesh_tensors, rgb, xyz_map, K, poses, *args, **kwargs)
    n = poses.shape[0] // 2
    return torch.cat([poses[:n].float(), out[n:]])


def _shifted(fn, self, *args, **kwargs):
    pose = np.array(fn(self, *args, **kwargs), dtype=np.float64)
    pose[:3, 3] += 0.001
    return pose


NAMES = ("unchanged", "half", "answer")


@contextlib.contextmanager
def planted(name):
    from foundationpose_tpu_torch.engine import estimator, geometric, refiner

    p = Patches()
    if name in ("unchanged", "half"):
        for cls in (refiner.PoseRefiner, geometric.GeometricRefiner):
            p.patch(cls, "refine", _unchanged if name == "unchanged" else _half)
    elif name == "answer":
        for attr in ("register", "track_one"):
            p.patch(estimator.FoundationPoseTorch, attr, _shifted)
    else:
        raise KeyError(f"no fault {name!r}: {NAMES}")
    try:
        yield
    finally:
        p.restore()
