"""What the pose traffic kinds' generators share: a pool of frames, the
camera, the object resting on the table, the boxes beside it, the seeded
streams, and the order in which a loop takes the pool's frames.
"""

import numpy as np
import torch

from reference import raster

from . import scene


class Frames:
    """A pool of frames and what made them."""

    def __init__(self, K, rgb, depth, mask, gt):
        self.K, self.rgb, self.depth, self.mask, self.gt = K, rgb, depth, mask, gt

    def __len__(self):
        return len(self.rgb)


def intrinsics(cam):
    return np.array([[cam["fx"], 0, cam["cx"]], [0, cam["fy"], cam["cy"]], [0, 0, 1]], np.float64)


def resting(obj_v, R):
    """Object -> world with rotation R, resting on the table at the origin."""
    T = np.eye(4)
    T[:3, :3] = R
    T[2, 3] = -(obj_v @ R.T)[:, 2].min()
    return T


def camera(target, dist, az, el):
    pos = target + dist * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
    return scene.look_at(pos, target)


def boxes_of(rng, obj, device):
    """Two seeded boxes beside the object, as reference mesh tensors."""
    radius = float(np.linalg.norm(np.asarray(obj["vertices"]), axis=-1).max())
    b = scene.make_boxes(rng, radius + 0.03)
    return raster.mesh_tensors(b["vertices"], b["faces"], b["normals"], colors=b["colors"],
                               device=device)


def renderer(seed, cfg, obj, device):
    """The camera, the table and the reference renderer of a run's frames."""
    cam = cfg["camera"]
    K = intrinsics(cam)
    return K, scene.Renderer(obj, scene.make_table(seed, device), K,
                             (cam["height"], cam["width"]), device)


def streams(seed, device):
    """The run's host and device random streams (a second, third... use of
    one seed draws from streams of their own)."""
    rng = np.random.default_rng([seed % 2**64, 2])
    gen = torch.Generator(device=device).manual_seed((seed + 3) % 2**63)
    return rng, gen


def pool_index(i, n, pingpong):
    """The pool frame of the ``i``-th call."""
    if not pingpong:
        return i % n
    p = i % (2 * n - 2)
    return p if p < n else 2 * n - 2 - p
