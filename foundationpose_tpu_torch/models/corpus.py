"""Randomized synthetic mesh corpus for object-agnostic training.

The port's own copy of foundationpose_tpu/models/corpus.py (pure numpy):
the same seeds give the same meshes, bit for bit.

The reference trains ONE RefineNet and ONE ScoreNet on a large corpus of
objects and applies them to novel objects, conditioning on the object only
through its renders (predict_pose_refine.py:93-147 loads a single
``weights/<run>/model_best.pth``; the training corpus itself is external and
absent from the snapshot). This module provides the corpus for our
from-scratch equivalent: randomized primitives and compounds — boxes,
cylinders, ellipsoids, multi-part unions — with randomized gray/vertex-color/
checker-texture appearance.

Distributional note (held-out evaluation): the accuracy suite's meshes
(evalsuite/scenes.py) use FIXED handpicked dimensions, colors and textures;
this corpus samples CONTINUOUS random dimensions from overlapping ranges with
its own seeds, so no evaluation mesh appears in training (measure-zero
collision) while the category coverage (flat faces, rotational symmetry,
compound asymmetry, texture) matches what the nets must generalize over.
"""

from __future__ import annotations

import numpy as np

from foundationpose_tpu_torch.core import meshio


def _sphere_uv(verts):
    v = np.asarray(verts, np.float64)
    r = np.linalg.norm(v, axis=-1)
    u = np.arctan2(v[:, 1], v[:, 0]) / (2 * np.pi) + 0.5
    vv = np.arccos(np.clip(v[:, 2] / np.maximum(r, 1e-12), -1, 1)) / np.pi
    return np.stack([u, vv], axis=-1)


def _checker(rng, size=256):
    n = int(rng.integers(4, 14))
    c0 = rng.integers(30, 230, 3)
    c1 = rng.integers(30, 230, 3)
    ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    cell = size // n
    board = ((ii // cell + jj // cell) % 2).astype(bool)
    return np.where(
        board[..., None], c0.astype(np.uint8), c1.astype(np.uint8)
    ).astype(np.uint8)


def _merge(meshes):
    verts = np.concatenate([m.vertices for m in meshes])
    offs = np.cumsum([0] + [len(m.vertices) for m in meshes[:-1]])
    faces = np.concatenate([m.faces + o for m, o in zip(meshes, offs)])
    return meshio.Mesh(verts, faces)


def _primitive(rng):
    kind = rng.choice(["box", "cylinder", "ellipsoid"])
    if kind == "box":
        ext = rng.uniform(0.03, 0.14, 3)
        return meshio.make_box(tuple(ext))
    if kind == "cylinder":
        r = rng.uniform(0.02, 0.06)
        h = rng.uniform(0.05, 0.16)
        return meshio.make_cylinder(r, h, n_seg=32)
    m = meshio.make_icosphere_mesh(subdivisions=3, radius=1.0)
    radii = rng.uniform(0.025, 0.08, 3)
    m.vertices = m.vertices * radii[None]
    m.vertex_normals = meshio.compute_vertex_normals(m.vertices, m.faces)
    return m


def random_training_mesh(seed: int) -> meshio.Mesh:
    """Deterministic random mesh: a primitive or a 2-4-part compound, with
    random appearance (uniform gray / random vertex colors / smooth vertex
    colors / checker texture)."""
    rng = np.random.default_rng(seed)
    n_parts = int(rng.choice([1, 1, 2, 3, 4]))
    parts = []
    for i in range(n_parts):
        p = _primitive(rng)
        if i > 0:
            # attach at a random offset so compounds are connected-ish
            off = rng.uniform(-0.05, 0.05, 3)
            p = p.translated(off)
        parts.append(p)
    mesh = _merge(parts) if len(parts) > 1 else parts[0]

    style = rng.choice(["gray", "vc_random", "vc_smooth", "texture"])
    V = len(mesh.vertices)
    if style == "gray":
        g = int(rng.integers(70, 220))
        mesh.vertex_colors = np.full((V, 3), g, np.uint8)
    elif style == "vc_random":
        mesh.vertex_colors = rng.integers(40, 230, (V, 3)).astype(np.uint8)
    elif style == "vc_smooth":
        # low-frequency color over the surface: affine in xyz + clip
        w = rng.uniform(-1, 1, (3, 3))
        b = rng.uniform(0.25, 0.75, 3)
        ext = np.abs(mesh.vertices).max() + 1e-9
        c = np.clip(mesh.vertices / ext @ w * 0.4 + b, 0.05, 0.95)
        mesh.vertex_colors = (c * 255).astype(np.uint8)
    else:
        mesh.uv = _sphere_uv(
            mesh.vertices - mesh.vertices.mean(0, keepdims=True)
        )
        mesh.texture = _checker(rng)
    return mesh


def build_corpus(n: int, seed: int = 0, textured_fraction=None):
    """n deterministic training meshes (seeds ``seed*10_000 + i``)."""
    return [random_training_mesh(seed * 10_000 + i) for i in range(n)]
