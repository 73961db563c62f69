"""Instant-NGP multiresolution hash-grid encoder.

Counterpart of foundationpose_tpu/ops/hashgrid.py (``level_resolutions``,
``level_table_sizes``, ``_grid_index``, ``hash_encode``, ``HashGridEncoder``),
itself modelled on the reference's CUDA grid encoder
(bundlesdf/mycuda/torch_ngp_grid_encoder/gridencoder.cu: fast_hash :36-51,
tiled-vs-hashed indexing :54-72, trilinear forward :95-244, atomic
scatter-add backward :248-334).

The forward is one ``index_select`` of the table per level (all 8 corners at
once) and trilinear weights; autograd of ``index_select`` is ``index_add_``,
the scatter-add the reference's backward kernel writes by hand. Same
prime-XOR hash, same per-level dense-vs-hashed switch, same geometric level
growth, corners summed in the JAX package's order.

The hash is uint32 arithmetic with wrap-around. Torch has no general uint32
arithmetic, so each product is taken in int64 and masked to its low 32 bits
before the XOR and the modulo, which gives the same bits.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

# fast_hash primes (gridencoder.cu:36-51); index 0 intentionally 1 so dense
# grids reduce to row-major indexing
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF
# corner offsets in the JAX package's loop order (dx, then dy, then dz)
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def level_resolutions(num_levels, base_resolution, desired_resolution):
    """Per-level grid resolutions with geometric growth
    (instant-ngp eq. 2-3; grid.py:109-122)."""
    if num_levels > 1:
        b = math.exp(math.log(desired_resolution / base_resolution) / (num_levels - 1))
    else:
        b = 1.0
    return [int(math.ceil(base_resolution * (b**l))) for l in range(num_levels)]


def level_table_sizes(resolutions: Sequence[int], log2_hashmap_size: int):
    """Entries per level: dense (R+1)^3 when it fits, else 2^log2_hashmap_size,
    aligned up to 8 like the reference (grid.py:112-116)."""
    max_entries = 2**log2_hashmap_size
    sizes = []
    for R in resolutions:
        size = min((R + 1) ** 3, max_entries)
        sizes.append(int((size + 7) // 8) * 8)
    return sizes


def _grid_index(coords, R, table_size):
    """coords: (..., 3) int64 lattice corners in [0, R]. Dense row-major when
    the level fits, prime-XOR hash (uint32, wrapping) otherwise."""
    if (R + 1) ** 3 <= table_size:
        return coords[..., 0] * ((R + 1) ** 2) + coords[..., 1] * (R + 1) + coords[..., 2]
    h = ((coords[..., 0] * _PRIMES[0]) & _U32) \
        ^ ((coords[..., 1] * _PRIMES[1]) & _U32) \
        ^ ((coords[..., 2] * _PRIMES[2]) & _U32)
    return h % table_size


def hash_encode(x, table, resolutions, offsets, table_sizes):
    """Encode points with a multires hash grid.

    x: (N,3) in [-1, 1]; table: (total_entries, F). Returns (N, L*F).
    """
    u = torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)
    # (8,3) corner offsets, built on the device (no upload per call)
    corners = torch.stack(torch.meshgrid(*[torch.arange(2, device=x.device)] * 3,
                                         indexing="ij"), dim=-1).reshape(8, 3)
    outs = []
    for l, R in enumerate(resolutions):
        p = u * R
        c0 = torch.clamp(torch.floor(p).long(), 0, R - 1)
        frac = p - c0
        idx = _grid_index(c0[:, None, :] + corners[None], R, table_sizes[l]) + offsets[l]
        feats = torch.index_select(table, 0, idx.reshape(-1)).reshape(x.shape[0], 8, -1)
        one_m = 1 - frac
        level = None
        for k, (dx, dy, dz) in enumerate(_CORNERS):
            w = ((frac[:, 0] if dx else one_m[:, 0])
                 * (frac[:, 1] if dy else one_m[:, 1])
                 * (frac[:, 2] if dz else one_m[:, 2]))
            term = feats[:, k] * w[:, None]
            level = term if level is None else level + term
        outs.append(level)
    return torch.cat(outs, dim=-1)


class HashGridEncoder(nn.Module):
    """Module owning the embedding table, initialised U(-1e-4, 1e-4) like
    torch-ngp. Defaults are the reference's BundleSDF config
    (config_ycbv.yml:44-47): 16 levels x 2 features, 2^22 hashmap, base 32 ->
    finest 512."""

    def __init__(self, num_levels=16, level_dim=2, base_resolution=32,
                 desired_resolution=512, log2_hashmap_size=22, generator=None):
        super().__init__()
        self.num_levels, self.level_dim = num_levels, level_dim
        self.resolutions = level_resolutions(num_levels, base_resolution, desired_resolution)
        self.table_sizes = level_table_sizes(self.resolutions, log2_hashmap_size)
        offsets = np.concatenate([[0], np.cumsum(self.table_sizes)])
        self.offsets = tuple(int(o) for o in offsets[:-1])
        total = int(offsets[-1])
        table = torch.rand((total, level_dim), generator=generator) * 2e-4 - 1e-4
        self.table = nn.Parameter(table)

    @property
    def out_dim(self):
        return self.num_levels * self.level_dim

    def forward(self, x):
        return hash_encode(x, self.table, self.resolutions, self.offsets, self.table_sizes)
