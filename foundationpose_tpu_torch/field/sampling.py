"""Occupancy-guided ray sampling for the neural object field.

Counterpart of foundationpose_tpu/field/sampling.py: a dense boolean
occupancy grid over the normalised [-1,1]^3 object volume (built on the host
from the fused depth cloud), slab-method ray / box entry and exit,
stratified [near, far] samples masked by an occupancy lookup, the +/-
truncation band around the observed depth, and inverse-CDF importance
sampling.

Every random draw is split from the arithmetic: ``stratified_samples``,
``sample_pdf`` and ``sample_rays`` take their uniforms as tensors (the
runner draws them from a ``torch.Generator``; the tests feed the JAX
package's ``jax.random`` draws). Three behaviours of the JAX package are kept
as they are:

- ``build_occupancy_grid``'s dilation wraps around the grid (``np.roll``);
  its "clear the wrapped faces" lines change nothing;
- the dilation is 6-neighbour per pass, although its docstring says 26;
- ``ray_box_intersect`` replaces a tiny direction component of either sign
  with +1e-12.
"""

from __future__ import annotations

import numpy as np
import torch


def build_occupancy_grid(points, resolution=64, dilate=2):
    """points: (N,3) in [-1,1] (the fused, normalized depth cloud).
    Returns (R,R,R) bool with ``dilate`` passes of dilation (6-neighbour per
    pass, wrapping around the grid, as the JAX package does). Host numpy."""
    pts = np.asarray(points)
    R = resolution
    ijk = np.floor((pts + 1.0) / 2.0 * R).astype(np.int64)
    ijk = np.clip(ijk, 0, R - 1)
    grid = np.zeros((R, R, R), dtype=bool)
    grid[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    for _ in range(dilate):
        g = grid.copy()
        for axis in range(3):
            g |= np.roll(grid, 1, axis) | np.roll(grid, -1, axis)
        grid = g
    return grid


def occupancy_lookup(grid, pts):
    """grid: (R,R,R) bool tensor; pts: (...,3) in [-1,1]. Points outside ->
    False."""
    R = grid.shape[0]
    ijk = torch.floor((pts + 1.0) / 2.0 * R).long()
    inside = ((ijk >= 0) & (ijk < R)).all(dim=-1)
    ijk = ijk.clamp(0, R - 1)
    return grid[ijk[..., 0], ijk[..., 1], ijk[..., 2]] & inside


def ray_box_intersect(origins, dirs, lo=-1.0, hi=1.0):
    """Slab method (reference nerf_helpers.py:432-475). origins/dirs: (N,3);
    with cam dirs of z = 1, t is camera depth. Returns (tmin, tmax); a miss
    gives (-1, -1); tmin clamped >= 0."""
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    t0 = (lo - origins) * inv
    t1 = (hi - origins) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    tmin = torch.maximum(tmin, torch.zeros_like(tmin))
    hit = tmax > tmin
    miss = torch.full_like(tmin, -1.0)
    return torch.where(hit, tmin, miss), torch.where(hit, tmax, miss)


def linspace01(n, device=None):
    """``jnp.linspace(0, 1, n)`` in float32, value for value: XLA turns its
    ``i / (n - 1)`` into i times the float32 reciprocal of n - 1."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return i * float(np.float32(1.0) / np.float32(max(n - 1, 1)))


def stratified_samples(u, near, far):
    """Stratified uniform samples in [near, far]. near/far: (N,1); u: (N,S)
    uniforms in [0, 1)."""
    t = linspace01(u.shape[1], u.device)[None]
    z = near + (far - near) * t
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    upper = torch.cat([mids, z[:, -1:]], dim=-1)
    lower = torch.cat([z[:, :1], mids], dim=-1)
    return lower + (upper - lower) * u


def sample_pdf(u, bins, weights, n_samples=None, deterministic=False):
    """Inverse-CDF importance sampling along rays (reference
    nerf_helpers.py:358-385). bins: (N,B); weights: (N,B-1); u: (N,S)
    uniforms, or None with ``deterministic`` (then ``n_samples`` evenly
    spaced quantiles). Returns (N,S)."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (N,B)
    if deterministic:
        u = linspace01(n_samples, cdf.device)[None].expand(cdf.shape[0], n_samples)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp_min(0)
    above = inds.clamp_max(cdf.shape[-1] - 1)
    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)


def sample_rays(u_uniform, u_depth, rays_o, rays_d, depth, occ_grid, trunc,
                neg_trunc_ratio=1.0, far_default=2.0, sort=True):
    """Per-ray sample depths + validity.

    rays_o/rays_d: (N,3) in the normalized world frame (``rays_d`` is the CV
    camera direction rotated to world, z-component 1 in the camera, so the
    sample parameter is camera depth). depth: (N,) observed depth. u_uniform:
    (N, n_uniform) and u_depth: (N, n_around_depth) uniforms — the JAX
    package's two draws from ``split(key)``. Returns z_vals (N, n_uniform +
    n_around_depth) and valid (N,S) bool. ``sort=False`` skips the along-ray
    ordering, which no order-free training loss needs.
    """
    tmin, tmax = ray_box_intersect(rays_o, rays_d)
    hit = tmin >= 0
    near = torch.where(hit, tmin, torch.zeros_like(tmin))[:, None]
    far = torch.where(hit, tmax, torch.full_like(tmax, far_default))[:, None]
    z_uniform = stratified_samples(u_uniform, near, far)

    valid_depth = (depth > 0.0) & (depth < far_default)
    nd = torch.where(valid_depth, depth, torch.full_like(depth, 0.5 * far_default))[:, None]
    z_depth = stratified_samples(u_depth, nd - trunc, nd + trunc * neg_trunc_ratio)

    z_vals = torch.cat([z_uniform, z_depth], dim=-1)
    if sort:
        z_vals = torch.sort(z_vals, dim=-1).values
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    valid = occupancy_lookup(occ_grid, pts) & hit[:, None]
    return z_vals, valid
