"""Direction / position encoders for the neural object field.

Counterpart of foundationpose_tpu/field/encoders.py: analytic real spherical
harmonics to degree 5 (``sh_encode``, reference nerf_helpers.py SHEncoder
:68-151), NeRF frequency embedding (``freq_encode``, Embedder :154-185) and
the multi-resolution triplane encoder (``TriplaneEncoder``).

The triplane's value per level is the sum over its three planes of a
bilinear lookup:

    out[n, c] = sum_ij  Wa[n, i] * Wb[n, j] * plane[i, j, c]

where Wa / Wb are the 2-tap linear-interpolation rows of the two axes. The
JAX package evaluates it as one-hot matmuls (``_axis_taps`` rows of length
R + 1), which at 524,288 points and R = 128 would hold ~1 GB of (N, R+1, C)
intermediates per plane here; the port computes the same function as a
4-tap gather per plane. ``_TriplaneEval`` is the counterpart of
``_triplane_eval`` (a ``jax.custom_vjp``) and writes its analytic VJP
(plane gradient: a 4-tap ``index_add``; point gradient: the derivative taps
of ``_axis_dtaps``, zero outside [0, 1]). The backward is itself plain
differentiable torch ops, so a gradient of a gradient (the eikonal
regulariser) flows through it, as JAX differentiates through its bwd rule.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_C0 = 0.28209479177387814
_C1 = 0.4886025119029199
_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
       -1.0925484305920792, 0.5462742152960396)
_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
       0.3731763325901154, -0.4570457994644658, 1.445305721320277,
       -0.5900435899266435)
_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
       -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
       0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def sh_encode(dirs, degree=3):
    """Real SH basis of unit directions. (..., 3) -> (..., degree^2)."""
    assert 1 <= degree <= 5
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, _C0)]
    if degree > 1:
        out += [-_C1 * y, _C1 * z, -_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            _C2[0] * xy,
            _C2[1] * yz,
            _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz,
            _C2[4] * (xx - yy),
        ]
    if degree > 3:
        out += [
            _C3[0] * y * (3 * xx - yy),
            _C3[1] * xy * z,
            _C3[2] * y * (4 * zz - xx - yy),
            _C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
            _C3[4] * x * (4 * zz - xx - yy),
            _C3[5] * z * (xx - yy),
            _C3[6] * x * (xx - 3 * yy),
        ]
    if degree > 4:
        out += [
            _C4[0] * xy * (xx - yy),
            _C4[1] * yz * (3 * xx - yy),
            _C4[2] * xy * (7 * zz - 1),
            _C4[3] * yz * (7 * zz - 3),
            _C4[4] * (zz * (35 * zz - 30) + 3),
            _C4[5] * xz * (7 * zz - 3),
            _C4[6] * (xx - yy) * (7 * zz - 1),
            _C4[7] * xz * (xx - 3 * yy),
            _C4[8] * (xx * (xx - 3 * yy) - yy * (3 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def sh_out_dim(degree):
    return degree**2


def freq_encode(x, num_freqs, include_input=True):
    """NeRF positional encoding with log-sampled frequencies 2^0..2^(n-1)."""
    outs = [x] if include_input else []
    for i in range(num_freqs):
        f = 2.0**i
        outs.append(torch.sin(x * f))
        outs.append(torch.cos(x * f))
    return torch.cat(outs, dim=-1)


def freq_out_dim(num_freqs, d=3, include_input=True):
    return d * (2 * num_freqs + (1 if include_input else 0))


# ---------------------------------------------------------------------------
# multi-resolution triplanes


def clip(x, lo, hi):
    """``jnp.clip``: maximum, then minimum, whose gradients split a tie in
    half (``torch.clamp`` passes all of it)."""
    full = lambda v: torch.full((), v, dtype=x.dtype, device=x.device)  # noqa: E731
    return torch.minimum(torch.maximum(x, full(lo)), full(hi))


def _axis_taps(x01, R):
    """x01 (N,) -> lower tap index i0 (N,) int64 and weight f of tap i0 + 1
    (tap i0 weighs 1 - f), as the JAX package's ``_axis_taps`` rows hold them.
    The clamp below R is the float32 value of ``R - 1e-6`` (R itself for
    R >= 32), so a point at 1 has i0 = R and f = 0 there."""
    g = clip(x01, 0.0, 1.0) * R
    hi = torch.full((), R - 1e-6, dtype=x01.dtype, device=x01.device)
    i0 = torch.floor(torch.minimum(g, hi)).detach()
    return i0.long(), g - i0


def _inside(x01, R):
    """R where x01 lies in [0, 1], 0 elsewhere: ``_axis_dtaps``' scale."""
    return ((x01 >= 0.0) & (x01 <= 1.0)).to(x01.dtype) * R


def _plane_taps(plane, ia, ib, R):
    """The four corner values (N, C) of a flattened ((R+1)^2, C) plane at
    (ia, ib), (ia+1, ib), (ia, ib+1), (ia+1, ib+1), and whether the a+1 and
    b+1 taps lie on the grid (a tap at R + 1 has weight 0 in the forward and
    does not exist in the JAX package's one-hot rows)."""
    ia1, ib1 = (ia + 1).clamp_max(R), (ib + 1).clamp_max(R)
    n, C = R + 1, plane.shape[-1]
    idx = torch.stack([ia * n + ib, ia1 * n + ib, ia * n + ib1, ia1 * n + ib1])
    # an element gather: on an H100 a row gather (index_select) of 2.1 M
    # 16-byte rows took 1.26 ms, this one 0.10-0.13 ms
    flat = (idx.reshape(-1, 1) * C + torch.arange(C, device=idx.device)).reshape(-1)
    v = plane.reshape(-1)[flat].reshape(4, ia.shape[0], C)
    return v, ia + 1 <= R, ib + 1 <= R


def _combo(v, fa, fb):
    """sum_ij Wa Wb P for one plane from its four taps, in the JAX package's
    order: along a first (the matmul), then along b."""
    fa, fb = fa[:, None], fb[:, None]
    t0 = (1 - fa) * v[0] + fa * v[1]
    t1 = (1 - fa) * v[2] + fa * v[3]
    return (1 - fb) * t0 + fb * t1


_PLANE_AXES = ((0, 1), (0, 2), (1, 2))


def triplane_forward(planes, pts, resolutions, channels):
    """planes: tuple of (3, R+1, R+1, C) per level; pts (N,3) in [-1,1].
    Returns (N, L*C). Plain differentiable ops (what the tests hold the
    custom backward against)."""
    x01 = (pts + 1.0) * 0.5
    outs = []
    for p, R in zip(planes, resolutions):
        taps = [_axis_taps(x01[:, a], R) for a in range(3)]
        level = 0.0
        for k, (a, b) in enumerate(_PLANE_AXES):
            (ia, fa), (ib, fb) = taps[a], taps[b]
            v, _, _ = _plane_taps(p[k].reshape(-1, channels), ia, ib, R)
            level = level + _combo(v, fa, fb)
        outs.append(level)
    return torch.cat(outs, dim=-1)


def triplane_backward(planes, pts, g, resolutions, channels):
    """Analytic VJP of ``triplane_forward`` (JAX ``_triplane_eval_bwd``):
    plane gradient gP[i,j,c] = sum_n Wa[n,i] Wb[n,j] g[n,c] as a 4-tap
    ``index_add``; point gradient through the derivative taps (-R at i0, +R
    at i0 + 1 when that tap is on the grid, 0 outside [0, 1]) times
    d x01 / d pts = 0.5."""
    C = channels
    x01 = (pts + 1.0) * 0.5
    g_planes = []
    g_pts = [torch.zeros_like(pts[:, 0]) for _ in range(3)]
    off = 0
    for p, R in zip(planes, resolutions):
        gl = g[:, off:off + C]
        off += C
        taps = [_axis_taps(x01[:, a], R) for a in range(3)]
        inside = [_inside(x01[:, a], R) for a in range(3)]
        n = R + 1
        gp_level = []
        for k, (a, b) in enumerate(_PLANE_AXES):
            (ia, fa), (ib, fb) = taps[a], taps[b]
            v, ok_a, ok_b = _plane_taps(p[k].reshape(-1, C), ia, ib, R)
            fa_, fb_ = fa[:, None], fb[:, None]
            # plane gradient: the four taps' weights times g, scattered
            ia1, ib1 = (ia + 1).clamp_max(R), (ib + 1).clamp_max(R)
            idx = torch.cat([ia * n + ib, ia1 * n + ib, ia * n + ib1, ia1 * n + ib1])
            wb0, wb1 = (1 - fb_) * gl, fb_ * gl
            src = torch.cat([(1 - fa_) * wb0, fa_ * wb0, (1 - fa_) * wb1, fa_ * wb1])
            gP = torch.zeros((n * n, C), dtype=g.dtype, device=g.device).index_add(0, idx, src)
            gp_level.append(gP.reshape(n, n, C))
            # point gradients: d out / d x01[a] and d out / d x01[b]
            ma, mb = ok_a.to(v.dtype)[:, None], ok_b.to(v.dtype)[:, None]
            da0 = (ma * v[1] - v[0]) * inside[a][:, None]
            da1 = (ma * v[3] - v[2]) * inside[a][:, None]
            oa = (1 - fb_) * da0 + fb_ * da1
            db0 = (mb * v[2] - v[0]) * inside[b][:, None]
            db1 = (mb * v[3] - v[1]) * inside[b][:, None]
            ob = (1 - fa_) * db0 + fa_ * db1
            g_pts[a] = g_pts[a] + (oa * gl).sum(-1) * 0.5
            g_pts[b] = g_pts[b] + (ob * gl).sum(-1) * 0.5
        g_planes.append(torch.stack(gp_level))
    return g_planes, torch.stack(g_pts, dim=-1)


class _TriplaneEval(torch.autograd.Function):
    """``_triplane_eval`` with its analytic backward. The backward is written
    in differentiable torch ops (no ``once_differentiable``): under
    ``create_graph=True`` autograd records it, so a loss on the point
    gradient (eikonal) differentiates through it."""

    @staticmethod
    def forward(ctx, pts, resolutions, channels, *planes):
        ctx.resolutions, ctx.channels = resolutions, channels
        ctx.save_for_backward(pts, *planes)
        return triplane_forward(planes, pts, resolutions, channels)

    @staticmethod
    def backward(ctx, g):
        pts, *planes = ctx.saved_tensors
        g_planes, g_pts = triplane_backward(planes, pts, g, ctx.resolutions, ctx.channels)
        return (g_pts, None, None, *g_planes)


def triplane_eval(planes, pts, resolutions, channels):
    return _TriplaneEval.apply(pts, tuple(resolutions), channels, *planes)


class TriplaneEncoder(nn.Module):
    """Multi-resolution triplane features. Output: concat over levels of the
    3-plane SUM (TensoRF decomposition), (N, len(resolutions) * channels).
    Parameters ``planes_{R}`` of shape (3, R+1, R+1, C), drawn N(0,
    ``init_scale``) as the JAX package draws them."""

    def __init__(self, resolutions=(16, 32, 64, 128), channels=2, init_scale=1e-2,
                 generator=None):
        super().__init__()
        self.resolutions, self.channels = tuple(resolutions), channels
        for R in self.resolutions:
            self.register_parameter(
                f"planes_{R}",
                nn.Parameter(torch.randn((3, R + 1, R + 1, channels), generator=generator)
                             * init_scale))

    def planes(self):
        return tuple(getattr(self, f"planes_{R}") for R in self.resolutions)

    def forward(self, pts):
        """pts: (N,3) in [-1,1] -> (N, L*C)."""
        return triplane_eval(self.planes(), pts, self.resolutions, self.channels)


def triplane_out_dim(resolutions, channels):
    return len(resolutions) * channels
