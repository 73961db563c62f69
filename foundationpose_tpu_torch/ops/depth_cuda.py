"""CUDA depth preprocess: a frame's erode, bilateral filter and xyz map as one
kernel.

Replaces no Pallas kernel. It is the counterpart of the XLA stencils
foundationpose_tpu/ops/image.py::erode_depth and ::bilateral_filter_depth
plus foundationpose_tpu/core/geometry.py::depth2xyzmap, which the port runs
as eager tensor ops (``ops/image.py``, ``core/geometry.py``): 25 shifted views
through each stencil pass, ~870 kernel launches per frame. It was added
because the H100 profile of a tracked frame showed 873 of the frame's 2,578
launches there, each a ~2 us kernel behind ~10 us of host dispatch, with the
card idle; ``register`` then reads the filtered depth on the host, so the
whole preprocess sat on the critical path of every call.

**K2** (``csrc/depth_preprocess.cu``): a block owns a 32 x 8 output tile,
loads the depth with a 4-pixel ring into shared memory, erodes the tile and a
2-pixel ring there, runs both bilateral passes from shared memory and writes
the filtered depth and the xyz map once; the intrinsics are read on the
device. Its arithmetic is the plain composition's, op for op and in the same
order, so the two agree bit for bit on the card.

What bounds it on an H100: bytes, 20 per pixel (4 read, 16 written), 1.8 us
at 480x640 and 0.3 us at the tracker's 224x224 pre-crop. So the launch is
the cost, and the design's point is one launch, no intermediate in device
memory and no host round trip.

Dispatch rule: a CUDA tensor goes to the kernel (a build, load or launch
failure raises; radius 2 and the plain functions' default thresholds are
compiled in, and the wrapper takes no other); a CPU tensor goes to the plain
composition. There is no fallback from one to the other. ``ops/kernels.py``
builds, loads, launches and counts it.
"""

from __future__ import annotations

import torch

from foundationpose_tpu_torch.core import geometry as geo
from foundationpose_tpu_torch.ops import image as imops
from foundationpose_tpu_torch.ops import kernels

RADIUS = 2  # of both stencils; compiled into the kernel


def plain_preprocess(depth, K=None):
    """The plain composition: ``erode_depth`` -> ``bilateral_filter_depth``
    (both at ``RADIUS``) -> ``depth2xyzmap``. Returns (d, xyz), xyz None when
    ``K`` is None."""
    d = imops.bilateral_filter_depth(imops.erode_depth(depth, radius=RADIUS), radius=RADIUS)
    return d, (None if K is None else geo.depth2xyzmap(d, K))


def preprocess(depth, K=None):
    """erode -> bilateral -> xyz map of one (H,W) depth frame, in metres, at
    ``RADIUS`` and the plain functions' default thresholds. Returns (d (H,W),
    xyz (H,W,3)); with ``K`` None only the filter runs and xyz is None. A CUDA
    tensor runs K2 (``K`` a contiguous (3,3) float32 tensor on its device); a
    CPU tensor runs the plain composition."""
    if not (isinstance(depth, torch.Tensor) and depth.is_cuda):
        return plain_preprocess(depth, K)
    H, W = depth.shape if depth.ndim == 2 else (0, 0)
    if not (depth.dtype == torch.float32 and depth.is_contiguous()
            and 1 <= H <= 8 * 65535 and W >= 1):
        raise ValueError(f"depth kernel: depth must be a contiguous (H,W) float32 frame, "
                         f"got {tuple(depth.shape)} {depth.dtype}")
    if K is not None and not (isinstance(K, torch.Tensor) and K.device == depth.device
                              and K.dtype == torch.float32 and tuple(K.shape) == (3, 3)
                              and K.is_contiguous()):
        got = (f"{tuple(K.shape)} {K.dtype} on {K.device}" if isinstance(K, torch.Tensor)
               else type(K).__name__)
        raise ValueError(f"depth kernel: K must be a contiguous (3,3) float32 tensor on "
                         f"{depth.device}, got {got}")
    out = torch.empty_like(depth)
    xyz = None if K is None else torch.empty((H, W, 3), dtype=torch.float32, device=depth.device)
    kernels.launch("K2", depth.device, depth.data_ptr(), None if K is None else K.data_ptr(),
                   H, W, out.data_ptr(), None if xyz is None else xyz.data_ptr())
    return out, xyz
