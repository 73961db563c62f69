"""Plain float32 reference of the pose engine's timed paths.

Plain PyTorch, written out again for the benchmark and frozen here: the
rasterizer, the crop warp and depth stencils, RefineNet / ScoreNet, the
learned refine step, the hybrid and geometric scores, the projective ICP step
and the tracking step. It imports nothing of the measured package and takes
only what the benchmark made (the object, the frames, the intrinsics) and the
raw weight files; whatever the program derives from those (centred mesh,
diameter, rotation grid, crop windows, preprocessed depth) it works out again.

Precision: float32 with TF32 off for matmuls and convolutions, which
``tf32(False)`` sets. ``nets.set_quant(net, "fp8")`` and ``tf32(True)`` give
the lower-precision controls that the correctness limits are set against.
"""

import contextlib

import torch


@contextlib.contextmanager
def tf32(enabled):
    """TF32 for matmuls and cuDNN convolutions on or off inside the block;
    the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
