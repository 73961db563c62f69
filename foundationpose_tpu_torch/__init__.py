"""foundationpose_tpu_torch — the PyTorch/CUDA port of the JAX package beside it.

Same sub-packages and module names as the JAX package (``core``, ``ops``,
``models``, ``engine``, ``apps``) so each counterpart is easy to find. The
port imports torch, numpy and scipy only — never jax, flax or any module of
the JAX package.

Device rule: every entry point takes ``device=None`` meaning ``"cuda"`` and
raises when no CUDA device is present; only an explicit ``device="cpu"``
runs on the CPU (what the parity tests pass). Host arrays reach a device
through ``upload`` (pinned staging and an asynchronous copy on CUDA).

Precision: float32 products here are camera geometry (projection, crop
transforms, pose composition), where TF32's ~3 decimal digits cost
millimetres. The JAX package pins its matmuls to ``highest`` for the same
reason; the port turns TF32 off for both matmuls and cuDNN convolutions.
The nets opt into bfloat16 explicitly (``RefinerConfig.dtype``).
"""

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda (raises without a CUDA device); anything else is
    taken as given. The CPU is never chosen silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present: the port runs on the GPU unless "
                "device='cpu' is passed explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


def upload(array, device, dtype=None):
    """numpy array or tensor -> tensor on ``device``. On a CUDA device a host
    array is staged in pinned memory and copied asynchronously on the current
    stream (the pinned block is recycled only after the copy has run); on the
    CPU it is copied into a new tensor. ``dtype`` converts on the host first.
    A tensor already on a device is moved (not copied) to ``device``."""
    t = array if torch.is_tensor(array) else torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    if t.device.type != "cpu":
        return t.to(device)
    if device.type != "cuda":
        return t.clone()  # never an alias of the caller's array
    return t.pin_memory().to(device, non_blocking=True)
