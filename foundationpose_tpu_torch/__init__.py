"""foundationpose_tpu_torch — the PyTorch/CUDA port of the JAX package beside it.

Same sub-packages and module names as the JAX package (``core``, ``ops``,
``models``, ``engine``, ``apps``) so each counterpart is easy to find. The
port imports torch, numpy and scipy only — never jax, flax or any module of
the JAX package.

Device rule: every entry point takes ``device=None`` meaning ``"cuda"`` and
raises when no CUDA device is present; only an explicit ``device="cpu"``
runs on the CPU (what the parity tests pass).

Precision: float32 products here are camera geometry (projection, crop
transforms, pose composition), where TF32's ~3 decimal digits cost
millimetres. The JAX package pins its matmuls to ``highest`` for the same
reason; the port turns TF32 off for both matmuls and cuDNN convolutions.
The nets opt into bfloat16 explicitly (``RefinerConfig.dtype``).
"""

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
