"""Carry the JAX package's parameters across to the port's modules.

``flax_params_to_state_dict`` turns the flat ``"params/a/b/kernel"`` ->
numpy dict that foundationpose_tpu/models/agnostic.py::save_params_npz
writes into a ``state_dict`` for the port's net. It is the inverse of the
torch -> flax map in foundationpose_tpu/models/weights.py:
conv kernels HWIO -> OIHW, dense kernels (in,out) -> (out,in), norm
``scale`` -> ``weight``; module paths are the same on both sides.
"""

from __future__ import annotations

import numpy as np
import torch


def flax_key_to_torch(key: str) -> str:
    parts = key.split("/")
    if parts[0] == "params":
        parts = parts[1:]
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[parts[-1]]
    return ".".join(parts[:-1] + [leaf])


def flax_params_to_state_dict(flat: dict, net: torch.nn.Module) -> dict:
    """``flat``: {"params/.../kernel|bias|scale": np.ndarray}. Returns a
    float32 state_dict for ``net``; raises on a missing, unexpected or
    wrong-shaped entry."""
    want = net.state_dict()
    out = {}
    for key, arr in flat.items():
        name = flax_key_to_torch(key)
        a = np.asarray(arr, dtype=np.float32)
        if key.endswith("/kernel"):
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            elif a.ndim == 2:
                a = a.T  # (in,out) -> (out,in)
            else:
                raise ValueError(f"{key}: unexpected kernel rank {a.ndim}")
        if name not in want:
            raise KeyError(f"unexpected parameter {key} (-> {name})")
        if tuple(want[name].shape) != a.shape:
            raise ValueError(f"{key}: shape {a.shape} != {tuple(want[name].shape)}")
        out[name] = torch.tensor(a)  # copies: the source may be a read-only view
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"missing parameters: {missing}")
    return out


def load_flax_npz(path: str, net: torch.nn.Module) -> None:
    """Load a ``save_params_npz`` file into ``net`` (strict)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    net.load_state_dict(flax_params_to_state_dict(flat, net), strict=True)
