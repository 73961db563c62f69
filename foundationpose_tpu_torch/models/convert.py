"""Carry the JAX package's parameters across to the port's modules.

``flax_params_to_state_dict`` turns the flat ``"params/a/b/kernel"`` ->
numpy dict that foundationpose_tpu/models/agnostic.py::save_params_npz
writes into a ``state_dict`` for the port's net. It is the inverse of the
torch -> flax map in foundationpose_tpu/models/weights.py:
conv kernels HWIO -> OIHW, dense kernels (in,out) -> (out,in), norm
``scale`` -> ``weight``; module paths are the same on both sides.
``state_dict_to_flax_params`` is the way back (what the port's trainers
write), and ``flax_init`` draws a net's parameters from flax's default
initialisers, the distribution the JAX package's training recipes start from.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn


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


def _flax_leaf(module: nn.Module, leaf: str) -> str:
    if leaf == "bias":
        return "bias"
    return "scale" if isinstance(module, (nn.GroupNorm, nn.LayerNorm)) else "kernel"


def state_dict_to_flax_params(net: torch.nn.Module) -> dict:
    """The port's parameters as the flat ``{"params/.../kernel|bias|scale":
    float32 array}`` dict the JAX package reads: conv OIHW -> HWIO, dense
    (out,in) -> (in,out), a norm's ``weight`` -> ``scale``. Exact (only
    transposes)."""
    flat = {}
    for name, t in net.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        key = "params/" + path.replace(".", "/") + "/" + _flax_leaf(net.get_submodule(path), leaf)
        a = t.detach().cpu().float().numpy()
        if key.endswith("/kernel"):
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        flat[key] = np.ascontiguousarray(a)
    return flat


# truncated at two standard deviations, the normal's std scaled so the
# truncated distribution has variance 1 (flax/jax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def flax_init(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Re-draw ``net``'s parameters as flax's defaults would: conv and dense
    kernels ``lecun_normal`` (truncated normal with variance 1 / fan_in), zero
    biases, norm scale 1 and bias 0. The draws come from a CPU
    ``torch.Generator`` seeded with ``seed`` (not flax's keys). Returns ``net``."""
    gen = torch.Generator().manual_seed(int(seed))
    for module in net.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            fan_in = w[0].numel()  # in-channels x kernel area, or in-features
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            draw = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            w.copy_(draw)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return net
