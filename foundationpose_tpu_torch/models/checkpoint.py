"""Engine checkpoints: both nets of a ``FoundationPoseTorch`` in one file.

Counterpart of foundationpose_tpu/models/checkpoint.py::save_engine /
load_engine. The JAX package writes orbax PyTree directories; the port has
no orbax, so it writes one ``torch.save`` of both nets' state dicts
(``{"format": ..., "refiner": state_dict, "scorer": state_dict}``). The
orbax directories of the JAX package are not read here: the object-agnostic
npz checkpoint (``models/agnostic.py``) is the format both packages share.
"""

from __future__ import annotations

import logging
import os

import torch

FORMAT = "foundationpose_tpu_torch engine v1"


def save_engine(estimator, path):
    """Save the refiner's and the scorer's nets (a ``HybridScorer`` saves its
    learned half)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    state = {"format": FORMAT,
             "refiner": {k: v.cpu() for k, v in _net(estimator.refiner).state_dict().items()},
             "scorer": {k: v.cpu() for k, v in _net(estimator.scorer).state_dict().items()}}
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    logging.info("engine checkpoint saved to %s", path)


def is_engine_checkpoint(path):
    """True for a file ``save_engine`` wrote."""
    if not os.path.isfile(path):
        return False
    try:
        state = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # not a torch file, or not one of ours
        return False
    return isinstance(state, dict) and state.get("format") == FORMAT


def load_engine(estimator, path):
    """Load both nets (strict) from a ``save_engine`` file."""
    path = os.path.abspath(path)
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: orbax engine checkpoints of the JAX package are not read "
            "by the port; carry weights across as an object-agnostic checkpoint "
            "(refiner.npz + scorer.npz + meta.json, models/agnostic.py)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or state.get("format") != FORMAT:
        raise ValueError(f"{path} is not an engine checkpoint written by save_engine")
    _net(estimator.refiner).load_state_dict(state["refiner"], strict=True)
    _net(estimator.scorer).load_state_dict(state["scorer"], strict=True)
    logging.info("engine checkpoint loaded from %s", path)


def _net(part):
    """The net of a predictor, or of a ``HybridScorer``'s learned half."""
    if hasattr(part, "net"):
        return part.net
    if hasattr(part, "learned"):
        return part.learned.net
    raise TypeError(f"{type(part).__name__} has no net to checkpoint (geometric mode)")
