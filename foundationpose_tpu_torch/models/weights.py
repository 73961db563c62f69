"""Torch-checkpoint import: load the reference's released RefineNet/ScoreNet
weights into the port's nets.

The port's own copy of foundationpose_tpu/models/weights.py. The reference
expects ``weights/<run>/model_best.pth`` (predict_pose_refine.py:97-141,
predict_score.py:120-154). The mapping below is the JAX package's, numpy
only: it builds the flax parameter tree from a torch state_dict

- Conv2d OIHW -> flax HWIO; Linear (out,in) -> (in,out)
- torch MultiheadAttention fused in_proj (3D,D) -> the fused in_proj Dense
- BatchNorm (use_BN configs) FOLDED into the preceding conv, so the nets
  always run norm-free at inference
- the sinusoidal position table is a buffer and is recomputed, not loaded

and ``models/convert.py`` carries that tree into the port's modules (the
inverse layout map), so a checkpoint goes through the same two maps as in
the JAX package plus the one the shipped agnostic weights already use.
Flax-serialised ``.msgpack`` parameter files are read by a small msgpack
decoder of the port's own (``read_flax_msgpack``; no flax or msgpack
package), and a file written by ``models/checkpoint.save_engine`` loads as
it is.
"""

from __future__ import annotations

import logging
import os
import struct

import numpy as np

from foundationpose_tpu_torch.models.convert import flax_params_to_state_dict


def _t(x):
    return np.asarray(x, dtype=np.float32)


def _conv(sd, prefix):
    w = _t(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)  # OIHW -> HWIO
    out = {"kernel": w}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    else:
        out["bias"] = np.zeros(w.shape[-1], np.float32)
    return out


def _fold_bn(conv, sd, prefix, eps=1e-5):
    """Fold BatchNorm running stats + affine into the preceding conv."""
    gamma = _t(sd[f"{prefix}.weight"])
    beta = _t(sd[f"{prefix}.bias"])
    mean = _t(sd[f"{prefix}.running_mean"])
    var = _t(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    conv["kernel"] = conv["kernel"] * scale[None, None, None, :]
    conv["bias"] = (conv["bias"] - mean) * scale + beta
    return conv


def _linear(sd, prefix):
    return {
        "kernel": _t(sd[f"{prefix}.weight"]).T,
        "bias": _t(sd[f"{prefix}.bias"]),
    }


def _layernorm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _mha(sd, prefix):
    return {
        "in_proj": {
            "kernel": _t(sd[f"{prefix}.in_proj_weight"]).T,
            "bias": _t(sd[f"{prefix}.in_proj_bias"]),
        },
        "out_proj": _linear(sd, f"{prefix}.out_proj"),
    }


def _conv_bn_relu(sd, prefix, use_bn):
    """reference ConvBNReLU: net = Sequential[Conv2d, (BN), ReLU]."""
    conv = _conv(sd, f"{prefix}.net.0")
    if use_bn and f"{prefix}.net.1.running_mean" in sd:
        conv = _fold_bn(conv, sd, f"{prefix}.net.1")
    return {"conv": conv}


def _res_block(sd, prefix, use_bn):
    c1 = _conv(sd, f"{prefix}.conv1")
    c2 = _conv(sd, f"{prefix}.conv2")
    if use_bn and f"{prefix}.bn1.running_mean" in sd:
        c1 = _fold_bn(c1, sd, f"{prefix}.bn1")
        c2 = _fold_bn(c2, sd, f"{prefix}.bn2")
    return {"conv1": c1, "conv2": c2}


def _encoder_a(sd, prefix, use_bn):
    return {
        "conv0": _conv_bn_relu(sd, f"{prefix}.0", use_bn),
        "conv1": _conv_bn_relu(sd, f"{prefix}.1", use_bn),
        "res0": _res_block(sd, f"{prefix}.2", use_bn),
        "res1": _res_block(sd, f"{prefix}.3", use_bn),
    }


def _encoder_ab(sd, prefix, use_bn):
    return {
        "res0": _res_block(sd, f"{prefix}.0", use_bn),
        "res1": _res_block(sd, f"{prefix}.1", use_bn),
        "conv0": _conv_bn_relu(sd, f"{prefix}.2", use_bn),
        "res2": _res_block(sd, f"{prefix}.3", use_bn),
        "res3": _res_block(sd, f"{prefix}.4", use_bn),
    }


def _transformer_layer(sd, prefix):
    return {
        "self_attn": _mha(sd, f"{prefix}.self_attn"),
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "linear1": _linear(sd, f"{prefix}.linear1"),
        "linear2": _linear(sd, f"{prefix}.linear2"),
    }


def refine_params_from_torch(state_dict, use_bn=False):
    """torch RefineNet state_dict -> flax params for models.refine_net.RefineNet
    (norm=None; BN folded)."""
    sd = state_dict
    params = {
        "encodeA": _encoder_a(sd, "encodeA", use_bn),
        "encodeAB": _encoder_ab(sd, "encodeAB", use_bn),
        "trans_tf": _transformer_layer(sd, "trans_head.0"),
        "trans_out": _linear(sd, "trans_head.1"),
        "rot_tf": _transformer_layer(sd, "rot_head.0"),
        "rot_out": _linear(sd, "rot_head.1"),
    }
    return {"params": params}


def score_params_from_torch(state_dict, use_bn=False):
    """torch ScoreNetMultiPair state_dict -> flax params."""
    sd = state_dict
    params = {
        "encoderA": _encoder_a(sd, "encoderA", use_bn),
        "encoderAB": _encoder_ab(sd, "encoderAB", use_bn),
        "att": _mha(sd, "att"),
        "att_cross": _mha(sd, "att_cross"),
        "linear": _linear(sd, "linear"),
    }
    return {"params": params}


def flatten_params(tree, prefix="params"):
    """Nested flax tree -> {"params/a/b/kernel": array} (the layout of
    ``models/convert.py``)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = v
    return flat


def load_torch_checkpoint(path):
    """Load a .pth file -> flat numpy state dict (unwraps ckpt['model'],
    matching predict_pose_refine.py:138-141)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v.detach().cpu().numpy() for k, v in ckpt.items()}


def refine_state_dict(state_dict, net, use_bn=False):
    """torch RefineNet state_dict -> state_dict of the port's ``RefineNet``."""
    tree = refine_params_from_torch(state_dict, use_bn=use_bn)["params"]
    return flax_params_to_state_dict(flatten_params(tree), net)


def score_state_dict(state_dict, net, use_bn=False):
    """torch ScoreNetMultiPair state_dict -> state_dict of the port's
    ``ScoreNetMultiPair``."""
    tree = score_params_from_torch(state_dict, use_bn=use_bn)["params"]
    return flax_params_to_state_dict(flatten_params(tree), net)


def load_refiner_weights(path, use_bn=False, net=None):
    """A reference RefineNet ``.pth`` -> state_dict of the port's ``RefineNet``
    (``net``; a default-width one, c_in 6, norm-free, when None). BatchNorm
    layers are folded into their convolutions with ``use_bn``."""
    from foundationpose_tpu_torch.models.refine_net import RefineNet

    return refine_state_dict(load_torch_checkpoint(path), net or RefineNet(c_in=6),
                             use_bn=use_bn)


def load_scorer_weights(path, use_bn=False, net=None):
    """A reference ScoreNetMultiPair ``.pth`` -> state_dict of the port's
    ``ScoreNetMultiPair`` (``net``; a default-width one, c_in 6, norm-free,
    when None)."""
    from foundationpose_tpu_torch.models.score_net import ScoreNetMultiPair

    return score_state_dict(load_torch_checkpoint(path), net or ScoreNetMultiPair(c_in=6),
                            use_bn=use_bn)


# ---------------------------------------------------------------------------
# flax's msgpack serialisation (``flax.serialization.to_bytes``), read in
# plain Python: maps, arrays, strings, binaries, numbers and the ndarray
# extension (code 1: msgpack of (shape, dtype name, C-order bytes)).

_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}


class _Reader:
    def __init__(self, data):
        self.b, self.i = memoryview(data), 0

    def take(self, n):
        out = self.b[self.i:self.i + n]
        self.i += n
        return bytes(out)

    def unpack(self, fmt):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        t = self.take(1)[0]
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self.map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.value() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return self.take(t & 0x1f).decode()
        if t in _FIXED:
            return _FIXED[t]
        sized = {0xc4: ("B", "bin"), 0xc5: ("H", "bin"), 0xc6: ("I", "bin"),
                 0xd9: ("B", "str"), 0xda: ("H", "str"), 0xdb: ("I", "str"),
                 0xdc: ("H", "arr"), 0xdd: ("I", "arr"), 0xde: ("H", "map"), 0xdf: ("I", "map"),
                 0xc7: ("B", "ext"), 0xc8: ("H", "ext"), 0xc9: ("I", "ext")}
        if t in sized:
            fmt, kind = sized[t]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "arr":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack("b"), n)
        if 0xd4 <= t <= 0xd8:
            return self.ext(self.unpack("b"), 1 << (t - 0xd4))
        scalars = {0xca: "f", 0xcb: "d", 0xcc: "B", 0xcd: "H", 0xce: "I", 0xcf: "Q",
                   0xd0: "b", 0xd1: "h", 0xd2: "i", 0xd3: "q"}
        if t in scalars:
            return self.unpack(scalars[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} not supported")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k.decode() if isinstance(k, bytes) else k] = self.value()
        return out

    def ext(self, code, n):
        data = self.take(n)
        if code not in (1, 3):  # ndarray, numpy scalar
            raise ValueError(f"msgpack extension {code} not supported")
        shape, dtype, buf = _Reader(data).value()
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            u16 = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
            arr = u16.view(np.float32)
        else:
            arr = np.frombuffer(buf, dtype=np.dtype(dtype))
        arr = arr.reshape(shape)
        return arr[()] if code == 3 else arr


def read_flax_msgpack(path):
    """A ``flax.serialization.to_bytes`` file -> flat {"a/b/kernel": array}."""
    with open(path, "rb") as f:
        tree = _Reader(f.read()).value()

    def walk(node, prefix):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path}: chunked arrays (> 1 GiB leaves) are not supported")
            out = {}
            for k, v in node.items():
                out.update(walk(v, f"{prefix}/{k}" if prefix else str(k)))
            return out
        return {prefix: np.asarray(node)}

    return walk(tree, "")


def load_engine_params(estimator, weights):
    """Load refiner + scorer weights into a ``FoundationPoseTorch`` engine.

    ``weights`` is either a file written by ``models/checkpoint.save_engine``
    (both nets, as they are), or a directory holding ``refiner.pth`` /
    ``scorer.pth`` (torch checkpoints of the reference; the nets must be
    built norm-free, the configs' default) or ``refiner.msgpack`` /
    ``scorer.msgpack`` (flax-serialised parameters of the JAX package). A
    ``HybridScorer`` takes the weights into its learned half. Orbax
    directories are not read (``models/checkpoint.py``)."""
    from foundationpose_tpu_torch.models import checkpoint

    if os.path.isfile(weights):
        checkpoint.load_engine(estimator, weights)
        return
    for name, target, convert in (("refiner", estimator.refiner, refine_state_dict),
                                  ("scorer", estimator.scorer, score_state_dict)):
        pth = os.path.join(weights, f"{name}.pth")
        msg = os.path.join(weights, f"{name}.msgpack")
        net = checkpoint._net(target)
        if os.path.exists(pth):
            net.load_state_dict(convert(load_torch_checkpoint(pth), net), strict=True)
            logging.info("loaded %s weights from %s", name, pth)
        elif os.path.exists(msg):
            net.load_state_dict(flax_params_to_state_dict(read_flax_msgpack(msg), net),
                                strict=True)
            logging.info("loaded %s weights from %s", name, msg)
        else:
            logging.warning("no %s weights found in %s", name, weights)
