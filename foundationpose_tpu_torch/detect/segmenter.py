"""Box -> mask on the device: Segment Anything's predictor, the port's own.

``BoxSegmenter`` does what ``segment_anything``'s ``SamPredictor.set_image``
+ ``predict(box=..., multimask_output=True)`` do, every step on the card:
resize the frame's long side to 1024 (bilinear, where the predictor resizes
with PIL), normalise by the pixel mean and std, pad bottom-right, encode,
embed the box, decode three masks with their predicted IoUs, keep the one of
the highest IoU, upsample its logits to 1024, crop the resized frame,
upsample to the frame's size and threshold at 0. Nothing is read back to the
host, so the mask can go straight to ``register``; no image embedding is kept
from one call to the next (each call is a new frame).

    seg = BoxSegmenter("sam_vit_h_4b8939.pth")
    mask = seg(rgb, (x0, y0, x1, y1))       # (H, W) bool on the device
    pose = est.register(K, rgb, depth, mask)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.engine.estimator import _upload
from foundationpose_tpu_torch.models import sam as sam_mod
from foundationpose_tpu_torch.utils.profiling import span


def preprocess_shape(h, w, long_side):
    """``ResizeLongestSide.get_preprocess_shape``: (h, w) scaled so that the
    longer side is ``long_side``, rounded half up."""
    scale = long_side / max(h, w)
    return int(h * scale + 0.5), int(w * scale + 0.5)


class BoxSegmenter:
    """SAM on box prompts. ``checkpoint``: a ``segment_anything`` ``.pth``, a
    HuggingFace checkpoint directory or a state dict; ``config``: a
    ``models.sam.SamConfig`` (default: the one the checkpoint's shapes give,
    in bfloat16). ``device=None`` means cuda. After each call ``mask``,
    ``low_res_logits`` (3, 4g, 4g) and ``iou_predictions`` (3,) hold what it
    computed, on the device."""

    def __init__(self, checkpoint, config=None, device=None):
        self.device = resolve_device(device)
        if isinstance(checkpoint, str):
            checkpoint = sam_mod.load_state_dict(checkpoint)
        self.config = config or sam_mod.config_from_state_dict(checkpoint)
        self.net = sam_mod.build_sam(self.config, self.device, checkpoint)
        cfg = self.config
        self.pixel_mean = torch.tensor(cfg.pixel_mean, device=self.device).view(1, 3, 1, 1)
        self.pixel_std = torch.tensor(cfg.pixel_std, device=self.device).view(1, 3, 1, 1)
        self.mask = self.low_res_logits = self.iou_predictions = None

    @torch.no_grad()
    def __call__(self, rgb, box):
        """uint8 (H, W, 3) frame (numpy or tensor) and one box x0, y0, x1, y1
        in its pixels -> (H, W) bool mask on the device."""
        with span("sam.segment", 1):
            H, W = rgb.shape[:2]
            S = self.config.image_size
            h, w = preprocess_shape(H, W, S)
            with span("sam.preprocess"):
                img = _upload(rgb, self.device).permute(2, 0, 1)[None].float()
                img = F.interpolate(img, (h, w), mode="bilinear", align_corners=False,
                                    antialias=True)
                img = F.pad((img - self.pixel_mean) / self.pixel_std, (0, S - w, 0, S - h))
                scale = np.array([w / W, h / H, w / W, h / H], np.float32)
                boxes = _upload(np.asarray(box, np.float32) * scale, self.device)[None]
            emb = self.net.encode(img)
            logits, iou = self.net.decode(emb, boxes)
            with span("sam.postprocess"):
                best = iou[0].argmax().view(1)
                low = logits[0].index_select(0, best)[None]
                up = F.interpolate(low, (S, S), mode="bilinear", align_corners=False)
                up = F.interpolate(up[..., :h, :w], (H, W), mode="bilinear", align_corners=False)
                mask = up[0, 0] > 0.0
        self.mask, self.low_res_logits, self.iou_predictions = mask, logits[0], iou[0]
        return mask
