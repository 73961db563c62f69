"""A closed loop of box -> mask -> pose calls with one client over a pool of
frames: each call hands the engine's segmenter (``detect/segmenter.
BoxSegmenter``) the frame and a detector's box, and ``register`` the mask it
returns, on the device.

The frames are ``register_loop``'s; the box of a frame is the bounding box of
the object's true mask with each edge moved by a seeded uniform
+-``box_jitter_px`` (a detector's error), clipped to the frame. The
segmenter's weights are drawn from the run's seed by the reference
(``reference/sam.draw_weights``, with the ``segmenter`` block's standard
deviations) and handed to the engine as its checkpoint; the reference computes
on the same float32 tensors. One call is one unit of work.

The judge holds, on each judged call, the engine's low-res mask logits and
predicted IoUs against the plain SAM (``reference/sam.py``) on the same frame,
box and weights: ``sam_logit_gap_p99`` is the 99th percentile of the logit
gap over the three masks' 3 x 256 x 256 logits, divided by the RMS of the
reference's logits; ``sam_iou_gap`` the largest IoU gap. Then it judges the
``register`` call on the engine's own mask as ``register_loop`` does
(``judge.judge_register``). The control runs both references in its
precision on the same frame, box and mask.

Parameters (``traffic/<name>.json``): ``register_loop``'s and
``box_jitter_px``.
"""

import numpy as np
import torch

from fpbench import judge as judge_mod, pose, traffic
from kinds import register_loop


def make_inputs(seed, cfg, tr, device):
    # an engine without the segmenter fails here, before the frames are made
    from foundationpose_tpu_torch.detect.segmenter import BoxSegmenter  # noqa: F401
    from reference.sam import draw_weights

    inputs = register_loop.make_inputs(seed, cfg, tr, device)
    rng = np.random.default_rng([seed % 2**64, 6])
    inputs.boxes = [detector_box(m, rng, tr["box_jitter_px"]) for m in inputs.frames.mask]
    inputs.sam_weights = draw_weights(cfg["segmenter"], (seed + 5) % 2**63, device)
    return inputs


def detector_box(mask, rng, jitter):
    """x0, y0, x1, y1 (float32): the mask's bounding box, each edge moved by
    a uniform draw in [-jitter, jitter] px, clipped to the frame."""
    ys, xs = np.nonzero(mask)
    if not len(xs):
        raise ValueError("the object is not in the frame")
    H, W = mask.shape
    box = np.array([xs.min(), ys.min(), xs.max(), ys.max()], np.float64)
    box += rng.uniform(-jitter, jitter, 4)
    return np.clip(box, 0, [W - 1, H - 1, W - 1, H - 1]).astype(np.float32)


class Client(pose.Client):
    def __init__(self, cfg, tr, inputs, device):
        super().__init__(cfg, tr, inputs, device)
        from foundationpose_tpu_torch.detect.segmenter import BoxSegmenter
        from foundationpose_tpu_torch.models.sam import SamConfig

        self.seg = BoxSegmenter(inputs.sam_weights, SamConfig.from_dict(cfg["segmenter"]),
                                device=device)
        self.segs = []  # per recorded call: (low-res logits, predicted IoUs, mask)

    def call(self):
        f = self.inputs.frames
        j = traffic.pool_index(self.i, len(f), False)

        def segment_and_register():
            mask = self.seg(f.rgb[j], self.inputs.boxes[j])
            self.segs.append((self.seg.low_res_logits, self.seg.iou_predictions, mask))
            return self.est.register(f.K, f.rgb[j], f.depth[j], mask)

        return self._record(j, segment_and_register)

    def clear(self):
        super().clear()
        self.segs.clear()

    def state(self):
        return {**super().state(), "segs": self.segs}

    def close(self):
        super().close()
        self.seg = None


class Reference:
    """The plain pose engine and the plain SAM over the drawn weights."""

    def __init__(self, cell, inputs, device, quant=None):
        from reference.sam import Sam

        self.pose = pose.make_reference(cell, inputs, device, quant=quant)
        self.sam = Sam(cell.config["segmenter"], inputs.sam_weights, device, quant=quant)


reference = Reference


def judge(cell, state, rng, impl, control=None):
    f, est_cfg = state["inputs"].frames, cell.config["estimator"]
    boxes = state["inputs"].boxes
    out = []
    for p in judge_mod.sample(rng, len(state["answers"]), cell.traffic["check_calls"]):
        j = state["answers"][p][1]
        logits, iou, mask = state["segs"][p]
        mask = mask.cpu().numpy()
        args = (f.K, f.rgb[j], f.depth[j])
        ref_logits, ref_iou, _ = impl.sam.predict(f.rgb[j], boxes[j])
        if control is None:
            rec = state["calls"][p]
        else:
            ctl, precision = control
            with precision():
                logits, iou, _ = ctl.sam.predict(f.rgb[j], boxes[j])
                rec = judge_mod.engine_register(ctl.pose, *args, mask, est_cfg)
        r = judge_mod.judge_register(impl.pose, rec, *args, mask, est_cfg)
        r.update(sam_gaps(logits, iou, ref_logits, ref_iou))
        out.append(r)
    return out


def sam_gaps(logits, iou, ref_logits, ref_iou):
    dev = ref_logits.device
    gap = (logits.to(dev).float() - ref_logits).abs().flatten()
    rms = ref_logits.pow(2).mean().sqrt()
    return {"sam_logit_gap_p99": float(torch.quantile(gap, 0.99) / rms),
            "sam_logit_gap_max": float(gap.max() / rms),
            "sam_iou_gap": float((iou.to(dev).float() - ref_iou).abs().max())}


summarize = judge_mod.worst
