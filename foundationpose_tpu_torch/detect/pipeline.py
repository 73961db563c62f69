"""Text-prompted automatic object masking: open-vocabulary detection +
instance segmentation.

The port's own copy of foundationpose_tpu/detect/pipeline.py. Three
differences: ``AutoMasker(device=None)`` means cuda, as everywhere in the port
(the JAX package's default is "cpu"); images reach the HuggingFace detector's
processor as numpy arrays, not PIL images; and the segmenter is the port's
own SAM (``detect/segmenter.BoxSegmenter``, ``models/sam.py``), which loads a
``segment_anything`` ``.pth`` or a HuggingFace checkpoint directory and
returns the mask on the device, where ``register`` takes it. ``depth_box_fallback`` labels
4-connected components with ``scipy.ndimage.label`` in place of
``cv2.connectedComponentsWithStats``; both number components in raster order
of their first pixel, so ties in area go to the same component.

The reference declares this capability (readme.md:9-11: Grounding-DINO box
from a text prompt -> SAM2 mask; weights fetched in docker/run_container.sh:
33-35) but ships no code for it. Here it is a real pipeline built on the
HuggingFace ``transformers`` implementation of GroundingDINO and the port's
SAM, loading from LOCAL checkpoints only (this host has zero egress):

    AutoMasker(detector_path=..., segmenter_path=...).mask_from_prompt(rgb, "mustard bottle")

Without checkpoints the class raises a clear error at construction;
``depth_box_fallback`` offers a heuristic mask (largest close-range
connected component) for fully-offline bring-up.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from scipy import ndimage

from foundationpose_tpu_torch import resolve_device
from foundationpose_tpu_torch.detect.segmenter import BoxSegmenter

DEFAULT_DETECTOR = os.getenv("GROUNDING_DINO_PATH", "")
DEFAULT_SEGMENTER = os.getenv("SAM_PATH", "")


class AutoMasker:
    def __init__(self, detector_path=None, segmenter_path=None, device=None,
                 box_threshold=0.35, text_threshold=0.25):
        self.detector_path = detector_path or DEFAULT_DETECTOR
        self.segmenter_path = segmenter_path or DEFAULT_SEGMENTER
        self.box_threshold = box_threshold
        self.text_threshold = text_threshold
        if not self.detector_path or not os.path.exists(self.detector_path):
            raise FileNotFoundError(
                "Grounding-DINO checkpoint not found. Set GROUNDING_DINO_PATH "
                "or pass detector_path= (a local HF checkpoint directory for "
                "'IDEA-Research/grounding-dino-tiny'-style weights)."
            )
        if not self.segmenter_path or not os.path.exists(self.segmenter_path):
            raise FileNotFoundError(
                "SAM checkpoint not found. Set SAM_PATH or pass "
                "segmenter_path= (local HF checkpoint for 'facebook/sam-vit-base')."
            )
        self.device = resolve_device(device)
        device = self.device
        from transformers import AutoModelForZeroShotObjectDetection, AutoProcessor

        self.det_processor = AutoProcessor.from_pretrained(self.detector_path)
        self.detector = AutoModelForZeroShotObjectDetection.from_pretrained(
            self.detector_path
        ).to(device).eval()
        self.segmenter = BoxSegmenter(checkpoint=self.segmenter_path, device=device)

    def detect_box(self, rgb, prompt):
        """Best box (x0,y0,x1,y1) for the prompt, or None."""
        image = np.asarray(rgb, dtype=np.uint8)
        text = prompt.strip().lower()
        if not text.endswith("."):
            text += "."
        inputs = self.det_processor(images=image, text=text, return_tensors="pt").to(
            self.device
        )
        with torch.no_grad():
            outputs = self.detector(**inputs)
        results = self.det_processor.post_process_grounded_object_detection(
            outputs,
            inputs["input_ids"],
            threshold=self.box_threshold,
            text_threshold=self.text_threshold,
            target_sizes=[image.shape[:2]],
        )[0]
        if len(results["boxes"]) == 0:
            return None, 0.0
        best = int(np.argmax(results["scores"].cpu().numpy()))
        return results["boxes"][best].cpu().numpy(), float(results["scores"][best])

    def segment_box(self, rgb, box):
        """SAM mask for a box prompt: (H, W) bool on the device."""
        if not torch.is_tensor(rgb):
            rgb = np.asarray(rgb, dtype=np.uint8)
        return self.segmenter(rgb, box)

    def mask_from_prompt(self, rgb, prompt):
        box, score = self.detect_box(rgb, prompt)
        if box is None:
            logging.warning("no detection for prompt %r", prompt)
            return torch.zeros(np.asarray(rgb).shape[:2], dtype=torch.bool, device=self.device)
        logging.info("detected %r box=%s score=%.3f", prompt, box, score)
        return self.segment_box(rgb, box)


def depth_box_fallback(depth, z_range=(0.2, 1.5), min_area=500):
    """Heuristic auto-mask without any model: largest connected component of
    close-range depth. Offline bring-up aid, not a detector."""
    valid = ((depth > z_range[0]) & (depth < z_range[1])).astype(np.uint8)
    labels, n = ndimage.label(valid, structure=[[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    areas = np.bincount(labels.reshape(-1), minlength=n + 1)
    best, best_area = 0, 0
    for i in range(1, n + 1):
        area = areas[i]
        if area > best_area and area >= min_area:
            best, best_area = i, area
    return (labels == best).astype(np.uint8) if best > 0 else np.zeros_like(valid)
