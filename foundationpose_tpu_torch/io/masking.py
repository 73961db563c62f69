"""Object-mask acquisition: RLE decoding, mask files, and an interactive
brush painter.

The port's own copy of foundationpose_tpu/io/masking.py. Mask files are read
through the port's PNG codec (palette masks give their indices, as PIL reads
them); ``MaskingTool`` needs cv2 and a display and imports cv2 only when run.
The automatic (detector + segmenter) path lives in
``foundationpose_tpu_torch.detect``.
"""

from __future__ import annotations

import logging
import os

import numpy as np


def rle_to_mask(rle: dict):
    """Binary mask from an uncompressed RLE dict {'size': (h,w), 'counts':
    [...]} — SAM-style output, decoded column-major."""
    h, w = rle["size"]
    mask = np.empty(h * w, dtype=bool)
    idx = 0
    parity = False
    for count in rle["counts"]:
        mask[idx : idx + count] = parity
        idx += count
        parity ^= True
    return mask.reshape(w, h).transpose()


def load_mask(mask_path, shape=None):
    """Load a binary mask (.npy, .png, or another format through PIL);
    optionally validate the shape. Returns (H,W) uint8 0/1."""
    if not os.path.exists(mask_path):
        raise FileNotFoundError(mask_path)
    if mask_path.endswith(".npy"):
        mask = np.load(mask_path)
    elif mask_path.lower().endswith(".png"):
        from foundationpose_tpu_torch.io import png

        mask = png.read_png(mask_path, expand_palette=False)
    else:
        from foundationpose_tpu_torch.io.datareader import import_optional

        mask = np.asarray(import_optional("PIL.Image").open(mask_path))
    if mask.ndim == 3:
        mask = mask[..., 0]
    mask = mask > 0
    if shape is not None and mask.shape != tuple(shape):
        raise ValueError(f"mask shape {mask.shape} != expected {shape}")
    return mask.astype(np.uint8)


class MaskingTool:
    """Interactive brush mask painter. Requires cv2 with GUI support and a
    display; raises otherwise."""

    def __init__(self, brush_size=10):
        self.brush_size = brush_size
        self.drawing = False
        self.mask = None
        self.img = None

    def _on_mouse(self, event, x, y, flags, param):
        import cv2

        if event == cv2.EVENT_LBUTTONDOWN:
            self.drawing = True
        elif event == cv2.EVENT_LBUTTONUP:
            self.drawing = False
        if self.drawing and event in (cv2.EVENT_MOUSEMOVE, cv2.EVENT_LBUTTONDOWN):
            cv2.circle(self.mask, (x, y), self.brush_size, 255, -1)

    def run(self, rgb, mask_path=None):
        """Paint a mask over ``rgb``; 's' saves + returns, 'q' aborts,
        '+'/'-' adjust the brush size."""
        from foundationpose_tpu_torch.io import png
        from foundationpose_tpu_torch.io.datareader import import_optional

        cv2 = import_optional("cv2")
        self.img = rgb[..., ::-1].copy()  # display as BGR
        self.mask = np.zeros(rgb.shape[:2], dtype=np.uint8)
        win = "paint object mask  (s=save, q=quit, +/-=brush)"
        cv2.namedWindow(win)
        cv2.setMouseCallback(win, self._on_mouse)
        while True:
            overlay = self.img.copy()
            overlay[self.mask > 0] = (
                0.5 * overlay[self.mask > 0] + np.array([0, 0, 127])
            ).astype(np.uint8)
            cv2.imshow(win, overlay)
            key = cv2.waitKey(16) & 0xFF
            if key == ord("s"):
                if mask_path:
                    png.write_png(mask_path, self.mask)
                    logging.info("mask saved to %s", mask_path)
                break
            if key == ord("q"):
                self.mask = None
                break
            if key == ord("+"):
                self.brush_size += 2
            if key == ord("-"):
                self.brush_size = max(2, self.brush_size - 2)
        cv2.destroyWindow(win)
        return None if self.mask is None else (self.mask > 0).astype(np.uint8)
