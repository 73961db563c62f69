"""Robot-camera ingestion: local files and HTTP endpoints.

The port's own copy of foundationpose_tpu/io/file_loader.py (reference
src/file_processing.py): 3x3-matrix or
ZED ``[SECTION] fx=...`` intrinsics parsing (:11-81), RGB/depth file loading
with the mm->m auto-conversion heuristic and <1%-valid warning (:83-138), and
``/rgb`` + ``/depth`` HTTP fetching with 5 s timeouts (:140-193). Failures
return None (plus an error string for the fetchers) rather than raising — the
robot loop polls and retries. PNG images are decoded by the port's codec;
other formats need PIL or cv2, imported when such a file is read.
"""

from __future__ import annotations

import logging
import os
import re

import numpy as np

from foundationpose_tpu_torch.io import png


class FileLoader:
    def __init__(self, base_url=""):
        self.base_url = base_url

    # ------------------------------------------------------------------
    def load_camera_intrinsics(self, intrinsics_file, camera_section="LEFT_CAM_FHD1200"):
        """3x3 whitespace matrix, or ZED conf ``[SECTION]`` with fx/fy/cx/cy."""
        try:
            with open(intrinsics_file) as f:
                first_line = f.readline().strip()
            if first_line.startswith("["):
                return self.convert_camera_intrinsics(intrinsics_file, camera_section)
            with open(intrinsics_file) as f:
                lines = f.readlines()
            if len(lines) < 3:
                raise ValueError("Intrinsics file has incorrect format")
            return np.array(
                [[float(v) for v in lines[r].strip().split()] for r in range(3)]
            )
        except Exception as e:
            logging.error("Error loading camera intrinsics: %s", e)
            return None

    def convert_camera_intrinsics(self, intrinsics_file, camera_section="LEFT_CAM_FHD1200"):
        try:
            with open(intrinsics_file) as f:
                content = f.read()
            m = re.search(r"\[" + camera_section + r"\](.*?)(?=\[|$)", content, re.DOTALL)
            if not m:
                raise ValueError(f"Camera section {camera_section} not found")
            sec = m.group(1)

            def get(name):
                return float(re.search(name + r"=([\d\.e-]+)", sec).group(1))

            fx, fy, cx, cy = get("fx"), get("fy"), get("cx"), get("cy")
            return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        except Exception as e:
            logging.error("Error converting camera intrinsics: %s", e)
            return None

    # ------------------------------------------------------------------
    def load_rgb_image_from_file(self, file_path):
        try:
            if not os.path.exists(file_path):
                raise FileNotFoundError(f"RGB file not found: {file_path}")
            from foundationpose_tpu_torch.io.datareader import _imread_rgb

            img = _imread_rgb(file_path)
            logging.info("Loaded RGB image from %s, shape %s", file_path, img.shape)
            return img
        except Exception as e:
            logging.error("Error loading RGB image: %s", e)
            return None

    @staticmethod
    def _sanitize_depth(depth):
        """mm->m heuristic + noise floor + 2D squeeze (reference :107-134)."""
        valid_pct = 100.0 * np.count_nonzero(depth > 0) / max(depth.size, 1)
        if valid_pct < 1:
            logging.warning("Less than 1%% of depth values are valid (%.2f%%)", valid_pct)
        if depth.size and np.max(depth) > 10 and depth.dtype != np.float32:
            logging.info("Converting depth from millimeters to meters")
            depth = depth.astype(np.float32) / 1000.0
        depth = depth.astype(np.float32, copy=True)
        depth[depth < 0.001] = 0
        if depth.ndim > 2:
            logging.warning("Depth has >2 dims; taking first channel")
            depth = depth[:, :, 0]
        return depth

    def load_depth_from_file(self, file_path):
        try:
            if not os.path.exists(file_path):
                raise FileNotFoundError(f"Depth file not found: {file_path}")
            if file_path.endswith(".npy"):
                depth = np.load(file_path)
            else:
                from foundationpose_tpu_torch.io.datareader import _imread

                depth = _imread(file_path)
            return self._sanitize_depth(depth)
        except Exception as e:
            logging.error("Error loading depth data: %s", e)
            return None

    # ------------------------------------------------------------------
    @staticmethod
    def _imdecode(content, colour):
        """``cv2.imdecode`` of an HTTP body: IMREAD_COLOR (BGR, 3 channels)
        when ``colour``, else IMREAD_UNCHANGED. PNG through the port's codec."""
        if content[:8] == png.SIGNATURE:
            img = png.decode_png(content)
            if not colour:
                return img[..., [2, 1, 0, 3][: img.shape[2]]] if img.ndim == 3 else img
            if img.dtype != np.uint8:  # IMREAD_COLOR scales 16 bits down to 8
                img = (img >> 8).astype(np.uint8)
            if img.ndim == 2:
                return np.repeat(img[..., None], 3, axis=-1)
            return np.ascontiguousarray(img[..., 2::-1])
        from foundationpose_tpu_torch.io.datareader import import_optional

        cv2 = import_optional("cv2")
        arr = np.frombuffer(content, dtype=np.uint8)
        return cv2.imdecode(arr, cv2.IMREAD_COLOR if colour else cv2.IMREAD_UNCHANGED)

    def fetch_rgb_image(self, timeout=5):
        try:
            import requests

            r = requests.get(self.base_url + "/rgb", timeout=timeout)
            if r.status_code != 200:
                return None, f"Failed to fetch image: HTTP {r.status_code}"
            return self._imdecode(r.content, colour=True), None
        except Exception as e:
            return None, f"Error fetching image: {e}"

    def fetch_depth(self, timeout=5):
        try:
            import requests

            r = requests.get(self.base_url + "/depth", timeout=timeout)
            if r.status_code != 200:
                return None, f"Failed to fetch depth data: HTTP {r.status_code}"
            depth = self._imdecode(r.content, colour=False)
            return self._sanitize_depth(depth), None
        except Exception as e:
            return None, f"Error fetching depth data: {e}"
