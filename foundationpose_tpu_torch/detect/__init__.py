"""Counterpart of foundationpose_tpu/detect (PyTorch port): text-prompted
auto-masking and the depth-only fallback."""
