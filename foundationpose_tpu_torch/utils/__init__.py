"""Counterpart of foundationpose_tpu/utils (PyTorch port): visualization."""
