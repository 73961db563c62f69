"""Counterpart of foundationpose_tpu/ops (PyTorch port)."""
