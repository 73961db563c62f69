"""Counterpart of foundationpose_tpu/models (PyTorch port)."""
