"""Counterpart of foundationpose_tpu/core (PyTorch port)."""
