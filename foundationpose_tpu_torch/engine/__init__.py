"""Counterpart of foundationpose_tpu/engine (PyTorch port)."""
