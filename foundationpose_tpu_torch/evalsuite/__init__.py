"""Counterpart of foundationpose_tpu/evalsuite (PyTorch port): the synthetic
scene suite and the accuracy harness."""
