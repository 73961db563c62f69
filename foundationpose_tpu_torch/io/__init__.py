"""Counterpart of foundationpose_tpu/io (PyTorch port): dataset readers,
robot-camera file loading, masks, pose conversion and publishing, and the
port's own PNG codec."""
