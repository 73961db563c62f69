from foundationpose_tpu_torch.field import bounds, encoders, losses, meshing, nerf, sampling  # noqa: F401
