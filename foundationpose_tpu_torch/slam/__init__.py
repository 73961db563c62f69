from foundationpose_tpu_torch.slam.reconstruction import run_neural_object_field  # noqa: F401
