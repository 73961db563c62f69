"""The reference with TF32 on for matmuls and convolutions: the step below
the configuration's float32 with TF32 off."""


def build(make_reference):
    from reference import tf32

    return make_reference(), lambda: tf32(True)
