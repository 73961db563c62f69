"""The reference with fp8 (e4m3) weights and activations in RefineNet and
ScoreNet: the step below the configuration's bf16 nets."""

import contextlib


def build(make_reference):
    return make_reference(quant="fp8"), contextlib.nullcontext
