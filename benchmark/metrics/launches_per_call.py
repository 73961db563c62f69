"""Device kernels per call of the traffic (a register call, a tracked
frame), over the traced calls."""


def read(rec):
    return rec["kernels"] / rec["calls"]
