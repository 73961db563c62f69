"""Share (%) of the traced window in which no device operation ran."""


def read(rec):
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
