"""Milliseconds per register call: the window's seconds over the calls it
completed (a closed loop with one client)."""


def read(window):
    return 1e3 * window["window_s"] / window["units"]
