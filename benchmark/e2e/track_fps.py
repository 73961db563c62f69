"""Frames tracked per second: the frames the window completed over its
seconds."""


def read(window):
    return window["units"] / window["window_s"]
