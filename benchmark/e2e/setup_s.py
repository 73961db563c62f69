"""Seconds from the process's start to the window's: imports, the CUDA
context, the run's inputs, the system and its weights, the warm calls, and
on a checkout's first run the builds."""


def read(window):
    return window["setup_s"]
