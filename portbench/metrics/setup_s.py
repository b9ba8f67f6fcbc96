"""Seconds from the process's start to the window's: interpreter and CUDA
start, inputs and weights made, the program loaded and warmed up, every
kernel built (host clock)."""


def read(run):
    return run.setup_s
