"""Seconds from the command's start to the measured window: the process
start, ``import torch``, the CUDA context, the traffic's families, and a
warm-up job that builds every kernel and library handle the window uses."""


def read(run):
    return run.setup_s
