"""Seconds from the process's start to the window's opening: the imports,
the CUDA context, loading the weights, building or loading the kernels,
making the inputs and warming up every shape the cell uses."""


def read(window) -> float:
    return window.setup_s
