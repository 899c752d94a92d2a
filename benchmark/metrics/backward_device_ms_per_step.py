"""Device ms per step of the work the autograd engine's backward functions
enqueue: the union of those operations' intervals."""


def read(reading):
    kernels = reading.trace.kernels_in({"backward"})
    return reading.trace.busy_us(kernels) / 1e3 / reading.steps if kernels else None
