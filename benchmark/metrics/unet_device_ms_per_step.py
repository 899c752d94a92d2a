"""Device ms per step of the work enqueued inside the benchmark's span
around the UNet's forward: the union of those operations' intervals."""


def read(reading):
    kernels = reading.trace.kernels_in({"unet"})
    return reading.trace.busy_us(kernels) / 1e3 / reading.steps if kernels else None
