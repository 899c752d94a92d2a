"""Host launch calls per step: the CUDA runtime and driver calls that
enqueue device work (kernel and graph launches, copies, sets) in the traced
stretch, over its steps. A graph replay counts once."""


def read(reading):
    return reading.trace.launches / reading.steps
