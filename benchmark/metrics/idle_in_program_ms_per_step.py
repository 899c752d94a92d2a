"""Device-idle ms per step during which a root span of the port
(`guided_step`, `sample`) was open: the idle time the port's host code
holds, which falls only when that code stops starving the device
(`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.idle_in_program_ms_per_step(reading)
