"""% of the traced window's device-idle time during which a root span of the
port (`guided_step`, `sample`) was open: the idle time the port's host code
holds, not the caller's (`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.idle_in_program_share(reading)
