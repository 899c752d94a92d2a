"""Device ms per step of the GroupNorm + activation kernels, forward and
backward: the work launched inside the port's `group_norm` and
`group_norm.backward` spans (`harness.port_spans`), the union of intervals,
in the UNet, the VAE and their backward alike; None where the port opens
no such span."""

from benchmark.harness import port_spans

SPANS = ("group_norm", "group_norm.backward")


def read(reading):
    spans = [s for s in port_spans.in_window(reading) if s[2] in SPANS]
    if not spans:
        return None
    kernels = port_spans.kernels_in(reading, spans)
    return reading.trace.busy_us(kernels) / 1e3 / reading.steps
