"""Device ms per step of the fused residual add + LayerNorm kernel: the work
launched inside the port's `layer_norm` spans (`harness.port_spans`), the
union of intervals, in every transformer block of the UNet; None where the
port opens no such span."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.device_ms_per_step(reading, "layer_norm")
