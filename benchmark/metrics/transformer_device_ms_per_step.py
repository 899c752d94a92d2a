"""Device ms per step of the UNet's spatial transformers: the work launched
inside the port's `spatial_transformer` spans (`harness.port_spans`: the
norm, the projections and every transformer block, self- and
cross-attention and feed-forward), the union of intervals; None where the
port opens no such span."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.device_ms_per_step(reading, "spatial_transformer")
