"""Device ms per step of the CLIP loss's backward: the work enqueued inside the
port's `clip_loss.backward` span, from the loss to the images' gradient
(`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.device_ms_per_step(reading, "clip_loss.backward")
