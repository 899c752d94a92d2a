"""Device ms per step of the work enqueued inside the port's `clip_loss`
span (resize, normalize, the CLIP image tower, the distance): the union of
those operations' intervals (`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.device_ms_per_step(reading, "clip_loss")
