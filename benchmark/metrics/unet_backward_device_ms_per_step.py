"""Device ms per step of the UNet's backward: the work enqueued inside the
port's `unet.backward` span, from the first gradient to reach the UNet's
noise to the latents' (`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.device_ms_per_step(reading, "unet.backward")
