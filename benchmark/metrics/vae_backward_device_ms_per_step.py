"""Device ms per step of the VAE decoder's backward: the work enqueued inside
the port's `vae_decode.backward` span, from the images' gradient to the
denoised latents' (`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.device_ms_per_step(reading, "vae_decode.backward")
