"""Host ms per step in the sampler's own code, outside the models: the
port's `sampler_step` spans less their `unet` (the batch, the CFG
combination `cfg_combine`, the update `sampler_update`), and its
`guided_update` spans (`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.host_ms_per_step(reading, ("sampler_step", "guided_update"),
                                       less=("unet",))
