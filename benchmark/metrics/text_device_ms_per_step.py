"""Device ms per step of the text tower: the work enqueued inside the port's
`text_encode` spans (tokenize and the CLIP text encoder, the uncond and cond
prompts), over the DDIM steps (`harness.port_spans`)."""

from benchmark.harness import port_spans


def read(reading):
    return port_spans.device_ms_per_step(reading, "text_encode")
