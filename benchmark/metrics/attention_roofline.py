"""The attention's least time over its device time, in %.

Each attention op that one call makes, as counted by `harness.flops` from
its shapes, takes at least max(FLOPs / peak FLOP/s, bytes / peak bytes/s)
of the card's data-sheet peaks; their sum over the traced calls is held to
the union of the device intervals of the work enqueued inside those ops'
spans (`benchmark/attention_ops/` names them)."""


def read(reading):
    kernels = reading.trace.kernels_in(set(reading.attention_ops))
    if not kernels or not reading.attention_per_call:
        return None
    least_s = reading.calls * sum(max(flops / reading.peak_flops, nbytes / reading.peak_bytes)
                                  for _, flops, nbytes in reading.attention_per_call)
    return 100.0 * least_s / (reading.trace.busy_us(kernels) / 1e6)
