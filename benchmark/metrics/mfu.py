"""Model FLOPs of a step (counted once by `harness.flops`) over the untraced
window's seconds per step, over the card's dense bf16 peak, in %."""


def read(reading):
    return 100.0 * reading.flops_per_step / (reading.ms_per_step / 1e3) / reading.peak_flops
