"""1 - (device busy time per step in the traced stretch, the union of every
device operation's interval) / (the untraced window's wall time per step),
in %. Tracing slows the host, so the wall time is the untraced one."""


def read(reading):
    busy_ms = reading.trace.busy_us() / 1e3 / reading.steps
    return 100.0 * (1.0 - busy_ms / reading.ms_per_step)
