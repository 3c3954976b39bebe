"""device_idle_pct: the share of the window in which no kernel, copy or
memset ran on the card (the profiler's trace), in %."""


def read(w):
    if w.device is None or not w.seconds:
        return None
    return 100.0 * (1.0 - w.device.busy_s() / w.seconds)
