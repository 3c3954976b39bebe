"""call_p95_ms: the 95th percentile (nearest rank) of the latency of
every call in the window, on the host clock, in ms."""

import math


def read(w):
    ms = sorted(c.ms for c in w.calls)
    return ms[math.ceil(0.95 * len(ms)) - 1]
