"""kernels_roofline: the least time the window's work allows on the
card's memory, over the time its kernels took, in %.

The work is counted from the calls' inputs and outputs, never from a
kernel's own traffic: each compressed byte read once and each decoded
byte written once. Decoding does no floating-point work, so the bound is
the bytes over the card's HBM bandwidth (peaks.json). The kernels' time
is the sum of the trace's kernel rows (copies and memsets left out). So
the count reads the same work whatever implements it, and a kernel
taken off the path cannot leave it stale."""


def least_bytes(calls) -> int:
    """Bytes the calls' work has to move at least: inputs read once,
    outputs written once."""
    return sum(c.in_bytes + c.out_bytes for c in calls)


def share_pct(nbytes: int, bytes_per_s: float, kernel_s: float):
    if not kernel_s:
        return None
    return 100.0 * (nbytes / bytes_per_s) / kernel_s


def read(w):
    if w.device is None or not w.peak_bytes_per_s:
        return None
    return share_pct(least_bytes(w.calls), w.peak_bytes_per_s,
                     w.device.seconds("kernel"))
