"""kernel_ms_per_MiB: the card's kernel time in the window (the sum of
the profiler's kernel rows; copies and memsets left out), in ms over the
MiB the window decoded: the card's compute that a decode takes from a
pipeline sharing the card. A probe counts the bytes its call had to
decode."""

MIB = 1 << 20


def read(w):
    if w.device is None or not w.out_bytes():
        return None
    return w.device.seconds("kernel") * 1e3 / (w.out_bytes() / MIB)
