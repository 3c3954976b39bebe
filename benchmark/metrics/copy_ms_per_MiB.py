"""copy_ms_per_MiB: the device time of the window's copies between host
and card (the profiler's Memcpy rows, both ways), in ms over the MiB the
window decoded."""

MIB = 1 << 20


def read(w):
    if w.device is None or not w.out_bytes():
        return None
    return w.device.seconds("copy") * 1e3 / (w.out_bytes() / MIB)
