"""decode_GBps.stream: decode_GBps of a traced window (stage timers and
the profiler on): the bytes the window's calls decoded, over the
window's seconds, in 10^9 B a second. A probe counts the bytes its call
had to decode to find the trailer wrong."""


def read(w):
    return w.out_bytes() / w.seconds / 1e9
