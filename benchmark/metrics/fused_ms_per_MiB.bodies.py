"""fused_ms_per_MiB.bodies: the program's stage `decode.fused` (host
scan, kernels 1-3, walk, splice and resolve, output fetch; ending in a
synchronize), in ms over the MiB of output of the calls that took the
fused route alone."""


def read(w):
    return w.ms_per_mib(("decode.fused",), w.fused_calls())
