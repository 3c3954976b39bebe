"""fused_kernels_ms_per_MiB: the program's spans `fused.kernels`
(kernels 1-3 and their plan's upload) and `fused.splice` (the splice
plan's upload and kernel 4), each ending in a synchronize, nested in
its stage `decode.fused`, in ms over the MiB of output of the calls
that took the fused route alone and ran them."""

STAGES = ("fused.kernels", "fused.splice")


def read(w):
    return w.ms_per_mib(STAGES, w.fused_calls())
