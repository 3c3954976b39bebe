"""fused_scan_ms_per_MiB: the program's spans `fused.scan` (the native
header scan) and `fused.plan` (the launch plan), nested in its stage
`decode.fused`, in ms over the MiB of output of the calls that took the
fused route alone and ran them."""

STAGES = ("fused.scan", "fused.plan")


def read(w):
    return w.ms_per_mib(STAGES, w.fused_calls())
