"""fused_walk_ms_per_MiB: the program's span `fused.walk` (the chain
walk over the metadata, building the splice plan), nested in its stage
`decode.fused`, in ms over the MiB of output of the calls that took the
fused route alone and ran it."""

STAGES = ("fused.walk",)


def read(w):
    return w.ms_per_mib(STAGES, w.fused_calls())
