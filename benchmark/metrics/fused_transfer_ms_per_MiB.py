"""fused_transfer_ms_per_MiB: the program's spans `fused.upload` (the
payload's H2D), `fused.meta` (the metadata's D2H and parse) and
`fused.fetch` (the output's or the error word's D2H), nested in its
stage `decode.fused`, in ms over the MiB of output of the calls that
took the fused route alone and ran them."""

STAGES = ("fused.upload", "fused.meta", "fused.fetch")


def read(w):
    return w.ms_per_mib(STAGES, w.fused_calls())
