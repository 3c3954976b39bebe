"""batch_transfer_ms_per_MiB: the program's spans `batch.stage` (the
buckets' host arrays), `batch.upload` (their H2D) and `batch.fetch` (the
outputs' D2H, each member's bytes and their join), nested in its stage
`decode.batch`, in ms over the MiB of output of the calls that ran them.
None where no call did."""

STAGES = ("batch.stage", "batch.upload", "batch.fetch")


def read(w):
    return w.ms_per_mib(STAGES, w.calls)
