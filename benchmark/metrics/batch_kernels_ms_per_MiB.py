"""batch_kernels_ms_per_MiB: the program's spans `batch.resolve` (K7)
and `batch.verify` (batched K5/K6 and the trailers' checks), each ending
in a synchronize, nested in its stage `decode.batch`, in ms over the MiB
of output of the calls that ran them. None where no call did."""

STAGES = ("batch.resolve", "batch.verify")


def read(w):
    return w.ms_per_mib(STAGES, w.calls)
