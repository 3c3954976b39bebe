"""batch_front_ms_per_MiB: the program's spans `batch.split` (the
headers and BSIZE of every member) and `batch.tokenize` (the members
tokenized in the pool), nested in its stage `decode.batch`, in ms over
the MiB of output of the calls that ran them. None where no call did (a
program without these spans)."""

STAGES = ("batch.split", "batch.tokenize")


def read(w):
    return w.ms_per_mib(STAGES, w.calls)
