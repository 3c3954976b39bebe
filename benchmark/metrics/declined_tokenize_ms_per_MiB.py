"""declined_tokenize_ms_per_MiB: the program's stage `tokenize` (the
configured tokenizer of the bodies the fused decode declines), in ms
over the MiB of output of the calls that ran it."""


def read(w):
    return w.ms_per_mib(("tokenize",), w.declined_calls())
