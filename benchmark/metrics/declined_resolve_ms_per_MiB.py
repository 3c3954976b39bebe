"""declined_resolve_ms_per_MiB: the program's stage `resolve.device`
(the span planner and the flat resolve on the card; the output's fetch
follows it), in ms over the MiB of output of the calls that ran it."""


def read(w):
    return w.ms_per_mib(("resolve.device",), w.declined_calls())
