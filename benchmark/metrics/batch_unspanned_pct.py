"""batch_unspanned_pct: the share of the program's stage `decode.batch`
that none of the `batch.*` spans nested in it covers, in %, over the
calls that ran it. Work added to the batch route outside every span
shows here. None where no `batch.*` span ran."""


def read(w):
    whole = covered = 0.0
    for c in w.calls:
        outer = [(a, b) for n, a, b in c.spans if n == "decode.batch"]
        whole += sum(b - a for a, b in outer)
        covered += sum(b - a for n, a, b in c.spans
                       if n.startswith("batch.")
                       and any(o0 <= a and b <= o1 for o0, o1 in outer))
    if not covered or not whole:
        return None
    return 100.0 * (whole - covered) / whole
