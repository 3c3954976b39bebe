"""fused_unspanned_pct: the share of the program's stage `decode.fused`
that none of the `fused.*` spans nested in it covers, in %, over the
calls that took the fused route alone. Work added to the route outside
every span shows here. None where no `fused.*` span ran."""


def read(w):
    whole = covered = 0.0
    for c in w.fused_calls():
        outer = [(a, b) for n, a, b in c.spans if n == "decode.fused"]
        whole += sum(b - a for a, b in outer)
        covered += sum(b - a for n, a, b in c.spans
                       if n.startswith("fused.")
                       and any(o0 <= a and b <= o1 for o0, o1 in outer))
    if not covered or not whole:
        return None
    return 100.0 * (whole - covered) / whole
