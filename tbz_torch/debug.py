"""Stream-structure debug dumper (the infgen-style tool the reference
left as commented-out vestiges: dump-tree huffman-tree.lisp:292-332 and
the dump-deflate shell-out deflate-test.lisp:6-13).

`dump(payload)` prints the block structure, Huffman table summaries and
(optionally) the token stream of a raw-deflate payload; `dump_tree`
pretty-prints a decode table. Both operate on the host oracle path
(the port of tbz/debug.py; its text is tbz's).
"""

from __future__ import annotations

import io
import sys

import numpy as np

from . import constants as C
from . import huffman, reference
from .tape import STORED_FLAG


def dump_tree(table: np.ndarray, kind: int, out=None) -> None:
    """Pretty-print a two-level decode table (symbol <- code walk)."""
    out = out or sys.stdout
    root = huffman.root_bits(kind)
    seen = set()
    rows = []
    for idx in range(1 << root):
        e = int(table[idx])
        op = (e >> C.ENTRY_OP_SHIFT) & 7
        if op == C.OP_LINK:
            base = e >> C.ENTRY_VAL_SHIFT
            sub_w = (e >> C.ENTRY_EXTRA_SHIFT) & 0x1F
            for j in range(1 << sub_w):
                e2 = int(table[base + j])
                rows.append((idx | (j << root), e2))
        else:
            rows.append((idx, e))
    for bits, e in rows:
        nb = e & 0xF
        op = (e >> C.ENTRY_OP_SHIFT) & 7
        if op == C.OP_INVALID:
            continue
        key = (bits & ((1 << nb) - 1), nb)
        if key in seen:
            continue
        seen.add(key)
        code = C.bit_reverse(key[0], nb)
        val = e >> C.ENTRY_VAL_SHIFT
        extra = (e >> C.ENTRY_EXTRA_SHIFT) & 0x1F
        opname = {C.OP_LITERAL: "lit", C.OP_MATCH: "match",
                  C.OP_END: "end"}[op]
        print(f"  {code:0{nb}b} ({nb:2d} bits) -> {opname} "
              f"val={val} extra={extra}", file=out)


def dump(payload: bytes, tokens: bool = False, out=None) -> str:
    """Dump the block structure of a raw-deflate stream."""
    buf = io.StringIO()
    res = reference.tokenize_host(payload)
    names = {0: "stored", 1: "static", 2: "dynamic"}
    for i, b in enumerate(res.blocks):
        print(f"block {i}: {names[b.btype]}{' FINAL' if b.bfinal else ''} "
              f"bits [{b.start_bit}, {b.end_bit}) "
              f"tokens [{b.token_start}, {b.token_end}) "
              f"out [{b.out_start}, {b.out_end})", file=buf)
        if tokens:
            t = res.tape
            for k in range(b.token_start, b.token_end):
                d = int(t.dist[k])
                ln = int(t.out_len[k])
                rv = int(t.root_val[k])
                if d:
                    print(f"  match len={ln} dist={d}", file=buf)
                elif rv & STORED_FLAG:
                    print(f"  stored run len={ln} "
                          f"src_off={rv & (STORED_FLAG - 1)}", file=buf)
                else:
                    ch = chr(rv) if 32 <= rv < 127 else "."
                    print(f"  literal {rv} '{ch}'", file=buf)
    print(f"end_bit={res.end_bit} finished={res.finished} "
          f"total_out={res.tape.total_out}", file=buf)
    text = buf.getvalue()
    if out is not False:
        print(text, end="", file=out or sys.stdout)
    return text


if __name__ == "__main__":
    data = open(sys.argv[1], "rb").read()
    dump(data, tokens="-t" in sys.argv)
