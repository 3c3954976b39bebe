"""decode_GBps.file: decode_GBps (metrics/decode_GBps.py, whose reader
this is) of a traced window of the BGZF cell: the bytes the window's
calls decoded over the window's seconds, in 10^9 B a second. The batch
route's host front sets it; the card is idle most of a call."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_decode_GBps",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "decode_GBps.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
