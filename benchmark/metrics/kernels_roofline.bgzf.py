"""kernels_roofline.bgzf: kernels_roofline (metrics/kernels_roofline.py,
whose reader this is) in the BGZF cell: the least time the window's work
allows on the card's memory, over the time its kernels took, in %."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_kernels_roofline",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "kernels_roofline.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
