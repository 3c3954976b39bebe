"""copy_ms_per_MiB.bgzf: copy_ms_per_MiB (metrics/copy_ms_per_MiB.py,
whose reader this is) in the BGZF cell: the device time of the window's
copies between host and card (the profiler's Memcpy rows, both ways;
page-locked on the batch route), in ms over the MiB decoded."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_copy_ms_per_MiB",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "copy_ms_per_MiB.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
