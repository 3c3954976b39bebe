"""device_idle_pct.bgzf: device_idle_pct (metrics/device_idle_pct.py,
whose reader this is) in the BGZF cell: the share of the window in which
no kernel, copy or memset ran on the card, in %."""

import importlib.util
import os

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_device_idle_pct",
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "device_idle_pct.py"))
_base = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_base)
read = _base.read
