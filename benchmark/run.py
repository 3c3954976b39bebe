#!/usr/bin/env python3
"""Run one cell of the benchmark of tbz_torch once, and print its result.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's pieces are found by name (see
cells.py). A run:

1. makes the configuration's files from the seed and writes them in
   its container format (corpus.py, formats/<format>.py), and makes one
   warm call a file (the first run in a checkout also builds the kernels
   into tbz_torch/build/ and the native library into
   tbz_torch/native/build/);
2. calls the program in a closed loop for S seconds: the next call
   starts when the last has returned, and the window closes when the
   first call that returns after S seconds does (schedule.py orders the
   calls and places the probes);
3. once the window has closed, compares every answer with the plain
   reference (reference.py): each file's bytes exactly, and each probe
   (a file with one check broken by its format's `probe`, for gzip and
   zlib the trailer's checksum) rejected with a checksum error;
4. prints, as the last lines of standard error, each number compared
   beside its limit, and as the last line of standard output one JSON
   object: `correct`, `attempted`, `failed`, `metrics` (the cell's
   end-to-end metrics, or with --trace 1 its per-layer metrics, each
   read by metrics/<name>.py), `device`, with --trace 1 `breakdown`, and
   last `checks`.

--trace 1 turns on the program's stage timers (Config.profile, each
stage ending in a synchronize) and torch.profiler over the window.
torch.profiler also runs over the window of an untraced run on a card
where one of the cell's end-to-end metrics is read from the device's
trace; the program's stage timers stay off there, and the profiler's
start is the harness's and not counted in setup_s.

--control verify_off runs the control of the comparison: the program
with its checksum verification off (verify=False), the one guarantee a
faster path would be tempted to drop. Its runs have to come out not
correct. The benchmark's own runs never pass it.

It exits non-zero, and prints no result, where there is no CUDA card or
fewer than the cell asks for, or where JAX, jaxlib, flax, the JAX package
`tbz` or its `bench.py` was loaded by the time the window closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import concurrent.futures  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import cells  # noqa: E402
import corpus  # noqa: E402
import devtrace  # noqa: E402
import record  # noqa: E402
import reference  # noqa: E402
import schedule  # noqa: E402

CONTROLS = {"verify_off": {"verify": False}}
MISSING = LookupError("the call gave no answer for this file")


class SpanLog:
    """Stands in for tbz_torch.utils.profiling.metrics in a traced run:
    keeps each stage the program times, with its start and end on the
    host clock, and passes it on to the program's own totals."""

    def __init__(self, inner):
        self.inner = inner
        self.spans: list = []

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            with self.inner.stage(name, nbytes):
                yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def __getattr__(self, key):
        return getattr(self.inner, key)


def _peaks(kind: str) -> float | None:
    with open(os.path.join(HERE, "peaks.json")) as f:
        card = json.load(f)["cards"].get(kind)
    return card["hbm_bytes_per_s"] if card else None


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i", "0"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _as_answer(a):
    """bytes for an output on the host or the device, else as it is."""
    if hasattr(a, "cpu") and hasattr(a, "numpy"):
        return a.cpu().numpy().tobytes()
    return a


def _per_file(cell: cells.Cell, calls: list) -> str:
    """Each file's calls in the window: their count, and the first's and
    the median's ms a MiB (a first call far slower than the median
    warms something up inside the window)."""
    by: dict = {}
    for c in calls:
        key = (cell.config["files"][c.files[0]][0] if len(c.files) == 1
               else f"{len(c.files)} files")
        by.setdefault(key, []).append(c.ms / (c.out_bytes / record.MIB))
    return "; ".join(
        f"{k} {len(v)}: {v[0]:.2f} / {sorted(v)[len(v) // 2]:.2f}"
        for k, v in sorted(by.items()))


def _by_fifth(calls: list, t0: float, t1: float) -> str:
    """GB/s of the calls that ended in each fifth of the window."""
    out = [0] * 5
    for c in calls:
        out[min(4, int(5 * (c.t1 - t0) / (t1 - t0)))] += c.out_bytes
    return " ".join(f"{b / ((t1 - t0) / 5) / 1e9:.4f}" for b in out)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, *,
             device=None, scale: float = 1.0, control: str | None = None,
             t_start: float = T_PROCESS, data=None) -> dict:
    """One run of `cell`; returns the result object. `device` None is
    the program's default (the card); tests pass "cpu" and a `scale`
    below 1, which shrinks every file. `data`: a future of the files,
    begun while torch was imported (main)."""
    import torch
    cfg, traffic = cell.config, cell.traffic
    on_card = device is None or str(device).startswith("cuda")

    def done():
        if on_card:
            torch.cuda.synchronize()

    # 1. set-up
    parts = {"torch and the card": time.perf_counter() - t_start}
    datas, payloads = (data.result() if data
                       else corpus.make_config(cfg, seed, scale=scale,
                                               fmt=cell.format))
    parts["rest of the data"] = (time.perf_counter() - t_start
                                 - sum(parts.values()))
    broken: dict = {}

    def probe_of(f):
        if f not in broken:
            broken[f] = cell.format.probe(payloads[f])
        return broken[f]

    kwargs = dict(traffic.get("kwargs", {}))
    kwargs.update(CONTROLS[control] if control else {})
    spans = prof = None
    if trace:
        from tbz_torch.utils import config as tconfig
        from tbz_torch.utils import profiling
        tconfig.set_config(dataclasses.replace(tconfig.get_config(),
                                               profile=True))
        spans = SpanLog(profiling.metrics)
        profiling.metrics = spans
    call = cell.call.setup(device, kwargs)
    parts["program loaded"] = (time.perf_counter() - t_start
                               - sum(parts.values()))
    for files in schedule.warm(traffic, len(datas)):
        with contextlib.suppress(Exception):  # the window judges calls
            call([payloads[f] for f in files])
    done()
    parts["warm calls"] = time.perf_counter() - t_start - sum(parts.values())
    harness_s = 0.0  # the harness's own part of the set-up
    if on_card and (trace or any(m["source"] == "device_trace"
                                 for m in cell.end_to_end)):
        a = time.perf_counter()
        prof = devtrace.Profiler()
        prof.start()
        harness_s = parts["profiler started"] = time.perf_counter() - a

    # 2. the window
    order = schedule.calls(traffic, len(datas), seed)
    calls, answers = [], []
    with prof.window() if prof else contextlib.nullcontext():
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while not calls or calls[-1].t1 < deadline:
            files, probe = next(order)
            ins = [probe_of(f) if k == probe else payloads[f]
                   for k, f in enumerate(files)]
            k0 = len(spans.spans) if spans else 0
            a = time.perf_counter()
            try:
                got = call(ins)
                done()
            except Exception as e:  # the call's answer, judged below
                got = [e] * len(ins)
            b = time.perf_counter()
            calls.append(record.Call(
                a, b, files, probe, sum(len(p) for p in ins),
                sum(len(datas[f]) for f in files),
                spans.spans[k0:] if spans else []))
            answers.append((ins, got))
    t1 = calls[-1].t1
    if prof:
        prof.stop()

    # 3. readings, then the comparison
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                    for i in range(cell.chips))
           if on_card else 0}
    window = record.Window(calls, t0, t1, t0 - t_start - harness_s)
    if on_card:
        window.peak_bytes_per_s = _peaks(dev["kind"])
        dev["power_limit"] = _power_limit()
    breakdown = None
    if spans:
        from tbz_torch.utils import profiling
        profiling.metrics = spans.inner
    if prof:
        window.device = prof.trace(t0, t1)
    if prof and trace:
        dev["busy_s"] = window.device.busy_s()
        dev["window_s"] = window.seconds
        breakdown = {"device_ops": window.device.top_ops(),
                     "idle_gaps": devtrace.idle_by_host(window.device,
                                                        calls)}
    del call
    if on_card:
        torch.cuda.empty_cache()

    ref = reference.Reference(cell.format, datas)
    n = {"wrong_answers": 0, "probes_accepted": 0, "answers_checked": 0,
         "probes_checked": 0}
    failed = 0
    for c, (ins, got) in zip(calls, answers):
        got = list(got)[:len(ins)]
        got += [MISSING] * (len(ins) - len(got))
        bad = False
        for f, p, a in zip(c.files, ins, got):
            exp = ref.expect(f, p)
            ok = reference.agrees(exp, _as_answer(a))
            probe = exp is reference.CHECKSUM_ERROR
            n["probes_checked" if probe else "answers_checked"] += 1
            if not ok:
                n["probes_accepted" if probe else "wrong_answers"] += 1
                bad = True
        failed += bad
    del answers
    checks = {"wrong_answers": {"value": n["wrong_answers"], "limit": 0},
              "probes_accepted": {"value": n["probes_accepted"],
                                  "limit": 0},
              "answers_checked": {"value": n["answers_checked"],
                                  "limit": ">= 1"},
              "probes_checked": {"value": n["probes_checked"],
                                 "limit": ">= 1"}}
    correct = (n["wrong_answers"] == 0 and n["probes_accepted"] == 0
               and n["answers_checked"] >= 1 and n["probes_checked"] >= 1)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m).read(window)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown:
        result["breakdown"] = breakdown
    result["setup_parts_s"] = parts
    result["per_file_ms_per_MiB"] = _per_file(cell, calls)
    result["GBps_by_fifth"] = _by_fifth(calls, t0, t1)
    result["window_GBps"] = window.out_bytes() / window.seconds / 1e9
    if window.device:
        d = window.device
        result["device_s"] = {"kernels": d.seconds("kernel"),
                              "copies": d.seconds("copy"),
                              "memsets": d.seconds("memset"),
                              "busy": d.busy_s(), "window": window.seconds}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=sorted(CONTROLS))
    args = ap.parse_args(argv)

    cell = cells.Cell(args.workload)
    # the files are made and compressed while torch is imported
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        data = pool.submit(corpus.make_config, cell.config, args.seed,
                           fmt=cell.format)
        import torch
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell.name} needs {cell.chips} CUDA card(s); this "
                  f"machine has {n}: no result", file=sys.stderr)
            data.cancel()
            return 2
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          control=args.control, data=data)
    loaded = cells.forbidden_modules(list(sys.modules))
    if loaded:
        print("modules that no run may load were loaded: "
              + ", ".join(loaded), file=sys.stderr)
        return 3
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 result["setup_parts_s"].items()),
          file=sys.stderr)
    print("per file, calls: first / median ms a MiB: "
          + result["per_file_ms_per_MiB"], file=sys.stderr)
    print("GB/s in each fifth of the window: " + result["GBps_by_fifth"],
          file=sys.stderr)
    if "device_s" in result:
        print("device seconds in the window: " + ", ".join(
            f"{k} {v:.4f}" for k, v in result["device_s"].items()),
            file=sys.stderr)
    w = result["metrics"]
    print(f"{cell.name} seed {args.seed}: {result['attempted']} calls, "
          f"{result['failed']} failed, {result['window_GBps']} GB/s; "
          + ", ".join(f"{k} {v['value']}" for k, v in w.items()),
          file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
