#!/usr/bin/env python3
"""Time the LZ77 resolve kernels (tbz_torch/csrc/resolve.cu with
splice.cu, and spans.cu) of one or more trees of this repository side
by side on one CUDA card.

    python3 probe_resolve.py OUT_DIR TREE [TREE ...]

For each TREE in the order given (e.g. a parent tree, this tree, this
tree, the parent), a child process imports that tree's tbz_torch (its
kernels and native library built there) and measures, on the same seeded
data (chip_smoke.py's corpus and seeds), with CUDA events around calls
after a warm-up call:
  - splice_resolve and resolve_core at the plans of the 1 MiB zlib L6
    body (mean of 10) and of the 64 MiB gzip L6 body (mean of 3), with
    their doubling pass counts;
  - resolve_batch (K7) on three 1 MiB zlib members (phase 2's batch,
    mean of 10) and on the largest bucket of phase 7's Silesia-shaped
    batch (mean of 3);
  - resolve_flat on the 1 MiB body's plan (mean of 10) and on the 64 MiB
    static-only body's plan (mean of 3), and tbz's scan and gscat layouts
    at 1 MiB (phase 10b, medians of 5 in turns, host glue included);
  - resolve_core on tests/torch_util.py's three 1 MiB adversarial tapes
    (mean of 10).
Prints one JSON line a tree and writes them all to
OUT_DIR/probe_resolve.json. Needs a CUDA card.

    python3 probe_resolve.py --trace OUT_DIR

    python3 probe_resolve.py --depth MIB [WINDOW]

needs no card: on the CPU it walks the genealogy of chip_smoke.py's
MIB-MiB zlib L6 tape (the 64 MiB stream's corpus and seed) and prints
the share of bytes more than 2^k hops from their root, the share of
words and of 32-word groups a Jacobi pass k leaves live (a group counts
while it holds a pointer or a value made by the last pass), and the
passes an in-place schedule would run that updates WINDOW words at a
time in index order (default 1048576, about what the card's grid holds
at once).

    python3 probe_resolve.py --trace OUT_DIR

traces this tree's doubling kernel (csrc/resolve.cu) on resolve_core at
the 1 MiB and 64 MiB bodies and on the deep adversarial tape, and on
resolve_flat at the 64 MiB static-only plan: per pass, the words left
live and the card's clock, read back from the kernel's
scratch (tbz_resolve and tbz_resolve_flat called directly); and the
whole call between CUDA events. Writes OUT_DIR/trace.json.
"""
import gzip
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import tempfile
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "probe_cs", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def make_data(d: str) -> None:
    """The bodies and the Silesia-shaped payloads, written once for every
    tree."""
    cs = _chip_smoke()
    names, payloads, _ = cs.silesia_batch()
    blobs = {k: _bodies(cs, k) for k in ("small", "big", "fixed")}
    blobs["silesia"] = (names, payloads)
    with open(os.path.join(d, "data.pkl"), "wb") as f:
        pickle.dump(blobs, f)


def largest_bucket(payloads, dev):
    """Kernel 7's arguments for the bucket of the most rows x cap of the
    Silesia-shaped batch, staged as decode_streams_sharded stages it."""
    import concurrent.futures
    import numpy as np
    from tbz_torch.ops import resolve as R
    from tbz_torch.parallel import shard
    buckets = {}
    for p in payloads:
        for mem in shard._tokenize_members(p, "auto"):
            buckets.setdefault(shard._bucket_key(mem), []).append(
                (0, 0, mem))
    (T, cap, M), its = max(buckets.items(),
                           key=lambda kv: len(kv[1]) * kv[0][1])
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        ol, di, rv, nt, tot, inp = shard._stage_bucket(its, T, M, pool)
    win = np.zeros((len(its), R.W), np.uint8)
    up = shard._upload((ol, di, rv, nt, inp, win), dev)
    return (*up[:4], tot, up[4], up[5], cap), len(its), cap


def measure(tree: str, d: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import tbz_torch
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve as R
    from tbz_torch.ops import resolve_spans as RS
    assert os.path.dirname(os.path.dirname(tbz_torch.__file__)) == tree
    cs = _chip_smoke()
    dev = torch.device("cuda")
    with open(os.path.join(d, "data.pkl"), "rb") as f:
        blobs = pickle.load(f)
    out = {"tree": tree}
    for name, reps in (("small", 10), ("big", 3)):
        body, data = blobs[name]
        r = {}
        for c in cs.kernel_cases(dev, body, data, adversarial=False):
            if c["name"] in ("splice_resolve", "resolve_core"):
                r[c["name"] + "_passes"] = int(c["run"]()[1])
                r[c["name"] + "_ms"] = cs.timed(c["run"], dev, reps)
        out[name] = r
        torch.cuda.empty_cache()
    args = cs.batch_case(dev, cs.MIB)
    out["batch_small_ms"] = cs.timed(args["run"], dev, 10)
    bargs, rows, cap = largest_bucket(blobs["silesia"][1], dev)
    out["batch_large"] = {"rows": rows, "cap": cap,
                          "passes": int(R._resolve_batch(*bargs)[1]),
                          "ms": cs.timed(lambda: R._resolve_batch(*bargs),
                                         dev, 3)}
    del bargs
    torch.cuda.empty_cache()
    for name, reps in (("small", 10), ("fixed", 3)):
        body, data = blobs[name]
        plan = NL.plan_spans_flat(NL.tokenize(body).tape, body)
        fa = RS.flat_plan_from_numpy(RS.stage_flat_plan(plan), dev)
        got = RS._resolve_flat_impl(fa)[:plan.total_out]
        assert got.cpu().numpy().tobytes() == data
        out["flat_" + name] = {
            "batches": plan.n_batches,
            "ms": cs.timed(lambda: RS._resolve_flat_impl(fa), dev, reps)}
        del fa, got
        torch.cuda.empty_cache()
    layouts = cs.flat_layouts(dev, *blobs["small"], 5)
    out["flat_layouts_1MiB"] = {k: v["median_ms"] for k, v in layouts.items()
                                if isinstance(v, dict)}
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_util as tu
    for i, kind in enumerate(tu.RESOLVE_KINDS):
        tape, inp, win, _ = tu.resolve_case(kind, cs.SEED + 40 + i)
        T = R._pad_pow2(len(tape))
        cap = R._pad_pow2(tape.total_out, floor=4096)

        def up(a):
            z = np.zeros(T, np.int32)
            z[:len(a)] = a
            return torch.from_numpy(z).to(dev)

        rargs = (up(tape.out_len), up(tape.dist), up(tape.root_val),
                 len(tape),
                 torch.from_numpy(np.frombuffer(inp or b"\0",
                                                np.uint8).copy()).to(dev),
                 R.window_tensor(win, dev), cap)
        out["core_" + kind] = {
            "passes": int(R._resolve_core(*rargs)[1]),
            "ms": cs.timed(lambda: R._resolve_core(*rargs), dev, 10)}
    return out


MAX_PASSES = 40   # csrc/resolve.cu's


def _ctl(scratch, dbl_bytes: int, N: int) -> dict:
    """The doubling kernel's counters and clock stamps, from its scratch
    (the layout of csrc/resolve.cu's Layout; dbl_bytes: where its part of
    the scratch starts)."""
    import numpy as np
    import torch
    live = (dbl_bytes + 8 * N + 7) & ~7
    n = MAX_PASSES + 1
    u = scratch.view(torch.uint8)[live:live + 8 * (2 * n + 1)].cpu().numpy(
        ).view(np.uint64)
    return {"live": u[:n].tolist(), "stamp": u[n:2 * n + 1].tolist()}


def _trace_row(ctl: dict, passes: int, call_ms: float, N: int) -> dict:
    st = ctl["stamp"]
    ks = range(1, passes + 1)
    return {"N": N, "passes": passes, "call_ms": call_ms,
            "doubling_ms": (st[MAX_PASSES + 1] - st[0]) / 1e6,
            "pass_ms": [(st[k] - st[k - 1]) / 1e6 for k in ks],
            "output_ms": (st[MAX_PASSES + 1] - st[passes]) / 1e6,
            "live": [ctl["live"][k] for k in ks]}


def trace(out_dir: str) -> int:
    import numpy as np
    import torch
    from tbz_torch import _cuda
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import resolve as R
    from tbz_torch.ops import resolve_spans as RS
    cs = _chip_smoke()
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_util as tu
    dev = torch.device("cuda")
    lib = _cuda.lib()
    st = torch.cuda.current_stream().cuda_stream

    def ev_ms(fn):
        e = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
        torch.cuda.synchronize()
        e[0].record()
        fn()
        e[1].record()
        torch.cuda.synchronize()
        return e[0].elapsed_time(e[1])

    def core(tape, inp, win):
        T = R._pad_pow2(len(tape))
        cap = R._pad_pow2(tape.total_out, floor=4096)

        def up(a):
            z = np.zeros(T, np.int32)
            z[:len(a)] = a
            return torch.from_numpy(z).to(dev)

        ol, di, rv = up(tape.out_len), up(tape.dist), up(tape.root_val)
        ib = torch.from_numpy(np.frombuffer(inp or b"\0", np.uint8).copy()
                              ).to(dev)
        win = R.window_tensor(win, dev)
        out = torch.empty(R.W + cap, dtype=torch.uint8, device=dev)
        scratch = torch.empty(int(lib.tbz_resolve_scratch_ints(T, cap)),
                              dtype=torch.int32, device=dev)
        passes = torch.empty(1, dtype=torch.int32, device=dev)

        def call():
            _cuda.check(lib.tbz_resolve(
                ol.data_ptr(), di.data_ptr(), rv.data_ptr(), len(tape), T,
                ib.data_ptr(), ib.numel(), win.data_ptr(), cap,
                out.data_ptr(), scratch.data_ptr(), passes.data_ptr(), st),
                "resolve_core")

        call()
        ms = ev_ms(call)
        kernels = _profile(call)
        NT = (cap + 1023) // 1024
        dbl = 4 * (T + int(lib.tbz_scan_scratch_ints(T)) + NT)
        N = R.W + cap
        return dict(_trace_row(_ctl(scratch, dbl, N), int(passes), ms, N),
                    kernels=kernels)

    res = {}
    for name, body, data in (
            ("core_1MiB", *_bodies(cs, "small")),
            ("core_64MiB", *_bodies(cs, "big"))):
        res[name] = core(NL.tokenize(body).tape, body, b"")
        print(name, json.dumps(res[name]), flush=True)
    tape, inp, win, _ = tu.resolve_case("deep", cs.SEED + 40)
    res["core_deep"] = core(tape, inp, win)
    print("core_deep", json.dumps(res["core_deep"]), flush=True)
    body, data = _bodies(cs, "fixed")
    plan = NL.plan_spans_flat(NL.tokenize(body).tape, body)
    a = RS.flat_plan_from_numpy(RS.stage_flat_plan(plan), dev)
    NB, G, K = a.srcaddr.shape
    base = torch.from_numpy(RS._batch_bases(a)).to(dev)
    n_out = a.out0.numel()
    out = torch.empty(n_out, dtype=torch.uint8, device=dev)
    scratch = torch.empty(int(lib.tbz_resolve_flat_scratch_ints(n_out)),
                          dtype=torch.int32, device=dev)

    def flat():
        _cuda.check(lib.tbz_resolve_flat(
            a.srcaddr.data_ptr(), a.lenoff.data_ptr(), a.g_rows.data_ptr(),
            NB, G, K, base.data_ptr(), a.window.data_ptr(),
            a.out0.data_ptr(), n_out, out.data_ptr(), scratch.data_ptr(),
            st), "resolve_flat")

    flat()
    ms = ev_ms(flat)
    N = R.W + n_out
    ctl = _ctl(scratch, 0, N)
    k = max(i for i in range(1, MAX_PASSES + 1) if ctl["stamp"][i]) \
        if any(ctl["stamp"][1:MAX_PASSES + 1]) else 0
    res["flat_64MiB"] = _trace_row(ctl, k, ms, N)
    print("flat_64MiB", json.dumps(res["flat_64MiB"]), flush=True)
    with open(os.path.join(out_dir, "trace.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


def _profile(fn) -> dict:
    """Device time by kernel name (ms) of one call of fn, from
    torch.profiler; {} where the profiler sees no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as e:  # the profiler is untried on this machine
        return {"error": str(e)}
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            out[ev.key[:60]] = t / 1e3
    return out


def _bodies(cs, name):
    d_small = cs.corpus(cs.SEED, cs.MIB)
    if name == "small":
        return zlib.compress(d_small, 6)[2:-4], d_small
    d_big = cs.corpus(cs.SEED + 6, 64 * cs.MIB)
    if name == "big":
        return gzip.compress(d_big, 6)[10:-8], d_big
    return cs.fixed_deflate(d_big, 31)[10:-8], d_big


def depth(mib: int, window: int) -> int:
    import numpy as np
    from tbz_torch.native import loader as NL
    cs = _chip_smoke()
    data = cs.corpus(cs.SEED + 6, mib * cs.MIB)
    tape = NL.tokenize(zlib.compress(data, 6)[2:-4]).tape
    W = 32768
    ol = np.asarray(tape.out_len, np.int64)
    di = np.asarray(tape.dist, np.int64)
    starts = np.cumsum(ol) - ol
    tid = np.repeat(np.arange(len(ol)), ol)
    q = np.arange(len(tid))
    ts, d = starts[tid], di[tid]
    m = d > 0
    n = (W + len(tid) + 31) // 32 * 32
    parent = np.arange(n)
    parent[W + q[m]] = np.clip(ts[m] - d[m] + (q[m] - ts[m]) % d[m] + W,
                               0, n - 1)
    root = parent == np.arange(n)
    # Jacobi passes: ptr[i] the 2^k-th ancestor (or the root), done[i] once
    # the word's target was resolved
    ptr, done = parent.copy(), root.copy()
    fresh = np.zeros(n, bool)
    words, groups, hops = [], [], np.zeros(n, np.int64)
    hops[~root] = 1
    while (~done).any():
        live = ~done
        words.append(round(float(live.mean()), 3))
        groups.append(round(float((live | fresh).reshape(-1, 32).any(1)
                                  .mean()), 3))
        t = ptr
        fresh = live & done[t]
        hops = np.where(live, hops + hops[t], hops)
        ptr = np.where(live, ptr[t], ptr)
        done = done | fresh
    deeper = {f"2^{k}": round(float((hops > 1 << k).mean()), 3)
              for k in range(0, 16, 2)}
    # in-place: WINDOW words at a time in index order, each window
    # reading the state the windows before it left
    ptr, done = parent.copy(), root.copy()
    ip = 0
    live = np.flatnonzero(~done)
    while len(live):
        ip += 1
        keep = []
        for a in range(0, len(live), window):
            e = live[a:a + window]
            t = ptr[e]
            ptr[e] = ptr[t]
            done[e] = done[t]
            keep.append(e[~done[e]])
        live = np.concatenate(keep)
    print(json.dumps({"MiB": mib, "bytes": int(len(tid)),
                      "match_share": round(float(m.mean()), 3),
                      "deepest": int(hops.max()),
                      "share_deeper_than": deeper,
                      "jacobi_passes": len(words) + 1,
                      "live_words": words, "live_groups": groups,
                      "sum_live_groups": round(sum(groups), 2),
                      "in_place_window": window, "in_place_passes": ip + 1}))
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--depth"]:
        return depth(int(sys.argv[2]),
                     int(sys.argv[3]) if len(sys.argv) > 3 else 1 << 20)
    if sys.argv[1:2] == ["--trace"]:
        os.makedirs(sys.argv[2], exist_ok=True)
        return trace(sys.argv[2])
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(os.path.abspath(sys.argv[2]), sys.argv[3])),
              flush=True)
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("probe_resolve: no CUDA device", file=sys.stderr)
        return 2
    out_dir, trees = sys.argv[1], [os.path.abspath(t) for t in sys.argv[2:]]
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as d:
        make_data(d)
        for tree in trees:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", tree, d], capture_output=True,
                               text=True, timeout=900)
            if r.returncode:
                print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
                return 1
            rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(out_dir, "probe_resolve.json"), "w") as f:
        json.dump({"device": smi, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
