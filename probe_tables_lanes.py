#!/usr/bin/env python3
"""Time kernels 1 and 2 (tbz_torch/csrc/tables.cu, lanes.cu) of one or
more trees of this repository side by side on one CUDA card.

    python3 probe_tables_lanes.py OUT_DIR TREE [TREE ...]

For each TREE in the order given (e.g. a parent tree, this tree, this
tree, the parent), a child process imports that tree's tbz_torch (its
kernels and native library built there) and measures, on the same seeded
data (chip_smoke.py's corpus and seeds):
  - build_flat_table and _lanes_multi at the plans of the 1 MiB zlib L6
    body (mean of 10 calls) and of the 64 MiB gzip L6 body (mean of 3),
    CUDA events after a warm-up call;
  - kernels 1-3 (_batched_kernel) at the 64 MiB plan (mean of 3);
  - the speculative tier on the 64 MiB static-only body
    (tokenize_stream_speculative): its per-block device call summed over
    the blocks (chip_smoke.LaneCallTimer, as phase 8e reads it), and one
    block's call alone (tables B = 1 + lanes L = 256, S = 384; mean of 20).
Prints one JSON line a tree and writes them all to
OUT_DIR/probe_tables_lanes.json. Needs a CUDA card.

    python3 probe_tables_lanes.py --variants OUT_DIR [NAME=LANES_CU ...]

builds this tree's lanes.cu (and each other lanes.cu given) and tables.cu
alone (nvcc for sm_90a, one
library a variant under OUT_DIR/<name>/) with ptxas' register report
(OUT_DIR/ptxas.txt) and lanes.cu's SASS (OUT_DIR/lanes.sass), and times,
at the 1 MiB and 64 MiB plans and at the speculative tier's largest call
(B = 1, L = 256, S = 384, on a static-only body), the raw kernel calls (no wrapper: buffers
allocated once; CUDA events around 10 calls after a warm-up, forward
then reverse order) of lanes.cu's variants:
  base      the tree's kernel;
  t64k4     64-lane blocks staging 4 tables;
  k4, k2    4 or 2 staged tables a block;
  nostore   the tape stores of the decode loop skipped (timing only);
  norefill  no stream loads after the first three words (timing only);
and of tables.cu; at the tier's shape also _lanes_fused as the tier
calls it (median of 20: host ms of the call, CUDA events around it, and
the fetch after it). Writes OUT_DIR/variants.json.
"""
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "probe_cs", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _test_util():
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_util
    return torch_util


def make_data(d: str) -> None:
    """The three bodies, written once for every tree."""
    import zlib
    cs = _chip_smoke()
    small = zlib.compress(cs.corpus(cs.SEED, cs.MIB), 6)[2:-4]
    d_big = cs.corpus(cs.SEED + 6, 64 * cs.MIB)
    import gzip
    big = gzip.compress(d_big, 6)[10:-8]
    fixed = cs.fixed_deflate(d_big, 31)[10:-8]
    for name, b in (("small", small), ("big", big), ("fixed", fixed)):
        with open(os.path.join(d, name), "wb") as f:
            f.write(b)


def measure(tree: str, d: str) -> dict:
    sys.path.insert(0, tree)
    import torch
    import tbz_torch
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import speculative as SP
    from tbz_torch.ops import tokenize_device as TD
    assert os.path.dirname(os.path.dirname(tbz_torch.__file__)) == tree
    cs = _chip_smoke()
    dev = torch.device("cuda")
    bodies = {n: open(os.path.join(d, n), "rb").read()
              for n in ("small", "big", "fixed")}
    out = {"tree": tree}
    for name, reps in (("small", 10), ("big", 3)):
        body = bodies[name]
        nbits = len(body) * 8
        plan = B._build_plan(nbits, NL.scan_headers(body), 8192)
        dp = B.plan_from_numpy(plan, dev)
        data32 = B.stage_stream(body, dev)
        lt, dt, _, _ = TD.build_flat_table(dp.lit_pad, dp.dist_pad)
        r = {"L": plan.L, "S": plan.S, "B": plan.B, "Ln": plan.Ln,
             "Bn": plan.Bn}
        r["tables_ms"] = cs.timed(
            lambda: TD.build_flat_table(dp.lit_pad, dp.dist_pad), dev, reps)
        r["lanes_ms"] = cs.timed(lambda: B._lanes_multi(
            data32, lt, dt, dp.tbl_idx, dp.lane_starts, dp.lane_ends, nbits,
            plan.S), dev, reps)
        if name == "big":
            r["kernels_1_3_ms"] = cs.timed(lambda: B._batched_kernel(
                data32, *dp, nbits, plan.L, plan.S, plan.B, plan.n_out),
                dev, reps)
        out[name] = r
        del lt, dt, data32, dp
        torch.cuda.empty_cache()
    body = bodies["fixed"]
    with cs.LaneCallTimer(dev) as timer:
        SP.tokenize_stream_speculative(body, device=dev)
    out["speculative"] = timer.result()
    # one block's call alone, at the tier's largest shape
    data32 = B.stage_stream(body, dev)
    lit = torch.full((288,), 8, dtype=torch.int32, device=dev)
    lit[144:256], lit[256:280] = 9, 7
    dist = torch.full((32,), 5, dtype=torch.int32, device=dev)
    starts = torch.arange(256, dtype=torch.int32, device=dev) * 2048 + 3
    ends = starts + 2048
    out["speculative_block_ms"] = cs.timed(lambda: SP._lanes_fused(
        data32, lit, dist, starts, ends, len(body) * 8, 256, 384), dev, 20)
    return out


NVCC = "/usr/local/cuda/bin/nvcc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
LOOP_STORE = """    if (real) {
      *o_starts = v_start;"""
LANE_VARIANTS = {
    "base": [],
    "t64k4": [("constexpr int THREADS = 32;", "constexpr int THREADS = 64;"),
              ("constexpr int K = 3; ", "constexpr int K = 4; ")],
    "k4": [("constexpr int K = 3; ", "constexpr int K = 4; ")],
    "k2": [("constexpr int K = 3; ", "constexpr int K = 2; ")],
    "nostore": [(LOOP_STORE, LOOP_STORE.replace("(real)",
                                                "(real && v_start == -7)"))],
    "norefill": [("next = __ldg(p++);", "next = lo ^ hi;\n      ++p;")],
}


def _shapes(cs, dev):
    """(name, data32, lit_pad, dist_pad, tbl_idx, starts, ends, nbits, S,
    real lanes) of the 1 MiB and 64 MiB plans and of the speculative
    tier's largest call (a 4 MiB static-only body, B = 1, L = 256 lanes
    2048 bits apart, S = 384)."""
    import gzip
    import zlib
    import torch
    from tbz_torch.native import loader as NL
    from tbz_torch.ops import batched as B
    bodies = {"1MiB": zlib.compress(cs.corpus(cs.SEED, cs.MIB), 6)[2:-4],
              "64MiB": gzip.compress(cs.corpus(cs.SEED + 6, 64 * cs.MIB),
                                     6)[10:-8]}
    for name, body in bodies.items():
        nbits = len(body) * 8
        plan = B._build_plan(nbits, NL.scan_headers(body), 8192)
        dp = B.plan_from_numpy(plan, dev)
        yield (name, B.stage_stream(body, dev), dp.lit_pad, dp.dist_pad,
               dp.tbl_idx, dp.lane_starts, dp.lane_ends, nbits, plan.S,
               plan.Ln)
    body = cs.fixed_deflate(cs.corpus(cs.SEED + 6, 4 * cs.MIB))
    lit = torch.full((1, 288), 8, dtype=torch.int32, device=dev)
    lit[0, 144:256], lit[0, 256:280] = 9, 7
    starts = torch.arange(256, dtype=torch.int32, device=dev) * 2048 + 3
    yield ("spec", B.stage_stream(body, dev), lit,
           torch.full((1, 32), 5, dtype=torch.int32, device=dev),
           torch.zeros(256, dtype=torch.int32, device=dev), starts,
           starts + 2048, len(body) * 8, 384, 256)


def variants(out: str, extra: list) -> int:
    import ctypes
    import time
    import torch
    sys.path.insert(0, HERE)
    from tbz_torch.ops import batched as B
    from tbz_torch.ops import speculative as SP
    from tbz_torch.ops import tokenize_device as TD
    src_dir = os.path.join(HERE, "tbz_torch", "csrc")
    lanes_src = open(os.path.join(src_dir, "lanes.cu")).read()
    sources = {}
    for name, subs in LANE_VARIANTS.items():
        text = lanes_src
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"{name}: {a!r} not in lanes.cu")
            text = text.replace(a, b)
        sources[name] = text
    for arg in extra:
        name, path = arg.split("=", 1)
        sources[name] = open(path).read()
    procs, report = {}, []
    for name, text in list(sources.items()) + [("tables", None)]:
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        cu = os.path.join(src_dir, "tables.cu")
        if text is not None:
            cu = os.path.join(d, "lanes.cu")
            with open(cu, "w") as f:
                f.write(text)
        procs[name] = subprocess.Popen(
            [NVCC, *ARCH, "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
             "-I", src_dir, "-o", os.path.join(d, "lib.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for name, p in procs.items():
        text = p.communicate()[0].decode()
        report.append(f"== {name}\n{text}")
        if p.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{text}")
    with open(os.path.join(out, "ptxas.txt"), "w") as f:
        f.write("\n".join(report))
    cubin = os.path.join(out, "lanes.cubin")
    subprocess.run([NVCC, *ARCH, "-cubin", "-I", src_dir, "-o", cubin,
                    os.path.join(src_dir, "lanes.cu")], check=True)
    with open(os.path.join(out, "lanes.sass"), "w") as f:
        subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", cubin],
                       stdout=f, check=True)

    cs = _chip_smoke()
    P = ctypes.c_void_p
    libs = {n: ctypes.CDLL(os.path.join(out, n, "lib.so"))
            for n in list(sources) + ["tables"]}
    dev = torch.device("cuda")
    st = torch.cuda.current_stream().cuda_stream
    lit_c, dist_c = TD._consts_on(dev)
    res = {}
    for (bname, data32, lit_pad, dist_pad, tbl_idx, starts, ends, nbits, S,
         Ln) in _shapes(cs, dev):
        Bp, L = lit_pad.shape[0], starts.shape[0]
        lt = torch.empty(Bp, TD.TSIZE, dtype=torch.int32, device=dev)
        dt = torch.empty_like(lt)
        errs = torch.empty(2, Bp, dtype=torch.int32, device=dev)
        tape = torch.empty(3, S, L, dtype=torch.int32, device=dev)
        ex = torch.empty(2, L, dtype=torch.int32, device=dev)
        calls = {"tables": lambda: libs["tables"].tbz_build_tables(
            P(lit_pad.data_ptr()), P(dist_pad.data_ptr()),
            ctypes.c_int64(Bp), P(lit_c.data_ptr()), P(dist_c.data_ptr()),
            P(lt.data_ptr()), P(dt.data_ptr()), P(errs[0].data_ptr()),
            P(errs[1].data_ptr()), P(st))}
        for name in sources:
            calls[name] = (lambda lib: lambda: lib.tbz_lanes(
                P(data32.data_ptr()), P(lt.data_ptr()), P(dt.data_ptr()),
                P(tbl_idx.data_ptr()), P(starts.data_ptr()),
                P(ends.data_ptr()), nbits, L, S, P(tape[0].data_ptr()),
                P(tape[1].data_ptr()), P(tape[2].data_ptr()),
                P(ex[0].data_ptr()), P(ex[1].data_ptr()), P(st)))(libs[name])
        calls["tables"]()
        ref, times = None, {}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                if calls[name]():
                    raise SystemExit(f"{name}: launch failed")
                torch.cuda.synchronize()
                if name == "base":
                    ref = [t.clone() for t in (tape, ex)]
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                ev[0].record()
                for _ in range(10):
                    calls[name]()
                ev[1].record()
                torch.cuda.synchronize()
                times.setdefault(name, []).append(ev[0].elapsed_time(ev[1])
                                                  / 10)
        k = B._lanes_multi(data32, lt, dt, tbl_idx, starts, ends, nbits, S)
        exact = all(torch.equal(a, b) for a, b in zip(
            (ref[0][0], ref[0][1], ref[0][2], ref[1][0], ref[1][1]), k))
        res[bname] = {"L": L, "S": S, "B": Bp, "Ln": Ln,
                      "base_equals_wrapper": exact, "ms": times}
        tu = _test_util()
        res[bname]["root_misses"] = {
            f"{lb}/{db}": tu.root_misses(data32, lt, dt, tbl_idx[:Ln],
                                         k[0][:, :Ln], k[1][:, :Ln], lb, db)
            for lb, db in ((10, 10), (11, 9), (12, 9))}
        if bname == "spec":
            # the tier's call as it runs: _lanes_fused, then its fetch
            host, window, fetch = [], [], []
            for _ in range(21):
                torch.cuda.synchronize()
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                t0 = time.perf_counter()
                ev[0].record()
                flat = SP._lanes_fused(data32, lit_pad[0], dist_pad[0],
                                       starts, starts + 2048, nbits, L, S)
                ev[1].record()
                t1 = time.perf_counter()
                flat.cpu()
                t2 = time.perf_counter()
                host.append((t1 - t0) * 1e3)
                fetch.append((t2 - t1) * 1e3)
                window.append(ev)
            torch.cuda.synchronize()
            res[bname]["lanes_fused"] = {
                "host_ms": sorted(host[1:])[10],
                "events_ms": sorted(e[0].elapsed_time(e[1])
                                    for e in window[1:])[10],
                "fetch_ms": sorted(fetch[1:])[10]}
        print(bname, json.dumps(res[bname]), flush=True)
        del lt, dt, tape, data32
        torch.cuda.empty_cache()
    with open(os.path.join(out, "variants.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--variants"]:
        os.makedirs(sys.argv[2], exist_ok=True)
        return variants(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(os.path.abspath(sys.argv[2]), sys.argv[3])),
              flush=True)
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("probe_tables_lanes: no CUDA device", file=sys.stderr)
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
                print(r.stdout, r.stderr, file=sys.stderr)
                return 1
            rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(out_dir, "probe_tables_lanes.json"), "w") as f:
        json.dump({"device": smi, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
