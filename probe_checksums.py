#!/usr/bin/env python3
"""Time the checksum kernels (tbz_torch/csrc/crc32.cu, K5, and
tbz_torch/csrc/adler32.cu, K6) of one or more trees of this repository
side by side on one CUDA card.

    python3 probe_checksums.py OUT_DIR TREE [TREE ...]

For each TREE in the order given (e.g. a parent tree, this tree, this
tree, the parent), a child process imports that tree's tbz_torch (its
kernels built there) and measures, on chip_smoke.py's seeded data, with
CUDA events around `_checksum_rows` calls after a warm-up call (the
timing of chip_smoke.py's phases):
  - 1 MiB: phase 2's corpus with 4096 bytes of slack after it, from a
    prev other than the default (mean of 10);
  - the 64 MiB body of phases 3 and 5, a row of exactly its bytes (mean
    of 3);
  - 640 MiB less 4099 bytes of phase 6's seeded buffer, and a 160 MiB
    shard of it (phase 9a; means of 3);
  - the largest bucket of phase 7's Silesia-shaped batch, its member
    outputs as rows: the kernel, and the whole `*_device_tail_batch`
    call that phase 7 times (means of 3);
  - the whole `crc32_device_tail` / `adler32_device_tail` call at 1 MiB
    by the host clock (the result fetched; mean of 10), so that the
    wrapper's glue shows beside the kernel;
  - torch.profiler's device time by kernel of one call at 1 MiB, 64 MiB
    and 640 MiB;
  - the host time of each piece of the wrapper's glue at 1 MiB (mean of
    200 calls without a synchronize).
Every result is checked against zlib. Prints the card's name and power
limit, one JSON line a tree, and writes them all to
OUT_DIR/probe_checksums.json. Needs a CUDA card (about 2 minutes for
four trees).
"""
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
PREVS = {"crc32": 0x5EED1234, "adler32": 0x1234ABCD}   # chip_smoke's
LARGE = 640 << 20


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "probe_cs", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def make_data(d: str) -> None:
    """The 1 MiB and 64 MiB corpora and the rows of phase 7's largest
    bucket (the bucket of the most rows x cap, as chip_smoke.py picks
    it), written once for every tree."""
    import numpy as np
    from tbz_torch.parallel import shard
    cs = _chip_smoke()
    np.save(os.path.join(d, "small.npy"),
            np.frombuffer(cs.corpus(cs.SEED, cs.MIB), np.uint8))
    np.save(os.path.join(d, "big.npy"),
            np.frombuffer(cs.corpus(cs.SEED + 6, 64 * cs.MIB), np.uint8))
    _, payloads, datas = cs.silesia_batch()
    buckets = {}
    for si, p in enumerate(payloads):
        off = 0
        for mem in shard._tokenize_members(p, "auto"):
            n = mem["res"].tape.total_out
            buckets.setdefault(shard._bucket_key(mem), []).append(
                (si, off, n))
            off += n
    (_, cap, _), its = max(buckets.items(),
                           key=lambda kv: len(kv[1]) * kv[0][1])
    rows = np.zeros((len(its), cap), np.uint8)
    for i, (si, off, n) in enumerate(its):
        rows[i, :n] = np.frombuffer(datas[si], np.uint8)[off:off + n]
    np.save(os.path.join(d, "bucket.npy"), rows)
    np.save(os.path.join(d, "bucket_lens.npy"),
            np.array([n for _, _, n in its], np.int64))


def _profile(fn) -> dict:
    """Device time by kernel name (ms) of one call of fn."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - reported, not fatal
        return {"error": str(e)}
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            out[ev.key[:60]] = t / 1e3
    return out


def glue(C, dev, rows, n: int, reps: int = 200) -> dict:
    """Host microseconds a call of each piece of `_checksum_rows`'s glue
    (Adler-32, whose C entry has one signature in every tree), and of
    the whole wrapper, without a synchronize in between."""
    import torch
    from tbz_torch import _cuda
    lib = _cuda.lib()
    params = torch.tensor([[0], [n], [1]], dtype=torch.long, device=dev)
    nscr = int(lib.tbz_checksum_scratch_ints(1, n))
    buf = torch.empty(1 + nscr, dtype=torch.long, device=dev)
    st = _cuda.stream(buf)
    # a tree whose kernels take their row tickets from the wrapper
    tickets = ([C._tickets(dev, st).data_ptr()]
               if len(lib.tbz_adler32_rows.argtypes) == 9 else [])
    pieces = {
        "empty": lambda: torch.empty(1 + nscr, dtype=torch.long, device=dev),
        "stream": lambda: _cuda.stream(buf),
        "require_cuda": lambda: _cuda.require_cuda(params, buf),
        "scratch_ints": lambda: lib.tbz_checksum_scratch_ints(1, n),
        "c_entry": lambda: lib.tbz_adler32_rows(
            rows.data_ptr(), rows.stride(0), 1, params.data_ptr(), n,
            *tickets, buf[1:].data_ptr(), buf.data_ptr(), st),
        "checksum_rows": lambda: C._checksum_rows("adler32", rows, params, n),
    }
    out = {}
    for k, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[k] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    return out


def measure(tree: str, d: str) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import tbz_torch
    from tbz_torch import checksums as C
    assert os.path.dirname(os.path.dirname(tbz_torch.__file__)) == tree
    cs = _chip_smoke()
    dev = torch.device("cuda")

    def params(n, prev):
        return torch.tensor([[0], [n], [prev]], dtype=torch.long, device=dev)

    small = np.load(os.path.join(d, "small.npy"))
    n1 = len(small)
    host = np.zeros(n1 + 4096, np.uint8)
    host[:n1] = small
    t_small = torch.from_numpy(host).to(dev)
    big = np.load(os.path.join(d, "big.npy"))
    t_big = torch.from_numpy(big).to(dev).unsqueeze(0)
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED)
    buf = torch.randint(0, 256, (LARGE,), dtype=torch.uint8, device=dev,
                        generator=g)
    large_host = buf.cpu().numpy()
    nL, C4 = LARGE - 4099, LARGE // 4
    rows_b = torch.from_numpy(np.load(os.path.join(d, "bucket.npy"))).to(dev)
    lens_b = np.load(os.path.join(d, "bucket_lens.npy"))
    out = {"tree": tree, "bucket": {"rows": int(rows_b.shape[0]),
                                    "cap": int(rows_b.shape[1]),
                                    "bytes": int(lens_b.sum())}}
    out["glue_us_1MiB"] = glue(C, dev, t_small.unsqueeze(0), n1)
    for name in ("crc32", "adler32"):
        z, prev = getattr(zlib, name), PREVS[name]
        dflt = 0 if name == "crc32" else 1
        r = {}
        shapes = (("1MiB", t_small.unsqueeze(0), n1, prev, 10, small),
                  ("64MiB", t_big, big.size, dflt, 3, big),
                  ("640MiB", buf.unsqueeze(0), nL, dflt, 3,
                   large_host[:nL]),
                  ("shard_160MiB", buf[:C4].unsqueeze(0), C4, dflt, 3,
                   large_host[:C4]))
        for key, rows, n, pv, reps, want in shapes:
            p = params(n, pv)
            got = int(C._checksum_rows(name, rows, p, n)[0])
            assert got == z(memoryview(want), pv), (name, key)
            r[key] = cs.timed(lambda: C._checksum_rows(name, rows, p, n),
                              dev, reps)
        batch = getattr(C, name + "_device_tail_batch")
        got = batch(rows_b, lens_b).cpu()
        hb = rows_b.cpu().numpy()
        assert all(int(got[i]) == z(hb[i, :n]) for i, n in enumerate(lens_b))
        pb = torch.from_numpy(np.stack([np.zeros_like(lens_b), lens_b,
                                        np.full_like(lens_b, dflt)])).to(dev)
        mb = int(lens_b.max())
        r["bucket_kernel"] = cs.timed(
            lambda: C._checksum_rows(name, rows_b, pb, mb), dev, 3)
        r["bucket_call"] = cs.timed(lambda: batch(rows_b, lens_b), dev, 3)
        tail = getattr(C, name + "_device_tail")
        tail(t_small, n1, prev)
        t0 = time.perf_counter()
        for _ in range(10):
            tail(t_small, n1, prev)
        r["1MiB_call_host"] = (time.perf_counter() - t0) * 1e3 / 10
        r["profile_1MiB"] = _profile(lambda: C._checksum_rows(
            name, t_small.unsqueeze(0), params(n1, prev), n1))
        r["profile_64MiB"] = _profile(lambda: C._checksum_rows(
            name, t_big, params(big.size, dflt), big.size))
        r["profile_640MiB"] = _profile(lambda: C._checksum_rows(
            name, buf.unsqueeze(0), params(nL, dflt), nL))
        out[name] = r
    return out


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        print(json.dumps(measure(os.path.abspath(sys.argv[2]), sys.argv[3])),
              flush=True)
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("probe_checksums: no CUDA device", file=sys.stderr)
        return 2
    out_dir, trees = sys.argv[1], [os.path.abspath(t) for t in sys.argv[2:]]
    os.makedirs(out_dir, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        make_data(d)
        print(f"data {time.perf_counter() - t0:.1f} s", flush=True)
        for tree in trees:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--one", tree, d], capture_output=True,
                               text=True, timeout=600)
            if r.returncode:
                print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
                return 1
            rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    with open(os.path.join(out_dir, "probe_checksums.json"), "w") as f:
        json.dump({"device": smi, "runs": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
