"""Several processes: 2 local processes x 2 CPU entries form a 4-entry
global mesh over a torch.distributed gloo group, the counterpart of
tests/test_multihost.py. Sequence-sharded checksums run across the
process boundary (partials all-gathered over gloo), each process
resolves its own rows of the mesh-wide batch and checks them byte for
byte, and decode_streams_sharded refuses the process-spanning mesh. The
workers import torch and tbz_torch only."""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import concurrent.futures, sys, zlib
import numpy as np
import torch
import torch.distributed as dist

pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
sys.path.insert(0, sys.argv[4])

from tbz_torch.parallel import distributed, shard

distributed.initialize(f"127.0.0.1:{port}", nproc, pid, device_type="cpu")
assert dist.get_world_size() == nproc and dist.get_backend() == "gloo"
mesh = distributed.global_mesh(dp=2 * nproc, local_devices=["cpu", "cpu"])
assert mesh.ranks.reshape(-1).tolist() == [r for r in range(nproc)
                                           for _ in range(2)]
assert not mesh.is_local()

# --- sequence-sharded checksums over the process-spanning mesh ---------
N = 2 * nproc * 8192
data = (b"multihost-corpus-" * 4096)[: N - 777]
arr = np.zeros(N, np.uint8)
arr[: len(data)] = np.frombuffer(data, np.uint8)
C = N // mesh.size
local = [2 * pid, 2 * pid + 1]          # this process's mesh rows
shards = [torch.from_numpy(arr[r * C:(r + 1) * C].copy()) for r in local]
crc_fn = shard.make_sharded_crc32(mesh, N)
adler_fn = shard.make_sharded_adler32(mesh, N)
for n in (len(data), 5000, 0):
    assert crc_fn(shards, n) == zlib.crc32(data[:n]), n
    assert adler_fn(shards, n) == zlib.adler32(data[:n]), n
assert crc_fn(arr, len(data)) == zlib.crc32(data)

# --- the mesh-wide resolve batch: each process checks its own rows -----
streams = [bytes([65 + i]) * (4000 + 101 * i) + b"-tail"
           for i in range(2 * nproc)]
payloads = [zlib.compress(s, 6)[2:-4] for s in streams]
its = [(si, mi, m) for si, p in enumerate(payloads)
       for mi, m in enumerate(shard._tokenize_members(p, "raw"))]
T, cap, M = (max(k) for k in zip(*(shard._bucket_key(m) for _, _, m in its)))
with concurrent.futures.ThreadPoolExecutor(2) as pool:
    staged = shard._stage_bucket(its, T, M, pool)
total_out = staged[4]
seen = []
for lo, hi, bodies in shard._resolve_batch_on_mesh(mesh, staged, cap):
    for k in range(hi - lo):
        si = lo + k
        got = bodies[k, :total_out[si]].numpy().tobytes()
        assert got == streams[si], f"stream {si} mismatch on pid {pid}"
        seen.append(si)
assert seen == local, seen

# --- a mesh that spans processes: this process cannot fetch every row --
try:
    shard.decode_streams_sharded(payloads, mesh, format="raw")
except ValueError:
    pass
else:
    raise SystemExit("decode_streams_sharded accepted a spanning mesh")
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tbz")]
assert not bad, bad
dist.destroy_process_group()
print(f"MULTIHOST-OK pid={pid}", flush=True)
"""


def test_two_process_gloo_mesh(tmp_path):
    from tbz_torch.native import loader
    assert loader.available()   # built once here, not by both workers
    nproc = 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(nproc), str(port), repo],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST-OK pid={pid}" in out
