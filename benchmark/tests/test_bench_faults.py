"""The comparison that decides `correct` catches what it has to: the
control (the program with its checksum verification off) and each fault
a cell can have, planted in the timed path underneath a whole run. On
the CPU at small sizes; the look for a card is skipped."""

import pytest

import cells
import run
from conftest import LEFT_OUT, cpu_scale, manifest_cells, traffic_of

CELLS = manifest_cells() + [w["name"] for w in LEFT_OUT]


def _run(root, cell, seed=2**31 + 101, control=None):
    c = cells.Cell(cell, root=root)
    # 3 s: on the CPU a batch call takes ~0.5 s, and the first probe may
    # come as late as the 4th call
    return run.run_cell(c, seed, 3.0, False, device="cpu",
                        scale=cpu_scale(c.config), control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell_root, cell):
    r = _run(cell_root, cell)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["checks"]["answers_checked"]["value"] >= 1
    assert r["checks"]["probes_checked"]["value"] >= 1
    assert list(r)[-1] == "checks"
    # on the CPU there is no device trace: the host's clock is read
    host = {m["name"] for m in cells.Cell(cell, root=cell_root).end_to_end
            if m["source"] == "host_clock"}
    assert "setup_s" in host and set(r["metrics"]) >= host


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 2**31 + 9, 2**33 + 1])
def test_the_control_is_not_correct(cell_root, cell, seed):
    r = _run(cell_root, cell, seed, control="verify_off")
    assert not r["correct"]
    assert r["checks"]["probes_accepted"]["value"] >= 1
    assert r["checks"]["wrong_answers"]["value"] == 0


def _flip(b: bytes) -> bytes:
    return bytes([b[0] ^ 1]) + b[1:] if b else b"\x00"


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_produced(cell_root, cell,
                                                monkeypatch):
    from tbz_torch import api
    from tbz_torch.parallel import shard
    decode_body = api._decode_body
    on_mesh = shard._resolve_batch_on_mesh

    def altered(*a, **k):
        out, total, end_bit, fin, body_dev = decode_body(*a, **k)
        return _flip(out), total, end_bit, fin, body_dev

    def altered_rows(*a, **k):
        blocks = on_mesh(*a, **k)
        for _, _, bodies in blocks:
            bodies[:, 0] ^= 1
        return blocks

    monkeypatch.setattr(api, "_decode_body", altered)
    monkeypatch.setattr(shard, "_resolve_batch_on_mesh", altered_rows)
    r = _run(cell_root, cell)
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_input_returned_unchanged(cell_root, cell, monkeypatch):
    import tbz_torch
    from tbz_torch.parallel import shard
    monkeypatch.setattr(tbz_torch, "decompress", lambda p, **k: bytes(p))
    monkeypatch.setattr(shard, "decode_streams_sharded",
                        lambda ps, mesh, **k: [bytes(p) for p in ps])
    r = _run(cell_root, cell)
    assert not r["correct"] and r["checks"]["wrong_answers"]["value"] >= 1


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if traffic_of(c)["files_per_call"] == "all"])
def test_half_the_batch_left_out(cell_root, cell, monkeypatch):
    from tbz_torch.parallel import shard
    whole = shard.decode_streams_sharded
    monkeypatch.setattr(shard, "decode_streams_sharded",
                        lambda ps, mesh, **k: whole(ps[:len(ps) // 2],
                                                    mesh, **k))
    r = _run(cell_root, cell)
    n_files = len(cells.Cell(cell, root=cell_root).config["files"])
    assert not r["correct"]
    assert r["checks"]["wrong_answers"]["value"] >= n_files - n_files // 2
