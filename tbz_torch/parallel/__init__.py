"""Distribution layer: mesh-sharded decode of independent streams and
sequence-sharded checksums (`shard`), mesh construction (`mesh`), and
torch.distributed process groups with member balancing
(`distributed`). Import submodules directly."""
