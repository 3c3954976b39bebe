"""Distribution layer: decode and encode of independent streams from a
pool of host threads (`host`: each decode through api.decompress, so
on the card by default), mesh-sharded decode of independent streams
and sequence-sharded checksums (`shard`), mesh construction (`mesh`),
and torch.distributed process groups with member balancing
(`distributed`). Import submodules directly."""
