"""Distribution layer: batched decode of independent streams on one card
with on-device checksums (`shard`). Several cards (torch.distributed)
come in a later slice of the port. Import submodules directly."""
