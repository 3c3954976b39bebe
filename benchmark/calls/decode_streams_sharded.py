"""A call of many files: tbz_torch.parallel.shard.decode_streams_sharded
over a mesh of one card (`cuda:0`, or the device a test names), with
the traffic's keyword arguments."""


def setup(device, kwargs: dict):
    from tbz_torch.parallel import shard
    from tbz_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=[device or "cuda:0"])

    def call(payloads: list) -> list:
        return shard.decode_streams_sharded(payloads, mesh, **kwargs)

    return call
