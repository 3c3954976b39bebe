"""A call of one BGZF file: tbz_torch.parallel.shard.
decode_streams_sharded([file]) over a mesh of one card (`cuda:0`, or the
device a test names), with the traffic's keyword arguments.

Set-up first hands the program an empty BGZF file (the EOF block alone)
with those arguments, and raises where the program cannot read it: a
program that does not know the format then ends the run before its
window, instead of answering every call with an error."""

EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b00"
                          "03000000000000000000")


def setup(device, kwargs: dict):
    from tbz_torch.parallel import shard
    from tbz_torch.parallel.mesh import make_mesh
    mesh = make_mesh(devices=[device or "cuda:0"])
    try:
        shard.decode_streams_sharded([EOF_BLOCK], mesh, **kwargs)
    except Exception as e:
        raise RuntimeError(f"this program cannot read BGZF with "
                           f"{kwargs}: {type(e).__name__}: {e}") from e

    def call(payloads: list) -> list:
        (payload,) = payloads
        return shard.decode_streams_sharded([payload], mesh, **kwargs)

    return call
