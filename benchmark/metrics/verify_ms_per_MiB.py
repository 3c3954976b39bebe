"""verify_ms_per_MiB: the program's stages `verify.crc32` and
`verify.adler32` (the trailer's checksum of fetched output), in ms over
the MiB of output of the calls that ran them."""

STAGES = ("verify.crc32", "verify.adler32")


def read(w):
    return w.ms_per_mib(STAGES, w.calls)
