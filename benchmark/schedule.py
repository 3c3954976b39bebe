"""The one traffic generator: the order of a run's calls, from a traffic
mix's parameters and the seed.

A traffic mix (`traffic/<name>.json`) gives:

    call            the call module (`calls/<call>.py`)
    kwargs          keyword arguments the call passes to the program
    files_per_call  1: each call takes one file, the files coming in a
                    seeded permutation, repeated; "all": each call takes
                    every file, in a seeded order
    probe_every     in each run of this many calls, one call (at a
                    seeded place) carries a probe: one of its files with
                    the checksum in its trailer broken, which the call
                    has to reject

Every seed gives the same set of sizes; only the order, the probes'
places and the files' contents change with it.
"""

from __future__ import annotations

import numpy as np

_SALT = 0x7B2C  # this generator's stream of the seed, apart from the data's


def warm(traffic: dict, n_files: int) -> list:
    """The set-up's calls: every file once, none a probe."""
    if traffic["files_per_call"] == "all":
        return [list(range(n_files))]
    return [[f] for f in range(n_files)]


def calls(traffic: dict, n_files: int, seed: int):
    """Yield (files, probe) for each call of the window, without end:
    the files' indices, and the place in `files` of the probe or None."""
    rng = np.random.default_rng([seed % (1 << 64), _SALT])
    every = int(traffic["probe_every"])
    every_file = traffic["files_per_call"] == "all"
    queue: list = []
    i, probe_at = 0, 0
    while True:
        if i % every == 0:
            probe_at = i + int(rng.integers(every))
        if every_file:
            files = rng.permutation(n_files).tolist()
        else:
            if not queue:
                queue = rng.permutation(n_files).tolist()
            files = [queue.pop()]
        probe = int(rng.integers(len(files))) if i == probe_at else None
        yield files, probe
        i += 1
