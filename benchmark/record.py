"""What a run records of its window, as the metric readers see it."""

from __future__ import annotations

import dataclasses

MIB = 1 << 20


@dataclasses.dataclass
class Call:
    t0: float                 # host clock, seconds
    t1: float
    files: list               # the configuration's file indices
    probe: int | None         # the place in `files` of a probe, or None
    in_bytes: int             # compressed bytes handed to the program
    out_bytes: int            # bytes the program had to decode
    spans: list = dataclasses.field(default_factory=list)
    # the program's stages inside the call (traced runs): (name, t0, t1)

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def ran(self, stage: str) -> bool:
        return any(s[0] == stage for s in self.spans)

    def stage_s(self, names) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n in names)


@dataclasses.dataclass
class Window:
    calls: list
    t0: float
    t1: float                 # when the last call returned
    setup_s: float
    device: object = None     # devtrace.DeviceTrace of a traced run
    peak_bytes_per_s: float | None = None   # the card's, from peaks.json

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def out_bytes(self, calls=None) -> int:
        return sum(c.out_bytes for c in (self.calls if calls is None
                                         else calls))

    def in_bytes(self) -> int:
        return sum(c.in_bytes for c in self.calls)

    def ms_per_mib(self, names, calls) -> float | None:
        """ms of the stages `names` in `calls`, over the MiB those calls
        decoded; None where no call ran them."""
        calls = [c for c in calls if any(c.ran(n) for n in names)]
        mib = self.out_bytes(calls) / MIB
        if not mib:
            return None
        return sum(c.stage_s(names) for c in calls) * 1e3 / mib

    def fused_calls(self) -> list:
        """Calls that took the fused route alone."""
        return [c for c in self.calls
                if c.ran("decode.fused") and not c.ran("tokenize")]

    def declined_calls(self) -> list:
        """Calls whose bodies the configured tokenizer read."""
        return [c for c in self.calls if c.ran("tokenize")]
