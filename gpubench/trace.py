"""What a traced window holds, reduced from ``torch.profiler``'s events.

The harness wraps its traced rounds in a span named ``WINDOW``; this
module keeps the device's operations (kernels, copies, fills) and the
host's (operators, runtime calls, spans) as plain ``Event`` tuples, so
that the metric readers can be checked on a trace made by hand.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

WINDOW = "gpubench.window"
DEVICE_KINDS = ("kernel", "memcpy", "memset")
HOST_KINDS = ("cpu", "runtime", "span")
TOP = 10
# the characters of an operation's name a breakdown keeps
NAME = 160
# host events looked back through to find the one holding a gap's middle
SCAN = 1000


class Event(NamedTuple):
    name: str
    kind: str
    start: int  # ns
    end: int  # ns


def _kind(e) -> str | None:
    """An event's kind, from whether it is a user annotation (a
    ``record_function`` span, on the host or its image on the device), its
    device and its name."""
    if e.is_user_annotation():
        return "span" if "CPU" in str(e.device_type()) else None
    name = e.name()
    if "CUDA" in str(e.device_type()):
        return "memcpy" if name.startswith("Memcpy") else (
            "memset" if name.startswith("Memset") else "kernel")
    return "runtime" if name.startswith("cuda") else "cpu"


def from_profiler(prof) -> list:
    """The events of a finished ``torch.profiler.profile``."""
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if kind is not None:
            start = int(e.start_ns())
            out.append(Event(e.name(), kind, start, start + int(e.duration_ns())))
    return out


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    """The events inside the ``WINDOW`` span, device operations clipped to
    it."""

    def __init__(self, events: list, rounds: int):
        spans = [e for e in events if e.kind == "span" and e.name == WINDOW]
        if len(spans) != 1:
            raise ValueError(f"a trace holds one {WINDOW} span, this one {len(spans)}")
        self.start, self.end = spans[0].start, spans[0].end
        self.rounds = rounds
        self.device = [Event(e.name, e.kind, max(e.start, self.start), min(e.end, self.end))
                       for e in events
                       if e.kind in DEVICE_KINDS and e.end > self.start and e.start < self.end]
        self.host = sorted((e for e in events if e.kind in HOST_KINDS and e.name != WINDOW),
                           key=lambda e: (e.start, -e.end))
        self.busy = _union([(e.start, e.end) for e in self.device])

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-9

    def kernels(self, names=None) -> list:
        """Kernel events, or those whose name holds one of ``names``."""
        return [e for e in self.device if e.kind == "kernel"
                and (names is None or any(n in e.name for n in names))]

    def device_ops(self) -> list:
        """[name, seconds] of the device operations that took most time."""
        total = {}
        for e in self.device:
            total[e.name] = total.get(e.name, 0) + (e.end - e.start)
        return [[n[:NAME], t * 1e-9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def gaps(self) -> list:
        """The idle intervals of the device inside the window."""
        edges = [self.start] + [x for se in self.busy for x in se] + [self.end]
        return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]

    def idle_gaps(self) -> list:
        """[label, seconds]: the device's idle time summed by what the host
        was doing at the middle of each gap (its innermost operation)."""
        starts = [e.start for e in self.host]
        total = {}
        for s, e in self.gaps():
            mid = (s + e) // 2
            label = "host, between operators"
            # the innermost host event holding mid: the latest-starting one
            # among those that started before it and have not ended
            i = bisect.bisect_right(starts, mid) - 1
            depth = 0
            while i >= 0 and depth < SCAN:
                h = self.host[i]
                if h.end >= mid:
                    label = h.name
                    break
                i -= 1
                depth += 1
            total[label] = total.get(label, 0) + (e - s)
        return [[n[:NAME], t * 1e-9] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]
