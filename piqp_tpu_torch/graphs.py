"""CUDA graphs of the IPM loop's straight-line segments.

``solver._solve_loop`` runs the IPM loop cut at its host decisions (each
``bool(... .any())``) and at its spans into segments, through a runner
``run(key, fn)`` and a set of buffers ``ws``: a segment reads its inputs
from ``ws`` and ends by putting its outputs there.  The eager loop runs
each segment at once (``eager``) and binds the names (``Names``).  On a
batch of small problems the card then waits on the ~1,350 kernel launches
of a trip, so on the card ``Segments.run`` runs a segment eagerly the
first time its key occurs, captures it as one ``torch.cuda.CUDAGraph``
the second time, and replays the graph after that, and ``Slots`` copies
each output into a persistent buffer, so a graph reads and writes the
same memory on every replay and no segment overwrites what an earlier
one still needs.  A trip then costs about as many graph launches as it
has decisions and spans, and a graph captured in one solve serves every
later solve of the same shapes: the solve copies its inputs into the
buffers first.

``engages`` is the rule for where the graphs run: the condensed dense
backend (``QPData`` itself) on a CUDA device, without per-iteration
printing and without autograd recording the solve.  ``CACHE`` holds a
few entries (buffers and graphs) by shape, dtype, device, cone flag and
settings, least recently used first out, and makes a new one only where
the device's free memory holds ``ROOM_PER_DATA_BYTE`` times the data;
elsewhere the solve takes the eager loop.

A replay runs no Python, so it neither opens the spans of the code it
replays nor counts the hand-written kernels' launches: ``Segments.run``
wraps each replay in the span ``piqp.ipm.graph`` (the caller keeps the
eager loop's ``piqp.kkt.*`` spans around it), and a capture records the
launches it holds in the ``COUNTERS`` of ``ops/chol_inv.py`` and
``ops/signed_chol_inv.py`` and adds them on every replay.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading

import torch

from .ops import chol_inv, signed_chol_inv
from .types import QPData, Settings, tree_map
from .utils.profiling import annotate

# entries (buffers and graphs) the process keeps
CACHE_ENTRIES = 4
# the device memory a new entry asks to find free, per byte of the data:
# a graphed solve of 1024 dense n = 128 problems grew the H100's reserved
# memory by 18.5 times the data, the eager loop by 8.3 times
ROOM_PER_DATA_BYTE = 24


def engages(data, settings: Settings) -> bool:
    """Whether a solve of ``data`` runs as CUDA graphs: condensed dense
    data (not a subclass: the full-KKT backends, the stage data and the
    horizon-sharded data keep the eager loop) on a CUDA device, no
    per-iteration printing, and no tensor that autograd would record."""
    if type(data) is not QPData or data.c.device.type != "cuda" or settings.verbose:
        return False
    return not (torch.is_grad_enabled() and any(
        getattr(data, f.name).requires_grad for f in dataclasses.fields(QPData)))


def key(data: QPData, settings: Settings, has_cone: bool) -> tuple:
    """What an entry's buffers and graphs are built for."""
    return (data.B, data.n, data.p, data.m, data.c.dtype, data.c.device, has_cone, settings)


def room(data: QPData) -> int:
    """The free device memory a new entry for ``data`` asks for."""
    return ROOM_PER_DATA_BYTE * sum(t.nbytes for t in _leaves(data))


# ---------------------------------------------------------------------------
# persistent buffers
# ---------------------------------------------------------------------------

def _leaves(tree) -> list:
    """The tensors of a tree (``types.tree_map``'s), in a fixed order."""
    out = []
    tree_map(out.append, tree)
    return out


class Names:
    """The eager loop's buffers: ``put(name=value, ...)`` binds each name to
    its value (a tree of tensors); ``names.<name>`` reads it."""

    def put(self, **values) -> None:
        self.__dict__.update(values)


class Slots(Names):
    """Named persistent buffers: ``put(name=value, ...)`` copies each value
    (a tree of tensors) into the buffers of its name, made at the name's
    first put as a copy of the value; ``slots.<name>`` reads them.  A
    buffer is never reallocated, so a graph that reads or writes it stays
    valid.  The copies of one put run as one multi-tensor copy a dtype."""

    def put(self, **values) -> None:
        pairs = []
        for name, value in values.items():
            slot = self.__dict__.get(name)
            if slot is None:
                self.__dict__[name] = tree_map(torch.clone, value)
                continue
            dst, src = _leaves(slot), _leaves(value)
            if len(dst) != len(src) or any(
                    d.shape != s.shape or d.dtype != s.dtype for d, s in zip(dst, src)):
                raise ValueError(f"slot {name!r} holds another structure than the value put")
            pairs += [(d, s) for d, s in zip(dst, src) if s is not d and d.numel()]
        # a value may hold a buffer this put writes (a field moved to
        # another place): read those before any is overwritten
        targets = {d.untyped_storage().data_ptr() for d, _ in pairs}
        by_dtype: dict = {}
        for d, s in pairs:
            if s.untyped_storage().data_ptr() in targets:
                s = s.clone()
            dsts, srcs = by_dtype.setdefault(d.dtype, ([], []))
            dsts.append(d)
            srcs.append(s)
        for dsts, srcs in by_dtype.values():
            torch._foreach_copy_(dsts, srcs)


# ---------------------------------------------------------------------------
# capture and replay
# ---------------------------------------------------------------------------

def eager(key, fn) -> None:
    """The eager loop's runner: runs the segment ``fn`` at once."""
    fn()


_STREAMS: dict = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream captures run on, one a device.  A first matrix
    product in each dtype there gives cuBLAS its workspace for the stream
    outside any capture."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            for dt in (torch.float32, torch.float64):
                a = torch.ones((2, 2, 2), dtype=dt, device=device)
                torch.matmul(a, a[..., :1])
        stream.synchronize()
        _STREAMS[device] = stream
    return stream


def capture_cuda(fn):
    """Capture ``fn`` (whose kernels have run once already) as a CUDA graph
    in its own memory pool; returns the replay: the graph's launch on the
    current stream, and the kernel launches it holds added to the
    counters."""
    device = torch.device("cuda", torch.cuda.current_device())
    counters = chol_inv.COUNTERS + signed_chol_inv.COUNTERS
    before = [dict(d) for d in counters]
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    # the capture ran the launchers but no kernel: take their counts back,
    # and add them on each replay
    held = []
    for d, b in zip(counters, before):
        held += [(d, i, d[i] - b[i]) for i in d if d[i] != b[i]]
        d.update(b)

    def replay():
        graph.replay()
        for d, i, n in held:
            d[i] += n

    return replay


def _standin(fn):
    """The CPU stand-in for ``capture_cuda``: a replay calls ``fn`` on the
    same buffers, as the graph would run its kernels."""
    return fn


class Segments:
    """Runs each segment by its key: eagerly the first time (which loads
    its kernels and initialises the libraries), through ``capture`` the
    second time, and by the captured replay from then on, inside a
    ``piqp.ipm.graph`` span."""

    def __init__(self, capture=capture_cuda):
        self._capture = capture
        self._seen: set = set()
        self._replays: dict = {}

    def run(self, key, fn) -> None:
        replay = self._replays.get(key)
        if replay is None:
            if key not in self._seen:
                self._seen.add(key)
                fn()
                return
            replay = self._replays[key] = self._capture(fn)
        with annotate("piqp.ipm.graph"):
            replay()


@dataclasses.dataclass
class Entry:
    """One shape's buffers and graphs."""

    slots: Slots
    segments: Segments


def _device_free() -> int:
    """The current CUDA device's free memory, bytes."""
    return torch.cuda.mem_get_info()[0]


class Cache:
    """The entries by ``key``, least recently used first out.  An entry is
    taken out while a solve uses it (a concurrent solve of the same key
    builds its own) and put back when the solve returns; a solve that
    raises drops it.  A new entry is made only where ``free()`` finds the
    bytes it asks for, after letting go of the least recently used
    entries one by one (``release()`` hands their memory back to the
    device) until it does."""

    def __init__(self, capture=capture_cuda, size: int = CACHE_ENTRIES, free=_device_free,
                 release=torch.cuda.empty_cache):
        self._capture, self._size = capture, size
        self._free, self._release = free, release
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._entries)

    def _make(self, need: int) -> Entry | None:
        while need and self._free() < need:
            if not self._entries:
                return None
            self._entries.popitem(last=False)
            self._release()
        return Entry(Slots(), Segments(self._capture))

    @contextlib.contextmanager
    def entry(self, key, need: int = 0):
        """The entry for ``key``, or None where a new one does not find
        ``need`` bytes free."""
        with self._lock:
            entry = self._entries.pop(key, None) or self._make(need)
        yield entry
        if entry is None:
            return
        with self._lock:
            self._entries[key] = entry
            while len(self._entries) > self._size:
                self._entries.popitem(last=False)


CACHE = Cache()
