"""Spans and counters of the renderer's layers, and their attribution to a
device trace.

Recording is off unless a caller turns it on:

    from hydracore_tpu_torch.utils import spans

    with spans.recording():
        pt.render_tile_production(scene, ids, 0, seed)
    got = spans.take()  # got.spans, got.counters, got.syncs

A span is a named host interval (`time.time_ns()`, the clock that
torch.profiler gives its events), its parent, the step it belongs to
(every root span starts one) and a few attributes. `span(name)` is a
context manager; `phase(name, within=parent)` closes the phases open
inside the innermost open span named `parent` and opens `name` there, so a
long loop body is cut into phases without a `with` block each; with no
such span open a phase records nothing. Off, `span()`, `phase()` and
`count()` test one flag and return.

Counters:
  * `count(name, n)`: recorded only while recording; n a host int or a
    device tensor (a boolean mask counts its True lanes), summed on the
    device and read once, when recording ends.
  * `bump(name)` / `value(name)` / `reset(*names)`: host ints counted
    always (the traversal kernels' launch counters); a recording reports
    how far each moved while it ran.
  * `is_recording()`: whether a recording runs, for a counter that its
    caller gathers on the device only then (kernel B3's upper-level votes,
    `traverse_cluster.b3_upper_votes`).
  * host syncs: while recording on a CUDA build, torch's sync debug mode
    warns at every synchronizing CUDA operation; each is counted by its
    site, the innermost frame under this package (`path:line`), and by the
    innermost open span. A sync from no frame of the package (a caller's
    own `torch.cuda.synchronize()`) is not counted.

`attribute(spans, device_ops, launches)` puts a profile's device
operations and idle gaps on the spans (device_events() reads them from a
torch.profiler run over CUDA activity).
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import os
import sys
import time
import warnings
from dataclasses import dataclass, field

import torch

OUTSIDE = "outside"  # host time in no span
SYNC_MESSAGE = "synchroniz"  # in torch's sync debug warnings

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PACKAGE)
_HERE = os.path.abspath(__file__)


class Span:
    """One recorded interval: start and end in ns of time.time_ns(),
    parent an index into the same list (-1 for a root)."""
    __slots__ = ("name", "start", "end", "parent", "step", "attrs")

    def __init__(self, name, start, parent, step, attrs):
        self.name, self.start, self.end = name, start, None
        self.parent, self.step, self.attrs = parent, step, attrs


@dataclass
class Taken:
    """What one recording gathered: the spans in the order they opened,
    counters {name: int}, host syncs {(site, span path): count}."""
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    syncs: dict = field(default_factory=dict)


def path_of(spans: list, i: int) -> str:
    """The names from the root down to span i, joined by '/'."""
    names = []
    while i >= 0:
        names.append(spans[i].name)
        i = spans[i].parent
    return "/".join(reversed(names))


class _Recorder:
    def __init__(self):
        self.spans = []
        self.stack = []  # indices of the open spans, innermost last
        self.steps = 0
        self.counts = {}
        self.syncs = {}
        self.base = dict(_always)

    def open(self, name, attrs):
        parent = self.stack[-1] if self.stack else -1
        if parent < 0:
            step = self.steps
            self.steps += 1
        else:
            step = self.spans[parent].step
        self.spans.append(Span(name, time.time_ns(), parent, step, attrs))
        self.stack.append(len(self.spans) - 1)

    def close_to(self, depth: int):
        """Closes the open spans above the first `depth` of the stack."""
        t = time.time_ns()
        while len(self.stack) > depth:
            self.spans[self.stack.pop()].end = t

    def innermost_path(self) -> str:
        return path_of(self.spans, self.stack[-1]) if self.stack else OUTSIDE

    def taken(self) -> Taken:
        counters = {k: int(v) for k, v in self.counts.items()}
        for k, v in _always.items():
            if v != self.base.get(k, 0):
                counters[k] = v - self.base.get(k, 0)
        return Taken(self.spans, counters, dict(self.syncs))


_rec = None  # the recorder while recording, else None
_last = None  # what the last recording gathered, until take()
_always = {}  # the counters of bump()


_NULL = contextlib.nullcontext()


class _Open:
    __slots__ = ("rec", "depth", "name", "attrs")

    def __init__(self, rec, name, attrs):
        self.rec, self.name, self.attrs = rec, name, attrs

    def __enter__(self):
        self.depth = len(self.rec.stack)
        self.rec.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        self.rec.close_to(self.depth)
        return False


def span(name: str, **attrs):
    """A context manager that records `name` from its entry to its exit
    (and closes any phase left open inside it)."""
    if _rec is None:
        return _NULL
    return _Open(_rec, name, attrs)


def spanned(name: str):
    """Decorator: every call of the function is a span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            if _rec is None:
                return fn(*a, **kw)
            with _Open(_rec, name, {}):
                return fn(*a, **kw)
        return call
    return wrap


def phase(name: str | None, within: str, **attrs) -> None:
    """Closes what is open inside the innermost open span named `within`
    and opens `name` there (name None: only closes). Records nothing when
    no span of that name is open."""
    rec = _rec
    if rec is None:
        return
    for k in range(len(rec.stack) - 1, -1, -1):
        if rec.spans[rec.stack[k]].name == within:
            rec.close_to(k + 1)
            if name is not None:
                rec.open(name, attrs)
            return


def count(name: str, n) -> None:
    """Adds n (an int, or a tensor: summed on its device, a boolean mask
    by its True entries) to counter `name` of the recording."""
    rec = _rec
    if rec is None:
        return
    if not isinstance(n, int):
        n = n.sum(dtype=torch.int64)
    prev = rec.counts.get(name)
    rec.counts[name] = n if prev is None else prev + n


def is_recording() -> bool:
    """True inside recording(): a caller may then gather a counter on the
    device that it would not pay for otherwise."""
    return _rec is not None


def bump(name: str) -> None:
    """Adds 1 to the always-counted host counter `name`."""
    _always[name] = _always.get(name, 0) + 1


def value(name: str) -> int:
    return _always.get(name, 0)


def reset(*names: str) -> None:
    for k in names:
        _always[k] = 0


def _sync_site(frame) -> str | None:
    """`path:line` (path from the repository root) of the innermost frame
    at or outside `frame` in this package's files, this module's own
    excepted; None when there is none."""
    while frame is not None:
        fname = os.path.abspath(frame.f_code.co_filename)
        if fname != _HERE and fname.startswith(_PACKAGE + os.sep):
            return f"{os.path.relpath(fname, _ROOT)}:{frame.f_lineno}"
        frame = frame.f_back
    return None


def _note_sync(rec) -> None:
    site = _sync_site(sys._getframe(1))
    if site is not None:
        key = (site, rec.innermost_path())
        rec.syncs[key] = rec.syncs.get(key, 0) + 1


@contextlib.contextmanager
def recording():
    """Records spans, counters and host syncs inside the block; take()
    hands them out after."""
    global _rec, _last
    if _rec is not None:
        raise RuntimeError("spans are already recording")
    rec = _Recorder()
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=f".*{SYNC_MESSAGE}")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_MESSAGE in str(message):
                _note_sync(rec)
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        mode = torch.cuda.get_sync_debug_mode() if cuda else 0
        _rec = rec
        try:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            yield rec
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
            _rec = None
            rec.close_to(0)
            _last = rec.taken()


def take() -> Taken:
    """What the last recording gathered (empty if none); clears it."""
    global _last
    out, _last = _last or Taken(), None
    return out


# ----------------------------------------------------------------------------
# Attribution of a device trace to the spans
# ----------------------------------------------------------------------------

def device_events(prof) -> tuple[list, dict]:
    """From a torch.profiler run with CUDA activity: the device operations
    [(name, start ns, duration ns, correlation id)] and the host start of
    each launch {correlation id: ns} (the CUDA runtime's launch and copy
    calls that the profiler records with CUDA activity)."""
    ops, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        corr = int(e.correlation_id())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            ops.append((e.name(), int(e.start_ns()), int(e.duration_ns()),
                        corr))
        elif corr:
            t = int(e.start_ns())
            launches[corr] = min(t, launches.get(corr, t))
    return ops, launches


def segments(spans: list) -> list:
    """[(t0, t1, index of the innermost span)] over the union of the
    spans' intervals, in time order; spans nest (a child lies inside its
    parent), each interval half-open [start, end)."""
    order = sorted((i for i, s in enumerate(spans) if s.end is not None),
                   key=lambda i: (spans[i].start, -spans[i].end, i))
    out, stack, t = [], [], None

    def emit(t0, t1, i):
        if t1 > t0:
            out.append((t0, t1, i))

    for i in order:
        s = spans[i]
        while stack and spans[stack[-1]].end <= s.start:
            top = stack.pop()
            emit(t, spans[top].end, top)
            t = spans[top].end
        if stack:
            emit(t, s.start, stack[-1])
        stack.append(i)
        t = s.start
    while stack:
        top = stack.pop()
        emit(t, spans[top].end, top)
        t = max(t, spans[top].end)
    return out


def _idle(ops: list) -> list:
    """The gaps [(t0, t1)] between the device operations' union."""
    gaps, end = [], None
    for _, start, dur, *_ in sorted(ops, key=lambda o: o[1]):
        if end is not None and start > end:
            gaps.append((end, start))
        end = start + dur if end is None else max(end, start + dur)
    return gaps


def attribute(spans: list, device_ops: list, launches: dict) -> dict:
    """{span path: {"device_s", "idle_s", "ops"}}: each device operation
    (name, start ns, duration ns, correlation id) on the innermost span
    open at its launch's host time (launches {correlation id: ns}), each
    idle gap between the operations split over the innermost spans open
    during it by their overlap. Operations launched outside every span, or
    with no launch recorded, and idle time while no span is open go to
    OUTSIDE."""
    segs = segments(spans)
    starts = [s[0] for s in segs]
    paths = {}

    def key(i):
        if i not in paths:
            paths[i] = OUTSIDE if i is None else path_of(spans, i)
        return paths[i]

    out = {}

    def add(i, what, v):
        row = out.setdefault(key(i), {"device_s": 0.0, "idle_s": 0.0,
                                      "ops": 0})
        row[what] += v

    for _, _, dur, corr in device_ops:
        i = None
        t = launches.get(corr)
        if t is not None:
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and segs[k][0] <= t < segs[k][1]:
                i = segs[k][2]
        add(i, "device_s", dur / 1e9)
        add(i, "ops", 1)
    for g0, g1 in _idle(device_ops):
        k = max(bisect.bisect_right(starts, g0) - 1, 0)
        t = g0
        while t < g1:
            if k < len(segs) and segs[k][1] <= t:
                k += 1
                continue
            if k < len(segs) and segs[k][0] <= t:
                t1 = min(g1, segs[k][1])
                add(segs[k][2], "idle_s", (t1 - t) / 1e9)
            else:
                t1 = min(g1, segs[k][0]) if k < len(segs) else g1
                add(None, "idle_s", (t1 - t) / 1e9)
            t = t1
    return out
