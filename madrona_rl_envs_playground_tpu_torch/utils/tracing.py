"""Spans and counters of the port's trainers, on the host's clock and, on
the card, the device's.

One tracer serves the process (``TRACER``; the module's functions are its
methods).  It is on from the start: every ``SelfPlayPPO.train_step`` and
``MAPPORunner.update`` records an ``update`` span whose children tile it,
every replay of a trainer's graph its input copy and replay
(``train/graphs.py``), and the trainers' construction; ``disable()`` turns
every site into one flag check.

**A span** (``span(name, device)``, a context manager) records its name, the
span open around it on the same thread (its parent) and the update it
belongs to: ``span(..., update=True)`` opens an update, and every span
opened inside it shares its id.  It stamps ``time.perf_counter_ns()`` at
entry and exit.  Where ``device`` is a CUDA device and its current stream
is not capturing a graph, it also marks its entry and exit on that stream
with CUDA events: the device's clock, in stream order.  Adjacent spans
share a mark: the children of a span opened with ``tiled=True`` (its
caller's word that they cover all its device work) start where the
previous one ended, the first where it started, and it ends where the
last ended; a span opened with ``after=<span>`` starts where that sibling
ended.  Nothing on the training path synchronises: events come from a
pool, and the events of earlier updates that ``query()`` reports done are
read with ``elapsed_time`` and given back to the pool right after a graph
replay inside an update, while the card runs it (or at an update's close
where two or more updates wait, as an eager trainer's do); so the pool
holds a few updates' events (creating a CUDA event costs tens of
microseconds of the host's time, recording a pooled one a few).
``snapshot()`` synchronises once and reads the rest.  On the CPU the device
fields stay ``None``.  While a ``torch.profiler`` session records, each span
also opens ``torch.profiler.record_function(name)``, so the profiler's trace
carries the program's spans on its own clock.

**Self time** is a span's duration less what its children cover; children
of a span run one after another on its thread and stream, so that is the
sum of theirs.  It is taken on the device clock where the span has events,
on the host's otherwise.

**Memory is bounded**: the full records of the last ``UPDATES_KEPT``
updates, and of the last ``OTHERS_KEPT`` spans opened outside any update,
are kept; besides, a running count, sum, minimum and maximum by span name
(host ms, device ms, self ms) and by counter.  ``reset()`` forgets all of it.

**Counters**: the graphs' ``replays:<graph>``, ``captures:<graph>`` and
``input_bytes:<graph>``; ``widened:epochs``, the tower inputs that a
self-play update's epochs widen to the towers' compute dtype (added by
``SelfPlayPPO._update`` on every call, eager or replayed: 1 where the critic
reads the obs, 2 where it reads its own state obs, 0 where the chunks hold
the compute dtype already; no metric reads it); ``rows:epochs``, the rows
the epochs' towers compute (the chunks' rows times ``update_epochs``, added
by ``SelfPlayPPO._update`` on every call); and ``active_rows:epochs``, the
rows of them that the losses weigh (the trainable active slots times
``update_epochs``; added only by envs whose seats take turns).  The active
count is a device scalar: its running sum stays on the card (one add an
update, outside the graphs) and ``snapshot()`` reads it after its one
synchronisation, so its ``min`` and ``max`` are None.  The kernels' launch counts
stay where they are counted (``ops/*.py`` ``LAUNCHES``); ``snapshot()``
reads them through ``train/graphs.py``.

Spans nest by thread: each thread has its own stack and its own sequence
of updates, so a server thread's spans do not interleave with a trainer's.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

UPDATES_KEPT = 1024  # updates whose every span is kept
OTHERS_KEPT = 1024  # spans outside an update that are kept
EVENT_BLOCK = 64  # CUDA events added to the pool at a time


class Stats:
    """Running count, sum, minimum and maximum of a series of numbers."""

    __slots__ = ("count", "sum", "min", "max")

    def __init__(self):
        self.count, self.sum, self.min, self.max = 0, 0, float("inf"), float("-inf")

    def add(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def as_dict(self) -> Optional[Dict[str, float]]:
        if not self.count:
            return None
        return {"count": self.count, "sum": self.sum, "min": self.min, "max": self.max}


class DeviceSum:
    """A running count and sum whose sum stays on the device of the amounts
    added (one float64 total a device): adding is one device add, with no
    host read; ``as_dict`` reads the totals (after the caller's
    synchronisation) and has no minimum or maximum."""

    __slots__ = ("count", "totals")

    def __init__(self):
        self.count, self.totals = 0, {}

    def add(self, amount: torch.Tensor, times: int) -> None:
        self.count += 1
        total = self.totals.get(amount.device)
        if total is None:
            total = self.totals[amount.device] = torch.zeros((), dtype=torch.float64,
                                                             device=amount.device)
        total.add_(amount, alpha=times)

    def on_cuda(self) -> bool:
        return any(d.type == "cuda" for d in self.totals)

    def as_dict(self) -> Optional[Dict[str, float]]:
        if not self.count:
            return None
        return {"count": self.count, "sum": sum(float(t) for t in self.totals.values()),
                "min": None, "max": None}


class _Record:
    """One span, and the context manager that times it: host stamps in ns,
    events (``own0``, ``own1``: recorded by this span, not shared with a
    neighbour's), and once read its device duration and self time (ms)."""

    __slots__ = ("tracer", "device", "opens_update", "tiled", "after", "id", "name", "parent",
                 "update", "t0", "t1", "child_ns", "ev0", "ev1", "own0", "own1", "tail",
                 "device_ms", "self_ms", "profiled")

    def __init__(self, tracer, name, device, opens_update, tiled, after):
        self.tracer, self.name, self.device, self.opens_update = tracer, name, device, opens_update
        self.tiled, self.after = tiled, after
        self.t0 = self.t1 = self.child_ns = 0
        self.ev0 = self.ev1 = self.tail = self.device_ms = self.self_ms = None
        self.own0 = self.own1 = False
        self.profiled = None

    def __enter__(self):
        self.tracer._open(self)
        return self

    def __exit__(self, *exc):
        self.tracer._close(self)
        return False

    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def host_self_ms(self) -> float:
        return (self.t1 - self.t0 - self.child_ns) / 1e6

    def as_dict(self) -> Dict:
        return {"id": self.id, "name": self.name, "parent": self.parent, "update": self.update,
                "host_ms": self.host_ms(), "device_ms": self.device_ms,
                "self_ms": self.self_ms if self.self_ms is not None else self.host_self_ms()}


class _Update:
    """The spans of one update, in the order they opened (the ``update``
    span first); ``period_ms`` is the device time from its start to the
    next update's start, ``uncovered_ms`` the part of it outside the
    ``update`` span."""

    __slots__ = ("id", "spans", "replays", "captures", "last_event", "resolved", "next",
                 "period_ms", "uncovered_ms")

    def __init__(self, uid):
        self.id, self.spans = uid, []
        self.replays = self.captures = 0
        self.last_event = None  # the last event its spans recorded
        self.resolved = False
        self.next = None  # the next update opened on its thread
        self.period_ms = self.uncovered_ms = None

    def as_dict(self) -> Dict:
        return {"id": self.id, "replayed": self.replays > 0 and not self.captures,
                "period_ms": self.period_ms, "uncovered_ms": self.uncovered_ms,
                "spans": [r.as_dict() for r in self.spans]}


class _NullSpan:
    """What ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()


class Tracer:
    """The spans and counters of one process (see the module's docstring)."""

    def __init__(self):
        self.enabled = True
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._update_ids = itertools.count(1)
        self._free_events: List[torch.cuda.Event] = []
        self.reset()

    # ---- switches -------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Forget every record, running statistic and counter (the spans
        open now still close, into the fresh state)."""
        with self._lock:
            self._updates = collections.deque()
            self._pending = collections.deque()  # kept updates whose events are not all read
            self._others = collections.deque(maxlen=OTHERS_KEPT)
            self._span_stats: Dict[str, Dict[str, Stats]] = {}
            self._counters: Dict[str, Stats] = {}
            self._device_counters: Dict[str, DeviceSum] = {}

    # ---- spans ----------------------------------------------------------
    def span(self, name: str, device=None, update: bool = False, tiled: bool = False,
             after: Optional[_Record] = None):
        """A context manager timing its block as the span ``name`` (it
        returns the span, or None while tracing is off);
        ``device``: a ``torch.device`` whose clock is read too where it is
        a CUDA device (its current stream's events);
        ``update``: the block is one update, which the spans inside share;
        ``tiled``: its children cover all the device work it enqueues, so
        they share their marks with it and with each other;
        ``after``: a sibling that closed just before it, with nothing
        enqueued since: it starts at that span's end."""
        if not self.enabled:
            return _NULL
        return _Record(self, name, device, update, tiled, after)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = stack = []
            return stack

    def in_update(self) -> bool:
        """Whether this thread is inside an update span."""
        stack = self._stack() if self.enabled else ()
        return bool(stack) and stack[-1].update is not None

    def _open(self, rec: _Record) -> None:
        stack = self._stack()
        parent = stack[-1] if stack else None
        uid = parent.update if parent is not None else None
        if rec.opens_update and uid is None:  # inside an update: a span of the outer one
            upd = self._local.current = _Update(next(self._update_ids))
            uid = upd.id
            prev = getattr(self._local, "last", None)
            if prev is not None:
                prev.next = upd
            self._local.last = upd
        rec.id, rec.parent, rec.update = next(self._ids), parent and parent.id, uid
        if uid is not None:
            self._local.current.spans.append(rec)
        else:
            with self._lock:
                self._others.append(rec)
        stack.append(rec)
        if _autograd_profiler._is_profiler_enabled:
            rec.profiled = torch.profiler.record_function(rec.name)
            rec.profiled.__enter__()
        device = rec.device
        if device is not None and device.type == "cuda" \
                and not torch.cuda.is_current_stream_capturing():
            after = rec.after
            if after is not None and after.ev1 is not None:
                rec.ev0 = after.ev1
            elif parent is not None and parent.tail is not None:
                rec.ev0 = parent.tail
            else:
                rec.ev0 = self._event()
                rec.ev0.record(self._stream(device))
                rec.own0 = True
            if rec.tiled:
                rec.tail = rec.ev0
        rec.t0 = time.perf_counter_ns()

    def _close(self, rec: _Record) -> None:
        rec.t1 = time.perf_counter_ns()
        if rec.ev0 is not None:
            if rec.tail is not None and rec.tail is not rec.ev0:  # where its last child ended
                rec.ev1 = rec.tail
            else:
                rec.ev1 = self._event()
                rec.ev1.record(self._stream(rec.device))
                rec.own1 = True
            rec.tail = None
            if rec.update is not None:
                self._local.current.last_event = rec.ev1
        if rec.profiled is not None:
            rec.profiled.__exit__(None, None, None)
            rec.profiled = None
        stack = self._stack()
        if stack and stack[-1] is rec:
            stack.pop()
        else:  # closed out of order (a generator left open): drop it wherever it is
            stack[:] = [r for r in stack if r is not rec]
        if stack:
            parent = stack[-1]
            parent.child_ns += rec.t1 - rec.t0
            if parent.tail is not None and rec.ev1 is not None:
                parent.tail = rec.ev1
        if rec.update is None:
            with self._lock:
                self._fold_host(rec)
        elif self._local.current.spans[0] is rec:
            with self._lock:
                self._close_update()

    def _fold_host(self, rec: _Record) -> None:
        """A closed span's host times into the running statistics."""
        st = self._stats(rec.name)
        st["host_ms"].add(rec.host_ms())
        if rec.ev0 is None:  # else its self time is the device's, once read
            st["self_ms"].add(rec.host_self_ms())

    def _close_update(self) -> None:
        upd = self._local.current
        self._local.current = None
        for rec in upd.spans:
            self._fold_host(rec)
        self._updates.append(upd)
        if len(self._updates) > UPDATES_KEPT:
            old = self._updates.popleft()
            if self._pending and self._pending[0] is old:  # the card is a ring behind: drop
                self._pending.popleft()
        if upd.last_event is not None:
            self._pending.append(upd)
            if len(self._pending) > 2:  # no graph replay has read them (an eager trainer)
                self._read_done(wait=False)

    def _stats(self, name: str) -> Dict[str, Stats]:
        st = self._span_stats.get(name)
        if st is None:
            st = self._span_stats[name] = {"host_ms": Stats(), "device_ms": Stats(),
                                           "self_ms": Stats()}
        return st

    # ---- CUDA events ----------------------------------------------------
    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        """``device``'s current CUDA stream, as ``torch.cuda.current_stream(
        device)`` gives it, at a tenth of its cost: the thread keeps the
        ``Stream`` objects it made, by stream."""
        index = device.index if device.index is not None else torch._C._cuda_getDevice()
        key = torch._C._cuda_getCurrentStream(index)
        try:
            streams = self._local.streams
        except AttributeError:
            streams = self._local.streams = {}
        stream = streams.get(key)
        if stream is None:
            stream = streams[key] = torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2])
        return stream

    def _event(self) -> torch.cuda.Event:
        try:
            return self._free_events.pop()
        except IndexError:  # the pool grows by a block
            self._free_events.extend(torch.cuda.Event(enable_timing=True)
                                     for _ in range(EVENT_BLOCK - 1))
            return torch.cuda.Event(enable_timing=True)

    def _release(self, recs: List[_Record], keep=None) -> None:
        """Pool the events that ``recs`` recorded, but ``keep``, and drop
        their references to the rest."""
        free = self._free_events
        for r in recs:
            if r.own0 and r.ev0 is not keep:
                free.append(r.ev0)
                r.own0 = False
            if r.own1:
                free.append(r.ev1)
                r.own1 = False
            if r.ev0 is not keep:
                r.ev0 = None
            r.ev1 = None

    def _resolve(self, upd: _Update) -> None:
        """Read an update's events (the card has passed them) and pool them
        but its start, which its period reads."""
        self._resolve_spans(upd.spans)
        self._release(upd.spans, keep=upd.spans[0].ev0)
        upd.resolved = True

    def _read_done(self, wait: bool) -> None:
        """Read the pending updates' events, oldest first, as far as the card
        has passed them (``wait``: all, after a synchronisation), and pool
        the events read; an update's start event waits for the start of the
        next update on its thread, which its period reads."""
        pending = self._pending
        while pending:
            upd = pending[0]
            if not upd.resolved:
                if not (wait or upd.last_event.query()):
                    return
                self._resolve(upd)
            root = upd.spans[0]
            if root.ev0 is not None:
                nxt = upd.next
                if nxt is None:  # not opened yet
                    break
                start = nxt.spans[0].ev0
                if start is not None:
                    if not (wait or start.query()):
                        return
                    upd.period_ms = root.ev0.elapsed_time(start)
                    upd.uncovered_ms = max(upd.period_ms - root.device_ms, 0.0)
                self._release([root])
            pending.popleft()
        if wait:  # the updates behind one whose next is not open yet
            for upd in pending:
                if not upd.resolved:
                    self._resolve(upd)

    def _resolve_spans(self, recs: List[_Record]) -> None:
        """Device durations and self times of ``recs`` whose events are done,
        folded into the running statistics."""
        for r in recs:
            if r.ev1 is not None:
                r.device_ms = r.ev0.elapsed_time(r.ev1)
        covered: Dict[int, float] = {}
        for r in recs:
            if r.device_ms is not None and r.parent is not None:
                covered[r.parent] = covered.get(r.parent, 0.0) + r.device_ms
        for r in recs:
            if r.device_ms is not None:
                r.self_ms = r.device_ms - covered.get(r.id, 0.0)
                st = self._stats(r.name)
                st["device_ms"].add(r.device_ms)
                st["self_ms"].add(r.self_ms)

    # ---- counters -------------------------------------------------------
    def _count(self, name: str, n) -> None:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Stats()
        c.add(n)

    def graph_captured(self, name: str) -> None:
        """A graph ``name`` was captured (``train/graphs.py``)."""
        if self.enabled:
            with self._lock:
                self._count("captures:" + name, 1)
            if self.in_update():
                self._local.current.captures += 1

    def graph_replayed(self, name: str, input_bytes: int) -> None:
        """A graph ``name`` was replayed after copying ``input_bytes`` into
        its static inputs."""
        if self.enabled:
            with self._lock:
                self._count("replays:" + name, 1)
                self._count("input_bytes:" + name, input_bytes)
            if self.in_update():
                self._local.current.replays += 1
                if self._pending:  # the card has the replay to run: read what it has passed
                    with self._lock:
                        self._read_done(wait=False)

    def widened(self, name: str, n: int) -> None:
        """The pass ``name`` widened ``n`` input tensors to the towers'
        compute dtype."""
        if self.enabled:
            with self._lock:
                self._count("widened:" + name, n)

    def rows(self, name: str, n: int) -> None:
        """The pass ``name`` computed ``n`` rows in its towers."""
        if self.enabled:
            with self._lock:
                self._count("rows:" + name, n)

    def active_rows(self, name: str, active: torch.Tensor, times: int) -> None:
        """The pass ``name`` weighed ``times`` x the sum of ``active`` (0/1
        weights on the device) of its rows: kept on the device, unread."""
        if self.enabled:
            with self._lock:
                c = self._device_counters.get("active_rows:" + name)
                if c is None:
                    c = self._device_counters["active_rows:" + name] = DeviceSum()
                c.add(active.sum(), times)

    # ---- reading --------------------------------------------------------
    def snapshot(self) -> Dict:
        """Everything kept, resolved (one synchronisation where events are
        pending): ``updates`` (each kept update: ``id``, ``replayed``,
        ``period_ms``, ``uncovered_ms`` and its ``spans``), ``others`` (the
        kept spans outside any update), each span as ``id``, ``name``,
        ``parent``, ``update``, ``host_ms``, ``device_ms`` and ``self_ms``; ``spans`` (by
        name, the running ``host_ms``, ``device_ms`` and ``self_ms``: count,
        sum, min, max, or None); ``counters`` (by name, the same four over
        the amounts added); ``launches`` (the kernels' wrapper calls by
        ``module.function``, ``ops/*.py`` ``LAUNCHES``)."""
        from ..train.graphs import launch_counts

        with self._lock:
            updates = list(self._updates)
            others = list(self._others)
            if (self._pending or any(r.ev1 is not None for r in others)
                    or any(c.on_cuda() for c in self._device_counters.values())) \
                    and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self._read_done(wait=True)
            done = [r for r in others if r.ev1 is not None and r.t1]
            if done:
                self._resolve_spans(done)
                self._release(done)
            return {
                "updates": [u.as_dict() for u in updates],
                "others": [r.as_dict() for r in others if r.t1],
                "spans": {name: {k: s.as_dict() for k, s in st.items()}
                          for name, st in self._span_stats.items()},
                "counters": {name: c.as_dict() for name, c in
                             list(self._counters.items()) + list(self._device_counters.items())},
                "launches": {f"{mod.rsplit('.', 1)[-1]}.{fn}": n
                             for (mod, fn), n in launch_counts().items()},
            }


TRACER = Tracer()

span = TRACER.span
in_update = TRACER.in_update
graph_captured = TRACER.graph_captured
graph_replayed = TRACER.graph_replayed
widened = TRACER.widened
rows = TRACER.rows
active_rows = TRACER.active_rows
snapshot = TRACER.snapshot
reset = TRACER.reset
enable = TRACER.enable
disable = TRACER.disable
