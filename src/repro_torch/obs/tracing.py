"""Request-lifecycle and scheduler-step tracing as Chrome trace events
(port of `repro.obs.tracing`).

Two layers:

- ``Tracer`` — an append-only buffer of Chrome trace-event dicts
  (``ph`` in B/E/X/i/C/M), timestamps in microseconds relative to the
  first event.  ``obs.export.write_trace`` wraps the buffer in the
  ``{"traceEvents": [...]}`` envelope that Perfetto and
  ``chrome://tracing`` load directly.
- ``EngineSpans`` — the serving engine's view: a per-request span state
  machine (submitted -> queued -> prefill -> decode -> preempted/
  resumed -> finished/cancelled) plus per-iteration scheduler step
  spans with phase children (retire/admit/prefill/decode) and counter
  tracks fed from the engine's existing ``trace_hook`` snapshot point.
  Every method is a no-op when no tracer is attached, so the engine
  calls them unconditionally and pays one attribute test per site when
  tracing is off.

Track layout: pid 0, tid 0 is the scheduler; request ``rid`` gets
tid ``rid + 1``.  All timestamps are host ``time.perf_counter()``
floats — reading a token *value* for a trace event would force a
device sync, so span boundaries only ever use host-side stamps the
engine already takes (the one device-to-host copy of a paged decode
step remains the only transfer).
"""

from __future__ import annotations

import time

SCHED_TID = 0


def _tid(rid):
    return int(rid) + 1


class Tracer:
    """Append-only Chrome trace-event buffer (host-side, one process)."""

    def __init__(self):
        self._events = []
        self._origin = None
        self._named_tids = set()

    # -- time base ---------------------------------------------------------
    def _ts(self, t):
        if t is None:
            t = time.perf_counter()
        if self._origin is None:
            self._origin = t
        return (t - self._origin) * 1e6  # us

    def reset(self):
        """Drop buffered events and the time origin (per-run tracing)."""
        self._events = []
        self._origin = None
        self._named_tids = set()

    # -- emitters ----------------------------------------------------------
    def thread_name(self, tid, name):
        if tid in self._named_tids:
            return
        self._named_tids.add(tid)
        self._events.append(
            {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
             "args": {"name": name}}
        )

    def begin(self, tid, name, t=None, **args):
        ev = {"name": name, "ph": "B", "pid": 0, "tid": tid,
              "ts": self._ts(t)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def end(self, tid, t=None):
        self._events.append(
            {"ph": "E", "pid": 0, "tid": tid, "ts": self._ts(t)}
        )

    def complete(self, tid, name, t0, t1, **args):
        ev = {"name": name, "ph": "X", "pid": 0, "tid": tid,
              "ts": self._ts(t0), "dur": max(0.0, (t1 - t0) * 1e6)}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, tid, name, t=None, **args):
        ev = {"name": name, "ph": "i", "pid": 0, "tid": tid,
              "ts": self._ts(t), "s": "t"}
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, tid, name, values, t=None):
        self._events.append(
            {"name": name, "ph": "C", "pid": 0, "tid": tid,
             "ts": self._ts(t), "args": dict(values)}
        )

    def events(self):
        return list(self._events)

    def __len__(self):
        return len(self._events)


class EngineSpans:
    """Span state machine the engine drives; no-op without a tracer.

    One open B/E span per request at any time (its lifecycle phase);
    sub-work inside a phase (a prefill chunk, a swap transfer, replay)
    is emitted as complete (X) events nested under it.  ``run_end``
    closes whatever is still open so the trace always balances.
    """

    PHASES = ("queued", "prefill", "decode", "preempted")

    def __init__(self, tracer=None):
        self._tr = tracer
        self._open = {}          # rid -> current phase name
        self._chunk_idx = {}     # rid -> prefill chunk ordinal
        self._step_idx = 0

    @property
    def on(self):
        return self._tr is not None

    # -- request lifecycle -------------------------------------------------
    def _enter(self, rid, phase, t, **args):
        tr = self._tr
        tid = _tid(rid)
        tr.thread_name(tid, f"request {rid}")
        cur = self._open.get(rid)
        if cur is not None:
            tr.end(tid, t)
        tr.begin(tid, phase, t, **args)
        self._open[rid] = phase

    def _leave(self, rid, t):
        if self._open.pop(rid, None) is not None:
            self._tr.end(_tid(rid), t)

    def submitted(self, rid, t=None):
        if self._tr is None:
            return
        self._enter(rid, "queued", t)

    def admitted(self, rid, t=None, mode=""):
        if self._tr is None:
            return
        self._enter(rid, "prefill", t, mode=mode)

    def chunk(self, rid, t0, t1, tokens=0):
        """One chunked-prefill slice of this request's prompt."""
        if self._tr is None:
            return
        i = self._chunk_idx.get(rid, 0)
        self._chunk_idx[rid] = i + 1
        self._tr.complete(_tid(rid), f"prefill_chunk[{i}]", t0, t1,
                          tokens=int(tokens))

    def first_token(self, rid, t=None):
        if self._tr is None:
            return
        self._tr.instant(_tid(rid), "first_token", t)
        self._enter(rid, "decode", t)

    def decoding(self, rid, t=None):
        if self._tr is None:
            return
        if self._open.get(rid) != "decode":
            self._enter(rid, "decode", t)

    def token(self, rid, t=None):
        if self._tr is None:
            return
        self._tr.instant(_tid(rid), "token", t)

    def preempted(self, rid, t=None, mode=""):
        if self._tr is None:
            return
        self._enter(rid, "preempted", t, mode=mode)

    def swap(self, rid, t0, t1, direction, nbytes=0):
        if self._tr is None:
            return
        self._tr.complete(_tid(rid), f"swap_{direction}", t0, t1,
                          bytes=int(nbytes))

    def resume_work(self, rid, t0, t1, mode=""):
        """The replay / swap-in work done to bring a victim back."""
        if self._tr is None:
            return
        self._tr.complete(_tid(rid), "resume", t0, t1, mode=mode)

    def resumed(self, rid, t=None, phase="decode"):
        if self._tr is None:
            return
        self._enter(rid, phase, t)

    def finished(self, rid, t=None):
        if self._tr is None:
            return
        self._leave(rid, t)
        self._tr.instant(_tid(rid), "finished", t)
        self._chunk_idx.pop(rid, None)

    def cancelled(self, rid, t=None):
        if self._tr is None:
            return
        self._leave(rid, t)
        self._tr.instant(_tid(rid), "cancelled", t)
        self._chunk_idx.pop(rid, None)

    # -- scheduler ---------------------------------------------------------
    def step(self, t0, t1, phases=(), **args):
        """One scheduler iteration: parent X span + phase X children.

        ``phases`` is ``[(name, p0, p1), ...]`` with host stamps taken
        around the retire/admit/prefill/decode regions of the loop.
        """
        if self._tr is None:
            return
        tr = self._tr
        tr.thread_name(SCHED_TID, "scheduler")
        i = self._step_idx
        self._step_idx += 1
        tr.complete(SCHED_TID, f"step[{i}]", t0, t1, **args)
        for name, p0, p1 in phases:
            tr.complete(SCHED_TID, name, p0, p1)

    def snapshot(self, snap, t=None):
        """Counter tracks from the engine's trace_hook snapshot dict."""
        if self._tr is None:
            return
        tr = self._tr
        tr.thread_name(SCHED_TID, "scheduler")
        tr.counter(SCHED_TID, "pool",
                   {"pages_in_use": snap.get("pages_in_use", 0),
                    "free_pages": snap.get("free_pages", 0)}, t)
        tr.counter(SCHED_TID, "load",
                   {"active": snap.get("active", 0),
                    "queued": snap.get("queued", 0),
                    "swapped": snap.get("swapped", 0)}, t)

    # -- run boundary ------------------------------------------------------
    def run_begin(self, t=None):
        if self._tr is None:
            return
        self._tr.reset()
        self._open = {}
        self._chunk_idx = {}
        self._step_idx = 0
        self._tr.instant(SCHED_TID, "run_begin", t)

    def run_end(self, t=None):
        if self._tr is None:
            return
        for rid in list(self._open):
            self._leave(rid, t)
        self._tr.instant(SCHED_TID, "run_end", t)
