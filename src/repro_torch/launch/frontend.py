"""Asyncio streaming front end over the paged continuous-batching engine
(port of `repro.launch.frontend`).

`ContinuousBatchingEngine.run` is a synchronous host loop: one thread,
one decode step an iteration, the `submit` / `cancel` mailboxes drained
once an iteration. This module puts an asyncio face on it and leaves that
loop as it is:

  * the engine loop runs on a daemon thread in serve-forever mode
    (`clock_mode="wall"`, `drain=False`); `torch.no_grad` is entered on
    that thread by `run`, and its launches go to its default stream;
  * `AsyncFrontend.submit()` hands a request to the engine's thread-safe
    mailbox and returns a `RequestStream`, an async iterator of
    `TokenEvent`s fed from the host ints the engine already copied (one
    device-to-host copy a decode step for every slot, one a chunk step
    that finishes prompts), fanned out to per-request asyncio queues
    through `call_soon_threadsafe`: no copy a token;
  * `RequestStream.cancel()` maps onto the engine's eviction path: queued
    requests are dropped, mid-prefill ones lose their prefill job and
    granted pages, active or preempted ones are evicted (shared prefix
    pages released by refcount, swapped planes discarded with no swap-in);
  * `stop()` shuts the loop down and returns the engine's results and
    stats.

The greedy tokens streamed here equal a synchronous `engine.run` over the
same requests: scheduling, arrival times, preemption and the prefix cache
never change tokens (tests/test_torch_frontend.py).

`play_trace` is the synchronous harness: it replays a timed arrival trace
(rows `(tokens, gen, at_seconds)`) through the front end and reports
latency SLOs: per-request TTFT (first token time minus the scheduled
arrival, so queueing is charged) and inter-token latency, p50 and p99.
The engine's Python loop and the asyncio loop share the interpreter
lock, so both latencies include that contention, as in the reference.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.launch.serve import ContinuousBatchingEngine, Request
from repro_torch.obs import export as obs_export
from repro_torch.obs.metrics import summary_ms

__analysis__ = {
    "traced": (),
    "host_loop": (),
    "device_returning": (),
    "device_params": (),
    "host_objects": ("engine", "_engine", "registry", "reg", "server"),
}


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed greedy token: value, perf_counter stamp of the step
    that produced it, and whether it completes its request."""
    token: int
    t: float
    final: bool


class RequestStream:
    """Per-request handle: an async iterator of `TokenEvent`s.

    `arrive_t` is the scheduled engine-clock arrival (seconds since run
    start) or None for "submitted now"; `submit_t` is the perf_counter
    stamp of the submit call. TTFT is measured against the scheduled
    arrival when there is one — a request that waited in the queue is
    charged its queueing delay.
    """

    def __init__(self, frontend: "AsyncFrontend", rid: int,
                 submit_t: float, arrive_t: Optional[float]):
        self._frontend = frontend
        self.rid = rid
        self.submit_t = submit_t
        self.arrive_t = arrive_t
        self.cancelled = False
        self.done = False
        self.events: List[TokenEvent] = []
        self._q: asyncio.Queue = asyncio.Queue()

    def __aiter__(self):
        return self

    async def __anext__(self) -> TokenEvent:
        if self.done and self._q.empty():
            raise StopAsyncIteration
        item = await self._q.get()
        if item is None:
            self.done = True
            raise StopAsyncIteration
        if isinstance(item, BaseException):
            self.done = True
            raise item
        return item

    @property
    def tokens(self) -> np.ndarray:
        """Tokens streamed so far (all of them, once drained)."""
        return np.asarray([e.token for e in self.events], np.int32)

    async def drain(self) -> np.ndarray:
        """Consume the stream to completion; returns the token array."""
        async for _ in self:
            pass
        return self.tokens

    def cancel(self) -> None:
        """Cancel this request (idempotent, best-effort — see
        ContinuousBatchingEngine.cancel). Closes the stream immediately;
        tokens already streamed stay in `events`."""
        if self.cancelled or self.done:
            return
        self.cancelled = True
        self._frontend._engine.cancel(self.rid)
        self._q.put_nowait(None)            # close the iterator


class AsyncFrontend:
    """Drives one serve-forever engine loop from asyncio.

    Lifecycle::

        fe = AsyncFrontend(engine, params)
        await fe.start()                  # engine loop on a daemon thread
        h = fe.submit(tokens, gen)        # or at=<seconds since start>
        async for ev in h: ...            # stream TokenEvents
        results, stats = await fe.stop()  # drain mailboxes, join thread

    One frontend per engine at a time (the engine owns one live run).
    """

    def __init__(self, engine: ContinuousBatchingEngine, params, *,
                 trace_hook=None):
        self._engine = engine
        self._params = params
        self._trace_hook = trace_hook
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._streams: Dict[int, RequestStream] = {}
        self._error: Optional[BaseException] = None
        self.results: Optional[Dict[int, np.ndarray]] = None
        self.stats: Optional[dict] = None
        # latency distributions, observed per streamed token on the event
        # loop (host stamps of the engine's existing copies: no extra
        # sync). The registry reset at run start and in reset_stats()
        # drops the warm-up's samples; these series handles survive it.
        reg = engine.telemetry.registry
        self._h_ttft = reg.histogram(
            "frontend_ttft_seconds",
            "time to first token vs scheduled arrival",
            unit="seconds").series()
        self._h_itl = reg.histogram(
            "frontend_itl_seconds",
            "inter-token latency (consecutive stream gaps, pooled)",
            unit="seconds").series()

    # ------------------------------------------------------- lifecycle
    async def start(self) -> None:
        """Start the engine loop and wait until it accepts traffic."""
        if self._thread is not None:
            raise RuntimeError("frontend already started")
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(
            target=self._serve, name="engine-loop", daemon=True)
        self._thread.start()
        ok = await self._loop.run_in_executor(
            None, self._engine._run_live.wait, 30.0)
        if not ok:
            raise RuntimeError("engine loop failed to come up") \
                from self._error

    def _serve(self) -> None:
        """Engine thread body: the serve-forever run loop."""
        try:
            self.results, self.stats = self._engine.run(
                self._params, [], trace_hook=self._trace_hook,
                emit=self._emit, clock_mode="wall", drain=False)
        except BaseException as e:          # propagate into the streams
            self._error = e
            if self._loop is not None:
                self._loop.call_soon_threadsafe(self._fail, e)

    def _emit(self, rid: int, token: int, final: bool, t: float) -> None:
        # engine thread -> event loop; the tokens are host ints already
        self._loop.call_soon_threadsafe(
            self._dispatch, rid, token, final, t)

    def _dispatch(self, rid: int, token: int, final: bool,
                  t: float) -> None:
        h = self._streams.get(rid)
        if h is None or h.cancelled or h.done:
            return                          # late token of a cancelled rid
        ev = TokenEvent(token=token, t=t, final=final)
        h.events.append(ev)
        if len(h.events) == 1:
            ref = self.t_origin + h.arrive_t if h.arrive_t is not None \
                else h.submit_t
            self._h_ttft.observe(t - ref)
        else:
            self._h_itl.observe(t - h.events[-2].t)
        h._q.put_nowait(ev)
        if final:
            h._q.put_nowait(None)           # close the iterator

    def _fail(self, e: BaseException) -> None:
        for h in self._streams.values():
            if not h.done:
                h._q.put_nowait(e)

    @property
    def t_origin(self) -> float:
        """perf_counter stamp of the engine clock's zero (run start)."""
        return self._engine._t_origin

    # --------------------------------------------------------- traffic
    def submit(self, tokens, gen: int,
               at: Optional[float] = None) -> RequestStream:
        """Submit a request; returns its stream handle. `at` schedules
        the arrival on the engine clock (seconds since run start) —
        None means "arrives now". Must be called on the event loop."""
        if self._error is not None:
            raise RuntimeError("engine loop died") from self._error
        t_sub = time.perf_counter()
        rid = self._engine.submit(Request(np.asarray(tokens), gen), at=at)
        h = RequestStream(self, rid, submit_t=t_sub, arrive_t=at)
        self._streams[rid] = h
        return h

    async def stop(self) -> Tuple[Dict[int, np.ndarray], dict]:
        """Stop the engine loop and return its (results, stats). Streams
        still open (cancelled or in flight at stop) are closed; their
        partial tokens remain on the handles."""
        self._engine.request_stop()
        await self._loop.run_in_executor(None, self._thread.join)
        if self._error is not None:
            raise self._error
        for h in self._streams.values():
            if not h.done:
                h._q.put_nowait(None)
        return self.results, self.stats


# ----------------------------------------------------------------------
# arrival traces + latency-SLO accounting
# ----------------------------------------------------------------------

def arrival_times(kind: str, n: int, rate: float, *,
                  burst: int = 4, rng=None) -> List[float]:
    """Arrival offsets (seconds since run start) for an open-loop trace.

    `poisson`: i.i.d. exponential inter-arrival gaps at `rate` req/s —
    the memoryless baseline every queueing model assumes. `bursty`:
    groups of `burst` requests land simultaneously, bursts spaced so the
    long-run offered load is still `rate` req/s — same average load,
    far worse tail (admission queueing concentrates at each burst).
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(0) if rng is None else rng
    if kind == "poisson":
        return list(np.cumsum(rng.exponential(1.0 / rate, n)))
    if kind == "bursty":
        gap = burst / rate
        return [(i // burst) * gap for i in range(n)]
    raise ValueError(f"unknown arrival trace kind: {kind!r}")


def _pctl(xs: Sequence[float]) -> dict:
    """p50/p99/mean/max of a sample, in milliseconds."""
    if not xs:
        return {"p50_ms": None, "p99_ms": None,
                "mean_ms": None, "max_ms": None, "n": 0}
    a = np.asarray(xs, np.float64) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean()), "max_ms": float(a.max()),
            "n": int(a.size)}


def slo_summary(streams: Sequence[RequestStream],
                t_origin: float) -> dict:
    """TTFT and inter-token latency percentiles over finished streams.

    TTFT is first-token stamp minus the request's *scheduled* arrival
    (t_origin + arrive_t), so queueing/admission delay is charged to the
    server; for unscheduled submissions the submit stamp is used. ITL
    pools every consecutive-token gap across all streams (per-request
    means hide tail stalls — a preemption is one giant gap, and the
    pooled p99 is exactly where it shows)."""
    ttft: List[float] = []
    itl: List[float] = []
    for h in streams:
        if not h.events:
            continue
        ref = t_origin + h.arrive_t if h.arrive_t is not None \
            else h.submit_t
        ttft.append(h.events[0].t - ref)
        itl.extend(b.t - a.t for a, b in zip(h.events, h.events[1:]))
    return {"requests": len(streams),
            "ttft": _pctl(ttft), "itl": _pctl(itl)}


def play_trace(engine: ContinuousBatchingEngine, params,
               trace: Sequence[Tuple[np.ndarray, int, float]], *,
               warmup: Optional[Sequence] = None,
               trace_hook=None,
               metrics_port: Optional[int] = None,
               after_trace=None
               ) -> Tuple[Dict[int, np.ndarray], dict, dict]:
    """Replay a timed arrival trace through the async front-end.

    `trace` rows are (prompt_tokens, gen, at_seconds). Every request is
    submitted up front with its scheduled arrival; the engine's wall
    clock admits each one when its time comes, so the replay is an
    open-loop load test (arrivals do not wait for completions).

    `warmup` rows (same shape, `at` ignored) run to completion first and
    are then erased from the books via `engine.reset_stats()` — compiled
    programs and a warm PrefixIndex stay, counters/timings/watermarks
    restart — so the reported stats and SLOs reflect only the trace.

    `metrics_port` (not None) serves `GET /metrics` from the engine's
    live registry on 127.0.0.1 for the duration of the replay (0 picks
    an ephemeral port); scrapes read host floats only. `after_trace`, if
    given, is a coroutine function awaited with that server (or None)
    once every stream of the trace has drained and before the engine
    stops: a scrape there sees every request's latency samples.

    Returns ({trace_row_index: streamed int32 tokens}, slo_summary,
    engine stats) — keyed by trace position, so callers can compare
    against a synchronous `engine.run` over the same rows directly.
    The SLO percentiles are read from the shared
    `frontend_ttft_seconds` / `frontend_itl_seconds` histograms that
    the front-end observes online (the registry reset at the warmup
    boundary guarantees they hold exactly the trace's samples), so the
    Prometheus exposition and the returned summary hold the same samples.
    """
    async def _main():
        fe = AsyncFrontend(engine, params, trace_hook=trace_hook)
        server = None
        if metrics_port is not None:
            server = obs_export.MetricsServer(
                engine.telemetry.registry, port=metrics_port)
            await server.start()
            print(f"metrics: http://127.0.0.1:{server.port}/metrics")
        await fe.start()
        if warmup:
            wh = [fe.submit(toks, gen) for toks, gen, *_ in warmup]
            for h in wh:
                await h.drain()
            # let the engine quiesce (final evictions run one iteration
            # after the final token) before drawing the measure boundary
            await asyncio.sleep(0.05)
            engine.reset_stats()
        # the engine clock kept ticking through warmup: schedule the
        # trace relative to "now" so at=0 still means "measure from an
        # unloaded server", and TTFT references follow automatically
        base = time.perf_counter() - fe.t_origin
        handles = [fe.submit(toks, gen, at=base + float(at))
                   for toks, gen, at in trace]
        for h in handles:
            await h.drain()
        if after_trace is not None:
            await after_trace(server)
        results, stats = await fe.stop()
        if server is not None:
            await server.stop()
        return fe, handles, results, stats

    fe, handles, results, stats = asyncio.run(_main())
    slo = {"requests": len(handles),
           "ttft": summary_ms(fe._h_ttft),
           "itl": summary_ms(fe._h_itl)}
    out = {i: h.tokens for i, h in enumerate(handles)}
    return out, slo, stats
