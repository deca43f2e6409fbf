"""Export surfaces for the telemetry layer (port of `repro.obs.export`).

- ``prometheus_text(registry)`` — Prometheus text exposition (0.0.4):
  ``# HELP`` / ``# TYPE`` headers, labeled samples, and for histograms
  the cumulative ``_bucket{le=...}`` / ``_sum`` / ``_count`` triplet.
- ``parse_prometheus(text)`` — minimal parser used by tests and the CI
  smoke step to assert the dump round-trips.
- ``write_trace(tracer, path)`` — Chrome trace-event JSON envelope
  (``{"traceEvents": [...]}``) loadable in Perfetto / chrome://tracing.
- ``write_events_jsonl`` / ``write_metrics_jsonl`` — one-JSON-object-
  per-line logs for offline processing.
- ``MetricsServer`` — a dependency-free asyncio HTTP listener serving
  ``GET /metrics`` from a live registry on an asyncio event loop (the
  engine thread never blocks on it).
"""

from __future__ import annotations

import asyncio
import json

__analysis__ = {
    "traced": (),
    "host_loop": (),
    "device_returning": (),
    "device_params": (),
    "host_objects": ("registry", "reg", "tracer", "server"),
}


def _fmt(v):
    f = float(v)
    if f != f:  # NaN
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _label_str(labels, extra=None):
    items = list(labels.items())
    if extra:
        items += list(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def prometheus_text(registry):
    """Render every registered metric in Prometheus text exposition."""
    lines = []
    for m in registry.collect():
        if m.help:
            lines.append(f"# HELP {m.name} {m.help}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for labels, s in m.samples():
            if m.kind == "histogram":
                cum = s.cumulative_counts()
                for ub, c in zip(m.buckets, cum[:-1]):
                    le = _label_str(labels, {"le": _fmt(ub)})
                    lines.append(f"{m.name}_bucket{le} {c}")
                inf = _label_str(labels, {"le": "+Inf"})
                lines.append(f"{m.name}_bucket{inf} {cum[-1]}")
                lines.append(
                    f"{m.name}_sum{_label_str(labels)} {_fmt(s.sum)}")
                lines.append(
                    f"{m.name}_count{_label_str(labels)} {s.count}")
            else:
                lines.append(
                    f"{m.name}{_label_str(labels)} {_fmt(s.value())}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text):
    """Parse exposition text back to ``{(name, labelstr): float}``.

    Not a general parser — exactly the subset ``prometheus_text``
    emits, so tests and the smoke run can assert round-tripping.
    """
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, val = line.rpartition(" ")
        if "{" in name_part:
            name, _, rest = name_part.partition("{")
            labelstr = rest.rstrip("}")
        else:
            name, labelstr = name_part, ""
        v = float(val)
        out[(name, labelstr)] = v
    return out


def write_prometheus(registry, path):
    with open(path, "w") as f:
        f.write(prometheus_text(registry))


def trace_json(tracer):
    return {"traceEvents": tracer.events(), "displayTimeUnit": "ms"}


def write_trace(tracer, path):
    with open(path, "w") as f:
        json.dump(trace_json(tracer), f)


def write_events_jsonl(tracer, path):
    with open(path, "w") as f:
        for ev in tracer.events():
            f.write(json.dumps(ev) + "\n")


def write_metrics_jsonl(registry, path):
    with open(path, "w") as f:
        for m in registry.collect():
            for labels, s in m.samples():
                rec = {"name": m.name, "kind": m.kind, "labels": labels}
                if m.kind == "histogram":
                    rec.update(count=s.count, sum=s.sum,
                               p50=s.percentile(50), p99=s.percentile(99))
                else:
                    rec["value"] = s.value()
                f.write(json.dumps(rec) + "\n")


class MetricsServer:
    """``GET /metrics`` over a live registry, on the asyncio loop.

    Plain ``asyncio.start_server`` — no web framework.  Rendering the
    exposition reads host-side floats only, so a scrape never touches
    the engine thread or any device buffer.
    """

    def __init__(self, registry, host="127.0.0.1", port=0):
        self._registry = registry
        self._host = host
        self._port = port
        self._server = None

    async def start(self):
        self._server = await asyncio.start_server(
            self._handle, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        return self

    @property
    def port(self):
        return self._port

    async def _handle(self, reader, writer):
        try:
            request = await reader.readline()
            # drain headers until the blank line
            while True:
                line = await reader.readline()
                if not line or line in (b"\r\n", b"\n"):
                    break
            parts = request.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else "/"
            if path == "/metrics":
                body = prometheus_text(self._registry).encode()
                head = (b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: text/plain; version=0.0.4\r\n")
            else:
                body = b"not found\n"
                head = b"HTTP/1.1 404 Not Found\r\nContent-Type: text/plain\r\n"
            writer.write(head
                         + f"Content-Length: {len(body)}\r\n".encode()
                         + b"Connection: close\r\n\r\n" + body)
            await writer.drain()
        finally:
            writer.close()

    async def stop(self):
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
