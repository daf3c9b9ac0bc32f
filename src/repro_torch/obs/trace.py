"""Per-request span recording and Chrome trace-event export.

:class:`SpanRecorder` buffers lifecycle *point* events ``(track, rid,
name, t, args)`` on the deterministic sim clock; the exporter derives
duration spans from them (a ``request`` span per rid from ``queued`` to
its terminal event, a ``decode`` span from first token to terminal) and
writes Chrome trace-event JSON loadable in Perfetto / chrome://tracing.
``track`` is :data:`FLEET_TRACK` for fleet-tier events (fleet clock)
or a replica id for engine-tier events (that replica's local clock);
tracks map to trace ``pid`` rows so each process timeline is
self-consistent.

Timestamps in the trace are microseconds (the trace-event wire unit);
the derived spans *also* carry their duration in sim seconds in
``args`` (``e2e_s`` / ``decode_s``), computed by the same subtraction
the fleet's telemetry performs — the bit-exact span-vs-latency gate
reads those, never the (scaled) ``ts``/``dur`` floats.

:data:`NULL_RECORDER` is the disabled default: every hook is a no-op,
no event is ever buffered, and instrumented runs are bit-identical to
uninstrumented ones (gated by the ``obs`` bench section).
"""
from __future__ import annotations

import json

__all__ = ["FLEET_TRACK", "SpanRecorder", "NullRecorder",
           "NULL_RECORDER", "to_chrome_trace", "write_trace",
           "read_trace"]

FLEET_TRACK = -1          # fleet-tier events (fleet clock); pid 0
_TERMINAL = ("completed", "failed")
_POINT_NAMES = frozenset({
    "queued", "routed", "admitted", "prefill-chunk", "decode",
    "preempted", "resumed", "drain-handoff", "completed", "failed"})


class SpanRecorder:
    """Buffering recorder: ``point`` appends one lifecycle event."""

    enabled = True

    def __init__(self):
        self.events: list[tuple] = []   # (track, rid, name, t, args)

    def point(self, track: int, rid: int, name: str, t: float,
              **args) -> None:
        self.events.append((int(track), int(rid), name, float(t),
                            args or None))

    @property
    def n_events(self) -> int:
        return len(self.events)

    def clear(self) -> None:
        self.events.clear()


class NullRecorder:
    """No-op recorder (tracing disabled): zero buffering, zero rows."""

    enabled = False
    events: tuple = ()
    n_events = 0

    def point(self, track, rid, name, t, **args) -> None:
        pass

    def clear(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


def _pid(track: int) -> int:
    return 0 if track < 0 else int(track) + 1


def to_chrome_trace(recorder) -> dict:
    """Chrome trace-event document: one instant event per recorded
    point, plus derived ``request`` / ``decode`` complete spans per
    (track, rid), plus process-name metadata rows."""
    events = []
    tracks = sorted({track for track, *_ in recorder.events})
    for track in tracks:
        events.append({"name": "process_name", "ph": "M",
                       "pid": _pid(track), "tid": 0,
                       "args": {"name": ("fleet" if track < 0
                                         else f"replica {track}")}})
    # per-(track, rid) lifecycle endpoints for the derived spans
    first: dict[tuple, tuple] = {}       # (track, rid) -> (t, name)
    decode0: dict[tuple, float] = {}
    terminal: dict[tuple, tuple] = {}
    for track, rid, name, t, args in recorder.events:
        ev = {"name": name, "ph": "i", "s": "t", "ts": t * 1e6,
              "pid": _pid(track), "tid": rid}
        if args:
            ev["args"] = dict(args)
        events.append(ev)
        key = (track, rid)
        if key not in first:
            first[key] = (t, name)
        if name == "decode" and key not in decode0:
            decode0[key] = t
        if name in _TERMINAL:
            terminal[key] = (t, name)
    for key, (t1, status) in terminal.items():
        track, rid = key
        t0, name0 = first[key]
        if name0 == "queued":
            events.append({"name": "request", "ph": "X",
                           "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                           "pid": _pid(track), "tid": rid,
                           "args": {"e2e_s": t1 - t0,
                                    "status": status}})
        if key in decode0:
            td = decode0[key]
            events.append({"name": "decode-span", "ph": "X",
                           "ts": td * 1e6, "dur": (t1 - td) * 1e6,
                           "pid": _pid(track), "tid": rid,
                           "args": {"decode_s": t1 - td,
                                    "status": status}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"generator": "repro.obs",
                          "clock": "sim-seconds (ts in us)"}}


def write_trace(recorder, path: str) -> dict:
    """Export ``recorder`` to ``path`` as trace-event JSON; returns the
    document (handy for immediate validation)."""
    doc = to_chrome_trace(recorder)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def _validate_event(i: int, ev) -> None:
    if not isinstance(ev, dict):
        raise ValueError(f"traceEvents[{i}]: not an object")
    for field, types in (("name", str), ("ph", str),
                         ("pid", int), ("tid", int)):
        if not isinstance(ev.get(field), types):
            raise ValueError(
                f"traceEvents[{i}]: missing/invalid {field!r}")
    ph = ev["ph"]
    if ph not in ("i", "X", "M"):
        raise ValueError(f"traceEvents[{i}]: unknown phase {ph!r}")
    if ph == "M":
        return
    ts = ev.get("ts")
    if not isinstance(ts, (int, float)) or not ts == ts or ts < 0:
        raise ValueError(f"traceEvents[{i}]: bad ts {ts!r}")
    if ph == "X":
        dur = ev.get("dur")
        if not isinstance(dur, (int, float)) or not dur == dur \
                or dur < 0:
            raise ValueError(f"traceEvents[{i}]: bad dur {dur!r}")
    if ph == "i" and ev["name"] not in _POINT_NAMES:
        raise ValueError(
            f"traceEvents[{i}]: unknown span event {ev['name']!r}")


def read_trace(path: str) -> dict:
    """Validating trace reader: checks every event's schema, rebuilds
    the per-request fleet-track lifecycle, and returns::

        {"n_events": ..., "n_points": ..., "requests":
            {rid: {"queued_s", "end_s", "e2e_s", "status"}}}

    ``e2e_s`` comes from the derived ``request`` span's args — the
    value the exporter computed with fleet-clock subtraction — and is
    cross-checked (to float32-ish tolerance only) against the scaled
    ``ts``/``dur`` pair."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    requests: dict[int, dict] = {}
    n_points = 0
    for i, ev in enumerate(events):
        _validate_event(i, ev)
        if ev["ph"] == "i":
            n_points += 1
        if ev["ph"] == "X" and ev["name"] == "request" \
                and ev["pid"] == 0:
            args = ev.get("args") or {}
            e2e = args.get("e2e_s")
            if not isinstance(e2e, (int, float)):
                raise ValueError(
                    f"traceEvents[{i}]: request span without e2e_s")
            if abs(ev["dur"] - e2e * 1e6) > 1e-3 + 1e-6 * ev["dur"]:
                raise ValueError(
                    f"traceEvents[{i}]: dur/e2e_s mismatch "
                    f"({ev['dur']!r} us vs {e2e!r} s)")
            rid = ev["tid"]
            if rid in requests:
                raise ValueError(
                    f"traceEvents[{i}]: duplicate request span for "
                    f"rid {rid}")
            requests[rid] = {"queued_s": ev["ts"] / 1e6,
                             "end_s": (ev["ts"] + ev["dur"]) / 1e6,
                             "e2e_s": float(e2e),
                             "status": args.get("status")}
    return {"n_events": len(events), "n_points": n_points,
            "requests": requests}
