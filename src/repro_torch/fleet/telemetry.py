"""Fleet telemetry: structured per-step and per-request metrics with
JSONL export.

:class:`FleetTelemetry` is the observability seam of the fleet layer —
:class:`~repro_torch.fleet.server.FleetServer` feeds it one record per barrier
step (per-replica loads, cross-replica imbalance, energy split into
serving vs barrier-idle, token counts, per-step preemption/prefix-hit
deltas) and
one record per finished request (fleet-clock TTFT / TPOT / end-to-end
latency, terminal status, error text), and :meth:`summary` folds them
into the serving scorecard: latency percentiles, SLO attainment,
energy-per-token, mean imbalance.

Export is line-delimited JSON (one self-describing record per line,
``kind`` in {``meta``, ``step``, ``request``, ``summary``}) so a run can
be streamed to disk while serving and post-processed with standard
tooling; :meth:`read_jsonl` round-trips a file back into an equivalent
telemetry object, and files cross between this package and the
reference's in both directions (``tests/test_torch_fleet.py``).

The meta record carries ``schema_version`` (:data:`SCHEMA_VERSION`);
the reader accepts any version in :data:`ACCEPTED_VERSIONS` and rejects
everything else up front, instead of failing later with an opaque
``KeyError`` on a reshaped record.  Bump the constant whenever a
record's key set changes.

Version history:

* **1** — per-step fleet records + per-request records (PR 5);
* **2** — step records gain ``replica_count`` (routable replicas when
  the row was cut — the autoscaler's R-over-time series) and
  ``replica_busy`` (per-replica busy seconds in the interval), and
  :meth:`summary` derives ``replica_count`` stats and per-replica
  utilization from them.  Version-1 files (no such keys) read back
  unchanged — the derived fields are simply absent, so their stored
  summaries still validate.
* **3** — step records gain ``prefix_revived`` (per-step delta of
  cached blocks re-pinned by a later hit — the persistent evictor's
  signature signal) and ``prefix_cached_blocks`` (fleet-wide gauge of
  reclaimable LRU-cached blocks when the row was cut);
  :meth:`summary` totals the former and reports the peak of the
  latter, guarded exactly like the v2 fields so v1/v2 files read back
  unchanged.
* **4** — step records gain ``gating_replica`` (the replica whose step
  gated the barrier; ``-1`` for arrival-gap troughs and async tick
  rows) and ``idle_split`` (the step's idle joules decomposed by cause,
  aligned with :data:`repro_torch.obs.IDLE_CAUSES`; its left-fold sum
  reproduces the row's ``idle_j`` bit-exactly — see
  :mod:`repro_torch.obs.ledger`).  :meth:`summary` derives ``idle_by_cause``
  totals and per-replica ``gating_steps`` counts, guarded exactly like
  the v2/v3 fields so v1–v3 files read back unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from ..obs.ledger import IDLE_CAUSES

__all__ = ["SLOSpec", "FleetTelemetry", "percentiles",
           "SCHEMA_VERSION", "ACCEPTED_VERSIONS"]

SCHEMA_VERSION = 4
ACCEPTED_VERSIONS = (1, 2, 3, 4)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Per-request service-level objective: a request attains the SLO
    when its TTFT and its TPOT are both within bounds (failed requests
    never attain)."""

    ttft_s: float = 1.0
    tpot_s: float = 0.1


def percentiles(xs, ps=(50, 95, 99)) -> dict:
    """{"p50": ..., "p95": ...} over finite entries (None when empty —
    JSON-native, and round-trip comparable where NaN would not be)."""
    xs = np.asarray([x for x in xs if x is not None], dtype=np.float64)
    xs = xs[np.isfinite(xs)]
    if xs.size == 0:
        return {f"p{p}": None for p in ps}
    return {f"p{p}": float(np.percentile(xs, p)) for p in ps}


def _jsonify(x):
    """Recursively coerce numpy scalars/arrays into JSON-native types."""
    if isinstance(x, dict):
        return {k: _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonify(v) for v in x]
    if isinstance(x, np.ndarray):
        return [_jsonify(v) for v in x.tolist()]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    return x


class FleetTelemetry:
    """Collects step/request records; summarizes; round-trips JSONL."""

    STEP_KEYS = ("step", "t", "dt", "replica_loads", "replica_active",
                 "replica_waiting", "cross_imbalance", "energy_j",
                 "idle_j", "tokens", "preemptions", "prefix_hits",
                 "replica_count", "replica_busy",
                 "prefix_revived", "prefix_cached_blocks",
                 "gating_replica", "idle_split")
    REQUEST_KEYS = ("rid", "replica", "status", "error", "t_arrival",
                    "t_routed", "ttft", "tpot", "latency", "n_prompt",
                    "n_generated")

    def __init__(self, slo: Optional[SLOSpec] = None,
                 record_steps: bool = True):
        self.slo = slo or SLOSpec()
        self.record_steps = record_steps
        self.steps: list[dict] = []
        self.requests: list[dict] = []

    # -- ingestion ------------------------------------------------------
    def record_step(self, **kw) -> None:
        if not self.record_steps:
            return
        rec = {k: _jsonify(kw.get(k)) for k in self.STEP_KEYS}
        self.steps.append(rec)

    def record_request(self, **kw) -> None:
        rec = {k: _jsonify(kw.get(k)) for k in self.REQUEST_KEYS}
        self.requests.append(rec)

    # -- aggregation ----------------------------------------------------
    def summary(self) -> dict:
        reqs = self.requests
        done = [r for r in reqs if r["status"] == "done"]
        failed = [r for r in reqs if r["status"] == "failed"]
        tokens = sum(s["tokens"] for s in self.steps) if self.steps \
            else sum(r["n_generated"] or 0 for r in done)
        energy = sum(s["energy_j"] + s["idle_j"] for s in self.steps)
        imb = [s["cross_imbalance"] for s in self.steps]
        attained = [
            r for r in done
            if r["ttft"] is not None and r["ttft"] <= self.slo.ttft_s
            and (r["tpot"] is None or r["tpot"] <= self.slo.tpot_s)
        ]
        out = {
            "n_requests": len(reqs),
            "completed": len(done),
            "failed": len(failed),
            "steps": len(self.steps),
            "time_s": self.steps[-1]["t"] if self.steps else 0.0,
            "tokens": tokens,
            "energy_j": energy,
            "energy_per_token": energy / max(tokens, 1),
            "mean_cross_imbalance": float(np.mean(imb)) if imb else 0.0,
            "slo_attainment": len(attained) / max(len(reqs), 1),
            "slo": dataclasses.asdict(self.slo),
            # step rows carry per-step deltas (not running totals), so
            # the run totals are their sums
            "preemptions": sum(s["preemptions"] for s in self.steps),
            "prefix_hits": sum(s["prefix_hits"] for s in self.steps),
        }
        for key in ("ttft", "tpot", "latency"):
            out[key] = percentiles([r[key] for r in done])
        # v2 series (absent from v1 files: the derived fields are then
        # omitted, so v1 stored summaries still validate on read-back)
        counts = [s.get("replica_count") for s in self.steps]
        if counts and all(c is not None for c in counts):
            out["replica_count"] = {
                "mean": float(np.mean(counts)),
                "min": int(min(counts)), "max": int(max(counts)),
            }
        busy = [s.get("replica_busy") for s in self.steps]
        if busy and all(b is not None for b in busy):
            per = np.asarray(busy, dtype=np.float64).sum(axis=0)
            t = max(self.steps[-1]["t"], 1e-12)
            out["replica_utilization"] = [float(x) for x in per / t]
        # v3 series (same guard: absent from v1/v2 files)
        revived = [s.get("prefix_revived") for s in self.steps]
        if revived and all(x is not None for x in revived):
            out["prefix_revived"] = sum(revived)
        cached = [s.get("prefix_cached_blocks") for s in self.steps]
        if cached and all(x is not None for x in cached):
            out["prefix_cached_blocks_peak"] = int(max(cached))
        # v4 series (same guard: absent from v1/v2/v3 files)
        splits = [s.get("idle_split") for s in self.steps]
        if splits and all(x is not None for x in splits):
            per = np.asarray(splits, dtype=np.float64).sum(axis=0)
            out["idle_by_cause"] = {
                name: float(per[i])
                for i, name in enumerate(IDLE_CAUSES)}
        gating = [s.get("gating_replica") for s in self.steps]
        if gating and all(g is not None for g in gating):
            counts: dict[str, int] = {}
            for g in gating:
                if g >= 0:
                    counts[str(g)] = counts.get(str(g), 0) + 1
            out["gating_steps"] = counts
        return _jsonify(out)

    # -- JSONL export / import -----------------------------------------
    def write_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(
                {"kind": "meta", "schema_version": SCHEMA_VERSION,
                 "slo": dataclasses.asdict(self.slo),
                 "record_steps": self.record_steps}) + "\n")
            for s in self.steps:
                f.write(json.dumps({"kind": "step", **s}) + "\n")
            for r in self.requests:
                f.write(json.dumps({"kind": "request", **r}) + "\n")
            f.write(json.dumps({"kind": "summary",
                                **self.summary()}) + "\n")

    @classmethod
    def read_jsonl(cls, path: str) -> "FleetTelemetry":
        """Rebuild a telemetry object from a JSONL export; the trailing
        summary line is validated against the recomputed summary."""
        tel: Optional[FleetTelemetry] = None
        summary = None
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                kind = rec.pop("kind")
                if kind == "meta":
                    version = rec.get("schema_version")
                    if version not in ACCEPTED_VERSIONS:
                        raise ValueError(
                            f"{path}: telemetry schema_version "
                            f"{version!r} not supported (reader "
                            f"accepts {ACCEPTED_VERSIONS}); re-export "
                            "the run with a supported version")
                    tel = cls(slo=SLOSpec(**rec["slo"]),
                              record_steps=rec["record_steps"])
                elif kind == "step":
                    tel.steps.append(rec)
                elif kind == "request":
                    tel.requests.append(rec)
                elif kind == "summary":
                    summary = rec
        if tel is None:
            raise ValueError(f"{path}: no meta record")
        if summary is not None:
            recomputed = json.loads(json.dumps(tel.summary()))
            if recomputed != summary:
                raise ValueError(
                    f"{path}: stored summary does not match records")
        return tel
