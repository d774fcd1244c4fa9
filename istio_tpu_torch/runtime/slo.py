"""The fused per-plane SLO scorecard.

Port of istio_tpu/runtime/slo.py. Each serving plane publishes its own
latency and lag readings; this module folds their CURRENT values into
one verdict table, so one read answers "is the mesh meeting its targets,
and which plane is missing". The verdicts of a plane:

  ok       the plane's reading is inside its target
  miss     the reading exists and is outside the target
  no_data  the plane has served nothing in its window (a fresh boot or
           an unused plane: distinct from a miss on purpose)

`overall` is the worst plane verdict (miss > ok > no_data). Pure reads of
gauges, ledgers and the event ring, never the hot path. The audit plane
reads the snapshot a caller passes (`RuntimeServer.audit.snapshot()`,
runtime/audit.py): ok while healthy with every injection explained, miss
otherwise, and no_data when `audit` is None.
"""
from __future__ import annotations

import time
from typing import Any

# targets of the planes that carry none of their own (the check plane's
# 1 ms target is monitor.CHECK_P99_TARGET_MS)
REPORT_DISPATCH_TARGET_MS = 250.0
DISCOVERY_PUSH_P99_TARGET_MS = 50.0


def _worst(verdicts: list[str]) -> str:
    if "miss" in verdicts:
        return "miss"
    if "ok" in verdicts:
        return "ok"
    return "no_data"


def scorecard(monitor: Any, forensics: Any, *,
              audit: dict | None = None,
              discovery: Any = None) -> dict:
    """`monitor` and `forensics` are the port's modules of those names
    (runtime/monitor.py, runtime/forensics.py); `audit` an audit
    snapshot dict; `discovery` a DiscoveryService (its generation)."""
    planes: dict[str, dict] = {}

    # check p99 against the latency plane's target
    lat = monitor.refresh_latency_gauges()
    if lat.get("n_window", 0) <= 0:
        planes["check_wire"] = {"verdict": "no_data", **lat}
    else:
        planes["check_wire"] = {
            "verdict": "ok" if lat.get("under_target") else "miss",
            **lat}

    # report export: the slowest exporter's last dispatch wall and the
    # conservation ledger's volume in flight
    cons = monitor.report_conservation()
    lag = monitor.REPORT_EXPORTER_LAG_MS
    with lag._lock:
        lags = {",".join(f"{k}={v}" for k, v in labels) or "_": val
                for labels, val in lag._values.items()}
    worst_lag = max(lags.values(), default=0.0)
    if cons["accepted"] == 0:
        verdict = "no_data"
    else:
        verdict = "ok" if worst_lag <= REPORT_DISPATCH_TARGET_MS \
            else "miss"
    planes["report_export"] = {
        "verdict": verdict,
        "worst_dispatch_ms": round(worst_lag, 3),
        "target_ms": REPORT_DISPATCH_TARGET_MS,
        "accepted": cons["accepted"], "exported": cons["exported"],
        "in_flight": cons["in_flight"]}

    # discovery push fan-out p99
    try:
        push = monitor.discovery_latency_snapshot()["push"]
    except Exception:
        push = {"count": 0}
    if not push.get("count"):
        planes["discovery_push"] = {"verdict": "no_data", **push}
    else:
        p99 = push.get("p99_ms", 0.0)
        planes["discovery_push"] = {
            "verdict": "ok" if p99 <= DISCOVERY_PUSH_P99_TARGET_MS
            else "miss",
            "target_ms": DISCOVERY_PUSH_P99_TARGET_MS, **push}
    if discovery is not None:
        try:
            planes["discovery_push"]["generation"] = discovery.version()
        except Exception:
            pass

    # quota flush age: informational freshness (an idle pool has no target
    # to miss, but a quota incident wants "when did counters last flush")
    flushes = forensics.EVENTS.snapshot(kind="quota_flush", limit=1)
    if not flushes:
        planes["quota_flush"] = {"verdict": "no_data"}
    else:
        planes["quota_flush"] = {
            "verdict": "ok",
            "age_s": round(time.time() - flushes[0]["wall"], 3),
            "items": flushes[0].get("detail", {}).get("items")}

    # the audit plane's own verdicts: invariants and explainability
    if audit is None:
        planes["audit"] = {"verdict": "no_data"}
    else:
        rate = audit.get("explainability", {}).get("rate", 1.0)
        healthy = bool(audit.get("healthy", True))
        planes["audit"] = {
            "verdict": "ok" if healthy and rate >= 1.0 else "miss",
            "healthy": healthy,
            "explainability_rate": rate,
            "violated": [c["name"] for c in audit.get("checks", ())
                         if c["status"] == "violated"]}

    return {"overall": _worst([p["verdict"] for p in planes.values()]),
            "planes": planes}
