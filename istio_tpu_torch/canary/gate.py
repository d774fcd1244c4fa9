"""The canary gate: decide a candidate snapshot's fate before publish.

Port of istio_tpu/canary/gate.py. `ConfigCanary` owns the recorder, runs record→replay→diff when the
Controller rebuilds, and renders the verdict per the configured mode:

  off   — the RuntimeServer builds no canary at all: no recorder tap,
          no replay, publishes proceed untouched (a ConfigCanary
          constructed directly with mode="off" records but never
          gates);
  warn  — replay + diff, report recorded (metrics, `reports()`),
          publish proceeds even on divergence;
  gate  — divergence rate beyond the threshold VETOES the publish: the
          Controller keeps the OLD dispatcher serving and surfaces a
          typed `CanaryRejected` (on_canary_reject,
          last_canary_rejection).

A broken canary must never take config updates down with it: any
internal replay/diff failure fails OPEN (logged, counted, published) —
the gate only ever vetoes on an actual measured divergence. One
departure from the reference: a `strict` canary (what RuntimeServer
builds for a CUDA device) does not fail open on a fault of the replay's
device trip that CHAOS did not inject. gate() logs it at ERROR and
raises it, so the Controller publishes nothing: a kernel that fails to
load or launch never lets a candidate nobody validated go live. Faults
of the host stages (corpus build, diff, the oracle confirm) still fail
open, as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any

from istio_tpu_torch.canary.differ import (CanaryReport,
                                           confirm_exemplars,
                                           diff_decisions)
from istio_tpu_torch.canary.recorder import TrafficRecorder
from istio_tpu_torch.canary.replay import replay_entries
from istio_tpu_torch.runtime.resilience import chaos_injected
from istio_tpu_torch.utils import metrics as hostmetrics
from istio_tpu_torch.utils.log import scope

log = scope("canary.gate")

MODES = ("off", "warn", "gate")


def register_families(reg: hostmetrics.Registry) -> dict:
    """mixer_canary_* metric families (zero-touched so the exposition
    distinguishes "canary idle" from "canary missing")."""
    fams = {
        "replays": reg.counter(
            "mixer_canary_replays_total",
            "candidate snapshots shadow-replayed against recorded "
            "live traffic"),
        "rows": reg.counter(
            "mixer_canary_replay_rows_total",
            "recorded requests replayed through candidate plans"),
        "divergences": reg.counter(
            "mixer_canary_divergences_total",
            "non-waived recorded-vs-candidate decision divergences, "
            "by kind (status_flip/precondition/quota)"),
        "verdicts": reg.counter(
            "mixer_canary_verdicts_total",
            "gate outcomes by verdict (publish/warn/veto)"),
        "errors": reg.counter(
            "mixer_canary_errors_total",
            "internal canary failures (failed OPEN: publish "
            "proceeded)"),
        "rate": reg.gauge(
            "mixer_canary_last_divergence_rate",
            "divergence rate of the most recent replay"),
        "recorder_entries": reg.gauge(
            "mixer_canary_recorder_entries",
            "recorded requests currently held in the sampling ring"),
        "replay_seconds": reg.histogram(
            "mixer_canary_replay_seconds",
            "shadow-replay wall time per candidate (device steps "
            "included)"),
        "publish_delay_seconds": reg.histogram(
            "mixer_canary_publish_delay_seconds",
            "publish latency the whole canary evaluation added "
            "(corpus build + replay + diff + oracle confirm)"),
    }
    for key in ("replays", "rows", "divergences", "verdicts", "errors"):
        fams[key].inc(0.0)
    return fams


FAMILIES = register_families(hostmetrics.default_registry)


@dataclasses.dataclass
class CanaryConfig:
    """ServerArgs.canary_* mirrors these."""
    mode: str = "off"                  # off | warn | gate
    # non-waived divergent rows / replayed rows beyond which `gate`
    # vetoes (strictly greater-than: 0.0 = any divergence vetoes)
    max_divergence_rate: float = 0.0
    # qualified rule names whose divergences never count toward the
    # gating rate (reported + counted separately)
    waivers: tuple = ()
    capacity: int = 2048               # recorder ring size
    sample_every: int = 1              # keep every k-th request
    replay_limit: int = 1024           # newest rows replayed per gate
    # below this many recorded rows the gate abstains (publishes with
    # a note): an empty corpus proves nothing
    min_rows: int = 1
    exemplars_per_rule: int = 4
    keep_reports: int = 8              # reports() history depth

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"canary mode must be one of {MODES}, "
                             f"got {self.mode!r}")


class CanaryRejected(RuntimeError):
    """Typed publish veto: the candidate snapshot flipped recorded
    live decisions beyond the configured threshold. Carries the diff
    report plus the candidate (snapshot, plan) so callers can re-derive
    evidence."""

    def __init__(self, message: str, report: CanaryReport,
                 candidate_snapshot: Any = None,
                 candidate_plan: Any = None):
        super().__init__(message)
        self.report = report
        self.candidate_snapshot = candidate_snapshot
        self.candidate_plan = candidate_plan


class ConfigCanary:
    """Record → shadow-replay → diff → gate, owned by the
    RuntimeServer and consulted by the Controller before every
    non-initial publish."""

    def __init__(self, config: CanaryConfig | None = None,
                 metrics: dict | None = None, strict: bool = False):
        self.config = config or CanaryConfig()
        # True on a CUDA server: a fault of the replay's device trip that
        # CHAOS did not inject raises out of gate() (module doc)
        self.strict = strict
        self.recorder = TrafficRecorder(
            capacity=self.config.capacity,
            sample_every=self.config.sample_every)
        self._metrics = metrics if metrics is not None else FAMILIES
        self._lock = threading.Lock()
        self._reports: collections.deque = collections.deque(
            maxlen=max(self.config.keep_reports, 1))
        self.evaluations = 0
        self.vetoes = 0
        # set by gate() when a DIVERGENT candidate is allowed through
        # (warn mode / sub-threshold / waived); consumed by
        # on_published() after the dispatcher swap
        self._rebaseline_on_publish = False

    # -- gate ----------------------------------------------------------

    def gate(self, active_dispatcher: Any, candidate_snapshot: Any,
             candidate_plan: Any,
             buckets: tuple[int, ...] = ()) -> CanaryRejected | None:
        """Evaluate the candidate against recorded traffic. Returns a
        `CanaryRejected` when the publish must be vetoed (mode=gate
        and divergence beyond threshold), else None (publish — the
        report, if any, is recorded either way). Raises only a strict
        canary's replay device fault (module doc)."""
        cfg = self.config
        if cfg.mode == "off":
            return None
        # fresh decision per evaluation: a flag left by a publish that
        # failed mid-rebuild must not wipe the ring on a later,
        # unrelated publish
        self._rebaseline_on_publish = False
        t0 = time.perf_counter()
        try:
            report = self._evaluate(active_dispatcher,
                                    candidate_snapshot,
                                    candidate_plan, buckets)
        except Exception as exc:
            if getattr(exc, "canary_strict", False):
                log.error("canary replay failed on the device (%s: %s); a "
                          "strict canary publishes nothing",
                          type(exc).__name__, exc)
                raise
            log.exception("canary evaluation failed; publishing "
                          "WITHOUT shadow validation (fail-open)")
            self._metrics["errors"].inc()
            return None
        finally:
            self._metrics["publish_delay_seconds"].observe(
                time.perf_counter() - t0)
        if report is None:     # abstained (no corpus / no plan)
            return None
        veto = (cfg.mode == "gate"
                and report.divergence_rate > cfg.max_divergence_rate)
        report.verdict = "veto" if veto else (
            "warn" if report.n_divergent else "publish")
        self._metrics["verdicts"].inc(1, verdict=report.verdict)
        self._record(report)
        if not veto:
            if report.n_divergent or report.n_waived:
                log.warning(
                    "canary: candidate rev %s diverges on %d/%d "
                    "recorded rows (+%d waived) (%s) — mode=%s, "
                    "publishing", report.candidate_revision,
                    report.n_divergent, report.n_rows,
                    report.n_waived, report.diverging_rules()[:5],
                    cfg.mode)
                # a DIVERGENT candidate is about to become the live
                # config: rows recorded under the old one now claim
                # decisions the new config legitimately changed, and
                # keeping them would re-report the accepted divergence
                # against every later candidate (an identical swap
                # must stay zero-divergence). Re-baseline — but only
                # AFTER the dispatcher swap (on_published): the old
                # dispatcher keeps tapping old-config rows until then,
                # and clearing here would let them survive the clear.
                self._rebaseline_on_publish = True
            return None
        self.vetoes += 1
        top = report.diverging_rules()
        msg = (f"canary veto: candidate config rev "
               f"{report.candidate_revision} flips "
               f"{report.n_divergent}/{report.n_rows} recorded live "
               f"decisions (rate {report.divergence_rate:.4f} > "
               f"{cfg.max_divergence_rate}) — diverging rules: "
               f"{', '.join(top[:5]) or '(none attributed)'}")
        return CanaryRejected(msg, report,
                              candidate_snapshot=candidate_snapshot,
                              candidate_plan=candidate_plan)

    def _evaluate(self, active_dispatcher, candidate_snapshot,
                  candidate_plan, buckets) -> CanaryReport | None:
        cfg = self.config
        self.evaluations += 1
        entries = self.recorder.corpus(limit=cfg.replay_limit)
        # ring OCCUPANCY, not the limit-capped replay subset — the
        # gauge's help text promises the former
        self._metrics["recorder_entries"].set(
            self.recorder.stats()["entries"])
        if len(entries) < cfg.min_rows:
            log.info("canary: %d recorded rows < min_rows=%d — "
                     "abstaining", len(entries), cfg.min_rows)
            return None
        identity = getattr(active_dispatcher, "identity_attr",
                           "destination.service")
        if candidate_plan is not None:
            try:
                replay = replay_entries(candidate_snapshot,
                                        candidate_plan, entries,
                                        buckets=buckets,
                                        identity_attr=identity)
            except Exception as exc:
                # the device trip failed: strict → raise out of gate()
                if self.strict and not chaos_injected(exc):
                    exc.canary_strict = True
                raise
        elif not getattr(candidate_snapshot, "rules", ()):
            # a RULE WIPE compiles to no plan at all — the most
            # catastrophic swap must not bypass the gate. Zero rules
            # means every check answers OK: diff against the shared
            # synthetic allow-everything replay (the rule-less baseline
            # the reference's admission hook shares) so recorded denies
            # register as status flips.
            from istio_tpu_torch.canary.replay import \
                allow_everything_replay
            replay = allow_everything_replay(len(entries))
        else:
            # rules exist but no plan (non-fused server / plan-build
            # failure): shadow replay is device-side — abstain
            log.info("canary: candidate has no fused plan — "
                     "abstaining (shadow replay is device-side)")
            return None
        self._metrics["replays"].inc()
        self._metrics["rows"].inc(replay.n_rows)
        self._metrics["replay_seconds"].observe(replay.wall_s)
        report = diff_decisions(
            entries, replay, waivers=cfg.waivers,
            exemplars_per_rule=cfg.exemplars_per_rule)
        report.mode = cfg.mode
        report.threshold = cfg.max_divergence_rate
        report.candidate_revision = getattr(candidate_snapshot,
                                            "revision", None)
        for kind, n in report.by_kind.items():
            self._metrics["divergences"].inc(n, kind=kind)
        self._metrics["rate"].set(report.divergence_rate)
        if report.n_divergent and active_dispatcher is not None:
            try:
                confirm_exemplars(
                    report,
                    active_dispatcher.snapshot,
                    active_dispatcher.fused,
                    candidate_snapshot, candidate_plan,
                    identity_attr=identity)
            except Exception:
                log.exception("canary exemplar oracle confirm failed")
        return report

    def on_published(self, dispatcher: Any = None) -> None:
        """Controller hook, called right AFTER the atomic dispatcher
        swap: when the published candidate was divergent, re-baseline
        the recorder — rows recorded under the superseded config claim
        decisions the new config legitimately changed, and replaying
        them would re-report the accepted divergence against every
        later candidate. Cleared post-swap so the old dispatcher's
        final taps land before the wipe (batches already in flight on
        it may still tap a stale row afterwards — a bounded, self-
        healing residue, same in-flight grace the rulestats retire
        sweep covers). Never raises."""
        if not self._rebaseline_on_publish:
            return
        self._rebaseline_on_publish = False
        try:
            self.recorder.clear()
            log.info("canary: recorder re-baselined after divergent "
                     "publish")
        except Exception:
            log.exception("canary recorder re-baseline failed")

    # -- views ---------------------------------------------------------

    def _record(self, report: CanaryReport) -> None:
        with self._lock:
            self._reports.append(report)

    def reports(self) -> list[CanaryReport]:
        with self._lock:
            return list(self._reports)

    def snapshot(self) -> dict:
        """JSON-able /debug/canary payload (the view itself waits for
        the introspect plane)."""
        with self._lock:
            reports = [r.to_dict() for r in self._reports]
        return {
            "mode": self.config.mode,
            "max_divergence_rate": self.config.max_divergence_rate,
            "waivers": list(self.config.waivers),
            "replay_limit": self.config.replay_limit,
            "evaluations": self.evaluations,
            "vetoes": self.vetoes,
            "recorder": self.recorder.stats(),
            "reports": reports,
        }
