"""Shadow replay: drive a recorded corpus through a candidate plan.

Port of istio_tpu/canary/replay.py. The replay path is the REAL serving
path — a `Dispatcher` built over
the candidate snapshot + `FusedPlan` — run in observe-off mode: no
stage histograms, no live-p99 window, no rule-telemetry folds, no
chaos seam, no recorder tap (the canary must never pollute the
metrics it is judged against, and a candidate's telemetry must start
clean when it publishes). Handlers are deliberately EMPTY: host
overlay adapter calls have side effects (quota consumption, exporter
writes) a shadow replay must not cause, so the decision surface
compared is the device-decidable one — fused deny/list/rbac statuses,
TTL/use-count folds, host-fallback predicates (oracle-patched, pure)
and quota-rule activity bits. Recorded decisions come off the same
surface, so identical semantics replay to identical decisions.

Batches chunk and pad to the serving buckets, so a replay runs the
shapes live traffic runs. On the card that is one fused trip a chunk:
rule_match, the dfa_lits / byte_lits launches of the subject groups,
verdict_fold (with list_banks on list worlds) and check_pack, and no
rule_stats launch (observe off).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Sequence

from istio_tpu_torch.canary.recorder import CanaryEntry


@dataclasses.dataclass
class ReplayResult:
    """Per-row candidate decisions for one corpus replay."""
    status: list[int]
    valid_duration_s: list[float]
    valid_use_count: list[int]
    deny_rule: list[str]           # qualified names; "" = no deny
    quota_rules: list[tuple]       # qualified QUOTA-rule names per row
    n_rows: int = 0
    wall_s: float = 0.0

    @property
    def rows_per_s(self) -> float:
        return self.n_rows / self.wall_s if self.wall_s > 0 else 0.0


def allow_everything_replay(n: int) -> ReplayResult:
    """The synthetic replay of a RULE-LESS snapshot: every check
    answers OK at the CheckResponse default TTL/use-count caps.
    The controller gate diffs a rule wipe against it (the reference's
    admission webhook shares it) — recorded denies register as status
    flips instead of bypassing the diff."""
    from istio_tpu_torch.runtime.dispatcher import CheckResponse

    ok = CheckResponse()
    return ReplayResult(
        status=[0] * n,
        valid_duration_s=[ok.valid_duration_s] * n,
        valid_use_count=[ok.valid_use_count] * n,
        deny_rule=[""] * n, quota_rules=[()] * n,
        n_rows=n, wall_s=0.0)


def replay_entries(snapshot: Any, plan: Any,
                   entries: Sequence[CanaryEntry],
                   buckets: tuple[int, ...] = (),
                   identity_attr: str | None = None) -> ReplayResult:
    """Batch-replay `entries` through `plan` on its device →
    ReplayResult aligned index-for-index with `entries`. `buckets`
    should be the serving bucket shapes; empty buckets replay at the
    corpus' own chunk shape (tests, offline replay)."""
    from istio_tpu_torch.runtime.batcher import pad_to_bucket
    from istio_tpu_torch.runtime.dispatcher import (DEFAULT_IDENTITY_ATTR,
                                                    Dispatcher)

    if plan is None:
        raise ValueError("shadow replay requires a fused plan "
                         "(candidate snapshot compiled with fused=True)")
    buckets = tuple(sorted(buckets))
    d = Dispatcher(snapshot, {},
                   identity_attr or DEFAULT_IDENTITY_ATTR,
                   fused=plan, buckets=buckets, observe=False)
    names = snapshot.qualified_rule_names()
    out = ReplayResult(status=[], valid_duration_s=[],
                       valid_use_count=[], deny_rule=[],
                       quota_rules=[])
    bags = [e.bag() for e in entries]
    cap = buckets[-1] if buckets else (len(bags) or 1)
    t0 = time.perf_counter()
    for lo in range(0, len(bags), cap):
        chunk = bags[lo:lo + cap]
        padded = pad_to_bucket(chunk, buckets) if buckets else chunk
        responses = d.check(padded)
        for resp in responses[:len(chunk)]:
            out.status.append(int(resp.status_code))
            out.valid_duration_s.append(float(resp.valid_duration_s))
            out.valid_use_count.append(int(resp.valid_use_count))
            ridx = getattr(resp, "deny_rule", -1)
            out.deny_rule.append(
                names[ridx] if 0 <= ridx < len(names) else "")
            out.quota_rules.append(tuple(
                names[r] for r in (resp.active_quota_rules or ())
                if 0 <= r < len(names)))
    out.n_rows = len(bags)
    out.wall_s = time.perf_counter() - t0
    return out
