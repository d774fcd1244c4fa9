"""Runtime server assembly: store → controller → dispatcher → batchers.

Port of the check and report paths of istio_tpu/runtime/server.py
(reference: mixer/pkg/server/server.go:92 newServer). `RuntimeServer`
is the in-process core the wire fronts wrap and what the tests and
chip_smoke.py drive directly: `check(bag)` coalesces through the
CheckBatcher, `check_many(bags)` serves a pre-formed batch (both ride
the ResilientChecker: one retry of a failed device trip, a circuit
breaker that routes whole batches to the host SnapshotOracle, and the
fail policy when both paths fail; runtime/resilience.py; on a CUDA
device only faults injected through CHAOS take that chain, and any
other device fault is raised to the caller), and
`report(bags)` / `submit_report(bags)` coalesce report records across
calls through a second CheckBatcher (the report coalescer) into shared
packed report trips, with every record counted accepted and then
exported or typed-rejected (monitor.report_conservation). Quota() has
the reference's three entries: `quota_fused` allocates through the
device quota pools on a check's activity bits (one quota_alloc launch
per pool batch window), `check_batch_quota_instep` (with
`quota_in_step`) allocates inside the check trip itself, and `quota` is
the host path through the adapter. Every entry runs the APA phase
(`preprocess`, one resolve trip per bag) first when the config has an
ATTRIBUTE_GENERATOR rule. It takes one argument the reference lacks,
`device` ("cuda" by default; tests pass "cpu", where every kernel
wrapper runs its plain version).

With `host_executor` (the default, as in the reference) the server owns
an AdapterExecutor (runtime/executor.py): the fused path's host-overlay
CHECK actions and quota()'s adapter calls run on per-handler lanes with
their own workers, queue cap and circuit breaker, bounded by the batch's
deadline (and `host_action_timeout_ms`); an action that does not
resolve answers `host_fail_policy`'s verdict, an adapter exception gets
one retry and then the inline path's INTERNAL; and list providers
refresh on its maintenance lane. `host_executor=False` runs host actions
inline, the reference's behavioural oracle. quota() takes
`default_check_deadline_ms` as its deadline when the caller gives none.
`check_grants` min-folds every check response's TTL and use count with
a GrantPolicy's grant (runtime/grants.py), revoked at each publish.

`mesh_shape=(dp, mp)` serves every batch through the dp × mp sharded
engine step (parallel/mesh.py) over `platform.devices()`: the physical
cards, or the virtual devices `platform.force_virtual_devices` made.
`canary` ("off" by default; "warn" or "gate") builds a ConfigCanary
(canary/gate.py) from the six `canary*` fields: every served fused batch
taps its recorder, and every config rebuild replays the recorded
traffic through the candidate plan before the publish; "gate" vetoes a
candidate whose divergence rate exceeds `canary_max_divergence`. On a
CUDA device the canary is strict: a fault of the replay's device trip
raises out of the rebuild with nothing published, where the reference
fails open.

`shards` / `replicas` serve checks through the sharded serving plane
(sharding/): `self.batcher` becomes a ReplicaRouter of `replicas`
CheckBatcher lanes (each router on its own CUDA stream on a card), the
published snapshot's rules are compiled into `shards` namespace banks
(or, with `shards=0` or a snapshot that cannot shard, one full plan a
lane), `check_many` routes through the first lane's router, and every
publish rebuilds the banks, delta-compiled by content key when
`delta_compile` is on (`_rebuild_sharded`; the records `_sharded` and
`_rebuild_status`). The parent plan is then never warmed and never runs
a trip; each bank has its own ResilientChecker (`bank:<k>`, strict on a
card), and in-step quota is refused.

The tail-latency forensics plane (runtime/forensics.py) is armed from
the six forensics fields before the controller's first publish: the
process-wide flight recorder (`flight_recorder`, `slow_threshold_ms`,
`slow_adaptive`, `slow_ring_capacity`) and event timeline
(`event_ring_capacity`). `check_many` and `check_batch_quota_instep` open
the recorder's tape on the caller's thread around their batch (the
batchers open it on their worker threads), a sharded rebuild records a
`bank_rebuild` event and `shutdown` a `shutdown` event.
`capture_profile(seconds)` runs one torch.profiler capture into
`profile_dir` (None → a fresh temporary directory).

The mesh audit plane (runtime/audit.py, `audit` and its three fields) is
created last in the constructor and started: a `mesh-audit` thread
evaluating the six invariants every `audit_interval_s`. `shutdown` stops
it first. `audit=False` leaves `self.audit` None. Callers hand
`self.audit.snapshot()` to `slo.scorecard(..., audit=)`.

`ServerArgs` keeps the reference's field names and defaults. The fields
the port does not carry (overlap_h2d, mTLS, the XLA compile cache) are
accepted at their defaults, where the planes behind
them simply do not run, and raise NotPorted when set to anything else.

On a CUDA device the constructor builds every kernel of
`kernels.KERNELS` before anything else: a failed nvcc raises out of the
constructor and never reaches a batch as a device error that the
oracle fallback would answer. A kernel that fails to load or launch
later raises from its batch: the card's ResilientChecker is strict.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from istio_tpu_torch.adapters.sdk import QuotaArgs, QuotaResult
from istio_tpu_torch.attribute.bag import Bag
from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.device import NotPorted, resolve_device
from istio_tpu_torch.expr.oracle import EvalError
from istio_tpu_torch.models.policy_engine import INTERNAL
from istio_tpu_torch.runtime import forensics, monitor
from istio_tpu_torch.runtime.batcher import CheckBatcher, default_buckets
from istio_tpu_torch.runtime.controller import Controller
from istio_tpu_torch.runtime.dispatcher import (CheckResponse,
                                                DEFAULT_IDENTITY_ATTR)
from istio_tpu_torch.runtime.resilience import (ResilienceConfig,
                                                ResilientChecker)
from istio_tpu_torch.runtime.rulestats import (RuleStatsAggregator,
                                               RuleStatsDrainer)
from istio_tpu_torch.runtime.store import Store
from istio_tpu_torch.utils.log import scope

log = scope("runtime.server")


@dataclasses.dataclass
class ServerArgs:
    """mixer/pkg/server/args.go:32 analog (the reference's fields)."""
    # -- carried by this slice ----------------------------------------
    identity_attr: str = DEFAULT_IDENTITY_ATTR
    default_manifest: Mapping[str, ValueType] | None = None
    batch_window_s: float = 0.0003
    max_batch: int = 1024
    # in-flight device batches (runtime/batcher.py)
    pipeline: int = 4
    # occupancy threshold of the batcher's adaptive window (None → 1)
    hold_at: int | None = None
    # serving batch shapes (None → batcher.default_buckets(max_batch))
    buckets: tuple[int, ...] | None = None
    # False skips the first build's prewarm
    initial_prewarm: bool = True
    max_str_len: int | None = None
    preprocess: bool = True
    # serve checks through the fused device engine; False = the generic
    # host-adapter dispatch path
    fused: bool = True
    # check batcher queue cap (None → 8×max_batch; 0 → unbounded)
    check_queue_cap: int | None = None
    # fold per-rule hit/deny/err counts in the fused check step
    rule_telemetry: bool = True
    # interval of the rule-stats drainer thread; 0 disables it (drains
    # then happen only on demand: rulestats.drain(), tests)
    rulestats_drain_s: float = 0.5
    # coalesce report records across report() calls into shared device
    # trips; False dispatches each call's records inline
    report_batching: bool = True
    # report coalescer queue cap (None → 16×max_batch)
    report_queue_cap: int | None = None
    # allocate quota inside the check trip when the live snapshot is
    # eligible (RuntimeServer.instep_quota_target)
    quota_in_step: bool = False
    # -- overload resilience (runtime/resilience.py and the batcher's
    #    admission control) ---------------------------------------------
    # shed the NEWEST check submits while the live p99 is over the SLO
    # target and the queue is half full
    brownout: bool = False
    # what Check() answers when the device AND the oracle fallback
    # fail: "open" → OK with a 1 s / 1-use TTL, "closed" → UNAVAILABLE
    check_fail_policy: str = "closed"
    # consecutive failed device batches that trip the breaker, and how
    # long it stays open before a half-open probe
    breaker_failures: int = 3
    breaker_reset_s: float = 5.0
    # retry a failed device trip once before it counts as a failure
    device_retry: bool = True
    # the check batcher dispatches the moment an in-flight slot under
    # continuous_depth frees (never waits for a window or a fill)
    continuous_batching: bool = False
    continuous_depth: int = 2
    # quota()'s deadline when the caller passes none (ms; 0 = none)
    default_check_deadline_ms: float = 0.0
    # -- the adapter-executor plane (runtime/executor.py) --------------
    # run host adapter work (the fused path's overlay CHECK actions,
    # quota() adapter calls, provider refresh) on the executor; False =
    # the inline loop (the behavioural oracle)
    host_executor: bool = True
    # worker threads and pending-action cap per handler lane
    executor_workers: int = 2
    executor_queue_cap: int = 256
    # what an unresolvable host action answers: "open" → OK with a
    # 1 s / 1-use TTL, "closed" → UNAVAILABLE
    host_fail_policy: str = "closed"
    # a bound on every host action even without a request deadline (ms;
    # 0 = the request's deadline only)
    host_action_timeout_ms: float = 0.0
    # per-lane breaker: consecutive failed or overrun actions that trip
    # it, and the open window before a half-open probe
    host_breaker_failures: int = 3
    host_breaker_reset_s: float = 5.0
    # -- check-cache grants (runtime/grants.py) -------------------------
    check_grants: bool = False
    grant_ttl_floor_s: float = 1.0
    grant_ttl_cap_s: float = 5.0
    grant_ttl_ramp_per_s: float = 0.5
    # -- config canary (canary/) ----------------------------------------
    # shadow-replay recorded live Check() traffic through every rebuilt
    # snapshot before the atomic publish: "off" disables the recorder
    # and the replay; "warn" replays and records the diff report but
    # always publishes; "gate" VETOES a publish whose divergence rate
    # exceeds canary_max_divergence (the old dispatcher keeps serving;
    # Controller.last_canary_rejection holds the CanaryRejected)
    canary: str = "off"
    # recorder sampling ring: capacity bounds memory, sample_every=k
    # keeps every k-th request (uniform stride across batches)
    canary_capacity: int = 2048
    canary_sample_every: int = 1
    # newest recorded rows replayed per candidate evaluation
    canary_replay_limit: int = 1024
    # non-waived divergent rows / replayed rows beyond which "gate"
    # vetoes (strictly greater-than; 0.0 = any divergence vetoes)
    canary_max_divergence: float = 0.0
    # qualified rule names ("ns/name") whose divergences are reported
    # but never gate
    canary_waivers: tuple = ()
    # -- the sharded serving plane (sharding/) --------------------------
    # >0: partition the snapshot's rules by namespace into this many
    # banks (each its own compiled RuleSetProgram + FusedPlan) and serve
    # checks through the shard-routed path — verdict-identical to the
    # monolithic compile, which is then never warmed and never runs a
    # device trip. 0 = monolithic serving (the default).
    shards: int = 0
    # serving lanes behind the one front: each lane is its own
    # CheckBatcher + router, on its own CUDA stream on a card
    # (sticky-by-namespace routing). With shards=0 each replica owns its
    # own FusedPlan over the full snapshot (lane 0 the published one);
    # with shards>0 the banks are shared. 1 = single lane.
    replicas: int = 1
    # True: config republishes under sharding diff the new snapshot
    # against the live plan by content hash and rebuild ONLY the banks
    # whose namespaces (or the replicated global set) changed; untouched
    # banks carry across generations with their warmed shapes, breaker
    # and rulestats bindings. False rebuilds every bank on every publish.
    delta_compile: bool = True
    # namespaces the delta planner may RELOCATE per republish to chase
    # LPT balance — each move recompiles two banks (0 = perfect plan
    # stability, the default; sharding/planner.plan_shards)
    shard_rebalance_budget: int = 0
    # dp × mp mesh serving over platform.devices() (parallel/mesh.py)
    mesh_shape: tuple[int, int] | None = None
    # -- tail-latency forensics (runtime/forensics.py) ------------------
    # the per-batch flight recorder: a batch whose slowest request's e2e
    # exceeds the threshold captures its stage timeline (and the
    # overlapping control-plane events) into a bounded ring. The fast
    # path is one threshold compare a batch
    flight_recorder: bool = True
    # capture threshold in ms; 0 = the live SLO target
    # (monitor.CHECK_P99_TARGET_MS: "slow" means "over the p99 budget")
    slow_threshold_ms: float = 0.0
    # adaptive mode: the threshold tracks max(base, live window p99),
    # re-read at scrape rate (only the outliers above the current regime
    # are exemplars)
    slow_adaptive: bool = False
    # bounded ring capacities (overflow is typed:
    # monitor.FORENSICS_DROPPED by ring)
    slow_ring_capacity: int = 256
    event_ring_capacity: int = 512
    # torch.profiler capture directory of capture_profile (None → a
    # fresh temporary directory a capture)
    profile_dir: str | None = None
    # -- mesh audit plane (runtime/audit.py) ---------------------------
    # the background invariant auditor: report / check / quota
    # conservation, grant coherence, plane agreement, routing
    # conservation, and the fault-explainability scorer. Violations
    # record audit_violation events, bump mixer_audit_* and flip the
    # mixer_audit_healthy gauge. The quota pools' counter planes are
    # pulled every audit_quota_every-th evaluation (the one audit read
    # that touches the card)
    audit: bool = True
    audit_interval_s: float = 0.5
    audit_quota_every: int = 8
    # how long an injection may stay unexplained before it expires
    audit_explain_window_s: float = 10.0
    # -- not carried: accepted at these defaults only -----------------
    jax_compile_cache_dir: str | None = None
    overlap_h2d: bool | None = None
    mtls: str = "off"
    mtls_identity: str = ""
    mtls_cert_ttl_minutes: int = 60
    mtls_rotation_fraction: float = 0.5


# fields RuntimeServer reads; every other field must keep its default
CARRIED_ARGS = frozenset({
    "identity_attr", "default_manifest", "batch_window_s", "max_batch",
    "pipeline", "hold_at", "buckets", "initial_prewarm", "max_str_len",
    "preprocess", "fused", "check_queue_cap", "rule_telemetry",
    "rulestats_drain_s", "host_executor", "report_batching",
    "report_queue_cap", "quota_in_step", "mesh_shape",
    "brownout", "check_fail_policy",
    "breaker_failures", "breaker_reset_s", "device_retry",
    "continuous_batching", "continuous_depth",
    "executor_workers", "executor_queue_cap", "host_fail_policy",
    "host_action_timeout_ms", "host_breaker_failures",
    "host_breaker_reset_s", "default_check_deadline_ms", "check_grants",
    "grant_ttl_floor_s", "grant_ttl_cap_s", "grant_ttl_ramp_per_s",
    "canary", "canary_capacity", "canary_sample_every",
    "canary_replay_limit", "canary_max_divergence", "canary_waivers",
    "shards", "replicas", "delta_compile", "shard_rebalance_budget",
    "flight_recorder", "slow_threshold_ms", "slow_adaptive",
    "slow_ring_capacity", "event_ring_capacity", "profile_dir",
    "audit", "audit_interval_s", "audit_quota_every",
    "audit_explain_window_s"})


def _check_carried(args: ServerArgs) -> None:
    for f in dataclasses.fields(ServerArgs):
        if f.name in CARRIED_ARGS:
            continue
        if getattr(args, f.name) != f.default:
            raise NotPorted(f"ServerArgs.{f.name}={getattr(args, f.name)!r}")


class RuntimeServer:
    def __init__(self, store: Store, args: ServerArgs | None = None,
                 device: str | torch.device = "cuda"):
        self.args = args or ServerArgs()
        _check_carried(self.args)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every kernel is built before the breaker exists: a build
            # failure raises here, never as a batch's device error
            from istio_tpu_torch import kernels
            kernels.build()
        if self.args.check_fail_policy not in ("open", "closed"):
            raise ValueError(
                f"check_fail_policy must be 'open' or 'closed', got "
                f"{self.args.check_fail_policy!r}")
        # the sharded serving plane (sharding/): when shards or extra
        # replicas are requested the check path serves through
        # namespace-sharded banks / replica lanes and the parent
        # monolithic plan stays un-warmed (metadata + oracle only)
        if self.args.shards < 0 or self.args.replicas < 1:
            raise ValueError(
                f"shards must be >= 0 and replicas >= 1, got "
                f"shards={self.args.shards} "
                f"replicas={self.args.replicas}")
        self._sharded_serving = (self.args.shards > 0
                                 or self.args.replicas > 1)
        if self._sharded_serving and not self.args.fused:
            raise ValueError("sharded/replica serving requires "
                             "fused=True")
        if self._sharded_serving and self.args.mesh_shape is not None:
            raise ValueError("sharded serving and mesh_shape are "
                             "mutually exclusive (banks own their "
                             "device leases)")
        # the published sharded generation (plan, banks, content keys,
        # mode, delta attribution) and the delta-compilation rebuild
        # ledger, zero-shaped before the first sharded publish: per-
        # generation and cumulative reused-vs-recompiled bank counts, the
        # last rebuild wall, and the last rebuild ERROR with the
        # generation it struck
        self._sharded: dict | None = None
        self._rebuild_status: dict = {
            "rebuilds": 0,
            "banks_reused": 0,
            "banks_recompiled": 0,
            "banks_reused_total": 0,
            "banks_recompiled_total": 0,
            "last_wall_s": 0.0,
            "revision": 0,
            "errors": 0,
            "last_error": None,
            "last_error_revision": None,
        }
        # each bank's circuit breaker by shard id, kept across swaps
        self._bank_breakers: dict = {}
        self._replica_router = None
        # tail-latency forensics: arm the process-wide flight recorder and
        # event ring BEFORE the controller's first publish, so the first
        # generation's events (publish, prewarm) land on the timeline
        forensics.RECORDER.configure(
            enabled=self.args.flight_recorder,
            threshold_ms=self.args.slow_threshold_ms,
            adaptive=self.args.slow_adaptive,
            capacity=self.args.slow_ring_capacity)
        forensics.EVENTS.configure(capacity=self.args.event_ring_capacity)
        manifest = self.args.default_manifest
        if manifest is None:
            manifest = GLOBAL_MANIFEST
        buckets = tuple(sorted(self.args.buckets)) if self.args.buckets \
            else default_buckets(self.args.max_batch)
        self._buckets = buckets
        mesh = None
        if self.args.mesh_shape is not None:
            if not self.args.fused:
                raise ValueError("mesh serving requires fused=True")
            from istio_tpu_torch.parallel.mesh import MeshSpec
            dp, mp = self.args.mesh_shape
            bad = [b for b in buckets if b % dp]
            if bad:
                raise ValueError(
                    f"serving buckets {bad} not divisible by dp={dp}")
            mesh = MeshSpec(dp=dp, mp=mp).build()
        # rule-level telemetry: the aggregator follows every publish
        # (draining the outgoing plan first); the drainer empties the
        # device accumulators on an interval so they never wrap
        self.rulestats = RuleStatsAggregator()
        # config canary: built before the controller so the very first
        # dispatcher already carries the recorder tap — the gate itself
        # only engages from the second rebuild on. Strict on the card: a
        # replay device fault fails the publish instead of failing open
        self.canary = None
        if self.args.canary != "off":
            from istio_tpu_torch.canary import CanaryConfig, ConfigCanary
            self.canary = ConfigCanary(CanaryConfig(
                mode=self.args.canary,
                max_divergence_rate=self.args.canary_max_divergence,
                waivers=tuple(self.args.canary_waivers),
                capacity=self.args.canary_capacity,
                sample_every=self.args.canary_sample_every,
                replay_limit=self.args.canary_replay_limit),
                strict=self.device.type == "cuda")
        # the adapter-executor plane and the grant policy are built
        # before the controller, so the first publish's dispatcher
        # already has them; lanes and breakers outlive config swaps
        self.executor = None
        if self.args.host_executor:
            from istio_tpu_torch.runtime.executor import (AdapterExecutor,
                                                          ExecutorConfig)
            self.executor = AdapterExecutor(ExecutorConfig(
                workers=self.args.executor_workers,
                queue_cap=self.args.executor_queue_cap,
                fail_policy=self.args.host_fail_policy,
                action_timeout_s=self.args.host_action_timeout_ms / 1e3,
                breaker_failures=self.args.host_breaker_failures,
                breaker_reset_s=self.args.host_breaker_reset_s))
        self.grants = None
        if self.args.check_grants:
            from istio_tpu_torch.runtime.grants import GrantPolicy
            self.grants = GrantPolicy(
                ttl_floor_s=self.args.grant_ttl_floor_s,
                ttl_cap_s=self.args.grant_ttl_cap_s,
                ttl_ramp_per_s=self.args.grant_ttl_ramp_per_s)
        try:
            self.controller = Controller(
                store, default_manifest=manifest,
                identity_attr=self.args.identity_attr,
                max_str_len=self.args.max_str_len,
                on_publish=self._on_config_publish,
                fused=self.args.fused,
                prewarm_buckets=buckets,
                mesh=mesh,
                rule_telemetry=self.args.rule_telemetry,
                initial_prewarm=self.args.initial_prewarm,
                prewarm_hook=self._prewarm_instep_for,
                canary=self.canary,
                warm_parent_plans=not self._sharded_serving,
                executor=self.executor,
                grants=self.grants,
                device=self.device)
        except BaseException:
            if self.executor is not None:
                self.executor.close()
            raise
        self._rulestats_drainer = RuleStatsDrainer(
            self.rulestats, self.args.rulestats_drain_s) \
            if (self.args.rule_telemetry
                and self.args.rulestats_drain_s > 0) else None
        # the resilience layer in front of the device trip: retry, the
        # circuit breaker with its CPU-oracle fallback, the fail policy.
        # On the card it is strict: a device fault that CHAOS did not
        # inject raises to the caller and is never answered by the host
        self.resilience = ResilientChecker(
            device=self._run_check_batch_device,
            oracle=self._run_check_batch_oracle,
            config=ResilienceConfig(
                fail_policy=self.args.check_fail_policy,
                breaker_failures=self.args.breaker_failures,
                breaker_reset_s=self.args.breaker_reset_s,
                retry=self.args.device_retry),
            strict_device=self.device.type == "cuda")
        cap = self.args.check_queue_cap
        max_queue = 8 * self.args.max_batch if cap is None else cap
        batcher_kw = dict(window_s=self.args.batch_window_s,
                          max_batch=self.args.max_batch,
                          pipeline=self.args.pipeline,
                          buckets=buckets,
                          hold_at=self.args.hold_at,
                          max_queue=max_queue,
                          brownout=self.args.brownout,
                          continuous=self.args.continuous_batching,
                          continuous_depth=self.args.continuous_depth)
        if self._sharded_serving:
            # N CheckBatcher lanes behind the one front attribute; each
            # lane's admission control (cap, deadline, brownout) is the
            # same CheckBatcher machinery, per lane
            from istio_tpu_torch.sharding import ReplicaRouter
            self._replica_router = ReplicaRouter(
                self.args.replicas, self.args.identity_attr, batcher_kw)
            self.batcher = self._replica_router
            # the controller's initial publish fired before the router
            # existed — build the first generation's banks now
            try:
                self._rebuild_sharded(self.controller.dispatcher)
            except BaseException:
                self._replica_router.close()
                if self._rulestats_drainer is not None:
                    self._rulestats_drainer.close()
                if self.executor is not None:
                    self.executor.close()
                self.controller.close()
                raise
        else:
            self.batcher = CheckBatcher(self._run_check_batch, **batcher_kw)
        # the REPORT coalescer: records from concurrent report() calls
        # share packed device trips. Its own instance, so report trips
        # are counted apart and the two queues cannot starve each
        # other's windows; the fused report resolve pads per chunk
        # itself, and report batches feed the report stages, not the
        # Check() ones. Bounded: an overflow sheds a typed
        # RESOURCE_EXHAUSTED.
        rcap = self.args.report_queue_cap
        self._report_batcher = CheckBatcher(
            self._run_report_batch,
            window_s=self.args.batch_window_s,
            max_batch=self.args.max_batch,
            pipeline=self.args.pipeline,
            buckets=buckets,
            hold_at=self.args.hold_at,
            size_hist=monitor.REPORT_BATCH_SIZE,
            pad_batches=False,
            observe_latency=False,
            stage_observer=lambda w: monitor.observe_report_stage(
                "coalesce_wait", w),
            max_queue=16 * self.args.max_batch if rcap is None
            else rcap) if self.args.report_batching else None
        # the mesh audit plane, created LAST so every surface it reads
        # (controller, batchers, grants, routers) already exists; it
        # reads snapshots and ledgers only, off the hot path
        self.audit = None
        if self.args.audit:
            from istio_tpu_torch.runtime.audit import AuditPlane
            self.audit = AuditPlane(
                self,
                interval_s=self.args.audit_interval_s,
                explain_window_s=self.args.audit_explain_window_s,
                quota_every=self.args.audit_quota_every)
            self.audit.start()

    def _on_config_publish(self, dispatcher) -> None:
        """Controller publish hook: rebind the rule-stats aggregator to
        the new snapshot, and register the published handlers' provider
        refreshes on the executor's maintenance lane. Neither ever fails
        a publish."""
        try:
            self.rulestats.attach(dispatcher)
        except Exception:
            log.exception("rulestats attach failed")
        if self.executor is not None:
            try:
                self.executor.register_refreshables(dispatcher.handlers)
            except Exception:
                log.exception("refreshable registration failed")
        # the sharded serving plane: rebuild the shard banks / replica
        # lanes for the freshly published snapshot and swap every lane
        # atomically (set_routers) — old banks keep serving while the
        # new generation compiles. A bank build error keeps the previous
        # generation serving and is recorded in the rebuild ledger
        # instead of killing the publish
        if self._replica_router is not None:
            try:
                self._rebuild_sharded(dispatcher)
            except Exception as exc:
                # conservative revoke: a failed rebuild left grant
                # state un-attributed — shortening budgets is always
                # safe, a stale long grant is not
                if self.grants is not None:
                    self.grants.on_publish(None)
                st = self._rebuild_status
                st["errors"] += 1
                st["last_error"] = f"{type(exc).__name__}: {exc}"
                st["last_error_revision"] = dispatcher.snapshot.revision
                log.exception("sharded serving rebuild failed for "
                              "generation %d; previous generation keeps "
                              "serving", dispatcher.snapshot.revision)

    def _rebuild_sharded(self, dispatcher) -> None:
        """Build the sharded serving generation for a published
        dispatcher and fan it across every surface coherently: plan
        (delta-stable against the live plan) → DIFF by bank content
        hash → compile only the banks whose namespaces (or the
        replicated global set) changed, carrying every untouched bank —
        warmed shapes, breaker state, rulestats bindings — across the
        generation (off-path; the previous generation keeps serving),
        warm the NEW banks' serving shapes, swap all replica lanes with
        one atomic set_routers, rebind the rulestats aggregator to the
        bank dispatchers (name-keyed counts merge globally), and record
        the plan decision + the reused-vs-recompiled ledger. The canary
        recorder taps the bank dispatchers the same way it taps a
        monolithic one — bank-local rule indices resolve through the
        bank's own qualified_rule_names, which are the global names."""
        from istio_tpu_torch.sharding import (ShardRouter,
                                              bank_content_key,
                                              compile_shard_bank,
                                              snapshot_static_digest)
        from istio_tpu_torch.sharding.banks import (ShardingUnsupported,
                                                    full_bank)
        from istio_tpu_torch.sharding.planner import (costs_from_ruleset,
                                                      plan_shards,
                                                      trivial_plan)

        router = self._replica_router
        snap = dispatcher.snapshot
        recorder = self.canary.recorder if self.canary is not None \
            else None
        buckets = self.controller.prewarm_buckets
        bank_kw = dict(identity_attr=self.args.identity_attr,
                       buckets=buckets,
                       rule_telemetry=self.args.rule_telemetry,
                       recorder=recorder, executor=self.executor,
                       grants=self.grants)
        t0 = time.perf_counter()
        n_lanes = router.n_replicas
        reason = ""
        bank_keys: list[str] = []
        reused_ids: list[int] = []

        def replica_lanes():
            # each lane owns its own FusedPlan over the full snapshot
            # (lane 0 rides the published dispatcher)
            plan = trivial_plan(n_lanes)
            banks = [full_bank(snap, dispatcher.handlers, i,
                               dispatcher=dispatcher if i == 0 else None,
                               **bank_kw)
                     for i in range(n_lanes)]
            # no delta attribution: conservative global revoke, same as
            # monolithic
            if self.grants is not None:
                self.grants.on_publish(None)
            routers = [ShardRouter({s: banks[i]
                                    for s in range(plan.n_shards)},
                                   plan, self.args.identity_attr,
                                   replica=i)
                       for i in range(n_lanes)]
            return plan, banks, routers

        if self.args.shards > 0:
            try:
                preds = snap.ruleset.rules[:snap.n_config_rules]
                # costs come from the decomposition compile_ruleset just
                # retained — never a second 100k-rule parse + DNF pass
                costs = costs_from_ruleset(
                    snap.ruleset, snap.finder)[:snap.n_config_rules]
                # the content-addressed bank cache: the previous
                # generation's banks keyed by their content hash. Delta
                # planning keeps unchanged namespaces on their shards,
                # so an unchanged shard's key matches and its compiled
                # bank carries over; pop-on-use so two identical shards
                # (possible when both hold only replicated globals)
                # never share one bank object
                prev = self._sharded if self.args.delta_compile else None
                prev_plan = None
                cache: dict[str, Any] = {}
                if prev is not None and prev.get("mode") == "sharded":
                    prev_plan = prev["plan"]
                    for b, key in zip(prev["banks"],
                                      prev.get("bank_keys", ())):
                        cache.setdefault(key, b)
                plan = plan_shards(
                    preds, snap.finder, self.args.shards, costs=costs,
                    revision=snap.revision, prev=prev_plan,
                    rebalance_budget=self.args.shard_rebalance_budget)
                static = snapshot_static_digest(
                    snap, identity_attr=self.args.identity_attr,
                    buckets=buckets,
                    rule_telemetry=self.args.rule_telemetry)
                banks = []
                for k in range(plan.n_shards):
                    key = bank_content_key(snap, plan, k, static)
                    bank_keys.append(key)
                    carried = cache.pop(key, None)
                    if carried is not None:
                        # carry the compiled artifact by SHALLOW COPY:
                        # the new generation's bank shares the
                        # dispatcher / snapshot / checker but owns its
                        # local_to_global — the outgoing generation's
                        # routers keep the ORIGINAL object, so in-flight
                        # folds never see the incoming numbering and a
                        # rebuild that fails on a later bank leaves
                        # serving state untouched
                        banks.append(dataclasses.replace(
                            carried, shard_id=k,
                            local_to_global=np.asarray(
                                plan.shard_rules[k], np.int64),
                            predicted_cost=float(plan.shard_cost[k])
                            if plan.shard_cost else 0.0))
                        reused_ids.append(k)
                    else:
                        b = compile_shard_bank(snap, dispatcher.handlers,
                                               plan, k, **bank_kw)
                        b.content_key = key
                        banks.append(b)
                # grant revocation scoped to the DELTA: only the
                # recompiled banks' namespaces drop to the TTL floor; a
                # scratch rebuild (nothing reused) revokes globally.
                # Before the router swap below — new-generation
                # responses never carry old-generation grants
                if self.grants is not None:
                    changed = {k for k in range(plan.n_shards)
                               if k not in reused_ids}
                    if reused_ids:
                        # union the OLD plan's namespaces for the
                        # changed shards: a namespace whose rules were
                        # all DELETED is absent from the new ns_to_shard
                        # but its cached verdicts still need revoking
                        # (shard ids are stable under delta planning)
                        ns_maps = [plan.ns_to_shard]
                        if prev_plan is not None:
                            ns_maps.append(prev_plan.ns_to_shard)
                        self.grants.on_publish(
                            {ns for m in ns_maps
                             for ns, s in m.items() if s in changed})
                    else:
                        self.grants.on_publish(None)
                bank_map = {b.shard_id: b for b in banks}
                routers = [ShardRouter(bank_map, plan,
                                       self.args.identity_attr,
                                       replica=i)
                           for i in range(n_lanes)]
            except ShardingUnsupported as exc:
                # un-shardable snapshot (rbac pseudo-rules): fall back
                # to replica-only lanes over the monolithic plan — the
                # server keeps serving, and the record says why
                reason = str(exc)
                plan, banks, routers = replica_lanes()
        else:
            plan, banks, routers = replica_lanes()
        # each bank carries its OWN resilience wrap: retry → per-bank
        # circuit breaker → the bank's CPU-oracle fallback
        # (Dispatcher.check_host_oracle over the bank's rules), strict on
        # the card as the server's own checker is. The CHECKER is per
        # generation (its callables belong to THIS generation's banks);
        # only the BREAKER persists across swaps, keyed by shard id
        breakers = self._bank_breakers
        reused_set = set(reused_ids)
        for b in banks:
            if b.shard_id in reused_set and b.checker is not None:
                # carried bank: its checker's callables ARE this bank's
                # dispatcher — checker, breaker state and all
                breakers[b.shard_id] = b.checker.breaker
                continue
            b.checker = ResilientChecker(
                device=b.dispatcher.check,
                oracle=b.dispatcher.check_host_oracle,
                config=ResilienceConfig(
                    fail_policy=self.args.check_fail_policy,
                    breaker_failures=self.args.breaker_failures,
                    breaker_reset_s=self.args.breaker_reset_s,
                    retry=self.args.device_retry),
                strict_device=self.device.type == "cuda",
                name=f"bank:{b.shard_id}")
            prev_brk = breakers.get(b.shard_id)
            if prev_brk is not None:
                b.checker.breaker = prev_brk
            else:
                breakers[b.shard_id] = b.checker.breaker
        # warm each NEW bank's serving shapes BEFORE the lane swap, in
        # this thread, as the controller warms a swapped plan: the
        # previous generation serves meanwhile, and the warm's pulls
        # finish every launch this thread's stream queued on the bank's
        # tables before any lane stream reads them. Carried banks keep
        # their warmed shape set — not warmed again, which is what delta
        # compilation saves
        distinct = {id(b.dispatcher.fused): b for b in banks
                    if b.dispatcher.fused is not None
                    and b.shard_id not in reused_set}
        for b in distinct.values():
            b.dispatcher.fused.prewarm(buckets)
        router.set_routers(routers, plan)
        # telemetry fan: bank plans' per-rule accumulators merge into
        # the one aggregator by qualified rule name (lane 0 in
        # replica-only mode IS the attached parent dispatcher — the
        # aggregator dedups by plan identity)
        try:
            self.rulestats.attach_lanes([b.dispatcher for b in banks])
        except Exception:
            log.exception("rulestats lane attach failed")
        wall = time.perf_counter() - t0
        n_recompiled = len(banks) - len(reused_ids)
        self._sharded = {
            "plan": plan,
            "banks": banks,
            "bank_keys": bank_keys,
            "revision": snap.revision,
            "mode": "sharded" if self.args.shards > 0 and not reason
                    else "replica-only",
            "fallback_reason": reason,
            "build_wall_s": wall,
            "built_wall": time.time(),
            "delta": {
                "reused": sorted(reused_ids),
                "recompiled": sorted(
                    b.shard_id for b in banks
                    if b.shard_id not in reused_set),
                "plan_stability": dict(plan.stability),
            },
        }
        st = self._rebuild_status
        st["rebuilds"] += 1
        st["banks_reused"] = len(reused_ids)
        st["banks_recompiled"] = n_recompiled
        st["banks_reused_total"] += len(reused_ids)
        st["banks_recompiled_total"] += n_recompiled
        st["last_wall_s"] = round(wall, 4)
        st["revision"] = snap.revision
        # the mesh event timeline: which banks this generation carried and
        # which it recompiled, the event a cold bank's tail rides beside
        forensics.record_event("bank_rebuild",
                               generation=snap.revision,
                               reused=len(reused_ids),
                               recompiled=n_recompiled,
                               wall_ms=round(wall * 1e3, 1))

    # -- API surface (grpcServer.go Check semantics) --
    # Preprocessing (the APA phase) happens exactly ONCE per request, in
    # the caller-facing entry points.

    def preprocess(self, bag: Bag) -> Bag:
        d = self.controller.dispatcher
        # the APA resolve costs a device trip per request — skip it
        # unless an ATTRIBUTE_GENERATOR action is configured
        if not self.args.preprocess or not d.has_apa:
            return bag
        return d.preprocess(bag)

    def _run_check_batch(self, bags: Sequence[Bag],
                         deadline: float | None = None
                         ) -> Sequence[CheckResponse]:
        # pre-batched entries (check_many) under sharded serving route
        # through the shard path too — a mixed-namespace batch fans
        # across banks inside the router; lane attribution rides
        # replica 0 (the submitting caller chose no lane)
        rr = self._replica_router
        if rr is not None and rr.routers:
            return rr.routers[0].check(bags, deadline=deadline)
        return self.resilience.run_batch(bags, deadline=deadline)

    def _run_check_batch_device(self, bags: Sequence[Bag],
                                deadline: float | None = None
                                ) -> Sequence[CheckResponse]:
        """The device serving path (the ResilientChecker's primary).
        Resolved per call: a config swap publishes a new dispatcher and
        the breaker follows it."""
        return self.controller.dispatcher.check(bags, deadline=deadline)

    def _run_check_batch_oracle(self, bags: Sequence[Bag]
                                ) -> Sequence[CheckResponse]:
        """The CPU-oracle fallback (the ResilientChecker's degraded
        path): no device trip and no kernel anywhere."""
        return self.controller.dispatcher.check_host_oracle(bags)

    def check(self, bag: Bag,
              deadline: float | None = None) -> CheckResponse:
        """One request, coalesced into a device batch. `deadline`:
        absolute time.perf_counter() instant (CheckBatcher.submit)."""
        return self.batcher.check(self.preprocess(bag), deadline=deadline)

    def check_many(self, bags: Sequence[Bag]) -> list[CheckResponse]:
        """Pre-batched entry: the whole batch is one device step. The
        preprocess time counts as the batch's queue-wait, and every
        request's wall time feeds the e2e histogram. The flight
        recorder's tape is open on this thread for the batch (the
        dispatcher runs inline here)."""
        t0 = time.perf_counter()
        forensics.RECORDER.batch_begin()
        pre = [self.preprocess(b) for b in bags]
        monitor.observe_stage("queue_wait", time.perf_counter() - t0)
        out = list(self._run_check_batch(pre))
        e2e = time.perf_counter() - t0
        for _ in bags:
            monitor.observe_check_e2e(e2e)
        forensics.RECORDER.note_direct(e2e, len(bags))
        return out

    def _run_report_batch(self, bags: Sequence[Bag]) -> Sequence[None]:
        """Report batcher hook: dispatch the coalesced record batch
        (unpadded — the fused resolve pads per chunk); results are
        completion-only."""
        self.controller.dispatcher.report(bags)
        return [None] * len(bags)

    def submit_report(self, bags: Sequence[Bag]) -> list:
        """Non-blocking report entry → one Future per record (empty when
        report_batching is off: the records were dispatched inline).
        Every record is counted ACCEPTED here and exported or typed-
        rejected exactly once when its future resolves
        (monitor.report_record_done)."""
        from concurrent.futures import Future

        from istio_tpu_torch.runtime.resilience import (CheckRejected,
                                                        UnavailableError)
        bags = [self.preprocess(b) for b in bags]
        rb = self._report_batcher
        if rb is None:
            monitor.report_accepted(len(bags))
            try:
                self.controller.dispatcher.report(bags)
            except Exception:
                monitor.report_rejected(len(bags), "error")
                raise
            monitor.report_exported(len(bags))
            return []
        futs = []
        for b in bags:
            monitor.report_accepted(1)
            try:
                fut = rb.submit(b)
            except Exception as exc:
                # a closed coalescer raises: the record stays on the
                # ledger as a typed-rejected future
                fut = Future()
                fut.set_exception(
                    exc if isinstance(exc, CheckRejected) else
                    UnavailableError(f"report coalescer closed: "
                                     f"{type(exc).__name__}: {exc}"))
            fut.add_done_callback(monitor.report_record_done)
            futs.append(fut)
        return futs

    def report(self, bags: Sequence[Bag]) -> None:
        """Blocking report: returns after every record's batch completed;
        the first batch error re-raises only after all futures
        resolved."""
        from concurrent.futures import wait

        futs = self.submit_report(bags)
        if not futs:
            return
        wait(futs)
        first = next((e for e in (f.exception() for f in futs)
                      if e is not None), None)
        if first is not None:
            raise first

    def quota(self, bag: Bag, quota_name: str,
              args: QuotaArgs | None = None,
              preprocessed: bool = False,
              deadline: float | None = None) -> QuotaResult:
        """The host quota path (Dispatcher.quota): resolves the bag's
        rules and calls the one matching quota handler. `deadline`: an
        absolute time.perf_counter() instant bounding the adapter call
        on the executor; a caller without one gets the server's
        default_check_deadline_ms."""
        d = self.controller.dispatcher
        if not preprocessed:
            bag = self.preprocess(bag)
        if deadline is None and self.args.default_check_deadline_ms:
            deadline = time.perf_counter() + \
                self.args.default_check_deadline_ms / 1e3
        return d.quota(bag, quota_name, args or QuotaArgs(),
                       deadline=deadline)

    def quota_fused(self, bag: Bag, quota_name: str, args: QuotaArgs,
                    check_result):
        """Served quota via the device pools (runtime/device_quota.py):
        reuses the CHECK step's activity bits instead of re-resolving.
        Returns a QuotaFuture, a final QuotaResult (no device work
        needed), or None → the caller takes the `quota` fallback
        (generic path / non-memquota quota handler)."""
        if check_result.active_quota_rules is None:
            return None
        # rule indices are positional within the snapshot that served
        # the check — use THAT dispatcher, not the current one
        d = check_result.quota_context
        if d is None:
            # no quota actions existed at check time: grant freely
            return QuotaResult(granted_amount=args.quota_amount)
        plan = d.fused
        if plan is None:
            return None
        active = set(check_result.active_quota_rules)
        snap = d.snapshot
        for ridx, handler_q, inst_q, names in plan.quota_actions:
            if ridx not in active or quota_name not in names:
                continue
            pool = self.controller.device_quotas.get(handler_q)
            # limits are keyed by the handler config's quota names, which
            # match QUALIFIED instance names
            if pool is None or not pool.knows(inst_q):
                return None   # non-memquota quota handler → host path
            try:
                instance = snap.instances[inst_q].build(bag)
            except EvalError as exc:   # dispatcher.quota parity
                return QuotaResult(granted_amount=0, status_code=INTERNAL,
                                   status_message=str(exc))
            except Exception as exc:   # safeDispatch parity
                return QuotaResult(granted_amount=0, status_code=INTERNAL,
                                   status_message=f"instance build: {exc}")
            return pool.alloc(inst_q, instance, args)
        # no matching active quota rule: grant freely
        return QuotaResult(granted_amount=args.quota_amount)

    # -- in-step quota (gated: ServerArgs.quota_in_step) ---------------

    def instep_quota_target(self) -> tuple | None:
        """(pool, {name → (ridx, inst_q)}) when the CURRENT snapshot is
        in-step eligible: exactly one device pool, and every quota name
        resolving to exactly one quota action on that pool's handler
        whose rule predicate is device-evaluated. None → callers use the
        classic check-then-quota_fused path."""
        if not self.args.quota_in_step:
            return None
        if self._replica_router is not None:
            # the merged check+quota program is ONE device program per
            # pool over ONE ruleset; bank-local rule indices and per-bank
            # trips leave no single program to merge into — sharded
            # serving keeps the classic check-then-quota_fused path
            return None
        d = self.controller.dispatcher
        cached = getattr(self, "_instep_cache", None)
        if cached is not None and cached[0] is d.snapshot:
            return cached[1]
        target = self._build_instep_target(d, self.controller.device_quotas)
        self._instep_cache = (d.snapshot, target)
        return target

    @staticmethod
    def _build_instep_target(d, pools: Mapping) -> tuple | None:
        plan = d.fused
        if plan is None or not plan.quota_actions or not pools:
            return None
        if len(set(map(id, pools.values()))) != 1:
            return None
        pool = next(iter(pools.values()))
        rs = d.snapshot.ruleset
        # the device alloc gates on the DEVICE status (a denied check
        # must not consume, grpcServer.go:188); host overlay actions or
        # host-fallback predicates could flip the final status after the
        # trip — such snapshots keep the classic path
        n_cfg = len(d.snapshot.rules)
        if plan.host_actions or any(r < n_cfg for r in rs.host_fallback):
            return None
        by_name: dict[str, Any] = {}
        for ridx, handler_q, inst_q, names in plan.quota_actions:
            for name in names:
                by_name.setdefault(name, []).append((ridx, handler_q, inst_q))
        out: dict[str, tuple] = {}
        for name, cands in by_name.items():
            if len(cands) != 1:
                continue
            ridx, handler_q, inst_q = cands[0]
            if pools.get(handler_q) is not pool or not pool.knows(inst_q) \
                    or ridx in rs.host_fallback:
                continue
            out[name] = (ridx, inst_q)
        return (pool, out) if out else None

    def _prewarm_instep_for(self, plan, pools: Mapping) -> None:
        """Controller prewarm hook: run the CANDIDATE plan's in-step trip
        at every serving shape before the publish, against the new
        generation's pool. On the card a warm is a few launches, so it
        runs synchronously in the rebuilding thread."""
        if not self.args.quota_in_step or not plan.quota_actions or \
                len(set(map(id, pools.values()))) != 1:
            return
        pool = next(iter(pools.values()))
        plan.prewarm_instep(self._buckets, pool.counts)

    def prewarm_instep(self) -> None:
        """Run the live plan's in-step trip at every serving shape (a
        no-op unless quota_in_step is on and the snapshot is eligible)."""
        target = self.instep_quota_target()
        plan = self.controller.dispatcher.fused
        if plan is None or target is None:
            return
        plan.prewarm_instep(self.controller.prewarm_buckets,
                            target[0].counts)

    def check_batch_quota_instep(self, bags: Sequence[Bag],
                                 qrows: Sequence[tuple], target: tuple):
        """One padded batch with its quota rows allocated IN the check
        trip. `qrows`: [(slot, requested name, QuotaArgs)]; `target` from
        instep_quota_target() (same snapshot). Returns (responses,
        {slot → QuotaResult}). Rows whose instance build fails resolve
        INTERNAL without the trip (quota_fused parity)."""
        from istio_tpu_torch.runtime.batcher import trim_pads

        t0 = time.perf_counter()
        forensics.RECORDER.batch_begin()
        out = self._check_batch_quota_instep_inner(bags, qrows, target)
        e2e = time.perf_counter() - t0
        # observed on success only, like the batcher's e2e mass
        real = trim_pads(bags)
        for _ in real:
            monitor.observe_check_e2e(e2e)
        forensics.RECORDER.note_direct(e2e, len(real))
        return out

    def _check_batch_quota_instep_inner(self, bags: Sequence[Bag],
                                        qrows: Sequence[tuple],
                                        target: tuple):
        d = self.controller.dispatcher
        snap = d.snapshot
        pool, by_name = target
        early: dict[int, QuotaResult] = {}
        rows: list[tuple] = []
        rule_idx = np.full(len(bags), -1, np.int32)
        for slot, name, args in qrows:
            ridx, inst_q = by_name[name]
            try:
                instance = snap.instances[inst_q].build(bags[slot])
            except EvalError as exc:
                early[slot] = QuotaResult(granted_amount=0,
                                          status_code=INTERNAL,
                                          status_message=str(exc))
                continue
            except Exception as exc:
                early[slot] = QuotaResult(
                    granted_amount=0, status_code=INTERNAL,
                    status_message=f"instance build: {exc}")
                continue
            rule_idx[slot] = ridx
            rows.append((slot, inst_q, instance, args))
        # tensorize OUTSIDE the counter token: the token covers only
        # stage → dispatch
        t_tz = time.perf_counter()
        pre = d._tensorize_for_device(bags)
        monitor.observe_stage("tensorize", time.perf_counter() - t_tz)
        sess = pool.inline_begin(len(bags), rows, pool._clock()) \
            if rows else None
        if sess is None:
            if rows:   # pool closed under a config swap
                for slot, _, _, _args in rows:
                    early[slot] = QuotaResult(
                        granted_amount=0, status_code=14,
                        status_message="quota pool closed by config swap")
            return d.check(bags, pre_tensorized=pre), early
        results: dict[int, QuotaResult] = {}

        def on_pull(granted, gate) -> None:
            # right after the one pull, inside d.check: commits (in
            # dispatch order) before the per-row response python runs
            results.update(sess.commit(np.asarray(granted),
                                       np.asarray(gate)))

        try:
            q = {"buckets": sess.buckets, "amounts": sess.amounts,
                 "be": sess.be, "mx": sess.mx, "active": sess.active,
                 "ticks": sess.ticks, "lasts": sess.lasts,
                 "rolling": sess.rolling, "rule_idx": rule_idx}
            responses = d.check(
                bags, instep=(q, sess.prev_counts, sess.dispatched, on_pull),
                pre_tensorized=pre)
        except BaseException:
            sess.abort()   # no-op when on_pull already committed
            raise
        results.update(sess.early)
        results.update(early)
        return responses, results

    def shutdown(self, deadline: float | None = 5.0) -> None:
        """Ordered graceful shutdown: stop the auditor, stop admission,
        drain the batchers
        (bounded by `deadline` seconds each), close them, stop the
        rule-stats drainer and drain once more, close the executor (no
        batch can submit a host action any more; wedged workers are left
        as daemon threads), then close the controller (closes handlers).
        Idempotent."""
        if getattr(self, "_shutdown_done", False):
            return
        self._shutdown_done = True
        # the auditor first: a mid-teardown evaluation would read the
        # batchers and pools as they close
        if getattr(self, "audit", None) is not None:
            self.audit.stop()
        forensics.record_event("shutdown", deadline_s=deadline)
        self.controller.begin_close()
        rb = self._report_batcher
        self.batcher.quiesce()
        if rb is not None:
            rb.quiesce()
        self.batcher.drain(deadline)
        if rb is not None:
            rb.drain(deadline)
        self.batcher.close()
        if rb is not None:
            rb.close()
            cons = monitor.report_conservation()
            if not cons["exact"]:
                # counters are process-wide: another live server may
                # legitimately hold records
                log.warning("report record conservation residue at "
                            "shutdown: %s", cons)
        if self._rulestats_drainer is not None:
            self._rulestats_drainer.close()
            self.rulestats.drain()     # what the last interval left
        if self.executor is not None:
            self.executor.close()
            hc = monitor.host_action_counters()
            if not hc["exact"]:
                # counters are process-wide: another live server may
                # legitimately hold actions
                log.warning("host action conservation residue at "
                            "shutdown: submitted=%d resolved=%d",
                            hc["submitted"], hc["resolved"])
        self.controller.close()

    def close(self) -> None:
        self.shutdown()

    def capture_profile(self, seconds: float = 1.0) -> dict:
        """One torch.profiler capture of `seconds` into
        ServerArgs.profile_dir (forensics.capture_profile: raises
        ProfileBusy while another capture runs, fail-soft payload where
        the profiler is unavailable)."""
        return forensics.capture_profile(self.args.profile_dir, seconds)
