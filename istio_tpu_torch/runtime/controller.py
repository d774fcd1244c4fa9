"""Controller — store watch → snapshot rebuild → atomic publish.

Port of istio_tpu/runtime/controller.py (reference:
mixer/pkg/runtime/controller.go — watchChanges :192 with a debounce,
rebuild :273/:380, publishSnapShot :115): a rebuild builds the snapshot,
then the fused plan on the card, then the handler table, then the
dispatcher, and swaps the dispatcher reference atomically. Orphaned
handlers close after a drain delay.

A new plan runs every serving shape once before it is published, in
the rebuilding thread (`initial_prewarm=False` skips this for the first
build only). The reference warms in background threads and serves
still-warming shapes through the host oracle, to hide XLA compile time;
here the kernels build once per process, at first use, and a warm trip
is a handful of launches, so there is nothing to hide and no thread.

Device quota pools (runtime/device_quota.DeviceQuotaTable) are built
when the fused path is on, as in the reference: each rebuild reuses the
pools whose memquota handler signature is unchanged and closes the
orphans after the drain delay. `prewarm_hook(plan, pools)` runs after a
new plan's warm, with the new generation's pools, before the publish
(the server warms its in-step quota trip there).

`mesh` (parallel/mesh.Mesh, dp × mp) makes every plan's engine step the
sharded one (runtime/fused.build_fused_plan). `executor`
(runtime/executor.AdapterExecutor) and `grants`
(runtime/grants.GrantPolicy) go to every published Dispatcher; the
grant policy revokes (`on_publish(None)`) immediately before each
dispatcher swap, so a request served by the new generation never
carries a grant computed from the old one's age.

`canary` (canary/gate.ConfigCanary): every rebuild after the first
replays the canary's recorded traffic through the candidate plan and
diffs it before anything is published; a veto (`CanaryRejected`, kept
in `last_canary_rejection` and handed to `on_canary_reject`) keeps the
old dispatcher, handler table and quota pools serving untouched. The
gate runs straight after the candidate plan is built, ahead of the
quota pool rebuild and the warm (the reference gates after its warm and
rebuilds the pools after the gate; here the in-step warm needs the new
pools, so the gate moved ahead of both). A strict canary's replay
device fault raises out of rebuild() with nothing published. Every
published dispatcher taps the canary's recorder, and `on_published`
re-baselines it after the swap. The reference's `canary_veto` forensics
event waits for the forensics plane; the veto is logged at ERROR.

`warm_parent_plans=False` (the sharded serving plane, sharding/): the
published plan is built for its metadata and the host oracle only; it is
not warmed (nor is `prewarm_hook` called) and the controller does not
revoke grants — the RuntimeServer warms the shard banks and revokes
before its own router swap. Not carried (raises NotPorted when asked
for): the overlapped h2d staging.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Mapping

import torch

from istio_tpu_torch.attribute.types import ValueType
from istio_tpu_torch.compiler.layout import InternTable
from istio_tpu_torch.device import NotPorted
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.runtime.dispatcher import (DEFAULT_IDENTITY_ATTR,
                                                Dispatcher)
from istio_tpu_torch.runtime.handler_table import HandlerTable
from istio_tpu_torch.runtime.store import Event, Store

log = logging.getLogger("istio_tpu_torch.runtime.controller")


class Controller:
    def __init__(self, store: Store,
                 default_manifest: Mapping[str, ValueType] | None = None,
                 identity_attr: str = DEFAULT_IDENTITY_ATTR,
                 debounce_s: float = 0.05,
                 max_str_len: int | None = None,
                 on_publish: Callable[[Dispatcher], None] | None = None,
                 fused: bool = True,
                 prewarm_buckets: tuple[int, ...] = (),
                 mesh=None,
                 rule_telemetry: bool = True,
                 canary=None,
                 on_canary_reject: Callable[..., None] | None = None,
                 initial_prewarm: bool = True,
                 prewarm_hook: Callable[..., None] | None = None,
                 warm_parent_plans: bool = True,
                 executor=None,
                 grants=None,
                 overlap_h2d: bool = False,
                 device: str | torch.device = "cuda"):
        if overlap_h2d:
            raise NotPorted("Controller(overlap_h2d=True)")
        self.store = store
        # False when a sharded serving plane owns the check path
        # (istio_tpu_torch/sharding): the parent monolithic plan is
        # then a metadata / oracle surface only — never warmed, and no
        # device trip ever runs on it. The RuntimeServer warms the shard
        # BANKS instead, inside its own publish hook, and revokes grants
        # before its router swap
        self.warm_parent_plans = warm_parent_plans
        # handed to every published Dispatcher; the executor's lanes and
        # breakers outlive snapshots
        self.executor = executor
        self.grants = grants
        # config canary: shadow-replays recorded live traffic through
        # every candidate before its publish; a veto keeps the old
        # dispatcher serving
        self.canary = canary
        self.on_canary_reject = on_canary_reject
        self.last_canary_rejection = None
        self.identity_attr = identity_attr
        self.debounce_s = debounce_s
        self.on_publish = on_publish
        self.fused_enabled = fused
        self.rule_telemetry = rule_telemetry
        self.mesh = mesh    # parallel/mesh.Mesh for mesh serving
        self.prewarm_buckets = tuple(prewarm_buckets)
        self.prewarm_hook = prewarm_hook
        # False skips the first build's warm; config-swap warms are
        # unaffected
        self.initial_prewarm = initial_prewarm
        self._closing = False
        self._builder = SnapshotBuilder(default_manifest,
                                        InternTable(), max_str_len,
                                        lower_rbac=fused, device=device)
        self._handler_table = HandlerTable()
        # device-backed served quota; pools keep their counters across
        # snapshot swaps via signature reuse
        self._quota_table = None
        if fused:
            from istio_tpu_torch.runtime.device_quota import DeviceQuotaTable
            self._quota_table = DeviceQuotaTable(device=device)
        self.device_quotas: dict = {}
        self._lock = threading.Lock()
        self._rebuild_serial = threading.Lock()   # one rebuild at a time
        self._timer: threading.Timer | None = None
        self._dispatcher: Dispatcher | None = None
        # wall seconds of the last completed publish
        self.last_publish_wall_s = 0.0
        self.rebuild()                      # initial snapshot
        store.watch(self._on_events)

    @property
    def dispatcher(self) -> Dispatcher:
        d = self._dispatcher
        assert d is not None
        return d

    def _on_events(self, events: list[Event]) -> None:
        """Debounced rebuild trigger (controller.go watchChanges)."""
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self.debounce_s, self.rebuild)
            self._timer.daemon = True
            self._timer.start()

    # grace period before closing handlers orphaned by a config swap —
    # lets requests in flight on the OLD dispatcher finish
    ORPHAN_DRAIN_S = 2.0

    def rebuild(self) -> Dispatcher:
        if self._closing:
            return self._dispatcher
        with self._rebuild_serial:
            if self._closing:
                return self._dispatcher
            return self._rebuild_locked()

    def _rebuild_locked(self) -> Dispatcher:
        t_pub0 = time.perf_counter()
        snapshot = self._builder.build(self.store)
        for err in snapshot.errors:
            log.warning("config: %s", err)
        plan = None
        if self.fused_enabled:
            from istio_tpu_torch.runtime.fused import build_fused_plan
            plan = build_fused_plan(snapshot, mesh=self.mesh,
                                    rule_telemetry=self.rule_telemetry)
        # config canary: replay recorded live traffic through the
        # candidate BEFORE any publish side effect — the quota pools,
        # the warm that runs on them and the handler table below all
        # move shared state toward the new snapshot, and a vetoed
        # candidate must leave them untouched so the old dispatcher
        # keeps serving unchanged
        if self.canary is not None and self._dispatcher is not None:
            rejection = self.canary.gate(self._dispatcher, snapshot,
                                         plan, self.prewarm_buckets)
            if rejection is not None:
                self.last_canary_rejection = rejection
                log.error("config publish VETOED (generation %d kept "
                          "serving): %s", self._dispatcher.snapshot
                          .revision, rejection)
                if self.on_canary_reject is not None:
                    try:
                        self.on_canary_reject(rejection)
                    except Exception:
                        log.exception("on_canary_reject hook failed")
                return self._dispatcher
        quota_orphans: list = []
        if self._quota_table is not None:
            self.device_quotas, quota_orphans = \
                self._quota_table.rebuild(snapshot)
        if plan is not None and self.prewarm_buckets and \
                self.warm_parent_plans and (
                self._dispatcher is not None or self.initial_prewarm):
            plan.prewarm(self.prewarm_buckets)
            if self.prewarm_hook is not None:
                try:
                    self.prewarm_hook(plan, self.device_quotas)
                except Exception:
                    log.exception("prewarm hook failed")
        handlers, orphans = self._handler_table.rebuild(snapshot)
        dispatcher = Dispatcher(snapshot, handlers, self.identity_attr,
                                fused=plan,
                                buckets=self.prewarm_buckets,
                                recorder=self.canary.recorder
                                if self.canary is not None else None,
                                executor=self.executor,
                                grants=self.grants)
        if self.grants is not None and self.warm_parent_plans:
            # revoke BEFORE the swap: the serving surface is this
            # controller's dispatcher (monolithic mode); under sharding
            # the server revokes, delta-scoped, before its router swap
            self.grants.on_publish(None)
        self._dispatcher = dispatcher      # atomic publish (GIL ref swap)
        # a successful publish supersedes any earlier veto
        self.last_canary_rejection = None
        if self.canary is not None:
            # post-swap: re-baselines the recorder when the published
            # candidate was divergent (gate.on_published)
            self.canary.on_published(dispatcher)
        if orphans:
            t = threading.Timer(
                self.ORPHAN_DRAIN_S,
                self._handler_table.close_handlers, args=(orphans,))
            t.daemon = True
            t.start()
        if quota_orphans:
            # same delayed drain as handler orphans: in-flight quota
            # futures on the old pools resolve first
            t = threading.Timer(
                self.ORPHAN_DRAIN_S,
                lambda: [p.close() for p in quota_orphans])
            t.daemon = True
            t.start()
        log.info("published config generation %d (%d rules, %d handlers,"
                 " %d instances, %d errors)", snapshot.revision,
                 len(snapshot.rules), len(handlers),
                 len(snapshot.instances), len(snapshot.errors))
        if self.on_publish is not None:
            self.on_publish(dispatcher)
        self.last_publish_wall_s = time.perf_counter() - t_pub0
        return dispatcher

    def begin_close(self) -> None:
        """Stop admitting rebuilds and cancel the debounce timer — no
        joins."""
        self._closing = True
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()

    def close(self) -> None:
        self.begin_close()
        # reap an in-flight rebuild: rebuild() holds _rebuild_serial
        with self._rebuild_serial:
            pass
        self._handler_table.close()
        if self._quota_table is not None:
            self._quota_table.close()
