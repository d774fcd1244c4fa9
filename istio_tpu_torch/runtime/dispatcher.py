"""Dispatcher — batched resolve + template/adapter fan-out, check and
report paths.

Port of the check and report paths of istio_tpu/runtime/dispatcher.py
(reference:
mixer/pkg/runtime/dispatcher.go + resolver.go):

  * The SERVING path is the fused device engine (runtime/fused.py):
    check verdicts, deny/list statuses, referenced bitmaps and quota
    activity bits come off one packed device step and one pull; only
    host-overlay actions (unfusable adapters) and host-fallback
    predicates run python per request. The generic path (fused=None)
    keeps instance construction + adapter calls host-side and is the
    behavioural oracle. Lowest-rule-index non-OK status wins, TTLs take
    the min (dispatcher.go:322), on both.
  * Namespace targeting follows resolver.go:180 destAndNamespace.
  * Adapter calls are panic-isolated (safeDispatch dispatcher.go:399).

Report dispatch rides the fused plan's packed report trip: one device
trip and one pull per chunk carry the active report rules' bits and
every lowered instance field (runtime/report_lower.py), and adapters
receive finished instances. `check(instep=...)` carries an in-step quota
allocation on the check trip (FusedPlan.packed_check_instep), and
`quota` is the host quota path through the adapter, and `preprocess`
the APA phase (one resolve trip per bag, as in the reference).

With an `executor` (runtime/executor.AdapterExecutor) the fused path's
host-overlay CHECK actions and quota()'s adapter call run on the
handlers' lanes, bounded by the batch's deadline; without one they run
inline in this thread, the reference's behavioural-oracle loop (the
generic path and the host oracle always run them inline). With `grants`
(runtime/grants.GrantPolicy) every check response's TTL and use count
are min-folded with its namespace's grant. The reference also marks the
grant fold as a stage of the flight recorder's tape
(`RECORDER.stage_mark("grant")`); runtime/forensics.py is not ported, so
that is left out. With a `recorder` (canary/recorder.TrafficRecorder)
the fused path taps every served batch after its response loop: the
padding-trimmed rows with the DEVICE planes (status, TTL, use count,
deny rule from the packed pull, before the host overlay and the grant
fold) and the batch's trace span; the generic path is not tapped, as in
the reference. `observe=False` is the canary's shadow-replay mode. Not
carried: the overlapped h2d staging (`overlap_h2d=True` raises
NotPorted).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Mapping, Sequence

import numpy as np

from istio_tpu_torch.adapters.sdk import (CheckResult, Handler, QuotaArgs,
                                          QuotaResult)
from istio_tpu_torch.attribute.bag import Bag, MutableBag
from istio_tpu_torch.device import NotPorted
from istio_tpu_torch.expr.oracle import EvalError
from istio_tpu_torch.models.policy_engine import INTERNAL, OK
from istio_tpu_torch.runtime import monitor
from istio_tpu_torch.runtime.config import Snapshot, _qualify
from istio_tpu_torch.templates import Variety

log = logging.getLogger("istio_tpu_torch.runtime.dispatcher")

DEFAULT_IDENTITY_ATTR = "destination.service"


@dataclasses.dataclass
class CheckResponse:
    """Precondition result (CheckResponse.PreconditionResult)."""
    status_code: int = OK
    status_message: str = ""
    valid_duration_s: float = 5.0
    valid_use_count: int = 10_000
    referenced: tuple = ()
    # item → was-present, filled by the fused path from device planes
    referenced_presence: dict | None = None
    # QUOTA-variety rules active for this request (fused path only)
    active_quota_rules: tuple | None = None
    # the dispatcher that produced those indices
    quota_context: Any = None
    # DEVICE deny attribution: the lowest-index rule whose fused check
    # action produced the non-OK device status (-1 when the device
    # answered OK)
    deny_rule: int = -1


def _namespace_of(bag: Bag, identity_attr: str) -> str:
    """destAndNamespace (resolver.go:180): svc.ns.svc.cluster.local →
    'ns'; bare or absent destination → default namespace ''."""
    v, ok = bag.get(identity_attr)
    if not ok or not isinstance(v, str):
        return ""
    parts = v.split(".")
    return parts[1] if len(parts) >= 2 and parts[1] else ""


class Dispatcher:
    """Stateless over an immutable snapshot + built handler map; the
    controller swaps (snapshot, handlers) pairs atomically."""

    def __init__(self, snapshot: Snapshot, handlers: Mapping[str, Handler],
                 identity_attr: str = DEFAULT_IDENTITY_ATTR,
                 fused=None,
                 buckets: tuple[int, ...] = (),
                 recorder=None,
                 observe: bool = True,
                 executor=None,
                 grants=None,
                 overlap_h2d: bool = False):
        if overlap_h2d:
            raise NotPorted("Dispatcher(overlap_h2d=True)")
        self.snapshot = snapshot
        self.handlers = dict(handlers)
        self.identity_attr = identity_attr
        self.fused = fused
        # AdapterExecutor: the fused path's host-overlay CHECK actions
        # and quota()'s adapter calls run on its lanes; None keeps the
        # inline loop
        self.executor = executor
        # GrantPolicy: every check response's TTL / use count is
        # min-folded with its namespace's grant
        self.grants = grants
        # canary TrafficRecorder (canary/recorder.py): the fused path
        # taps every served batch's device planes into it
        self.recorder = recorder
        self._ns_name_of: dict | None = None   # lazy rs.ns_ids inverse
        # False = shadow-replay mode: no stage histograms, no
        # rule-telemetry folds, no chaos seam
        self.observe = observe
        self.buckets = tuple(sorted(buckets))
        # any ATTRIBUTE_GENERATOR action configured? (when False the
        # server skips the per-request preprocess resolve entirely)
        self.has_apa = any(
            snapshot.actions_for(r, Variety.ATTRIBUTE_GENERATOR)
            for r in range(len(snapshot.rules)))

    def _handler_for(self, hc) -> Handler | None:
        """Built handler for a HandlerConfig (config._qualify)."""
        return self.handlers.get(_qualify(hc.name, hc.namespace))

    # ------------------------------------------------------------------
    # resolution
    # ------------------------------------------------------------------

    def _grants_for_rows(self, ns_ids) -> list | None:
        """Per-row (ttl_s, use_count) from the grant policy, one policy
        round per distinct namespace of the batch; None when grants are
        off."""
        if self.grants is None:
            return None
        inv = self._ns_name_of
        if inv is None:
            inv = {v: k for k, v in self.snapshot.ruleset.ns_ids.items()}
            self._ns_name_of = inv
        uniq, inverse = np.unique(np.asarray(ns_ids), return_inverse=True)
        gs = self.grants.grants_for([inv.get(int(u), "") for u in uniq])
        return [gs[i] for i in inverse.reshape(-1)]

    def _apply_grants(self, bags: Sequence[Bag], responses) -> None:
        """The grant fold of the generic and oracle paths (a namespace
        lookup per bag): min() like every other TTL source."""
        if self.grants is None:
            return
        for bag, resp in zip(bags, responses):
            ttl, uses = self.grants.grant(
                _namespace_of(bag, self.identity_attr))
            resp.valid_duration_s = min(resp.valid_duration_s, ttl)
            resp.valid_use_count = min(resp.valid_use_count, uses)

    def _request_ns_ids(self, bags: Sequence[Bag]) -> np.ndarray:
        return np.asarray([self.snapshot.ruleset.namespace_id(
            _namespace_of(bag, self.identity_attr)) for bag in bags],
            np.int32)

    def _tensorize_for_device(self, bags: Sequence[Bag]):
        """(batch, ns_ids) via the python tensorizer (the C++ wire
        decoder is not ported)."""
        batch = self.snapshot.tensorizer.tensorize(bags)
        return batch, self._request_ns_ids(bags)

    def _overlay_active(self, packed: np.ndarray, bags: Sequence[Bag],
                        ns_ids: np.ndarray, observe: bool = False
                        ) -> tuple[np.ndarray, dict]:
        """Decode the packed step's bitpacked overlay plane →
        (ns-masked active bits [len(bags), n_overlay_cols], rule idx →
        column position). Host-fallback rules' bits are oracle-patched;
        device + host resolve errors are accounted. `bags`/`ns_ids` are
        already trimmed of padding rows. `observe`: feed host-fallback
        hits/errors into the rule-telemetry plane (check path only)."""
        from istio_tpu_torch.runtime.fused import unpack_word_rows

        plan, rs = self.fused, self.snapshot.ruleset
        n_err = int(packed[4, 0]) if packed.shape[1] else 0
        if n_err and self.observe:
            monitor.RESOLVE_ERRORS.inc(n_err)
        cols = plan.overlay_cols
        if not len(cols):
            return np.zeros((len(bags), 0), bool), {}
        n_words = plan.n_ref_words
        n_ov_words = plan.n_overlay_words
        n_real = len(bags)
        active_sub = unpack_word_rows(
            packed[5 + n_words:5 + n_words + n_ov_words, :n_real],
            len(cols))
        col_pos = {int(r): i for i, r in enumerate(cols)}
        rns = rs.rule_ns[cols]
        ns_ok_sub = (rns[None, :] == rs.ns_ids[""]) | \
                    (rns[None, :] == ns_ids[:, None])
        host_errs = 0
        fb_cols: list[int] = []
        fb_pos: list[int] = []
        err_by_rule: dict[int, int] = {}
        for ridx in rs.host_fallback:
            pos = col_pos.get(ridx)
            if pos is None:
                continue
            fb_cols.append(ridx)
            fb_pos.append(pos)
            vis_errs = 0
            # only ns-visible (bag, rule) pairs are oracle-evaluated
            for b in np.nonzero(ns_ok_sub[:, pos])[0]:
                m, _, e = rs.host_eval(ridx, bags[b])
                active_sub[b, pos] = m
                if e:
                    vis_errs += 1
            if vis_errs:
                err_by_rule[ridx] = vis_errs
                host_errs += vis_errs
        if host_errs and self.observe:
            monitor.RESOLVE_ERRORS.inc(host_errs)
        active_sub &= ns_ok_sub
        tele = plan.telemetry
        if observe and tele is not None and (fb_cols or err_by_rule):
            tele.add_host(fb_cols, active_sub[:, fb_pos],
                          err_by_rule, tele.ns_slots(ns_ids))
        return active_sub, col_pos

    def _overlay_fallback(self, matched: np.ndarray, err: np.ndarray,
                          ns_ids: np.ndarray, bags: Sequence[Bag]
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Patch host-fallback rules' verdicts into the device output and
        account namespace-visible errors; returns (active, ns_ok),
        clipped to config rules."""
        rs = self.snapshot.ruleset
        n_cfg = len(self.snapshot.rules)
        for ridx in rs.host_fallback:
            if ridx >= n_cfg:
                continue
            for b, bag in enumerate(bags):
                m, _, e = rs.host_eval(ridx, bag)
                matched[b, ridx] = m
                err[b, ridx] = e
        matched = matched[:, :n_cfg]
        err = err[:, :n_cfg]
        ns_ok = rs.namespace_mask(ns_ids).numpy()[:, :n_cfg]
        n_err = int((err & ns_ok).sum())
        if n_err:
            monitor.RESOLVE_ERRORS.inc(n_err)
        return matched & ns_ok, ns_ok

    def _resolve(self, bags: Sequence[Bag], observe: bool = False
                 ) -> tuple[list[list[int]], list[list[int]]]:
        """Batched rule matching → per-bag (active, namespace-visible)
        rule index lists: one device step for the whole batch, fallback
        + namespace masking host-side (the generic path)."""
        snap = self.snapshot
        if snap.ruleset.n_rules == 0:
            empty: list[list[int]] = [[] for _ in bags]
            return empty, [[] for _ in bags]
        with monitor.resolve_timer():
            t0 = time.perf_counter()
            batch = snap.tensorizer.tensorize(bags)
            t1 = time.perf_counter()
            if observe:
                monitor.observe_stage("tensorize", t1 - t0)
                from istio_tpu_torch.runtime.resilience import CHAOS
                CHAOS.device_step()
            matched, _, err = snap.ruleset(batch, ("matched", "err"))
            matched = matched.cpu().numpy()
            err = err.cpu().numpy()
            if observe:
                monitor.observe_stage("device_step",
                                      time.perf_counter() - t1)
        ns_ids = self._request_ns_ids(bags)
        active, ns_ok = self._overlay_fallback(matched, err, ns_ids, bags)
        return ([list(np.nonzero(active[b])[0]) for b in range(len(bags))],
                [list(np.nonzero(ns_ok[b])[0]) for b in range(len(bags))])

    # ------------------------------------------------------------------
    # varieties
    # ------------------------------------------------------------------

    def check(self, bags: Sequence[Bag], instep: Any = None,
              pre_tensorized: Any = None,
              deadline: float | None = None) -> list[CheckResponse]:
        """`instep`: optional (q_arrays, counts, on_dispatch, on_pull)
        from an in-step quota session (device_quota.InlineQuotaSession)
        — the quota alloc rides the check trip; `on_dispatch(new_counts)`
        fires once the trip is enqueued (the session moves the pool onto
        the trip's output plane and releases its token) and
        `on_pull(granted, gate)` right after the one pull, before any
        per-row response python. `pre_tensorized`: (batch, ns_ids)
        computed by the caller; must correspond to `bags` exactly. Both
        require the fused path. `deadline`: the batch's earliest row
        deadline (an absolute time.perf_counter() instant, from the
        batcher); host actions on the executor inherit it. None =
        unbounded (but for a configured per-action timeout)."""
        if self.fused is not None:
            return self._check_fused(bags, instep=instep,
                                     pre_tensorized=pre_tensorized,
                                     deadline=deadline)
        if instep is not None:
            raise ValueError("Dispatcher.check(instep=...) needs the fused "
                             "path")
        actives, visibles = self._resolve(bags, observe=self.observe)
        t_respond = time.perf_counter()
        out = [self._check_one(bag, rule_idxs, vis)
               for bag, rule_idxs, vis in zip(bags, actives, visibles)]
        self._apply_grants(bags, out)
        if self.observe:
            monitor.observe_stage("respond",
                                  time.perf_counter() - t_respond)
        return out

    def _check_fused(self, bags: Sequence[Bag], instep: Any = None,
                     pre_tensorized: Any = None,
                     deadline: float | None = None) -> list[CheckResponse]:
        """Fused serving path: ONE device step computes rule matching +
        denier/list verdicts + TTLs for the whole batch; the host loop
        below only touches rules with non-fusable actions (and rules
        whose predicate fell back to the host oracle). Status merge is
        lowest-rule-index-wins on both sides."""
        from istio_tpu_torch.runtime.batcher import trim_pads
        from istio_tpu_torch.runtime.fused import unpack_word_rows
        from istio_tpu_torch.utils import tracing

        snap, plan = self.snapshot, self.fused
        tr = tracing.get_tracer()
        # real (non-padding) prefix length, known BEFORE the device call
        n_real = len(trim_pads(bags))
        observe = self.observe
        with (monitor.resolve_timer() if observe
              else contextlib.nullcontext()):
            if pre_tensorized is not None:
                batch, ns_ids = pre_tensorized
            else:
                t_tz = time.perf_counter()
                with tr.span("serve.tensorize", batch=len(bags)):
                    batch, ns_ids = self._tensorize_for_device(bags)
                if observe:
                    monitor.observe_stage("tensorize",
                                          time.perf_counter() - t_tz)
            # ONE device→host pull for the whole verdict
            with tr.span("serve.device"):
                if instep is not None:
                    t_d = time.perf_counter()
                    q_arrays, counts, on_dispatch, on_pull = instep
                    packed_dev, new_counts = plan.packed_check_instep(
                        batch, ns_ids, q_arrays, counts, n_real=n_real)
                    # the trip is enqueued: the session moves the pool
                    # onto its output plane and drops the token, so the
                    # next trip chains on it while this pull is pending
                    on_dispatch(new_counts)
                    t_pull = time.perf_counter()
                    monitor.observe_stage("h2d", t_pull - t_d)
                    packed = packed_dev.cpu().numpy()   # the one pull
                    monitor.observe_stage("device_step",
                                          time.perf_counter() - t_pull)
                    # granted / gate are the LAST two rows; everything
                    # the decode below reads sits before them
                    on_pull(packed[-2], packed[-1] != 0)
                else:
                    packed = plan.packed_check(batch, ns_ids,
                                               observe=observe,
                                               n_real=n_real)
            status = packed[0]
            dur = packed[1].view(np.float32)
            uses = packed[2]
            deny_rule = packed[3]
        t_overlay = time.perf_counter()
        rs = snap.ruleset

        # bucket-padding rows carry no caller: every host-side pass
        # below runs on the real prefix only
        bags = bags[:n_real]
        ns_ids = ns_ids[:n_real]

        # referenced-attribute item bits (rows 5..5+W)
        n_words = plan.n_ref_words
        if n_words:
            ref_bits = unpack_word_rows(packed[5:5 + n_words, :n_real],
                                        len(plan.item_names))

        active_sub, col_pos = self._overlay_active(packed, bags, ns_ids,
                                                   observe=observe)
        present_np = batch.present.numpy()[:n_real]
        map_present_np = batch.map_present.numpy()[:n_real]
        lay = rs.layout

        ha = plan.host_rule_idx
        ha_pos = np.asarray([col_pos[int(r)] for r in ha], np.int64)
        qa_rules = sorted({qa[0] for qa in plan.quota_actions})
        qa_pos = [col_pos[r] for r in qa_rules]

        # the executor plane: submit every host action NOW, so the
        # adapter calls run on their lanes while the fold below decodes
        # the referenced / presence planes; the response loop then
        # claims them in rule order, bounded by the deadline. One list a
        # row of (rule idx, HostAction or final CheckResult), in the
        # order the inline loop would run them, so lowest-rule-index-
        # wins merging is byte-identical
        ex = self.executor
        host_pending: list[list] | None = None
        # an exception from the first submit to the last claim abandons
        # every unclaimed action: the conservation ledger stays exact, and
        # a retried batch never leaves its first submission dangling
        try:
            if ex is not None and len(ha):
                from istio_tpu_torch.runtime.executor import check_fallback
                host_pending = []
                for b, bag in enumerate(bags):
                    row: list = []
                    host_pending.append(row)
                    for ridx in ha[active_sub[b, ha_pos]]:
                        ridx = int(ridx)
                        for hc, template, inst_names in plan.host_actions[ridx]:
                            handler = self._handler_for(hc)
                            if handler is None:
                                continue
                            hq = _qualify(hc.name, hc.namespace)
                            for iname in inst_names:
                                try:
                                    instance = snap.instances[
                                        iname].build(bag)
                                except EvalError as exc:
                                    # the build stays on this thread
                                    # (_safe_check parity)
                                    monitor.DISPATCH_ERRORS.inc()
                                    row.append((ridx, CheckResult(
                                        status_code=INTERNAL,
                                        status_message=str(exc))))
                                    continue
                                row.append((ridx, ex.submit(
                                    hq, self._bound_check(handler, template,
                                                          instance),
                                    check_fallback)))

            # Referenced/presence construction deduplicated across the
            # batch: uniform traffic produces a handful of distinct
            # (referenced bits, presence bits) signatures. Shared objects
            # are read-only by contract.
            ref_of = None
            if n_words:
                signature = np.concatenate(
                    [ref_bits[:, :len(plan.item_names)],
                     present_np.astype(np.uint8),
                     map_present_np.astype(np.uint8),
                     active_sub.astype(np.uint8)], axis=1)
                uniq, inverse = np.unique(signature, axis=0,
                                          return_inverse=True)
                inverse = inverse.reshape(-1)
                names = plan.item_names
                n_items = len(names)
                shared: list[tuple[tuple, dict]] = []
                for u in range(uniq.shape[0]):
                    row = uniq[u]
                    referenced = {names[j]
                                  for j in np.nonzero(row[:n_items])[0]}
                    act_row = row[n_items + present_np.shape[1] +
                                  map_present_np.shape[1]:]
                    for ridx, extra in plan.unmapped_instance_attrs.items():
                        if act_row[col_pos[ridx]]:
                            referenced |= extra
                    pres_row = row[n_items:n_items + present_np.shape[1]]
                    mp_row = row[n_items + present_np.shape[1]:
                                 n_items + present_np.shape[1] +
                                 map_present_np.shape[1]]
                    presence: dict = {}
                    for item in referenced:
                        if isinstance(item, tuple):
                            col = lay.derived_slots.get(item)
                            if col is not None:
                                presence[item] = bool(pres_row[col])
                        else:
                            col = lay.slots.get(item)
                            if col is not None:
                                presence[item] = bool(pres_row[col])
                            else:
                                mcol = lay.map_slots.get(item)
                                if mcol is not None:
                                    presence[item] = bool(mp_row[mcol])
                    shared.append((tuple(sorted(referenced, key=str)),
                                   presence))
                ref_of = [shared[i] for i in inverse]
            elif plan.unmapped_instance_attrs:
                # no layout items at all, but some rules still carry
                # instance attrs — merge them per row
                ref_of = []
                for b in range(n_real):
                    referenced: set = set()
                    for ridx, extra in plan.unmapped_instance_attrs.items():
                        if active_sub[b, col_pos[ridx]]:
                            referenced |= extra
                    ref_of.append((tuple(sorted(referenced, key=str)), {}))
            t_respond = time.perf_counter()
            if observe:
                monitor.observe_stage("fold", t_respond - t_overlay)
            tele = plan.telemetry if observe else None
            # the canary recorder shares the span so its samples join
            # the batch's trace
            tele_span = tr._current() \
                if tele is not None or self.recorder is not None else None
            # check-cache grants: one (ttl, uses) pair per distinct
            # namespace, min-folded into every response, allow and deny
            grant_of = self._grants_for_rows(ns_ids)
            out = []
            for b, bag in enumerate(bags):
                resp = CheckResponse()
                resp.valid_duration_s = min(resp.valid_duration_s,
                                            float(dur[b]))
                resp.valid_use_count = min(resp.valid_use_count, int(uses[b]))
                dev_rule = int(deny_rule[b])
                dev_applied = False
                host_active = ha[active_sub[b, ha_pos]] if len(ha) else ()
                pend = host_pending[b] if host_pending is not None else None
                pi = 0
                for ridx in host_active:
                    ridx = int(ridx)
                    # ties at ridx == dev_rule follow the rule's config
                    # action order: if its first CHECK action is fused, the
                    # device result applies before the host actions
                    if not dev_applied and (
                            ridx > dev_rule or
                            (ridx == dev_rule and
                             dev_rule in plan.fused_first_rules)):
                        self._apply_device_status(resp, plan, dev_rule,
                                                  int(status[b]))
                        dev_applied = True
                    if pend is not None:
                        # claim this rule's pre-submitted results, each
                        # wait bounded by the batch deadline: one that
                        # does not resolve answers its fail policy
                        while pi < len(pend) and pend[pi][0] == ridx:
                            item = pend[pi][1]
                            pi += 1
                            result = item if isinstance(item, CheckResult) \
                                else ex.resolve(item, deadline)
                            self._combine(resp, result)
                        continue
                    for hc, template, inst_names in plan.host_actions[ridx]:
                        handler = self._handler_for(hc)
                        if handler is None:
                            continue
                        for iname in inst_names:
                            ib = snap.instances[iname]
                            result = self._safe_check(handler, template,
                                                      ib, bag)
                            self._combine(resp, result)
                if not dev_applied:
                    self._apply_device_status(resp, plan, dev_rule,
                                              int(status[b]))
                if status[b] != OK:
                    resp.deny_rule = dev_rule
                    if tele is not None:
                        tele.sample(dev_rule, int(status[b]), bag, tele_span)
                if ref_of is not None:
                    resp.referenced, resp.referenced_presence = ref_of[b]
                if qa_rules:
                    resp.active_quota_rules = tuple(
                        r for r, p in zip(qa_rules, qa_pos)
                        if active_sub[b, p])
                    resp.quota_context = self
                else:
                    resp.active_quota_rules = ()
                if grant_of is not None:
                    g_ttl, g_uses = grant_of[b]
                    resp.valid_duration_s = min(resp.valid_duration_s,
                                                g_ttl)
                    resp.valid_use_count = min(resp.valid_use_count,
                                               g_uses)
                out.append(resp)
            if observe:
                monitor.observe_stage("respond",
                                      time.perf_counter() - t_respond)
                tr.emit("serve.overlay", time.perf_counter() - t_overlay,
                        batch=len(bags))
            if self.recorder is not None:
                # canary tap: bags / out are padding-trimmed; one stride
                # check a batch, a bounded append a sampled row. The
                # DEVICE planes are recorded, not the merged responses:
                # the shadow replay runs no host adapter and no grant
                self.recorder.tap(bags, out, snap, self.identity_attr,
                                  tele_span,
                                  device=(status, dur, uses, deny_rule))
            return out
        except BaseException:
            if host_pending is not None:
                for row in host_pending:
                    for _ridx, item in row:
                        if not isinstance(item, CheckResult):
                            ex.abandon(item)
            raise

    @staticmethod
    def _apply_device_status(resp: CheckResponse, plan, dev_rule: int,
                             dev_status: int) -> None:
        """Merge the device verdict like one more adapter result."""
        if dev_status == OK:
            return
        if resp.status_code == OK:
            resp.status_code = dev_status
            resp.status_message = plan.message_for(dev_rule, dev_status)
        else:
            resp.status_message = (resp.status_message + "; " +
                                   plan.message_for(dev_rule, dev_status)
                                   ).strip("; ")

    def check_host_oracle(self, bags: Sequence[Bag],
                          deadline: float | None = None
                          ) -> list[CheckResponse]:
        """Graceful-degradation check path: resolve every rule on the
        CPU via the whole-snapshot oracle and run the generic host
        adapter loop — no device step anywhere."""
        from istio_tpu_torch.runtime.batcher import trim_pads

        bags = trim_pads(list(bags))
        oracle = self._oracle()
        out: list[CheckResponse] = []
        n_err = 0
        for bag in bags:
            ns = _namespace_of(bag, self.identity_attr)
            active, visible, errs = oracle.resolve(bag, ns)
            n_err += errs
            out.append(self._check_one(bag, active, visible))
        self._apply_grants(bags, out)
        if n_err:
            monitor.RESOLVE_ERRORS.inc(n_err)
        return out

    def _oracle(self):
        """Lazily-built whole-snapshot oracle, cached per dispatcher,
        seeded with the ruleset's host-fallback programs. Only CONFIG
        rules participate."""
        cached = getattr(self, "_snapshot_oracle", None)
        if cached is None:
            from istio_tpu_torch.compiler.ruleset import SnapshotOracle
            rs = self.snapshot.ruleset
            n_cfg = len(self.snapshot.rules)
            cached = SnapshotOracle(
                rs.rules[:n_cfg], self.snapshot.finder,
                seed={r: p for r, p in rs.host_fallback.items()
                      if r < n_cfg})
            self._snapshot_oracle = cached
        return cached

    def _check_one(self, bag: Bag, rule_idxs: list[int],
                   visible: list[int]) -> CheckResponse:
        snap = self.snapshot
        resp = CheckResponse()
        # ReferencedAttributes: every namespace-visible rule's predicate
        # was EVALUATED for this request; matched rules add their
        # instances' attribute uses below
        referenced: set = set()
        for ridx in visible:
            referenced |= snap.ruleset.attr_names[ridx]
        for ridx in rule_idxs:
            for hc, template, inst_names in snap.actions_for(
                    ridx, Variety.CHECK):
                handler = self._handler_for(hc)
                if handler is None:
                    continue
                for iname in inst_names:
                    ib = snap.instances[iname]
                    referenced |= ib.referenced_attrs
                    result = self._safe_check(handler, template, ib, bag)
                    self._combine(resp, result)
        resp.referenced = tuple(sorted(referenced, key=str))
        return resp

    @staticmethod
    def _bound_check(handler: Handler, template: str, instance) -> Any:
        """The zero-argument adapter call of one CHECK action on the
        executor: _safe_check's dispatch leg. A failing action's
        dispatch error is counted once, by check_fallback."""
        def call():
            with monitor.dispatch_timer():
                return handler.handle_check(template, instance)
        return call

    @staticmethod
    def _bound_quota(handler: Handler, template: str, instance,
                     args: QuotaArgs) -> Any:
        def call():
            with monitor.dispatch_timer():
                return handler.handle_quota(template, instance, args)
        return call

    def _safe_check(self, handler: Handler, template: str, ib,
                    bag: Bag) -> CheckResult:
        with monitor.dispatch_timer():
            try:
                instance = ib.build(bag)
            except EvalError as exc:
                monitor.DISPATCH_ERRORS.inc()
                return CheckResult(status_code=INTERNAL,
                                   status_message=str(exc))
            try:
                return handler.handle_check(template, instance)
            except Exception as exc:   # safeDispatch (dispatcher.go:399)
                monitor.DISPATCH_ERRORS.inc()
                log.exception("adapter check failed")
                return CheckResult(status_code=INTERNAL,
                                   status_message=f"adapter panic: {exc}")

    @staticmethod
    def _combine(resp: CheckResponse, r: CheckResult) -> None:
        """combineResults (dispatcher.go:322): worst status, min TTLs."""
        if not r.ok and resp.status_code == OK:
            resp.status_code = r.status_code
            resp.status_message = r.status_message
        elif not r.ok:
            resp.status_message = \
                f"{resp.status_message}; {r.status_message}".strip("; ")
        resp.valid_duration_s = min(resp.valid_duration_s,
                                    r.valid_duration_s)
        resp.valid_use_count = min(resp.valid_use_count,
                                   r.valid_use_count)

    def report(self, bags: Sequence[Bag]) -> None:
        """Resolve the active REPORT rules of every record and hand each
        action's instances to its adapter, record by record in rule
        order. On the fused path the instances of lowered specs come off
        the packed report pull (ReportFieldCtx); the rest build on the
        host. A device-invalid field, like a host EvalError, aborts that
        record's instance and counts a dispatch error."""
        from istio_tpu_torch.runtime.batcher import trim_pads

        # padding rows carry no caller and must not fire empty-match
        # report rules
        bags = trim_pads(bags)
        if not bags:
            return
        fctx = None
        if self.fused is not None:
            if not self.fused.report_rules:
                return      # no REPORT rules configured: nothing to do
            actives, fctx = self._report_active_fused(bags)
        else:
            actives, _ = self._resolve(bags)
        rl = self.fused.report_lowering if self.fused is not None \
            else None
        observe = self.observe
        # adapter_dispatch accumulates ONLY handle_report wall time: host
        # instance builds for unlowerable instances run in this loop too
        adapter_s = 0.0
        tmpl_records: dict[str, int] = {}
        for b, (bag, rule_idxs) in enumerate(zip(bags, actives)):
            for ridx in rule_idxs:
                for hc, template, inst_names in self.snapshot.actions_for(
                        ridx, Variety.REPORT):
                    handler = self._handler_for(hc)
                    if handler is None:
                        continue
                    instances = []
                    for iname in inst_names:
                        if fctx is not None and iname in rl.specs:
                            inst = fctx.materialize(iname, b)
                            if inst is None:
                                # device-invalid field: the EvalError
                                # abort, same accounting as the host
                                monitor.DISPATCH_ERRORS.inc()
                                log.warning("instance %s: field "
                                            "evaluation failed", iname)
                            else:
                                instances.append(inst)
                            continue
                        try:
                            instances.append(
                                self.snapshot.instances[iname].build(bag))
                        except EvalError as exc:
                            monitor.DISPATCH_ERRORS.inc()
                            log.warning("instance %s: %s", iname, exc)
                    if not instances:
                        continue
                    t_h = time.perf_counter()
                    failed = False
                    with monitor.dispatch_timer():
                        try:
                            handler.handle_report(template, instances)
                        except Exception:
                            failed = True
                            monitor.DISPATCH_ERRORS.inc()
                            log.exception("adapter report failed")
                    adapter_s += time.perf_counter() - t_h
                    if observe:
                        monitor.note_adapter_export(
                            _qualify(hc.name, hc.namespace), len(instances),
                            error=failed)
                        if not failed:
                            tmpl_records[template] = \
                                tmpl_records.get(template, 0) + \
                                len(instances)
        if observe:
            if adapter_s > 0 or tmpl_records:
                monitor.observe_report_stage("adapter_dispatch", adapter_s)
            for template, n in tmpl_records.items():
                monitor.REPORT_TEMPLATE_RECORDS.inc(n, template=template)

    def _report_active_fused(self, bags: Sequence[Bag]
                             ) -> tuple[list[list[int]], Any]:
        """Per-bag ACTIVE REPORT-rule indices via the fused packed step:
        one device trip and one pull of the bitpacked overlay plane per
        chunk. Record counts pad to the prewarmed serving bucket shapes,
        and oversize batches run in largest-bucket chunks. When the
        snapshot's report instances lowered, the same pull carries every
        instance-field value/valid row (packed_report); the returned
        ReportFieldCtx materializes finished instances."""
        from istio_tpu_torch.runtime.batcher import pad_to_bucket
        from istio_tpu_torch.runtime.report_lower import ReportFieldCtx

        plan = self.fused
        rl = plan.report_lowering
        fctx = ReportFieldCtx(rl, self.snapshot.ruleset.interner) \
            if rl is not None else None
        # field rows live after the head + ref-bit + overlay words
        base = 5 + plan.n_ref_words + plan.n_overlay_words
        rcols = None
        cap = self.buckets[-1] if self.buckets else len(bags) or 1
        out: list[list[int]] = []
        observe = self.observe
        for lo in range(0, len(bags), cap):
            chunk = bags[lo:lo + cap]
            padded = pad_to_bucket(chunk, self.buckets) \
                if self.buckets else chunk
            with monitor.resolve_timer():
                t_tz = time.perf_counter()
                batch, ns_ids = self._tensorize_for_device(padded)
                t_dev = time.perf_counter()
                packed = plan.packed_report(batch, ns_ids) \
                    if rl is not None \
                    else plan.packed_check(batch, ns_ids, observe=False)
                t_done = time.perf_counter()
                if observe:
                    monitor.observe_report_stage("tensorize", t_dev - t_tz)
                    monitor.observe_report_stage("device_field_eval",
                                                 t_done - t_dev)
            active_sub, col_pos = self._overlay_active(
                packed, chunk, ns_ids[:len(chunk)])
            if rcols is None:
                rcols = [(ridx, col_pos[ridx])
                         for ridx in sorted(plan.report_rules)
                         if ridx in col_pos]
            t_dec = time.perf_counter()
            if fctx is not None:
                # skip the unique-id decode for chunks with no active
                # report rule anywhere — their planes are never read
                any_active = bool(rcols) and bool(
                    active_sub[:, [p for _, p in rcols]].any())
                fctx.add_chunk(packed, base, len(chunk), batch,
                               decode=any_active)
                if observe:
                    monitor.observe_report_stage(
                        "intern_decode", time.perf_counter() - t_dec)
            out.extend(
                [ridx for ridx, pos in rcols if active_sub[b, pos]]
                for b in range(len(chunk)))
        if fctx is not None:
            fctx.seal()
        return out, fctx

    def quota(self, bag: Bag, quota_name: str, args: QuotaArgs,
              deadline: float | None = None) -> QuotaResult:
        """The host quota path: dispatches to at most ONE handler
        (dispatcher.go:242-260). With an executor the adapter call runs
        on its handler's lane, bounded by `deadline`; inline
        otherwise."""
        actives = self._resolve([bag])[0][0]
        for ridx in actives:
            for hc, template, inst_names in self.snapshot.actions_for(
                    ridx, Variety.QUOTA):
                for iname in inst_names:
                    if iname.split(".")[0] != quota_name and \
                            iname != quota_name:
                        continue
                    handler = self._handler_for(hc)
                    if handler is None:
                        continue
                    try:
                        instance = self.snapshot.instances[iname].build(bag)
                    except EvalError as exc:
                        monitor.DISPATCH_ERRORS.inc()
                        return QuotaResult(granted_amount=0,
                                           status_code=INTERNAL,
                                           status_message=str(exc))
                    except Exception as exc:
                        # safeDispatch parity: a malformed attribute
                        # value degrades to a typed INTERNAL denial
                        monitor.DISPATCH_ERRORS.inc()
                        log.exception("quota instance build failed")
                        return QuotaResult(granted_amount=0,
                                           status_code=INTERNAL,
                                           status_message=str(exc))
                    ex = self.executor
                    if ex is not None:
                        from istio_tpu_torch.runtime.executor import \
                            quota_fallback
                        amount = args.quota_amount
                        act = ex.submit(
                            _qualify(hc.name, hc.namespace),
                            self._bound_quota(handler, template, instance,
                                              args),
                            lambda policy, reason, _a=amount:
                                quota_fallback(policy, reason, _a))
                        return ex.resolve(act, deadline)
                    try:
                        with monitor.dispatch_timer():
                            return handler.handle_quota(template, instance,
                                                        args)
                    except Exception as exc:
                        monitor.DISPATCH_ERRORS.inc()
                        log.exception("adapter quota failed")
                        return QuotaResult(granted_amount=0,
                                           status_code=INTERNAL,
                                           status_message=str(exc))
        # no matching quota rule: grant freely (reference returns empty)
        return QuotaResult(granted_amount=args.quota_amount)

    def preprocess(self, bag: Bag) -> Bag:
        """APA phase (dispatcher.go:285): run ATTRIBUTE_GENERATOR
        actions, bind outputs into a child bag. The resolve is one
        device trip for the one bag (rule_match and the literal
        kernels its world has)."""
        actives = self._resolve([bag])[0][0]
        child = MutableBag(parent=bag)
        for ridx in actives:
            for hc, template, inst_names in self.snapshot.actions_for(
                    ridx, Variety.ATTRIBUTE_GENERATOR):
                handler = self._handler_for(hc)
                if handler is None:
                    continue
                for iname in inst_names:
                    ib = self.snapshot.instances[iname]
                    try:
                        instance = ib.build(bag)
                        outputs = handler.generate_attributes(template,
                                                              instance)
                    except EvalError as exc:
                        monitor.DISPATCH_ERRORS.inc()
                        log.warning("APA %s: %s", iname, exc)
                        continue
                    except Exception:
                        monitor.DISPATCH_ERRORS.inc()
                        log.exception("APA adapter failed")
                        continue
                    bindings = getattr(ib, "attribute_bindings", None)
                    if bindings:
                        for attr, ref in bindings.items():
                            key = str(ref).removeprefix("$out.")
                            if key in outputs:
                                child.set(attr, outputs[key])
                    else:
                        for key, value in outputs.items():
                            child.set(key.replace("_", "."), value)
        return child
