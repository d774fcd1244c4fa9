"""K13: the verdict fold of a dp × mp sharded check step (the mesh entry
points of csrc/verdict_fold.cu, on the unsharded fold's row-fold body).

Under a mesh each (dp, mp) shard holds matched / err [B/dp, R/mp]: its
rows' slice of the rule axis. `mesh_fold` reduces over that axis with
the mesh_fold kernel's three entry points, each on the stream of the
virtual device it runs for:

  mesh_partial  per (dp, mp) shard: the row fold on the shard's rule
                slice → a partial record per row
  mesh_combine  per dp shard: the records over mp → status, TTLs,
                deny_rule, referenced, the error count, quota keys
  mesh_quota    per dp replica (only with quotas): the keys of every dp
                shard gathered, the whole batch ranked, every grant
                committed into the replica's counters (one launch up to
                the rows one cluster holds, policy_engine.quota_plan)

The records of a dp shard's mp partials are written straight into one
buffer on that shard's device when they share its physical device, and
copied there otherwise. `mesh_fold_plain` gathers matched, err and the
list states over the mesh and runs the unsharded plain fold
(models/policy_engine.verdict_fold_plain) on the whole batch; the CPU
runs it, a card never does. `partial_record` is one shard's mesh_partial
step alone, whose plain version is the word fold over the shard's
window (models/policy_engine.verdict_fold_words_plain with `window`);
`combine_records` is the mesh_combine and mesh_quota steps alone over
given records, whose plain version is combine_fold_records; `mesh_quota`
is the quota step alone over given key columns, whose plain versions are
policy_engine.quota_grant_plain (the kernel's formulation) and the
reference's rank (verdict_fold_plain's batch_rank).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.compiler.layout import AttributeBatch
from istio_tpu_torch.models.policy_engine import (REC_ROWS, FoldConsts,
                                                  check_plane_pair,
                                                  combine_fold_records,
                                                  check_word_tables,
                                                  quota_grant_plain,
                                                  quota_plan,
                                                  verdict_fold_plain,
                                                  verdict_fold_words_plain)
from istio_tpu_torch.platform import VirtualDevice, fork, handed_over


@dataclasses.dataclass
class FoldPart:
    """One (dp, mp) shard's input to the fold, on its virtual device."""
    vdev: VirtualDevice
    r0: int                       # global index of the slice's first rule
    matched: torch.Tensor         # bool [B/dp, Rm]
    err: torch.Tensor             # bool [B/dp, Rm]
    lstate: torch.Tensor | None   # uint8 [B/dp, NL]: this slice's lists
    req_ns: torch.Tensor          # int32 [B/dp]
    batch: AttributeBatch         # the dp shard's rows
    params: Mapping[str, torch.Tensor]   # on vdev.device
    list_kind: torch.Tensor | None = None   # uint8 [NL], with lstate


def gather_plane(parts: list[list[FoldPart]], field: str,
                 device: torch.device) -> torch.Tensor:
    """The [B, R] plane `field` (matched or err) of the whole mesh on
    `device`, rows in dp order, rule columns in mp order."""
    rows = [torch.cat([getattr(p, field).to(device) for p in row], dim=1)
            if len(row) > 1 else getattr(row[0], field).to(device)
            for row in parts]
    return torch.cat(rows) if len(rows) > 1 else rows[0]


def gather_lstate(parts: list[list[FoldPart]], device: torch.device
                  ) -> torch.Tensor | None:
    """The [B, NL] list states of the whole mesh: each list's byte comes
    from the one mp shard that holds its rule (zero on the others)."""
    if parts[0][0].lstate is None:
        return None
    rows = []
    for row in parts:
        acc = row[0].lstate.to(device)
        for p in row[1:]:
            acc = acc | p.lstate.to(device)
        rows.append(acc)
    return torch.cat(rows)


def mesh_fold_plain(parts: list[list[FoldPart]],
                    params: Mapping[str, torch.Tensor],
                    quota_counts: torch.Tensor, c: FoldConsts,
                    list_kind: torch.Tensor | None,
                    device: torch.device) -> tuple[torch.Tensor, ...]:
    """Plain version of the mesh_fold kernel: matched, err and the list
    states gathered over the mesh onto `device`, then the unsharded
    plain fold on the whole batch (quota_counts updated in place) →
    (status, dur, uses, deny_rule, referenced, err_count)."""
    matched = gather_plane(parts, "matched", device)
    err = gather_plane(parts, "err", device)
    lstate = gather_lstate(parts, device)
    req = torch.cat([row[0].req_ns.to(device) for row in parts])
    batch = AttributeBatch.cat([row[0].batch for row in parts], device)
    return verdict_fold_plain(matched, err, req, batch, params, quota_counts,
                              c, lstate,
                              list_kind if lstate is not None else None)


_K = kernels
_PARTIAL_ARGS = ([_K.VP, _K.VP, _K.VP] + [_K.I32] * 4       # planes, geometry
                 + [_K.VP, _K.I32] + [_K.VP] * 5            # word tables, deny
                 + [_K.I32, _K.I32] + [_K.VP] * 9           # lists
                 + [_K.I32, _K.I32] + [_K.VP] * 3           # rbac
                 + [_K.VP, _K.VP, _K.I32]                   # batch planes
                 + [_K.I32, _K.VP] + [_K.VP, _K.VP, _K.VP])  # quota, outs
_COMBINE_ARGS = ([_K.I32, _K.VP, _K.VP, _K.I32, _K.VP, _K.VP]
                 + [_K.I32, _K.VP, _K.VP]                   # rbac
                 + [_K.VP, _K.VP, _K.I32, _K.I32, _K.I32, _K.VP, _K.VP]
                 + [_K.VP, _K.I32, _K.I32, _K.I32]          # ref table
                 + [_K.VP] * 7 + [_K.VP])                   # outs, stream
_QUOTA_ARGS = ([_K.VP] + [_K.I32] * 4 + [_K.VP] * 5 + [_K.I32] * 5
               + [_K.VP, _K.VP])


def partial_record(p: FoldPart, n_rows: int, c: FoldConsts, n_q: int,
                   rec: torch.Tensor | None = None,
                   flags: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Shard p's partial record over its rule slice [p.r0, p.r0 + Rm) of
    n_rows rules, the mesh_partial step of mesh_fold alone (mesh_fold
    counts its launches; this counts none) → (rec int32 [REC_ROWS, Bd],
    flags uint8 [Bd, max(NRB + Q, 1)], `__global__` launches), written
    into rec / flags when given, on the current stream of p's device.
    CPU tensors run verdict_fold_words_plain over the window (flags
    [Bd, NRB + Q], no launch)."""
    pm = p.params
    lk = p.list_kind if p.lstate is not None else None
    rm = int(p.matched.shape[1])
    if p.matched.device.type == "cpu":
        rec_p, flags_p = verdict_fold_words_plain(
            p.matched, p.err, p.req_ns, p.batch, pm, None, c, p.lstate, lk,
            window=(p.r0, p.r0 + rm))
        return rec_p, flags_p, 0
    bd = int(p.matched.shape[0])
    n_lists = int(pm["pe_list_rule"].shape[0]) if c.has_lists else 0
    n_rbac = int(pm["pe_rb_rule"].shape[0]) if c.has_rbac else 0
    n_flags = max(n_rbac + n_q, 1)
    check_word_tables("mesh_partial", pm, n_rows, p.matched.device)
    check_plane_pair("mesh_partial", p.matched, p.err)
    if rec is None:
        rec = torch.empty((REC_ROWS, bd), dtype=torch.int32,
                          device=p.matched.device)
    if flags is None:
        flags = torch.empty((bd, n_flags), dtype=torch.uint8,
                            device=p.matched.device)
    p_ = kernels.ptr
    null = kernels.VP(0)
    fn = kernels.function("mesh_fold", "mesh_partial", _PARTIAL_ARGS)
    rc = fn(p_(p.matched), p_(p.err), p_(p.req_ns), bd, rm, p.r0, n_rows,
            p_(pm["pe_vis_ns"]), int(pm["pe_vis_ns"].shape[0]),
            p_(pm["pe_vis_words"]), p_(pm["pe_deny_words"]),
            p_(pm["pe_err_words"]), p_(pm["pe_deny_dur"]),
            p_(pm["pe_deny_uses"]),
            n_lists, int(pm["pe_list_ids"].shape[1]),
            p_(pm["pe_list_ids"]), p_(pm["pe_list_rule"]),
            p_(pm["pe_list_slot"]), p_(pm["pe_list_black"]),
            p_(pm["pe_list_code"]), p_(pm["pe_list_dur"]),
            p_(pm["pe_list_uses"]),
            null if lk is None else p_(lk),
            null if p.lstate is None else p_(p.lstate),
            n_rbac, int(pm["pe_rb_allow"].shape[1]),
            p_(pm["pe_rb_rule"]), p_(pm["pe_rb_guard"]),
            p_(pm["pe_rb_allow"]),
            p_(p.batch.ids), p_(p.batch.present),
            int(p.batch.ids.shape[1]), n_q, p_(pm["pe_q_rule"]),
            p_(rec), p_(flags), kernels.VP(kernels.stream_ptr()))
    return rec, flags, kernels.check(rc, "mesh_fold")


def _same_phys(a: VirtualDevice, b: VirtualDevice) -> bool:
    return a.device == b.device


def _combine(rec: torch.Tensor, flags: torch.Tensor, req_ns: torch.Tensor,
             batch: AttributeBatch, pm: Mapping[str, torch.Tensor],
             n_rbac: int, n_q: int, n_buckets: int, c: FoldConsts
             ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor, int]:
    """One dp shard's mesh_combine launch on the current stream over its
    records rec int32 [MP, REC_ROWS, Bd] and flags uint8 [MP, Bd, NRB +
    Q] (any width where NRB + Q is 0: none is read) → ((status, dur, uses,
    deny_rule, referenced, err_count), ckey int32 [max(Q, 1), Bd],
    `__global__` launches)."""
    dev = rec.device
    mp, bd = int(rec.shape[0]), int(rec.shape[2])
    table = pm["pe_ref_table"]
    o = (torch.empty(bd, dtype=torch.int32, device=dev),
         torch.empty(bd, dtype=torch.float32, device=dev),
         torch.empty(bd, dtype=torch.int32, device=dev),
         torch.empty(bd, dtype=torch.int32, device=dev),
         torch.empty((bd, c.n_attr_cols), dtype=torch.bool, device=dev),
         torch.zeros((), dtype=torch.int32, device=dev))
    ckey = torch.empty((max(n_q, 1), bd), dtype=torch.int32, device=dev)
    p_ = kernels.ptr
    fn = kernels.function("mesh_fold", "mesh_combine", _COMBINE_ARGS)
    rc = fn(mp, p_(rec), p_(flags), bd, p_(req_ns),
            p_(pm["pe_deny_status"]), n_rbac, p_(pm["pe_rb_rule"]),
            p_(pm["pe_rb_dur"]), p_(batch.present), p_(batch.hash_ids),
            int(batch.ids.shape[1]), n_q, n_buckets, p_(pm["pe_q_slot"]),
            p_(pm["pe_q_nb"]), p_(table), int(table.shape[0]),
            int(table.shape[1]), c.n_attr_cols, *(p_(t) for t in o),
            p_(ckey), kernels.VP(kernels.stream_ptr()))
    return o, ckey, kernels.check(rc, "mesh_fold")


def mesh_quota(keys: torch.Tensor, q_max: torch.Tensor,
               q_rule: torch.Tensor, counts: torch.Tensor, row0: int,
               status: torch.Tensor, deny_rule: torch.Tensor) -> int:
    """One dp replica's quota rank / grant / commit (mesh_fold's quota
    step alone; mesh_fold counts its launches, this counts none) over
    the gathered keys int32 [Q, B] (< 0 inactive, column q's keys inside
    row q of counts [Q, NB]): every grant committed into counts in
    place, RESOURCE_EXHAUSTED and the lowest over-limit rule on status /
    deny_rule int32 [Bd], the rows from row0, on the current stream under
    policy_engine.quota_plan(B) → `__global__` launches. CPU tensors run
    quota_grant_plain (no launch)."""
    if keys.device.type == "cpu":
        quota_grant_plain(keys, counts, q_max, q_rule, status, deny_rule,
                          row0)
        return 0
    n_q, b = int(keys.shape[0]), int(keys.shape[1])
    for name, t in (("keys", keys), ("q_max", q_max), ("q_rule", q_rule),
                    ("counts", counts), ("status", status),
                    ("deny_rule", deny_rule)):
        if t.device != keys.device or t.dtype != torch.int32 or \
                not t.is_contiguous():
            raise ValueError(f"mesh_quota: {name} must be a contiguous "
                             f"int32 tensor on {keys.device}")
    if counts.dim() != 2 or int(counts.shape[0]) < n_q or \
            int(q_max.numel()) < n_q or int(q_rule.numel()) < n_q or \
            tuple(deny_rule.shape) != tuple(status.shape) or \
            not 0 <= row0 <= b - int(status.shape[0]):
        raise ValueError("mesh_quota: counts / q_max / q_rule / status do "
                         f"not fit {n_q} quotas x {b} rows from {row0}")
    plan = quota_plan(b)
    scratch = torch.empty(max(plan.scratch_words(n_q), 1),
                          dtype=torch.int32, device=keys.device)
    p_ = kernels.ptr
    fn = kernels.function("mesh_fold", "mesh_quota", _QUOTA_ARGS)
    rc = fn(p_(keys), b, n_q, row0, int(status.shape[0]), p_(q_max),
            p_(q_rule), p_(counts), p_(status), p_(deny_rule), *plan.args,
            p_(scratch), kernels.VP(kernels.stream_ptr()))
    return kernels.check(rc, "mesh_fold")


def combine_records(rec: torch.Tensor, flags: torch.Tensor,
                    req_ns: torch.Tensor, batch: AttributeBatch,
                    params: Mapping[str, torch.Tensor],
                    quota_counts: torch.Tensor, c: FoldConsts
                    ) -> tuple[torch.Tensor, ...]:
    """The verdict of one row block from its records over MP windows,
    rec int32 [MP, REC_ROWS, B] and flags uint8 [MP, B, NRB + Q]: the
    mesh_combine and (with quotas) mesh_quota steps of mesh_fold alone,
    as one dp shard of a one-row-block mesh, on the current stream
    (mesh_fold counts its launches; this counts none) → (status, dur,
    uses, deny_rule, referenced, err_count), quota_counts updated in
    place. CPU tensors run combine_fold_records."""
    n_rbac = int(params["pe_rb_rule"].shape[0]) if c.has_rbac else 0
    n_q = int(quota_counts.shape[0]) if c.has_quota else 0
    if rec.device.type == "cpu":
        return combine_fold_records(list(rec), list(flags), req_ns, batch,
                                    params, quota_counts, c)
    if rec.dtype != torch.int32 or flags.dtype != torch.uint8 or \
            rec.shape[1] != REC_ROWS or tuple(flags.shape) != \
            (rec.shape[0], rec.shape[2], n_rbac + n_q):
        raise ValueError("combine_records: rec must be int32 [MP, "
                         f"{REC_ROWS}, B] and flags uint8 [MP, B, NRB + Q]")
    o, ckey, _ = _combine(rec.contiguous(), flags.contiguous(), req_ns,
                          batch, params, n_rbac, n_q,
                          int(quota_counts.shape[1]), c)
    if n_q:
        mesh_quota(ckey, params["pe_q_max"], params["pe_q_rule"],
                   quota_counts, 0, o[0], o[3])
    return o


def mesh_fold(parts: list[list[FoldPart]], params: Mapping[str, torch.Tensor],
              quota_counts: torch.Tensor, c: FoldConsts,
              list_kind: torch.Tensor | None,
              device: torch.device) -> tuple[torch.Tensor, ...]:
    """The verdict fold of a sharded step: parts[d][m] is shard (d, m);
    `params` / `quota_counts` / `list_kind` on `device` (the mesh's home,
    where the outputs land, the caller's current stream there ordering
    them). → (status [B], dur, uses, deny_rule, referenced [B, n_attr],
    err_count []) on `device`; quota_counts updated in place (every dp
    replica commits every grant of the batch into its own copy; replica
    0's is written back). CPU tensors run mesh_fold_plain."""
    types = {p.matched.device.type for row in parts for p in row}
    if types == {"cpu"}:
        return mesh_fold_plain(parts, params, quota_counts, c, list_kind,
                               device)
    if types != {"cuda"} or device.type != "cuda":
        raise ValueError(f"mesh_fold: shards on {sorted(types)}, home "
                         f"{device}")
    dp, mp = len(parts), len(parts[0])
    bd = int(parts[0][0].matched.shape[0])
    b = bd * dp
    n_rows = int(params["pe_deny_dur"].shape[0])
    n_lists = int(params["pe_list_rule"].shape[0]) if c.has_lists else 0
    n_q = int(quota_counts.shape[0]) if c.has_quota else 0
    n_rbac = int(params["pe_rb_rule"].shape[0]) if c.has_rbac else 0
    n_flags = n_rbac + n_q
    width = 0
    for row in parts:
        for p in row:
            rm = int(p.matched.shape[1])
            if tuple(p.matched.shape) != (bd, rm) or \
                    tuple(p.err.shape) != (bd, rm) or \
                    p.matched.dtype != torch.bool or \
                    p.err.dtype != torch.bool or \
                    not p.matched.is_contiguous() or \
                    not p.err.is_contiguous():
                raise ValueError("mesh_fold: each shard's matched / err must "
                                 f"be contiguous bool [{bd}, Rm]")
            if p.lstate is not None and (tuple(p.lstate.shape) !=
                                         (bd, n_lists)):
                raise ValueError("mesh_fold: lstate does not fit the lists")
            width += rm
    if width != n_rows * dp:
        raise ValueError(f"mesh_fold: rule slices cover {width // dp} of "
                         f"{n_rows} rules")
    captured = kernels.launches.captured is not None
    before = quota_counts.clone() if captured else None
    cur, ev0 = fork(device)
    p_ = kernels.ptr
    grids = 0
    recs, flags, ev_part = [], [], []
    # ---- partials: one launch per (dp, mp) shard on its own stream
    for row in parts:
        home = row[0].vdev
        with home.scope():
            rec = torch.empty((mp, REC_ROWS, bd), dtype=torch.int32,
                              device=home.device)
            flg = torch.empty((mp, bd, max(n_flags, 1)), dtype=torch.uint8,
                              device=home.device)
        recs.append(rec)
        flags.append(flg)
        evs = []
        for m, p in enumerate(row):
            vd = p.vdev
            vd.wait(ev0)
            with vd.scope():
                local = _same_phys(vd, home)
                out_r = handed_over(rec[m], vd.stream) if local else \
                    torch.empty((REC_ROWS, bd), dtype=torch.int32,
                                device=vd.device)
                out_f = handed_over(flg[m], vd.stream) if local else \
                    torch.empty((bd, max(n_flags, 1)), dtype=torch.uint8,
                                device=vd.device)
                grids += partial_record(p, n_rows, c, n_q, out_r,
                                        out_f)[2]
                if not local:      # the transport: a copy onto dp's device
                    rec[m].copy_(out_r, non_blocking=True)
                    flg[m].copy_(out_f, non_blocking=True)
                evs.append(vd.record())
        ev_part.append(evs)
    # ---- combine: one launch per dp shard on its first device's stream
    outs, ckeys, ev_comb = [], [], []
    for d, row in enumerate(parts):
        home, p = row[0].vdev, row[0]
        for ev in ev_part[d]:
            home.wait(ev)
        with home.scope():
            o, ckey, g = _combine(recs[d], flags[d], p.req_ns, p.batch,
                                  p.params, n_rbac, n_q,
                                  int(quota_counts.shape[1]), c)
            grids += g
            ev_comb.append(home.record())
        outs.append(o)
        ckeys.append(ckey)
    finals = ev_comb
    replica0 = None
    # ---- quota: every dp replica ranks the whole batch
    if n_q:
        finals = []
        for d, row in enumerate(parts):
            home, pm = row[0].vdev, row[0].params
            home.wait(ev0)
            for ev in ev_comb:
                home.wait(ev)
            with home.scope():
                keys = torch.cat([handed_over(k, home.stream).to(home.device)
                                  for k in ckeys], dim=1)
                counts = quota_counts.to(home.device, copy=True)
                grids += mesh_quota(keys, pm["pe_q_max"], pm["pe_q_rule"],
                                    counts, d * bd, outs[d][0], outs[d][3])
                finals.append(home.record())
            if d == 0:
                replica0 = counts
    # ---- join on the caller's stream and gather the dp outputs
    for ev in finals:
        if ev is not None:
            cur.wait_event(ev)
    gathered = []
    for i in range(5):
        ts = [handed_over(o[i], cur).to(device) for o in outs]
        gathered.append(torch.cat(ts) if len(ts) > 1 else ts[0])
    err_count = torch.stack([handed_over(o[5], cur).to(device)
                             for o in outs]).sum(dtype=torch.int32)
    if replica0 is not None:
        quota_counts.copy_(handed_over(replica0, cur))
    kernels.launched("mesh_fold", grids, parts, params, before, c, list_kind,
                     device)
    return (*gathered, err_count)
