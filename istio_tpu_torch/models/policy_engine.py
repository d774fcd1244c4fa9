"""PolicyEngine — the fused batched Check()/Quota() step on the card.

Port of istio_tpu/models/policy_engine.py. For a batch of B requests:

    ruleset match          rule_match kernel (+ dfa_scan, byte_pred)  [B, R]
    × namespace mask  ┐
    deny actions      │
    listentry (STRINGS)│   verdict_fold kernel (csrc/verdict_fold.cu)
    quota rank+grant  │   → status / TTLs / deny_rule / err_count,
    referenced attrs  ┘     quota counters updated in place

Adapter semantics fused on device (as in the reference):
  * denier: per-rule fixed status + TTLs.
  * list: whitelist/blacklist membership of one value, STRINGS entries
    as an interned-id equality scan. REGEX and IP_ADDRESSES lists and
    RbacSpecs raise NotPorted in this slice (ROADMAP.md).
  * memquota: fixed-window counters resident on the device; a batch
    ranks same-bucket requests, grants while prior + rank < max, and
    commits the grants.

Status combining is LOWEST-RULE-INDEX-WINS (the host dispatcher's
_combine order), ties deny → list → quota; TTLs take the min over every
active fused rule.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.compiler.layout import (AttributeBatch, InternTable,
                                             Tensorizer)
from istio_tpu_torch.compiler.ruleset import (Rule, RuleSetProgram,
                                              compile_ruleset)
from istio_tpu_torch.device import NotPorted, resolve_device
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.models.quota_alloc import batch_rank
from istio_tpu_torch.ops.bytes_ops import pack_bits, unpack_bits
from istio_tpu_torch.utils.log import scope

log = scope("models.policy_engine")

# istio.mixer.v1 / google.rpc status codes used on the check path.
OK = 0
NOT_FOUND = 5
PERMISSION_DENIED = 7
RESOURCE_EXHAUSTED = 8
INTERNAL = 13
_BIG = np.float32(3.4e38)
INT32_MAX = int(np.iinfo(np.int32).max)
# adapter CheckResult defaults — INTERNAL results min these into the TTL
# fold (host _combine parity)
DEFAULT_DUR = np.float32(5.0)
DEFAULT_USES = np.int32(10_000)


@dataclasses.dataclass(frozen=True)
class DenySpec:
    """denier adapter wiring for one rule (denier.go params)."""
    rule: int                      # rule index in the ruleset
    status: int = PERMISSION_DENIED
    valid_duration_s: float = 5.0
    valid_use_count: int = 10000


@dataclasses.dataclass(frozen=True)
class ListEntrySpec:
    """list adapter wiring for one rule (listentry template +
    mixer/adapter/list): check `value_attr`'s membership in a fixed
    list. This slice lowers entry_type STRINGS (interned-id equality
    scan); REGEX and IP_ADDRESSES raise NotPorted."""
    rule: int
    value_attr: str                # attribute (or (map,key)) whose value is checked
    entries: Sequence[Any]         # list payload per entry_type
    blacklist: bool = False       # True: member → deny; False: non-member → deny
    valid_duration_s: float = 5.0
    valid_use_count: int = 10000
    entry_type: str = "STRINGS"


@dataclasses.dataclass(frozen=True)
class RbacSpec:
    """rbac adapter wiring for one rule (mixer/adapter/rbac rbac.go:181).
    Not ported in this slice: PolicyEngine raises NotPorted."""
    rule: int
    allow_rows: tuple[int, ...]
    guard_row: int = -1            # -1: instance can never error
    valid_duration_s: float = 60.0  # handler caching_ttl_s


@dataclasses.dataclass(frozen=True)
class QuotaSpec:
    """memquota wiring for one rule: fixed-window rate limit keyed by an
    attribute's stable content hash."""
    rule: int
    key_attr: str
    max_amount: int = 100
    n_buckets: int = 4096          # hash space for keys


@dataclasses.dataclass
class CheckVerdict:
    """Batched check result (adapter.CheckResult semantics, check.go:28)."""
    status: Any            # int32 [B] — google.rpc code
    valid_duration_s: Any  # float32 [B]
    valid_use_count: Any   # int32 [B]
    referenced: Any        # bool [B, n_columns] attribute-use bitmap
    matched: Any           # bool [B, R] (diagnostics + host overlay)
    err: Any               # bool [B, R]
    deny_rule: Any         # int32 [B] — lowest rule idx that produced a
    #                        non-OK status; INT32_MAX when status is OK
    err_count: Any         # int32 [] — namespace-visible predicate errors
    #                        in the batch


def ref_table(attr_mask_bits: np.ndarray, rule_ns: np.ndarray,
              default_ns: int = 0) -> np.ndarray:
    """Per-namespace referenced-attribute table, bool [n_ns + 1, W·32]:
    row 0 answers every request namespace that owns no rule (unknown
    namespaces are -1), row v+1 namespace id v. The reference computes
    `ns_ok ⊗ attr_mask` per request (an int8 matmul); ns_ok depends only
    on req_ns, so a lookup of this table is the same function."""
    lanes = np.array(attr_mask_bits, dtype=np.uint32).view(np.int32)
    mask = unpack_bits(torch.from_numpy(lanes),
                       int(lanes.shape[-1]) * 32).numpy()       # [R, W·32]
    n_ns = max(int(rule_ns.max(initial=-1)) + 1, 1)
    out = np.zeros((n_ns + 1, mask.shape[1]), bool)
    for row, v in enumerate(range(-1, n_ns)):
        ns_ok = (rule_ns == default_ns) | (rule_ns == v)
        out[row] = mask[ns_ok].any(axis=0)
    return out


@dataclasses.dataclass(frozen=True)
class FoldConsts:
    """Shape-bearing structure of the verdict fold (closure constants in
    the reference)."""
    default_ns: int
    has_lists: bool
    has_quota: bool
    n_attr_cols: int


def verdict_fold_plain(matched: torch.Tensor, err: torch.Tensor,
                       req_ns: torch.Tensor, batch: AttributeBatch,
                       params: Mapping[str, torch.Tensor],
                       quota_counts: torch.Tensor, c: FoldConsts
                       ) -> tuple[torch.Tensor, ...]:
    """Plain version of the verdict_fold kernel: the reference's
    PolicyEngine step (istio_tpu/models/policy_engine.py:379-654) for
    deny, STRINGS lists, quota and referenced attributes. Updates
    quota_counts in place; → (status, dur, uses, deny_rule, referenced,
    err_count)."""
    dev = matched.device
    b, n_rules = matched.shape
    rule_ns = params["pe_rule_ns"]
    ns_ok = (rule_ns[None, :] == c.default_ns) | \
        (rule_ns[None, :] == req_ns[:, None])
    active = matched & ns_ok                                   # [B, R]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    rule_idx = torch.arange(n_rules, dtype=torch.int32, device=dev)

    dmask = active & params["pe_deny_mask"][None, :]
    d_key = torch.where(dmask, rule_idx[None, :], INT32_MAX)
    d_arg = torch.argmin(d_key, dim=1)
    cand_rule = d_key.min(dim=1).values
    cand_status = params["pe_deny_status"][d_arg]
    dur = torch.where(dmask, params["pe_deny_dur"][None, :], big).min(dim=1) \
        .values
    uses = torch.where(dmask, params["pe_deny_uses"][None, :],
                       INT32_MAX).min(dim=1).values

    if c.has_lists:
        l_slot = params["pe_list_slot"].long()
        l_rule_i = params["pe_list_rule"]
        sym = batch.ids[:, l_slot]                             # [B, L]
        sym_ok = batch.present[:, l_slot]
        member = (sym[:, :, None] == params["pe_list_ids"][None]).any(dim=2)
        l_rule_act = active[:, l_rule_i.long()]
        l_internal = l_rule_act & ~sym_ok
        l_eval = l_rule_act & sym_ok
        l_hit = l_internal | (l_eval &
                              (member == params["pe_list_black"][None, :]))
        l_key = torch.where(l_hit, l_rule_i[None, :], INT32_MAX)
        l_arg = torch.argmin(l_key, dim=1)
        l_rule = l_key.min(dim=1).values
        winner_internal = torch.gather(l_internal, 1, l_arg[:, None])[:, 0]
        take_l = l_rule < cand_rule          # strict: deny wins ties
        l_status = torch.where(winner_internal, INTERNAL,
                               params["pe_list_code"][l_arg])
        cand_status = torch.where(take_l, l_status, cand_status)
        cand_rule = torch.minimum(cand_rule, l_rule)
        dur = torch.minimum(dur, torch.where(
            l_eval, params["pe_list_dur"][None, :], big).min(dim=1).values)
        uses = torch.minimum(uses, torch.where(
            l_eval, params["pe_list_uses"][None, :], INT32_MAX)
            .min(dim=1).values)
        any_internal = l_internal.any(dim=1)
        dur = torch.where(any_internal,
                          torch.minimum(dur, torch.tensor(DEFAULT_DUR,
                                                          device=dev)), dur)
        uses = torch.where(any_internal,
                           torch.minimum(uses, torch.tensor(
                               DEFAULT_USES, device=dev)), uses)
    status = torch.where(cand_rule < INT32_MAX, cand_status, OK) \
        .to(torch.int32)

    if c.has_quota:
        q_slot = params["pe_q_slot"].long()
        q_rule = params["pe_q_rule"]
        key = batch.hash_ids[:, q_slot]                        # [B, Q]
        key_ok = batch.present[:, q_slot]
        q_active = active[:, q_rule.long()] & key_ok & \
            (status == OK)[:, None]
        bucket = torch.remainder(key, params["pe_q_nb"][None, :])  # floor
        n_q, n_b = quota_counts.shape
        qoff = torch.arange(n_q, dtype=torch.int32, device=dev)[None, :] \
            * n_b
        ckey = torch.where(q_active, bucket + qoff, INT32_MAX)
        rank = batch_rank(ckey.T.reshape(-1)).reshape(n_q, b).T
        flat = (bucket + qoff).long()
        prior = quota_counts.reshape(-1)[flat]                 # [B, Q]
        granted = q_active & (prior + rank < params["pe_q_max"][None, :])
        over = q_active & ~granted
        any_over = over.any(dim=1)
        status = torch.where(any_over, RESOURCE_EXHAUSTED, status) \
            .to(torch.int32)
        cand_rule = torch.where(
            any_over, torch.where(over, q_rule[None, :], INT32_MAX)
            .min(dim=1).values, cand_rule)
        quota_counts.view(-1).index_add_(
            0, flat.reshape(-1), granted.to(torch.int32).reshape(-1))

    table = params["pe_ref_table"]
    n_rows_t = table.shape[0]
    row = torch.where((req_ns >= 0) & (req_ns < n_rows_t - 1),
                      req_ns + 1, 0).long()
    referenced = table[row][:, :c.n_attr_cols]
    deny_rule = torch.where(status == OK, INT32_MAX, cand_rule) \
        .to(torch.int32)
    counted = err & ns_ok
    if "pe_err_rule_mask" in params:
        counted = counted & params["pe_err_rule_mask"][None, :]
    err_count = counted.sum(dtype=torch.int32)
    return status, dur, uses, deny_rule, referenced, err_count


_K = kernels
_FOLD_ARGS = ([_K.VP, _K.VP, _K.VP, _K.I32, _K.I32]           # matched..R
              + [_K.VP, _K.I32] + [_K.VP] * 5                  # ns, deny, mask
              + [_K.I32, _K.I32] + [_K.VP] * 7                 # lists
              + [_K.VP, _K.VP, _K.VP, _K.I32]                  # batch planes
              + [_K.I32, _K.I32] + [_K.VP] * 5                 # quota
              + [_K.VP, _K.I32, _K.I32, _K.I32]                # ref table
              + [_K.VP] * 6 + [_K.VP, _K.VP] + [_K.VP])        # outs, scratch


def verdict_fold(matched: torch.Tensor, err: torch.Tensor,
                 req_ns: torch.Tensor, batch: AttributeBatch,
                 params: Mapping[str, torch.Tensor],
                 quota_counts: torch.Tensor, c: FoldConsts
                 ) -> tuple[torch.Tensor, ...]:
    """The verdict fold of one batch: namespace mask, deny fold, STRINGS
    list scan, quota rank / grant / commit (quota_counts updated in
    place) and referenced attributes → (status, dur, uses, deny_rule,
    referenced, err_count). CPU tensors run verdict_fold_plain."""
    if matched.device.type == "cpu":
        return verdict_fold_plain(matched, err, req_ns, batch, params,
                                  quota_counts, c)
    if matched.device.type != "cuda":
        raise ValueError(f"verdict_fold: unsupported device {matched.device}")
    dev = matched.device
    b, n_rules = matched.shape
    want = {"matched": (matched, torch.bool, (b, n_rules)),
            "err": (err, torch.bool, (b, n_rules)),
            "req_ns": (req_ns, torch.int32, (b,)),
            "quota_counts": (quota_counts, torch.int32, None)}
    for k, dt in (("pe_rule_ns", torch.int32), ("pe_deny_mask", torch.bool),
                  ("pe_deny_status", torch.int32),
                  ("pe_deny_dur", torch.float32),
                  ("pe_deny_uses", torch.int32)):
        want[k] = (params[k], dt, (n_rules,))
    for k, dt in (("pe_list_ids", torch.int32), ("pe_list_rule", torch.int32),
                  ("pe_list_slot", torch.int32), ("pe_list_black", torch.bool),
                  ("pe_list_code", torch.int32), ("pe_list_dur", torch.float32),
                  ("pe_list_uses", torch.int32), ("pe_q_rule", torch.int32),
                  ("pe_q_slot", torch.int32), ("pe_q_max", torch.int32),
                  ("pe_q_nb", torch.int32), ("pe_ref_table", torch.bool)):
        want[k] = (params[k], dt, None)
    for k, dt in (("ids", torch.int32), ("present", torch.bool),
                  ("hash_ids", torch.int32)):
        want[k] = (getattr(batch, k), dt, None)
    for k, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or not t.is_contiguous() or \
                (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"verdict_fold: {k} must be a contiguous {dt} "
                             f"{shape or ''} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    mask = params.get("pe_err_rule_mask")
    n_lists = int(params["pe_list_rule"].shape[0]) if c.has_lists else 0
    n_q = int(quota_counts.shape[0]) if c.has_quota else 0
    table = params["pe_ref_table"]
    status = torch.empty(b, dtype=torch.int32, device=dev)
    dur = torch.empty(b, dtype=torch.float32, device=dev)
    uses = torch.empty(b, dtype=torch.int32, device=dev)
    deny_rule = torch.empty(b, dtype=torch.int32, device=dev)
    referenced = torch.empty((b, c.n_attr_cols), dtype=torch.bool,
                             device=dev)
    err_count = torch.zeros((), dtype=torch.int32, device=dev)
    ckey = torch.empty((max(n_q, 1), b), dtype=torch.int32, device=dev)
    qstate = torch.empty((max(n_q, 1), b), dtype=torch.uint8, device=dev)
    if b == 0:
        return status, dur, uses, deny_rule, referenced, err_count
    p = kernels.ptr
    null = kernels.VP(0)
    fn = kernels.function("verdict_fold", "verdict_fold", _FOLD_ARGS)
    rc = fn(p(matched), p(err), p(req_ns), b, n_rules,
            p(params["pe_rule_ns"]), c.default_ns, p(params["pe_deny_mask"]),
            p(params["pe_deny_status"]), p(params["pe_deny_dur"]),
            p(params["pe_deny_uses"]), null if mask is None else p(mask),
            n_lists, int(params["pe_list_ids"].shape[1]),
            p(params["pe_list_ids"]), p(params["pe_list_rule"]),
            p(params["pe_list_slot"]), p(params["pe_list_black"]),
            p(params["pe_list_code"]), p(params["pe_list_dur"]),
            p(params["pe_list_uses"]),
            p(batch.ids), p(batch.present), p(batch.hash_ids),
            int(batch.ids.shape[1]),
            n_q, int(quota_counts.shape[1]), p(params["pe_q_rule"]),
            p(params["pe_q_slot"]), p(params["pe_q_max"]),
            p(params["pe_q_nb"]), p(quota_counts),
            p(table), int(table.shape[0]), int(table.shape[1]),
            c.n_attr_cols,
            p(status), p(dur), p(uses), p(deny_rule), p(referenced),
            p(err_count), p(ckey), p(qstate),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("verdict_fold", kernels.check(rc, "verdict_fold"),
                     matched, err, req_ns, batch, params, quota_counts, c)
    return status, dur, uses, deny_rule, referenced, err_count


class PolicyEngine:
    """Compiled fused policy step for one config snapshot, on `device`.

    Construction compiles the ruleset + action tensors; `check(batch,
    req_ns)` runs the fused step. Quota state lives in
    `self.quota_counts` on the device and every step updates it IN
    PLACE (the reference donates the buffer through its jitted step and
    rebinds the result instead); a check with quotas is therefore a
    read-modify-write and must not run concurrently with another.
    """

    def __init__(self, rules: Sequence[Rule] | None = None,
                 finder: AttributeDescriptorFinder | None = None,
                 deny: Sequence[DenySpec] = (),
                 lists: Sequence[ListEntrySpec] = (),
                 quotas: Sequence[QuotaSpec] = (),
                 rbacs: Sequence[RbacSpec] = (),
                 interner: InternTable | None = None,
                 max_str_len: int | None = None,
                 ruleset: RuleSetProgram | None = None,
                 count_rules: int | None = None,
                 device: str | torch.device = "cuda"):
        dev = resolve_device(device)
        if rbacs:
            raise NotPorted("RbacSpec banks (RBAC any-allow fold)")
        for l in lists:
            if l.entry_type == "REGEX":
                raise NotPorted("REGEX list banks")
            if l.entry_type == "IP_ADDRESSES":
                raise NotPorted("IP_ADDRESSES (CIDR) list banks")
            if l.entry_type != "STRINGS":
                raise ValueError(f"unknown list entry_type {l.entry_type}")
        if ruleset is None:
            if rules is None or finder is None:
                raise ValueError("PolicyEngine needs rules + finder, or a "
                                 "compiled ruleset")
            ruleset = compile_ruleset(rules, finder, interner=interner,
                                      max_str_len=max_str_len, device=dev)
        self.device = dev
        self.ruleset = ruleset
        self.finder = finder
        interner = self.ruleset.interner
        n_rows = int(self.ruleset.rule_ns.shape[0])
        if count_rules is None or count_rules >= n_rows:
            err_rule_mask = None
        else:
            err_rule_mask = np.zeros(n_rows, bool)
            err_rule_mask[:count_rules] = True

        # --- denier tensors ---
        deny_mask = np.zeros(n_rows, bool)
        deny_status = np.full(n_rows, OK, np.int32)
        deny_dur = np.full(n_rows, _BIG, np.float32)
        deny_uses = np.full(n_rows, INT32_MAX, np.int32)
        for d in deny:
            deny_mask[d.rule] = True
            deny_status[d.rule] = d.status
            deny_dur[d.rule] = d.valid_duration_s
            deny_uses[d.rule] = d.valid_use_count

        # --- list tensors (STRINGS) ---
        n_lists = len(lists)
        max_entries = max((len(l.entries) for l in lists), default=1) or 1
        # int32 ids: the reference builds int64 and jax (no x64) narrows
        list_ids = np.zeros((max(n_lists, 1), max_entries), np.int32)
        list_rule = np.zeros(max(n_lists, 1), np.int32)
        list_slot = np.zeros(max(n_lists, 1), np.int32)
        list_black = np.zeros(max(n_lists, 1), bool)
        list_code = np.full(max(n_lists, 1), PERMISSION_DENIED, np.int32)
        list_dur = np.full(max(n_lists, 1), _BIG, np.float32)
        list_uses = np.full(max(n_lists, 1), INT32_MAX, np.int32)
        for i, l in enumerate(lists):
            ids = [interner.intern(e) for e in l.entries]
            # pad with ID_INVALID: a present slot's id is never 0
            list_ids[i, :len(ids)] = ids
            list_rule[i] = l.rule
            list_slot[i] = self._slot_for(l.value_attr)
            list_black[i] = l.blacklist
            # blacklist hit → PERMISSION_DENIED, whitelist miss → NOT_FOUND
            list_code[i] = PERMISSION_DENIED if l.blacklist else NOT_FOUND
            list_dur[i] = l.valid_duration_s
            list_uses[i] = l.valid_use_count

        # --- rbac tensors: none in this slice, kept as the reference's
        #     empty banks so params carry the same keys
        rb_rule = np.zeros(1, np.int32)
        rb_dur = np.full(1, _BIG, np.float32)
        rb_guard = np.full(1, n_rows + 1, np.int32)
        rb_allow = np.full((1, 1), n_rows, np.int32)

        # --- quota tensors ---
        n_quotas = len(quotas)
        q_rule = np.zeros(max(n_quotas, 1), np.int32)
        q_slot = np.zeros(max(n_quotas, 1), np.int32)
        q_max = np.zeros(max(n_quotas, 1), np.int32)
        q_nb = np.ones(max(n_quotas, 1), np.int32)
        n_buckets = max((q.n_buckets for q in quotas), default=1)
        if n_quotas * n_buckets >= INT32_MAX:
            raise ValueError(
                f"quota hash space too large: {n_quotas} quotas × "
                f"{n_buckets} buckets must stay below 2^31-1 (int32 "
                "composite keys)")
        self._quota_slots = frozenset(
            self._slot_for(q.key_attr) for q in quotas)
        for i, q in enumerate(quotas):
            q_rule[i] = q.rule
            q_slot[i] = self._slot_for(q.key_attr)
            q_max[i] = q.max_amount
            q_nb[i] = q.n_buckets
        self.quota_counts = torch.zeros((max(n_quotas, 1), n_buckets),
                                        dtype=torch.int32, device=dev)
        self._has_quota = n_quotas > 0

        attr_mask_bits = pack_bits(self.ruleset.attr_mask).view(np.int32)
        n_attr_cols = int(self.ruleset.attr_mask.shape[1])
        default_ns = self.ruleset.ns_ids[""]
        pe = {
            "pe_rule_ns": self.ruleset.rule_ns,
            "pe_attr_mask_bits": attr_mask_bits,
            "pe_deny_mask": deny_mask,
            "pe_deny_status": deny_status,
            "pe_deny_dur": deny_dur,
            "pe_deny_uses": deny_uses,
            "pe_list_ids": list_ids,
            "pe_list_rule": list_rule,
            "pe_list_slot": list_slot,
            "pe_list_black": list_black,
            "pe_list_code": list_code,
            "pe_list_dur": list_dur,
            "pe_list_uses": list_uses,
            "pe_q_rule": q_rule,
            "pe_q_slot": q_slot,
            "pe_q_max": q_max,
            "pe_q_nb": q_nb,
            "pe_rb_rule": rb_rule,
            "pe_rb_dur": rb_dur,
            "pe_rb_guard": rb_guard,
            "pe_rb_allow": rb_allow,
            # port-only: the verdict_fold kernel's per-namespace
            # referenced table (derived, see ref_table)
            "pe_ref_table": ref_table(attr_mask_bits.view(np.uint32),
                                      self.ruleset.rule_ns, default_ns),
        }
        if err_rule_mask is not None:
            pe["pe_err_rule_mask"] = err_rule_mask
        pe_params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in pe.items()}
        self.fold_consts = FoldConsts(default_ns=default_ns,
                                      has_lists=n_lists > 0,
                                      has_quota=self._has_quota,
                                      n_attr_cols=n_attr_cols)
        # ruleset index tensors + the engine bank tensors — the one
        # argument dict every step takes (interop.params_from_reference
        # builds the same dict from the JAX package's engine)
        self.params = {**self.ruleset.params, **pe_params}

    def step(self, params: Mapping[str, torch.Tensor], batch: AttributeBatch,
             req_ns: Any, quota_counts: torch.Tensor
             ) -> tuple[CheckVerdict, torch.Tensor]:
        """One fused check step (the reference's raw_step): → (verdict,
        quota_counts), the counts updated in place."""
        batch = batch.to(self.device)
        req = torch.as_tensor(np.asarray(req_ns, np.int32)) \
            if not isinstance(req_ns, torch.Tensor) else req_ns
        req = req.to(device=self.device, dtype=torch.int32).contiguous()
        matched, _not_matched, err = self.ruleset.fn(params, batch)
        status, dur, uses, deny_rule, referenced, err_count = verdict_fold(
            matched, err, req, batch, params, quota_counts,
            self.fold_consts)
        verdict = CheckVerdict(status=status, valid_duration_s=dur,
                               valid_use_count=uses, referenced=referenced,
                               matched=matched, err=err,
                               deny_rule=deny_rule, err_count=err_count)
        return verdict, quota_counts

    raw_step = step

    def _slot_for(self, attr: Any) -> int:
        lay = self.ruleset.layout
        if isinstance(attr, tuple):
            if attr not in lay.derived_slots:
                raise ValueError(f"no derived slot for {attr}; reference it "
                                 "in a rule or add it to derived_keys")
            return lay.derived_slots[attr]
        return lay.slot_of(attr)

    # ------------------------------------------------------------------
    def check(self, batch: AttributeBatch, req_ns: Any) -> CheckVerdict:
        """With device quotas this is a read-modify-write on
        quota_counts and must not run concurrently."""
        verdict, _ = self.step(self.params, batch, req_ns, self.quota_counts)
        return verdict

    def reset_quota(self) -> None:
        """New quota window (memquota's window roll)."""
        self.quota_counts.zero_()

    @property
    def tensorizer(self) -> Tensorizer:
        # hash exactly the quota key slots — the only consumers of the
        # stable-hash plane
        return Tensorizer(self.ruleset.layout, self.ruleset.interner,
                          hash_slots=self._quota_slots)
