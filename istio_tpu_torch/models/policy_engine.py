"""PolicyEngine — the fused batched Check()/Quota() step on the card.

Port of istio_tpu/models/policy_engine.py. For a batch of B requests:

    ruleset match          rule_match kernel (+ dfa_scan, byte_pred)  [B, R]
    REGEX / CIDR lists     dfa_scan + list_banks kernels → list states
    × namespace mask  ┐
    deny actions      │
    listentry          │   verdict_fold kernel (csrc/verdict_fold.cu)
    rbac any-allow    │   → status / TTLs / deny_rule / err_count,
    quota rank+grant  │     quota counters updated in place
    referenced attrs  ┘

Adapter semantics fused on device (as in the reference):
  * denier: per-rule fixed status + TTLs.
  * list: whitelist/blacklist membership of one value, by entry_type:
    STRINGS as an interned-id equality scan, REGEX as a DFA bank per
    value byte slot (truncated values with no definitive prefix hit err
    the rule and suppress the deny), IP_ADDRESSES as CIDR prefix
    compares in v6-mapped space.
  * rbac: a request is allowed iff any of its policy's pseudo-rule rows
    (compiler/rbac_lower.py) matched; a guard row that is not
    definitely true is INTERNAL.
  * memquota: fixed-window counters resident on the device; a batch
    ranks same-bucket requests, grants while prior + rank < max, and
    commits the grants.

Status combining is LOWEST-RULE-INDEX-WINS (the host dispatcher's
_combine order), ties deny → list → rbac → quota; TTLs take the min
over every active fused rule.
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
from istio_tpu_torch.device import resolve_device
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.models.quota_alloc import batch_rank
from istio_tpu_torch.ops import bytes_ops
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
_LIST_TYPES = ("STRINGS", "REGEX", "IP_ADDRESSES")
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
    list. Three lowerings by entry_type (list.go ListEntryType):

      STRINGS       — interned-id equality scan (exact match)
      REGEX         — DFA bank over the value's byte slot (Go regexp
                      search semantics, ops/regex_dfa); truncated values
                      with no definitive prefix hit mark the rule's err
                      bit and suppress the deny
      IP_ADDRESSES  — CIDR prefix compare over the value's IP bytes in
                      v6-mapped space, version-strict

    CASE_INSENSITIVE_STRINGS and provider-refreshed lists stay on the
    host (runtime/fused.py)."""
    rule: int
    value_attr: str                # attribute (or (map,key)) whose value is checked
    entries: Sequence[Any]         # list payload per entry_type
    blacklist: bool = False       # True: member → deny; False: non-member → deny
    valid_duration_s: float = 5.0
    valid_use_count: int = 10000
    entry_type: str = "STRINGS"


@dataclasses.dataclass(frozen=True)
class RbacSpec:
    """rbac adapter wiring for one rule (mixer/adapter/rbac rbac.go:181
    HandleAuthorization): the policy's (binding, subject, role-rule)
    triples were lowered to pseudo-rule rows (compiler/rbac_lower.py);
    the request is allowed iff ANY `allow_rows` row matched. When the
    `guard_row` is not definitely true the host path would have failed
    the instance build with INTERNAL, so the device reports the same."""
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


def vis_rows_of(rule_ns: np.ndarray, default_ns: int = 0
                ) -> tuple[np.ndarray, np.ndarray]:
    """The rules each request namespace sees, one row per namespace value
    that can differ: → (vis_ns int32 [V], the distinct values of rule_ns
    ascending, pad namespace -7 among them; vis bool [V + 1, R], row v
    the rules whose namespace is default_ns or vis_ns[v], row V the
    default rules alone — what every other int32 sees). `vis_rows`
    looks a request's row up."""
    rule_ns = np.asarray(rule_ns, np.int32)
    vis_ns = np.unique(rule_ns).astype(np.int32)
    dflt = rule_ns == default_ns
    vis = np.stack([dflt | (rule_ns == v) for v in vis_ns] + [dflt])
    return vis_ns, vis


def vis_rows(req_ns: torch.Tensor, vis_ns: torch.Tensor) -> torch.Tensor:
    """Each request's row of the vis tables: the index of its namespace
    in vis_ns, or V where it is none of them (exact for every int32)."""
    hit = req_ns[:, None] == vis_ns[None, :]
    return torch.where(hit.any(dim=1), hit.to(torch.int32).argmax(dim=1),
                       int(vis_ns.shape[0])).long()


def fold_word_tables(rule_ns: np.ndarray, default_ns: int,
                     deny_mask: np.ndarray,
                     err_rule_mask: np.ndarray | None = None
                     ) -> dict[str, np.ndarray]:
    """The verdict_fold kernel's rule tables as 32-rule bit words, int32
    lanes in pack_bits order (bit k of word w is rule 32w + k), ceil(R /
    32) words a row; port-only and derived, like ref_table:

      pe_vis_ns      int32 [V]       vis_rows_of's namespace values
      pe_vis_words   [V + 1, NW]     vis_rows_of's rows
      pe_deny_words  [NW]            deny_mask
      pe_err_words   [NW]            err_rule_mask (every rule without)
    """
    vis_ns, vis = vis_rows_of(rule_ns, default_ns)
    n_rows = int(np.asarray(rule_ns).shape[0])
    errs = np.ones(n_rows, bool) if err_rule_mask is None else err_rule_mask
    words = lambda a: pack_bits(a).view(np.int32)  # noqa: E731
    return {"pe_vis_ns": vis_ns, "pe_vis_words": words(vis),
            "pe_deny_words": words(np.asarray(deny_mask, bool)),
            "pe_err_words": words(np.asarray(errs, bool))}


@dataclasses.dataclass(frozen=True)
class FoldConsts:
    """Shape-bearing structure of the verdict fold (closure constants in
    the reference)."""
    default_ns: int
    has_lists: bool
    has_quota: bool
    n_attr_cols: int
    has_rbac: bool


def verdict_fold_plain(matched: torch.Tensor, err: torch.Tensor,
                       req_ns: torch.Tensor, batch: AttributeBatch,
                       params: Mapping[str, torch.Tensor],
                       quota_counts: torch.Tensor, c: FoldConsts,
                       lstate: torch.Tensor | None = None,
                       list_kind: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, ...]:
    """Plain version of the verdict_fold kernel: the reference's
    PolicyEngine step (istio_tpu/models/policy_engine.py:379-654) after
    the byte-level list banks: deny, lists, RBAC, quota and referenced
    attributes. `lstate` uint8 [B, NL] holds the list_banks kernels'
    state bytes (member | und << 1 | bad << 2), read for the lists whose
    `list_kind` is non-zero in place of the id scan; `err` is the plane
    the regex banks already OR'd their und bits into. Updates
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
        if lstate is not None:
            byte = (list_kind != 0)[None, :]
            member = torch.where(
                byte, (lstate & bytes_ops.LIST_MEMBER) != 0, member)
            # a present value the host adapter cannot parse (bad) is
            # INTERNAL; a truncated undecidable regex value (und) is
            # neither evaluated nor INTERNAL: its rule errs instead
            bad = (lstate & bytes_ops.LIST_BAD) != 0
            und = (lstate & bytes_ops.LIST_UND) != 0
            l_internal = l_internal | (l_rule_act & sym_ok & bad)
            l_eval = l_eval & ~bad & ~und
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

    if c.has_rbac:
        # allowed iff ANY lowered pseudo-rule matched; a guard row that
        # is not definitely true is INTERNAL. Column R of m_ext is the
        # FALSE sentinel (padding of allow rows), R + 1 the TRUE one (no
        # guard)
        m_ext = torch.cat([matched, torch.zeros((b, 1), dtype=torch.bool,
                                                device=dev),
                           torch.ones((b, 1), dtype=torch.bool,
                                      device=dev)], dim=1)
        rb_rule = params["pe_rb_rule"]
        allow = m_ext[:, params["pe_rb_allow"].long()].any(dim=2)
        guard_ok = m_ext[:, params["pe_rb_guard"].long()]
        r_active = active[:, rb_rule.long()]
        r_deny = r_active & guard_ok & ~allow
        r_bad = r_deny | (r_active & ~guard_ok)
        rb_key = torch.where(r_bad, rb_rule[None, :], INT32_MAX)
        rb_arg = torch.argmin(rb_key, dim=1)
        rb_rule_min = rb_key.min(dim=1).values
        rb_status = torch.where(
            torch.gather(r_deny, 1, rb_arg[:, None])[:, 0],
            PERMISSION_DENIED, INTERNAL)
        take_rb = rb_rule_min < cand_rule    # deny / list win ties
        cand_status = torch.where(take_rb, rb_status, cand_status)
        cand_rule = torch.minimum(cand_rule, rb_rule_min)
        # caching_ttl on allow and deny alike; INTERNAL carries nothing
        dur = torch.minimum(dur, torch.where(
            r_active & guard_ok, params["pe_rb_dur"][None, :], big)
            .min(dim=1).values)
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


# the row fold's record over a window of the rule axis (mesh_partial's rec
# rows): lowest active deny rule, min TTL bits, min uses, errors, the list
# winner's rule / list / status
REC_DENY, REC_DUR, REC_USES, REC_ERR, REC_LRULE, REC_LARG, REC_LSTATUS = \
    range(7)
REC_ROWS = 7
RB_ALLOW, RB_GUARD, RB_ACTIVE = 1, 2, 4     # an RBAC spec's flag bits


def _fold_record_words(matched: torch.Tensor, err: torch.Tensor,
                            req_ns: torch.Tensor, batch: AttributeBatch,
                            params: Mapping[str, torch.Tensor],
                            c: FoldConsts, r0: int,
                            lstate: torch.Tensor | None = None,
                            list_kind: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's row fold over the window [r0, r0 + Rm) of the rule
    axis, from the rule-word tables (fold_word_tables): `matched` / `err`
    are the window's columns [B, Rm]. → (rec int32 [REC_ROWS, B], flags
    uint8 [B, NRB + Q]): per RBAC spec RB_ALLOW (an allow column in the
    window matched), RB_GUARD (its guard column is in the window and
    matched, or is the TRUE sentinel), RB_ACTIVE (its rule is in the
    window and active); per quota 1 where its rule is in the window and
    active. Every field is a min, sum or OR over the rule axis, so the
    records of windows that tile it combine (combine_fold_records) into
    the unsharded fold."""
    dev = matched.device
    b, rm = matched.shape
    n_rules = int(params["pe_deny_dur"].shape[0])
    r1 = r0 + rm
    if rm <= 0 or r0 < 0 or r1 > n_rules:
        raise ValueError(f"window [{r0}, {r1}) outside {n_rules} rules")
    n_bits = int(params["pe_vis_words"].shape[1]) * 32
    vis = unpack_bits(params["pe_vis_words"], n_bits)[
        vis_rows(req_ns, params["pe_vis_ns"])]                 # [B, R+]
    deny = unpack_bits(params["pe_deny_words"], n_bits)[r0:r1]
    errw = unpack_bits(params["pe_err_words"], n_bits)[r0:r1]
    m, e, v = matched != 0, err != 0, vis[:, r0:r1]
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    rule_idx = torch.arange(r0, r1, dtype=torch.int32, device=dev)
    cand = m & v & deny[None, :]
    d_rule = torch.where(cand, rule_idx[None, :], INT32_MAX).min(dim=1).values
    dur = torch.where(cand, params["pe_deny_dur"][None, r0:r1], big) \
        .min(dim=1).values
    uses = torch.where(cand, params["pe_deny_uses"][None, r0:r1],
                       INT32_MAX).min(dim=1).values
    errs = (e & v & errw[None, :]).sum(dim=1, dtype=torch.int32)

    def active(rules: torch.Tensor) -> torch.Tensor:   # [B, len(rules)]
        inside = (rules >= r0) & (rules < r1)
        loc = (rules - r0).clamp(0, rm - 1).long()
        return inside[None, :] & vis[:, rules.long()] & m[:, loc]

    l_rule = torch.full((b,), INT32_MAX, dtype=torch.int32, device=dev)
    l_arg = torch.zeros(b, dtype=torch.int32, device=dev)
    l_status = torch.zeros(b, dtype=torch.int32, device=dev)
    if c.has_lists:
        rules = params["pe_list_rule"]
        n_lists = int(rules.shape[0])
        slot = params["pe_list_slot"].long()
        sym_ok = batch.present[:, slot]
        member = (batch.ids[:, slot][:, :, None] ==
                  params["pe_list_ids"][None]).any(dim=2)
        bad = und = torch.zeros_like(sym_ok)
        if lstate is not None:
            byte = (list_kind != 0)[None, :]
            member = torch.where(byte, (lstate & bytes_ops.LIST_MEMBER) != 0,
                                 member)
            bad = byte & ((lstate & bytes_ops.LIST_BAD) != 0)
            und = byte & ((lstate & bytes_ops.LIST_UND) != 0)
        act = active(rules)
        internal = act & (~sym_ok | bad)
        evald = act & ~internal & ~und
        hit = internal | (evald & (member == params["pe_list_black"][None]))
        key = rules.long()[None, :] * n_lists + \
            torch.arange(n_lists, device=dev)[None, :]
        k_min = torch.where(hit, key, 1 << 62).min(dim=1).values
        won = k_min < (1 << 62)
        arg = torch.where(won, k_min % n_lists, 0)
        l_rule = torch.where(won, k_min // n_lists, INT32_MAX).to(torch.int32)
        l_arg = arg.to(torch.int32)
        w_int = torch.gather(internal, 1, arg[:, None])[:, 0]
        l_status = torch.where(won, torch.where(
            w_int, INTERNAL, params["pe_list_code"][arg]), OK) \
            .to(torch.int32)
        dur = torch.minimum(dur, torch.where(
            evald, params["pe_list_dur"][None], big).min(dim=1).values)
        uses = torch.minimum(uses, torch.where(
            evald, params["pe_list_uses"][None], INT32_MAX).min(dim=1).values)
        lint = internal.any(dim=1)
        dur = torch.where(lint, torch.minimum(
            dur, torch.tensor(DEFAULT_DUR, device=dev)), dur)
        uses = torch.where(lint, torch.minimum(
            uses, torch.tensor(DEFAULT_USES, device=dev)), uses)
    flags = []
    if c.has_rbac:
        def column(cols: torch.Tensor) -> torch.Tensor:
            inside = (cols >= r0) & (cols < r1)
            loc = (cols - r0).clamp(0, rm - 1).long()
            return torch.where(inside, m[:, loc], cols == n_rules + 1)
        allow = column(params["pe_rb_allow"]).any(dim=2)
        guard = column(params["pe_rb_guard"])
        flags.append(allow.to(torch.uint8) * RB_ALLOW
                     + guard.to(torch.uint8) * RB_GUARD
                     + active(params["pe_rb_rule"]).to(torch.uint8)
                     * RB_ACTIVE)
    if c.has_quota:
        flags.append(active(params["pe_q_rule"]).to(torch.uint8))
    rec = torch.stack([d_rule.to(torch.int32), dur.view(torch.int32),
                       uses.to(torch.int32), errs, l_rule, l_arg, l_status])
    flag = torch.cat(flags, dim=1) if flags else \
        torch.zeros((b, 0), dtype=torch.uint8, device=dev)
    return rec, flag


def combine_fold_records(recs: Sequence[torch.Tensor],
                         flags: Sequence[torch.Tensor], req_ns: torch.Tensor,
                         batch: AttributeBatch,
                         params: Mapping[str, torch.Tensor],
                         quota_counts: torch.Tensor, c: FoldConsts
                         ) -> tuple[torch.Tensor, ...]:
    """The verdict from the records of windows that tile the rule axis
    (verdict_fold_words_plain with a window), as mesh_combine and mesh_quota compute it:
    min / sum / lowest (rule, list) over the records, the flags OR'd and
    the RBAC specs decided, the lowest index winning with ties deny →
    list → RBAC → quota, then the quota rank / grant / commit
    (quota_counts updated in place) and the referenced rows → (status,
    dur, uses, deny_rule, referenced, err_count)."""
    dev = req_ns.device
    rec = torch.stack(list(recs))                          # [M, 7, B]
    deny = rec[:, REC_DENY].min(dim=0).values
    dur = rec[:, REC_DUR].view(torch.float32).min(dim=0).values
    uses = rec[:, REC_USES].min(dim=0).values
    errs = rec[:, REC_ERR].sum(dim=0, dtype=torch.int32)
    l_key = rec[:, REC_LRULE].long() * (1 << 32) + rec[:, REC_LARG].long()
    l_at = l_key.argmin(dim=0)
    l_rule = torch.gather(rec[:, REC_LRULE], 0, l_at[None])[0]
    l_status = torch.gather(rec[:, REC_LSTATUS], 0, l_at[None])[0]
    flag = flags[0]
    for f in flags[1:]:
        flag = flag | f
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)

    cand_rule = deny
    cand_status = torch.where(
        deny < INT32_MAX,
        params["pe_deny_status"][deny.clamp(max=int(
            params["pe_deny_status"].shape[0]) - 1).long()], OK)
    take_l = l_rule < cand_rule
    cand_status = torch.where(take_l, l_status, cand_status)
    cand_rule = torch.minimum(cand_rule, l_rule)
    n_rbac = int(params["pe_rb_rule"].shape[0]) if c.has_rbac else 0
    if n_rbac:
        f = flag[:, :n_rbac]
        allow, guard, act = ((f & bit) != 0 for bit in
                             (RB_ALLOW, RB_GUARD, RB_ACTIVE))
        rb_rule = params["pe_rb_rule"]
        r_deny = act & guard & ~allow
        r_bad = r_deny | (act & ~guard)
        key = torch.where(r_bad, rb_rule[None, :], INT32_MAX)
        rb_arg = torch.argmin(key, dim=1)
        rb_min = key.min(dim=1).values
        rb_status = torch.where(torch.gather(r_deny, 1, rb_arg[:, None])[:, 0],
                                PERMISSION_DENIED, INTERNAL)
        take_rb = rb_min < cand_rule
        cand_status = torch.where(take_rb, rb_status, cand_status)
        cand_rule = torch.minimum(cand_rule, rb_min)
        dur = torch.minimum(dur, torch.where(
            act & guard, params["pe_rb_dur"][None, :], big).min(dim=1).values)
    status = torch.where(cand_rule < INT32_MAX, cand_status, OK) \
        .to(torch.int32)
    if c.has_quota:
        n_q, n_b = quota_counts.shape
        q_slot = params["pe_q_slot"].long()
        q_act = (flag[:, n_rbac:n_rbac + n_q] != 0) & \
            batch.present[:, q_slot] & (status == OK)[:, None]
        bucket = torch.remainder(batch.hash_ids[:, q_slot],
                                 params["pe_q_nb"][None, :])
        flat = bucket + torch.arange(n_q, dtype=torch.int32,
                                     device=dev)[None, :] * n_b
        ckey = torch.where(q_act, flat, INT32_MAX)
        b = int(req_ns.shape[0])
        rank = batch_rank(ckey.T.reshape(-1)).reshape(n_q, b).T
        prior = quota_counts.reshape(-1)[flat.long()]
        granted = q_act & (prior + rank < params["pe_q_max"][None, :])
        over = q_act & ~granted
        any_over = over.any(dim=1)
        status = torch.where(any_over, RESOURCE_EXHAUSTED, status) \
            .to(torch.int32)
        cand_rule = torch.where(any_over, torch.where(
            over, params["pe_q_rule"][None, :], INT32_MAX).min(dim=1).values,
            cand_rule)
        quota_counts.view(-1).index_add_(
            0, flat.long().reshape(-1), granted.to(torch.int32).reshape(-1))
    table = params["pe_ref_table"]
    n_rows_t = table.shape[0]
    row = torch.where((req_ns >= 0) & (req_ns < n_rows_t - 1),
                      req_ns + 1, 0).long()
    referenced = table[row][:, :c.n_attr_cols]
    deny_rule = torch.where(status == OK, INT32_MAX, cand_rule) \
        .to(torch.int32)
    return status, dur, uses.to(torch.int32), deny_rule, referenced, \
        errs.sum(dtype=torch.int32)


def verdict_fold_words_plain(matched: torch.Tensor, err: torch.Tensor,
                             req_ns: torch.Tensor, batch: AttributeBatch,
                             params: Mapping[str, torch.Tensor],
                             quota_counts: torch.Tensor | None,
                             c: FoldConsts,
                             lstate: torch.Tensor | None = None,
                             list_kind: torch.Tensor | None = None,
                             window: tuple[int, int] | None = None):
    """Plain version of the verdict_fold kernel in its own formulation:
    the row fold over the rule-word tables (no per-rule namespace, deny
    or err-mask read), then the combine. With `window` (r0, r1) the
    planes are that window's columns [B, r1 - r0] and the result is the
    window's record → (rec, flags), as mesh_partial writes it
    (quota_counts unused); without, the whole verdict as
    verdict_fold_plain returns it, quota_counts updated in place."""
    if window is not None:
        if matched.shape[1] != window[1] - window[0]:
            raise ValueError(f"planes of {matched.shape[1]} columns for "
                             f"the window {window}")
        return _fold_record_words(matched, err, req_ns, batch, params,
                                       c, window[0], lstate, list_kind)
    rec, flags = _fold_record_words(matched, err, req_ns, batch, params,
                                         c, 0, lstate, list_kind)
    return combine_fold_records([rec], [flags], req_ns, batch, params,
                                quota_counts, c)


def check_word_tables(name: str, params: Mapping[str, torch.Tensor],
                      n_rules: int, dev: torch.device) -> None:
    """Raise unless params hold fold_word_tables' tables for n_rules
    rules on dev (the shapes the kernels index without a check)."""
    nw = (n_rules + 31) // 32
    v = int(params["pe_vis_ns"].shape[0])
    for k, shape in (("pe_vis_ns", (v,)), ("pe_vis_words", (v + 1, nw)),
                     ("pe_deny_words", (nw,)), ("pe_err_words", (nw,))):
        t = params[k]
        if t.device != dev or t.dtype != torch.int32 or \
                not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {k} must be a contiguous int32 "
                             f"{shape} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def check_plane_pair(name: str, matched: torch.Tensor,
                     err: torch.Tensor) -> None:
    """The row walk reads both planes in 16-byte words from one split of
    each row: their addresses must agree modulo 16."""
    if (matched.data_ptr() - err.data_ptr()) % 16:
        raise ValueError(f"{name}: matched and err start at addresses "
                         "that differ modulo 16")


# The quota launch plan (csrc/verdict_fold.cu quota_grant): rows a block
# takes as a rule (2,048 beat 512, 1,024 and 4,096 at B = 2,048 and
# 8,192 on the card, PERF.md §6), blocks a cluster, and rows a block
# holds at most.
QUOTA_BLOCK_ROWS = 2048
QUOTA_MAX_CLUSTER = 16
QUOTA_MAX_ROWS = 4096


@dataclasses.dataclass(frozen=True)
class QuotaPlan:
    """How quota_grant covers a batch: `blocks` blocks a quota column,
    each over `rows` consecutive rows with `threads` threads and a hash
    table of `slots`; `launches` 1 (one block, or one cluster of
    `blocks`) or 3 (build, decide and commit over a global scratch of
    `scratch_words(Q)` int32)."""
    blocks: int
    rows: int
    threads: int
    slots: int
    launches: int

    def scratch_words(self, n_q: int) -> int:
        return n_q * self.blocks * 3 * self.slots if self.launches == 3 \
            else 0

    @property
    def args(self) -> tuple[int, int, int, int, int]:
        return (self.blocks, self.rows, self.threads, self.slots,
                self.launches)


def quota_plan(b: int) -> QuotaPlan:
    """The quota launch plan for b rows: one block up to
    QUOTA_BLOCK_ROWS rows; one cluster of ceil(b / QUOTA_BLOCK_ROWS)
    blocks, at most QUOTA_MAX_CLUSTER, the rows spread evenly, while a
    block holds at most QUOTA_MAX_ROWS; past that, three launches over
    blocks of QUOTA_MAX_ROWS."""
    blocks = min(QUOTA_MAX_CLUSTER, max(1, -(-b // QUOTA_BLOCK_ROWS)))
    rows = max(1, -(-b // blocks))
    launches = 1
    if rows > QUOTA_MAX_ROWS:
        rows, blocks, launches = QUOTA_MAX_ROWS, -(-b // QUOTA_MAX_ROWS), 3
    threads = min(1024, max(32, -(-rows // 32) * 32))
    slots = max(64, 1 << (2 * rows - 1).bit_length())
    return QuotaPlan(blocks, rows, threads, slots, launches)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def _mark_over(over_rule: torch.Tensor, row0: int, status: torch.Tensor,
               deny_rule: torch.Tensor) -> None:
    """RESOURCE_EXHAUSTED and the lowest over-limit rule (over_rule [B],
    INT32_MAX where none) on status / deny_rule [Bd], the rows from
    row0, in place."""
    mine = over_rule[row0:row0 + int(status.shape[0])]
    hit = mine != INT32_MAX
    status.copy_(torch.where(hit, RESOURCE_EXHAUSTED, status))
    deny_rule.copy_(torch.where(hit, torch.minimum(deny_rule, mine),
                                deny_rule))


def quota_grant_plain(ckey: torch.Tensor, counts: torch.Tensor,
                      q_max: torch.Tensor, q_rule: torch.Tensor,
                      status: torch.Tensor, deny_rule: torch.Tensor,
                      row0: int = 0, plan: QuotaPlan | None = None) -> None:
    """Plain version of the quota_grant kernel in its own formulation, in
    place: ckey int32 [Q, B] (< 0 inactive; column q's keys index
    counts.view(-1) [Q·NB] inside row q), counts updated, status /
    deny_rule int32 [Bd] of the rows from row0. Per column and per block
    of `plan.rows` rows, each key's rows hold the group ranks [pre, pre +
    n) (pre: the key's rows in earlier blocks) and are all granted
    (counter + pre + n - 1 < q_max), all over (counter + pre >= q_max)
    or, where the limit falls inside or the int32 sum wraps, ranked
    exactly (their stable rank in the block); each group commits its
    grants after every read of the counters; an over-limit row gets
    RESOURCE_EXHAUSTED and the lowest over-limit quota rule."""
    n_q, b = int(ckey.shape[0]), int(ckey.shape[1])
    plan = plan or quota_plan(b)
    dev = ckey.device
    flat = counts.view(-1)
    keys_all = torch.unique(ckey[ckey >= 0].long())     # every live key
    prior = flat[keys_all].long()           # every read before a commit
    add = torch.zeros_like(prior)
    over_rule = torch.full((b,), INT32_MAX, dtype=torch.int32, device=dev)
    for q in range(n_q):
        col = ckey[q]
        run = torch.zeros_like(prior)       # the key's rows in earlier blocks
        qm = int(q_max[q])
        for r0 in range(0, b, plan.rows):
            keys = col[r0:r0 + plan.rows].long()
            act = keys >= 0
            if not bool(act.any()):
                continue
            uniq, inv, n = torch.unique(keys[act], return_inverse=True,
                                        return_counts=True)
            u = torch.searchsorted(keys_all, uniq)
            lo = prior[u] + run[u]                            # per key
            avail = qm - lo
            fits = lo + n - 1 <= INT32_MAX
            g = torch.where(fits & (avail >= n), n,
                            torch.where(fits & (avail <= 0), 0, -1))
            rank = batch_rank(inv.to(torch.int32)).long()     # in the block
            exact = _wrap32(lo[inv] + rank) < qm
            granted = torch.where(g[inv] < 0, exact, g[inv] > 0)
            walked = torch.zeros_like(n).index_add_(0, inv, granted.long())
            add.index_add_(0, u, torch.where(g < 0, walked, g))
            run.index_add_(0, u, n)
            rows = torch.nonzero(act).flatten()[~granted] + r0
            over_rule[rows] = torch.minimum(over_rule[rows], q_rule[q])
    flat[keys_all] = _wrap32(prior + add)
    _mark_over(over_rule, row0, status, deny_rule)


def quota_rank_plain(ckey: torch.Tensor, counts: torch.Tensor,
                     q_max: torch.Tensor, q_rule: torch.Tensor,
                     status: torch.Tensor, deny_rule: torch.Tensor,
                     row0: int = 0) -> None:
    """The reference's quota rank / grant / commit (as verdict_fold_plain
    computes it: one stable sort of the Q·B composite keys, batch_rank)
    on key columns ckey int32 [Q, B] (< 0 inactive), in place as
    quota_grant_plain: counts [Q, NB] updated, status / deny_rule int32
    [Bd] of the rows from row0."""
    n_q, b = int(ckey.shape[0]), int(ckey.shape[1])
    act = ckey >= 0
    rank = batch_rank(torch.where(act, ckey, INT32_MAX).reshape(-1)) \
        .reshape(n_q, b)
    flat = counts.view(-1)
    key = torch.where(act, ckey, 0).long()
    granted = act & (flat[key] + rank < q_max[:n_q, None])
    over = act & ~granted
    rule = torch.where(over, q_rule[:n_q, None], INT32_MAX).min(dim=0) \
        .values if n_q else torch.full((b,), INT32_MAX, dtype=torch.int32)
    flat.index_add_(0, key[granted], torch.ones_like(key[granted],
                                                     dtype=torch.int32))
    _mark_over(rule.to(torch.int32), row0, status, deny_rule)


_K = kernels
_FOLD_ARGS = ([_K.VP, _K.VP, _K.VP, _K.I32, _K.I32]           # matched..R
              + [_K.VP, _K.I32, _K.VP, _K.VP, _K.VP]           # word tables
              + [_K.VP] * 3                                    # deny
              + [_K.I32, _K.I32] + [_K.VP] * 7                 # lists
              + [_K.VP, _K.VP]                                 # list states
              + [_K.I32, _K.I32] + [_K.VP] * 4                 # rbac
              + [_K.VP, _K.VP, _K.VP, _K.I32]                  # batch planes
              + [_K.I32, _K.I32] + [_K.VP] * 5                 # quota
              + [_K.VP, _K.I32, _K.I32, _K.I32]                # ref table
              + [_K.VP] * 6 + [_K.VP]                          # outs, ckey
              + [_K.I32] * 5 + [_K.VP, _K.VP])                 # plan, stream


def verdict_fold(matched: torch.Tensor, err: torch.Tensor,
                 req_ns: torch.Tensor, batch: AttributeBatch,
                 params: Mapping[str, torch.Tensor],
                 quota_counts: torch.Tensor, c: FoldConsts,
                 lstate: torch.Tensor | None = None,
                 list_kind: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, ...]:
    """The verdict fold of one batch: namespace mask, deny fold, list
    fold (id scan, or the list_banks state bytes `lstate` for the lists
    whose `list_kind` is non-zero), RBAC any-allow fold, quota rank /
    grant / commit (quota_counts updated in place) and referenced
    attributes → (status, dur, uses, deny_rule, referenced, err_count).
    CPU tensors run verdict_fold_plain."""
    if matched.device.type == "cpu":
        return verdict_fold_plain(matched, err, req_ns, batch, params,
                                  quota_counts, c, lstate, list_kind)
    if matched.device.type != "cuda":
        raise ValueError(f"verdict_fold: unsupported device {matched.device}")
    dev = matched.device
    b, n_rules = matched.shape
    want = {"matched": (matched, torch.bool, (b, n_rules)),
            "err": (err, torch.bool, (b, n_rules)),
            "req_ns": (req_ns, torch.int32, (b,)),
            "quota_counts": (quota_counts, torch.int32, None)}
    for k, dt in (("pe_deny_status", torch.int32),
                  ("pe_deny_dur", torch.float32),
                  ("pe_deny_uses", torch.int32)):
        want[k] = (params[k], dt, (n_rules,))
    for k, dt in (("pe_list_ids", torch.int32), ("pe_list_rule", torch.int32),
                  ("pe_list_slot", torch.int32), ("pe_list_black", torch.bool),
                  ("pe_list_code", torch.int32), ("pe_list_dur", torch.float32),
                  ("pe_list_uses", torch.int32), ("pe_q_rule", torch.int32),
                  ("pe_q_slot", torch.int32), ("pe_q_max", torch.int32),
                  ("pe_q_nb", torch.int32), ("pe_ref_table", torch.bool),
                  ("pe_rb_rule", torch.int32), ("pe_rb_dur", torch.float32),
                  ("pe_rb_guard", torch.int32),
                  ("pe_rb_allow", torch.int32)):
        want[k] = (params[k], dt, None)
    if lstate is not None:
        want["lstate"] = (lstate, torch.uint8, None)
        want["list_kind"] = (list_kind, torch.uint8, None)
    for k, dt in (("ids", torch.int32), ("present", torch.bool),
                  ("hash_ids", torch.int32)):
        want[k] = (getattr(batch, k), dt, None)
    for k, (t, dt, shape) in want.items():
        if t.device != dev or t.dtype != dt or not t.is_contiguous() or \
                (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"verdict_fold: {k} must be a contiguous {dt} "
                             f"{shape or ''} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    check_word_tables("verdict_fold", params, n_rules, dev)
    check_plane_pair("verdict_fold", matched, err)
    n_lists = int(params["pe_list_rule"].shape[0]) if c.has_lists else 0
    n_q = int(quota_counts.shape[0]) if c.has_quota else 0
    n_rbac = int(params["pe_rb_rule"].shape[0]) if c.has_rbac else 0
    if lstate is not None and (tuple(lstate.shape) != (b, n_lists) or
                               tuple(list_kind.shape) != (n_lists,)):
        raise ValueError(f"verdict_fold: lstate {tuple(lstate.shape)} / "
                         f"list_kind {tuple(list_kind.shape)} do not fit "
                         f"{b} rows × {n_lists} lists")
    table = params["pe_ref_table"]
    status = torch.empty(b, dtype=torch.int32, device=dev)
    dur = torch.empty(b, dtype=torch.float32, device=dev)
    uses = torch.empty(b, dtype=torch.int32, device=dev)
    deny_rule = torch.empty(b, dtype=torch.int32, device=dev)
    referenced = torch.empty((b, c.n_attr_cols), dtype=torch.bool,
                             device=dev)
    err_count = torch.zeros((), dtype=torch.int32, device=dev)
    ckey = torch.empty((max(n_q, 1), b), dtype=torch.int32, device=dev)
    plan = quota_plan(b)
    scratch = torch.empty(max(plan.scratch_words(n_q), 1),
                          dtype=torch.int32, device=dev)
    if b == 0:
        return status, dur, uses, deny_rule, referenced, err_count
    p = kernels.ptr
    null = kernels.VP(0)
    fn = kernels.function("verdict_fold", "verdict_fold", _FOLD_ARGS)
    rc = fn(p(matched), p(err), p(req_ns), b, n_rules,
            p(params["pe_vis_ns"]), int(params["pe_vis_ns"].shape[0]),
            p(params["pe_vis_words"]), p(params["pe_deny_words"]),
            p(params["pe_err_words"]), p(params["pe_deny_status"]),
            p(params["pe_deny_dur"]), p(params["pe_deny_uses"]),
            n_lists, int(params["pe_list_ids"].shape[1]),
            p(params["pe_list_ids"]), p(params["pe_list_rule"]),
            p(params["pe_list_slot"]), p(params["pe_list_black"]),
            p(params["pe_list_code"]), p(params["pe_list_dur"]),
            p(params["pe_list_uses"]),
            null if lstate is None else p(list_kind),
            null if lstate is None else p(lstate),
            n_rbac, int(params["pe_rb_allow"].shape[1]),
            p(params["pe_rb_rule"]), p(params["pe_rb_dur"]),
            p(params["pe_rb_guard"]), p(params["pe_rb_allow"]),
            p(batch.ids), p(batch.present), p(batch.hash_ids),
            int(batch.ids.shape[1]),
            n_q, int(quota_counts.shape[1]), p(params["pe_q_rule"]),
            p(params["pe_q_slot"]), p(params["pe_q_max"]),
            p(params["pe_q_nb"]), p(quota_counts),
            p(table), int(table.shape[0]), int(table.shape[1]),
            c.n_attr_cols,
            p(status), p(dur), p(uses), p(deny_rule), p(referenced),
            p(err_count), p(ckey), *plan.args, p(scratch),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("verdict_fold", kernels.check(rc, "verdict_fold"),
                     matched, err, req_ns, batch, params, quota_counts, c,
                     lstate, list_kind)
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
        for l in lists:
            if l.entry_type not in _LIST_TYPES:
                raise ValueError(f"unknown list entry_type {l.entry_type}")
        if ruleset is None:
            if rules is None or finder is None:
                raise ValueError("PolicyEngine needs rules + finder, or a "
                                 "compiled ruleset")
            # REGEX / CIDR lists match value BYTES: their value attrs
            # need byte (and, for map reads, derived) layout slots
            lsrcs = [l.value_attr for l in lists
                     if l.entry_type in ("REGEX", "IP_ADDRESSES")]
            ruleset = compile_ruleset(
                rules, finder, interner=interner, max_str_len=max_str_len,
                extra_derived_keys=[r for r in lsrcs
                                    if isinstance(r, tuple)],
                extra_byte_sources=sorted(set(lsrcs), key=str), device=dev)
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

        # --- list tensors ---
        n_lists = len(lists)
        max_entries = max((len(l.entries) for l in lists
                           if l.entry_type == "STRINGS"), default=1) or 1
        # int32 ids: the reference builds int64 and jax (no x64) narrows
        list_ids = np.zeros((max(n_lists, 1), max_entries), np.int32)
        list_rule = np.zeros(max(n_lists, 1), np.int32)
        list_slot = np.zeros(max(n_lists, 1), np.int32)
        list_black = np.zeros(max(n_lists, 1), bool)
        list_code = np.full(max(n_lists, 1), PERMISSION_DENIED, np.int32)
        list_dur = np.full(max(n_lists, 1), _BIG, np.float32)
        list_uses = np.full(max(n_lists, 1), INT32_MAX, np.int32)
        list_kind = np.zeros(max(n_lists, 1), np.uint8)
        for i, l in enumerate(lists):
            if l.entry_type == "STRINGS":
                ids = [interner.intern(e) for e in l.entries]
                # pad with ID_INVALID: a present slot's id is never 0
                list_ids[i, :len(ids)] = ids
            else:
                # REGEX / IP rows keep all-zero ids; their membership
                # comes from the list_banks kernels' state bytes
                list_kind[i] = 1
            list_rule[i] = l.rule
            list_slot[i] = self._slot_for(l.value_attr)
            list_black[i] = l.blacklist
            # blacklist hit → PERMISSION_DENIED, whitelist miss → NOT_FOUND
            list_code[i] = PERMISSION_DENIED if l.blacklist else NOT_FOUND
            list_dur[i] = l.valid_duration_s
            list_uses[i] = l.valid_use_count

        self._max_len = int(self.ruleset.layout.max_str_len)
        self._dfa_banks, self._rx_lists = self._build_regex_banks(lists)
        self._cidr_lists = self._build_cidr_bank(lists)
        self._list_kind = torch.from_numpy(list_kind).to(dev)
        self._list_rule = list_rule[:n_lists]
        self._shard_list_cache: dict[tuple[int, int], tuple] = {}

        # --- rbac tensors ---
        n_rbac = len(rbacs)
        k_allow = max((len(r.allow_rows) for r in rbacs), default=1) or 1
        # indices into [matched | FALSE col | TRUE col]: padding of allow
        # rows points at FALSE (OR identity), a missing guard at TRUE
        false_col, true_col = n_rows, n_rows + 1
        rb_rule = np.zeros(max(n_rbac, 1), np.int32)
        rb_dur = np.full(max(n_rbac, 1), _BIG, np.float32)
        rb_guard = np.full(max(n_rbac, 1), true_col, np.int32)
        rb_allow = np.full((max(n_rbac, 1), k_allow), false_col, np.int32)
        for i, r in enumerate(rbacs):
            rb_rule[i] = r.rule
            rb_dur[i] = r.valid_duration_s
            if r.guard_row >= 0:
                rb_guard[i] = r.guard_row
            rb_allow[i, :len(r.allow_rows)] = r.allow_rows

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
            # port-only: its rule-word tables (fold_word_tables)
            **fold_word_tables(self.ruleset.rule_ns, default_ns, deny_mask,
                               err_rule_mask),
        }
        if err_rule_mask is not None:
            pe["pe_err_rule_mask"] = err_rule_mask
        pe_params = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in pe.items()}
        self.fold_consts = FoldConsts(default_ns=default_ns,
                                      has_lists=n_lists > 0,
                                      has_quota=self._has_quota,
                                      n_attr_cols=n_attr_cols,
                                      has_rbac=n_rbac > 0)
        # ruleset index tensors + the engine bank tensors — the one
        # argument dict every step takes (interop.params_from_reference
        # builds the same dict from the JAX package's engine)
        self.params = {**self.ruleset.params, **pe_params}
        # the step check() runs: this one, or a mesh's sharded step
        # (parallel/mesh.shard_engine_check, set by runtime/fused.py)
        self._step = self.step

    def step(self, params: Mapping[str, torch.Tensor], batch: AttributeBatch,
             req_ns: Any, quota_counts: torch.Tensor
             ) -> tuple[CheckVerdict, torch.Tensor]:
        """One fused check step (the reference's raw_step): → (verdict,
        quota_counts), the counts updated in place."""
        batch = batch.to(self.device)
        req = torch.as_tensor(np.asarray(req_ns, np.int32)) \
            if not isinstance(req_ns, torch.Tensor) else req_ns
        req = req.to(device=self.device, dtype=torch.int32).contiguous()
        matched, _, err = self.ruleset.fn(params, batch, ("matched", "err"))
        lstate = self.list_states(batch, err)
        status, dur, uses, deny_rule, referenced, err_count = verdict_fold(
            matched, err, req, batch, params, quota_counts,
            self.fold_consts, lstate,
            self._list_kind if lstate is not None else None)
        verdict = CheckVerdict(status=status, valid_duration_s=dur,
                               valid_use_count=uses, referenced=referenced,
                               matched=matched, err=err,
                               deny_rule=deny_rule, err_count=err_count)
        return verdict, quota_counts

    raw_step = step

    def list_states(self, batch: AttributeBatch, err: torch.Tensor,
                    rules: tuple[int, int] | None = None
                    ) -> torch.Tensor | None:
        """State bytes of the REGEX and IP_ADDRESSES lists, uint8 [B, NL]
        (bytes_ops.LIST_*; zero for STRINGS lists), or None when there
        are none: one dfa_scan per regex bank, then one list_banks
        launch for both banks. The regex banks OR their undecidable rows
        into `err` in place (the reference's err plane after its list
        fold).
        `rules` (r0, r1): a mesh shard's rule slice — only the lists of
        rules in [r0, r1) are evaluated (the others' bytes stay zero),
        and `err` is that slice's plane [B, r1 - r0]."""
        if self._rx_lists is None and self._cidr_lists is None:
            return None
        rx, cidr = (self._rx_lists, self._cidr_lists) if rules is None \
            else self._shard_lists(*rules)
        b = int(batch.ids.shape[0])
        n_lists = int(self._list_kind.shape[0])
        lstate = torch.zeros((b, n_lists), dtype=torch.uint8,
                             device=batch.ids.device)
        acc = None
        if rx is not None:
            accs = [bytes_ops.dfa_scan(batch.str_bytes[:, bslot],
                                       batch.str_lens[:, bslot], bank)
                    for bslot, bank in self._dfa_banks]
            acc = accs[0] if len(accs) == 1 else torch.cat(accs, dim=1)
        if rx is not None or cidr is not None:
            bytes_ops.list_banks(acc, batch.str_bytes, batch.str_lens,
                                 self._max_len, rx, cidr, lstate, err)
        return lstate

    def _shard_lists(self, r0: int, r1: int) -> tuple:
        """(RegexLists, CidrLists) of the lists whose rule lies in [r0,
        r1), rules renumbered into the slice (None where none lies
        there); list positions and acceptance columns stay global."""
        hit = self._shard_list_cache.get((r0, r1))
        if hit is not None:
            return hit
        rx, cidr = self._rx_lists, self._cidr_lists
        rx_s = cidr_s = None
        if rx is not None:
            keep = [j for j in range(rx.n) if r0 <= int(rx.rule[j]) < r1]
            if keep:
                pats = [rx.pat[rx.ptr[j]:rx.ptr[j + 1]] for j in keep]
                rx_s = bytes_ops.RegexLists(
                    pos=rx.pos[keep], rule=rx.rule[keep] - r0,
                    bslot=rx.bslot[keep],
                    ptr=np.cumsum([0] + [len(x) for x in pats],
                                  dtype=np.int64).astype(np.int32),
                    pat=np.concatenate(pats + [np.zeros(
                        0 if any(len(x) for x in pats) else 1)])
                    .astype(np.int32),
                    pdef=rx.pdef)
        if cidr is not None:
            keep = [k for k in range(int(cidr.pos.shape[0]))
                    if r0 <= int(self._list_rule[cidr.pos[k]]) < r1]
            if keep:
                cidr_s = bytes_ops.CidrLists(
                    **{f: getattr(cidr, f)[keep] for f in cidr._fields})
        self._shard_list_cache[(r0, r1)] = (rx_s, cidr_s)
        return rx_s, cidr_s

    def _slot_for(self, attr: Any) -> int:
        lay = self.ruleset.layout
        if isinstance(attr, tuple):
            if attr not in lay.derived_slots:
                raise ValueError(f"no derived slot for {attr}; reference it "
                                 "in a rule or add it to derived_keys")
            return lay.derived_slots[attr]
        return lay.slot_of(attr)

    def _byte_slot_for(self, l: ListEntrySpec) -> int:
        bslot = self.ruleset.layout.byte_slots.get(l.value_attr)
        if bslot is None:
            raise ValueError(
                f"{l.entry_type} list value {l.value_attr!r} has no byte "
                "slot; pass it via compile_ruleset(extra_byte_sources=...)")
        return bslot

    def _build_regex_banks(self, lists: Sequence[ListEntrySpec]
                           ) -> tuple[list, bytes_ops.RegexLists | None]:
        """REGEX lists grouped by value byte slot → one DFA bank per slot
        (patterns deduplicated within a bank, in the reference's order)
        and the lists' CSR pattern rows over the banks' acceptance
        columns, concatenated in byte-slot order. → ([(bslot, DfaBank)],
        RegexLists or None). Raises UnsupportedRegex for patterns outside
        the DFA subset (runtime/fused.py gates fusability on that)."""
        from istio_tpu_torch.ops.regex_dfa import (compile_regex,
                                                   pack_dfas_tiered)

        groups: dict[int, dict] = {}
        for i, l in enumerate(lists):
            if l.entry_type != "REGEX":
                continue
            bslot = self._byte_slot_for(l)
            g = groups.setdefault(bslot, {"pat_idx": {}, "dfas": [],
                                          "dollar": [], "lists": []})
            idxs = []
            for e in l.entries:
                e = str(e)
                j = g["pat_idx"].get(e)
                if j is None:
                    j = len(g["dfas"])
                    g["pat_idx"][e] = j
                    g["dfas"].append(compile_regex(e))
                    g["dollar"].append("$" in e)
                idxs.append(j)
            g["lists"].append((i, idxs))
        if not groups:
            return [], None
        banks, pos, rule, bslots, ptr, pat, pdef = [], [], [], [], [0], [], []
        for bslot in sorted(groups):
            g = groups[bslot]
            off = len(pdef)
            banks.append((bslot, bytes_ops.DfaBank.of(
                pack_dfas_tiered(g["dfas"])["classes"])))
            pdef.extend(not d for d in g["dollar"])
            for i, idxs in g["lists"]:
                pos.append(i)
                rule.append(lists[i].rule)
                bslots.append(bslot)
                pat.extend(off + j for j in idxs)
                ptr.append(len(pat))
        return banks, bytes_ops.RegexLists(
            pos=np.asarray(pos, np.int32), rule=np.asarray(rule, np.int32),
            bslot=np.asarray(bslots, np.int32),
            ptr=np.asarray(ptr, np.int32),
            pat=np.asarray(pat or [0], np.int32),
            pdef=np.asarray(pdef, np.uint8))

    def _build_cidr_bank(self, lists: Sequence[ListEntrySpec]
                         ) -> bytes_ops.CidrLists | None:
        """IP_ADDRESSES lists → per-entry (prefix, mask) byte rows in
        v6-mapped space. v4 nets map to ::ffff:0:0/96+len; membership
        also requires the value's v4/v6 version to equal the entry's
        (ipaddress `addr in net` is version-strict — host parity with
        list_adapter._member)."""
        items = [(i, l) for i, l in enumerate(lists)
                 if l.entry_type == "IP_ADDRESSES"]
        if not items:
            return None
        return bytes_ops.CidrLists.of(
            [i for i, _ in items], [self._byte_slot_for(l) for _, l in items],
            [list(l.entries) for _, l in items])

    # ------------------------------------------------------------------
    def check(self, batch: AttributeBatch, req_ns: Any) -> CheckVerdict:
        """With device quotas this is a read-modify-write on
        quota_counts and must not run concurrently."""
        verdict, _ = self._step(self.params, batch, req_ns,
                                 self.quota_counts)
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
