"""The verdict fold's word formulation against the JAX package's: the
port's rule-word tables (models/policy_engine.fold_word_tables: each
request namespace's visible rules, the deny rules and the rules the
error count covers, as 32-rule bit words) and the plain version that
folds from them (verdict_fold_words_plain, the formulation of the
verdict_fold and mesh_partial kernels) must give every verdict field of
the reference's PolicyEngine step exactly, and equal the port's plain
version (verdict_fold_plain), quota counters included — on the headline
world at make_store(300), make_rbac_store(50), tests/test_fused_serving's
REGEX / CIDR list world and a make_engine(300) quota world with small
limits, at B = 0, 1, 31, 32, 33 and 97, with request namespaces -1, -7
(the rule-axis pad), the default, the largest id and one past it, and
the int32 extremes. The reference cannot run a zero-row batch (a max over
an empty axis), so at B = 0 the word plain version is held against the
port's plain version alone. The vis rows equal the reference ruleset's
namespace mask for each of those namespaces, and the records of windows
of the rule axis that start off a 32-rule word combine (min / sum / OR,
combine_fold_records) into the unsharded verdict. The port runs on the
CPU."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.attribute.global_dict import GLOBAL_MANIFEST as REF_MANIFEST
from istio_tpu.models import policy_engine as ref_pe
from istio_tpu.runtime import fused as ref_fused
from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.ops.bytes_ops import unpack_bits
from istio_tpu_torch.runtime import fused
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


VERDICT = ("status", "valid_duration_s", "valid_use_count", "deny_rule",
           "referenced", "err_count")
BATCHES = (0, 1, 31, 32, 33, 97)
EDGE_NS = (-1, -7, 0, "max", "max+1", -2 ** 31, 2 ** 31 - 1)
WORLD_NAMES = ("headline", "rbac", "lists", "quota")


def _load(name):
    path = pathlib.Path(__file__).with_name(name)
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _namespace_of(d):
    v = d.get("destination.service")
    parts = v.split(".") if isinstance(v, str) else []
    return parts[1] if len(parts) >= 2 and parts[1] else ""


def edge_values(ruleset) -> list[int]:
    """EDGE_NS with the ruleset's largest namespace id filled in."""
    top = max(ruleset.ns_ids.values())
    return [top if v == "max" else top + 1 if v == "max+1" else v
            for v in EDGE_NS]


class World:
    """One world built by both packages: `ref` / `got` engines (and, for
    a store world, the snapshots and fused plans), a traffic of dicts and
    their request namespaces."""

    def __init__(self, name):
        self.name = name
        self.ref_plan = self.got_plan = None
        if name == "quota":
            # make_engine(300, with_quota=True) at a limit of 3 (the
            # reference's make_engine has no limit argument)
            n = 300
            self.ref = ref_pe.PolicyEngine(
                ref_workloads.make_rules(n), ref_workloads.MESH_FINDER,
                deny=[ref_pe.DenySpec(rule=i) for i in range(0, n, 3)],
                lists=[ref_pe.ListEntrySpec(
                    rule=i, value_attr="source.namespace",
                    entries=[f"ns{j}" for j in range(0, 23, 2)])
                    for i in range(1, n, 97)],
                quotas=[ref_pe.QuotaSpec(rule=i, key_attr="source.user",
                                         max_amount=3)
                        for i in range(2, n, 301)])
            self.got = workloads.make_engine(n, with_quota=True,
                                             device="cpu", quota_max=3)
            self.ref_tz, self.got_tz = self.ref.tensorizer, self.got.tensorizer
            self.ref_rs, self.got_rs = self.ref.ruleset, self.got.ruleset
            self.dicts, ns = workloads.make_hit_requests(300, 97, seed=11)
            self.ns = [self.got_rs.namespace_id(x) for x in ns]
            return
        ref_man, got_man = REF_MANIFEST, GLOBAL_MANIFEST
        if name == "headline":
            ref_store = ref_workloads.make_store(300)
            self.dicts, _ = workloads.make_hit_requests(300, 97, seed=12)
        elif name == "rbac":
            ref_store = ref_workloads.make_rbac_store(50)
            ref_man, got_man = ref_workloads.MESH_MANIFEST, \
                workloads.MESH_MANIFEST
            self.dicts = workloads.make_rbac_request_dicts(97, seed=13)
        else:
            lists = _load("test_torch_lists.py")
            ref_store = lists._fused_serving_module()._store()
            self.dicts = lists.list_world_dicts()
        got_store = interop.store_from_reference(ref_store)
        rsnap = RefBuilder(ref_man).build(ref_store)
        psnap = SnapshotBuilder(got_man, device="cpu").build(got_store)
        ref_store.close()
        got_store.close()
        self.ref_plan = ref_fused.build_fused_plan(rsnap,
                                                   rule_telemetry=False)
        self.got_plan = fused.build_fused_plan(psnap, rule_telemetry=False)
        self.ref, self.got = self.ref_plan.engine, self.got_plan.engine
        self.ref_tz, self.got_tz = rsnap.tensorizer, psnap.tensorizer
        self.ref_rs, self.got_rs = rsnap.ruleset, psnap.ruleset
        self.ns = [self.got_rs.namespace_id(_namespace_of(d))
                   for d in self.dicts]

    def batch(self, b: int):
        """B rows of the traffic (tiled), every other row's namespace one
        of the edge values → (ref batch, port batch, req int32 [B],
        dicts)."""
        dicts = [self.dicts[i % len(self.dicts)] for i in range(b)]
        req = np.asarray([self.ns[i % len(self.ns)] for i in range(b)],
                         np.int32)
        vals = edge_values(self.got_rs)
        req[0::2] = [vals[i % len(vals)] for i in range(len(req[0::2]))]
        rb = self.ref_tz.tensorize([ref_bag(d) for d in dicts])
        if b:
            pb = self.got_tz.tensorize([bag_from_mapping(d) for d in dicts])
        else:
            # a zero-row slice of a batch: tensorize([]) gives planes of
            # zero strides, which the CIDR list wrapper refuses
            pb = self.got_tz.tensorize([bag_from_mapping(self.dicts[0])]) \
                .rows(0, 0)
        return rb, pb, req, dicts

    def fold_inputs(self, pb, req):
        """The port's verdict_fold inputs for a port batch → (matched,
        err, req, batch, params, consts, lstate, list_kind)."""
        eng = self.got
        matched, _, err = eng.ruleset.fn(eng.params, pb, ("matched", "err"))
        lstate = eng.list_states(pb, err)
        kind = eng._list_kind if lstate is not None else None
        return (matched, err, torch.from_numpy(req), pb, eng.params,
                eng.fold_consts, lstate, kind)


@pytest.fixture(scope="module")
def worlds():
    made: dict = {}

    def get(name):
        if name not in made:
            made[name] = World(name)
        return made[name]
    return get


def _assert_verdict(got, want_v, label):
    for f, g in zip(VERDICT, got):
        want = np.asarray(getattr(want_v, f))
        have = g.numpy()
        assert have.shape == want.shape, (label, f)
        assert have.dtype == want.dtype, (label, f)
        np.testing.assert_array_equal(have, want, err_msg=f"{label}.{f}")


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("name", WORLD_NAMES)
def test_words_fold_matches_reference_step(worlds, name, b):
    w = worlds(name)
    rb, pb, req, _ = w.batch(b)
    m, e, rq, batch, params, c, lstate, kind = w.fold_inputs(pb, req)
    q0 = w.got.quota_counts.clone()
    if b:
        if name == "quota":
            q0 = torch.from_numpy(np.asarray(w.ref.quota_counts).copy())
        ref_v = w.ref.check(rb, req)
    qw, qp = q0.clone(), q0.clone()
    words = pe.verdict_fold_words_plain(m, e, rq, batch, params, qw, c,
                                        lstate, kind)
    plain = pe.verdict_fold_plain(m, e, rq, batch, params, qp, c, lstate,
                                  kind)
    for f, x, y in zip(VERDICT, words, plain):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert torch.equal(qw, qp)
    if b:
        _assert_verdict(words, ref_v, f"{name} B={b}")
        np.testing.assert_array_equal(qw.numpy(),
                                      np.asarray(w.ref.quota_counts))
    if name == "quota" and b == 97:
        assert {pe.OK, pe.RESOURCE_EXHAUSTED} <= set(words[0].tolist())


@pytest.mark.parametrize("name", WORLD_NAMES)
def test_vis_rows_equal_the_namespace_mask(worlds, name):
    w = worlds(name)
    params = w.got.params
    n_rules = int(w.got_rs.rule_ns.shape[0])
    vals = sorted(set(edge_values(w.got_rs)) | set(w.got_rs.ns_ids.values())
                  | {-7})
    req = np.asarray(vals, np.int32)
    want = np.asarray(w.ref_rs.namespace_mask(req))
    rows = pe.vis_rows(torch.from_numpy(req), params["pe_vis_ns"])
    have = unpack_bits(params["pe_vis_words"], n_rules)[rows].numpy()
    np.testing.assert_array_equal(have, want)
    # the pad namespace has a row of its own where the axis is padded,
    # and the unknown ones share the default-only row
    v = int(params["pe_vis_ns"].shape[0])
    padded = bool((w.got_rs.rule_ns == -7).any())
    assert padded == (name != "quota")
    assert (int(pe.vis_rows(torch.tensor([-7], dtype=torch.int32),
                            params["pe_vis_ns"])[0]) < v) == padded
    assert int(pe.vis_rows(torch.tensor([-1], dtype=torch.int32),
                           params["pe_vis_ns"])[0]) == v
    deny = unpack_bits(params["pe_deny_words"], n_rules).numpy()
    np.testing.assert_array_equal(deny, params["pe_deny_mask"].numpy())
    mask = params.get("pe_err_rule_mask")
    errw = unpack_bits(params["pe_err_words"], n_rules).numpy()
    np.testing.assert_array_equal(
        errw, np.ones(n_rules, bool) if mask is None else mask.numpy())


def window_cuts(n_rules: int) -> list[int]:
    """Window boundaries of the rule axis, most of them off a 32-rule
    word, with odd widths where the axis allows."""
    inner = {c for c in (37, 101, n_rules // 2 + 3, n_rules - 5)
             if 0 < c < n_rules}
    return sorted({0, n_rules} | inner)


@pytest.mark.parametrize("name", WORLD_NAMES)
def test_window_records_combine_into_the_unsharded_fold(worlds, name):
    w = worlds(name)
    rb, pb, req, _ = w.batch(97)
    m, e, rq, batch, params, c, lstate, kind = w.fold_inputs(pb, req)
    n_rules = int(m.shape[1])
    cuts = window_cuts(n_rules)
    assert any(r0 % 32 for r0 in cuts[1:-1])
    recs, flags = [], []
    for r0, r1 in zip(cuts, cuts[1:]):
        rec, flag = pe.verdict_fold_words_plain(
            m[:, r0:r1].contiguous(), e[:, r0:r1].contiguous(), rq, batch,
            params, None, c, lstate, kind, window=(r0, r1))
        assert rec.shape == (pe.REC_ROWS, 97) and rec.dtype == torch.int32
        recs.append(rec)
        flags.append(flag)
    q0 = w.got.quota_counts.clone()
    if name == "quota":
        q0 = torch.from_numpy(np.asarray(w.ref.quota_counts).copy())
    ref_v = w.ref.check(rb, req)
    qc, qp = q0.clone(), q0.clone()
    got = pe.combine_fold_records(recs, flags, rq, batch, params, qc, c)
    plain = pe.verdict_fold_plain(m, e, rq, batch, params, qp, c, lstate,
                                  kind)
    for f, x, y in zip(VERDICT, got, plain):
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert torch.equal(qc, qp)
    _assert_verdict(got, ref_v, f"{name} windows {cuts}")
    np.testing.assert_array_equal(qc.numpy(), np.asarray(w.ref.quota_counts))
    # the windows' records, each a min / sum / OR: the error counts sum,
    # the deny rules min
    rec = torch.stack(recs)
    whole, _ = pe.verdict_fold_words_plain(m, e, rq, batch, params, None, c,
                                           lstate, kind,
                                           window=(0, n_rules))
    assert torch.equal(rec[:, pe.REC_ERR].sum(0, dtype=torch.int32),
                       whole[pe.REC_ERR])
    assert torch.equal(rec[:, pe.REC_DENY].min(0).values,
                       whole[pe.REC_DENY])
