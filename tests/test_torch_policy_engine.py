"""The port's PolicyEngine against the JAX package's: every CheckVerdict
field (status, valid_duration_s, valid_use_count, referenced, matched,
err, deny_rule, err_count) and the quota counters must be equal exactly,
batch after batch with quota state carried, on make_engine worlds either
side of the reference's pairwise / sort quota-rank switch at B=256, on
small quotas that run out, on the tests/test_policy_engine.py scenarios,
and when fed the reference's own compiled params through interop."""
import jax
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.compiler.ruleset import Rule as RefRule
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.models import policy_engine as ref_pe
from istio_tpu.testing import workloads as ref_workloads
from istio_tpu.testing.corpus import CORPUS_MANIFEST

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.compiler.ruleset import Rule
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FIELDS = ("status", "valid_duration_s", "valid_use_count", "referenced",
          "matched", "err", "deny_rule", "err_count")

REF_FINDER = RefFinder(CORPUS_MANIFEST)
PT_FINDER = AttributeDescriptorFinder(
    interop.manifest_from_reference(CORPUS_MANIFEST))


def _assert_verdicts_equal(ref_v, got_v):
    for f in FIELDS:
        want = np.asarray(getattr(ref_v, f))
        have = getattr(got_v, f).numpy()
        assert have.shape == want.shape, f
        assert have.dtype == want.dtype, f
        np.testing.assert_array_equal(have, want, err_msg=f)


def _step_both(ref, got, dicts, req_ns):
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in dicts])
    pb = got.tensorizer.tensorize([DictBag(d) for d in dicts])
    req = np.asarray(req_ns, np.int32)
    ref_v = ref.check(rb, req)
    got_v = got.check(pb, req)
    _assert_verdicts_equal(ref_v, got_v)
    np.testing.assert_array_equal(got.quota_counts.numpy(),
                                  np.asarray(ref.quota_counts))
    return got_v


def _mesh_engines(n_rules, quota_max):
    """The make_engine world at any quota limit, built by both."""
    rules = ref_workloads.make_rules(n_rules)
    ref = ref_pe.PolicyEngine(
        rules, ref_workloads.MESH_FINDER,
        deny=[ref_pe.DenySpec(rule=i) for i in range(0, n_rules, 3)],
        lists=[ref_pe.ListEntrySpec(
            rule=i, value_attr="source.namespace",
            entries=[f"ns{j}" for j in range(0, 23, 2)])
            for i in range(1, n_rules, 97)],
        quotas=[ref_pe.QuotaSpec(rule=i, key_attr="source.user",
                                 max_amount=quota_max)
                for i in range(2, n_rules, 301)])
    got = workloads.make_engine(n_rules, with_quota=True, device="cpu",
                                quota_max=quota_max)
    return ref, got


@pytest.mark.parametrize("batch", [64, 300])
def test_make_engine_matches_reference_over_batches(batch):
    ref = ref_workloads.make_engine(1000, with_quota=True)
    got = workloads.make_engine(1000, with_quota=True, device="cpu")
    for k in ref.params:
        want = np.asarray(ref.params[k])
        have = got.params[k].numpy()
        if k == "pe_attr_mask_bits":
            have = have.view(np.uint32)
        np.testing.assert_array_equal(have, want, err_msg=k)
    statuses = set()
    for step in range(3):
        dicts, ns = workloads.make_hit_requests(1000, batch, seed=step)
        dicts[:16] = workloads.make_request_dicts(16, seed=step + 1)
        v = _step_both(ref, got, dicts,
                       [got.ruleset.namespace_id(x) for x in ns])
        statuses |= set(v.status.tolist())
    assert {pe.OK, pe.NOT_FOUND, pe.PERMISSION_DENIED} <= statuses


@pytest.mark.parametrize("batch", [64, 300])
def test_small_quotas_run_out_like_reference(batch):
    ref, got = _mesh_engines(700, quota_max=3)
    exhausted = 0
    for step in range(4):
        dicts, ns = workloads.make_hit_requests(700, batch, seed=40 + step)
        v = _step_both(ref, got, dicts,
                       [got.ruleset.namespace_id(x) for x in ns])
        exhausted += int((v.status == pe.RESOURCE_EXHAUSTED).sum())
    assert exhausted > 0
    got.reset_quota()
    assert int(got.quota_counts.sum()) == 0


def test_reference_params_through_the_port_step():
    """interop carries the reference's compiled params, batch and quota
    state; the port's step on them equals the reference raw_step."""
    ref = ref_workloads.make_engine(400, with_quota=True)
    got = workloads.make_engine(400, with_quota=True, device="cpu")
    dicts, ns = workloads.make_hit_requests(400, 96, seed=8)
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in dicts])
    req = np.asarray([got.ruleset.namespace_id(x) for x in ns], np.int32)
    counts = np.zeros(np.asarray(ref.quota_counts).shape, np.int32)
    counts[:, ::7] = 3
    ref_v, ref_counts = jax.jit(ref.raw_step)(ref.params, rb, req,
                                              counts.copy())
    params = interop.params_from_reference(ref.params, device="cpu")
    for k in ("pe_ref_table", "pe_vis_ns", "pe_vis_words", "pe_deny_words",
              "pe_err_words"):
        np.testing.assert_array_equal(params[k].numpy(),
                                      got.params[k].numpy(), err_msg=k)
    qc = interop.quota_counts_from_reference(counts, device="cpu")
    pb = interop.batch_from_reference(rb, device="cpu")
    got_v, got_counts = got.step(params, pb, req, qc)
    _assert_verdicts_equal(ref_v, got_v)
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(ref_counts))
    # the word formulation of the fold on the same params
    qw = interop.quota_counts_from_reference(counts, device="cpu")
    matched, _, err = got.ruleset.fn(params, pb, ("matched", "err"))
    words = pe.verdict_fold_words_plain(
        matched, err, torch.from_numpy(req), pb, params, qw,
        got.fold_consts, got.list_states(pb, err))
    for f, w in zip(("status", "valid_duration_s", "valid_use_count",
                     "deny_rule", "referenced", "err_count"), words):
        np.testing.assert_array_equal(w.numpy(),
                                      np.asarray(getattr(ref_v, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(qw.numpy(), np.asarray(ref_counts))


# ---- the tests/test_policy_engine.py scenarios, against the reference

def _scenario(rules, kw_ref, kw_pt, batches, ns=None):
    ref = ref_pe.PolicyEngine([RefRule(*r) for r in rules], REF_FINDER,
                              **kw_ref)
    got = pe.PolicyEngine([Rule(*r) for r in rules], PT_FINDER,
                          device="cpu", **kw_pt)
    out = []
    for dicts in batches:
        req = np.zeros(len(dicts), np.int32) if ns is None else [
            got.ruleset.namespace_id(x) for x in ns]
        out.append(_step_both(ref, got, dicts, req))
    return got, out


def _specs(mod, deny=(), lists=(), quotas=()):
    return {"deny": [mod.DenySpec(**d) for d in deny],
            "lists": [mod.ListEntrySpec(**l) for l in lists],
            "quotas": [mod.QuotaSpec(**q) for q in quotas]}


def _both(**kw):
    return _specs(ref_pe, **kw), _specs(pe, **kw)


def test_denier_path():
    kr, kp = _both(deny=[{"rule": 0, "valid_duration_s": 7.0,
                          "valid_use_count": 42}])
    _, (v,) = _scenario([("deny-user", 'request.user == "evil"')], kr, kp,
                        [[{"request.user": "evil"},
                          {"request.user": "good"}, {}]])
    assert v.status.tolist() == [pe.PERMISSION_DENIED, pe.OK, pe.OK]
    assert float(v.valid_duration_s[0]) == 7.0
    assert int(v.valid_use_count[0]) == 42
    assert float(v.valid_duration_s[1]) > 1e30


def test_whitelist_and_blacklist():
    kr, kp = _both(lists=[
        {"rule": 0, "value_attr": "source.namespace",
         "entries": ["ns-a", "ns-b"]},
        {"rule": 1, "value_attr": "request.user", "entries": ["bad"],
         "blacklist": True}])
    _, (v,) = _scenario([("wl", ""), ("bl", "")], kr, kp, [[
        {"source.namespace": "ns-a", "request.user": "ok"},
        {"source.namespace": "ns-z", "request.user": "ok"},
        {"source.namespace": "ns-b", "request.user": "bad"}]])
    assert v.status.tolist() == [pe.OK, pe.NOT_FOUND, pe.PERMISSION_DENIED]


def test_list_absent_value_is_internal():
    kr, kp = _both(lists=[{"rule": 0, "value_attr": "request.user",
                           "entries": ["alice"]}])
    _, (v,) = _scenario([("wl", "")], kr, kp,
                        [[{}, {"request.user": "alice"}]])
    assert v.status.tolist() == [pe.INTERNAL, pe.OK]
    assert float(v.valid_duration_s[0]) == 5.0
    assert float(pe.DEFAULT_DUR) == float(ref_pe.DEFAULT_DUR)
    assert int(pe.DEFAULT_USES) == int(ref_pe.DEFAULT_USES)


def test_quota_fixed_window():
    kr, kp = _both(quotas=[{"rule": 0, "key_attr": "request.user",
                            "max_amount": 3}])
    got, (v1, v2) = _scenario(
        [("q", "")], kr, kp,
        [[{"request.user": "u"}] * 5,
         [{"request.user": "u"}, {"request.user": "other"}]])
    assert sorted(v1.status.tolist()) == [pe.OK] * 3 + \
        [pe.RESOURCE_EXHAUSTED] * 2
    assert v2.status.tolist() == [pe.RESOURCE_EXHAUSTED, pe.OK]
    got.reset_quota()
    batch = got.tensorizer.tensorize([DictBag({"request.user": "u"})])
    assert got.check(batch, np.zeros(1, np.int32)).status.tolist() == [pe.OK]


def test_quota_bucket_stable_across_batches():
    kr, kp = _both(quotas=[{"rule": 0, "key_attr": "request.user",
                            "max_amount": 2}])
    _, (v1, v2) = _scenario(
        [("q", "")], kr, kp,
        [[{"request.user": "u"}, {"request.user": "u"}],
         [{"request.user": "a"}, {"request.user": "b"},
          {"request.user": "u"}]])
    assert v1.status.tolist() == [pe.OK, pe.OK]
    assert v2.status.tolist() == [pe.OK, pe.OK, pe.RESOURCE_EXHAUSTED]


def test_denied_requests_do_not_consume_quota():
    kr, kp = _both(deny=[{"rule": 0}],
                   quotas=[{"rule": 1, "key_attr": "source.namespace",
                            "max_amount": 1}])
    _, (v,) = _scenario(
        [("deny", 'request.user == "evil"'), ("q", "")], kr, kp,
        [[{"request.user": "evil", "source.namespace": "ns"},
          {"request.user": "good", "source.namespace": "ns"}]])
    assert v.status.tolist() == [pe.PERMISSION_DENIED, pe.OK]


def test_namespace_scoping():
    kr, kp = _both(deny=[{"rule": 0}])
    _, (v,) = _scenario([("deny-ns1", "", "ns1")], kr, kp, [[{}, {}]],
                        ns=["ns1", "absent-ns"])
    assert v.status.tolist() == [pe.PERMISSION_DENIED, pe.OK]


def test_referenced_attribute_bitmap():
    kr, kp = _both(deny=[{"rule": 0}])
    got, (v,) = _scenario([("r", 'request.user == "x"')], kr, kp,
                          [[{"request.user": "x"}]])
    assert bool(v.referenced[0, got.ruleset.layout.slot_of("request.user")])


def test_ttl_combine_takes_min():
    kr, kp = _both(deny=[{"rule": 0, "valid_duration_s": 9.0},
                         {"rule": 1, "valid_duration_s": 2.0}])
    _, (v,) = _scenario([("a", ""), ("b", "")], kr, kp, [[{}]])
    assert float(v.valid_duration_s[0]) == 2.0


def test_err_count_respects_count_rules():
    rules = [("a", 'request.user == "x"'), ("b", 'request.user == "y"')]
    ref = ref_pe.PolicyEngine([RefRule(*r) for r in rules], REF_FINDER,
                              count_rules=1)
    got = pe.PolicyEngine([Rule(*r) for r in rules], PT_FINDER,
                          count_rules=1, device="cpu")
    v = _step_both(ref, got, [{}, {}], [0, 0])
    assert int(v.err_count) == 2


# ---- the byte-level list banks and the RBAC fold

def test_unported_banks_raise():
    """(Named from when these banks raised NotPorted.) REGEX and
    IP_ADDRESSES lists and an RbacSpec now build and fold exactly as
    the reference's do; an unknown entry type is still refused."""
    rules = [("r", ""), ("allow", 'request.user == "alice"'),
             ("guard", "request.user == request.user")]
    lists = [{"rule": 0, "value_attr": "request.path",
              "entries": ["^/api/", "x$"], "blacklist": True,
              "entry_type": "REGEX"},
             {"rule": 0, "value_attr": "aip", "entries": ["10.0.0.0/8"],
              "entry_type": "IP_ADDRESSES"}]
    rbacs = [{"rule": 0, "allow_rows": (1,), "guard_row": 2}]
    kr, kp = ({"lists": [mod.ListEntrySpec(**l) for l in lists],
               "rbacs": [mod.RbacSpec(**r) for r in rbacs],
               "count_rules": 1} for mod in (ref_pe, pe))
    ip = bytes([10, 0, 0, 1])
    _, (v,) = _scenario(rules, kr, kp, [[
        {"request.user": "alice", "request.path": "/web", "aip": ip},
        {"request.user": "alice", "request.path": "/api/v1", "aip": ip},
        {"request.user": "bob", "request.path": "/web", "aip": ip},
        {"request.path": "/web", "aip": ip},
        {"request.user": "alice", "request.path": "/web",
         "aip": bytes([11, 0, 0, 1])},
        {"request.user": "alice", "request.path": "/web",
         "aip": b"\x01\x02"}]])
    assert v.status.tolist() == [pe.OK, pe.PERMISSION_DENIED,
                                 pe.PERMISSION_DENIED, pe.INTERNAL,
                                 pe.NOT_FOUND, pe.INTERNAL]
    with pytest.raises(ValueError, match="entry_type"):
        pe.PolicyEngine([Rule("r", "")], PT_FINDER, device="cpu", lists=[
            pe.ListEntrySpec(rule=0, value_attr="request.user",
                             entries=["a"],
                             entry_type="CASE_INSENSITIVE_STRINGS")])
