"""The port's rule telemetry against the JAX package's: counts drained
after several served check batches must equal the reference's exactly
(hit and deny per namespace slot, err per rule), with bucket padding
rows, requests from namespaces the snapshot does not know and a
host-fallback rule in the traffic. The fold's plain version is held
against the reference's delta program directly; hit and deny are
separate buffers; a reference run continues on the port through
interop.telemetry_state_from_reference."""
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import Dispatcher as RefDispatcher
from istio_tpu.runtime import fused as ref_fused
from istio_tpu.runtime import rulestats as ref_rulestats
from istio_tpu.runtime.batcher import pad_to_bucket as ref_pad
from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
from istio_tpu.attribute.global_dict import GLOBAL_MANIFEST as REF_MANIFEST
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
from istio_tpu_torch.runtime import fused
from istio_tpu_torch.runtime.batcher import pad_to_bucket
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.runtime.dispatcher import Dispatcher
from istio_tpu_torch.runtime.rulestats import rule_stats_plain
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


N_RULES = 120
BUCKETS = (16, 64)


def _store(mod):
    """make_store plus a host-fallback rule (a dynamic map key) that
    denies, in a namespace of its own."""
    s = mod.make_store(N_RULES)
    s.set(("rule", "ns5", "dynkey"), {
        "match": 'request.headers[request.method] == "x"',
        "actions": [{"handler": "denyall.istio-system",
                     "instances": ["nothing.istio-system"]}]})
    return s


@pytest.fixture(scope="module")
def dispatchers():
    ref_store = _store(ref_workloads)
    pt_store = interop.store_from_reference(ref_store)
    rsnap = RefBuilder(REF_MANIFEST).build(ref_store)
    psnap = SnapshotBuilder(GLOBAL_MANIFEST, device="cpu").build(pt_store)
    ref = RefDispatcher(rsnap, {}, fused=ref_fused.build_fused_plan(rsnap))
    got = Dispatcher(psnap, {}, fused=fused.build_fused_plan(psnap))
    ref_store.close()
    pt_store.close()
    return ref, got


def _batch(b, seed):
    dicts, _ = workloads.make_hit_requests(N_RULES, b, seed=seed)
    rng = np.random.default_rng(seed)
    for i, d in enumerate(dicts):
        if i % 5 == 0:      # a namespace no rule names
            d["destination.service"] = "svc1.nowhere.svc.cluster.local"
        if i % 4 == 1:      # the host-fallback rule's namespace
            d["destination.service"] = "svc.ns5.svc.cluster.local"
            d["request.method"] = "GET"
            d["request.headers"] = {"GET": "x" if rng.random() < 0.5
                                    else "y"}
        if i % 9 == 2:      # the dynamic key is absent: predicate error
            d["destination.service"] = "svc.ns5.svc.cluster.local"
            d.pop("request.method", None)
    return dicts


def test_drained_counts_match_reference(dispatchers):
    ref, got = dispatchers
    for step, b in enumerate((5, 40, 64, 13)):
        dicts = _batch(b, seed=10 + step)
        rr = ref.check(ref_pad([ref_bag(d) for d in dicts], BUCKETS))
        pr = got.check(pad_to_bucket([bag_from_mapping(d) for d in dicts],
                                     BUCKETS))
        assert [r.status_code for r in pr] == [r.status_code for r in rr]
    want = ref.fused.telemetry.drain()
    have = got.fused.telemetry.drain()
    for k in ("hit", "deny", "err"):
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
        assert have[k].dtype == want[k].dtype
    assert have["generation"] == want["generation"] == 1
    slots = got.fused.telemetry.n_slots
    assert want["hit"][slots - 1].sum() > 0      # unknown namespaces
    assert want["deny"].sum() > 0 and want["err"].sum() > 0
    rs = got.snapshot.ruleset
    fb = next(iter(rs.host_fallback))
    assert want["hit"][:, fb].sum() > 0          # host-side fallback hits
    assert want["err"][fb] > 0
    # a drain empties the accumulators
    again = got.fused.telemetry.drain()
    assert again["hit"].sum() == again["deny"].sum() == \
        again["err"].sum() == 0


def test_plain_fold_matches_reference_delta():
    rng = np.random.default_rng(5)
    b, r, s = 37, 50, 6
    rule_ns = rng.integers(0, s - 1, size=r).astype(np.int32)
    rule_ns[-4:] = -7                               # rule-axis padding
    matched = rng.random((b, r)) < 0.4
    err = rng.random((b, r)) < 0.2
    status = rng.choice([0, 5, 7, 13], size=b).astype(np.int32)
    deny_rule = np.where(status != 0, rng.integers(0, r, size=b),
                         np.iinfo(np.int32).max).astype(np.int32)
    req = rng.integers(-1, s - 1, size=b).astype(np.int32)
    req[3] = -7
    real = np.arange(b) < b - 6
    err_rows = rng.random(r) < 0.8
    delta = ref_rulestats.RuleTelemetry._make_delta(rule_ns, 0, s, err_rows)
    want = [np.asarray(x) for x in delta(matched, err, status, deny_rule,
                                         req, real)]
    acc = [torch.zeros((s, r), dtype=torch.int32),
           torch.zeros((s, r), dtype=torch.int32),
           torch.zeros(r, dtype=torch.int32)]
    t = torch.from_numpy
    rule_stats_plain(t(matched), t(err), t(status), t(deny_rule), t(req),
                     t(real), t(rule_ns), 0, s, t(err_rows), *acc)
    for w, h in zip(want, acc):
        np.testing.assert_array_equal(h.numpy(), w)
    # the fold adds in place: a second batch doubles every count
    rule_stats_plain(t(matched), t(err), t(status), t(deny_rule), t(req),
                     t(real), t(rule_ns), 0, s, t(err_rows), *acc)
    for w, h in zip(want, acc):
        np.testing.assert_array_equal(h.numpy(), 2 * w)


# rule_stats's edge shapes (chip_smoke phase 5b holds the kernel on the
# same kinds): R not a multiple of a column run, one slot, more than 64,
# one namespace, alternating namespaces, an all-padding batch, unknown
# namespaces only, and B not a multiple of a row chunk
EDGE_FOLDS = {
    "ragged_rule_axis": dict(b=77, r=1001, s=6),
    "one_slot": dict(b=64, r=96, s=1),
    "many_slots": dict(b=300, r=120, s=80),
    "one_namespace": dict(b=130, r=200, s=6, ns="one"),
    "alternating_namespaces": dict(b=130, r=200, s=6, ns="alternate"),
    "all_padding": dict(b=50, r=64, s=6, real="none"),
    "unknown_namespaces": dict(b=90, r=64, s=6, ns="unknown"),
    "ragged_batch": dict(b=333, r=10008, s=24),
}


@pytest.mark.parametrize("case", sorted(EDGE_FOLDS))
def test_plain_fold_edge_shapes_match_reference(case):
    kw = EDGE_FOLDS[case]
    b, r, s = kw["b"], kw["r"], kw["s"]
    rng = np.random.default_rng(len(case))
    rule_ns = rng.integers(0, max(s - 1, 1), size=r).astype(np.int32)
    rule_ns[::7] = 0                                # the default namespace
    rule_ns[-3:] = -7
    matched = rng.random((b, r)) < 0.3
    err = rng.random((b, r)) < 0.1
    status = rng.choice([0, 0, 7, 13], size=b).astype(np.int32)
    deny_rule = rng.integers(-1, r + 1, size=b).astype(np.int32)
    req = rng.integers(-1, s + 2, size=b).astype(np.int32)
    if kw.get("ns") == "one":
        req[:] = min(2, s - 1)
    elif kw.get("ns") == "alternate":
        req = np.where(np.arange(b) % 2 == 0, 1, 3).astype(np.int32)
    elif kw.get("ns") == "unknown":
        req = rng.choice([-1, -7, s + 5], size=b).astype(np.int32)
    real = np.zeros(b, bool) if kw.get("real") == "none" else \
        rng.random(b) < 0.9
    err_rows = rng.random(r) < 0.9
    delta = ref_rulestats.RuleTelemetry._make_delta(rule_ns, 0, s, err_rows)
    want = [np.asarray(x) for x in delta(matched, err, status, deny_rule,
                                         req, real)]
    acc = [torch.full((s, r), 3, dtype=torch.int32),
           torch.zeros((s, r), dtype=torch.int32),
           torch.zeros(r, dtype=torch.int32)]
    t = torch.from_numpy
    rule_stats_plain(t(matched), t(err), t(status), t(deny_rule), t(req),
                     t(real), t(rule_ns), 0, s, t(err_rows), *acc)
    want[0] = want[0] + 3                           # folded into state
    for w, h in zip(want, acc):
        np.testing.assert_array_equal(h.numpy(), w)


def test_accumulators_are_separate_buffers(dispatchers):
    _, got = dispatchers
    hit, deny, err = got.fused.telemetry.state()
    assert hit.data_ptr() != deny.data_ptr()
    assert len({hit.data_ptr(), deny.data_ptr(), err.data_ptr()}) == 3


def test_reference_run_continues_on_the_port(dispatchers):
    ref, got = dispatchers
    ref.fused.telemetry.drain()
    got.fused.telemetry.drain()
    dicts = _batch(24, seed=77)
    ref.check([ref_bag(d) for d in dicts])
    for dst, src in zip(got.fused.telemetry.state(),
                        interop.telemetry_state_from_reference(
                            ref.fused.telemetry, device="cpu")):
        dst.copy_(src)
    more = _batch(31, seed=78)
    ref.check([ref_bag(d) for d in more])
    got.check([bag_from_mapping(d) for d in more])
    want = ref.fused.telemetry.drain()
    have = got.fused.telemetry.drain()
    for k in ("hit", "deny", "err"):
        np.testing.assert_array_equal(have[k], want[k], err_msg=k)
