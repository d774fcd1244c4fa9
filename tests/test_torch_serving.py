"""The port's served Check() path against the JAX package's:
RuntimeServer.check_many on the same store and bags must give
CheckResponses equal in every field (status_code, status_message,
valid_duration_s, valid_use_count, referenced, referenced_presence,
deny_rule, active_quota_rules) on make_store(200), on
make_store(200, host_overlay_every=5) and on tests/test_fused_serving.py's
world; a config swap serves the new
snapshot on both, on the device path of a plan warmed before it is
published; the batcher entry answers like check_many; the name-keyed
rule counts equal the reference aggregator's across a swap, and the
drainer thread and shutdown empty the device accumulators. The port
runs on the CPU (plain versions of every kernel)."""
import importlib.util
import pathlib
import time

import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.device import NotPorted
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FIELDS = ("status_code", "status_message", "valid_duration_s",
          "valid_use_count", "referenced", "referenced_presence",
          "deny_rule", "active_quota_rules")

# the reference server with the planes the port does not carry switched
# off where they would act behind the test's back (the audit thread, the
# rule-stats drainer pulling the accumulators)
REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)


def _fused_serving_module():
    path = pathlib.Path(__file__).with_name("test_fused_serving.py")
    spec = importlib.util.spec_from_file_location("_fused_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fused_world_store():
    """tests/test_fused_serving.py's store, its REGEX and CIDR lists
    included."""
    return _fused_serving_module()._store()


def fused_world_dicts():
    return [dict(b._values) for b in _fused_serving_module()._bags()]


WORLDS = {
    "make_store": lambda: ref_workloads.make_store(200),
    "overlay": lambda: ref_workloads.make_store(200, host_overlay_every=5),
    "fused_world": fused_world_store,
}


@pytest.fixture(scope="module")
def servers():
    made: dict = {}

    def get(name):
        if name not in made:
            ref_store = WORLDS[name]()
            ref = RefServer(ref_store, RefArgs(**REF_ARGS))
            pt_store = interop.store_from_reference(ref_store)
            got = RuntimeServer(pt_store, ServerArgs(initial_prewarm=False),
                                device="cpu")
            made[name] = (ref, got, ref_store, pt_store)
        return made[name][:2]
    yield get
    for ref, got, rs, ps in made.values():
        got.close()
        ref.close()
        ps.close()
        rs.close()


def _traffic(name, b, seed):
    if name == "fused_world":
        dicts = fused_world_dicts()
        return (dicts * (b // len(dicts) + 1))[:b]
    dicts, _ = workloads.make_hit_requests(200, b, seed=seed)
    return dicts


def _assert_responses_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        for f in FIELDS:
            assert getattr(b, f) == getattr(a, f), (i, f)


@pytest.mark.parametrize("name", list(WORLDS))
@pytest.mark.parametrize("b", [1, 7, 64])
def test_check_many_matches_reference(servers, name, b):
    ref, got = servers(name)
    dicts = _traffic(name, b, seed=b)
    want = ref.check_many([ref_bag(d) for d in dicts])
    have = got.check_many([bag_from_mapping(d) for d in dicts])
    _assert_responses_equal(want, have)
    if name != "fused_world" and b == 64:
        # the traffic reaches deny, whitelist and error branches
        codes = {r.status_code for r in want}
        assert {0, 5, 7} <= codes


def test_fused_world_statuses(servers):
    """The fused-serving scenarios the port carries, on the port."""
    _, got = servers("fused_world")
    r = got.check_many([bag_from_mapping(d) for d in fused_world_dicts()])
    assert r[0].status_code == 7 and r[0].valid_use_count == 100
    assert r[0].status_message == "admin is off limits"
    assert r[3].status_code == 5          # whitelist miss
    assert r[4].status_code == 7          # blacklist hit (map-derived)
    assert r[11].status_code == 7         # host-fallback predicate deny
    assert r[13].status_code == 7         # namespace-scoped rule
    assert r[14].status_code == 0


def test_headline_traffic_matches_reference(servers):
    ref, got = servers("make_store")
    dicts = workloads.make_request_dicts(64, seed=4)
    _assert_responses_equal(ref.check_many([ref_bag(d) for d in dicts]),
                            got.check_many([bag_from_mapping(d)
                                            for d in dicts]))


def test_batcher_entry_matches_check_many(servers):
    _, got = servers("overlay")
    dicts = _traffic("overlay", 9, seed=21)
    many = got.check_many([bag_from_mapping(d) for d in dicts])
    one = [got.check(bag_from_mapping(d)) for d in dicts]
    _assert_responses_equal(many, one)


def test_config_swap_serves_new_snapshot():
    ref_store = ref_workloads.make_store(60)
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(**REF_ARGS))
    got = RuntimeServer(pt_store, ServerArgs(initial_prewarm=False),
                        device="cpu")
    try:
        dicts, _ = workloads.make_hit_requests(60, 32, seed=8)
        before = got.check_many([bag_from_mapping(d) for d in dicts])
        assert any(r.status_code == 7 for r in before)
        _deny_unavailable(ref_store, pt_store)
        ref.controller.rebuild()
        got.controller.rebuild()
        assert got.controller.dispatcher.snapshot.revision >= 2
        want = ref.check_many([ref_bag(d) for d in dicts])
        have = got.check_many([bag_from_mapping(d) for d in dicts])
        _assert_responses_equal(want, have)
        codes = {r.status_code for r in have}
        assert 14 in codes and 7 not in codes
    finally:
        got.close()
        ref.close()
        pt_store.close()
        ref_store.close()


def test_generic_path_and_host_oracle_match_reference():
    """The non-fused dispatcher (host adapters for every action) and the
    CPU-oracle degradation path, against the reference's."""
    ref_store = ref_workloads.make_store(80, host_overlay_every=5)
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(fused=False, **REF_ARGS))
    got = RuntimeServer(pt_store, ServerArgs(initial_prewarm=False,
                                             fused=False), device="cpu")
    try:
        assert got.controller.dispatcher.fused is None
        dicts, _ = workloads.make_hit_requests(80, 24, seed=12)
        rbags = [ref_bag(d) for d in dicts]
        pbags = [bag_from_mapping(d) for d in dicts]
        _assert_responses_equal(ref.check_many(rbags),
                                got.check_many(pbags))
        _assert_responses_equal(
            ref.controller.dispatcher.check_host_oracle(rbags),
            got.controller.dispatcher.check_host_oracle(pbags))
    finally:
        got.close()
        ref.close()
        pt_store.close()
        ref_store.close()


def _deny_unavailable(*stores):
    """Every denier now answers UNAVAILABLE with a short TTL."""
    spec = {"adapter": "denier",
            "params": {"status_code": 14, "valid_duration_s": 1.5}}
    for store in stores:
        store.set(("handler", "istio-system", "denyall"), spec)


def test_swap_serves_on_the_device():
    """A config swap warms every serving shape of the new plan before it
    is published, and the first batches after it run on the device (the
    plan's packed_check), never through the host oracle."""
    ref_store = ref_workloads.make_store(60)
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(**REF_ARGS))
    buckets = (8, 32)
    got = RuntimeServer(pt_store, ServerArgs(initial_prewarm=False,
                                             buckets=buckets),
                        device="cpu")
    try:
        assert got.controller.dispatcher.fused._warmed_shapes == set()
        _deny_unavailable(ref_store, pt_store)
        ref.controller.rebuild()
        d = got.controller.rebuild()
        plan = d.fused
        assert plan._warmed_shapes == set(plan.all_warm_shapes(buckets))
        trips = []
        packed_check = plan.packed_check

        def counted(*a, **kw):
            trips.append(1)
            return packed_check(*a, **kw)

        def no_oracle(*a, **kw):
            raise AssertionError("served through the host oracle")

        plan.packed_check = counted
        d.check_host_oracle = no_oracle
        for step, b in enumerate((5, 32)):
            dicts, _ = workloads.make_hit_requests(60, b, seed=40 + step)
            _assert_responses_equal(
                ref.check_many([ref_bag(x) for x in dicts]),
                got.check_many([bag_from_mapping(x) for x in dicts]))
        assert len(trips) == 2
    finally:
        got.close()
        ref.close()
        pt_store.close()
        ref_store.close()


def test_rulestats_counts_match_reference_across_a_swap():
    """The name-keyed cumulative rule counts equal the reference
    aggregator's, before and after a config swap (the outgoing plan is
    drained at the publish, so no count is lost)."""
    ref_store = ref_workloads.make_store(60)
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(**REF_ARGS))
    got = RuntimeServer(pt_store, ServerArgs(initial_prewarm=False,
                                             rulestats_drain_s=0),
                        device="cpu")
    try:
        def serve(seed):
            dicts, _ = workloads.make_hit_requests(60, 24, seed=seed)
            for x in dicts[::5]:
                x["destination.service"] = "svc1.nowhere.svc.cluster.local"
            ref.check_many([ref_bag(x) for x in dicts])
            got.check_many([bag_from_mapping(x) for x in dicts])

        for seed in (50, 51):
            serve(seed)
        ref.rulestats.drain()
        got.rulestats.drain()
        first = got.rulestats.counts()
        assert first == ref.rulestats.counts()
        assert sum(v["hits"] for v in first.values()) > 0
        assert sum(v["denies"] for v in first.values()) > 0
        assert any("(unknown)" in v["ns"] for v in first.values())
        serve(52)                     # folded into the outgoing plan
        _deny_unavailable(ref_store, pt_store)
        ref.controller.rebuild()
        got.controller.rebuild()
        serve(53)
        ref.rulestats.drain()
        got.rulestats.drain()
        after = got.rulestats.counts()
        assert after == ref.rulestats.counts()
        assert sum(v["hits"] for v in after.values()) > \
            sum(v["hits"] for v in first.values())
    finally:
        got.close()
        ref.close()
        pt_store.close()
        ref_store.close()


def _device_counts_zero(server) -> bool:
    return all(int(x.sum()) == 0 for x in
               server.controller.dispatcher.fused.telemetry.state())


def test_rulestats_drainer_empties_the_accumulators():
    """The drainer thread moves the device counts into the aggregator
    on its own, and shutdown drains what the last interval left: both
    servers end with the counts of the same traffic."""
    store = workloads.make_store(40)
    dicts, _ = workloads.make_hit_requests(40, 32, seed=60)
    bags = [bag_from_mapping(x) for x in dicts]
    ticking = RuntimeServer(store, ServerArgs(initial_prewarm=False,
                                              rulestats_drain_s=0.02),
                            device="cpu")
    idle = RuntimeServer(store, ServerArgs(initial_prewarm=False,
                                           rulestats_drain_s=600),
                         device="cpu")
    try:
        for srv in (ticking, idle):
            srv.check_many(bags)
        assert not _device_counts_zero(idle)
        deadline = time.time() + 20
        while not _device_counts_zero(ticking) and time.time() < deadline:
            time.sleep(0.02)
        assert _device_counts_zero(ticking)
        ticking.rulestats.drain()
        counts = ticking.rulestats.counts()
        assert sum(v["hits"] for v in counts.values()) > 0
    finally:
        ticking.close()
        idle.close()
        store.close()
    assert _device_counts_zero(idle)
    assert idle.rulestats.counts() == counts


def test_store_watch_rebuilds_after_debounce():
    store = workloads.make_store(20)
    got = RuntimeServer(store, ServerArgs(initial_prewarm=False),
                        device="cpu")
    try:
        rev = got.controller.dispatcher.snapshot.revision
        store.set(("rule", "ns1", "late"), {
            "match": 'request.method == "PATCH"',
            "actions": [{"handler": "denyall.istio-system",
                         "instances": ["nothing.istio-system"]}]})
        deadline = time.time() + 20
        while got.controller.dispatcher.snapshot.revision == rev and \
                time.time() < deadline:
            time.sleep(0.02)
        snap = got.controller.dispatcher.snapshot
        assert snap.revision > rev
        assert any(r.name == "late" for r in snap.rules)
        r = got.check_many([bag_from_mapping({
            "request.method": "PATCH",
            "destination.service": "svc.ns1.svc.cluster.local"})])
        assert r[0].status_code == 7
    finally:
        got.close()
        store.close()


def test_unported_options_raise():
    store = workloads.make_store(8)
    try:
        with pytest.raises(NotPorted):
            RuntimeServer(store, ServerArgs(jax_compile_cache_dir="cache"),
                          device="cpu")
        with pytest.raises(NotPorted):
            RuntimeServer(store, ServerArgs(overlap_h2d=True), device="cpu")
        # mesh serving is carried, over platform.devices(): no card and
        # no virtual devices here, so even a 1 x 1 mesh has no device
        with pytest.raises(ValueError, match="need 1 devices, have 0"):
            RuntimeServer(store, ServerArgs(mesh_shape=(1, 1)), device="cpu")
        got = RuntimeServer(store, ServerArgs(initial_prewarm=False),
                            device="cpu")
        try:
            d = got.controller.dispatcher
            # the APA phase is carried: with no ATTRIBUTE_GENERATOR rule
            # the child bag adds nothing to its parent
            pre = d.preprocess(bag_from_mapping({"request.method": "GET"}))
            assert pre.names() == ["request.method"]
            assert pre.get("request.method") == ("GET", True)
            # the canary recorder is carried (tests/test_torch_canary.py)
            rec = object()
            assert type(d)(d.snapshot, d.handlers,
                           recorder=rec).recorder is rec
            with pytest.raises(NotPorted):
                type(d)(d.snapshot, d.handlers, overlap_h2d=True)
        finally:
            got.close()
    finally:
        store.close()
