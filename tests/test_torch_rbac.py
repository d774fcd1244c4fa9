"""The port's authz Check() path against the JAX package's: rbac policies
(servicerole / servicerolebinding kinds wired to an authorization
instance) lower to the same pseudo-rule rows (compiler/rbac_lower.py,
SnapshotBuilder._lower_rbac_groups), the fused plan folds them with the
same RbacSpecs, and RuntimeServer.check_many answers with equal
responses in every field, a byte-identical packed pull and equal
drained rule counts — on tests/test_rbac_lower.py's store and on
make_rbac_store(40) (BASELINE config 2 cut to 40 role rules), served
under ServerArgs(initial_prewarm=False, audit=False, rulestats_drain_s=0)
on the reference and device="cpu" on the port. Policies that do not
lower stay on the host adapter (adapters/rbac.py) on both, and the
PolicyEngine's RBAC fold equals the reference's through interop. The
port runs on the CPU (plain versions of every kernel)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.attribute.global_dict import GLOBAL_MANIFEST as REF_MANIFEST
from istio_tpu.compiler import rbac_lower as ref_lower
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
from istio_tpu_torch.compiler import rbac_lower
from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
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


FIELDS = ("status_code", "status_message", "valid_duration_s",
          "valid_use_count", "referenced", "referenced_presence",
          "deny_rule", "active_quota_rules")
REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)


def _rbac_lower_module():
    path = pathlib.Path(__file__).with_name("test_rbac_lower.py")
    spec = importlib.util.spec_from_file_location("_rbac_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# world → (reference store factory, manifests, traffic dicts)
def _lower_world_dicts(b, seed):
    dicts = [dict(x._values) for x in _rbac_lower_module()._bags()]
    return (dicts * (b // len(dicts) + 1))[:b]


WORLDS = {
    "rbac_lower": (lambda: _rbac_lower_module()._store(),
                   REF_MANIFEST, GLOBAL_MANIFEST, _lower_world_dicts),
    "make_rbac_store": (lambda: ref_workloads.make_rbac_store(40),
                        ref_workloads.MESH_MANIFEST, workloads.MESH_MANIFEST,
                        lambda b, seed: workloads.make_rbac_request_dicts(
                            b, seed=seed)),
}


@pytest.fixture(scope="module")
def servers():
    made: dict = {}

    def get(name):
        if name not in made:
            factory, ref_man, pt_man, _ = WORLDS[name]
            ref_store = factory()
            pt_store = interop.store_from_reference(ref_store)
            ref = RefServer(ref_store, RefArgs(default_manifest=ref_man,
                                               **REF_ARGS))
            got = RuntimeServer(pt_store, ServerArgs(
                default_manifest=pt_man, initial_prewarm=False,
                rulestats_drain_s=0), device="cpu")
            made[name] = (ref, got, ref_store, pt_store)
        return made[name][:2]
    yield get
    for ref, got, rs, ps in made.values():
        got.close()
        ref.close()
        ps.close()
        rs.close()


def _assert_responses_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        for f in FIELDS:
            assert getattr(b, f) == getattr(a, f), (i, f)


# ---- the lowering

@pytest.mark.parametrize("name", list(WORLDS))
def test_lower_rbac_matches_reference(name):
    """lower_rbac on the world's policy and instance: the same pseudo-rule
    ASTs (by their text), guard and triple count."""
    factory, ref_man, pt_man, _ = WORLDS[name]
    ref_store = factory()
    pt_store = interop.store_from_reference(ref_store)
    try:
        want = RefBuilder(ref_man).build(ref_store)
        got = SnapshotBuilder(pt_man, device="cpu").build(pt_store)
        ((_, inst),) = got.rbac_groups
        ref_low = ref_lower.lower_rbac(
            want.roles, want.bindings, want.instances[inst].expr_tree(),
            want.finder)
        low = rbac_lower.lower_rbac(
            got.roles, got.bindings, got.instances[inst].expr_tree(),
            got.finder)
        assert [str(a) for a in low.allow_asts] == \
            [str(a) for a in ref_low.allow_asts]
        assert str(low.guard_ast) == str(ref_low.guard_ast)
        assert low.n_triples == ref_low.n_triples
        assert len(low.allow_asts) > 0
    finally:
        pt_store.close()
        ref_store.close()


@pytest.mark.parametrize("name", list(WORLDS))
def test_snapshot_matches_reference(name):
    """The rbac groups and every array of the compiled ruleset, pseudo
    rows included, against a cache-free reference build (ROADMAP.md
    queue C)."""
    factory, ref_man, pt_man, _ = WORLDS[name]
    ref_store = factory()
    pt_store = interop.store_from_reference(ref_store)
    try:
        assert set(pt_store.list()) == set(ref_store.list())
        builder = RefBuilder(ref_man)
        builder.decomp_cache = None
        want = builder.build(ref_store)
        got = SnapshotBuilder(pt_man, device="cpu").build(pt_store)
        assert got.rbac_groups.keys() == want.rbac_groups.keys()
        for k, g in got.rbac_groups.items():
            w = want.rbac_groups[k]
            assert (g.allow_rows, g.guard_row, g.n_triples, g.lowered,
                    g.reason) == (w.allow_rows, w.guard_row, w.n_triples,
                                  w.lowered, w.reason)
            assert g.lowered
        rs, rr = got.ruleset, want.ruleset
        assert got.n_config_rules == want.n_config_rules == 1
        assert rs.n_rules == rr.n_rules
        assert [r.name for r in rs.rules] == [r.name for r in rr.rules]
        for k in rr.params:
            np.testing.assert_array_equal(rs.params[k].numpy(),
                                          np.asarray(rr.params[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(rs.rule_ns, rr.rule_ns)
        np.testing.assert_array_equal(rs.attr_mask, rr.attr_mask)
        assert rs.host_fallback.keys() == rr.host_fallback.keys()
        assert got.roles == want.roles and got.bindings == want.bindings
    finally:
        pt_store.close()
        ref_store.close()


def test_baseline_world_pseudo_rule_count():
    """make_rbac_store(n): one allow row per (binding, subject,
    role-rule) triple plus the guard row, after the one config rule."""
    store = workloads.make_rbac_store(60)
    try:
        snap = SnapshotBuilder(workloads.MESH_MANIFEST,
                               device="cpu").build(store)
        (g,) = snap.rbac_groups.values()
        assert g.lowered and g.n_triples == 60
        assert g.allow_rows == tuple(range(1, 61)) and g.guard_row == 61
        assert snap.ruleset.n_rules == 62
        assert snap.ruleset.rule_ns.shape[0] == 64      # rule_pad 8
    finally:
        store.close()


# ---- the served path

@pytest.mark.parametrize("name", list(WORLDS))
@pytest.mark.parametrize("b", [1, 12, 64])
def test_check_many_matches_reference(servers, name, b):
    ref, got = servers(name)
    dicts = WORLDS[name][3](b, b)
    want = ref.check_many([ref_bag(d) for d in dicts])
    have = got.check_many([bag_from_mapping(d) for d in dicts])
    _assert_responses_equal(want, have)
    if b == 64:
        codes = {r.status_code for r in want}
        assert {0, 7} <= codes


@pytest.mark.parametrize("name", list(WORLDS))
def test_packed_pull_is_byte_identical(servers, name):
    ref, got = servers(name)
    rd, pd = ref.controller.dispatcher, got.controller.dispatcher
    assert pd.fused.rbac_rules == rd.fused.rbac_rules == frozenset({0})
    assert not pd.fused.host_actions and not rd.fused.host_actions
    np.testing.assert_array_equal(pd.fused.overlay_cols,
                                  rd.fused.overlay_cols)
    dicts = WORLDS[name][3](48, 5)
    rbags = [ref_bag(d) for d in dicts]
    pbags = [bag_from_mapping(d) for d in dicts]
    ns = rd._request_ns_ids(rbags)
    np.testing.assert_array_equal(pd._request_ns_ids(pbags), ns)
    a = rd.fused.packed_check(rd.snapshot.tensorizer.tensorize(rbags), ns,
                              observe=False)
    h = pd.fused.packed_check(pd.snapshot.tensorizer.tensorize(pbags), ns,
                              observe=False)
    assert h.dtype == a.dtype == np.int32
    assert h.tobytes() == a.tobytes()


@pytest.mark.parametrize("name", list(WORLDS))
def test_rule_counts_match_reference(servers, name):
    ref, got = servers(name)
    ref.rulestats.drain()
    got.rulestats.drain()
    for seed in (31, 32):
        dicts = WORLDS[name][3](40, seed)
        ref.check_many([ref_bag(d) for d in dicts])
        got.check_many([bag_from_mapping(d) for d in dicts])
    ref.rulestats.drain()
    got.rulestats.drain()
    counts = got.rulestats.counts()
    assert counts == ref.rulestats.counts()
    assert sum(v["denies"] for v in counts.values()) > 0


def test_expected_statuses(servers):
    """tests/test_rbac_lower.py's expected verdicts, on the port."""
    ref, got = servers("rbac_lower")
    dicts = _lower_world_dicts(12, 0)
    r = got.check_many([bag_from_mapping(d) for d in dicts])
    # served on both, so the shared servers' rule counts stay comparable
    _assert_responses_equal(ref.check_many([ref_bag(d) for d in dicts]), r)
    assert [x.status_code for x in r] == [0, 7, 0, 0, 7, 7, 0, 7, 7, 13, 13,
                                          7]
    assert r[1].status_message == "RBAC: permission denied"
    assert r[9].status_message == "authorization instance evaluation failed"
    assert r[0].valid_duration_s == 5.0    # min(default 5, 42)


def test_generic_path_matches_reference():
    """fused=False: the port's host rbac adapter answers as the
    reference's, and no pseudo-rule is compiled."""
    ref_store = _rbac_lower_module()._store()
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(fused=False, **REF_ARGS))
    got = RuntimeServer(pt_store, ServerArgs(fused=False,
                                             initial_prewarm=False),
                        device="cpu")
    try:
        snap = got.controller.dispatcher.snapshot
        assert snap.rbac_groups == {}
        assert snap.ruleset.n_rules == len(snap.rules)
        dicts = _lower_world_dicts(12, 0)
        _assert_responses_equal(ref.check_many([ref_bag(d) for d in dicts]),
                                got.check_many([bag_from_mapping(d)
                                                for d in dicts]))
    finally:
        got.close()
        ref.close()
        pt_store.close()
        ref_store.close()


# ---- policies that do not lower (tests/test_rbac_lower.py:188, :224)

def _serve_both(ref_store, dicts):
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(**REF_ARGS))
    got = RuntimeServer(pt_store, ServerArgs(initial_prewarm=False),
                        device="cpu")
    try:
        want = ref.check_many([ref_bag(d) for d in dicts])
        have = got.check_many([bag_from_mapping(d) for d in dicts])
        _assert_responses_equal(want, have)
        groups = {k: (g.lowered, g.reason) for k, g in
                  got.controller.dispatcher.snapshot.rbac_groups.items()}
        assert groups == {k: (g.lowered, g.reason) for k, g in
                          ref.controller.dispatcher.snapshot
                          .rbac_groups.items()}
        host = set(got.controller.dispatcher.fused.host_actions)
        assert host == set(ref.controller.dispatcher.fused.host_actions)
        return groups, host, have
    finally:
        got.close()
        ref.close()
        pt_store.close()
        ref_store.close()


def test_unfusable_policy_stays_on_host():
    s = _rbac_lower_module()._store()
    s.set(("instance", "istio-system", "authz"), {
        "template": "authorization",
        "params": {
            "subject": {"user": "source.user",
                        "properties": {"size": "request.size"}},
            "action": {"namespace": "destination.namespace",
                       "service": "destination.service",
                       "method": "request.method",
                       "path": "request.path"}}})
    s.set(("servicerolebinding", "default", "viewer-b"), {
        "roleRef": {"kind": "ServiceRole", "name": "viewer"},
        "subjects": [{"user": "alice", "properties": {"size": "100"}}]})
    base = {"destination.namespace": "default",
            "destination.service": "b.default.svc.cluster.local",
            "request.method": "GET", "request.path": "/data/1"}
    dicts = [dict(base, **{"source.user": "alice", "request.size": 100}),
             dict(base, **{"source.user": "alice", "request.size": 7}),
             dict(base, **{"source.user": "bob", "request.size": 100})]
    groups, host, have = _serve_both(s, dicts)
    ((lowered, reason),) = groups.values()
    assert not lowered and "STRING" in reason
    assert host == {0}
    assert [r.status_code for r in have] == [0, 7, 7]


def test_non_string_config_values_keep_host_parity():
    s = _rbac_lower_module()._store()
    s.set(("servicerolebinding", "default", "intuser-b"), {
        "roleRef": {"kind": "ServiceRole", "name": "viewer"},
        "subjects": [{"user": 123}]})
    dicts = [{"source.user": "123", "destination.namespace": "default",
              "destination.service": "b.default.svc.cluster.local",
              "request.method": "GET", "request.path": "/data/1"}]
    groups, host, have = _serve_both(s, dicts)
    assert all(lowered for lowered, _ in groups.values()) and not host
    assert have[0].status_code == 7
    s2 = _rbac_lower_module()._store()
    s2.set(("servicerole", "default", "viewer"), {"rules": [
        {"services": [42], "methods": ["GET"], "paths": []}]})
    groups, host, have = _serve_both(s2, dicts)
    ((lowered, reason),) = groups.values()
    assert not lowered and "pattern" in reason and host == {0}


# ---- the engine's RBAC fold through interop

def test_engine_rbac_fold_through_interop():
    """The reference's own compiled params and batch through the port's
    step, with its RbacSpecs carried by interop.specs_from_reference: two
    specs on one rule (the lowest spec index wins a tie), a spec with no
    guard, a deny rule and a list rule below and above it."""
    from istio_tpu.attribute.bag import DictBag as RefDictBag
    from istio_tpu.compiler.ruleset import Rule as RefRule
    from istio_tpu.models import policy_engine as ref_pe
    from istio_tpu_torch.compiler.ruleset import Rule

    finder_ref = ref_workloads.MESH_FINDER
    rules = [("deny", 'request.method == "PUT"'),
             ("authz", 'request.method != "HEAD"'),
             ("wl", 'request.method == "GET"'),
             ("a0", 'source.user == "alice"'),
             ("a1", 'request.path.startsWith("/pub/")'),
             ("a2", 'destination.service.endsWith(".prod.svc")'),
             ("guard", "source.user == source.user")]
    ref_specs = {
        "deny": [ref_pe.DenySpec(rule=0, valid_duration_s=2.0)],
        "lists": [ref_pe.ListEntrySpec(rule=2, value_attr="source.name",
                                       entries=["web"])],
        "rbacs": [ref_pe.RbacSpec(rule=1, allow_rows=(3, 4), guard_row=6,
                                  valid_duration_s=42.0),
                  ref_pe.RbacSpec(rule=1, allow_rows=(5,),
                                  valid_duration_s=9.0)]}
    ref = ref_pe.PolicyEngine([RefRule(*r) for r in rules], finder_ref,
                              count_rules=3, **ref_specs)
    got = pe.PolicyEngine(
        [Rule(*r) for r in rules], workloads.MESH_FINDER, count_rules=3,
        device="cpu", **{k: interop.specs_from_reference(v)
                         for k, v in ref_specs.items()})
    rng = np.random.default_rng(5)
    dicts = []
    for _ in range(96):
        d = {"request.method": str(rng.choice(["GET", "PUT", "POST",
                                               "HEAD"])),
             "request.path": str(rng.choice(["/pub/a", "/priv/b"])),
             "destination.service": str(rng.choice(["a.prod.svc",
                                                    "a.dev.svc"])),
             "source.name": str(rng.choice(["web", "db"]))}
        if rng.random() < 0.8:
            d["source.user"] = str(rng.choice(["alice", "bob"]))
        dicts.append(d)
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in dicts])
    req = np.zeros(len(dicts), np.int32)
    import jax
    ref_v, _ = jax.jit(ref.raw_step)(ref.params, rb, req, ref.quota_counts)
    params = interop.params_from_reference(ref.params, device="cpu")
    for k in ("pe_rb_rule", "pe_rb_dur", "pe_rb_guard", "pe_rb_allow"):
        np.testing.assert_array_equal(params[k].numpy(),
                                      got.params[k].numpy(), err_msg=k)
    got_v, _ = got.step(params, interop.batch_from_reference(rb, "cpu"),
                        req, got.quota_counts)
    for f in ("status", "valid_duration_s", "valid_use_count", "referenced",
              "matched", "err", "deny_rule", "err_count"):
        np.testing.assert_array_equal(getattr(got_v, f).numpy(),
                                      np.asarray(getattr(ref_v, f)),
                                      err_msg=f)
    codes = set(got_v.status.tolist())
    assert {pe.OK, pe.PERMISSION_DENIED, pe.INTERNAL, pe.NOT_FOUND} <= codes
