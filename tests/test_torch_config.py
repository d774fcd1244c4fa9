"""The port's SnapshotBuilder against the JAX package's: on the same
store, the Snapshot's rules (names, namespaces, matches, actions), the
instance templates and referenced attributes, the soft errors, the
layout and every array of the compiled ruleset (rule_pad 8, so pad rows
included) must be equal, and so must its verdicts. The rbac device
lowering appends the reference's pseudo-rule rows and the rbac handler
builds; the store delivers watch events and the handler table reuses
unchanged handlers."""
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
from istio_tpu.attribute.global_dict import GLOBAL_MANIFEST as REF_MANIFEST
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.runtime.handler_table import HandlerTable
from istio_tpu_torch.runtime.store import MemStore
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


INDEX_PARAMS = ("lit_idx", "conj_m_idx", "conj_n_idx", "eqc_col", "eqc_cid",
                "eqc_xor", "eqc_pad")


def _mixed_store(ref_mod):
    """A store with a bad rule, a bad instance, an unknown adapter ref,
    a map-derived listentry value and a report instance whose field
    needs a derived column."""
    s = ref_mod.make_store(24)
    s.set(("rule", "ns3", "broken"), {"match": "request.size == \"x\"",
                                      "actions": []})
    s.set(("instance", "istio-system", "badinst"), {
        "template": "listentry", "params": {"value": "request.size"}})
    s.set(("rule", "ns4", "dangling"), {
        "match": "", "actions": [{"handler": "nope.istio-system",
                                  "instances": []}]})
    s.set(("instance", "istio-system", "uainst"), {
        "template": "listentry",
        "params": {"value": 'request.headers["user-agent"]'}})
    s.set(("rule", "istio-system", "ua-rule"), {
        "match": "connection.mtls",
        "actions": [{"handler": "nswhitelist", "instances": ["uainst"]}]})
    s.set(("instance", "istio-system", "hostcount"), {
        "template": "metric",
        "params": {"value": "1",
                   "dimensions": {"h": 'request.headers["host"]'}}})
    s.set(("rule", "istio-system", "report-hosts"), {
        "match": "", "actions": [{"handler": "prom",
                                  "instances": ["hostcount"]}]})
    return s


STORES = {
    "make_store": lambda: ref_workloads.make_store(120),
    "overlay": lambda: ref_workloads.make_store(120, host_overlay_every=5),
    "mixed": lambda: _mixed_store(ref_workloads),
}


def _layout_view(lay):
    return {"slots": dict(lay.slots), "derived": dict(lay.derived_slots),
            "maps": dict(lay.map_slots), "bytes": dict(lay.byte_slots),
            "extern": dict(lay.extern_slots), "L": lay.max_str_len,
            "n_columns": lay.n_columns, "n_maps": lay.n_maps,
            "manifest": {k: v.name for k, v in lay.manifest.items()}}


@pytest.mark.parametrize("name", list(STORES))
def test_snapshot_matches_reference(name):
    ref_store = STORES[name]()
    pt_store = interop.store_from_reference(ref_store)
    try:
        # the reference's DecompCache replays cached DNFs as freshly
        # built sets, which can permute the fused conjunction columns
        # of a compile that hits it (ROADMAP.md queue C); the port has
        # no cache, so its arrays are held against a cache-free build
        # and its verdicts against the default (cached) one
        ref_builder = RefBuilder(REF_MANIFEST)
        ref_builder.decomp_cache = None
        want = ref_builder.build(ref_store)
        got = SnapshotBuilder(GLOBAL_MANIFEST, device="cpu").build(pt_store)
        cached = RefBuilder(REF_MANIFEST).build(ref_store)
        dicts, _ = workloads.make_hit_requests(120, 48, seed=3)
        rb = cached.tensorizer.tensorize([RefDictBag(d) for d in dicts])
        pb = got.tensorizer.tensorize([DictBag(d) for d in dicts])
        for w, h in zip(cached.ruleset(rb), got.ruleset(pb)):
            np.testing.assert_array_equal(h.numpy(), np.asarray(w))
        assert [(r.name, r.namespace, r.match,
                 [(a.handler, a.instances) for a in r.actions])
                for r in got.rules] == \
            [(r.name, r.namespace, r.match,
              [(a.handler, a.instances) for a in r.actions])
             for r in want.rules]
        assert got.instance_templates == want.instance_templates
        assert {k: ib.referenced_attrs for k, ib in got.instances.items()} \
            == {k: ib.referenced_attrs for k, ib in want.instances.items()}
        assert {k: (h.adapter, h.signature) for k, h in got.handlers.items()} \
            == {k: (h.adapter, h.signature)
                for k, h in want.handlers.items()}
        assert got.errors == want.errors
        assert got.instance_digests == want.instance_digests
        assert got.n_config_rules == want.n_config_rules
        assert got.compile_kwargs.keys() == want.compile_kwargs.keys()
        assert got.compile_kwargs["rule_pad"] == 8
        assert _layout_view(got.ruleset.layout) == \
            _layout_view(want.ruleset.layout)
        rs, rr = got.ruleset, want.ruleset
        for k in INDEX_PARAMS:
            np.testing.assert_array_equal(rs.params[k].numpy(),
                                          np.asarray(rr.params[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(rs.rule_ns, rr.rule_ns)
        np.testing.assert_array_equal(rs.attr_mask, rr.attr_mask)
        assert rs.rule_ns.shape[0] % 8 == 0 and rs.n_rules == len(got.rules)
        assert rs.ns_ids == rr.ns_ids
        assert rs.attr_names == rr.attr_names
        assert rs.host_fallback.keys() == rr.host_fallback.keys()
        assert rs.fallback_reason == rr.fallback_reason
        assert rs.geometry.items() >= rr.geometry.items()
        if name == "mixed":
            assert got.errors          # the broken resources are reported
    finally:
        pt_store.close()
        ref_store.close()


def test_rbac_lowering_raises_not_ported():
    """(Named from when the rbac lowering raised NotPorted.) A rule that
    wires an authorization instance to an rbac handler now lowers to
    pseudo-rule rows after the config rules, exactly the reference's,
    and the rbac adapter's handler builds; lower_rbac=False leaves them
    out."""
    ref_store = ref_workloads.make_store(4)
    s = interop.store_from_reference(ref_store)
    try:
        s.set(("handler", "istio-system", "authz"), {
            "adapter": "rbac", "params": {}})
        s.set(("instance", "istio-system", "req"), {
            "template": "authorization",
            "params": {"subject": {"user": "source.user"},
                       "action": {"namespace": "destination.namespace",
                                  "method": "request.method"}}})
        s.set(("rule", "istio-system", "authz-rule"), {
            "match": "", "actions": [{"handler": "authz",
                                      "instances": ["req"]}]})
        s.set(("servicerole", "istio-system", "viewer"), {"rules": [
            {"services": ["*"], "methods": ["GET", "HEAD"]}]})
        s.set(("servicerolebinding", "istio-system", "viewer-b"), {
            "roleRef": {"kind": "ServiceRole", "name": "viewer"},
            "subjects": [{"user": "alice"}, {"user": "bob"}]})
        ref_builder = RefBuilder(REF_MANIFEST)
        ref_builder.decomp_cache = None
        want = ref_builder.build(_ref_store_of(s))
        snap = SnapshotBuilder(GLOBAL_MANIFEST, device="cpu").build(s)
        key = ("authz.istio-system", "req.istio-system")
        g, w = snap.rbac_groups[key], want.rbac_groups[key]
        assert (g.allow_rows, g.guard_row, g.n_triples, g.lowered) == \
            (w.allow_rows, w.guard_row, w.n_triples, w.lowered)
        assert g.lowered and len(g.allow_rows) == 2 and g.guard_row >= 0
        n_cfg = snap.n_config_rules
        assert n_cfg == want.n_config_rules == len(snap.rules)
        assert snap.ruleset.n_rules == want.ruleset.n_rules == n_cfg + 3
        assert [r.name for r in snap.ruleset.rules] == \
            [r.name for r in want.ruleset.rules]
        for k in INDEX_PARAMS:
            np.testing.assert_array_equal(
                snap.ruleset.params[k].numpy(),
                np.asarray(want.ruleset.params[k]), err_msg=k)
        np.testing.assert_array_equal(snap.ruleset.attr_mask,
                                      want.ruleset.attr_mask)
        assert not snap.ruleset.attr_mask[n_cfg:].any()
        handlers, _ = HandlerTable().rebuild(snap)
        assert type(handlers["authz.istio-system"]).__name__ == \
            "RbacHandler"
        assert not snap.errors
        bare = SnapshotBuilder(GLOBAL_MANIFEST, lower_rbac=False,
                               device="cpu").build(s)
        assert bare.rbac_groups == {} and \
            bare.ruleset.n_rules == len(bare.rules)
    finally:
        s.close()
        ref_store.close()


def _ref_store_of(pt_store):
    """The port's store as a reference MemStore (the same entries)."""
    from istio_tpu.runtime.store import Event as RefEvent
    from istio_tpu.runtime.store import MemStore as RefMemStore
    out = RefMemStore()
    out.apply_events([RefEvent(k, dict(v))
                      for k, v in pt_store.list().items()], notify=False)
    return out


def test_store_watch_delivers_events():
    s = MemStore()
    seen = []
    try:
        s.watch(lambda evs: seen.extend(e.key for e in evs))
        s.set(("rule", "ns", "r"), {"match": ""})
        s.delete(("rule", "ns", "r"))
        s.apply_events([], notify=True)
        import time
        deadline = time.time() + 5
        while len(seen) < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert seen == [("rule", "ns", "r")] * 2
        assert s.list() == {}
    finally:
        s.close()


def test_handler_table_reuses_unchanged_handlers():
    s = workloads.make_store(10)
    try:
        table = HandlerTable()
        b = SnapshotBuilder(GLOBAL_MANIFEST, device="cpu")
        first, _ = table.rebuild(b.build(s))
        s.set(("handler", "istio-system", "denyall"), {
            "adapter": "denier", "params": {"status_code": 16}})
        second, orphans = table.rebuild(b.build(s))
        assert second["mq.istio-system"] is first["mq.istio-system"]
        assert second["denyall.istio-system"] is not \
            first["denyall.istio-system"]
        assert orphans == [first["denyall.istio-system"]]
        assert sorted(first) == ["denyall.istio-system",
                                 "mq.istio-system",
                                 "nswhitelist.istio-system",
                                 "prom.istio-system"]
        table.close()
    finally:
        s.close()
