"""The port's fused serving plan against the JAX package's, on the same
store: the plan (overlay_cols, item_names, inst_mask, pred_map_mask, the
host_actions keys, deny_info, list_rules, quota_actions,
fused_first_rules, str_tiers) must be equal, and FusedPlan.packed_check
must return an int32 array byte-identical to the reference's at B ∈
{1, 7, 64} on both byte tiers — on make_store (3 item words), on
make_store with host_overlay_every (more than 32 overlay columns) and on
a plan with neither items nor overlay columns. The packer's plain
version runs (CPU tensors); pack_bool_rows is held against the
reference with bit 31 set; a REGEX or CIDR list fuses where the
reference fuses it, with a byte-identical pull."""
import dataclasses

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.attribute.global_dict import GLOBAL_MANIFEST as REF_MANIFEST
from istio_tpu.runtime import fused as ref_fused
from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
from istio_tpu_torch.runtime import fused
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.runtime.dispatcher import Dispatcher
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


WORLDS = {
    "make_store": lambda: ref_workloads.make_store(200),
    "overlay": lambda: ref_workloads.make_store(200, host_overlay_every=5),
}


def _bare(plan):
    """The plan with neither referenced items nor overlay columns: the
    packed pull is the five head rows alone. (A snapshot whose layout
    has no column at all cannot run in the reference: its fused gather
    reads column 0 of an empty ids plane — ROADMAP.md queue C.)"""
    n_rows = plan.inst_mask.shape[0]
    return dataclasses.replace(
        plan, item_names=[], inst_mask=np.zeros((n_rows, 0), np.int8),
        pred_map_mask=np.zeros((n_rows, 0), np.int8),
        overlay_cols=np.zeros(0, np.int64), _packer=None)


@pytest.fixture(scope="module")
def plans():
    made: dict = {}

    def get(name):
        if name not in made:
            if name == "bare":
                rsnap, psnap, ref_plan, pt_plan = get("make_store")
                made[name] = (rsnap, psnap, _bare(ref_plan),
                              _bare(pt_plan))
                return made[name]
            ref_store = WORLDS[name]()
            pt_store = interop.store_from_reference(ref_store)
            rsnap = RefBuilder(REF_MANIFEST).build(ref_store)
            psnap = SnapshotBuilder(GLOBAL_MANIFEST,
                                    device="cpu").build(pt_store)
            ref_plan = ref_fused.build_fused_plan(rsnap,
                                                  rule_telemetry=False)
            pt_plan = fused.build_fused_plan(psnap, rule_telemetry=False)
            made[name] = (rsnap, psnap, ref_plan, pt_plan)
            ref_store.close()
            pt_store.close()
        return made[name]
    return get


@pytest.mark.parametrize("name", [*WORLDS, "bare"])
def test_plan_matches_reference(plans, name):
    _, _, want, got = plans(name)
    np.testing.assert_array_equal(got.overlay_cols, want.overlay_cols)
    assert got.item_names == want.item_names
    np.testing.assert_array_equal(got.inst_mask, want.inst_mask)
    np.testing.assert_array_equal(got.pred_map_mask, want.pred_map_mask)
    assert got.host_actions.keys() == want.host_actions.keys()
    np.testing.assert_array_equal(got.host_rule_idx, want.host_rule_idx)
    assert got.deny_info == want.deny_info
    assert got.list_rules == want.list_rules
    assert [q[:3] + (sorted(q[3]),) for q in got.quota_actions] == \
        [q[:3] + (sorted(q[3]),) for q in want.quota_actions]
    assert got.fused_first_rules == want.fused_first_rules
    assert got.str_tiers == want.str_tiers
    assert got.instance_attrs == want.instance_attrs
    assert got.unmapped_instance_attrs == want.unmapped_instance_attrs
    assert got.unfused_list_kinds == want.unfused_list_kinds
    assert got.report_rules == want.report_rules
    assert (got.fused_deny, got.fused_lists) == \
        (want.fused_deny, want.fused_lists)
    assert got.n_ref_words == want.n_ref_words
    assert got.n_overlay_words == want.n_overlay_words
    if name == "make_store":
        assert got.n_ref_words > 1
    if name == "overlay":
        assert len(got.overlay_cols) > 32
    if name == "bare":
        assert got.n_ref_words == 0 and got.n_overlay_words == 0


def _dicts(b, seed, long_path):
    dicts, _ = workloads.make_hit_requests(200, b, seed=seed)
    for d in dicts:
        path = d.get("request.path")
        if isinstance(path, str) and len(path) > 32:
            d["request.path"] = path[:32]
    if long_path:
        dicts[-1] = dict(dicts[-1], **{"request.path": "/api/v1/" + "p" * 40})
    return dicts


@pytest.mark.parametrize("name", [*WORLDS, "bare"])
@pytest.mark.parametrize("b", [1, 7, 64])
@pytest.mark.parametrize("long_path", [False, True])
def test_packed_check_is_byte_identical(plans, name, b, long_path):
    rsnap, psnap, want, got = plans(name)
    dicts = _dicts(b, seed=b + 100 * long_path, long_path=long_path)
    rbags = [ref_bag(d) for d in dicts]
    pbags = [bag_from_mapping(d) for d in dicts]
    ns = np.asarray([rsnap.ruleset.namespace_id(
        _namespace_of(d)) for d in dicts], np.int32)
    rb = rsnap.tensorizer.tensorize(rbags)
    pb = psnap.tensorizer.tensorize(pbags)
    if len(got.str_tiers) > 1:
        tier = got._serve_width(pb)
        assert tier == (got.str_tiers[1] if long_path
                        else got.str_tiers[0])
    a = want.packed_check(rb, ns, observe=False)
    h = got.packed_check(pb, ns, observe=False)
    assert h.dtype == a.dtype == np.int32
    assert h.shape == a.shape == (5 + got.n_ref_words
                                  + got.n_overlay_words, b)
    assert h.tobytes() == a.tobytes()


def _namespace_of(d):
    v = d.get("destination.service")
    parts = v.split(".") if isinstance(v, str) else []
    return parts[1] if len(parts) >= 2 and parts[1] else ""


def test_pack_bool_rows_matches_reference_with_bit_31():
    rng = np.random.default_rng(4)
    flags = rng.random((9, 96)) < 0.5
    flags[:, 31] = True
    flags[0, :] = True
    want = np.asarray(ref_fused.pack_bool_rows(flags, 3))
    got = fused.pack_bool_rows(torch.from_numpy(flags), 3).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert (got[0] < 0).all()
    np.testing.assert_array_equal(fused.unpack_word_rows(got, 96), flags)
    np.testing.assert_array_equal(fused.unpack_word_rows(got, 70),
                                  ref_fused.unpack_word_rows(want, 70))


@pytest.mark.parametrize("entry_type,overrides,value", [
    ("REGEX", ["^/api/"], "request.path"),
    ("IP_ADDRESSES", ["10.0.0.0/8"], "source.ip"),
])
def test_fusable_regex_and_cidr_lists_raise(entry_type, overrides, value):
    """(Named from when these lists raised NotPorted.) A REGEX or CIDR
    list fuses into the plan exactly where the reference's does, and
    the packed pull is byte-identical, also from a plan whose engine
    step is sharded over a (2, 2) mesh of virtual CPU devices."""
    s = MemStore()
    try:
        s.set(("handler", "istio-system", "lst"), {
            "adapter": "list",
            "params": {"overrides": overrides, "entry_type": entry_type,
                       "blacklist": True}})
        s.set(("instance", "istio-system", "v"), {
            "template": "listentry", "params": {"value": value}})
        s.set(("rule", "istio-system", "r"), {
            "match": "", "actions": [{"handler": "lst",
                                      "instances": ["v"]}]})
        snap = SnapshotBuilder(GLOBAL_MANIFEST, device="cpu").build(s)
        ref_store = _ref_store_of(s)
        rsnap = RefBuilder(REF_MANIFEST).build(ref_store)
        ref_store.close()
        want = ref_fused.build_fused_plan(rsnap, rule_telemetry=False)
        got = fused.build_fused_plan(snap, rule_telemetry=False)
        assert got.fused_lists == want.fused_lists == 1
        assert got.list_rules == want.list_rules == frozenset({0})
        assert not got.host_actions and not want.host_actions
        dicts = [{}, {"request.path": "/api/x"}, {"request.path": "/web"},
                 {"source.ip": bytes([10, 1, 2, 3])},
                 {"source.ip": bytes([11, 1, 2, 3])},
                 {"source.ip": b"\x01\x02\x03"}]
        ns = np.zeros(len(dicts), np.int32)
        a = want.packed_check(rsnap.tensorizer.tensorize(
            [ref_bag(d) for d in dicts]), ns, observe=False)
        h = got.packed_check(snap.tensorizer.tensorize(
            [bag_from_mapping(d) for d in dicts]), ns, observe=False)
        assert h.tobytes() == a.tobytes()
        assert len(set(a[0].tolist())) > 1
        from istio_tpu_torch import platform
        from istio_tpu_torch.parallel.mesh import MeshSpec
        with platform.force_virtual_devices(4, "cpu"):
            mesh = MeshSpec(2, 2).build()
        sharded = fused.build_fused_plan(snap, mesh=mesh,
                                         rule_telemetry=False)
        m = sharded.packed_check(snap.tensorizer.tensorize(
            [bag_from_mapping(d) for d in dicts]), ns, observe=False)
        assert m.tobytes() == a.tobytes()
    finally:
        s.close()


def _ref_store_of(pt_store):
    from istio_tpu.runtime.store import Event as RefEvent
    from istio_tpu.runtime.store import MemStore as RefMemStore
    out = RefMemStore()
    out.apply_events([RefEvent(k, dict(v))
                      for k, v in pt_store.list().items()], notify=False)
    return out


def test_warm_bookkeeping(plans):
    from istio_tpu_torch.runtime import monitor
    _, psnap, _, plan = plans("make_store")
    pairs = plan.all_warm_shapes((64, 8))
    assert pairs == [(8, 32), (8, 128), (64, 32), (64, 128)]
    h = monitor.CHECK_STAGE_SECONDS
    before = {st: h.sum(st) for st in monitor.CHECK_STAGES}
    plan.prewarm((64, 8))
    assert set(pairs) <= plan._warmed_shapes
    # warm trips are not check traffic
    assert {st: h.sum(st) for st in monitor.CHECK_STAGES} == before
    d = Dispatcher(psnap, {}, fused=plan)
    assert d.fused is plan and not d.has_apa
