"""The packer's word formulation against the JAX package's: the port's
pack tables (runtime/fused.PackTables: the verdict fold's namespace rows,
each row's predicate-map words, the rules that carry an instance bit)
and the plain version that packs from them (check_pack_words_plain, the
formulation of the check_pack kernel) must give the reference's packed
rows (FusedPlan.packed_check) byte for byte, and equal the port's plain
version (check_pack_plain) — on the headline world at make_store(300),
make_rbac_store(50) and tests/test_fused_serving's REGEX / CIDR list
world through each package's fused plan, and on the make_engine(300)
quota world (small limits: RESOURCE_EXHAUSTED rows) through each
package's packer over random instance and predicate-map masks of 3 and
11 instance words; at B = 0, 1, 31, 32, 33 and 97, with request
namespaces -1, -7, the default, the largest id and one past it, and the
int32 extremes. At B = 0, which the reference cannot run, the word plain
version is held against the port's plain version alone. pred_ns equals
the reference's ns_ok ⊗ pred_map for each of those namespaces, and
inst_any the rules with an instance bit. The port runs on the CPU."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from istio_tpu.runtime import fused as ref_fused

from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.ops.bytes_ops import unpack_bits
from istio_tpu_torch.runtime import fused


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fold_words_module():
    path = pathlib.Path(__file__).with_name("test_torch_fold_words.py")
    spec = importlib.util.spec_from_file_location("_fold_words", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FW = _fold_words_module()
# world → the map-item count of the random masks (quota world), or None
# (the fused plan's own masks)
WORLDS = {"headline": None, "rbac": None, "lists": None, "quota": 40,
          "quota-wide": 300}


def _plans(w, n_maps: int | None):
    """(reference plan, port plan) whose packers to compare: a store
    world's fused plans, or plans over the quota world's engines with
    random masks of n_maps map items (n_cols + n_maps items in all) and
    40 overlay columns."""
    if n_maps is None:
        return w.ref_plan, w.got_plan
    rng = np.random.default_rng(n_maps)
    r = int(w.got_rs.rule_ns.shape[0])
    n_items = w.got_rs.layout.n_columns + n_maps
    inst = (rng.random((r, n_items)) < 0.03).astype(np.int8)
    inst[::7, 31] = 1                    # bit 31 of the first item word
    pred = (rng.random((r, n_maps)) < 0.05).astype(np.int8)
    cols = np.sort(rng.choice(r, size=40, replace=False)).astype(np.int64)
    kw = dict(host_actions={}, host_rule_idx=np.zeros(0, np.int64),
              instance_attrs=[frozenset()] * r, deny_info={},
              list_rules=frozenset(), item_names=[f"i{j}" for j in
                                                  range(n_items)],
              inst_mask=inst, pred_map_mask=pred, overlay_cols=cols)
    return (ref_fused.FusedPlan(engine=w.ref, **kw),
            fused.FusedPlan(engine=w.got, **kw))


@pytest.fixture(scope="module")
def worlds():
    made: dict = {}

    def get(name):
        if name not in made:
            base = FW.World(name.split("-")[0])
            made[name] = (base, *_plans(base, WORLDS[name]))
        return made[name]
    return get


@pytest.mark.parametrize("b", FW.BATCHES)
@pytest.mark.parametrize("name", WORLDS)
def test_words_pack_matches_reference_rows(worlds, name, b):
    w, ref_plan, got_plan = worlds(name)
    rb, pb, req, _ = w.batch(b)
    rq = torch.from_numpy(req)
    t = got_plan.pack_tables()
    if name.startswith("quota"):      # both from the reference's counters
        w.got.quota_counts.copy_(torch.from_numpy(
            np.asarray(w.ref.quota_counts).copy()))
    v = w.got.check(pb, rq)
    args = (v.status, v.valid_duration_s, v.valid_use_count, v.deny_rule,
            v.err_count, v.referenced, v.matched, rq, t)
    words = fused.check_pack_words_plain(*args)
    plain = fused.check_pack_plain(*args)
    assert words.dtype == plain.dtype == torch.int32
    assert words.shape == (t.n_rows_out, b)
    assert torch.equal(words, plain)
    if not b:
        return
    if WORLDS[name] is None:
        want = ref_plan.packed_check(rb, req, observe=False)
    else:
        want = np.asarray(ref_plan._base_packer()(w.ref.check(rb, req),
                                                  req))
        np.testing.assert_array_equal(w.got.quota_counts.numpy(),
                                      np.asarray(w.ref.quota_counts))
    assert want.dtype == np.int32
    assert words.numpy().tobytes() == want.tobytes()
    if name == "quota-wide" and b == 97:
        assert t.n_words > 8 and bool((words[5] < 0).any())


@pytest.mark.parametrize("name", WORLDS)
def test_pack_tables_equal_the_reference_products(worlds, name):
    w, ref_plan, got_plan = worlds(name)
    t = got_plan.pack_tables()
    n_rules = int(w.got_rs.rule_ns.shape[0])
    vals = sorted(set(FW.edge_values(w.got_rs))
                  | set(w.got_rs.ns_ids.values()) | {-7})
    req = np.asarray(vals, np.int32)
    ns_ok = np.asarray(w.ref_rs.namespace_mask(req))
    rows = pe.vis_rows(torch.from_numpy(req), t.vis_ns)
    np.testing.assert_array_equal(
        unpack_bits(t.vis_words, n_rules)[rows].numpy(), ns_ok)
    np.testing.assert_array_equal(t.vis_words.numpy(),
                                  w.got.params["pe_vis_words"].numpy())
    pred_map = np.asarray(ref_plan.pred_map_mask, np.int32)
    want = (ns_ok.astype(np.int32) @ pred_map) > 0
    np.testing.assert_array_equal(
        unpack_bits(t.pred_ns, t.n_maps)[rows].numpy(), want)
    np.testing.assert_array_equal(
        unpack_bits(t.inst_any, n_rules).numpy(),
        np.asarray(ref_plan.inst_mask).any(axis=1))
