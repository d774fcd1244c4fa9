"""The port's Tensorizer, layout and intern table against the JAX
package's: the same rules and bags must give byte-identical planes —
ids (incl. negative per-batch ephemeral ids), present, map_present,
str_bytes (truncated at max_str_len), str_lens and the FNV-1a hash_ids
— and the same InternTable contents."""
import datetime

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.compiler import layout as ref_layout
from istio_tpu.compiler import tensor_expr as ref_te
from istio_tpu.compiler.ruleset import compile_ruleset as ref_compile
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.parser import parse as ref_parse
from istio_tpu.testing import workloads as ref_workloads
from istio_tpu.testing.corpus import CORPUS, CORPUS_MANIFEST

from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.compiler import layout as pt_layout
from istio_tpu_torch.compiler import tensor_expr as pt_te
from istio_tpu_torch.compiler.ruleset import Rule, compile_ruleset
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.interop import manifest_from_reference
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


PLANES = ("ids", "present", "map_present", "str_bytes", "str_lens",
          "hash_ids")

LONG = "/v1/" + "x" * 300          # past the 128-byte slot


def _assert_batches_equal(ref, got):
    for f in PLANES:
        want = np.asarray(getattr(ref, f))
        have = getattr(got, f)
        assert isinstance(have, torch.Tensor), f
        np.testing.assert_array_equal(have.numpy(), want, err_msg=f)
        assert have.numpy().dtype == want.dtype, f
    assert got.ephemeral_values == ref.ephemeral_values


def _assert_interners_equal(ref, got):
    assert len(ref) == len(got)
    for i in range(len(ref)):
        assert got.value_of(i) == ref.value_of(i), i


def _assert_layouts_equal(ref, got):
    assert dict(got.slots) == dict(ref.slots)
    assert dict(got.derived_slots) == dict(ref.derived_slots)
    assert dict(got.map_slots) == dict(ref.map_slots)
    assert dict(got.byte_slots) == dict(ref.byte_slots)
    assert dict(got.extern_slots) == dict(ref.extern_slots)
    assert got.max_str_len == ref.max_str_len


def _mesh_dicts():
    dicts, _ = workloads.make_hit_requests(300, 40, seed=5)
    dicts += workloads.make_request_dicts(20, seed=9)
    dicts += [
        {},                                          # everything absent
        {"request.path": LONG, "request.host": "h" * 200},
        {"request.headers": {}},                     # map, key absent
        {"request.headers": {"cookie": "session=7", "x": "y"},
         "source.user": "never-seen-user", "request.size": 1 << 40},
        {"destination.service": "unseen.svc", "connection.mtls": False},
    ]
    return dicts


@pytest.mark.parametrize("hash_slots", [None, "all"])
def test_mesh_layout_and_tensorize_match_reference(hash_slots):
    rules = ref_workloads.make_rules(300, with_regex=True)
    ref = ref_compile(rules, ref_workloads.MESH_FINDER, jit=False)
    finder = AttributeDescriptorFinder(
        manifest_from_reference(ref_workloads.MESH_MANIFEST))
    got = compile_ruleset([Rule(r.name, r.match, r.namespace)
                           for r in rules], finder, device="cpu")
    _assert_layouts_equal(ref.layout, got.layout)
    _assert_interners_equal(ref.interner, got.interner)
    dicts = _mesh_dicts()
    rb = ref_layout.Tensorizer(ref.layout, ref.interner, hash_slots) \
        .tensorize([RefDictBag(d) for d in dicts])
    pb = pt_layout.Tensorizer(got.layout, got.interner, hash_slots) \
        .tensorize([DictBag(d) for d in dicts])
    _assert_batches_equal(rb, pb)
    assert int(pb.str_lens.max()) == 128          # truncated at the cap
    assert int(pb.ids.min()) < 0                  # ephemeral ids occurred


def _corpus_layouts():
    """One layout over every corpus expression's requirements (derived
    map keys, byte slots incl. numeric order keys, ip()/timestamp()
    extern columns)."""
    ref_f = RefFinder(CORPUS_MANIFEST)
    pt_f = AttributeDescriptorFinder(manifest_from_reference(CORPUS_MANIFEST))
    rr, pr = ref_te.Requirements(), pt_te.Requirements()
    for c in CORPUS:
        if c.compile_err is not None:
            continue
        try:
            r1 = ref_te.collect_requirements(ref_parse(c.e), ref_f)
        except ref_te.HostFallback:
            with pytest.raises(pt_te.HostFallback):
                pt_te.collect_requirements(parse(c.e), pt_f)
            continue
        rr.merge(r1)
        pr.merge(pt_te.collect_requirements(parse(c.e), pt_f))

    def args(r):
        return (sorted(r.derived_keys), sorted(r.byte_sources, key=str),
                [(n, k, a) for (n, k), a in r.extern_sources.items()])
    dk, bs, ex = args(rr)
    ref_lay = ref_layout.build_layout(CORPUS_MANIFEST, dk, bs,
                                      extern_sources=ex)
    dk, bs, ex = args(pr)
    pt_lay = pt_layout.build_layout(manifest_from_reference(CORPUS_MANIFEST),
                                    dk, bs, extern_sources=ex)
    return ref_lay, pt_lay


def test_corpus_layout_and_tensorize_match_reference():
    ref_lay, pt_lay = _corpus_layouts()
    _assert_layouts_equal(ref_lay, pt_lay)
    assert pt_lay.extern_slots and pt_lay.derived_slots and pt_lay.byte_slots
    ref_int, pt_int = ref_layout.InternTable(), pt_layout.InternTable()
    for v in ("aaa", 2, 3.5, True, b"\x01\x02\x03\x04",
              datetime.timedelta(seconds=3)):
        assert pt_int.intern(v) == ref_int.intern(v)
    inputs = [c.input for c in CORPUS if c.compile_err is None]
    inputs.append({"as": LONG, "ar": {"foo": "x" * 129}})
    rb = ref_layout.Tensorizer(ref_lay, ref_int, "all").tensorize(
        [RefDictBag(d) for d in inputs])
    pb = pt_layout.Tensorizer(pt_lay, pt_int, "all").tensorize(
        [DictBag(d) for d in inputs])
    _assert_batches_equal(rb, pb)
    _assert_interners_equal(ref_int, pt_int)


@pytest.mark.parametrize("value", [
    "", "a", "svc0.ns1.svc.cluster.local", 0, -1, 1 << 40, 2.5, -0.0,
    True, False, b"\x0a\x00\x00\x01", b"\x00" * 16,
    datetime.timedelta(milliseconds=1500),
    datetime.datetime(2020, 1, 2, tzinfo=datetime.timezone.utc)])
def test_stable_hash31_matches_reference(value):
    assert pt_layout.stable_hash31(value) == ref_layout.stable_hash31(value)


def test_batch_to_same_device_is_identity():
    lay = pt_layout.build_layout({"a": manifest_from_reference(
        CORPUS_MANIFEST)["as"]})
    batch = pt_layout.Tensorizer(lay, pt_layout.InternTable()).tensorize(
        [DictBag({"a": "x"}), DictBag({})])
    assert batch.to("cpu") is batch
    assert batch.ids.dtype == torch.int32
    assert batch.present.tolist() == [[True], [False]]
    assert batch.ephemeral_values == ["x"]
