"""The port's ruleset compiler against the JAX package's: the emitted
index tensors (lit_idx, conj_m_idx, conj_n_idx, eqc_*) must be
array_equal to the reference params, and matched / not_matched / err
equal to the reference program on the same bags (plain versions of the
kernels on the CPU). Covers the make_rules worlds and the
tests/test_ruleset.py cases."""
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.compiler import layout as ref_layout
from istio_tpu.compiler import ruleset as ref_rs
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.checker import TypeError_ as RefTypeError
from istio_tpu.expr.oracle import OracleProgram as RefOracle
from istio_tpu.expr.parser import ParseError as RefParseError
from istio_tpu.attribute.types import ValueType as RefV
from istio_tpu.testing import workloads as ref_workloads
from istio_tpu.testing.corpus import CORPUS, CORPUS_MANIFEST

from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.compiler import layout as pt_layout
from istio_tpu_torch.compiler import ruleset as pt_rs
from istio_tpu_torch.device import NotPorted
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder, TypeError_
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


INDEX_PARAMS = ("lit_idx", "conj_m_idx", "conj_n_idx", "eqc_col", "eqc_cid",
                "eqc_xor", "eqc_pad")

CORPUS_REF_FINDER = RefFinder(CORPUS_MANIFEST)
CORPUS_PT_FINDER = AttributeDescriptorFinder(
    manifest_from_reference(CORPUS_MANIFEST))


def _compile_both(rules, ref_finder, pt_finder):
    ref = ref_rs.compile_ruleset(
        [ref_rs.Rule(r[0], r[1], r[2]) for r in rules], ref_finder,
        jit=False)
    got = pt_rs.compile_ruleset(
        [pt_rs.Rule(r[0], r[1], r[2]) for r in rules], pt_finder,
        device="cpu")
    return ref, got


def _run_both(ref, got, dicts):
    rb = ref_layout.Tensorizer(ref.layout, ref.interner).tensorize(
        [RefDictBag(d) for d in dicts])
    pb = pt_layout.Tensorizer(got.layout, got.interner).tensorize(
        [DictBag(d) for d in dicts])
    want = [np.asarray(a) for a in ref(rb)]
    have = [a.numpy() for a in got(pb)]
    return want, have


def _assert_parity(ref, got, dicts):
    for k in INDEX_PARAMS:
        np.testing.assert_array_equal(got.params[k].numpy(),
                                      np.asarray(ref.params[k]), err_msg=k)
    assert got.geometry.items() >= {
        k: v for k, v in ref.geometry.items()}.items()
    assert dict(got.host_fallback).keys() == dict(ref.host_fallback).keys()
    np.testing.assert_array_equal(got.rule_ns, ref.rule_ns)
    np.testing.assert_array_equal(got.attr_mask, ref.attr_mask)
    assert got.ns_ids == ref.ns_ids
    assert got.atom_tier == ref.atom_tier
    want, have = _run_both(ref, got, dicts)
    for name, w, h in zip(("matched", "not_matched", "err"), want, have):
        np.testing.assert_array_equal(h, w, err_msg=name)
    return have


@pytest.mark.parametrize("n_rules", [64, 1000])
def test_make_rules_world_matches_reference(n_rules):
    rules = [(r.name, r.match, r.namespace)
             for r in ref_workloads.make_rules(n_rules, with_regex=True)]
    ref, got = _compile_both(
        rules, ref_workloads.MESH_FINDER,
        AttributeDescriptorFinder(
            manifest_from_reference(ref_workloads.MESH_MANIFEST)))
    dicts, _ = workloads.make_hit_requests(n_rules, 120, seed=n_rules)
    dicts += workloads.make_request_dicts(60, seed=2)
    m, n, e = _assert_parity(ref, got, dicts)
    # the world exercises every tier and all three verdicts
    assert got.geometry["n_dfa_groups"] == 1
    assert got.geometry["n_byte_groups"] == 2
    assert m.any() and n.any() and e.any()


def _bool_cases():
    out = []
    for c in CORPUS:
        if c.compile_err is not None:
            continue
        try:
            prog = RefOracle(c.e, CORPUS_REF_FINDER)
        except (RefParseError, RefTypeError):
            continue
        if prog.result_type == RefV.BOOL:
            out.append(c)
    return out


def test_corpus_predicates_as_one_ruleset_match_reference():
    cases = _bool_cases()
    rules = [(f"r{i}", c.e, "") for i, c in enumerate(cases)]
    ref, got = _compile_both(rules, CORPUS_REF_FINDER, CORPUS_PT_FINDER)
    assert got.fallback_reason == ref.fallback_reason
    _assert_parity(ref, got, [c.input for c in CORPUS
                              if c.compile_err is None])


@pytest.mark.parametrize("rules,dicts", [
    ([("r", "", "")], [{}, {"a": 1}]),                       # empty match
    ([("r", "false", "")], [{}]),                            # const false
    ([("a", 'a == 3 && as == "nope"', ""),                  # short circuit
      ("b", 'a == 2 || as == "nope"', ""),
      ("c", 'a == 2 && as == "nope"', ""),
      ("d", 'as == "x" || a == 2', "")], [{"a": 2}, {}, {"as": "x"}]),
    ([("default", "", ""), ("ns1", "", "ns1"), ("ns2", "", "ns2")], [{}]),
    ([("r0", 'a == 2 && request.header["host"] == "x"', "")],
     [{"a": 2, "request.header": {"host": "x"}}, {"a": 2}]),
    ([(f"r{i}", f"a == 2 && b == {i}", "") for i in range(20)],
     [{"a": 2, "b": 3}, {"a": 1}]),
    ([("dev", "a == 2", ""), ("host", 'ar[as] == "v"', "")],
     [{"a": 2, "as": "k", "ar": {"k": "v"}}]),
    ([("ss", "as == as2", ""), ("ss2", "as != as2 && a == 1", "")],
     [{"as": "x", "as2": "x"}, {"as": "x", "as2": "y", "a": 1}, {}]),
], ids=["empty", "false", "short-circuit", "namespaces", "attr-masks",
        "dedup", "fallback", "slot-eq"])
def test_ruleset_cases_match_reference(rules, dicts):
    ref, got = _compile_both(rules, CORPUS_REF_FINDER, CORPUS_PT_FINDER)
    assert got.n_atoms == ref.n_atoms
    _assert_parity(ref, got, dicts)


def test_namespace_mask_and_ids_match_reference():
    rules = [("default", "", ""), ("ns1", "", "ns1"), ("ns2", "", "ns2")]
    ref, got = _compile_both(rules, CORPUS_REF_FINDER, CORPUS_PT_FINDER)
    req = np.asarray([got.namespace_id("ns1"), got.namespace_id("other")])
    assert got.namespace_mask(req).tolist() == \
        np.asarray(ref.namespace_mask(req)).tolist() == \
        [[True, True, False], [True, False, False]]


def test_large_bookinfo_ruleset_matches_reference():
    """The 1k-rule Bookinfo-style ruleset of tests/test_ruleset.py."""
    rng = np.random.default_rng(0)
    rules = []
    for i in range(1000):
        parts = [f'destination.service == "svc{i % 50}.ns.svc.cluster.local"']
        if i % 3 == 0:
            parts.append(f'source.namespace != "ns{i % 7}"')
        if i % 5 == 0:
            parts.append(f'request.header["cookie"] == "user{i % 11}"')
        rules.append((f"r{i}", " && ".join(parts), ""))
    dicts = []
    for _ in range(64):
        d = {"destination.service":
             f"svc{rng.integers(0, 60)}.ns.svc.cluster.local",
             "source.namespace": f"ns{rng.integers(0, 8)}"}
        if rng.random() < 0.7:
            d["request.header"] = {"cookie": f"user{rng.integers(0, 12)}"}
        dicts.append(d)
    ref, got = _compile_both(rules, CORPUS_REF_FINDER, CORPUS_PT_FINDER)
    assert not got.host_fallback
    _assert_parity(ref, got, dicts)


def test_non_bool_match_rejected():
    with pytest.raises(TypeError_):
        pt_rs.compile_ruleset([pt_rs.Rule("r", '"str"')], CORPUS_PT_FINDER,
                              device="cpu")


def test_rule_pad_is_not_ported():
    with pytest.raises(NotPorted):
        pt_rs.compile_ruleset([pt_rs.Rule("r", "")], CORPUS_PT_FINDER,
                              rule_pad=8, device="cpu")


def test_host_eval_and_snapshot_oracle():
    got = pt_rs.compile_ruleset(
        [pt_rs.Rule("dev", "a == 2"),
         pt_rs.Rule("host", 'ar[as] == "v"', "ns1")], CORPUS_PT_FINDER,
        device="cpu")
    bag = DictBag({"a": 2, "as": "k", "ar": {"k": "v"}})
    assert got.host_eval(1, bag) == (True, False, False)
    oracle = pt_rs.SnapshotOracle(got.rules, CORPUS_PT_FINDER,
                                  seed=got.host_fallback)
    assert oracle.resolve(bag, "ns1") == ([0, 1], [0, 1], 0)
    assert oracle.resolve(bag, "ns2") == ([0], [0], 0)
