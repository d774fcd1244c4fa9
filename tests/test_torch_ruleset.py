"""The port's ruleset compiler against the JAX package's: the emitted
index tensors (lit_idx, conj_m_idx, conj_n_idx, eqc_*) must be
array_equal to the reference params, and matched / not_matched / err
equal to the reference program on the same bags (plain versions of the
kernels on the CPU). Covers the make_rules worlds and the
tests/test_ruleset.py cases. The rule_match kernel's own formulation
(the word tables, 32 requests per int32 word: rule_match_words_plain)
is held against the reference's run on the same worlds, the authz store,
atom-less, all-EQ and host-fallback snapshots, at B = 1 to 97 and for
every plane subset. Every value is a bool: the tolerance is exact
equality."""
import functools
import itertools

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


def _compile_both(rules, ref_finder, pt_finder, rule_pad=1):
    ref = ref_rs.compile_ruleset(
        [ref_rs.Rule(r[0], r[1], r[2]) for r in rules], ref_finder,
        jit=False, rule_pad=rule_pad)
    got = pt_rs.compile_ruleset(
        [pt_rs.Rule(r[0], r[1], r[2]) for r in rules], pt_finder,
        rule_pad=rule_pad, device="cpu")
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


def _bookinfo():
    """The 1k-rule Bookinfo-style ruleset of tests/test_ruleset.py and
    its 64 requests."""
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
    return rules, dicts


def test_large_bookinfo_ruleset_matches_reference():
    """The 1k-rule Bookinfo-style ruleset of tests/test_ruleset.py."""
    rules, dicts = _bookinfo()
    ref, got = _compile_both(rules, CORPUS_REF_FINDER, CORPUS_PT_FINDER)
    assert not got.host_fallback
    _assert_parity(ref, got, dicts)


def test_non_bool_match_rejected():
    with pytest.raises(TypeError_):
        pt_rs.compile_ruleset([pt_rs.Rule("r", '"str"')], CORPUS_PT_FINDER,
                              device="cpu")


@pytest.mark.parametrize("rule_pad", [1, 8])
def test_rule_pad_matches_reference(rule_pad):
    """rule_pad rounds the rule axis up to a multiple (the snapshot
    builder always compiles with 8): every ruleset array, the pad rows'
    sentinels (matched False, not_matched True, err False, namespace
    -7) and the engine step equal the reference's."""
    from istio_tpu.models import policy_engine as ref_pe
    from istio_tpu_torch.models import policy_engine as pt_pe
    n_rules = 61
    rules = [(r.name, r.match, r.namespace)
             for r in ref_workloads.make_rules(n_rules, with_regex=True)]
    pt_finder = AttributeDescriptorFinder(
        manifest_from_reference(ref_workloads.MESH_MANIFEST))
    ref, got = _compile_both(rules, ref_workloads.MESH_FINDER, pt_finder,
                             rule_pad=rule_pad)
    n_rows = -(-n_rules // rule_pad) * rule_pad
    assert got.n_rules == n_rules
    assert got.rule_ns.shape == (n_rows,)
    assert got.attr_mask.shape[0] == n_rows
    dicts, ns = workloads.make_hit_requests(n_rules, 40, seed=5)
    m, n, e = _assert_parity(ref, got, dicts)
    assert m.shape == (40, n_rows)
    assert not m[:, n_rules:].any() and n[:, n_rules:].all() \
        and not e[:, n_rules:].any()
    assert (got.rule_ns[n_rules:] == -7).all()
    conj_true = got.geometry["n_conjs"] + 1
    assert (got.params["conj_n_idx"][n_rules:, 0] == conj_true).all()
    deny = list(range(0, n_rules, 3))
    ref_eng = ref_pe.PolicyEngine(
        ruleset=ref, finder=ref_workloads.MESH_FINDER,
        deny=[ref_pe.DenySpec(rule=i) for i in deny], count_rules=n_rules)
    pt_eng = pt_pe.PolicyEngine(
        ruleset=got, finder=pt_finder,
        deny=[pt_pe.DenySpec(rule=i) for i in deny], count_rules=n_rules,
        device="cpu")
    req = np.asarray([got.namespace_id(x) for x in ns], np.int32)
    rv = ref_eng.check(ref_layout.Tensorizer(ref.layout, ref.interner)
                       .tensorize([RefDictBag(d) for d in dicts]), req)
    pv = pt_eng.check(pt_eng.tensorizer.tensorize(
        [DictBag(d) for d in dicts]), req)
    for f in ("status", "valid_duration_s", "valid_use_count",
              "referenced", "matched", "err", "deny_rule", "err_count"):
        np.testing.assert_array_equal(getattr(pv, f).numpy(),
                                      np.asarray(getattr(rv, f)), err_msg=f)


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


# ---------------------------------------------------------------------------
# the kernel's word formulation against the reference's run
# ---------------------------------------------------------------------------

def _mesh_finders():
    return ref_workloads.MESH_FINDER, AttributeDescriptorFinder(
        manifest_from_reference(ref_workloads.MESH_MANIFEST))


def _authz_world():
    """make_rbac_store(24) compiled by both packages' snapshot builders
    (the reference's without its decomposition cache)."""
    from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
    from istio_tpu_torch import interop
    from istio_tpu_torch.runtime.config import SnapshotBuilder
    ref_store = ref_workloads.make_rbac_store(24)
    pt_store = interop.store_from_reference(ref_store)
    try:
        builder = RefBuilder(ref_workloads.MESH_MANIFEST)
        builder.decomp_cache = None
        ref = builder.build(ref_store).ruleset
        got = SnapshotBuilder(workloads.MESH_MANIFEST,
                              device="cpu").build(pt_store).ruleset
    finally:
        pt_store.close()
        ref_store.close()
    return ref, got, workloads.make_rbac_request_dicts(96, seed=5)


@functools.lru_cache(maxsize=None)
def _word_world(name: str):
    """→ (reference program, port program, request dicts)."""
    if name.startswith("make_rules_") or name == "rule_pad":
        n, pad = (61, 8) if name == "rule_pad" else (int(name[11:]), 1)
        rules = [(r.name, r.match, r.namespace)
                 for r in ref_workloads.make_rules(n, with_regex=True)]
        dicts, _ = workloads.make_hit_requests(n, 120, seed=n)
        return (*_compile_both(rules, *_mesh_finders(), rule_pad=pad),
                dicts + workloads.make_request_dicts(60, seed=2))
    if name == "authz":
        return _authz_world()
    if name == "corpus":
        rules = [(f"r{i}", c.e, "") for i, c in enumerate(_bool_cases())]
        dicts = [c.input for c in CORPUS if c.compile_err is None]
    elif name == "bookinfo":
        rules, dicts = _bookinfo()
    else:
        rules, dicts = {
            "atom_less": ([("t", "", ""), ("f", "false", "ns1")],
                          [{}, {"a": 1}]),
            "empty": ([], [{}, {"a": 2}]),
            "all_eq": ([("eq", "a == 2", ""), ("neq", 'as != "x"', "ns1"),
                        ("both", 'a == 1 && as == "y"', "")],
                       [{"a": 2}, {"as": "x"}, {"a": 1, "as": "y"}, {}]),
            "fallback": ([("dev", "a == 2", ""),
                          ("host", 'ar[as] == "v"', "ns1"),
                          ("ss", "as == as2", "")],
                         [{"a": 2, "as": "k", "ar": {"k": "v"}},
                          {"as": "x", "as2": "x"}, {}]),
        }[name]
    return (*_compile_both(rules, CORPUS_REF_FINDER, CORPUS_PT_FINDER),
            dicts)


WORD_WORLDS = ["make_rules_64", "make_rules_1000", "corpus", "bookinfo",
               "rule_pad", "authz", "atom_less", "empty", "all_eq",
               "fallback"]


def _k1_inputs(got, dicts):
    """The arguments the port program's run hands rule_match."""
    seen = {}
    real = pt_rs.rule_match

    def spy(*args):
        seen["args"] = args[:6]
        return real(*args)
    pt_rs.rule_match = spy
    try:
        got(pt_layout.Tensorizer(got.layout, got.interner).tensorize(
            [DictBag(d) for d in dicts]))
    finally:
        pt_rs.rule_match = real
    return seen["args"]


def _rows(dicts, b):
    return (dicts * (-(-b // len(dicts))))[:b]


def _ref_planes(ref, dicts):
    rb = ref_layout.Tensorizer(ref.layout, ref.interner).tensorize(
        [RefDictBag(d) for d in dicts])
    return [np.asarray(a) for a in ref(rb)]


@pytest.mark.parametrize("world", WORD_WORLDS)
def test_word_plain_matches_reference(world):
    ref, got, dicts = _word_world(world)
    args = _k1_inputs(got, dicts)
    want = _ref_planes(ref, dicts)
    words = pt_rs.rule_match_words_plain(*args)
    for name, w, h, p in zip(pt_rs.PLANES, want, words,
                             pt_rs.rule_match_plain(*args)):
        np.testing.assert_array_equal(h.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(p.numpy(), w, err_msg=name)
    # the tables: the two sentinel rows, ascending TRUE-padded rows
    c = got.geometry
    consts = args[5]
    q = consts.n_lits
    rows = consts.conj_lit.numpy()
    assert rows.shape[0] == max(c["n_conjs"], 1) + 2
    assert (np.diff(rows, axis=1) >= 0).all()
    assert rows[-2, 0] == 2 * q and (rows[-1] == 2 * q + 1).all()
    assert (rows >= 0).all() and (rows <= 2 * q + 1).all()


@pytest.mark.parametrize("b", [1, 31, 32, 33, 97])
@pytest.mark.parametrize("world", ["make_rules_64", "corpus", "authz",
                                   "rule_pad"])
def test_word_plain_request_counts(world, b):
    """Request counts that are not a multiple of 32: the tail bits of
    the last word never reach a plane."""
    ref, got, dicts = _word_world(world)
    dicts = _rows(dicts, b)
    words = pt_rs.rule_match_words_plain(*_k1_inputs(got, dicts))
    for name, w, h in zip(pt_rs.PLANES, _ref_planes(ref, dicts), words):
        assert h.shape == w.shape == (b, got.rule_ns.shape[0])
        np.testing.assert_array_equal(h.numpy(), w, err_msg=name)


PLANE_SUBSETS = [s for k in (1, 2, 3)
                 for s in itertools.combinations(pt_rs.PLANES, k)]


@pytest.mark.parametrize("planes", PLANE_SUBSETS,
                         ids=["+".join(s) for s in PLANE_SUBSETS])
@pytest.mark.parametrize("world", ["make_rules_64", "fallback"])
def test_plane_subsets(world, planes):
    """A program asked for some planes returns those (equal to the
    reference's) and None in place of the others; so do the plain
    versions."""
    ref, got, dicts = _word_world(world)
    want = _ref_planes(ref, dicts)
    batch = pt_layout.Tensorizer(got.layout, got.interner).tensorize(
        [DictBag(d) for d in dicts])
    args = _k1_inputs(got, dicts)
    for out in (got(batch, planes), got.fn(got.params, batch, planes),
                pt_rs.rule_match_plain(*args, planes),
                pt_rs.rule_match_words_plain(*args, planes)):
        for name, w, h in zip(pt_rs.PLANES, want, out):
            if name in planes:
                np.testing.assert_array_equal(h.numpy(), w, err_msg=name)
            else:
                assert h is None, name


def test_plane_names_are_checked():
    _, got, dicts = _word_world("make_rules_64")
    args = _k1_inputs(got, dicts)
    for bad in ((), ("matched", "sat")):
        with pytest.raises(ValueError):
            pt_rs.rule_match(*args, bad)
        with pytest.raises(ValueError):
            pt_rs.rule_match_words_plain(*args, bad)


def test_word_tables_compute_each_compare_once():
    """One literal per distinct (col, cid) compare, fused slots and
    legacy EQ atoms together: fewer literals than fused literal slots;
    numbered by first use, and each found by the kernel's table probe."""
    _, got, dicts = _word_world("make_rules_1000")
    c = _k1_inputs(got, dicts)[5]
    pad = got.params["eqc_pad"].numpy()[:c.n_fused]
    slots = np.stack([got.params["eqc_col"].numpy()[:c.n_fused][~pad],
                      got.params["eqc_cid"].numpy()[:c.n_fused][~pad]], 1)
    legacy = np.stack([c.eq_cols.numpy(), c.eq_cids.numpy()], 1)
    pairs = {tuple(x) for x in np.concatenate([slots, legacy])}
    assert c.n_cmp == len(pairs) < len(slots)
    keys = [tuple(x) for x in np.stack(
        [c.lit_a.numpy()[:c.n_cmp], c.lit_b.numpy()[:c.n_cmp]], 1)]
    assert sorted(keys) == sorted(pairs)
    # numbered in order of first use: the conjunction rows, read in
    # order, name the compares 0, 1, 2, ...
    rows = c.conj_lit.numpy()
    used = rows[rows < 2 * c.n_cmp] // 2
    first = used[np.sort(np.unique(used, return_index=True)[1])]
    np.testing.assert_array_equal(first, np.arange(c.n_cmp))
    # every compare is found in the table, an absent key is not
    cols = torch.from_numpy(np.asarray([k[0] for k in keys] + [keys[0][0]]))
    cids = torch.from_numpy(np.asarray([k[1] for k in keys] + [-5]))
    np.testing.assert_array_equal(pt_rs.cmp_lookup(c, cols, cids).numpy(),
                                  list(range(c.n_cmp)) + [-1])
    assert c.n_ext == c.n_live - len(c.eq_cols) - len(c.ss_a)
