"""The check atoms as op programs (compiler/op_lower.py, ops/field_ops.py,
the atom_eval kernel's plain versions) against the JAX package's atom
closures (istio_tpu/compiler/tensor_expr.py _compile_node), on the CPU.

  * every conformance-corpus expression, lowered as one program and
    interpreted with torch ops (field_ops.interpret_plain), gives the
    reference closure's (val, ok, err) on every corpus input, and its
    literal pair (m, n) through atom_eval (the closures) and
    atom_eval_ops_plain; host-fallback decisions agree;
  * the authz world (make_rbac_store(24)) and route worlds: the ext
    literal planes rule_match reads equal the reference ruleset's, from
    the closures and from the op programs;
  * edge cases: runtime-pattern predicates with the pattern longer than
    the subject, empty, `*` only, leading and trailing `*`; strings at
    exactly max_len and beyond; numeric NaN and malformed order keys; a
    narrowed latency-tier byte plane; a 40-deep LAND chain and a
    balanced tree of 999 nodes; Sethi–Ullman operand swaps under OR,
    LAND, LOR, CMP and DPRED with an error on either side;
  * the port's copy of the corpus equals the reference's.
Every value is an int or a bool: the tolerance is exact equality."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.attribute.types import ValueType as RefV
from istio_tpu.compiler import layout as ref_layout
from istio_tpu.compiler import tensor_expr as ref_te
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.parser import parse as ref_parse
from istio_tpu.pilot import route_nfa as ref_nfa
from istio_tpu.runtime.config import SnapshotBuilder as RefBuilder
from istio_tpu.testing import corpus as ref_corpus
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop, kernels
from istio_tpu_torch.attribute.bag import DictBag, bag_from_mapping
from istio_tpu_torch.compiler import layout as pt_layout
from istio_tpu_torch.compiler import op_lower
from istio_tpu_torch.compiler import ruleset as pt_rs
from istio_tpu_torch.compiler import tensor_expr as pt_te
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.ops import field_ops as fo
from istio_tpu_torch.pilot import route_nfa
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.testing import corpus as pt_corpus
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


RUNNABLE = [c for c in ref_corpus.CORPUS if c.compile_err is None]
INPUTS = [c.input for c in RUNNABLE]


def _layout_args(reqs):
    return (sorted(reqs.derived_keys), sorted(reqs.byte_sources, key=str),
            [(n, k, ast) for (n, k), ast in reqs.extern_sources.items()])


def _narrow(batch, width):
    return batch if width is None else dataclasses.replace(
        batch, str_bytes=batch.str_bytes[:, :, :width])


def _reference(texts, manifest, dicts, max_str_len=128, width=None):
    """The reference's closures of every expression over one layout →
    [(val int32, ok, err)] as numpy."""
    finder = RefFinder(manifest)
    asts = [ref_parse(t) for t in texts]
    reqs = ref_te.Requirements()
    for ast in asts:
        ref_te.collect_requirements(ast, finder, reqs)
    dk, bs, ex = _layout_args(reqs)
    lay = ref_layout.build_layout(manifest, dk, bs, max_str_len=max_str_len,
                                  extern_sources=ex)
    interner = ref_layout.InternTable()
    ctx = ref_te._Ctx(lay, interner, finder)
    nodes = [ref_te._compile_node(ast, ctx) for ast in asts]
    batch = _narrow(ref_layout.Tensorizer(lay, interner).tensorize(
        [RefDictBag(d) for d in dicts]), width)
    out = []
    for node in nodes:
        t = node(batch)
        out.append((np.asarray(t.val).astype(np.int32), np.asarray(t.ok),
                    np.asarray(t.err)))
    return out


def _port(texts, manifest, dicts, max_str_len=128, width=None):
    """The port's closures and op programs of every expression over one
    layout → (closures, OpProgram, batch, (layout, interner, finder))."""
    finder = AttributeDescriptorFinder(manifest)
    asts = [parse(t) for t in texts]
    reqs = pt_te.Requirements()
    for ast in asts:
        pt_te.collect_requirements(ast, finder, reqs)
    dk, bs, ex = _layout_args(reqs)
    lay = pt_layout.build_layout(manifest, dk, bs, max_str_len=max_str_len,
                                 extern_sources=ex)
    interner = pt_layout.InternTable()
    ctx = pt_te._Ctx(lay, interner, finder)
    nodes = [pt_te._compile_node(ast, ctx) for ast in asts]
    prog = op_lower.lower_programs(asts, lay, interner, finder)
    batch = _narrow(pt_layout.Tensorizer(lay, interner).tensorize(
        [DictBag(d) for d in dicts]), width)
    return nodes, prog, batch, (lay, interner, finder)


def _literals(val, ok, err):
    ee = err | ~ok
    v = val != 0
    return v & ~ee, ~v & ~ee


def _assert_programs_equal(texts, ref_manifest, dicts, bool_typed,
                           max_str_len=128, width=None):
    """Op programs and closures of the port equal the reference's
    closures; BOOL expressions also as atoms (m, n) through both
    atom_eval plain versions. → the OpProgram."""
    want = _reference(texts, ref_manifest, dicts, max_str_len, width)
    manifest = interop.manifest_from_reference(ref_manifest)
    nodes, prog, batch, lowering = _port(texts, manifest, dicts, max_str_len,
                                         width)
    got = fo.interpret_plain(batch, prog)
    for i, text in enumerate(texts):
        closure = nodes[i](batch)
        for part, g, c, w in zip(
                ("val", "ok", "err"), got[i],
                (closure.val.to(torch.int32), closure.ok, closure.err),
                want[i]):
            np.testing.assert_array_equal(g.numpy(), w,
                                          err_msg=f"{text}: {part} (ops)")
            np.testing.assert_array_equal(c.numpy(), w,
                                          err_msg=f"{text}: {part} (closure)")
    atoms = [i for i in range(len(texts)) if bool_typed[i]]
    if atoms:
        sub = op_lower.lower_programs([parse(texts[i]) for i in atoms],
                                      *lowering)
        ap = fo.AtomProgram(fns=[nodes[i] for i in atoms], prog=sub,
                            cols=np.arange(len(atoms), dtype=np.int32))
        b = len(dicts)
        for fn in (fo.atom_eval, fo.atom_eval_ops_plain):
            em = torch.ones((b, len(atoms)), dtype=torch.bool)
            en = torch.ones((b, len(atoms)), dtype=torch.bool)
            fn(batch, ap, em, en)
            for j, i in enumerate(atoms):
                m, n = _literals(*want[i])
                np.testing.assert_array_equal(em[:, j].numpy(), m,
                                              err_msg=f"{texts[i]}: m")
                np.testing.assert_array_equal(en[:, j].numpy(), n,
                                              err_msg=f"{texts[i]}: n")
    return prog


def _bool_typed(text, manifest) -> bool:
    from istio_tpu.expr.checker import DEFAULT_FUNCS, eval_type
    return eval_type(ref_parse(text), RefFinder(manifest),
                     DEFAULT_FUNCS) == RefV.BOOL


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

def test_port_corpus_copy_equals_reference():
    def view(c):
        # repr: a NaN input is not equal to itself
        return (c.e, repr(c.input), repr(c.result), c.err, c.compile_err,
                None if c.type_ is None else c.type_.name, c.referenced,
                c.name)
    assert [view(c) for c in pt_corpus.CORPUS] == \
        [view(c) for c in ref_corpus.CORPUS]
    assert {k: v.name for k, v in pt_corpus.CORPUS_MANIFEST.items()} == \
        {k: v.name for k, v in ref_corpus.CORPUS_MANIFEST.items()}


@pytest.mark.parametrize("case", RUNNABLE, ids=lambda c: c.id())
def test_corpus_atom_program_equals_reference(case):
    """Every corpus expression as one program over every corpus input;
    the same host-fallback decision as the reference."""
    man = ref_corpus.CORPUS_MANIFEST
    try:
        _reference([case.e], man, INPUTS)
    except ref_te.HostFallback:
        with pytest.raises(pt_te.HostFallback):
            _port([case.e], interop.manifest_from_reference(man), INPUTS)
        return
    prog = _assert_programs_equal([case.e], man, INPUTS,
                                  [_bool_typed(case.e, man)])
    n_ops = int(prog.starts[1])
    assert prog.need <= max(int(np.log2(n_ops + 1)), 1)


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------

EDGE_MANIFEST = {"s": RefV.STRING, "p": RefV.STRING, "q": RefV.STRING,
                 "n": RefV.INT64, "m": RefV.INT64, "d": RefV.DOUBLE,
                 "d2": RefV.DOUBLE, "t": RefV.TIMESTAMP, "b": RefV.BOOL,
                 "b2": RefV.BOOL, "h": RefV.STRING_MAP, "h2": RefV.STRING_MAP}
MAX_LEN = 8
SUBJECTS = ["", "a", "abc", "abcdefg", "abcdefgh", "abcdefghij", "xbc",
            "*bc", "bc", "abc*", None]
PATTERNS = ["", "*", "**", "a", "abc", "*bc", "abc*", "*", "abcdefgh",
            "abcdefghijk", "bc", "x*", "*x", "a*c", None]


def _edge_dicts() -> list[dict]:
    out = []
    for i, s in enumerate(SUBJECTS):
        for j, p in enumerate(PATTERNS):
            d = {}
            if s is not None:
                d["s"] = s
            if p is not None:
                d["p"] = p
            if (i + j) % 3:
                d["q"] = PATTERNS[(i * 7 + j) % len(PATTERNS)] or "zz"
            if (i + j) % 4 == 1:
                d["h"] = {"k": s or "", "j": p or "*"}
            if (i + j) % 5 == 2:
                d["h2"] = {"k": "h2"}
            out.append(d)
    return out


DYN_PREDS = ["s.startsWith(p)", "s.endsWith(p)", "match(s, p)",
             "(s | q).startsWith(p | q)", 'match(h["k"] | s, h["j"] | "*")',
             "s.endsWith(s)", 'match("abc", p)', 'p.startsWith("")',
             '"".endsWith(p)', "match(s, q | p)"]
CONST_PREDS = ['s.startsWith("abc")', 's.endsWith("bc")', 'match(s, "*bc")',
               'match(s, "abc*")', 'match(s, "abcdefgh")', 'match(s, "a")',
               's.startsWith("")', 's.endsWith("abcdefghijk")',
               '(s | p).endsWith("*")', '"^ab".matches(s)',
               '"c$".matches(s)', '"b+c".matches(s)',
               '"^$".matches(h["k"] | p)',
               '(s.startsWith("a") || p.endsWith("*")) == b',
               '"(".matches(s)']


def test_dyn_and_const_byte_predicates_equal_reference():
    """Runtime and constant patterns: longer than the subject, empty,
    `*` only, leading / trailing `*`, subjects at exactly max_len and
    truncated past it, absent operands, `|` views, map views."""
    texts = DYN_PREDS + CONST_PREDS
    prog = _assert_programs_equal(texts, EDGE_MANIFEST, _edge_dicts(),
                                  [_bool_typed(t, EDGE_MANIFEST)
                                   for t in texts], max_str_len=MAX_LEN)
    ops = {int(o) for o in prog.ops[:, 0]}
    assert {fo.OP_DPRED, fo.OP_BPRED, fo.OP_DFA, fo.OP_BSLOT,
            fo.OP_BCONST, fo.OP_ERR} <= ops


CMP_TEXTS = ["s < p", "s <= q", "p > s", "q >= p", '"abc" < s',
             's >= "abcdefgh"', "n < m", "n >= m", "d < d2", "d2 >= d",
             "d > 1.5", "t < t", "(s | q) < p", "n < 7", "d <= d",
             "b < b2", "s < n", "n < d"]


def _cmp_dicts() -> list[dict]:
    out = []
    nums = [None, 0, -3, 7, 2 ** 40, "malformed", 7.5]
    dbls = [None, float("nan"), 1.5, -0.0, 0.0, 2.5, "bad", float("inf")]
    for i in range(60):
        d = {}
        s, p = SUBJECTS[i % len(SUBJECTS)], PATTERNS[i % len(PATTERNS)]
        if s is not None:
            d["s"] = s
        if p is not None:
            d["p"] = p
        if i % 3:
            d["q"] = SUBJECTS[(i * 5) % len(SUBJECTS)] or ""
        for k, vals, step in (("n", nums, 1), ("m", nums, 3),
                              ("d", dbls, 1), ("d2", dbls, 5)):
            v = vals[(i * step + i // len(vals)) % len(vals)]
            if v is not None:
                d[k] = v
        if i % 2:
            d["b"], d["b2"] = bool(i % 4 == 1), True
        out.append(d)
    return out


def test_ordered_compares_equal_reference():
    """Strings at and past the cap (err), numeric NaN (False, never err)
    and malformed (err) order keys, type mismatches and unorderable
    types (ERR every row), constant views on either side."""
    texts = [t for t in CMP_TEXTS if t != "n < d"]   # mixed numeric: host
    prog = _assert_programs_equal(texts, EDGE_MANIFEST, _cmp_dicts(),
                                  [True] * len(texts), max_str_len=MAX_LEN)
    assert fo.OP_CMP in {int(o) for o in prog.ops[:, 0]}
    with pytest.raises(pt_te.HostFallback):
        _port(["n < d"], interop.manifest_from_reference(EDGE_MANIFEST),
              [{}], MAX_LEN)


def test_narrowed_byte_plane_equals_reference():
    """A latency-tier batch whose str_bytes is sliced below max_str_len:
    constant rows supply the batch's width and keep their true length."""
    dicts = [d for d in _edge_dicts()
             if all(len(v) <= 12 for v in d.values() if isinstance(v, str))]
    texts = DYN_PREDS + CONST_PREDS[:9] + ["s < p", '"abc" < s',
                                           's >= "abcdefgh"']
    _assert_programs_equal(texts, EDGE_MANIFEST, dicts,
                           [_bool_typed(t, EDGE_MANIFEST) for t in texts],
                           max_str_len=32, width=12)


def _balanced(leaves: list[str], ops=("&&", "||")) -> str:
    if len(leaves) == 1:
        return leaves[0]
    mid = len(leaves) // 2
    op = ops[len(leaves) % len(ops)]
    return f"({_balanced(leaves[:mid], ops)} {op} " \
        f"{_balanced(leaves[mid:], ops)})"


def _deep_dicts() -> list[dict]:
    rng = np.random.default_rng(7)
    out = []
    for _ in range(48):
        d = {}
        for k in ("b", "b2"):
            if rng.random() < 0.8:
                d[k] = bool(rng.random() < 0.6)
        for k in ("n", "m"):
            if rng.random() < 0.8:
                d[k] = int(rng.integers(0, 3))
        if rng.random() < 0.7:
            d["s"] = str(rng.choice(["abc", "x", "abcdefghij"]))
        out.append(d)
    return out


def test_deep_land_chain_and_balanced_tree_lower_without_leaf():
    """A 40-deep LAND chain (left-nested as parsed and right-nested) and
    a balanced LAND / LOR tree of 999 nodes: one program each, no
    closure, stack within floor(log2(n + 1))."""
    leaves = [f"n == {i % 3}" if i % 3 == 0 else
              ("b" if i % 3 == 1 else 's.startsWith("ab")')
              for i in range(40)]
    left = " && ".join(leaves)
    right = "".join(f"({x} && " for x in leaves[:-1]) + leaves[-1] + \
        ")" * (len(leaves) - 1)
    tree = _balanced(["b", "b2", "n == 1", "m == 2", "b2"] * 100)
    texts = [left, right, f"({tree}) == true"]
    prog = _assert_programs_equal(texts, EDGE_MANIFEST, _deep_dicts(),
                                  [True] * 3, max_str_len=MAX_LEN)
    sizes = np.diff(prog.starts)
    # 40 leaves (three rows for an EQ, two for a BSLOT + BPRED) and 39 LAND
    assert sizes[0] == sizes[1] > 100 and sizes[2] > 1000
    assert prog.need <= int(np.log2(sizes.max() + 1))
    assert prog.need <= 3 + 10           # the tree: depth 10, EQ leaves


SWAPS = [
    # right operand deeper: emitted first, the op row's order bit set;
    # the left operand is absent (OR), or an error, on some rows
    "b || (b2 && (n == 1 || m == 2))",
    "b && (b2 || (n == 1 && m == 2))",
    'timestamp(s) == t || (b && (b2 || n == 1))',
    'timestamp(s) == t && (b || (b2 && n == 1))',
    '(s | (p | (q | "z"))) == "abc"',
    '(h["k"] | (h2["k"] | (s | "none"))) == "h2"',
    's < (p | (q | "zz"))',
    's.startsWith(p | (q | (h["j"] | "a")))',
    'match(s, p | (q | "*"))',
    # and the mirror: left deeper, no swap
    "(b2 && (n == 1 || m == 2)) || b",
    '((b || (b2 && n == 1)) && timestamp(s) == t)',
]


def test_sethi_ullman_swaps_keep_error_rules():
    texts = SWAPS
    dicts = _deep_dicts() + [
        {"s": "2018-03-01T12:00:00Z", "t": "2018-03-01T12:00:00Z",
         "b": False}, {"s": "never", "b2": True, "n": 1},
        {"s": "abc", "p": "a"}, {"h": {"k": "x"}, "h2": {"k": "h2"}},
        {"h2": {"k": "h2"}}, {}]
    import datetime
    for d in dicts:
        if isinstance(d.get("t"), str):
            d["t"] = datetime.datetime(2018, 3, 1, 12,
                                       tzinfo=datetime.timezone.utc)
    prog = _assert_programs_equal(texts, EDGE_MANIFEST, dicts,
                                  [True] * len(texts), max_str_len=MAX_LEN)
    two = np.isin(prog.ops[:, 0], sorted(fo.TWO_OPERAND))
    swapped = {int(o) for o in prog.ops[two & (prog.ops[:, 4] == 1), 0]}
    assert {fo.OP_OR, fo.OP_LAND, fo.OP_LOR, fo.OP_CMP,
            fo.OP_DPRED} <= swapped, sorted(fo.OP_NAMES[o] for o in swapped)
    assert (prog.ops[two, 4] == 0).any()


def test_stack_limit_is_a_compile_error(monkeypatch):
    """A program that needs more than the kernel's stack raises at
    lowering (never a quiet closure)."""
    monkeypatch.setattr(fo, "MAX_STACK", 2)
    man = interop.manifest_from_reference(EDGE_MANIFEST)
    with pytest.raises(op_lower.NotLowerable):
        _port(["(b && b2) || (b2 && b)"], man, [{}], MAX_LEN)


# ---------------------------------------------------------------------------
# rulesets: the ext literal planes rule_match reads
# ---------------------------------------------------------------------------

def _ref_ext_planes(rs, batch) -> tuple[np.ndarray, np.ndarray]:
    """The reference ruleset's ext literal columns (the DFA-group atoms,
    then the generic tier in its order): its own run, with literal and
    conjunction index rows that copy the literal plane through."""
    g = rs.geometry
    n_live, n_fused = g["n_live"], g["n_fused_conjs"]
    w = 2 * n_live + 1
    params = dict(rs.params)
    params["lit_idx"] = jnp.arange(w, dtype=jnp.int32)[:, None]
    params["conj_m_idx"] = params["conj_n_idx"] = \
        (n_fused + jnp.arange(w, dtype=jnp.int32))[:, None]
    lit = np.asarray(rs.fn(params, batch)[0])
    off = g["n_eq_atoms"] + g["n_ss_atoms"]
    n_ext = g["n_dfa_atoms"] + g["n_gen_atoms"]
    return (lit[:, off:off + n_ext],
            lit[:, n_live + off:n_live + off + n_ext])


def _port_ext_planes(rs, batch, monkeypatch) -> list:
    """The port ruleset's ext planes as its run hands them to
    rule_match (closures on the CPU), and the same planes with the
    atom_eval columns rewritten by the op programs."""
    seen = {}
    real = pt_rs.rule_match

    def spy(ids, present, em, en, params, c, *planes):
        seen["planes"] = (em.clone(), en.clone())
        return real(ids, present, em, en, params, c, *planes)
    monkeypatch.setattr(pt_rs, "rule_match", spy)
    rs(batch)
    em, en = seen["planes"]
    cols = torch.from_numpy(rs.atoms.cols).long()
    om, on = em.clone(), en.clone()
    om[:, cols] = ~om[:, cols]
    on[:, cols] = ~on[:, cols]
    fo.atom_eval_ops_plain(batch, rs.atoms, om, on)
    return [(em, en), (om, on)]


def _authz(n_roles: int):
    ref_store = ref_workloads.make_rbac_store(n_roles)
    pt_store = interop.store_from_reference(ref_store)
    try:
        builder = RefBuilder(ref_workloads.MESH_MANIFEST)
        builder.decomp_cache = None
        want = builder.build(ref_store).ruleset
        got = SnapshotBuilder(workloads.MESH_MANIFEST,
                              device="cpu").build(pt_store).ruleset
    finally:
        pt_store.close()
        ref_store.close()
    dicts = workloads.make_rbac_request_dicts(96, seed=5)
    return want, got, dicts


def _routes(n_routes: int):
    services, rules = ref_workloads.make_route_world(n_routes)
    ref = ref_nfa.RouteTable(services, rules)
    p_services, p_rules = interop.pilot_world_from_reference(services, rules)
    port = route_nfa.RouteTable(p_services, p_rules, device="cpu")
    dicts = ref_workloads.make_route_requests(128,
                                              n_services=len(services))
    return ref.program, port.program, dicts


@pytest.mark.parametrize("world", ["authz_24", "routes_200", "routes_1000"])
def test_world_ext_planes_equal_reference(world, monkeypatch):
    kind, n = world.split("_")
    want_rs, got_rs, dicts = (_authz if kind == "authz" else _routes)(int(n))
    assert got_rs.atoms.n > 0
    assert got_rs.geometry["n_prog_atoms"] == got_rs.atoms.n
    rb = ref_layout.Tensorizer(want_rs.layout, want_rs.interner).tensorize(
        [ref_bag(d) for d in dicts])
    pb = pt_layout.Tensorizer(got_rs.layout, got_rs.interner).tensorize(
        [bag_from_mapping(d) for d in dicts])
    want = _ref_ext_planes(want_rs, rb)
    assert want[0].any() and want[1].any()
    for m, n in _port_ext_planes(got_rs, pb, monkeypatch):
        np.testing.assert_array_equal(m.numpy(), want[0])
        np.testing.assert_array_equal(n.numpy(), want[1])
    cols = got_rs.atoms.cols
    assert want[0][:, cols].any() or want[1][:, cols].any()
    # the whole match agrees too
    for g, w in zip(got_rs(pb), want_rs(rb)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_authz_atoms_are_programs_not_closures():
    """At make_rbac_store(24) every generic-tier atom that is not a
    constant byte predicate is an op program: none is left to a
    closure on the device path."""
    _, got, _ = _authz(24)
    g = got.geometry
    n_byte = sum(1 for a, tier in got.atom_tier.items() if tier == "tensor"
                 and pt_te.is_const_byte_pred(_atom_ast(got, a)))
    assert g["n_prog_atoms"] + n_byte == g["n_gen_atoms"]
    assert g["n_prog_atoms"] > 0 and g["atom_stack"] <= 3


def _atom_ast(rs, aidx):
    # atom ASTs are not kept on the program; rebuild the table
    return _ATOMS.setdefault(id(rs), _atom_table(rs))[aidx]


_ATOMS: dict = {}


def _atom_table(rs):
    atoms = pt_rs._AtomTable()
    for rule in rs.rules:
        try:
            pt_rs._decompose(pt_rs._rule_ast(rule), atoms, 10 ** 6)
        except pt_te.HostFallback:
            pass
    return atoms.asts


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_atom_eval_refuses_mixed_devices_and_bad_planes():
    man = interop.manifest_from_reference(EDGE_MANIFEST)
    nodes, prog, batch, _ = _port(["s.startsWith(p)"], man, [{"s": "a"}],
                                  MAX_LEN)
    ap = fo.AtomProgram(fns=nodes, prog=prog,
                        cols=np.zeros(1, np.int32))
    meta = torch.empty((1, 1), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        fo.atom_eval(batch, ap, meta, meta)
    with pytest.raises(ValueError, match="bool"):
        fo.atom_eval(batch, ap, torch.zeros((1, 1), dtype=torch.int32),
                     torch.zeros((1, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="column"):
        fo.atom_eval(batch, ap, torch.zeros((1, 0), dtype=torch.bool),
                     torch.zeros((1, 0), dtype=torch.bool))
    kernels.launches.reset()
    em = torch.zeros((1, 1), dtype=torch.bool)
    en = torch.zeros((1, 1), dtype=torch.bool)
    fo.atom_eval(batch, ap, em, en)
    assert kernels.launches["atom_eval"] == 0       # CPU: the closures
    assert (bool(em[0, 0]), bool(en[0, 0])) == (False, False)   # p absent


def test_atom_eval_is_an_entry_point_of_field_eval():
    assert "atom_eval" in kernels.KERNELS
    assert kernels.source_of("atom_eval") == "field_eval"
    assert kernels.ENTRY_POINTS["field_eval"] == ("field_eval",
                                                  "atom_eval")
    assert kernels._lib_path("atom_eval") == kernels._lib_path("field_eval")
    assert set(kernels.launches.entries) >= {"atom_eval", "field_eval"}
