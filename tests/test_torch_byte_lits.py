"""The literal entry points of K3 and K2 (byte_lits, dfa_lits) on the CPU:
their plain versions against the JAX package's literal pair per atom.

The reference's pair of a constant byte predicate is its
_compile_byte_pred closure (istio_tpu/compiler/tensor_expr.py) turned
into m = val & ~ee, n = ~val & ~ee as its ruleset forms the generic
tier's literals (istio_tpu/compiler/ruleset.py parts_m / parts_n); a
regex group's is compile_dfa_group's (val, ee) → m = val, n = ~val & ~ee.
Both packages' closures run on the same subject view, made from a numpy
seed and injected in place of the subject's byte view (an attribute
view never errs, so an error row can only be made this way): absent and
error rows, lengths 0, k - 1, k, L - 1, L and past L, patterns of
k = 0, k = L and k > L, prefix / suffix / exact / glob groups, anchored
and unanchored regexes on possibly truncated rows, widths 8, 13 and 128,
contiguous, strided and stride-0 rows, a plane narrowed below max_len,
B ∈ {0, 1, 31, 32, 33}. The port writes each column into a pre-filled
plane at scattered columns; every other column must keep its bytes.
A ruleset whose world has two byte groups, one DFA group, atom_eval
atoms and an EQ atom sharing the ext planes is held against the JAX
run. Every value is a bool: the tolerance is exact equality."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.attribute.types import ValueType as RefV
from istio_tpu.compiler import layout as ref_layout
from istio_tpu.compiler import ruleset as ref_rs
from istio_tpu.compiler import tensor_expr as ref_te
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.parser import parse as ref_parse
from istio_tpu.ops import regex_dfa as ref_dfa

from istio_tpu_torch import kernels
from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.compiler import layout as pt_layout
from istio_tpu_torch.compiler import ruleset as pt_rs
from istio_tpu_torch.compiler import tensor_expr as pt_te
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.interop import manifest_from_reference
from istio_tpu_torch.ops import bytes_ops, regex_dfa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


WIDTHS = (8, 13, 128)
BATCHES = (0, 1, 31, 32, 33)
VIEWS = ("rows", "strided", "broadcast", "narrowed", "lean")
REGEXES = ("a+b*", "(ab|ba)+$", "^b", "[^a]b", "^$", "a", "b$", "^ab",
           "ab")


class Subject:
    """One subject view of B rows of width L from a numpy seed, as numpy
    arrays (data, lens, ok, err) and max_len. `view` picks the layout
    the port's plain version reads: contiguous rows, a column of a
    [B, 3, L] plane, a broadcast constant row, a plane narrowed to L of
    max_len = 2L (rows longer than the plane), or the lean masks (ok
    and err None: present on every row, never an error)."""

    def __init__(self, b: int, width: int, view: str, seed: int):
        rng = np.random.default_rng(seed)
        self.b, self.width, self.view = b, width, view
        self.max_len = 2 * width if view == "narrowed" else width
        lens_pool = [0, 1, 2, 3, width // 2, width - 2, width - 1, width,
                     width + 1, width + 4]
        if view == "broadcast":
            n = int(rng.integers(0, width + 1))
            row = np.zeros(width, np.uint8)
            row[:n] = rng.choice(np.frombuffer(b"ab", np.uint8), n)
            self.row = row
            self.data = np.broadcast_to(row, (b, width))
            self.lens = np.full(b, n, np.int32)
        else:
            lens = rng.choice(lens_pool, size=b).astype(np.int32)
            lens[::3] = rng.integers(0, width + 1, size=len(lens[::3]))
            data = np.zeros((b, width), np.uint8)
            for i, n in enumerate(lens):
                n = min(int(n), width)
                data[i, :n] = rng.choice(np.frombuffer(b"ab", np.uint8), n)
            self.data, self.lens = data, lens
        if view in ("broadcast", "lean"):
            self.ok = np.ones(b, bool)
            self.err = np.zeros(b, bool)
        else:
            self.ok = rng.random(b) < 0.85
            self.err = rng.random(b) < 0.1
        self.rng = rng

    def rows(self) -> list[bytes]:
        return [bytes(self.data[i, :min(int(n), self.width)])
                for i, n in enumerate(self.lens)]

    def ref(self):
        return ref_te.BVal(jnp.asarray(np.ascontiguousarray(self.data)),
                           jnp.asarray(self.lens), jnp.asarray(self.ok),
                           jnp.asarray(self.err))

    def port(self) -> pt_te.BVal:
        lens = torch.from_numpy(self.lens.copy())
        if self.view == "broadcast":
            data = torch.from_numpy(self.row.copy()).expand(self.b,
                                                            self.width)
        elif self.view == "strided":
            plane = torch.from_numpy(np.stack(
                [self.data[::-1], self.data, self.data], axis=1).copy())
            data = plane[:, 1, :]
            lens = torch.from_numpy(np.stack(
                [self.lens, -self.lens], axis=1).copy())[:, 0]
        else:
            data = torch.from_numpy(np.ascontiguousarray(self.data))
        if self.view in ("broadcast", "lean"):
            return pt_te.BVal(data, lens, None, None)
        pres = torch.from_numpy(np.stack([~self.ok, self.ok], 1).copy())
        return pt_te.BVal(data, lens, pres[:, 1],
                          torch.from_numpy(self.err.copy()))


def _texts(subj: Subject) -> list[str]:
    """Constant startsWith / endsWith / match() calls over `s` whose
    patterns are cut from the subject's own rows (so they hit) or made
    up: k = 0, 1, L - 1, L and L + 1 of each kind."""
    rng, width = subj.rng, subj.width
    rows = [r for r in subj.rows() if r] or [b"ab"]

    def cut(k: int, tail: bool) -> str:
        src = [r for r in rows if len(r) >= k]
        if not src or k == 0:
            return "".join(rng.choice(list("ab"), k))
        r = src[int(rng.integers(len(src)))]
        return (r[len(r) - k:] if tail else r[:k]).decode()

    out = []
    for k in (0, 1, 3, width - 1, width, width + 1):
        pre, suf = cut(k, False), cut(k, True)
        if k <= subj.max_len:            # longer → HostFallback in both
            out.append(f's.startsWith("{pre}")')
        out.append(f's.endsWith("{suf}")')
        if k < subj.max_len:             # the glob's '*' counts
            out.append(f'match(s, "{pre}*")')
            out.append(f'match(s, "*{suf}")')
        if k <= subj.max_len:
            out.append(f'match(s, "{pre}")')
    for r in rows[:3]:                   # exact hits
        if len(r) <= subj.max_len:
            out.append(f'match(s, "{r.decode()}")')
    return out


def _ref_pairs(calls, subj: Subject, monkeypatch, dfa: bool):
    """The reference's literal pairs [B, k] (m, n) of the calls (texts,
    or regex patterns with dfa=True) over the injected subject view."""
    view = subj.ref()
    monkeypatch.setattr(ref_te, "_compile_bytes",
                        lambda e, ctx: (lambda batch: view))
    ctx = types.SimpleNamespace(
        layout=types.SimpleNamespace(max_str_len=subj.max_len))
    if dfa and subj.b == 0:
        # the reference's DFA formulations cannot scan a zero-row batch
        return (np.zeros((0, len(calls)), bool),) * 2
    if dfa:
        fn = ref_te.compile_dfa_group(
            ref_parse("s"), list(calls),
            [ref_dfa.compile_regex(p) for p in calls], ctx)
        val, ee = (np.asarray(x) for x in fn(None))
        return val, ~val & ~ee
    ms, ns = [], []
    for text in calls:
        t = ref_te._compile_byte_pred(ref_parse(text).fn, ctx)(None)
        ee = np.asarray(t.err) | ~np.asarray(t.ok)
        val = np.asarray(t.val)
        ms.append(val & ~ee)
        ns.append(~val & ~ee)
    return (np.stack(ms, 1), np.stack(ns, 1)) if ms else \
        (np.zeros((subj.b, 0), bool),) * 2


def _prefilled(subj: Subject, k: int):
    """Scattered columns in planes [B, 2k + 5] pre-filled with a pattern
    that every column outside the group must keep."""
    x = 2 * k + 5
    cols = np.sort(subj.rng.permutation(x)[:k]).astype(np.int32)
    fill = subj.rng.random((2, subj.b, x)) < 0.5
    return cols, torch.from_numpy(fill[0].copy()), \
        torch.from_numpy(fill[1].copy())


def _check_planes(em, en, fill_m, fill_n, cols, want_m, want_n):
    got_m, got_n = em.numpy(), en.numpy()
    np.testing.assert_array_equal(got_m[:, cols], want_m)
    np.testing.assert_array_equal(got_n[:, cols], want_n)
    rest = np.setdiff1d(np.arange(em.shape[1]), cols)
    np.testing.assert_array_equal(got_m[:, rest], fill_m[:, rest])
    np.testing.assert_array_equal(got_n[:, rest], fill_n[:, rest])


CASES = [(w, b, v) for w in WIDTHS for b in BATCHES for v in VIEWS
         if b in (0, 33) or v in ("rows", "narrowed")]


@pytest.mark.parametrize("width,b,view", CASES)
def test_byte_lits_plain_equals_reference(width, b, view, monkeypatch):
    subj = Subject(b, width, view, seed=width * 1000 + b * 10 + len(view))
    texts = _texts(subj)
    want_m, want_n = _ref_pairs(texts, subj, monkeypatch, dfa=False)
    cols, em, en = _prefilled(subj, len(texts))
    fill_m, fill_n = em.numpy().copy(), en.numpy().copy()
    s = subj.port()
    view_of = lambda e, ctx, lean=False: (lambda batch: s)  # noqa: E731
    monkeypatch.setattr(pt_te, "_compile_bytes", view_of)
    ctx = types.SimpleNamespace(
        layout=types.SimpleNamespace(max_str_len=subj.max_len))
    group = pt_te.compile_byte_lits(parse("s"),
                                    [parse(t).fn for t in texts], cols, ctx)
    kernels.launches.reset()
    group.write(group.view(None), em, en)
    assert kernels.launches["byte_pred"] == 0     # the CPU runs the plain
    _check_planes(em, en, fill_m, fill_n, cols, want_m, want_n)
    # the plain version by itself, from the same pre-filled planes
    em2, en2 = torch.from_numpy(fill_m.copy()), torch.from_numpy(fill_n.copy())
    pats, plens, kind = group.table.on(torch.device("cpu"))
    mode, c = group.lits.on(torch.device("cpu"))
    bytes_ops.byte_lits_plain(s.data, s.lens, s.ok, s.err, pats, plens, kind,
                              mode, c, subj.max_len, em2, en2)
    _check_planes(em2, en2, fill_m, fill_n, cols, want_m, want_n)


@pytest.mark.parametrize("width,b,view", CASES)
def test_dfa_lits_plain_equals_reference(width, b, view, monkeypatch):
    subj = Subject(b, width, view, seed=width * 1000 + b * 10 + len(view))
    want_m, want_n = _ref_pairs(REGEXES, subj, monkeypatch, dfa=True)
    cols, em, en = _prefilled(subj, len(REGEXES))
    fill_m, fill_n = em.numpy().copy(), en.numpy().copy()
    s = subj.port()
    monkeypatch.setattr(pt_te, "_compile_bytes",
                        lambda e, ctx, lean=False: (lambda batch: s))
    ctx = types.SimpleNamespace(
        layout=types.SimpleNamespace(max_str_len=subj.max_len))
    group = pt_te.compile_dfa_lits(
        parse("s"), list(REGEXES),
        [regex_dfa.compile_regex(p) for p in REGEXES], cols, ctx)
    assert list(group.lits.mode) == [
        bytes_ops.TRUNC_ALL if "$" in p else bytes_ops.TRUNC_MISS
        for p in REGEXES]
    group.write(group.view(None), em, en)
    _check_planes(em, en, fill_m, fill_n, cols, want_m, want_n)
    em2, en2 = torch.from_numpy(fill_m.copy()), torch.from_numpy(fill_n.copy())
    bytes_ops.dfa_lits_plain(s.data, s.lens, s.ok, s.err,
                             *group.table.on(torch.device("cpu")),
                             *group.lits.on(torch.device("cpu")),
                             subj.max_len, em2, en2)
    _check_planes(em2, en2, fill_m, fill_n, cols, want_m, want_n)


def test_lits_wrappers_refuse_bad_planes_and_mixed_devices():
    subj = Subject(4, 8, "rows", seed=3)
    s = subj.port()
    pats = bytes_ops.BytePatterns.of([(bytes_ops.PREFIX, b"a")])
    lits = bytes_ops.LitColumns.of([bytes_ops.TRUNC_SAFE], [2])
    ok = torch.zeros((4, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="column"):
        bytes_ops.byte_lits(s.data, s.lens, s.ok, s.err, pats, lits, 8,
                            ok[:, :2], ok[:, :2])
    with pytest.raises(ValueError, match="stride"):
        bytes_ops.byte_lits(s.data, s.lens, s.ok, s.err, pats, lits, 8,
                            ok, ok.T.contiguous().T)
    with pytest.raises(ValueError, match="columns"):
        bytes_ops.byte_lits(s.data, s.lens, s.ok, s.err, pats,
                            bytes_ops.LitColumns.of([0, 0], [0, 1]), 8, ok,
                            ok.clone())
    meta = torch.empty((4, 3), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="mixed"):
        bytes_ops.byte_lits(s.data, s.lens, s.ok, s.err, pats, lits, 8,
                            meta, meta)
    bank = bytes_ops.DfaBank.of(regex_dfa.pack_dfas_classes(
        [regex_dfa.compile_regex("a")]))
    with pytest.raises(ValueError, match="mixed"):
        bytes_ops.dfa_lits(s.data, s.lens, None, None, bank, lits, 8, meta,
                           meta)


def test_lits_are_entry_points_of_the_plane_sources():
    assert kernels.ENTRY_POINTS["byte_pred"] == ("byte_pred", "byte_lits")
    assert kernels.ENTRY_POINTS["dfa_scan"] == ("dfa_scan", "dfa_lits")
    assert {"byte_lits", "dfa_lits"} <= set(kernels.launches.entries)
    assert "byte_lits" not in kernels.KERNELS


def test_row_words_cover_what_the_patterns_read():
    """Every word of the row where a suffix or exact pattern fits it;
    else the words below the longest prefix that fits."""
    P, S, E = bytes_ops.PREFIX, bytes_ops.SUFFIX, bytes_ops.EXACT
    of = bytes_ops.BytePatterns.of
    assert of([(P, b"ab"), (S, b"b")]).row_words(13) == 4
    assert of([(P, b"ab"), (E, b"abc")]).row_words(128) == 32
    assert of([(P, b"abcde"), (P, b"a")]).row_words(128) == 2
    assert of([(P, b"a" * 20), (P, b"abc")]).row_words(8) == 1
    assert of([(P, b""), (S, b"a" * 9)]).row_words(8) == 0
    assert of([]).row_words(8) == 0


def _byte_plan_ok(b, l, p, need=None, staged=None):
    """byte_plan's launch for B rows of L bytes and P patterns: every
    row in a block's reach, a warp multiple of threads split into groups
    of a power of two lanes, the staged kernel wherever a row and a
    pattern fit its shared memory, and its blocks within it."""
    g, threads, chunk, grid, st = bytes_ops.byte_plan(
        b, l, p, None, need=need, staged=staged)
    need = -(-l // 4) if need is None else need
    rows = threads // g
    assert g in (1, 2, 4, 8, 16, 32) and threads % 32 == 0
    assert 32 <= threads <= 512 and threads % g == 0
    assert 1 <= chunk <= max(p, 1)
    fits = bytes_ops.byte_smem(need, 1, 1) <= bytes_ops._BYTE_SMEM
    assert st == (fits if staged is None else staged)
    if st:
        assert bytes_ops.byte_smem(need, rows, chunk) <= bytes_ops._BYTE_SMEM
    else:
        assert chunk == 1
    assert 1 <= grid <= -(-b // rows)
    return g, rows, chunk, st


def test_plans_cover_the_rows():
    """The launch plans the wrappers pass (their grids need an SM count,
    faked here): every row in a block's reach, shared memory within a
    block's."""
    real = bytes_ops._sm_count
    bytes_ops._sm_count = lambda device: 132
    try:
        for b, l, p in ((1, 8, 1), (2048, 128, 26), (2047, 13, 400),
                        (64, 32, 3000)):
            for staged in (None, True, False):
                g, rows, _, _ = _byte_plan_ok(b, l, p, staged=staged)
                assert g == min(32, 1 << max(p - 1, 0).bit_length())
                assert rows == 256 // g
        for b, l, n in ((2048, 128, 2), (2048, 32, 400), (7, 61440, 3),
                        (1, 8, 1)):
            threads, rows, grid = bytes_ops.dfa_plan(b, l, n, None)
            assert 128 <= threads <= 256 and threads % 32 == 0
            assert grid * rows >= b and (grid - 1) * rows < b
            assert 256 + rows * bytes_ops.dfa_class_stride(l) <= \
                bytes_ops._DFA_SMEM
        # the headline's 2 x 2,048 walks reach every SM
        assert bytes_ops.dfa_plan(2048, 128, 2, None)[2] >= 128
    finally:
        bytes_ops._sm_count = real


@pytest.mark.parametrize("p", [1, 2, 32, 400])
def test_byte_plan_fits_long_rows(p, monkeypatch):
    """Long rows at any pattern count: the staged kernel holds fewer rows
    a block (lanes widened to keep a warp) while a row and a pattern fit
    its shared memory, with every word read or only a short prefix's;
    longer rows take the direct kernel, which needs none."""
    monkeypatch.setattr(bytes_ops, "_sm_count", lambda device: 132)
    for l in (128, 256, 896, 897, 1024, 1790, 1791, 2048, 4096, 16384,
              47_000, 65536, 100_000):
        for need in (None, 2):
            _byte_plan_ok(2048, l, p, need)
            _byte_plan_ok(2048, l, p, need, staged=False)
    # 256 single-pattern rows of 1,024 bytes would take 263 KB
    assert _byte_plan_ok(2048, 1024, 1)[1:4:2] == (64, True)
    assert _byte_plan_ok(2048, 16384, p)[1:4:2] == (4, True)
    assert not _byte_plan_ok(2048, 65536, p)[3]
    with pytest.raises(ValueError, match="does not fit"):
        bytes_ops.byte_plan(1, 65536, p, None, staged=True)


# ---------------------------------------------------------------------------
# a ruleset whose ext planes hold two byte groups, a DFA group and
# atom_eval atoms
# ---------------------------------------------------------------------------

MANIFEST = {"s": RefV.STRING, "t": RefV.STRING}
RULES = [
    ("r0", 's.startsWith("ab")'),
    ("r1", 's.endsWith("ba") || t.startsWith("a")'),
    ("r2", 'match(t, "*ab") && "^a+b".matches(s)'),
    ("r3", '"b$".matches(s) || s.startsWith(t)'),
    ("r4", 'match(s, "abab") || t.endsWith(s)'),
    ("r5", '"(ab)+".matches(s) && t.endsWith("b")'),
    ("r6", 's == "ab" || match(t, "a*")'),
    ("r7", 'match(s, "abababab") && match(t, "*bbb")'),
]


def _dicts(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        d = {}
        for k in ("s", "t"):
            if rng.random() < 0.85:
                d[k] = "".join(rng.choice(list("ab"),
                                          int(rng.integers(0, 12))))
        out.append(d)
    return out


def _ref_ext_planes(rs, batch):
    """The reference ruleset's ext literal columns: its own run, with
    literal and conjunction index rows that copy the literal plane
    through."""
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


@pytest.mark.parametrize("b", [1, 33, 96])
def test_ruleset_lit_groups_equal_reference(b, monkeypatch):
    rules = [pt_rs.Rule(n, t, "") for n, t in RULES]
    ref = ref_rs.compile_ruleset([ref_rs.Rule(n, t, "") for n, t in RULES],
                                 RefFinder(MANIFEST), jit=False,
                                 max_str_len=8)
    got = pt_rs.compile_ruleset(
        rules, AttributeDescriptorFinder(manifest_from_reference(MANIFEST)),
        max_str_len=8, device="cpu")
    geo = got.geometry
    assert (geo["n_byte_groups"], geo["n_dfa_groups"]) == (2, 1)
    assert geo["n_prog_atoms"] >= 2 and not any(got.host_fallback)
    dicts = _dicts(b, seed=b)
    rb = ref_layout.Tensorizer(ref.layout, ref.interner).tensorize(
        [RefDictBag(d) for d in dicts])
    pb = pt_layout.Tensorizer(got.layout, got.interner).tensorize(
        [DictBag(d) for d in dicts])
    want = _ref_ext_planes(ref, rb)
    seen = {}
    real = pt_rs.rule_match

    def spy(ids, present, em, en, params, c, *planes):
        seen["planes"] = (em.clone(), en.clone())
        return real(ids, present, em, en, params, c, *planes)
    monkeypatch.setattr(pt_rs, "rule_match", spy)
    out = got(pb)
    em, en = seen["planes"]
    np.testing.assert_array_equal(em.numpy(), want[0])
    np.testing.assert_array_equal(en.numpy(), want[1])
    for g_, w_ in zip(out, ref(rb)):
        np.testing.assert_array_equal(g_.numpy(), np.asarray(w_))
