"""The port's byte predicates and DFA scan against the JAX package's.

The dfa_scan plain version must equal all three JAX formulations of the
multi-pattern DFA (flat gather, dense one-hot, block-diagonal one-hot)
and the host automaton; the byte_pred plain version must equal
prefix_match / suffix_match / exact_match / glob_match edge for edge.
On the CPU the wrappers run exactly these plain versions."""
import numpy as np
import pytest
import torch

from istio_tpu.ops import bytes_ops as ref_ops
from istio_tpu.ops import regex_dfa as ref_dfa

from istio_tpu_torch.ops import bytes_ops
from istio_tpu_torch.ops import regex_dfa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# the patterns and subjects of tests/test_dfa_kernels.py, plus the
# headline world's request.path regexes
PATS = ([f"^/api/v{k}/" for k in range(6)] +
        [r"items/[0-9]+", r"^/x$", r"a+b*c", r"(foo|bar)baz",
         r"/(products|reviews)/[0-9]+/v1", r"/(products|reviews)/[0-9]+/v3"])
SUBJECTS = [b"/api/v3/items/77", b"/x", b"/xx", b"", b"aac", b"abc",
            b"ac", b"/items/123", b"zzz", b"/api/v9/x", b"foobaz",
            b"xbarbazy", b"/reviews/12/v1", b"/products/9/v3/more"]


def _planes(subjects, width):
    data = np.zeros((len(subjects), width), np.uint8)
    lens = np.zeros(len(subjects), np.int32)
    for i, s in enumerate(subjects):
        s = s[:width]
        data[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return data, lens


def _random_subjects(n, seed):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"/apiv0123456789xitemsfobarzc", np.uint8)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 40))
        out.append(bytes(rng.choice(alphabet, size=k)))
    return out


@pytest.mark.parametrize("width", [32, 8])
def test_dfa_scan_matches_all_reference_formulations(width):
    subjects = SUBJECTS + _random_subjects(200, seed=width)
    data, lens = _planes(subjects, width)
    ref_dfas = [ref_dfa.compile_regex(p) for p in PATS]
    dfas = [regex_dfa.compile_regex(p) for p in PATS]
    for a, b in zip(ref_dfas, dfas):
        np.testing.assert_array_equal(a.transitions, b.transitions)
        np.testing.assert_array_equal(a.accept, b.accept)

    trans, accept = ref_dfa.pack_dfas(ref_dfas)
    ref_classes = ref_dfa.pack_dfas_classes(ref_dfas)
    want = [
        np.asarray(ref_ops.dfa_match_many(data, lens, trans, accept)),
        np.asarray(ref_ops.dfa_match_many_onehot(
            data, lens, ref_dfa.pack_dfas_onehot(ref_dfas, ref_classes))),
        np.asarray(ref_ops.dfa_match_many_onehot_blocked(
            data, lens, ref_dfa.pack_dfas_onehot_blocked(ref_dfas,
                                                         ref_classes))),
    ]
    host = np.asarray([[ref_dfa.dfa_matches_host(d, s[:width])
                        for d in ref_dfas] for s in subjects])
    bank = bytes_ops.DfaBank.of(regex_dfa.pack_dfas_classes(dfas))
    got = bytes_ops.dfa_scan(torch.from_numpy(data),
                             torch.from_numpy(lens), bank).numpy()
    assert got.dtype == np.bool_ and got.shape == (len(subjects), len(PATS))
    for w in want:
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(got, host)


def test_dfa_scan_stops_at_each_rows_length():
    """Bytes past a row's length never move its automaton, even when
    they are not zero padding."""
    dfas = [regex_dfa.compile_regex(r"^ab$")]
    bank = bytes_ops.DfaBank.of(regex_dfa.pack_dfas_classes(dfas))
    data = torch.tensor([list(b"abzz"), list(b"abzz")], dtype=torch.uint8)
    lens = torch.tensor([2, 4], dtype=torch.int32)
    assert bytes_ops.dfa_scan(data, lens, bank)[:, 0].tolist() == [True,
                                                                   False]


def test_pack_dfas_tiered_geometry_matches_reference():
    pats = ["/(products|reviews)/[0-9]+/v0", "/(products|reviews)/[0-9]+/v2"]
    ref = ref_dfa.pack_dfas_tiered([ref_dfa.compile_regex(p) for p in pats])
    got = regex_dfa.pack_dfas_tiered([regex_dfa.compile_regex(p)
                                      for p in pats])
    for k in ("gt", "class_of", "rep", "starts", "accept"):
        np.testing.assert_array_equal(got["classes"][k], ref["classes"][k])
    assert (got["packed"] is None) == (ref["packed"] is None)
    assert (got["packed_blk"] is None) == (ref["packed_blk"] is None)


BYTE_SUBJECTS = [b"", b"a", b"ab", b"abc", b"xabc", b"abcabc",
                 b"svc1.ns3.cluster.local", b"/api/v1/x", b"*", b"a*b",
                 b"\x00a", b"x" * 16]
BYTE_PATTERNS = [b"", b"a", b"abc", b"bc", b"x" * 16, b"x" * 17,
                 b".ns3.cluster.local", b"/api/v1/", b"*", b"a*b",
                 b"\x00a"]
GLOBS = ["*", "a*", "*c", "abc", "", "*.ns3.cluster.local", "/api/*",
         "a*b", "**", "x" * 17 + "*", "*" + "x" * 17]


@pytest.mark.parametrize("width", [16, 4])
@pytest.mark.parametrize("kind", ["prefix", "suffix", "exact"])
def test_byte_pred_matches_reference(kind, width):
    data, lens = _planes(BYTE_SUBJECTS, width)
    ref_fn = {"prefix": ref_ops.prefix_match, "suffix": ref_ops.suffix_match,
              "exact": ref_ops.exact_match}[kind]
    code = {"prefix": bytes_ops.PREFIX, "suffix": bytes_ops.SUFFIX,
            "exact": bytes_ops.EXACT}[kind]
    want = np.stack([np.asarray(ref_fn(data, lens, p))
                     for p in BYTE_PATTERNS], axis=1)
    pats = bytes_ops.BytePatterns.of([(code, p) for p in BYTE_PATTERNS])
    got = bytes_ops.byte_pred(torch.from_numpy(data),
                              torch.from_numpy(lens), pats).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", [24, 4])
def test_glob_groups_match_reference(width):
    """Globs of mixed kinds answered by ONE byte_pred launch: trailing
    '*' = prefix, leading '*' = suffix, "*" matches everything, else
    exact."""
    data, lens = _planes(BYTE_SUBJECTS, width)
    want = np.stack([np.asarray(ref_ops.glob_match(data, lens, g))
                     for g in GLOBS], axis=1)
    pats = bytes_ops.BytePatterns.of([bytes_ops.glob_kind(g) for g in GLOBS])
    got = bytes_ops.byte_pred(torch.from_numpy(data),
                              torch.from_numpy(lens), pats).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, GLOBS.index("*")].all()


def test_byte_pred_reads_strided_rows():
    """A column of a [B, S, L] str_bytes plane (row stride S·L) and a
    broadcast constant row (row stride 0) give the same answers as
    contiguous copies."""
    planes = torch.zeros((3, 2, 8), dtype=torch.uint8)
    planes[0, 1, :3] = torch.tensor(list(b"abc"))
    planes[2, 1, :2] = torch.tensor(list(b"ab"))
    lens = torch.tensor([[0, 3], [0, 0], [0, 2]], dtype=torch.int32)
    pats = bytes_ops.BytePatterns.of([(bytes_ops.PREFIX, b"ab"),
                                      (bytes_ops.SUFFIX, b"bc")])
    view = bytes_ops.byte_pred(planes[:, 1, :], lens[:, 1], pats)
    copy = bytes_ops.byte_pred(planes[:, 1, :].contiguous(),
                               lens[:, 1].contiguous(), pats)
    assert view.tolist() == copy.tolist() == [[True, True], [False, False],
                                              [True, False]]
    row = torch.tensor(list(b"abc") + [0] * 5, dtype=torch.uint8)
    bcast = bytes_ops.byte_pred(row[None].expand(3, 8),
                                torch.full((3,), 3, dtype=torch.int32), pats)
    assert bcast.tolist() == [[True, True]] * 3


def test_wrappers_refuse_other_devices():
    data = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    lens = torch.zeros(2, dtype=torch.int32, device="meta")
    pats = bytes_ops.BytePatterns.of([(bytes_ops.PREFIX, b"a")])
    with pytest.raises(ValueError):
        bytes_ops._kernel_or_plain(data, lens)
    with pytest.raises(ValueError):
        bytes_ops.byte_pred(data, torch.zeros(2, dtype=torch.int32), pats)


def _pair_planes(seed, width=12, n=300):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ab*\x00", np.uint8)

    def plane():
        data = np.zeros((n, width), np.uint8)
        lens = rng.integers(0, width + 1, size=n).astype(np.int32)
        for i in range(n):
            data[i, :lens[i]] = rng.choice(alphabet, size=lens[i])
        return data, lens
    return plane() + plane()


@pytest.mark.parametrize("fn", ["dyn_prefix_match", "dyn_suffix_match",
                                "dyn_exact_match", "dyn_glob_match",
                                "lex_cmp"])
def test_runtime_pattern_predicates_match_reference(fn):
    sd, sl, pd, pl = _pair_planes(seed=len(fn))
    want = np.asarray(getattr(ref_ops, fn)(sd, sl, pd, pl))
    got = getattr(bytes_ops, fn)(*(torch.from_numpy(a) for a in
                                   (sd, sl, pd, pl))).numpy()
    np.testing.assert_array_equal(got, want)


def test_bit_lanes_round_trip_like_reference():
    rng = np.random.default_rng(3)
    a = rng.random((7, 45)) < 0.3
    packed = bytes_ops.pack_bits(a)
    np.testing.assert_array_equal(packed, ref_ops.pack_bits(a))
    got = bytes_ops.unpack_bits(torch.from_numpy(packed.view(np.int32)), 45)
    np.testing.assert_array_equal(got.numpy(), a)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.unpack_bits(packed, 45)))
