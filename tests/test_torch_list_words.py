"""The list_banks kernel's word formulation against the JAX package.

The kernel (csrc/list_banks.cu) runs both banks of a step in one launch:
REGEX lists as the OR of the acceptance plane over each list's CSR row
of patterns, split over a group of lanes, and IP_ADDRESSES lists from
entry tables in 32-bit words (ops/bytes_ops.CidrLists.words: each list's
valid entries, its v4 nets in one run tested on word 3 alone, its v6
nets in another tested on four words). Its plain version
(bytes_ops.list_banks_words_plain) must give the reference's list
membership, und and bad bits and err plane exactly (the reference's
banks and formulas of istio_tpu/models/policy_engine.py:439-502, as
tests/test_torch_lists.py computes them), and the port's step with it in
place of list_banks every verdict field of the JAX step: on a world of
v4 and v6 nets at /0, /8, /32, /96 and /128 (v4 values against v6 nets,
mapped and unmapped 16-byte values, lists of 1, 6 and 40 nets, so that
shorter lists carry invalid padding entries, one list of v4 nets only and
one of v6 only), values of length 0, 3, 4, 5 and 16, and a REGEX list of
40 patterns over paths truncated at the 128-byte slot. The port runs on
the CPU."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.compiler.ruleset import Rule as RefRule
from istio_tpu.models import policy_engine as ref_pe

from istio_tpu_torch import interop
from istio_tpu_torch.compiler.ruleset import Rule
from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.ops import bytes_ops

V4M = b"\x00" * 10 + b"\xff\xff"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lists_module():
    path = pathlib.Path(__file__).with_name("test_torch_lists.py")
    spec = importlib.util.spec_from_file_location("_torch_lists", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _many_nets() -> list[str]:
    rng = np.random.default_rng(4)
    nets = []
    for i in range(40):
        if i % 4:
            a = rng.integers(0, 256, 4)
            nets.append(f"{a[0]}.{a[1]}.{a[2]}.{a[3]}/"
                        f"{int(rng.integers(8, 33))}")
        else:
            a = rng.integers(0, 1 << 16, 8)
            nets.append(":".join(f"{x:x}" for x in a)
                        + f"/{int(rng.integers(16, 129))}")
    return nets + ["172.16.0.0/12"]


PATTERNS = [f"^/p{i}/" if i % 3 else f"/q{i}$" for i in range(40)]
LISTS = [
    {"rule": 0, "value_attr": "request.path", "entries": PATTERNS,
     "blacklist": True, "entry_type": "REGEX"},
    {"rule": 1, "value_attr": "aip",
     "entries": ["10.0.0.0/8", "2001:db8::/32", "192.168.1.7/32",
                 "::ffff:0:0/96", "::/128", "fe80::1/128"],
     "entry_type": "IP_ADDRESSES"},
    {"rule": 2, "value_attr": "target.ip", "entries": ["0.0.0.0/0"],
     "blacklist": True, "entry_type": "IP_ADDRESSES"},
    {"rule": 2, "value_attr": "aip", "entries": ["::/0"],
     "entry_type": "IP_ADDRESSES"},
    {"rule": 3, "value_attr": "target.ip", "entries": _many_nets(),
     "blacklist": True, "entry_type": "IP_ADDRESSES"},
    {"rule": 3, "value_attr": "request.user", "entries": ["bob", "eve"],
     "blacklist": True},
]
RULES = [("a", ""), ("b", "request.size > 3"), ("c", ""), ("d", ""),
         ("e", "request.size == 5")]


def _dicts(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    paths = [f"/p{i}/x" for i in range(1, 40, 7)] + \
        [f"/a/q{i}" for i in range(0, 40, 9)] + \
        ["/p1/" + "y" * 200, "/zz/" + "q" * 140, "/a/q3" + "/" * 130, "",
         "/none"]
    ips = [bytes([10, 1, 2, 3]), bytes([11, 1, 2, 3]),
           bytes([192, 168, 1, 7]), bytes([172, 20, 0, 1]),
           V4M + bytes([10, 0, 0, 1]), V4M + bytes([8, 8, 8, 8]),
           bytes.fromhex("20010db8") + b"\x00" * 12,
           bytes.fromhex("fe80") + b"\x00" * 13 + b"\x01",
           b"\x00" * 16, bytes.fromhex("fe81") + b"\x00" * 14,
           b"\x01\x02\x03", b"\x01\x02\x03\x04\x05", b""]
    out = []
    for _ in range(n):
        d = {"request.size": int(rng.integers(0, 8))}
        if rng.random() < 0.95:
            d["request.path"] = str(rng.choice(paths))
        if rng.random() < 0.8:
            d["request.user"] = str(rng.choice(["admin", "bob", "al"]))
        for attr, p in (("aip", 0.9), ("target.ip", 0.8)):
            if rng.random() < p:
                d[attr] = ips[int(rng.integers(len(ips)))]
        out.append(d)
    return out


@pytest.fixture(scope="module")
def engines():
    from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
    from istio_tpu.testing.corpus import CORPUS_MANIFEST
    from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
    ref_lists = [ref_pe.ListEntrySpec(**x) for x in LISTS]
    ref = ref_pe.PolicyEngine(
        [RefRule(*r) for r in RULES], RefFinder(CORPUS_MANIFEST),
        deny=[ref_pe.DenySpec(rule=4)], lists=ref_lists)
    got = pe.PolicyEngine(
        [Rule(*r) for r in RULES], AttributeDescriptorFinder(
            interop.manifest_from_reference(CORPUS_MANIFEST)),
        deny=interop.specs_from_reference([ref_pe.DenySpec(rule=4)]),
        lists=interop.specs_from_reference(ref_lists), device="cpu")
    return ref, got, ref_lists


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_word_formulation_matches_reference_membership(engines, seed):
    ref, got, ref_lists = engines
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in _dicts(120, seed)])
    pb = interop.batch_from_reference(rb, device="cpu")
    member, und, bad = _lists_module()._reference_membership(
        ref, ref_lists, rb)
    acc = torch.cat([bytes_ops.dfa_scan(pb.str_bytes[:, s], pb.str_lens[:, s],
                                        bank)
                     for s, bank in got._dfa_banks], dim=1)
    b, n_lists = member.shape
    n_rules = int(got.ruleset.rule_ns.shape[0])
    words = torch.zeros((b, n_lists), dtype=torch.uint8)
    err = torch.zeros((b, n_rules), dtype=torch.bool)
    bytes_ops.list_banks_words_plain(acc, pb.str_bytes, pb.str_lens,
                                     got._max_len, got._rx_lists,
                                     got._cidr_lists, words, err)
    byte = np.asarray([x.get("entry_type", "STRINGS") != "STRINGS"
                       for x in LISTS])
    ls = words.numpy()
    np.testing.assert_array_equal((ls & 1 != 0)[:, byte], member[:, byte])
    np.testing.assert_array_equal(ls & 2 != 0, und)
    np.testing.assert_array_equal(ls & 4 != 0, bad)
    want_err = np.zeros(err.shape, bool)
    for j, x in enumerate(LISTS):
        want_err[:, x["rule"]] |= und[:, j]
    np.testing.assert_array_equal(err.numpy(), want_err)
    # every branch ran: members and non-members of each IP list, v4 and
    # v6 values, bad lengths, truncated REGEX values decided and not
    for j in np.flatnonzero(byte):
        assert member[:, j].any() and not member[:, j].all(), j
    assert und.any() and bad.any()
    # the served plain versions agree on the same inputs
    plain = torch.zeros_like(words)
    err2 = torch.zeros_like(err)
    bytes_ops.list_banks(acc, pb.str_bytes, pb.str_lens, got._max_len,
                         got._rx_lists, got._cidr_lists, plain, err2)
    assert torch.equal(plain, words) and torch.equal(err2, err)


@pytest.mark.parametrize("b", [60, 257])
def test_step_with_word_formulation_matches_reference(engines, monkeypatch,
                                                      b):
    import jax
    ref, got, _ = engines
    monkeypatch.setattr(bytes_ops, "list_banks",
                        bytes_ops.list_banks_words_plain)
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in _dicts(b, 10 + b)])
    req = np.zeros(b, np.int32)
    ref_v, _ = jax.jit(ref.raw_step)(ref.params, rb, req, ref.quota_counts)
    got_v, _ = got.step(interop.params_from_reference(ref.params, "cpu"),
                        interop.batch_from_reference(rb, "cpu"), req,
                        got.quota_counts)
    for f in ("status", "valid_duration_s", "valid_use_count", "deny_rule",
              "err", "err_count"):
        np.testing.assert_array_equal(getattr(got_v, f).numpy(),
                                      np.asarray(getattr(ref_v, f)),
                                      err_msg=f)
    assert len(set(np.asarray(ref_v.status).tolist())) >= 3


def test_word_tables_and_lanes(monkeypatch):
    """Each list's valid entries, v4 run then v6 run; word 3 of a v4 net
    (its words 0..2 the mapped prefix); lanes a pair from the longest run
    or pattern row, a warp at most."""
    nets = [["10.0.0.0/8", "::/0", "1.2.3.4/32"], [],
            ["fe80::/10"], ["0.0.0.0/0"] * 33]
    c = bytes_ops.CidrLists.of([0, 1, 2, 3], [0, 0, 0, 0], nets)
    v4_ptr, v4, v6_ptr, v6 = c.words()
    assert v4_ptr.tolist() == [0, 2, 2, 2, 35]
    assert v6_ptr.tolist() == [0, 1, 1, 2, 2]
    assert v4[0].tolist() == [0x000000FF, 0x0000000A]
    assert v4[1].tolist() == [0xFFFFFFFF, 0x04030201]
    assert v4[2].tolist() == [0, 0]
    assert v6[0].tolist() == [0] * 8
    assert v6[1].tolist() == [0xC0FF, 0, 0, 0, 0x80FE, 0, 0, 0]
    mask = c.mask.reshape(4, -1, 16).view("<u4")
    assert (mask[c.valid & c.ent_v4][:, :3] == 0xFFFFFFFF).all()
    assert c.run_lengths() == 33
    for e, lanes in ((0, 1), (1, 1), (2, 2), (31, 32), (32, 32), (33, 32),
                     (1024, 32)):
        one = bytes_ops.CidrLists.of([0], [0], [["9.9.9.9/32"] * e])
        assert bytes_ops.list_plan(None, one) == (1, lanes), e
    rx = bytes_ops.RegexLists(
        pos=np.zeros(2, np.int32), rule=np.zeros(2, np.int32),
        bslot=np.zeros(2, np.int32), ptr=np.asarray([0, 3, 9], np.int32),
        pat=np.arange(9, dtype=np.int32), pdef=np.ones(9, np.uint8))
    assert bytes_ops.list_plan(rx, None) == (8, 1)
    # a large batch of many short lists keeps fewer lanes a pair; a
    # small batch of one long list a warp
    many = bytes_ops.CidrLists.of(list(range(64)), [0] * 64,
                                  [["9.9.9.9/32"] * 16] * 64)
    assert bytes_ops.list_plan(None, many, 2048) == (1, 4)
    assert bytes_ops.list_plan(None, many, 64) == (1, 16)
    long = bytes_ops.CidrLists.of([0], [0], [["9.9.9.9/32"] * 1024])
    assert bytes_ops.list_plan(None, long, 2048) == (1, 32)
    monkeypatch.setattr(bytes_ops, "LIST_THREADS", 64)
    assert bytes_ops.list_plan(rx, long, 2048) == (1, 1)
