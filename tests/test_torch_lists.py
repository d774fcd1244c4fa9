"""The port's list banks against the JAX package's: REGEX lists (a DFA
bank per value byte slot, the truncation contract) and IP_ADDRESSES
lists (CIDR prefix compares in v6-mapped space, version-strict) fuse
where the reference fuses them, and RuntimeServer.check_many answers
with equal responses in every field, a byte-identical packed pull and
equal drained rule counts — on tests/test_fused_serving.py's store
(STRINGS, REGEX, CIDR, case-insensitive and fallback-expression lists,
deniers, a host-fallback predicate) with bags that hit the regex
prefix, a truncated path, IPv4, IPv6, v4-mapped IPv6, a malformed IP
length and an absent source.ip, and on the edge and IP-typed stores of
test_fused_list_edge_values_match_generic /
test_ip_typed_values_keep_host_semantics with the same unfused-kind
reasons. The list_banks kernels' plain versions equal the reference
step's membership on edge inputs, and the PolicyEngine's list fold
equals the reference's through interop. The port runs on the CPU
(plain versions of every kernel)."""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.compiler.ruleset import Rule as RefRule
from istio_tpu.models import policy_engine as ref_pe
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.compiler.ruleset import Rule
from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.ops import bytes_ops
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


FIELDS = ("status_code", "status_message", "valid_duration_s",
          "valid_use_count", "referenced", "referenced_presence",
          "deny_rule", "active_quota_rules")
REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)
V4M = b"\x00" * 10 + b"\xff\xff"


def _fused_serving_module():
    path = pathlib.Path(__file__).with_name("test_fused_serving.py")
    spec = importlib.util.spec_from_file_location("_fused_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def list_world_dicts():
    """test_fused_serving.py's bags plus the list edge values: regex
    prefix hits and misses, a truncated path either way, IPv4, IPv6,
    v4-mapped IPv6 in and out of the nets, malformed IP lengths, an
    absent source.ip and one beside a blacklisted path."""
    dicts = [dict(b._values) for b in _fused_serving_module()._bags()]
    https, http = {"request.scheme": "https"}, {"request.scheme": "http"}
    dicts += [
        dict(http, **{"request.path": "/api/"}),
        dict(http, **{"request.path": "/ap"}),
        dict(http, **{"request.path": "/api/" + "y" * 123}),   # len 128
        dict(http, **{"request.path": "x/api/" + "y" * 300}),
        dict(http),                                            # path absent
        dict(https, **{"source.ip": bytes([10, 255, 255, 255])}),
        dict(https, **{"source.ip": bytes([9, 255, 255, 255])}),
        dict(https, **{"source.ip": bytes.fromhex("20010db8ffff")
                       + b"\x00" * 10}),
        dict(https, **{"source.ip": bytes.fromhex("20010db9")
                       + b"\x00" * 12}),
        dict(https, **{"source.ip": V4M + bytes([10, 9, 8, 7])}),
        dict(https, **{"source.ip": V4M[:-1] + b"\x00"
                       + bytes([10, 9, 8, 7])}),
        dict(https, **{"source.ip": b"\x0a\x00\x00"}),
        dict(https, **{"source.ip": b"\x0a" * 5}),
        dict(https, **{"source.ip": b""}),
        dict(https),                                           # ip absent
        dict(https, **{"request.path": "/admin/x"}),
    ]
    return dicts


def _edge_store():
    """test_fused_list_edge_values_match_generic's store."""
    from istio_tpu.runtime import MemStore
    s = MemStore()
    s.set(("handler", "istio-system", "rx"), {
        "adapter": "list",
        "params": {"overrides": ["^/blocked/"], "entry_type": "REGEX",
                   "blacklist": True}})
    s.set(("handler", "istio-system", "cidr"), {
        "adapter": "list",
        "params": {"overrides": ["10.0.0.0/8"],
                   "entry_type": "IP_ADDRESSES", "blacklist": False}})
    s.set(("instance", "istio-system", "path"), {
        "template": "listentry", "params": {"value": "request.path"}})
    s.set(("instance", "istio-system", "ip"), {
        "template": "listentry", "params": {"value": "source.ip"}})
    s.set(("rule", "istio-system", "r0"), {
        "match": 'request.scheme == "http"',
        "actions": [{"handler": "rx", "instances": ["path"]}]})
    s.set(("rule", "istio-system", "r1"), {
        "match": 'request.scheme == "https"',
        "actions": [{"handler": "cidr", "instances": ["ip"]}]})
    return s


def _edge_dicts():
    return [{"request.scheme": "http"},
            {"request.scheme": "http", "request.path": ""},
            {"request.scheme": "https"},
            {"request.scheme": "https", "source.ip": b"\x01\x02\x03"},
            {"request.scheme": "https", "source.ip": bytes([10, 0, 0, 1])},
            {"request.scheme": "http", "request.path": "/blocked/x"},
            {"request.scheme": "http",
             "request.path": "/blocked/" + "z" * 200},
            {"request.scheme": "http", "request.path": "/open/" + "z" * 200}]


def _ip_typed_store():
    """test_ip_typed_values_keep_host_semantics's store."""
    from istio_tpu.runtime import MemStore
    s = MemStore()
    s.set(("handler", "istio-system", "strlist"), {
        "adapter": "list",
        "params": {"overrides": ["10.0.0.1"], "blacklist": False}})
    s.set(("handler", "istio-system", "iptext"), {
        "adapter": "list",
        "params": {"overrides": ["10.0.0.0/8"],
                   "entry_type": "IP_ADDRESSES", "blacklist": False}})
    s.set(("instance", "istio-system", "ipinst"), {
        "template": "listentry", "params": {"value": "source.ip"}})
    s.set(("instance", "istio-system", "hdrip"), {
        "template": "listentry",
        "params": {"value": 'request.headers["x-ip"]'}})
    s.set(("rule", "istio-system", "r0"), {
        "match": 'request.scheme == "http"',
        "actions": [{"handler": "strlist", "instances": ["ipinst"]}]})
    s.set(("rule", "istio-system", "r1"), {
        "match": 'request.scheme == "https"',
        "actions": [{"handler": "iptext", "instances": ["hdrip"]}]})
    return s


def _ip_typed_dicts():
    return [{"request.scheme": "http", "source.ip": bytes([10, 0, 0, 1])},
            {"request.scheme": "http", "source.ip": bytes([10, 9, 9, 9])},
            {"request.scheme": "https",
             "request.headers": {"x-ip": "10.1.2.3"}},
            {"request.scheme": "https",
             "request.headers": {"x-ip": "11.1.2.3"}}]


WORLDS = {
    "list_world": (lambda: _fused_serving_module()._store(),
                   list_world_dicts),
    "edge": (_edge_store, _edge_dicts),
    "ip_typed": (_ip_typed_store, _ip_typed_dicts),
}


@pytest.fixture(scope="module")
def servers():
    made: dict = {}

    def get(name):
        if name not in made:
            ref_store = WORLDS[name][0]()
            pt_store = interop.store_from_reference(ref_store)
            ref = RefServer(ref_store, RefArgs(**REF_ARGS))
            got = RuntimeServer(pt_store, ServerArgs(initial_prewarm=False,
                                                     rulestats_drain_s=0),
                                device="cpu")
            made[name] = (ref, got, ref_store, pt_store)
        return made[name][:2]
    yield get
    for ref, got, rs, ps in made.values():
        got.close()
        ref.close()
        ps.close()
        rs.close()


def _assert_responses_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        for f in FIELDS:
            assert getattr(b, f) == getattr(a, f), (i, f)


def _repeat(dicts, b):
    return (dicts * (b // len(dicts) + 1))[:b]


@pytest.mark.parametrize("name", list(WORLDS))
def test_plan_matches_reference(servers, name):
    ref, got = servers(name)
    want, have = ref.controller.dispatcher.fused, \
        got.controller.dispatcher.fused
    assert (have.fused_deny, have.fused_lists) == \
        (want.fused_deny, want.fused_lists)
    assert have.list_rules == want.list_rules
    assert have.host_actions.keys() == want.host_actions.keys()
    assert have.unfused_list_kinds == want.unfused_list_kinds
    assert have.fused_first_rules == want.fused_first_rules
    np.testing.assert_array_equal(have.overlay_cols, want.overlay_cols)
    assert have.str_tiers == want.str_tiers
    if name == "list_world":
        assert have.fused_lists == 4
        assert "CASE_INSENSITIVE_STRINGS" in have.unfused_list_kinds
    if name == "edge":
        assert have.fused_lists == 2
    if name == "ip_typed":
        assert have.fused_lists == 0
        assert {"STRINGS:value-not-lowerable",
                "IP_ADDRESSES:value-not-lowerable"} <= \
            set(have.unfused_list_kinds)


@pytest.mark.parametrize("name", list(WORLDS))
@pytest.mark.parametrize("b", [1, 7, 64])
def test_check_many_matches_reference(servers, name, b):
    ref, got = servers(name)
    dicts = _repeat(WORLDS[name][1](), b)
    _assert_responses_equal(ref.check_many([ref_bag(d) for d in dicts]),
                            got.check_many([bag_from_mapping(d)
                                            for d in dicts]))


def test_list_world_statuses(servers):
    """The verdicts the list edge bags must reach (test_fused_serving's
    cases keep theirs): every list branch of the fold is exercised."""
    ref, got = servers("list_world")
    dicts = list_world_dicts()
    have = got.check_many([bag_from_mapping(d) for d in dicts])
    # served on both, so the shared servers' rule counts stay comparable
    _assert_responses_equal(ref.check_many([ref_bag(d) for d in dicts]),
                            have)
    codes = [r.status_code for r in have]
    n = len(_fused_serving_module()._bags())
    assert codes[9] == 7 and codes[10] == 0          # regex hit / miss
    assert codes[17:21] == [7, 7, 7, 0]              # CIDR v4m / v4 / v6
    assert codes[n - 2] == 7 and codes[n - 1] == 0   # truncated paths
    assert codes[n:n + 5] == [7, 0, 7, 0, 13]
    assert codes[n + 5:] == [7, 0, 7, 0, 7, 0, 13, 13, 13, 13, 7]
    assert have[n + 10].valid_duration_s == 5.0      # INTERNAL defaults
    assert have[n + 10].valid_use_count == 10_000


@pytest.mark.parametrize("name", ["list_world", "edge"])
@pytest.mark.parametrize("long_path", [False, True])
def test_packed_pull_is_byte_identical(servers, name, long_path):
    ref, got = servers(name)
    rd, pd = ref.controller.dispatcher, got.controller.dispatcher
    dicts = [d for d in WORLDS[name][1]()
             if long_path or len(d.get("request.path", "")) <= 32]
    rbags = [ref_bag(d) for d in dicts]
    pbags = [bag_from_mapping(d) for d in dicts]
    ns = rd._request_ns_ids(rbags)
    rb = rd.snapshot.tensorizer.tensorize(rbags)
    pb = pd.snapshot.tensorizer.tensorize(pbags)
    tiers = pd.fused.str_tiers
    assert pd.fused._serve_width(pb) == (tiers[-1] if long_path
                                         else tiers[0])
    a = rd.fused.packed_check(rb, ns, observe=False)
    h = pd.fused.packed_check(pb, ns, observe=False)
    assert h.tobytes() == a.tobytes()
    assert int(h[4, 0]) == int(a[4, 0])
    if long_path:
        assert int(a[4, 0]) > 0      # the undecidable regex rows err


@pytest.mark.parametrize("name", ["list_world", "edge"])
def test_rule_counts_match_reference(servers, name):
    ref, got = servers(name)
    ref.rulestats.drain()
    got.rulestats.drain()
    dicts = WORLDS[name][1]()
    for _ in range(2):
        ref.check_many([ref_bag(d) for d in dicts])
        got.check_many([bag_from_mapping(d) for d in dicts])
    ref.rulestats.drain()
    got.rulestats.drain()
    counts = got.rulestats.counts()
    assert counts == ref.rulestats.counts()
    assert sum(v["errors"] for v in counts.values()) > 0


def test_generic_path_matches_reference():
    """fused=False: the port's host list adapter answers the REGEX and
    CIDR lists as the reference's."""
    ref_store = _fused_serving_module()._store()
    pt_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(fused=False, **REF_ARGS))
    got = RuntimeServer(pt_store, ServerArgs(fused=False,
                                             initial_prewarm=False),
                        device="cpu")
    try:
        dicts = list_world_dicts()
        _assert_responses_equal(ref.check_many([ref_bag(d) for d in dicts]),
                                got.check_many([bag_from_mapping(d)
                                                for d in dicts]))
    finally:
        got.close()
        ref.close()
        pt_store.close()
        ref_store.close()


# ---- the list_banks kernels' plain versions against the reference step

LISTS = [
    {"rule": 0, "value_attr": "request.path",
     "entries": ["^/api/", "x$", "^/v[0-9]+/"], "blacklist": True,
     "entry_type": "REGEX"},
    {"rule": 1, "value_attr": "request.path", "entries": ["^/pub/", "x$"],
     "entry_type": "REGEX"},
    {"rule": 1, "value_attr": "request.user", "entries": ["^adm"],
     "blacklist": True, "entry_type": "REGEX"},
    {"rule": 2, "value_attr": "aip",
     "entries": ["10.0.0.0/8", "2001:db8::/32", "192.168.1.7/32"],
     "entry_type": "IP_ADDRESSES"},
    {"rule": 3, "value_attr": "target.ip", "entries": ["::/0"],
     "blacklist": True, "entry_type": "IP_ADDRESSES"},
    {"rule": 1, "value_attr": "request.user", "entries": ["bob", "eve"],
     "blacklist": True},
]
RULES = [("a", ""), ("b", 'request.size > 3'), ("c", ""), ("d", ""),
         ("e", "request.size == 5")]


def _list_dicts(n, seed):
    rng = np.random.default_rng(seed)
    paths = ["/api/x", "/pub/a", "/v12/q", "/priv", "x", "/pub/" + "p" * 200,
             "/api/" + "q" * 130, "/priv/" + "x" * 300, ""]
    ips = [bytes([10, 1, 2, 3]), bytes([11, 1, 2, 3]),
           bytes([192, 168, 1, 7]), V4M + bytes([10, 0, 0, 1]),
           bytes.fromhex("20010db8") + b"\x00" * 12,
           bytes.fromhex("fe80") + b"\x00" * 14, b"\x01\x02", b""]
    out = []
    for _ in range(n):
        d = {}
        if rng.random() < 0.9:
            d["request.path"] = str(rng.choice(paths))
        if rng.random() < 0.8:
            d["request.user"] = str(rng.choice(["admin", "bob", "al"]))
        if rng.random() < 0.9:
            d["aip"] = ips[int(rng.integers(len(ips)))]
        if rng.random() < 0.7:
            d["target.ip"] = ips[int(rng.integers(len(ips)))]
        d["request.size"] = int(rng.integers(0, 8))
        out.append(d)
    return out


def _engines():
    from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
    from istio_tpu.testing.corpus import CORPUS_MANIFEST
    from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
    ref_lists = [ref_pe.ListEntrySpec(**l) for l in LISTS]
    ref = ref_pe.PolicyEngine(
        [RefRule(*r) for r in RULES], RefFinder(CORPUS_MANIFEST),
        deny=[ref_pe.DenySpec(rule=4)], lists=ref_lists)
    got = pe.PolicyEngine(
        [Rule(*r) for r in RULES], AttributeDescriptorFinder(
            interop.manifest_from_reference(CORPUS_MANIFEST)),
        deny=interop.specs_from_reference([ref_pe.DenySpec(rule=4)]),
        lists=interop.specs_from_reference(ref_lists), device="cpu")
    return ref, got, ref_lists


def _reference_membership(ref, ref_lists, rb):
    """The reference step's list membership (policy_engine.py:439-502),
    computed with its own bank builders and formulas."""
    import jax.numpy as jnp
    from istio_tpu.ops import bytes_ops as ref_bytes

    member = np.zeros((rb.ids.shape[0], len(ref_lists)), bool)
    und = np.zeros_like(member)
    bad = np.zeros_like(member)
    max_len = ref.ruleset.layout.max_str_len
    for bank in ref._build_regex_banks(ref_lists):
        s_data = jnp.asarray(rb.str_bytes)[:, bank["bslot"]]
        s_lens = jnp.asarray(rb.str_lens)[:, bank["bslot"]]
        m = ref_bytes.dfa_match_many(
            s_data, s_lens, bank["trans"], bank["accept"]) \
            if bank["trans"] is not None else \
            ref_bytes.dfa_match_many_onehot(s_data, s_lens, bank["packed"])
        m8 = np.asarray(m).astype(np.int32)
        hit = m8 @ np.asarray(bank["M"], np.int32) > 0
        dec = m8 @ np.asarray(bank["M_def"], np.int32) > 0
        trunc = (np.asarray(s_lens) >= max_len)[:, None]
        pos = np.asarray(bank["pos"])
        member[:, pos] = np.where(trunc, dec, hit)
        und[:, pos] = trunc & ~dec
    cb = ref._build_cidr_bank(ref_lists)
    vb = np.asarray(rb.str_bytes)[:, np.asarray(cb["bslots"]), :16]
    vl = np.asarray(rb.str_lens)[:, np.asarray(cb["bslots"])]
    mapped = np.zeros_like(vb)
    mapped[:, :, 10:12] = 255
    mapped[:, :, 12:16] = vb[:, :, 0:4]
    is4 = vl == 4
    val_mapped = (vb[:, :, :12] == np.asarray([0] * 10 + [255, 255],
                                              np.uint8)).all(axis=2)
    v = np.where(is4[:, :, None], mapped, vb)
    val_ok = is4 | (vl == 16)
    val_v4 = is4 | ((vl == 16) & val_mapped)
    hit_e = ((v[:, :, None, :] & np.asarray(cb["mask"])[None])
             == np.asarray(cb["prefix"])[None]).all(axis=3)
    hit_e &= np.asarray(cb["valid"])[None]
    hit_e &= val_v4[:, :, None] == np.asarray(cb["ent_v4"])[None]
    pos = np.asarray(cb["pos"])
    member[:, pos] = hit_e.any(axis=2) & val_ok
    bad[:, pos] = ~val_ok
    return member, und, bad


@pytest.mark.parametrize("seed", [0, 1])
def test_list_banks_plain_match_reference_membership(seed):
    ref, got, ref_lists = _engines()
    dicts = _list_dicts(80, seed)
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in dicts])
    pb = interop.batch_from_reference(rb, device="cpu")
    member, und, bad = _reference_membership(ref, ref_lists, rb)
    b, n_lists = member.shape
    err = torch.zeros((b, got.ruleset.rule_ns.shape[0]), dtype=torch.bool)
    lstate = got.list_states(pb, err)
    byte = np.asarray([l.get("entry_type", "STRINGS") != "STRINGS"
                       for l in LISTS])
    ls = lstate.numpy()
    np.testing.assert_array_equal((ls & 1 != 0)[:, byte], member[:, byte])
    np.testing.assert_array_equal(ls & 2 != 0, und)
    np.testing.assert_array_equal(ls & 4 != 0, bad)
    assert not ls[:, ~byte].any()
    want_err = np.zeros(err.shape, bool)
    for j, l in enumerate(LISTS):
        want_err[:, l["rule"]] |= und[:, j]
    np.testing.assert_array_equal(err.numpy(), want_err)
    assert und.any() and bad.any() and member[:, byte].any()
    # the plain versions called directly, on the same inputs
    acc = torch.cat([bytes_ops.dfa_scan(pb.str_bytes[:, s], pb.str_lens[:, s],
                                        bank)
                     for s, bank in got._dfa_banks], dim=1)
    direct = torch.zeros_like(lstate)
    err2 = torch.zeros_like(err)
    bytes_ops.regex_list_plain(acc, pb.str_lens, got._max_len,
                               *got._rx_lists.on(acc.device), direct, err2)
    bytes_ops.cidr_list_plain(pb.str_bytes, pb.str_lens,
                              *got._cidr_lists.on(acc.device), direct)
    assert torch.equal(direct, lstate) and torch.equal(err2, err)


@pytest.mark.parametrize("b", [40, 300])
def test_engine_lists_through_interop(b):
    """The reference's compiled params and batch through the port's step,
    with its ListEntrySpecs carried by interop.specs_from_reference."""
    import jax
    ref, got, _ = _engines()
    np.testing.assert_array_equal(got.params["pe_list_ids"].numpy(),
                                  np.asarray(ref.params["pe_list_ids"]))
    dicts = _list_dicts(b, b)
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in dicts])
    req = np.zeros(b, np.int32)
    ref_v, _ = jax.jit(ref.raw_step)(ref.params, rb, req, ref.quota_counts)
    got_v, _ = got.step(interop.params_from_reference(ref.params, "cpu"),
                        interop.batch_from_reference(rb, "cpu"), req,
                        got.quota_counts)
    for f in ("status", "valid_duration_s", "valid_use_count", "referenced",
              "matched", "err", "deny_rule", "err_count"):
        np.testing.assert_array_equal(getattr(got_v, f).numpy(),
                                      np.asarray(getattr(ref_v, f)),
                                      err_msg=f)
    assert {pe.OK, pe.PERMISSION_DENIED, pe.NOT_FOUND, pe.INTERNAL} <= \
        set(got_v.status.tolist())
    assert int(got_v.err_count) > 0
