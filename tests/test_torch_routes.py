"""Pilot's route selection (B12) on the port against the JAX package's, on
the CPU: the same seeded route worlds (carried across with
interop.pilot_world_from_reference) and the same requests go through
istio_tpu.pilot.route_nfa and istio_tpu_torch.pilot.route_nfa.

  * match_to_predicate strings are equal;
  * RouteTable.select equals the reference's select and select_host on
    make_route_world(200) and (1000), tests/test_pilot.py's world and
    tests/test_route_scope.py's corpora, and on a host-fallback world;
  * the compact select (_compact_planes + _select_on_device_compact)
    equals the reference's _select_on_device_compact on the same
    compacted numpy inputs, and the dense select;
  * the plain versions of the K10 kernel: route_winner_plain against
    the reference's _winner, route_densify_plain against the reference's
    re-densify formula, on random and edge inputs;
  * RouteScopeProgram.admit_rows and digest against the reference's;
  * the rule_match kernel's word formulation (rule_match_words_plain,
    the planes the selects ask for and all three) against the
    reference program's run, on every route world and on the scope
    programs' admission batches;
  * select_wire and native raise NotPorted.

Every value is an int or a bool: the tolerance is exact equality."""
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.pilot import route_nfa as ref_nfa
from istio_tpu.pilot.model import (Config as RefConfig,
                                   ConfigMeta as RefMeta, Port as RefPort,
                                   Service as RefService)
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop, kernels
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.compiler import ruleset as pt_rs
from istio_tpu_torch.device import NotPorted
from istio_tpu_torch.ops import route_ops
from istio_tpu_torch.pilot import route_nfa
from istio_tpu_torch.testing import workloads


def _load(name: str):
    path = pathlib.Path(__file__).with_name(f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pilot_test_world():
    """tests/test_pilot.py::test_route_nfa_matches_host_oracle's table
    and traffic: a cookie regex, a URI prefix, a URI exact + header
    presence rule."""
    http = RefPort("http", 80, "HTTP")
    reviews = RefService(hostname="reviews.default.svc.cluster.local",
                         address="10.1.0.1",
                         ports=(http, RefPort("grpc", 7070, "GRPC")))
    ratings = RefService(hostname="ratings.default.svc.cluster.local",
                         address="10.1.0.2", ports=(http,))

    def rule(name, spec):
        return RefConfig(RefMeta(type="route-rule", name=name,
                                 namespace="default"), spec)

    rules = {
        reviews.hostname: [
            rule("jason", {
                "destination": {"name": "reviews"}, "precedence": 2,
                "match": {"request": {"headers": {
                    "cookie": {"regex": "^(.*?;)?(user=jason)(;.*)?$"}}}},
                "route": [{"labels": {"version": "v2"}}]}),
            rule("api", {
                "destination": {"name": "reviews"}, "precedence": 1,
                "match": {"request": {"headers": {
                    "uri": {"prefix": "/api/"}}}},
                "route": [{"labels": {"version": "v1"}}]})],
        ratings.hostname: [
            rule("exact", {
                "destination": {"name": "ratings"},
                "match": {"request": {"headers": {
                    "uri": {"exact": "/healthz"},
                    "x-debug": {"presence": True}}}},
                "route": [{"labels": {}}]})]}
    rng = np.random.default_rng(3)
    requests = []
    for i in range(64):
        req = {"destination.service":
               (reviews if i % 2 else ratings).hostname,
               "request.path": str(rng.choice(
                   ["/api/v1/reviews", "/healthz", "/other"])),
               "request.headers": {}}
        if rng.random() < 0.5:
            req["request.headers"]["cookie"] = str(rng.choice(
                ["user=jason", "s=1;user=jason;x=2", "user=mary"]))
        if rng.random() < 0.5:
            req["request.headers"]["x-debug"] = "1"
        requests.append(req)
    return [reviews, ratings], rules, requests


def _host_fallback_world():
    """tests/test_pilot.py:414's world: a backreference regex the DFA
    compiler refuses (host fallback) beside a plain prefix rule."""
    svc = RefService(hostname="svc0.default.svc.cluster.local",
                     address="10.0.0.1", ports=(RefPort("http", 80, "HTTP"),))
    rules = {svc.hostname: [
        RefConfig(RefMeta(type="route-rule", name="rr-backref",
                          namespace="default"),
                  {"destination": {"name": "svc0"},
                   "match": {"request": {"headers": {
                       "uri": {"regex": r"^/(a+)\1$"}}}},
                   "route": [{"labels": {"version": "v2"}}]}),
        RefConfig(RefMeta(type="route-rule", name="rr-plain",
                          namespace="default"),
                  {"destination": {"name": "svc0"},
                   "match": {"request": {"headers": {
                       "uri": {"prefix": "/api/"}}}},
                   "route": [{"labels": {"version": "v1"}}]})]}
    reqs = [{"destination.service": svc.hostname, "request.path": p}
            for p in ("/aaaa", "/aaa", "/api/x", "/other", "/aa")]
    return [svc], rules, reqs


def _world(name: str):
    """→ (reference services, reference rules_by_host, requests)."""
    if name.startswith("route_world_"):
        n = int(name.rsplit("_", 1)[1])
        services, rules = ref_workloads.make_route_world(n)
        return services, rules, ref_workloads.make_route_requests(
            128, n_services=len(services))
    if name == "pilot":
        return _pilot_test_world()
    if name == "host_fallback":
        return _host_fallback_world()
    seed = int(name.rsplit("_", 1)[1])
    scope = _load("test_route_scope")
    services, rules = scope._make_corpus(seed)
    return services, rules, scope._make_requests(seed, services)


WORLDS = ["route_world_200", "route_world_1000", "pilot", "scope_0",
          "scope_11", "scope_29"]
_tables: dict = {}


def _tables_of(name: str):
    """Both packages' RouteTables over one world (cached per module)."""
    if name not in _tables:
        services, rules, reqs = _world(name)
        ref = ref_nfa.RouteTable(services, rules)
        p_services, p_rules = interop.pilot_world_from_reference(services,
                                                                 rules)
        port = route_nfa.RouteTable(p_services, p_rules, device="cpu")
        _tables[name] = (ref, port, reqs)
    return _tables[name]


MATCH_BLOCKS = [
    None,
    {"request": {"headers": {"uri": {"prefix": "/a\"b\\"}}}},
    {"request": {"headers": {"uri": {"regex": "^/x/[0-9]+$"}}}},
    {"request": {"headers": {"uri": {"regex": "/x|/y"}}}},
    {"request": {"headers": {":method": {"exact": "GET"},
                             "authority": {"prefix": "api."},
                             "x-debug": {"presence": True},
                             "x-empty": None, "x-any": {}}}},
    {"headers": {"cookie": {"exact": "user=a"}}},
    {"request": {"headers": {"scheme": {"regex": "^https?$"}}}},
]


@pytest.mark.parametrize("i", range(len(MATCH_BLOCKS)))
@pytest.mark.parametrize("source", [None, "src.default.svc.cluster.local"])
def test_match_to_predicate_equals_reference(i, source):
    m = MATCH_BLOCKS[i]
    assert route_nfa.match_to_predicate("h.default.svc.cluster.local", m,
                                        source) == \
        ref_nfa.match_to_predicate("h.default.svc.cluster.local", m, source)


def test_route_world_predicates_equal_reference():
    ref, port, _ = _tables_of("route_world_1000")
    assert [e.predicate for e in port.entries] == \
        [e.predicate for e in ref.entries]
    assert [e.precedence for e in port.entries] == \
        [e.precedence for e in ref.entries]
    np.testing.assert_array_equal(port._weight, ref._weight)
    assert port.default_index == ref.default_index


@pytest.mark.parametrize("name", WORLDS + ["host_fallback"])
def test_select_matches_reference_and_host_oracle(name):
    ref, port, reqs = _tables_of(name)
    assert bool(port.program.host_fallback) == (name == "host_fallback")
    kernels.launches.reset()
    got = port.select(reqs)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref.select(reqs))
    want = [ref.select_host(r) for r in reqs]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [port.select_host(r) for r in reqs])
    assert (got != port.default_index).any()
    # the plain versions ran: nothing launched on the CPU
    assert kernels.launches["rule_match"] == 0
    assert kernels.launches["route_select"] == 0
    for i in got[:8]:
        a, b = port.route_for(int(i)), ref.route_for(int(i))
        assert (a is None) == (b is None)
        if a is not None:
            assert a.rule.meta.name == b.rule.meta.name


@pytest.mark.parametrize("name", ["route_world_200", "pilot", "scope_11"])
def test_compact_select_matches_reference(name):
    ref, port, reqs = _tables_of(name)
    batch = port.tensorizer.tensorize([bag_from_mapping(r) for r in reqs])
    planes = port._compact_planes(batch)
    assert planes is not None
    flat, pres, lens = planes
    assert flat.shape[0] >= 1024 and lens.dtype == np.int16
    got = port._select_on_device_compact(batch.ids.numpy(), pres,
                                         batch.map_present.numpy(), flat,
                                         lens)
    ref_batch = ref.tensorizer.tensorize([ref_bag(r) for r in reqs])
    np.testing.assert_array_equal(np.asarray(ref_batch.str_bytes),
                                  batch.str_bytes.numpy())
    want = ref._select_on_device_compact(
        ref.program.params, np.asarray(ref_batch.ids), pres,
        np.asarray(ref_batch.map_present), flat, lens)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), port.select(reqs))


def test_compact_planes_skip_when_dense_is_smaller():
    _, port, reqs = _tables_of("pilot")
    batch = port.tensorizer.tensorize([bag_from_mapping(reqs[0])])
    assert batch.str_bytes.numel() < 1024        # one row, two slots
    assert port._compact_planes(batch) is None


# ----------------------------------------------------------- K10, plain

def _winner_case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    b, r = 64, 300
    matched = rng.random((b, r)) < 0.05
    weight = rng.permutation(r).astype(np.int32) + 1
    if kind == "no_match":
        matched[:] = False
    elif kind == "all_matched":
        matched[:] = True
    elif kind == "r1":
        matched, weight = matched[:, :1] | (rng.random((b, 1)) < 0.5), \
            np.array([1], np.int32)
    elif kind == "ties":
        weight = rng.integers(1, 4, r).astype(np.int32)
        matched = rng.random((b, r)) < 0.3
    elif kind == "nonpositive":
        weight = rng.integers(-3, 2, r).astype(np.int32)
        matched = rng.random((b, r)) < 0.3
    return matched, weight, int(weight.shape[0])


@pytest.mark.parametrize("kind", ["random", "no_match", "all_matched", "r1",
                                  "ties", "nonpositive"])
def test_route_winner_plain_matches_reference(kind):
    matched, weight, default = _winner_case(kind, 5)
    want = np.asarray(ref_nfa._winner(jnp.asarray(matched),
                                      jnp.asarray(weight), default))
    got = route_ops.route_winner(torch.from_numpy(matched),
                                 torch.from_numpy(weight), default)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        route_ops.route_winner_plain(torch.from_numpy(matched),
                                     torch.from_numpy(weight),
                                     default).numpy(), want)


def _ref_densify(flat, lens16, pres_packed, n_cols, max_len):
    """The reference's re-densify, route_nfa.py:287-300, as it computes
    it inside _select_on_device_compact."""
    lens = jnp.asarray(lens16).astype(jnp.int32)
    b, nbyte = lens.shape
    flat_lens = lens.reshape(-1)
    starts = (jnp.cumsum(flat_lens) - flat_lens).reshape(b, nbyte)
    idx = starts[:, :, None] + jnp.arange(max_len)[None, None, :]
    flat = jnp.asarray(flat)
    sb = flat[jnp.clip(idx, 0, flat.shape[0] - 1)]
    sb = jnp.where(jnp.arange(max_len)[None, None, :] < lens[:, :, None],
                   sb, 0)
    bits = ((jnp.asarray(pres_packed)[:, :, None] >>
             jnp.arange(8, dtype=jnp.uint8)) & 1) > 0
    present = bits.reshape(b, -1)[:, :n_cols]
    return np.asarray(sb), np.asarray(lens), np.asarray(present)


def _densify_case(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    b, nbyte, max_len, n_cols = 48, 1, 256, 7
    if kind == "multi_slot":
        nbyte, n_cols = 3, 19
    lens = rng.integers(0, 40, (b, nbyte))
    if kind == "len_0_and_L":
        lens[::3] = 0
        lens[1::5] = max_len
    if kind == "short_rows":
        max_len = 16
        lens = rng.integers(0, max_len + 1, (b, nbyte))
    total = int(lens.sum())
    cap = max(1024, 1 << total.bit_length())
    flat = rng.integers(0, 256, cap).astype(np.uint8)   # cap > total
    pres = rng.integers(0, 256, (b, -(-n_cols // 8))).astype(np.uint8)
    return flat, lens.astype(np.int16), pres, n_cols, max_len


@pytest.mark.parametrize("kind", ["random", "len_0_and_L", "multi_slot",
                                  "short_rows"])
def test_route_densify_plain_matches_reference(kind):
    flat, lens16, pres, n_cols, max_len = _densify_case(kind, 7)
    assert n_cols % 8 != 0 and flat.shape[0] > int(lens16.sum())
    want = _ref_densify(flat, lens16, pres, n_cols, max_len)
    got = route_ops.route_densify(torch.from_numpy(flat),
                                  torch.from_numpy(lens16),
                                  torch.from_numpy(pres), n_cols, max_len)
    assert [g.dtype for g in got] == [torch.uint8, torch.int32, torch.bool]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_route_ops_refuse_bad_inputs():
    m = torch.zeros((2, 3), dtype=torch.bool)
    with pytest.raises(ValueError):
        route_ops.route_winner(m, torch.ones(4, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        route_ops.route_winner(m.int(), torch.ones(3, dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        route_ops.route_densify(torch.zeros(0, dtype=torch.uint8),
                                torch.zeros((2, 1), dtype=torch.int16),
                                torch.zeros((2, 1), dtype=torch.uint8), 3, 8)
    with pytest.raises(ValueError):
        route_ops.route_densify(torch.zeros(8, dtype=torch.uint8),
                                torch.zeros((2, 1), dtype=torch.int16),
                                torch.zeros((2, 1), dtype=torch.uint8), 9, 8)


# ------------------------------------------------------- RouteScopeProgram

@pytest.mark.parametrize("seed", [0, 11, 29])
def test_admit_rows_and_digest_match_reference(seed):
    scope_mod = _load("test_route_scope")
    services, rules = scope_mod._make_corpus(seed)
    ref = ref_nfa.RouteScopeProgram(rules)
    _, p_rules = interop.pilot_world_from_reference(services, rules)
    port = route_nfa.RouteScopeProgram(p_rules, device="cpu")
    assert port.digest == ref.digest
    assert port.n_constrained == ref.n_constrained > 0
    sources = [s.hostname for s in services] + \
        [None, "ghost.default.svc.cluster.local", ""]
    for n in (1, 3, len(sources)):          # padding to powers of two
        assert port.admit_rows(sources[:n]) == ref.admit_rows(sources[:n])
    rows = port.admit_rows(sources)
    for b, src in enumerate(sources):
        for host, rs in p_rules.items():
            for i in range(len(rs)):
                assert port.admits(rows[b], host, i) == \
                    ref.admits(rows[b], host, i)
    assert port.admit_rows([]) == []


def test_admit_rows_without_constraints_admits_everything():
    services, rules = ref_workloads.make_route_world(40)
    free = {h: [c for c in v if not c.spec["match"].get("source")]
            for h, v in rules.items()}
    _, p_free = interop.pilot_world_from_reference(services, free)
    port = route_nfa.RouteScopeProgram(p_free, device="cpu")
    ref = ref_nfa.RouteScopeProgram(free)
    assert port.digest == ref.digest and port.n_constrained == 0
    assert port.admit_rows(["a", None]) == ref.admit_rows(["a", None]) == \
        [None, None]


def test_route_worlds_built_by_both_packages_agree():
    services, rules = workloads.make_route_world(300)
    r_services, r_rules = ref_workloads.make_route_world(300)
    c_services, c_rules = interop.pilot_world_from_reference(r_services,
                                                             r_rules)
    assert services == c_services and rules == c_rules
    assert workloads.make_route_requests(64, 30) == \
        ref_workloads.make_route_requests(64, 30)


def test_select_wire_and_native_raise_not_ported():
    _, port, _ = _tables_of("pilot")
    with pytest.raises(NotPorted):
        port.select_wire([b""])
    with pytest.raises(NotPorted):
        port.native


# ------------------------------------- rule_match's word formulation (K1)

def _k1_inputs(program, batch):
    """The arguments the port program's run hands rule_match."""
    seen = {}
    real = pt_rs.rule_match

    def spy(*args):
        seen["args"] = args[:6]
        return real(*args)
    pt_rs.rule_match = spy
    try:
        program(batch)
    finally:
        pt_rs.rule_match = real
    return seen["args"]


def _assert_words_equal(ref_program, ref_batch, program, batch):
    want = [np.asarray(a) for a in ref_program(ref_batch)]
    args = _k1_inputs(program, batch)
    for planes in (pt_rs.PLANES, ("matched",)):
        got = pt_rs.rule_match_words_plain(*args, planes)
        for name, w, h in zip(pt_rs.PLANES, want, got):
            if name in planes:
                np.testing.assert_array_equal(h.numpy(), w, err_msg=name)
            else:
                assert h is None
    return want


@pytest.mark.parametrize("name", WORLDS + ["host_fallback"])
def test_rule_words_match_reference_on_route_worlds(name):
    ref, port, reqs = _tables_of(name)
    want = _assert_words_equal(
        ref.program, ref.tensorizer.tensorize([ref_bag(r) for r in reqs]),
        port.program,
        port.tensorizer.tensorize([bag_from_mapping(r) for r in reqs]))
    assert want[0].any()


@pytest.mark.parametrize("seed", [0, 11, 29])
def test_rule_words_match_reference_on_admission_batches(seed):
    scope_mod = _load("test_route_scope")
    services, rules = scope_mod._make_corpus(seed)
    ref = ref_nfa.RouteScopeProgram(rules)
    _, p_rules = interop.pilot_world_from_reference(services, rules)
    port = route_nfa.RouteScopeProgram(p_rules, device="cpu")
    sources = [s.hostname for s in services] + \
        ["ghost.default.svc.cluster.local", ""]
    (ref_prog, ref_tz), (prog, tz) = ref._program, port._program
    for n in (1, 33, 97):
        rows = [{"source.service": sources[i % len(sources)]}
                for i in range(n)]
        want = _assert_words_equal(
            ref_prog, ref_tz.tensorize([ref_bag(r) for r in rows]), prog,
            tz.tensorize([bag_from_mapping(r) for r in rows]))
        assert want[0].shape == (n, prog.rule_ns.shape[0])
