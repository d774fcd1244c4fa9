"""The port's APA phase (Dispatcher.preprocess) and host adapters, served,
against the JAX package's.

RuntimeServer(device="cpu") of the port and the reference's
RuntimeServer, each over its own copy of one store, are fed the same
bags:
  * tests/test_runtime.py's APA world (test_apa_preprocess: a
    kubernetesenv handler, a kubernetes instance with
    attribute_bindings, a rule with match "" and a denier on a bound
    attribute);
  * chip_smoke.apa_world over make_store(1_000): 100 static pods, a
    deny rule on a bound label and a stdio access log of the bound
    attributes, with chip_smoke.check_actions_world's OPA rules
    (expression and Rego mode) and servicecontrol apikey rule beside
    make_store's deniers;
  * chip_smoke.telemetry_world over make_store(24): Istio's default
    telemetry config with its access log in stdio.
Responses (every field), drained rule counts, the bound attributes of
every preprocessed bag, and the stdio lines (byte for byte) must be
equal. Every value compared is an int, a string, a bool or bytes, so
the tolerance is exact equality. The port runs on the CPU (plain
versions of every kernel).
"""
import importlib.util
import ipaddress
import pathlib

import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import MemStore as RefMemStore
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)
PORT_ARGS = dict(initial_prewarm=False, rulestats_drain_s=0)
FIELDS = ("status_code", "status_message", "valid_duration_s",
          "valid_use_count", "referenced", "referenced_presence",
          "deny_rule", "active_quota_rules")
PODS = 100


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load(ROOT / "chip_smoke.py", "_chip_smoke_apa")


def _runtime_world(logs: pathlib.Path):
    """test_runtime.test_apa_preprocess's store."""
    s = RefMemStore()
    s.set(("handler", "", "kube"), {
        "adapter": "kubernetesenv",
        "params": {"pods": {"web.default": {
            "pod_name": "web-1", "namespace": "default",
            "pod_ip": "10.0.0.9", "service_account_name": "web-sa"}}}})
    s.set(("instance", "", "kubeattrs"), {
        "template": "kubernetes",
        "params": {"source_ip": "source.ip",
                   "attribute_bindings": {
                       "source.name": "$out.source_pod_name",
                       "source.namespace": "$out.source_namespace"}}})
    s.set(("rule", "", "kubeapa"), {
        "match": "",
        "actions": [{"handler": "kube", "instances": ["kubeattrs"]}]})
    s.set(("handler", "", "deny-default-ns"), {
        "adapter": "denier", "params": {}})
    s.set(("instance", "", "nothing2"), {
        "template": "checknothing", "params": {}})
    s.set(("rule", "", "denypod"), {
        "match": 'source.name == "web-1"',
        "actions": [{"handler": "deny-default-ns",
                     "instances": ["nothing2"]}]})
    return s, {}


def _runtime_dicts(b: int, seed: int) -> list[dict]:
    ips = ["10.0.0.9", "10.0.0.7", None]
    out = []
    for j in range(b):
        d = {"destination.service": "x.default.svc"}
        ip = ips[(j + seed) % 3]
        if ip is not None:
            d["source.ip"] = ipaddress.ip_address(ip).packed
        out.append(d)
    return out


def _apa_world(logs: pathlib.Path):
    """make_store(1_000) + chip_smoke's APA world and host check
    actions; → (store, {handler: (reference log, port log)})."""
    s = ref_workloads.make_store(1000)
    SMOKE.apa_world(s, PODS, str(logs / "pods_ref.log"))
    SMOKE.check_actions_world(s)
    return s, {"podstdio": ("pods_ref.log", "pods_port.log")}


def _telemetry_world(logs: pathlib.Path):
    s = ref_workloads.make_store(24)
    SMOKE.telemetry_world(s, str(logs / "telemetry_ref.log"))
    return s, {"stdio": ("telemetry_ref.log", "telemetry_port.log")}


# store factory, traffic
WORLDS = {
    "runtime": (_runtime_world, _runtime_dicts),
    "apa": (_apa_world, lambda b, seed: SMOKE.apa_dicts(b, seed, PODS)),
    "telemetry": (_telemetry_world, SMOKE.telemetry_dicts),
}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    made: dict = {}

    def get(name: str):
        if name not in made:
            logs = tmp_path_factory.mktemp(name)
            ref_store, files = WORLDS[name][0](logs)
            port_store = interop.store_from_reference(ref_store)
            for handler, (_, port_log) in files.items():
                key = ("handler", "istio-system", handler)
                spec = port_store.get(key)
                port_store.set(key, {**spec, "params": {
                    **spec["params"], "log_stream": str(logs / port_log)}})
            ref = RefServer(ref_store, RefArgs(**REF_ARGS))
            port = RuntimeServer(port_store, ServerArgs(**PORT_ARGS),
                                 device="cpu")
            made[name] = (ref, port, logs, files,
                          (port, ref, port_store, ref_store))
        return made[name][:4]
    yield get
    for *_, objs in made.values():
        for x in objs:
            x.close()


def _assert_responses_equal(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        for f in FIELDS:
            assert getattr(b, f) == getattr(a, f), (i, f)


def _bound(bag) -> dict:
    """The attributes the APA phase bound into a preprocessed bag."""
    assert type(bag).__name__ == "MutableBag"
    return {k: bag.get(k)[0] for k in sorted(bag._values)}


@pytest.mark.parametrize("name", ["runtime", "apa"])
def test_has_apa(servers, name):
    ref, port, _, _ = servers(name)
    assert port.controller.dispatcher.has_apa
    assert ref.controller.dispatcher.has_apa


@pytest.mark.parametrize("name", ["runtime", "apa"])
def test_preprocessed_bags_equal(servers, name):
    ref, port, _, _ = servers(name)
    dicts = WORLDS[name][1](48, 3)
    want = [_bound(ref.preprocess(ref_bag(d))) for d in dicts]
    got = [_bound(port.preprocess(bag_from_mapping(d))) for d in dicts]
    assert got == want
    assert any(got) and not all(got)


@pytest.mark.parametrize("name", ["runtime", "apa"])
@pytest.mark.parametrize("b", [1, 16, 64])
def test_check_many_equal(servers, name, b):
    ref, port, _, _ = servers(name)
    dicts = WORLDS[name][1](b, b)
    want = ref.check_many([ref_bag(d) for d in dicts])
    got = port.check_many([bag_from_mapping(d) for d in dicts])
    _assert_responses_equal(want, got)


def test_bound_attribute_denies(servers):
    """test_apa_preprocess: the APA phase fills source.name, and the
    denier on it fires; without a pod for the ip it does not."""
    ref, port, _, _ = servers("runtime")
    for srv, bag in ((ref, ref_bag), (port, bag_from_mapping)):
        r = srv.check(bag({"source.ip": ipaddress.ip_address(
            "10.0.0.9").packed, "destination.service": "x.default.svc"}))
        assert r.status_code == 7
        r2 = srv.check(bag({"source.ip": ipaddress.ip_address(
            "10.0.0.7").packed, "destination.service": "x.default.svc"}))
        assert r2.status_code == 0


def test_apa_world_deny_causes(servers):
    """In the APA world, rows are denied by OPA (both modes), by
    servicecontrol, by make_store's deniers and by the deny rule on a
    bound label, the last OK without the APA phase."""
    ref, port, _, _ = servers("apa")
    dicts = SMOKE.apa_dicts(256, 11, PODS)
    got = port.check_many([bag_from_mapping(d) for d in dicts])
    _assert_responses_equal(
        ref.check_many([ref_bag(d) for d in dicts]), got)
    causes = SMOKE.deny_causes(got)
    assert all(causes.values()), causes
    # the same bags without the APA phase (on both servers, so that
    # their rule counts stay equal)
    raw = port.controller.dispatcher.check(
        [bag_from_mapping(d) for d in dicts])
    _assert_responses_equal(
        ref.controller.dispatcher.check([ref_bag(d) for d in dicts]), raw)
    assert any(g.status_code and not r.status_code
               for g, r in zip(got, raw))
    messages = {r.status_message.split(":")[0] for r in got
                if r.status_code}
    assert {"opa", "API_KEY_INVALID"} <= messages


@pytest.mark.parametrize("name", ["runtime", "apa"])
def test_rule_counts_equal(servers, name):
    ref, port, _, _ = servers(name)
    ref.rulestats.drain()
    port.rulestats.drain()
    for seed in (31, 32):
        dicts = WORLDS[name][1](40, seed)
        ref.check_many([ref_bag(d) for d in dicts])
        port.check_many([bag_from_mapping(d) for d in dicts])
    ref.rulestats.drain()
    port.rulestats.drain()
    counts = port.rulestats.counts()
    assert counts == ref.rulestats.counts()
    assert sum(v["denies"] for v in counts.values()) > 0


@pytest.mark.parametrize("name", ["apa", "telemetry"])
def test_report_stdio_lines_equal(servers, name):
    """report() through the APA phase (apa) or of the telemetry world:
    the stdio handler's lines equal the reference's byte for byte."""
    ref, port, logs, files = servers(name)
    dicts = WORLDS[name][1](45, 7)
    ref.report([ref_bag(d) for d in dicts])
    port.report([bag_from_mapping(d) for d in dicts])
    for ref_log, port_log in files.values():
        want = (logs / ref_log).read_bytes()
        got = (logs / port_log).read_bytes()
        assert got == want
        assert len(got.splitlines()) >= 45
