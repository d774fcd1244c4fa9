"""The port's config canary (istio_tpu_torch/canary) against the JAX
package's (istio_tpu/canary).

Every scenario of tests/test_canary.py runs on both packages from the
same inputs (`both(scenario)`), and the outcomes must be equal: recorder
stats and corpora, diff reports, gate verdicts, rejections, and the
canary metric families' deltas. Then a corpus file saved by either
package loads in the other (`entry_to_json` byte-equal), and for each of
the three seeded canary pairs (testing/corpus.make_canary_snapshot_pairs)
a port CPU server and a reference server give equal reports: the
divergent swap vetoed with the planted rule named under the planted
kind, the old dispatcher serving on, the identical swap published with
no divergence, and warn mode publishing the divergent candidate and
re-baselining the recorder. Then the port's own contracts: a vetoed
publish leaves the handler table, the quota pools and the serving
dispatcher untouched (quota() answers as the reference's after it), a
CPU server's canary fails open as the reference's does, and a strict
canary (what a CUDA server builds) raises a replay device fault that
CHAOS did not inject, publishing nothing.

Exact equality throughout: every value compared is an int, a bool, a
string or `valid_duration_s`, a min over f32 constants. Wall times and
trace ids are left out of report comparisons.
"""
import dataclasses
import datetime
import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from istio_tpu import canary as ref_canary
from istio_tpu.adapters.sdk import QuotaArgs as RefQuotaArgs
from istio_tpu.attribute import compressed as ref_compressed
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.canary import gate as ref_gate
from istio_tpu.runtime import MemStore as RefMemStore
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime.batcher import pad_to_bucket as ref_pad
from istio_tpu.runtime.dispatcher import CheckResponse as RefResponse
from istio_tpu.runtime.store import Event as RefEvent
from istio_tpu.testing import corpus as ref_corpus

from istio_tpu_torch import canary as pt_canary
from istio_tpu_torch.adapters.sdk import QuotaArgs
from istio_tpu_torch.attribute import compressed as pt_compressed
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.canary import gate as pt_gate
from istio_tpu_torch.runtime import MemStore, RuntimeServer, ServerArgs
from istio_tpu_torch.runtime.batcher import pad_to_bucket
from istio_tpu_torch.runtime.dispatcher import CheckResponse
from istio_tpu_torch.runtime.resilience import CHAOS
from istio_tpu_torch.runtime.store import Event
from istio_tpu_torch.testing import corpus as pt_corpus

BUCKETS = (16, 32)


def _ref_server(store, **kw):
    return RefServer(store, RefArgs(**kw))


def _pt_server(store, **kw):
    return RuntimeServer(store, ServerArgs(**kw), device="cpu")


def _ref_serve(srv, bags):
    return srv.check_batch_preprocessed(bags)


def _pt_serve(srv, bags):
    return srv.check_many(bags)


REF = SimpleNamespace(
    name="ref", canary=ref_canary, gate=ref_gate, compressed=ref_compressed,
    bag=ref_bag, CheckResponse=RefResponse, MemStore=RefMemStore,
    Event=RefEvent, corpus=ref_corpus, pad=ref_pad, server=_ref_server,
    serve=_ref_serve, QuotaArgs=RefQuotaArgs,
    # the reference server with the planes the port does not carry
    # switched off where they would act behind the test's back
    server_args=dict(initial_prewarm=False, audit=False))
PORT = SimpleNamespace(
    name="port", canary=pt_canary, gate=pt_gate, compressed=pt_compressed,
    bag=bag_from_mapping, CheckResponse=CheckResponse, MemStore=MemStore,
    Event=Event, corpus=pt_corpus, pad=pad_to_bucket, server=_pt_server,
    serve=_pt_serve, QuotaArgs=QuotaArgs, server_args={})


def both(scenario):
    """(reference outcome, port outcome) of one scenario."""
    return scenario(REF), scenario(PORT)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Snap:
    """Minimal snapshot stand-in for recorder name resolution."""

    def __init__(self, names):
        self._names = list(names)

    def qualified_rule_names(self):
        return self._names


def _resp(p, status=0, dur=5.0, uses=10_000, deny=-1, quota=()):
    r = p.CheckResponse()
    r.status_code = status
    r.valid_duration_s = dur
    r.valid_use_count = uses
    r.deny_rule = deny
    r.active_quota_rules = tuple(quota)
    return r


def _bags(p, n):
    return [p.bag({"destination.service": f"svc{i}.ns1.svc.cluster.local",
                   "request.method": "GET"}) for i in range(n)]


def entry_view(p, e) -> dict:
    """An entry as JSON minus its wall-clock stamp."""
    d = p.canary.entry_to_json(e)
    d.pop("t")
    return d


def report_view(rep) -> dict | None:
    """A CanaryReport without wall times and trace ids."""
    if rep is None:
        return None
    d = rep.to_dict()
    d.pop("replay_rows_per_s")
    d.pop("replay_wall_s")
    for c in d["per_rule"].values():
        for ex in c["exemplars"]:
            ex.pop("trace_id")
    return d


def families(p) -> dict:
    """The canary metric families' readings (process-wide)."""
    f = p.gate.FAMILIES
    return {"replays": f["replays"].value(), "rows": f["rows"].value(),
            "errors": f["errors"].value(),
            "divergences": {k: f["divergences"].value(kind=k) for k in (
                "status_flip", "precondition", "quota")},
            "verdicts": {v: f["verdicts"].value(verdict=v) for v in (
                "publish", "warn", "veto")},
            "replay_n": f["replay_seconds"].count(),
            "delay_n": f["publish_delay_seconds"].count()}


def family_delta(p, fn):
    """(fn's result, the families' growth while it ran)."""
    before = families(p)
    out = fn()
    after = families(p)

    def sub(a, b):
        return {k: sub(v, b[k]) for k, v in a.items()} \
            if isinstance(a, dict) else a - b

    return out, sub(after, before)


# ---------------------------------------------------------------------------
# tests/test_canary.py, on both packages
# ---------------------------------------------------------------------------

def test_recorder_stride_sampling():
    def run(p):
        rec = p.canary.TrafficRecorder(capacity=64, sample_every=3)
        snap = _Snap(["r0"])
        rec.tap(_bags(p, 10), [_resp(p) for _ in range(10)], snap,
                "destination.service")
        first = rec.stats()
        rec.tap(_bags(p, 4), [_resp(p) for _ in range(4)], snap,
                "destination.service")
        return first, rec.stats()

    ref, port = both(run)
    assert port == ref
    assert port[0]["sampled"] == 4 and port[0]["seen"] == 10
    assert port[1]["sampled"] == 5


def test_recorder_ring_bounds_and_eviction():
    def run(p):
        rec = p.canary.TrafficRecorder(capacity=8, sample_every=1)
        snap = _Snap(["r0"])
        for k in range(4):
            rec.tap(_bags(p, 4), [_resp(p, status=k) for _ in range(4)],
                    snap, "destination.service")
        return rec.stats(), [entry_view(p, e) for e in rec.corpus()]

    ref, port = both(run)
    assert port == ref
    st, corpus = port
    assert st["entries"] == 8 and st["evicted"] == 8
    assert {e["status"] for e in corpus} == {2, 3}


def test_recorder_device_surface_overrides_merged_response():
    """The fused tap records the DEVICE planes, not the post-host-merge
    response."""
    def run(p):
        rec = p.canary.TrafficRecorder(capacity=8)
        snap = _Snap(["ns1/r0", "ns1/r1"])
        responses = [_resp(p, status=5, dur=0.5, uses=1, deny=-1),
                     _resp(p, status=7, deny=1)]
        device = (np.array([0, 7], np.int32),
                  np.array([9.0, 2.5], np.float32),
                  np.array([20_000, 500], np.int32),
                  np.array([0, 1], np.int32))
        rec.tap(_bags(p, 2), responses, snap, "destination.service",
                device=device)
        return [entry_view(p, e) for e in rec.corpus()]

    ref, port = both(run)
    assert port == ref
    a, b = port
    assert a["status"] == 0 and a["deny_rule"] == ""
    assert a["valid_duration_s"] == 5.0 and a["valid_use_count"] == 10_000
    assert b["status"] == 7 and b["deny_rule"] == "ns1/r1"
    assert b["valid_duration_s"] == 2.5 and b["valid_use_count"] == 500


def test_recorder_corpus_resolves_names_and_namespace():
    def run(p):
        rec = p.canary.TrafficRecorder(capacity=8)
        snap = _Snap(["ns1/deny-rule", "ns1/quota-rule"])
        rec.tap(_bags(p, 1), [_resp(p, status=7, deny=0, quota=(1,))],
                snap, "destination.service")
        return [entry_view(p, e) for e in rec.corpus()]

    ref, port = both(run)
    assert port == ref
    (e,) = port
    assert e["deny_rule"] == "ns1/deny-rule"
    assert e["quota_rules"] == ["ns1/quota-rule"]
    assert e["namespace"] == "ns1" and e["status"] == 7


CORPUS_VALUES = {
    "destination.service": "a.ns1.svc.cluster.local",
    "request.size": 123,
    "request.time": datetime.datetime(2026, 8, 3, 12, 0,
                                      tzinfo=datetime.timezone.utc),
    "response.duration": datetime.timedelta(milliseconds=250),
    "source.ip": b"\x00" * 10 + b"\xff\xff" + bytes([9, 8, 7, 6]),
    "request.headers": {"cookie": "session=1"},
    "connection.mtls": True,
}


def _corpus_entry(p):
    return p.canary.CanaryEntry(
        ca=p.compressed.encode(p.bag(CORPUS_VALUES)), status=7,
        valid_duration_s=2.5, valid_use_count=42, deny_rule="ns1/r1",
        namespace="ns1", quota_rules=("ns1/q",), trace_id="t1", t=1.0)


def test_corpus_file_roundtrip(tmp_path):
    def run(p):
        path = str(tmp_path / f"{p.name}.json")
        n = p.canary.save_corpus(path, [_corpus_entry(p)])
        (back,) = p.canary.load_corpus(path)
        bag = back.bag()
        return n, p.canary.entry_to_json(back), \
            {k: bag.get(k) for k in CORPUS_VALUES}

    ref, port = both(run)
    assert port == ref
    n, e, values = port
    assert n == 1 and e["status"] == 7 and e["deny_rule"] == "ns1/r1"
    assert e["quota_rules"] == ["ns1/q"]
    assert values == {k: (v, True) for k, v in CORPUS_VALUES.items()}


def test_entry_json_is_json_safe():
    def run(p):
        e = p.canary.CanaryEntry(ca=p.compressed.encode(p.bag({"a": 1})))
        text = json.dumps(p.canary.entry_to_json(e))
        back = p.canary.entry_from_json(p.canary.entry_to_json(e))
        return text, back.valid_use_count

    ref, port = both(run)
    assert port == ref
    assert port[1] == 10_000


def _entry(p, status=0, dur=5.0, uses=10_000, deny="", quota=()):
    return p.canary.CanaryEntry(
        ca=p.compressed.encode(p.bag({"a": 1})), status=status,
        valid_duration_s=dur, valid_use_count=uses, deny_rule=deny,
        quota_rules=tuple(quota))


def _replay(p, rows):
    return p.canary.ReplayResult(
        status=[r.get("status", 0) for r in rows],
        valid_duration_s=[r.get("dur", 5.0) for r in rows],
        valid_use_count=[r.get("uses", 10_000) for r in rows],
        deny_rule=[r.get("deny", "") for r in rows],
        quota_rules=[tuple(r.get("quota", ())) for r in rows],
        n_rows=len(rows), wall_s=0.01)


def test_diff_classifies_all_kinds():
    def run(p):
        entries = [
            _entry(p, status=7, deny="ns/d"),
            _entry(p),
            _entry(p, status=7, dur=2.5, deny="ns/d"),
            _entry(p, quota=("ns/q",)),
            _entry(p),
        ]
        rep = p.canary.diff_decisions(entries, _replay(p, [
            {},
            {"status": 7, "deny": "ns/d2"},
            {"status": 7, "dur": 1.25, "deny": "ns/d"},
            {},
            {},
        ]))
        return report_view(rep), rep.diverging_rules()

    ref, port = both(run)
    assert port == ref
    rep = port[0]
    assert rep["n_rows"] == 5 and rep["n_divergent"] == 4
    assert rep["by_kind"] == {"status_flip": 2, "precondition": 1,
                              "quota": 1}
    assert rep["per_rule"]["ns/d"]["status_flip"] == 1
    assert rep["per_rule"]["ns/d2"]["status_flip"] == 1
    assert rep["per_rule"]["ns/d"]["precondition"] == 1
    assert rep["per_rule"]["ns/q"]["quota"] == 1
    assert rep["divergence_rate"] == 0.8
    ex = rep["per_rule"]["ns/q"]["exemplars"][0]
    assert ex["kind"] == "quota" and ex["bag"]


def test_diff_reservoir_exemplars_equal_the_reference():
    """The reservoir keeps the same exemplars under the same seed when a
    rule diverges on more rows than it keeps."""
    def run(p):
        entries = [_entry(p, status=7, deny="ns/d") for _ in range(40)]
        rep = p.canary.diff_decisions(entries, _replay(p, [{}] * 40),
                                      exemplars_per_rule=3, seed=11)
        return report_view(rep)

    ref, port = both(run)
    assert port == ref
    assert [ex["entry_index"] for ex in
            port["per_rule"]["ns/d"]["exemplars"]] != [0, 1, 2]


def test_diff_waivers_excluded_from_gating_rate():
    def run(p):
        entries = [_entry(p, status=7, deny="ns/waived"), _entry(p)]
        rep = p.canary.diff_decisions(entries, _replay(p, [{}, {}]),
                                      waivers=("ns/waived",))
        return report_view(rep), rep.diverging_rules()

    ref, port = both(run)
    assert port == ref
    rep, ranked = port
    assert rep["n_divergent"] == 0 and rep["n_waived"] == 1
    assert rep["divergence_rate"] == 0.0
    assert rep["per_rule"]["ns/waived"]["waived"] is True
    assert "ns/waived" not in ranked


def outcome(fn):
    """('ok', value) or (error class name, message)."""
    try:
        return ("ok", fn())
    except Exception as exc:   # noqa: BLE001 — the outcome is the point
        return (type(exc).__name__, str(exc))


def test_diff_row_mismatch_raises():
    ref, port = both(lambda p: outcome(lambda: p.canary.diff_decisions(
        [_entry(p)], _replay(p, [{}, {}]))))
    assert port == ref
    assert port[0] == "ValueError"


def test_canary_config_rejects_bad_mode():
    ref, port = both(lambda p: outcome(
        lambda: p.canary.CanaryConfig(mode="audit")))
    assert port == ref
    assert port[0] == "ValueError"


def test_gate_off_mode_never_replays():
    def run(p):
        canary = p.canary.ConfigCanary(p.canary.CanaryConfig(mode="off"))
        return family_delta(p, lambda: (canary.gate(None, None, None),
                                         canary.evaluations))

    ref, port = both(run)
    assert port == ref
    assert port[0] == (None, 0)


def test_gate_abstains_without_corpus():
    def run(p):
        canary = p.canary.ConfigCanary(p.canary.CanaryConfig(mode="gate"))
        return family_delta(p, lambda: (
            canary.gate(None, object(), object()), canary.reports(),
            canary.evaluations))

    ref, port = both(run)
    assert port == ref
    assert port[0] == (None, [], 1)


def _scripted(p, monkeypatch, canary, entries, rows):
    monkeypatch.setattr(canary.recorder, "corpus",
                        lambda limit=None: entries)
    monkeypatch.setattr(p.gate, "replay_entries",
                        lambda *a, **k: _replay(p, rows))
    monkeypatch.setattr(p.gate, "confirm_exemplars", lambda *a, **k: None)


def test_gate_threshold_is_strictly_greater_than(monkeypatch):
    def run(p):
        out = []
        for thr in (0.5, 0.25):
            canary = p.canary.ConfigCanary(p.canary.CanaryConfig(
                mode="gate", max_divergence_rate=thr))
            entries = [_entry(p, status=7, deny="ns/d"), _entry(p)]
            _scripted(p, monkeypatch, canary, entries, [{}, {}])
            rej, fams = family_delta(
                p, lambda: canary.gate(None, _Snap([]), object()))
            out.append((None if rej is None else str(rej),
                        None if rej is None else report_view(rej.report),
                        report_view(canary.reports()[-1]), fams,
                        canary.vetoes))
        return out

    ref, port = both(run)
    assert port == ref
    (rej0, _, rep0, _, _), (rej1, rrep1, _, fams1, vetoes1) = port
    assert rej0 is None and rep0["verdict"] == "warn"
    assert rej1 is not None and "ns/d" in rej1
    assert rrep1["verdict"] == "veto" and vetoes1 == 1
    assert fams1["verdicts"]["veto"] == 1


def test_divergent_publish_rebaselines_recorder(monkeypatch):
    def run(p):
        canary = p.canary.ConfigCanary(p.canary.CanaryConfig(mode="warn"))
        snap = _Snap(["ns/d"])
        monkeypatch.setattr(p.gate, "confirm_exemplars",
                            lambda *a, **k: None)
        canary.recorder.tap(_bags(p, 2),
                            [_resp(p, status=7, deny=0), _resp(p)],
                            snap, "destination.service")
        trail = [canary.recorder.stats()["entries"]]
        monkeypatch.setattr(
            p.gate, "replay_entries",
            lambda *a, **k: _replay(p, [{"status": 7, "deny": "ns/d"}, {}]))
        trail.append(canary.gate(None, _Snap([]), object()))
        trail += [canary.reports()[-1].verdict,
                  canary.recorder.stats()["entries"]]
        canary.on_published()
        trail.append(canary.recorder.stats()["entries"])
        monkeypatch.setattr(p.gate, "replay_entries",
                            lambda *a, **k: _replay(p, [{}, {}]))
        trail.append(canary.gate(None, _Snap([]), object()))
        trail += [canary.reports()[-1].verdict,
                  canary.recorder.stats()["entries"]]
        canary.on_published()
        trail.append(canary.recorder.stats()["entries"])
        return trail

    ref, port = both(run)
    assert port == ref
    assert port == [2, None, "publish", 2, 2, None, "warn", 2, 0]


def test_gate_vetoes_rule_wipe(monkeypatch):
    class _EmptySnap(_Snap):
        rules = ()
        revision = 9

    def run(p):
        canary = p.canary.ConfigCanary(p.canary.CanaryConfig(mode="gate"))
        monkeypatch.setattr(
            canary.recorder, "corpus",
            lambda limit=None: [_entry(p, status=7, deny="ns/d"),
                                _entry(p)])
        monkeypatch.setattr(p.gate, "confirm_exemplars",
                            lambda *a, **k: None)
        rej = canary.gate(None, _EmptySnap([]), None)
        return str(rej), report_view(rej.report)

    ref, port = both(run)
    assert port == ref
    assert "ns/d" in port[0]
    assert port[1]["by_kind"] == {"status_flip": 1}
    assert port[1]["candidate_revision"] == 9


def test_gate_fails_open_on_internal_error(monkeypatch):
    def run(p):
        canary = p.canary.ConfigCanary(p.canary.CanaryConfig(mode="gate"))
        monkeypatch.setattr(canary.recorder, "corpus",
                            lambda limit=None: [_entry(p)])
        monkeypatch.setattr(
            p.gate, "replay_entries",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        return family_delta(p, lambda: canary.gate(None, object(),
                                                   object()))

    ref, port = both(run)
    assert port == ref
    assert port[0] is None and port[1]["errors"] == 1


def test_server_args_reject_bad_canary_mode():
    def run(p):
        return outcome(lambda: p.server(p.MemStore(), canary="audit",
                                        **p.server_args))

    ref, port = both(run)
    assert port == ref
    assert port[0] == "ValueError"


def test_identical_config_with_host_overlay_rule_publishes():
    """A rule whose CHECK action stays host-side (a
    CASE_INSENSITIVE_STRINGS list, unfusable): the recorder captures the
    device surface, so an identical rebuild publishes with zero
    divergences on both packages."""
    def run(p):
        store = p.MemStore()
        store.apply_events([
            p.Event(("handler", "istio-system", "ci"), {
                "adapter": "list",
                "params": {"overrides": ["ALLOWED"],
                           "entry_type": "CASE_INSENSITIVE_STRINGS",
                           "blacklist": False}}),
            p.Event(("instance", "istio-system", "srcns"), {
                "template": "listentry",
                "params": {"value": "source.namespace"}}),
            p.Event(("rule", "ns1", "host-deny"), {
                "match":
                    'destination.service == "a.ns1.svc.cluster.local"',
                "actions": [{"handler": "ci.istio-system",
                             "instances": ["srcns.istio-system"]}]})],
            notify=False)
        srv = p.server(store, batch_window_s=0.0005, max_batch=8,
                       buckets=(8,), canary="gate", rulestats_drain_s=0,
                       default_manifest=p.corpus.ANALYZER_MANIFEST,
                       **p.server_args)
        try:
            plan = srv.controller.dispatcher.fused
            assert plan is not None and plan.host_actions
            bags = [p.bag({
                "destination.service": "a.ns1.svc.cluster.local",
                "source.namespace": "not-allowed",
                "request.method": "GET"}) for _ in range(4)]
            resps = p.serve(srv, p.pad(bags, (8,)))
            entries = srv.canary.recorder.corpus()
            d0 = srv.controller.dispatcher
            d1 = srv.controller.rebuild()
            return ([r.status_code for r in resps[:4]],
                    [entry_view(p, e) for e in entries], d1 is not d0,
                    report_view(srv.canary.reports()[-1]))
        finally:
            srv.close()

    ref, port = both(run)
    assert port == ref
    statuses, entries, published, rep = port
    assert statuses[0] != 0                 # the host adapter denies live
    assert entries and all(e["status"] == 0 for e in entries)
    assert published and rep["n_divergent"] == 0


# ---------------------------------------------------------------------------
# the corpus file across packages
# ---------------------------------------------------------------------------

def _recorded_entries(p, n=12, seed=3):
    rng = np.random.default_rng(seed)
    rec = p.canary.TrafficRecorder(capacity=64)
    snap = _Snap([f"ns{i}/r{i}" for i in range(6)])
    dicts = [{"destination.service":
              f"svc{int(rng.integers(9))}.ns{i % 3}.svc.cluster.local",
              "request.method": "GET", "request.size": int(rng.integers(99)),
              "request.headers": {"x": str(i)}} for i in range(n)]
    device = (np.asarray(rng.choice([0, 7], n), np.int32),
              np.asarray(rng.choice([2.5, 9.0], n), np.float32),
              np.asarray(rng.integers(1, 20_000, n), np.int32),
              np.asarray(rng.integers(0, 6, n), np.int32))
    rec.tap([p.bag(d) for d in dicts],
            [_resp(p, quota=(int(rng.integers(6)),)) for _ in range(n)],
            snap, "destination.service", device=device)
    out = rec.corpus()
    for e in out:
        e.t = 1.5                           # the wall clock, pinned
    return out


def test_corpus_json_byte_equal_and_loads_across_packages(tmp_path):
    ref_entries = _recorded_entries(REF)
    pt_entries = _recorded_entries(PORT)
    assert [json.dumps(pt_canary.entry_to_json(e)) for e in pt_entries] \
        == [json.dumps(ref_canary.entry_to_json(e)) for e in ref_entries]
    for saver, loader in ((PORT, REF), (REF, PORT)):
        path = str(tmp_path / f"{saver.name}.json")
        entries = ref_entries if saver is REF else pt_entries
        assert saver.canary.save_corpus(path, entries) == len(entries)
        back = loader.canary.load_corpus(path)
        assert [loader.canary.entry_to_json(e) for e in back] == \
            [saver.canary.entry_to_json(e) for e in entries]
        for e, b in zip(entries, back):
            eb, bb = e.bag(), b.bag()
            assert {n: eb.get(n) for n in eb.names()} == \
                {n: bb.get(n) for n in bb.names()}
    bad = tmp_path / "v2.json"
    bad.write_text(json.dumps({"version": 2, "entries": []}))
    ref, port = both(lambda p: outcome(
        lambda: p.canary.load_corpus(str(bad))))
    assert port == ref and port[0] == "ValueError"


# ---------------------------------------------------------------------------
# the three seeded pairs on a CPU server of each package
# ---------------------------------------------------------------------------

SEED = 20


def _swap(p, store, old_docs, new_docs) -> None:
    old_keys = {k for k, _ in old_docs}
    new_keys = {k for k, _ in new_docs}
    events = [p.Event(k, None) for k in old_keys - new_keys]
    events += [p.Event(k, dict(s)) for k, s in new_docs]
    # no watcher delivery: the test rebuilds explicitly, and a debounced
    # background rebuild would race it
    store.apply_events(events, notify=False)


def _served(p, srv, bags) -> list:
    out = []
    for lo in range(0, len(bags), BUCKETS[-1]):
        chunk = bags[lo:lo + BUCKETS[-1]]
        out.extend(p.serve(srv, p.pad(chunk, BUCKETS))[:len(chunk)])
    return [(r.status_code, r.valid_duration_s, r.valid_use_count,
             r.deny_rule) for r in out]


def _pair_server(p, pair, mode):
    store = p.MemStore()
    store.apply_events([p.Event(k, dict(s)) for k, s in pair.base_docs],
                       notify=False)
    srv = p.server(store, batch_window_s=0.0005, max_batch=BUCKETS[-1],
                   buckets=BUCKETS, canary=mode, rulestats_drain_s=0,
                   default_manifest=p.corpus.ANALYZER_MANIFEST,
                   **p.server_args)
    return srv, store


def _gate_leg(p, pair):
    srv, store = _pair_server(p, pair, "gate")
    try:
        bags = [p.bag(d) for d in p.corpus.make_canary_traffic(pair, SEED)]
        out = {"served": _served(p, srv, bags),
               "corpus": [entry_view(p, e)
                          for e in srv.canary.recorder.corpus()]}
        d0 = srv.controller.dispatcher
        _swap(p, store, pair.base_docs, pair.divergent_docs)
        d1, out["divergent_families"] = family_delta(
            p, srv.controller.rebuild)
        rej = srv.controller.last_canary_rejection
        out["vetoed"] = d1 is d0
        out["rejection"] = (type(rej).__name__, str(rej),
                            report_view(rej.report))
        out["after_veto"] = _served(p, srv, bags)
        out["serving_after_veto"] = srv.controller.dispatcher is d0
        _swap(p, store, pair.divergent_docs, pair.identical_docs)
        d2, out["identical_families"] = family_delta(
            p, srv.controller.rebuild)
        out["identical_published"] = d2 is not d0
        out["identical_report"] = report_view(srv.canary.reports()[-1])
        out["rejection_cleared"] = \
            srv.controller.last_canary_rejection is None
        out["after_identical"] = _served(p, srv, bags)
        snap = srv.canary.snapshot()
        out["snapshot"] = {k: v for k, v in snap.items() if k != "reports"}
        out["snapshot_reports"] = [
            {k: v for k, v in r.items()
             if k not in ("replay_rows_per_s", "replay_wall_s",
                          "per_rule")} for r in snap["reports"]]
        return out
    finally:
        srv.close()


def _warn_leg(p, pair):
    srv, store = _pair_server(p, pair, "warn")
    try:
        bags = [p.bag(d) for d in p.corpus.make_canary_traffic(pair, SEED)]
        _served(p, srv, bags)
        d0 = srv.controller.dispatcher
        _swap(p, store, pair.base_docs, pair.divergent_docs)
        d1 = srv.controller.rebuild()
        out = {"published": d1 is not d0,
               "report": report_view(srv.canary.reports()[-1]),
               "entries_after_publish":
                   srv.canary.recorder.stats()["entries"]}
        # an empty ring abstains; refilled under the live (divergent)
        # config, a rebuild of that same config replays it with no
        # divergence; the base semantics then diverge again on the
        # planted rule
        n_reports = len(srv.canary.reports())
        srv.controller.rebuild()
        out["abstained"] = len(srv.canary.reports()) == n_reports
        out["served"] = _served(p, srv, bags)
        d2 = srv.controller.rebuild()
        out["same_published"] = d2 is not d1
        out["same_report"] = report_view(srv.canary.reports()[-1])
        _swap(p, store, pair.divergent_docs, pair.identical_docs)
        srv.controller.rebuild()
        out["base_again_report"] = report_view(srv.canary.reports()[-1])
        return out
    finally:
        srv.close()


@pytest.mark.parametrize("index", range(3))
def test_seeded_pair_reports_equal_the_reference(index):
    pairs = {p.name: p.corpus.make_canary_snapshot_pairs(SEED)[index]
             for p in (REF, PORT)}
    ref, port = both(lambda p: {"gate": _gate_leg(p, pairs[p.name]),
                                "warn": _warn_leg(p, pairs[p.name])})
    assert port == ref
    pair = pairs["port"]
    g, w = port["gate"], port["warn"]
    assert g["vetoed"] and g["serving_after_veto"]
    name, _msg, rep = g["rejection"]
    assert name == "CanaryRejected" and rep["verdict"] == "veto"
    c = rep["per_rule"][pair.divergent_rule]
    assert c[pair.expected] >= 1
    assert all(ex.get("oracle_confirmed") is True
               for ex in c["exemplars"] if ex["kind"] == "status_flip")
    assert g["after_veto"] == g["served"]
    assert g["identical_published"] and g["rejection_cleared"]
    assert g["identical_report"]["verdict"] == "publish"
    assert g["identical_report"]["n_divergent"] == 0
    assert g["divergent_families"]["errors"] == 0
    assert w["published"] and w["report"]["verdict"] == "warn"
    assert pair.divergent_rule in w["report"]["per_rule"]
    assert w["entries_after_publish"] == 0 and w["abstained"]
    assert w["same_published"]
    assert w["same_report"]["verdict"] == "publish"
    assert w["same_report"]["n_divergent"] == 0
    assert w["base_again_report"]["verdict"] == "warn"
    assert pair.divergent_rule in w["base_again_report"]["per_rule"]


def test_canary_pairs_and_manifest_equal_the_reference():
    for seed in (0, SEED, 99):
        ref_pairs = ref_corpus.make_canary_snapshot_pairs(seed)
        pt_pairs = pt_corpus.make_canary_snapshot_pairs(seed)
        assert [dataclasses.asdict(x) for x in pt_pairs] == \
            [dataclasses.asdict(x) for x in ref_pairs]
        for rp, pp in zip(ref_pairs, pt_pairs):
            assert pt_corpus.make_canary_traffic(pp, seed) == \
                ref_corpus.make_canary_traffic(rp, seed)
    assert {k: v.name for k, v in pt_corpus.ANALYZER_MANIFEST.items()} == \
        {k: v.name for k, v in ref_corpus.ANALYZER_MANIFEST.items()}


# ---------------------------------------------------------------------------
# the port's own contracts
# ---------------------------------------------------------------------------

def _quota_docs(docs, max_amount):
    """docs with the memquota handler's limit set to max_amount."""
    out = []
    for key, spec in docs:
        if key == ("handler", "istio-system", "mq"):
            spec = {"adapter": "memquota", "params": {"quotas": [
                {"name": "rq.istio-system", "max_amount": max_amount,
                 "valid_duration_s": 600.0}]}}
        out.append((key, spec))
    return out


def test_veto_leaves_handlers_quota_pools_and_dispatcher_untouched():
    """The divergent candidate also changes the memquota handler's limit,
    so a publish would build a new handler and a new device pool and
    orphan the old ones. Vetoed, it leaves all of them as they were: the
    same device_quotas object with the same pool and counts, the same
    handler table, the same dispatcher; quota() and the fused quota path
    answer on the old limit, and quota() equals the reference's."""
    def run(p):
        pair = p.corpus.make_canary_snapshot_pairs(SEED)[0]
        base = _quota_docs(pair.base_docs, 5)
        divergent = _quota_docs(pair.divergent_docs, 1 << 20)
        srv, store = _pair_server(p, dataclasses.replace(
            pair, base_docs=base), "gate")
        try:
            bags = [p.bag(d)
                    for d in p.corpus.make_canary_traffic(pair, SEED)]
            _served(p, srv, bags)
            # the request addressed to the quota rule's service
            rules = [s for k, s in base if k[0] == "rule"]
            quota_bag = bags[next(
                i for i, s in enumerate(rules)
                if any(a["handler"] == "mq.istio-system"
                       for a in s["actions"]))]
            grants = [srv.quota(quota_bag, "rq.istio-system",
                                p.QuotaArgs(quota_amount=2))
                      for _ in range(2)]
            ctl = srv.controller
            state = (ctl.dispatcher, ctl.device_quotas,
                     dict(ctl.device_quotas),
                     dict(ctl._handler_table._by_sig),
                     dict(ctl.dispatcher.handlers))
            counts = {q: pool.counts.clone()
                      for q, pool in ctl.device_quotas.items()} \
                if p is PORT else None
            _swap(p, store, base, divergent)
            ctl.rebuild()
            vetoed = ctl.last_canary_rejection is not None
            after = (ctl.dispatcher, ctl.device_quotas,
                     dict(ctl.device_quotas),
                     dict(ctl._handler_table._by_sig),
                     dict(ctl.dispatcher.handlers))
            same = [a is b or a == b for a, b in zip(after, state)]
            if p is PORT:
                same.append(all(
                    torch.equal(pool.counts, counts[q])
                    for q, pool in ctl.device_quotas.items()))
                same.append(not any(pool._closed for pool in
                                    ctl.device_quotas.values()))
            grants += [srv.quota(quota_bag, "rq.istio-system",
                                 p.QuotaArgs(quota_amount=2))
                       for _ in range(2)]
            return vetoed, same, [(g.status_code, g.granted_amount,
                                   g.valid_duration_s) for g in grants]
        finally:
            srv.close()

    ref, port = both(run)
    assert port[0] and all(port[1]), port[1]
    assert ref[0] and all(ref[1]), ref[1]
    assert port[2] == ref[2]
    # the old limit of 5 still holds: 2 + 2, then 1 of 2, then none
    assert [g[1] for g in port[2]] == [2, 2, 1, 0]


def test_cpu_server_canary_fails_open_like_the_reference(monkeypatch):
    """A replay that raises on a CPU server publishes the candidate
    without validation and counts mixer_canary_errors_total, on both
    packages (the reference's fail-open)."""
    def run(p):
        pair = p.corpus.make_canary_snapshot_pairs(SEED)[0]
        srv, store = _pair_server(p, pair, "gate")
        try:
            assert getattr(srv.canary, "strict", False) is False
            bags = [p.bag(d)
                    for d in p.corpus.make_canary_traffic(pair, SEED)]
            _served(p, srv, bags)
            d0 = srv.controller.dispatcher
            monkeypatch.setattr(
                p.gate, "replay_entries",
                lambda *a, **k: (_ for _ in ()).throw(
                    RuntimeError("kernel launch failed")))
            _swap(p, store, pair.base_docs, pair.divergent_docs)
            d1, fams = family_delta(p, srv.controller.rebuild)
            return d1 is not d0, srv.canary.reports(), fams
        finally:
            srv.close()

    ref, port = both(run)
    assert port == ref
    published, reports, fams = port
    assert published and reports == [] and fams["errors"] == 1


def test_strict_canary_raises_a_replay_fault_chaos_did_not_inject(
        monkeypatch):
    """A strict canary (what RuntimeServer builds for a CUDA device): a
    replay device fault that CHAOS did not inject raises out of
    Controller.rebuild(), logged at ERROR, with nothing published and
    mixer_canary_errors_total unchanged. A fault CHAOS injected (marked
    chaos_injected) still fails open, and so do host-stage faults."""
    pair = pt_corpus.make_canary_snapshot_pairs(SEED)[0]
    srv, store = _pair_server(PORT, pair, "gate")
    try:
        assert srv.canary.strict is False     # a CPU server
        srv.canary.strict = True              # as a CUDA server builds it
        bags = [bag_from_mapping(d)
                for d in pt_corpus.make_canary_traffic(pair, SEED)]
        _served(PORT, srv, bags)
        ctl = srv.controller
        d0, quotas0 = ctl.dispatcher, ctl.device_quotas

        def failing(*a, **k):
            raise RuntimeError("rule_match: CUDA error: an illegal "
                               "memory access was encountered")

        monkeypatch.setattr(pt_gate, "replay_entries", failing)
        _swap(PORT, store, pair.base_docs, pair.identical_docs)
        before = families(PORT)
        records: list = []
        seen = logging.Handler(logging.ERROR)
        seen.emit = records.append
        gate_log = logging.getLogger("istio_tpu_torch.canary.gate")
        gate_log.addHandler(seen)
        try:
            with pytest.raises(RuntimeError, match="illegal memory"):
                ctl.rebuild()
        finally:
            gate_log.removeHandler(seen)
        assert ctl.dispatcher is d0 and ctl.device_quotas is quotas0
        after = families(PORT)
        # the publish delay is observed whatever the outcome
        assert after.pop("delay_n") == before.pop("delay_n") + 1
        assert after == before
        assert any(r.levelno == logging.ERROR and "strict canary" in
                   r.getMessage() for r in records)
        # the old dispatcher serves on, unchanged
        assert _served(PORT, srv, bags) == _served(PORT, srv, bags)

        def injected(*a, **k):
            err = RuntimeError("chaos: injected device failure")
            err.chaos_injected = True
            raise err

        monkeypatch.setattr(pt_gate, "replay_entries", injected)
        d1, fams = family_delta(PORT, ctl.rebuild)
        assert d1 is not d0 and fams["errors"] == 1
        # a host-stage fault (the diff) fails open on a strict canary too
        monkeypatch.undo()
        monkeypatch.setattr(
            pt_gate, "diff_decisions",
            lambda *a, **k: (_ for _ in ()).throw(ValueError("diff")))
        _served(PORT, srv, bags)
        _swap(PORT, store, pair.identical_docs, pair.base_docs)
        d2, fams = family_delta(PORT, ctl.rebuild)
        assert d2 is not d1 and fams["errors"] == 1
    finally:
        srv.close()
        CHAOS.reset()


def test_canary_fields_are_carried():
    """The six canary fields are carried (no NotPorted), the default
    builds no canary, and a canary server's dispatchers tap its
    recorder."""
    from istio_tpu_torch.runtime.server import CARRIED_ARGS

    fields = {"canary", "canary_capacity", "canary_sample_every",
              "canary_replay_limit", "canary_max_divergence",
              "canary_waivers"}
    assert fields <= CARRIED_ARGS
    store = MemStore()
    srv = _pt_server(store, rulestats_drain_s=0)
    try:
        assert srv.canary is None
        assert srv.controller.dispatcher.recorder is None
    finally:
        srv.close()
    srv = _pt_server(store, rulestats_drain_s=0, canary="warn",
                     canary_capacity=5, canary_sample_every=2,
                     canary_replay_limit=3, canary_max_divergence=0.25,
                     canary_waivers=("ns/r",))
    try:
        cfg = srv.canary.config
        assert (cfg.mode, cfg.capacity, cfg.sample_every, cfg.replay_limit,
                cfg.max_divergence_rate, cfg.waivers) == \
            ("warn", 5, 2, 3, 0.25, ("ns/r",))
        assert srv.controller.dispatcher.recorder is srv.canary.recorder
        assert srv.controller.canary is srv.canary
    finally:
        srv.close()
