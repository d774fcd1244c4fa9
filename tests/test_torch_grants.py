"""The port's check-cache grants (runtime/grants.py) against the JAX
package's.

The two policy tests of tests/test_cache_grants.py run on both packages
with both grant modules' clocks frozen together (each module reads
`time.monotonic()` on its module-level `time`, which the fixture swaps
for one shared manual clock), so every TTL and use count is exact and
equal. Then a RuntimeServer of each package with `check_grants=True`:
the served TTLs of an allow and of a deny clamped into [floor, cap],
the grant fold of the host-oracle and generic paths, and revocation
before the swap on a store delete (the grant policy revokes while the
old dispatcher is still the served one, and the first response of the
new generation carries the floor). The client-cache hit rate of
test_cache_grants.py needs the Mixer client, which is not ported.
"""
import time

import pytest

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import Event as RefEvent
from istio_tpu.runtime import MemStore as RefMemStore
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime import grants as ref_grants

from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.runtime import (Event, MemStore, RuntimeServer,
                                     ServerArgs)
from istio_tpu_torch.runtime import grants

OK, PERMISSION_DENIED = 0, 7
DENY_PATH = {"destination.service": "web.prod.svc.cluster.local",
             "request.path": "/admin/keys"}
OPEN_PATH = {"destination.service": "web.prod.svc.cluster.local",
             "request.path": "/api/items"}
GRANT_ARGS = dict(check_grants=True, grant_ttl_floor_s=0.3,
                  grant_ttl_cap_s=1.2, grant_ttl_ramp_per_s=2.0)


class Clock:
    """One manual monotonic clock for both grant modules."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(ref_grants, "time", c)
    monkeypatch.setattr(grants, "time", c)
    return c


PACKAGES = (("ref", ref_grants.GrantPolicy),
            ("port", grants.GrantPolicy))


def _store(kind, event):
    """test_cache_grants.py's store, written without notifying watchers:
    a delivery that reached the server's watch after its first build
    would publish a second generation at a moment the test does not
    choose."""
    s = kind()
    s.apply_events([
        event(("handler", "istio-system", "denyadmin"), {
            "adapter": "denier",
            "params": {"status_code": PERMISSION_DENIED,
                       "status_message": "admin is off limits",
                       "valid_duration_s": 600.0,
                       "valid_use_count": 100000}}),
        event(("instance", "istio-system", "nothing"), {
            "template": "checknothing", "params": {}}),
        event(("rule", "istio-system", "r-deny"), {
            "match": 'request.path.startsWith("/admin")',
            "actions": [{"handler": "denyadmin",
                         "instances": ["nothing"]}]})], notify=False)
    return s


def _servers(**kw):
    """A server of each package over _store(), warmed at its one bucket
    (the reference's JAX compile stays out of every served call)."""
    args = dict(batch_window_s=0.001, max_batch=8, buckets=(8,),
                initial_prewarm=False, rulestats_drain_s=0, **kw)
    ref = RefServer(_store(RefMemStore, RefEvent),
                    RefArgs(audit=False, **args))
    port = RuntimeServer(_store(MemStore, Event), ServerArgs(**args),
                         device="cpu")
    for srv in (ref, port):
        plan = srv.controller.dispatcher.fused
        if plan is not None:
            plan.prewarm((8,))
    return {"ref": (ref, ref_bag), "port": (port, bag_from_mapping)}


def _close(servers) -> None:
    for srv, _ in servers.values():
        store = srv.controller.store
        srv.close()
        store.close()


def fields(r) -> tuple:
    return (r.status_code, r.status_message, r.valid_duration_s,
            r.valid_use_count)


# ---------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------

def test_policy_floor_ramp_cap_and_quantum(clock):
    out = {}
    for name, Policy in PACKAGES:
        p = Policy(ttl_floor_s=1.0, ttl_cap_s=5.0, ttl_ramp_per_s=2.0,
                   quantum_s=0.0)
        seen = [p.grant("ns1")]
        clock.t += 10.0
        seen.append(p.grant("ns1"))
        clock.t += 0.37
        seen.append(p.grant("ns2"))
        clock.t -= 10.37
        # quantization: ages inside one quantum give identical grants
        q = Policy(quantum_s=0.5)
        clock.t += 0.2
        a = q.grant("x")
        clock.t += 0.2
        seen += [a, q.grant("x")]
        clock.t += 0.2
        seen.append(q.grant("x"))
        clock.t -= 0.6
        seen.append(q.grants_for(["x", "y", "x"]))
        out[name] = seen
    assert out["ref"] == out["port"]
    seen = out["port"]
    assert seen[0] == (1.0, 64)
    assert seen[1] == (5.0, 10_000) == seen[2]
    assert seen[3] == seen[4] == (1.0, 64)
    assert seen[5] == (1.25, 576)
    assert seen[6] == [(1.0, 64)] * 3


def test_policy_per_namespace_revocation(clock):
    out = {}
    for name, Policy in PACKAGES:
        p = Policy(ttl_floor_s=1.0, ttl_cap_s=5.0, ttl_ramp_per_s=2.0,
                   quantum_s=0.0)
        clock.t += 100.0
        seen = [p.grant("a"), p.grant("b")]
        p.on_publish({"a"})         # the delta touched only namespace a
        seen += [p.grant("a"), p.grant("b")]
        clock.t += 1.0
        seen += [p.grant("a"), p.grant("b")]
        p.on_publish(None)          # unattributed publish: revoke all
        seen += [p.grant("b"), p.generation, p.watermark()]
        st = p.stats()
        seen += [st["revocations"], st["grants_issued"], st["ns_ages_s"],
                 st["global_age_s"]]
        clock.t -= 101.0
        out[name] = seen
    assert out["ref"] == out["port"]
    seen = out["port"]
    assert seen[:2] == [(5.0, 10_000)] * 2
    assert seen[2] == (1.0, 64) and seen[3] == (5.0, 10_000)
    assert seen[4] == (3.0, 1088)
    assert seen[6] == (1.0, 64) and seen[7] == 2
    assert seen[8] == {"generation": 2, "revocations": 2,
                       "grants_issued": 7, "issued_at_generation": 2}
    assert seen[9] == 2 and seen[10] == 7 and seen[11] == {}
    assert seen[12] == 0.0


# ---------------------------------------------------------------------
# served grants on RuntimeServer
# ---------------------------------------------------------------------

def test_serving_emits_grant_clamped_ttls(clock):
    """Allow and deny TTLs clamped into [floor, cap]: at the floor right
    after the publish, on the ramp, and at the cap (the denier's 600 s
    too: a cached DENY must be revocable)."""
    servers = _servers(**GRANT_ARGS)
    try:
        out = {}
        for name, (srv, mk) in servers.items():
            t0 = clock.t
            seen = [srv.grants.generation,
                    fields(srv.check(mk(dict(OPEN_PATH)))),
                    fields(srv.check(mk(dict(DENY_PATH))))]
            clock.t += 0.3           # inside the first quantum
            seen.append(fields(srv.check(mk(dict(OPEN_PATH)))))
            clock.t += 0.2           # one quantum: 0.3 + 0.5 x 2 > cap
            seen += [fields(r) for r in srv.check_many(
                [mk(dict(OPEN_PATH)), mk(dict(DENY_PATH))])]
            clock.t = t0
            out[name] = seen
        assert out["ref"] == out["port"]
        gen, allow0, deny0, allow1, allow2, deny2 = out["port"]
        assert gen == 1
        assert allow0 == (OK, "", 0.3, 64) == allow1
        assert deny0[0] == PERMISSION_DENIED and deny0[2:] == (0.3, 64)
        assert allow2 == (OK, "", 1.2, 576)
        assert deny2[0] == PERMISSION_DENIED and deny2[2:] == (1.2, 576)
    finally:
        _close(servers)


def test_host_oracle_and_generic_paths_fold_grants(clock):
    """The host-oracle path and the generic (fused=False) path fold the
    grant too, per bag."""
    out = {}
    for fused in (True, False):
        servers = _servers(fused=fused, **GRANT_ARGS)
        try:
            for name, (srv, mk) in servers.items():
                d = srv.controller.dispatcher
                bags = [mk(dict(OPEN_PATH)), mk(dict(DENY_PATH))]
                clock.t += 0.5
                got = [fields(r) for r in d.check_host_oracle(bags)]
                got += [fields(r) for r in d.check(bags)]
                clock.t -= 0.5
                out.setdefault(name, []).append(got)
        finally:
            _close(servers)
    assert out["ref"] == out["port"]
    for got in out["port"]:
        assert [g[2:] for g in got] == [(1.2, 576)] * 4
        assert [g[0] for g in got] == [OK, PERMISSION_DENIED] * 2


def test_delta_revokes_before_the_swap(clock):
    """A store delete flips a DENY to OK. The grant policy revokes while
    the old dispatcher is still the served one (revoke before swap), the
    generation grows once, and the first responses of the new generation
    carry the TTL floor, then ramp from the publish."""
    servers = _servers(**GRANT_ARGS)
    try:
        out = {}
        for name, (srv, mk) in servers.items():
            clock.t += 10.0          # a long-stable config: at the cap
            before = [fields(srv.check(mk(dict(DENY_PATH))))]
            g = srv.grants
            old = srv.controller.dispatcher
            at_revoke = []
            real = g.on_publish

            def spy(changed=None, _real=real, _srv=srv):
                at_revoke.append(_srv.controller._dispatcher)
                _real(changed)

            g.on_publish = spy
            gen0 = g.generation
            rev0 = old.snapshot.revision
            srv.controller.store.delete(("rule", "istio-system", "r-deny"))
            end = time.time() + 30.0
            while time.time() < end and \
                    srv.controller.dispatcher.snapshot.revision == rev0:
                time.sleep(0.01)
            seen = [len(at_revoke), at_revoke[0] is old,
                    g.generation - gen0,
                    srv.controller.dispatcher is not old]
            seen += [fields(srv.check(mk(dict(DENY_PATH)))),
                     fields(srv.check(mk(dict(OPEN_PATH))))]
            clock.t += 0.5
            seen.append(fields(srv.check(mk(dict(DENY_PATH)))))
            clock.t -= 10.5
            g.on_publish = real
            out[name] = before + seen
        assert out["ref"] == out["port"]
        got = out["port"]
        assert got[0][0] == PERMISSION_DENIED and got[0][2:] == (1.2, 10_000)
        assert got[1:5] == [1, True, 1, True]
        assert got[5] == got[6] == (OK, "", 0.3, 64)
        assert got[7] == (OK, "", 1.2, 576)
    finally:
        _close(servers)
