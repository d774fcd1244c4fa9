"""The port's Quota() path against the JAX package's, on the CPU (the
plain version of the quota_alloc kernel, K9):

  * every mode of make_rolling_alloc_step and make_alloc_step against
    the reference's (jit=False) on tests/test_device_quota.py's
    scenarios — contention, adversarial, negative and over-domain
    amounts, a shrunken limit, same-amount ties at the budget boundary,
    rolling and exact rows mixed, ticks - last of 0, 1, K and more, K = 1
    — and on 32,768 zipf(1.3) rows over a 100,000-key pool, the batch
    the kernel's multi-block path took on the card before its cluster
    path, and on 8,193 and 16,384 zipf rows whose hottest run crosses
    every seam of the cluster path, in unit, seg and gated seg — grants
    and the whole counter plane equal;
  * DeviceQuotaPool against the reference pool under an injected clock
    (contention, burst, dedup replay within and across windows, rolling
    reclaim, full expiry, keyspace exhaustion, alloc after close);
  * RuntimeServer.quota_fused / quota against the reference server;
  * tests/test_quota_instep.py's in-step scenarios, the port's in-step
    results equal to the reference's and the port's classic path's, and
    the one pulled array byte-equal to the reference's;
  * an aborted in-step trip restoring the counter plane.

Every value is an int: the tolerance is exact equality."""
import itertools

import numpy as np
import pytest
import torch

from istio_tpu.adapters.sdk import QuotaArgs as RefArgs
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.models import quota_alloc as ref_qa
from istio_tpu.runtime import MemStore as RefStore
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefServerArgs
from istio_tpu.runtime.device_quota import DeviceQuotaPool as RefPool

from istio_tpu_torch import interop, kernels
from istio_tpu_torch.adapters.sdk import QuotaArgs
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.models import quota_alloc as qa
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.runtime.device_quota import DeviceQuotaPool

OK, RESOURCE_EXHAUSTED, INTERNAL, UNAVAILABLE = 0, 8, 13, 14
INT32_MAX = int(np.iinfo(np.int32).max)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- kernel

def _rolling_batch(rng, n_buckets, k, b, amounts):
    """A contended rolling batch: per-bucket max / tick / last / rolling
    (rows of one bucket agree, as the pool stages them)."""
    buckets = rng.integers(0, n_buckets, b).astype(np.int32)
    mx = np.take(rng.integers(4, 30, n_buckets).astype(np.int32), buckets)
    ticks = np.take(rng.integers(0, 3 * k, n_buckets).astype(np.int32),
                    buckets)
    lasts = np.take(rng.integers(-k, 3 * k, n_buckets).astype(np.int32),
                    buckets)
    rolling = np.take(rng.random(n_buckets) < 0.7, buckets)
    slots = rng.integers(0, 3, (n_buckets, k)).astype(np.int32)
    return [slots, buckets, amounts.astype(np.int32), rng.random(b) < 0.4,
            mx, rng.random(b) < 0.9, ticks, lasts, rolling]


def _scenario(name: str, seed: int):
    """→ (n_buckets, k, args, modes): the reference test scenarios."""
    rng = np.random.default_rng(seed)
    k = 10
    if name == "contended":
        a = _rolling_batch(rng, 12, k, 256, rng.integers(0, 6, 256))
        return 12, k, a, ("scan", "seg")
    if name == "unit":
        a = _rolling_batch(rng, 16, k, 256, np.ones(256))
        return 16, k, a, ("scan", "unit", "seg")
    if name == "ragged":          # B = 777, above the pool's 512 pad
        a = _rolling_batch(rng, 40, k, 777, rng.integers(-1, 9, 777))
        return 40, k, a, ("scan", "seg")
    if name == "ragged_unit":
        a = _rolling_batch(rng, 40, k, 777, np.ones(777))
        return 40, k, a, ("scan", "unit")
    if name == "single_row":      # B = 1
        a = _rolling_batch(rng, 4, k, 1, np.array([3]))
        return 4, k, a, ("scan", "fast", "unit", "seg")
    if name == "unique":          # distinct active buckets: fast
        a = _rolling_batch(rng, 512, k, 128, rng.integers(-1, 9, 128))
        a[1] = rng.permutation(512)[:128].astype(np.int32)
        return 512, k, a, ("scan", "fast", "seg")
    if name == "unique_512":
        a = _rolling_batch(rng, 4096, k, 512, rng.integers(0, 9, 512))
        a[1] = rng.permutation(4096)[:512].astype(np.int32)
        return 4096, k, a, ("scan", "fast", "seg")
    if name == "negative":        # never granted, never drains
        slots = np.zeros((8, k), np.int32)
        slots[2, 0] = 5
        z = np.zeros(2, np.int32)
        a = [slots, np.array([2, 2], np.int32),
             np.array([-100, -100], np.int32), np.array([False, True]),
             np.full(2, 10, np.int32), np.ones(2, bool), z, z,
             np.zeros(2, bool)]
        return 8, k, a, ("scan", "fast", "seg")
    if name in ("adversarial", "adversarial_be", "over_then_legit",
                "shrunken"):
        slots = np.zeros((4, k), np.int32)
        big = 1_500_000_000
        amounts = np.array([big, big, 5], np.int32)
        be = np.array([False, False, True])
        if name == "adversarial_be":
            be = np.ones(3, bool)
        if name == "over_then_legit":
            amounts, be = np.array([big, 7, 2], np.int32), np.zeros(3, bool)
        if name == "shrunken":    # used > max: nothing granted
            slots[1, 0] = INT32_MAX - 3
            amounts = np.array([3, 2, qa.DOMAIN_MAX], np.int32)
            be = np.array([False, True, True])
        z = np.zeros(3, np.int32)
        a = [slots, np.array([1, 1, 1], np.int32), amounts, be,
             np.full(3, 10, np.int32), np.ones(3, bool), z, z,
             np.zeros(3, bool)]
        return 4, k, a, ("scan", "seg")
    if name == "ties":            # same-amount rows at the boundary
        b = 64
        buckets = rng.integers(0, 3, b).astype(np.int32)
        amounts = rng.choice([2, 3, 3, 3], b).astype(np.int32)
        slots = np.zeros((3, k), np.int32)
        slots[:, 4] = 7
        z = np.zeros(b, np.int32)
        a = [slots, buckets, amounts, rng.random(b) < 0.3,
             np.full(b, 40, np.int32), rng.random(b) < 0.95, z, z,
             np.zeros(b, bool)]
        return 3, k, a, ("scan", "seg")
    if name == "ticks":           # ticks - last of 0, 1, K, > K, < 0
        n = 8
        buckets = np.arange(n, dtype=np.int32)
        ticks = np.array([5, 5, 15, 40, 3, 7, 9, 12], np.int32)
        lasts = np.array([5, 4, 5, 5, 6, -2, 9, 11], np.int32)
        rolling = np.array([1, 1, 1, 1, 1, 0, 1, 0], bool)
        slots = rng.integers(1, 4, (n, k)).astype(np.int32)
        a = [slots, buckets, rng.integers(1, 8, n).astype(np.int32),
             rng.random(n) < 0.5, np.full(n, 20, np.int32),
             np.ones(n, bool), ticks, lasts, rolling]
        return n, k, a, ("scan", "fast", "seg")
    if name == "k1":              # K = 1: the fixed-counter plane
        b = 96
        buckets = rng.integers(0, 6, b).astype(np.int32)
        z = np.zeros(b, np.int32)
        a = [rng.integers(0, 5, (6, 1)).astype(np.int32), buckets,
             rng.integers(-1, 6, b).astype(np.int32), rng.random(b) < 0.5,
             np.full(b, 12, np.int32), rng.random(b) < 0.9, z, z,
             np.zeros(b, bool)]
        return 6, 1, a, ("scan", "seg")
    if name in ("zipf_32768", "zipf_unit_32768"):
        # the multi-block kernel's batch: zipf(1.3) keys over a 100,000-
        # key pool, so the hot keys' runs span many of its scan tiles
        b, n = 32768, 100_000
        amounts = np.ones(b) if name == "zipf_unit_32768" else \
            rng.integers(-1, 6, b)
        a = _rolling_batch(rng, n, k, b, amounts)
        a[1] = ((rng.zipf(1.3, b) - 1) % n).astype(np.int32)
        # per-bucket max / tick / last / rolling follow the keys
        a[4] = np.take(rng.integers(40, 400, n), a[1]).astype(np.int32)
        for j in (6, 7):
            a[j] = np.take(rng.integers(0, 3 * k, n), a[1]).astype(np.int32)
        a[8] = np.take(rng.random(n) < 0.7, a[1])
        return n, k, a, (("scan", "unit", "seg") if name.startswith(
            "zipf_unit") else ("scan", "seg"))
    raise KeyError(name)


SCENARIOS = [("contended", s) for s in range(4)] + [
    ("unit", 7), ("ragged", 5), ("ragged_unit", 6), ("single_row", 1),
    ("unique", 3), ("unique_512", 4), ("negative", 0), ("adversarial", 0),
    ("adversarial_be", 0), ("over_then_legit", 0), ("shrunken", 0),
    ("ties", 11), ("ties", 12), ("ticks", 2), ("k1", 9),
    ("zipf_32768", 13), ("zipf_unit_32768", 14)]
CASES = [(name, seed, mode) for name, seed in SCENARIOS
         for mode in _scenario(name, seed)[3]]


@pytest.mark.parametrize("name,seed,mode", CASES)
def test_rolling_mode_matches_reference(name, seed, mode):
    n_buckets, k, args, _ = _scenario(name, seed)
    i = ("scan", "fast", "unit", "seg").index(mode)
    ref = ref_qa.make_rolling_alloc_step(n_buckets, k, jit=False)[i]
    got = qa.make_rolling_alloc_step(n_buckets, k)[i]
    g_ref, s_ref = ref(*args)
    g, s = got(*(torch.from_numpy(np.asarray(x)) for x in args))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    # functional convention: the input plane is left as it was
    np.testing.assert_array_equal(np.asarray(args[0]), _scenario(
        name, seed)[2][0])
    assert g.dtype == torch.int32 and kernels.launches["quota_alloc"] == 0


def _seam_batch(b: int, seed: int, mode: str):
    """A contended batch of b zipf(1.3) rows over a 100,000-key pool whose
    hottest key is renamed to sit mid-order, so that in (bucket, row)
    order its run crosses every seam of the kernel's cluster path
    (positions j * ceil(b / c), c = ceil(b / 8192) blocks)."""
    rng = np.random.default_rng(seed)
    n, k = 100_000, 10
    amounts = np.ones(b) if mode == "unit" else rng.integers(-1, 6, b)
    a = _rolling_batch(rng, n, k, b, amounts)
    keys = ((rng.zipf(1.3, b) - 1) % n).astype(np.int64)
    hot = np.bincount(keys).argmax()
    others = np.sort(keys[keys != hot])
    count = int((keys == hot).sum())
    keys[keys == hot] = others[max(b // 2 - count // 2, 0)]
    a[1] = keys.astype(np.int32)
    a[4] = np.take(rng.integers(40, 400, n), a[1]).astype(np.int32)
    for j in (6, 7):
        a[j] = np.take(rng.integers(0, 3 * k, n), a[1]).astype(np.int32)
    a[8] = np.take(rng.random(n) < 0.7, a[1])
    live = np.where(a[5], a[1], INT32_MAX)
    order = np.sort(live, kind="stable")
    c = -(-b // 8192)
    for seam in range(-(-b // c), b, -(-b // c)):
        assert order[seam - 1] == order[seam], "no run crosses a seam"
    return n, k, a, rng


SEAM_CASES = list(itertools.product((8193, 16384), ("unit", "seg", "gate")))


@pytest.mark.parametrize("b,mode", SEAM_CASES)
def test_contended_batches_across_cluster_seams_match_reference(b, mode):
    import jax.numpy as jnp
    n, k, args, rng = _seam_batch(b, 20 + b % 7, mode)
    i = ("scan", "fast", "unit", "seg").index("seg" if mode == "gate"
                                              else mode)
    ref = ref_qa.make_rolling_alloc_step(n, k, jit=False)[i]
    t = [torch.from_numpy(np.asarray(x)) for x in args]
    ref_args = list(args)
    gate = None
    if mode == "gate":
        # runtime/fused.py:471-488 (packq): amounts gated on the verdict
        n_rules = 5
        status = np.where(rng.random(b) < 0.2, 7, 0).astype(np.int32)
        matched = rng.random((b, n_rules)) < 0.7
        rule_idx = rng.integers(-1, n_rules + 1, b).astype(np.int32)
        rule_ns = rng.integers(0, 3, n_rules).astype(np.int32)
        req_ns = rng.integers(-1, 3, b).astype(np.int32)
        safe = jnp.clip(rule_idx, 0, n_rules - 1)
        rn = jnp.asarray(rule_ns)[safe]
        want_gate = jnp.asarray(args[5]) & (rule_idx >= 0) & \
            ((rn == 0) | (rn == req_ns)) & (status == 0) & \
            jnp.asarray(matched)[jnp.arange(b), safe]
        ref_args[2] = np.asarray(jnp.where(want_gate, args[2], 0))
        gate = qa.QuotaGate(*(torch.from_numpy(x) for x in (
            status, matched, rule_idx, rule_ns, req_ns)), default_ns=0)
    g_ref, s_ref = ref(*ref_args)
    plane = t[0].clone()
    g, gated = qa.quota_alloc_plain("seg" if mode == "gate" else mode,
                                    plane, *t[1:], gate)
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(plane.numpy(), np.asarray(s_ref))
    if gate is not None:
        np.testing.assert_array_equal(gated.numpy(), np.asarray(want_gate))
    assert int(np.asarray(g_ref).sum()) > 0


@pytest.mark.parametrize("seed,mode", list(itertools.product(range(3),
                                                             ("scan",
                                                              "fast"))))
def test_fixed_counters_match_reference(seed, mode):
    rng = np.random.default_rng(seed)
    n_buckets = 32 if mode == "scan" else 512
    b = 256 if mode == "scan" else 128
    counts = rng.integers(0, 8, n_buckets).astype(np.int32)
    buckets = (rng.integers(0, n_buckets, b) if mode == "scan" else
               rng.permutation(n_buckets)[:b]).astype(np.int32)
    args = [counts, buckets, rng.integers(-1, 5, b).astype(np.int32),
            rng.random(b) < 0.5, np.full(b, 10, np.int32),
            rng.random(b) < 0.9]
    i = ("scan", "fast").index(mode)
    g_ref, c_ref = ref_qa.make_alloc_step(n_buckets, jit=False)[i](*args)
    g, c = qa.make_alloc_step(n_buckets)[i](
        *(torch.from_numpy(np.asarray(x)) for x in args))
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("op", ["add", "max"])
def test_seg_scan_matches_reference(op):
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    v = rng.integers(-2**31, 2**31 - 1, 300, dtype=np.int64).astype(np.int32)
    v[::7] = rng.integers(-5, 5, v[::7].shape[0])
    newseg = rng.random(300) < 0.2
    newseg[0] = True
    want = ref_qa.seg_scan(jnp.add if op == "add" else jnp.maximum,
                           jnp.asarray(v), jnp.asarray(newseg))
    got = qa.seg_scan(op, torch.from_numpy(v), torch.from_numpy(newseg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = rng.integers(0, 9, 300).astype(np.int32)
    np.testing.assert_array_equal(
        qa.batch_rank(torch.from_numpy(key)).numpy(),
        np.asarray(ref_qa.batch_rank(jnp.asarray(key))))


def test_alloc_wrapper_checks_its_arguments():
    slots = torch.zeros((4, 10), dtype=torch.int32)
    z = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        qa.quota_alloc("bogus", slots, z, z, z, z, z, z, z, z)
    with pytest.raises(ValueError):
        qa.quota_alloc("seg", slots, z, z, z, z, z, z, z, z,
                       granted=torch.zeros(2, dtype=torch.int32))
    gate = qa.QuotaGate(status=z, matched=torch.zeros((3, 1), dtype=bool),
                        rule_idx=z, rule_ns=torch.zeros(1, dtype=torch.int32),
                        req_ns=z, default_ns=0)
    with pytest.raises(ValueError):
        qa.quota_alloc("seg", slots, z, z, z, z, z, z, z, z, gate=gate)


# ---------------------------------------------------------------- pool

class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _pools(max_amount=10, duration=0.0, n_buckets=64, max_batch=64,
           window=0.0):
    clock = Clock()
    quotas = {"rq": {"name": "rq", "max_amount": max_amount,
                     "valid_duration_s": duration}}
    ref = RefPool(quotas, n_buckets=n_buckets, clock=clock,
                  batch_window_s=window, max_batch=max_batch, jit=False)
    got = DeviceQuotaPool(quotas, n_buckets=n_buckets, clock=clock,
                          batch_window_s=window, max_batch=max_batch,
                          device="cpu")
    return ref, got, clock


def _inst(dims):
    return {"name": "rq", "dimensions": dims}


def _same(got, want) -> None:
    assert (got.granted_amount, got.status_code, got.valid_duration_s,
            got.status_message) == \
        (want.granted_amount, want.status_code, want.valid_duration_s,
         want.status_message)


def _both(ref, got, dims, amount, be=True, dedup=""):
    r = ref.alloc("rq", _inst(dims), RefArgs(
        quota_amount=amount, best_effort=be, dedup_id=dedup)).result()
    g = got.alloc("rq", _inst(dims), QuotaArgs(
        quota_amount=amount, best_effort=be, dedup_id=dedup)).result()
    _same(g, r)
    return g.granted_amount


def _burst(ref, got, dims, args):
    """Submit a burst without waiting: with max_batch = len(args) and a
    long window it is exactly one flush on each pool."""
    rf = [ref.alloc("rq", _inst(dims), RefArgs(**a)) for a in args]
    gf = [got.alloc("rq", _inst(dims), QuotaArgs(**a)) for a in args]
    for r, g in zip(rf, gf):
        _same(g.result(), r.result())
    return [g.result().granted_amount for g in gf]


def _close(*pools):
    for p in pools:
        p.close()


def test_pool_contention_matches_reference():
    ref, got, clock = _pools(max_amount=10)
    try:
        rng = np.random.default_rng(11)
        for i in range(120):
            _both(ref, got, {"user": f"u{int(rng.integers(4))}"},
                  int(rng.integers(0, 5)), bool(rng.random() < 0.5),
                  f"d{i % 37}" if rng.random() < 0.3 else "")
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(ref.counts))
    finally:
        _close(ref, got)


@pytest.mark.parametrize("duration", [0.0, 10.0])
def test_pool_burst_matches_reference(duration):
    ref, got, clock = _pools(max_amount=6, duration=duration, max_batch=12,
                             window=5.0)
    try:
        args = [dict(quota_amount=2 + i % 3, best_effort=i % 2 == 0)
                for i in range(12)]
        assert sum(_burst(ref, got, {"k": "hot"}, args)) == 6
        ones = [dict(quota_amount=1, best_effort=i % 3 == 0)
                for i in range(12)]
        clock.t += 11.0
        _burst(ref, got, {"k": "hot"}, ones)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(ref.counts))
    finally:
        _close(ref, got)


def test_pool_dedup_replays_within_and_across_windows():
    ref, got, clock = _pools(max_amount=3, duration=10.0, max_batch=4,
                             window=5.0)
    try:
        # the same id twice in one flush: one consumption, one replay
        _burst(ref, got, {}, [dict(quota_amount=2, dedup_id="dup"),
                              dict(quota_amount=2, dedup_id="dup"),
                              dict(quota_amount=1),
                              dict(quota_amount=1, dedup_id="y")])
        for pool in (ref, got):    # single allocs from here on
            pool._window_s = 0.0
        # cache replays of a grant and of a denial, later in the window
        clock.t += 0.5
        _both(ref, got, {}, 2, dedup="dup")
        _both(ref, got, {}, 1, dedup="y")
        # past the dedup expiry and the window: a fresh consumption
        clock.t += 12.0
        assert _both(ref, got, {}, 2, dedup="dup") == 2
    finally:
        _close(ref, got)


def test_pool_rolling_reclaim_and_full_expiry():
    ref, got, clock = _pools(max_amount=10, duration=10.0)
    try:
        assert _both(ref, got, {}, 5) == 5
        clock.t += 5.0
        assert _both(ref, got, {}, 5) == 5
        clock.t += 6.0              # the first 5 rolled out
        assert _both(ref, got, {}, 10) == 5
        clock.t += 5.0
        assert _both(ref, got, {}, 10) == 5
        clock.t += 25.0             # everything left the window
        assert _both(ref, got, {}, 10, be=False) == 10
        assert _both(ref, got, {}, 1, be=False) == 0
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(ref.counts))
    finally:
        _close(ref, got)


def test_pool_keyspace_exhaustion_fails_closed():
    ref, got, clock = _pools(max_amount=5, n_buckets=4, max_batch=8)
    try:
        for i in range(4):
            assert _both(ref, got, {"k": f"u{i}"}, 1) == 1
        _both(ref, got, {"k": "u99"}, 1)
        r = got.alloc("rq", _inst({"k": "u98"}), QuotaArgs()).result()
        assert (r.granted_amount, r.status_code) == (0, RESOURCE_EXHAUSTED)
        assert got.audit_view()["n_used"] == 4
    finally:
        _close(ref, got)


def test_pool_alloc_after_close_and_unknown_name():
    ref, got, _ = _pools()
    _close(ref, got)
    _same(got.alloc("rq", _inst({}), QuotaArgs()).result(timeout=1.0),
          ref.alloc("rq", _inst({}), RefArgs()).result(timeout=1.0))
    assert got.alloc("rq", _inst({}), QuotaArgs()).result(
        timeout=1.0).status_code == UNAVAILABLE
    _same(got.alloc("nope", _inst({}), QuotaArgs()).result(),
          ref.alloc("nope", _inst({}), RefArgs()).result())


# ------------------------------------------------------- served wiring

QUOTA_STORE = [
    (("handler", "istio-system", "mq"), {
        "adapter": "memquota",
        "params": {"quotas": [{"name": "rq.istio-system",
                               "max_amount": 2}]}}),
    (("instance", "istio-system", "rq"), {
        "template": "quota",
        "params": {"dimensions": {"user": 'source.user | "anon"'}}}),
    (("rule", "istio-system", "qr"), {
        "match": 'request.path.startsWith("/metered")',
        "actions": [{"handler": "mq", "instances": ["rq"]}]}),
]

REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)


def _ref_store(entries) -> RefStore:
    s = RefStore()
    for key, spec in entries:
        s.set(key, spec)
    return s


def test_served_quota_fused_and_host_path_match_reference():
    ref = RefServer(_ref_store(QUOTA_STORE),
                    RefServerArgs(batch_window_s=0.001, **REF_ARGS))
    got = RuntimeServer(interop.store_from_reference(
        _ref_store(QUOTA_STORE)), ServerArgs(batch_window_s=0.001,
                                             initial_prewarm=False,
                                             rulestats_drain_s=0),
        device="cpu")
    try:
        assert got.controller.device_quotas
        cases = [{"request.path": "/metered/x", "source.user": "alice"},
                 {"request.path": "/open/x", "source.user": "alice"},
                 {"request.path": "/metered/x", "source.user": "bob"},
                 {"request.path": "/metered/y"}]
        for rnd in range(3):
            for c in cases:
                rb, gb = ref_bag(c), bag_from_mapping(c)
                rr = ref.check_many([rb])[0]
                gr = got.check_many([gb])[0]
                assert gr.active_quota_rules == rr.active_quota_rules
                want = ref.quota_fused(rb, "rq", RefArgs(quota_amount=1), rr)
                have = got.quota_fused(gb, "rq", QuotaArgs(quota_amount=1),
                                       gr)
                assert (want is None) == (have is None)
                if hasattr(want, "result"):
                    want, have = want.result(), have.result()
                _same(have, want)
                # the host path through the memquota adapter
                _same(got.quota(gb, "rq", QuotaArgs(quota_amount=rnd)),
                      ref.quota(rb, "rq", RefArgs(quota_amount=rnd)))
    finally:
        ref.close()
        got.close()


# -------------------------------------------------------------- in-step

def _instep_entries():
    return [
        (("handler", "istio-system", "mq"), {
            "adapter": "memquota",
            "params": {"quotas": [
                {"name": "rq.istio-system", "max_amount": 40,
                 "valid_duration_s": 10.0},
                {"name": "eq.istio-system", "max_amount": 10}]}}),
        (("instance", "istio-system", "rq"), {
            "template": "quota",
            "params": {"dimensions": {"user": 'source.user | "anon"'}}}),
        (("instance", "istio-system", "eq"), {
            "template": "quota",
            "params": {"dimensions": {"svc": "destination.service"}}}),
        (("rule", "istio-system", "rq-rule"), {
            "match": 'request.method == "GET"',
            "actions": [{"handler": "mq", "instances": ["rq"]}]}),
        (("rule", "istio-system", "eq-rule"), {
            "match": "",
            "actions": [{"handler": "mq", "instances": ["eq"]}]}),
    ]


DENY_ENTRIES = [
    (("handler", "istio-system", "deny"), {
        "adapter": "denier", "params": {"status_code": 7}}),
    (("instance", "istio-system", "nothing"), {
        "template": "checknothing", "params": {}}),
    (("rule", "istio-system", "deny-admin"), {
        "match": 'request.path.startsWith("/admin")',
        "actions": [{"handler": "deny", "instances": ["nothing"]}]}),
]


class World:
    """The same store served by the reference (in-step) and the port
    (in-step and classic), each pool on its own injected clock."""

    def __init__(self, entries):
        self.clocks = [Clock(100.0) for _ in range(3)]
        self.ref = RefServer(_ref_store(entries), RefServerArgs(
            fused=True, max_batch=8, buckets=(8,), quota_in_step=True,
            **REF_ARGS))
        self.got = RuntimeServer(
            interop.store_from_reference(_ref_store(entries)),
            ServerArgs(fused=True, max_batch=8, buckets=(8,),
                       quota_in_step=True, rulestats_drain_s=0),
            device="cpu")
        self.classic = RuntimeServer(
            interop.store_from_reference(_ref_store(entries)),
            ServerArgs(fused=True, max_batch=8, buckets=(8,),
                       rulestats_drain_s=0), device="cpu")
        for srv, clock in zip((self.ref, self.got, self.classic),
                              self.clocks):
            for pool in set(srv.controller.device_quotas.values()):
                pool._clock = clock
        # the reference warms its in-step program in a thread at start
        warm = getattr(self.ref, "_instep_prewarm_thread", None)
        if warm is not None:
            warm.join()
        # record every in-step pull of both packages
        self.pulls = {"ref": [], "got": []}
        for key, srv in (("ref", self.ref), ("got", self.got)):
            plan = srv.controller.dispatcher.fused
            orig = plan.packed_check_instep

            def rec(*a, _o=orig, _k=key, **kw):
                out = _o(*a, **kw)
                self.pulls[_k].append(out[0])
                return out
            plan.packed_check_instep = rec

    def advance(self, dt):
        for c in self.clocks:
            c.t += dt

    def close(self):
        for srv in (self.ref, self.got, self.classic):
            srv.close()


def _classic_round(srv, bags, qrows):
    """check, then (status-gated, like the fronts — grpcServer.go:188)
    quota_fused per row."""
    resps = srv.controller.dispatcher.check(bags)
    out = {}
    for slot, name, args in qrows:
        if resps[slot].status_code != OK:
            continue
        qr = srv.quota_fused(bags[slot], name, args, resps[slot])
        if qr is None:
            qr = srv.quota(bags[slot], name, args, preprocessed=True)
        out[slot] = qr.result() if hasattr(qr, "result") else qr
    return resps, out


BAG_DICTS = (
    {"request.method": "GET", "source.user": "alice",
     "destination.service": "a.svc"},
    {"request.method": "GET", "source.user": "bob",
     "destination.service": "a.svc"},
    {"request.method": "POST", "source.user": "alice",
     "destination.service": "b.svc"},
    {"request.method": "GET", "destination.service": "b.svc"},
    {"request.method": "GET", "source.user": "alice",
     "destination.service": "a.svc"},
    {"request.method": "GET", "source.user": "alice",
     "destination.service": "c.svc"},
)


def _wave(world, wave, dicts=BAG_DICTS, classic=True):
    """Drive one wave through the three servers; hold the port's in-step
    results equal to the reference's (every field) and, with `classic`,
    to the port's classic path's (grant and status on rows whose check
    passed)."""
    ref_rows = [(s, n, RefArgs(**a)) for s, n, a in wave]
    got_rows = [(s, n, QuotaArgs(**a)) for s, n, a in wave]
    rt = world.ref.instep_quota_target()
    gt = world.got.instep_quota_target()
    assert (rt is None) == (gt is None) and gt is not None
    assert set(gt[1]) == set(rt[1])
    ra, qa_ref = world.ref.check_batch_quota_instep(
        [ref_bag(d) for d in dicts], ref_rows, rt)
    ga, qa_got = world.got.check_batch_quota_instep(
        [bag_from_mapping(d) for d in dicts], got_rows, gt)
    assert [x.status_code for x in ga] == [x.status_code for x in ra]
    assert set(qa_got) == set(qa_ref)
    if classic:
        cb, qb = _classic_round(world.classic,
                                [bag_from_mapping(d) for d in dicts],
                                got_rows)
        assert [x.status_code for x in cb] == [x.status_code for x in ga]
    for slot in qa_got:
        _same(qa_got[slot], qa_ref[slot])
        if classic and cb[slot].status_code == OK:
            assert (qa_got[slot].granted_amount, qa_got[slot].status_code) \
                == (qb[slot].granted_amount, qb[slot].status_code)
    if world.pulls["ref"]:
        want = np.asarray(world.pulls["ref"][-1])
        have = world.pulls["got"][-1].numpy()
        np.testing.assert_array_equal(have, want)
    return qa_got


def _a(amount, be=True, dedup=""):
    return dict(quota_amount=amount, best_effort=be, dedup_id=dedup)


INSTEP_WAVES = {
    # gated / ungated rows, defaulted dims, mixed amounts contending on
    # one bucket, best-effort partials, window exhaustion
    "gating_and_contention": ([
        [(0, "rq", _a(5)), (4, "rq", _a(5)), (2, "rq", _a(7)),
         (3, "rq", _a(3)), (1, "eq", _a(6))],
        [(0, "rq", _a(40)), (1, "eq", _a(6))],
        [(4, "rq", _a(1)), (1, "eq", _a(6))],
    ], {}),
    # consume the window, advance half a window, then past it
    "rolling_reclaim": ([
        [(0, "rq", _a(40))], [(0, "rq", _a(1))], [(0, "rq", _a(40))],
    ], {1: 5.0, 2: 6.0}),
    # in-batch replay, cache replay, then single consumption proven
    "dedup": ([
        [(0, "rq", _a(5, dedup="d1")), (4, "rq", _a(5, dedup="d1"))],
        [(0, "rq", _a(5, dedup="d1"))],
        [(5, "rq", _a(40))],
    ], {}),
    # all-or-nothing ties at the boundary of one bucket
    "ao_ties": ([
        [(0, "rq", _a(15, be=False)), (4, "rq", _a(15, be=False)),
         (5, "rq", _a(15, be=False)), (1, "rq", _a(30, be=False))],
        [(0, "rq", _a(10, be=False)), (4, "rq", _a(10, be=False))],
    ], {}),
}


@pytest.mark.parametrize("name", list(INSTEP_WAVES))
def test_instep_matches_reference_and_classic(name):
    waves, moves = INSTEP_WAVES[name]
    world = World(_instep_entries())
    try:
        for i, wave in enumerate(waves):
            if i in moves:
                world.advance(moves[i])
            _wave(world, wave)
        pool = next(iter(world.got.controller.device_quotas.values()))
        rpool = next(iter(world.ref.controller.device_quotas.values()))
        np.testing.assert_array_equal(pool.counts.numpy(),
                                      np.asarray(rpool.counts))
    finally:
        world.close()


def test_instep_denied_checks_never_consume():
    world = World(_instep_entries() + DENY_ENTRIES)
    try:
        admin = [dict(BAG_DICTS[0], **{"request.path": "/admin/x"})]
        ok = [dict(BAG_DICTS[0], **{"request.path": "/ok"})]
        _wave(world, [(0, "rq", _a(40))], admin)
        got = _wave(world, [(0, "rq", _a(40))], ok)
        assert got[0].granted_amount == 40
    finally:
        world.close()


def test_instep_instance_eval_error_is_internal():
    world = World(_instep_entries())
    try:
        got = _wave(world, [(0, "eq", _a(3))], [{"request.method": "GET"}])
        assert got[0].status_code == INTERNAL
    finally:
        world.close()


def test_instep_target_rejects_ambiguous_names_and_flag_off():
    entries = _instep_entries() + [(("rule", "istio-system", "rq-rule-2"), {
        "match": 'request.method == "PUT"',
        "actions": [{"handler": "mq", "instances": ["rq"]}]})]
    ref = RefServer(_ref_store(entries), RefServerArgs(
        fused=True, max_batch=8, buckets=(8,), quota_in_step=True,
        **REF_ARGS))
    got = RuntimeServer(interop.store_from_reference(_ref_store(entries)),
                        ServerArgs(fused=True, max_batch=8, buckets=(8,),
                                   quota_in_step=True, rulestats_drain_s=0),
                        device="cpu")
    off = RuntimeServer(interop.store_from_reference(_ref_store(entries)),
                        ServerArgs(fused=True, max_batch=8, buckets=(8,),
                                   rulestats_drain_s=0), device="cpu")
    try:
        _, by_name = got.instep_quota_target()
        assert set(by_name) == set(ref.instep_quota_target()[1])
        assert "rq" not in by_name and "eq" in by_name
        assert off.instep_quota_target() is None
        # the warm before the publish ran every serving shape; a later
        # warm of the same shapes is memoized
        warmed = set(got.controller.dispatcher.fused._instep_warmed)
        assert warmed
        got.prewarm_instep()
        assert got.controller.dispatcher.fused._instep_warmed == warmed
    finally:
        for s in (ref, got, off):
            s.close()


class _FailingPull:
    """A pulled array whose transfer fails (both packages' pulls)."""

    def cpu(self):
        raise RuntimeError("injected device fault")

    def __array__(self, *a, **kw):
        raise RuntimeError("injected device fault")


@pytest.mark.parametrize("where", ["after_dispatch", "before_dispatch"])
def test_aborted_instep_trip_restores_counters(where):
    """A trip that fails after its dispatch (the pull) restores the plane
    the last committed trip left (InlineQuotaSession.abort); one that
    fails before it changes nothing. The same fault is injected into the
    reference: the pool state and every later grant equal its, the
    reference's own handling of the failed trip's dedup ids included
    (ROADMAP queue C: a pre-dispatch abort leaves them pending)."""
    world = World(_instep_entries())
    try:
        _wave(world, [(0, "rq", _a(15)), (1, "rq", _a(3, dedup="z"))])
        pools = [next(iter(s.controller.device_quotas.values()))
                 for s in (world.ref, world.got)]
        good = pools[1].counts.clone()
        plans = [s.controller.dispatcher.fused
                 for s in (world.ref, world.got)]
        inners = [p.packed_check_instep for p in plans]
        for plan, inner in zip(plans, inners):
            def faulty(*a, _inner=inner, **kw):
                if where == "before_dispatch":
                    raise RuntimeError("injected device fault")
                return _FailingPull(), _inner(*a, **kw)[1]
            plan.packed_check_instep = faulty
        for srv, bag, args in ((world.ref, ref_bag, RefArgs),
                               (world.got, bag_from_mapping, QuotaArgs)):
            with pytest.raises(RuntimeError, match="injected"):
                srv.check_batch_quota_instep(
                    [bag(d) for d in BAG_DICTS],
                    [(0, "rq", args(quota_amount=20)),
                     (4, "rq", args(quota_amount=7, dedup_id="w"))],
                    srv.instep_quota_target())
        assert torch.equal(pools[1].counts, good)
        np.testing.assert_array_equal(pools[1].counts.numpy(),
                                      np.asarray(pools[0].counts))
        assert set(pools[1]._dedup_pending) == set(pools[0]._dedup_pending)
        assert not pools[1]._counts_lock.locked()
        for plan, inner in zip(plans, inners):
            plan.packed_check_instep = inner
        world.pulls["ref"].clear()
        got = _wave(world, [(4, "rq", _a(7, dedup="w")), (0, "rq", _a(40)),
                            (1, "rq", _a(3, dedup="z"))], classic=False)
        if where == "after_dispatch":
            # 40 - 15 left for alice: the 7 first (amount ascending), 18
            assert (got[4].granted_amount, got[0].granted_amount,
                    got[1].granted_amount) == (7, 18, 3)
        else:
            assert got[4].status_code == UNAVAILABLE
        np.testing.assert_array_equal(pools[1].counts.numpy(),
                                      np.asarray(pools[0].counts))
    finally:
        world.close()
