"""The in-fold quota rank's kernel formulation against the JAX package.

The quota_grant kernel (csrc/verdict_fold.cu) ranks each quota column
without a sort: per block of consecutive rows, each key's rows hold the
group ranks [pre, pre + n) and are all granted, all over, or — where the
limit falls inside the group or the int32 sum wraps — ranked exactly;
each group commits its grants with one add. Its plain version
(policy_engine.quota_grant_plain, with the launch plan's block size or a
smaller one, so that keys span blocks) must give the reference's grants
(istio_tpu/models/policy_engine.py:586-623: the pairwise tier up to
B = 256, the stable sort above), counters, statuses and over-limit rules
exactly: on hypothesis key columns with heavy duplication (all inactive,
one hot key, a few keys), counters at q_max - 1 and q_max, several
quotas over one row, int32 wrap of counter + rank, and composite keys
near INT32_MAX (a counter plane of 2^31 - 2 cells, mapped from a sparse
file); and through the engine: the port's step (verdict_fold on the
CPU) and the kernel formulation over the fold's keys against the JAX
PolicyEngine step at B = 255, 256, 257, 1,024 and 4,096, counters
carried over three batches. The port runs on the CPU."""
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.models import policy_engine as ref_pe
from istio_tpu.models.quota_alloc import batch_rank as ref_batch_rank
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.parallel import mesh_fold as mf
from istio_tpu_torch.testing import workloads

INT32_MAX = 2 ** 31 - 1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ref_grant(ckey, prior, q_max, q_rule):
    """The reference's quota grant on composite keys [B, Q] (INT32_MAX
    inactive) and the counters they read [B, Q], with the rank tier the
    reference picks for B → (granted [B, Q], any_over [B], over_rule
    [B])."""
    ck = jnp.asarray(ckey, jnp.int32)
    b, n_q = ck.shape
    if b <= 256:
        eq = ck[None, :, :] == ck[:, None, :]
        lower = (jnp.arange(b)[None, :] < jnp.arange(b)[:, None])[:, :, None]
        rank = jnp.sum(eq & lower, axis=1, dtype=jnp.int32)
    else:
        rank = ref_batch_rank(ck.T.reshape(-1)).reshape(n_q, b).T
    active = ck != INT32_MAX
    granted = active & (jnp.asarray(prior, jnp.int32) + rank
                        < jnp.asarray(q_max, jnp.int32)[None, :])
    over = active & ~granted
    over_rule = jnp.min(jnp.where(over, jnp.asarray(q_rule, jnp.int32)[None],
                                  INT32_MAX), axis=1)
    return (np.asarray(granted), np.asarray(jnp.any(over, axis=1)),
            np.asarray(over_rule))


def check_columns(keys, counts, q_max, q_rule, rows=None):
    """Hold quota_grant_plain (launch plan, or blocks of `rows`) and the
    mesh_quota entry point on the CPU against ref_grant on key columns
    int32 [Q, B] (-1 inactive) over `counts` (a flat int32 tensor, every
    live key inside it), from zero statuses; counts updated as the
    reference commits."""
    n_q, b = keys.shape
    flat = counts.view(-1)
    live = keys >= 0
    prior = np.where(live, flat[torch.from_numpy(np.where(live, keys, 0))
                                .long()].numpy(), 0).T
    granted, any_over, over_rule = ref_grant(
        np.where(live, keys, INT32_MAX).T, prior, q_max, q_rule)
    touched = np.unique(keys[live])
    want = flat[torch.from_numpy(touched).long()].numpy().astype(np.int64)
    pos = np.searchsorted(touched, keys.T[granted])
    np.add.at(want, pos, 1)
    want = ((want + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    want_status = np.where(any_over, pe.RESOURCE_EXHAUSTED, 0)
    want_rule = np.where(any_over, over_rule, INT32_MAX)
    before = flat[torch.from_numpy(touched).long()].clone()
    plans = [None] if rows is None else [None, pe.QuotaPlan(
        -(-b // rows), rows, 32, 64, 1)]
    for plan in plans:
        flat[torch.from_numpy(touched).long()] = before
        status = torch.zeros(b, dtype=torch.int32)
        rule = torch.full((b,), INT32_MAX, dtype=torch.int32)
        pe.quota_grant_plain(torch.from_numpy(keys), counts,
                             torch.from_numpy(q_max), torch.from_numpy(q_rule),
                             status, rule, plan=plan)
        np.testing.assert_array_equal(status.numpy(), want_status)
        np.testing.assert_array_equal(rule.numpy(), want_rule)
        np.testing.assert_array_equal(
            flat[torch.from_numpy(touched).long()].numpy(), want)
    # the entry point, on a dp replica's rows [row0, row0 + bd)
    flat[torch.from_numpy(touched).long()] = before
    row0 = b // 3
    bd = b - row0 - b // 4
    status = torch.zeros(bd, dtype=torch.int32)
    rule = torch.full((bd,), INT32_MAX, dtype=torch.int32)
    assert mf.mesh_quota(torch.from_numpy(keys), torch.from_numpy(q_max),
                         torch.from_numpy(q_rule), counts, row0, status,
                         rule) == 0
    np.testing.assert_array_equal(status.numpy(),
                                  want_status[row0:row0 + bd])
    np.testing.assert_array_equal(rule.numpy(), want_rule[row0:row0 + bd])
    np.testing.assert_array_equal(
        flat[torch.from_numpy(touched).long()].numpy(), want)
    return int(granted.sum()), int(any_over.sum())


@st.composite
def key_columns(draw):
    """(keys int32 [Q, B] with -1 inactive, counts int32 [Q, NB], q_max,
    q_rule, block rows): heavy duplication of keys, counters at and
    around q_max, int32 counters near the top (wrap of counter +
    rank)."""
    b = draw(st.sampled_from([1, 2, 31, 32, 33, 100, 255, 256, 257, 700]))
    n_q = draw(st.integers(1, 4))
    nb = draw(st.sampled_from([1, 2, 5, 64]))
    kind = draw(st.sampled_from(["inactive", "hot", "few", "many"]))
    seed = draw(st.integers(0, 2 ** 16))
    rng = np.random.default_rng(seed)
    if kind == "inactive":
        bucket = np.full((n_q, b), -1)
    elif kind == "hot":
        bucket = np.where(rng.random((n_q, b)) < 0.9,
                          rng.integers(0, nb, (n_q, 1)), -1)
    elif kind == "few":
        bucket = np.where(rng.random((n_q, b)) < 0.7,
                          rng.integers(0, min(nb, 3), (n_q, b)), -1)
    else:
        bucket = np.where(rng.random((n_q, b)) < 0.5,
                          rng.integers(0, nb, (n_q, b)), -1)
    keys = np.where(bucket >= 0,
                    bucket + np.arange(n_q)[:, None] * nb, -1).astype(np.int32)
    q_max = rng.choice([1, 2, 3, 17, INT32_MAX], n_q).astype(np.int32)
    counts = rng.integers(0, 3, (n_q, nb)).astype(np.int64)
    near = rng.random((n_q, nb))
    counts = np.where(near < 0.3, q_max[:, None] - 1, counts)
    counts = np.where((near >= 0.3) & (near < 0.5), q_max[:, None], counts)
    counts = np.where(near > 0.95, INT32_MAX - rng.integers(0, 40, (n_q, nb)),
                      counts)
    q_rule = rng.integers(0, 9, n_q).astype(np.int32)
    rows = draw(st.sampled_from([7, 32, 64]))
    return keys, counts.astype(np.int32), q_max, q_rule, rows


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(key_columns())
def test_kernel_formulation_matches_reference_grant(case):
    keys, counts, q_max, q_rule, rows = case
    check_columns(keys, torch.from_numpy(counts.copy()), q_max, q_rule, rows)


def test_hot_key_over_the_limit_spans_blocks():
    """One key on every row, its counter below the limit by less than the
    rows: the limit falls inside the group, in a later block than the
    first, and a second quota over the same rows is never over."""
    b = 4096
    keys = np.stack([np.full(b, 3), np.full(b, 64 + 5)]).astype(np.int32)
    counts = torch.zeros(2 * 64, dtype=torch.int32)
    counts[3] = 10
    q_max = np.asarray([2000, INT32_MAX], np.int32)
    granted, over = check_columns(keys, counts, q_max,
                                  np.asarray([4, 2], np.int32), rows=1024)
    assert (granted, over) == (1990 + b, b - 1990)
    assert int(counts[3]) == 2000 and int(counts[69]) == b


@pytest.fixture(scope="module")
def huge_plane(tmp_path_factory):
    """A counter plane of 2 quotas x (2^30 - 1) buckets, int32, mapped
    from a sparse file (only the touched cells take room)."""
    path = tmp_path_factory.mktemp("plane") / "counts.bin"
    n = 2 * (2 ** 30 - 1)
    arr = np.memmap(path, dtype=np.int32, mode="w+", shape=(n,))
    return torch.from_numpy(arr)


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(st.integers(0, 2 ** 16), st.sampled_from([5, 256, 257, 1000]))
def test_composite_keys_near_int32_max(huge_plane, seed, b):
    rng = np.random.default_rng(seed)
    nb = 2 ** 30 - 1
    top = nb - 1 - rng.integers(0, 6, (2, b))          # the last buckets
    keys = np.where(rng.random((2, b)) < 0.8,
                    top + np.arange(2)[:, None] * nb, -1).astype(np.int32)
    assert keys.max() >= 2 ** 31 - 9
    live = np.unique(keys[keys >= 0])
    huge_plane[torch.from_numpy(live).long()] = torch.from_numpy(
        rng.integers(0, 4, live.shape[0]).astype(np.int32))
    check_columns(keys, huge_plane, np.asarray([3, 5], np.int32),
                  np.asarray([7, 1], np.int32), rows=64)


def test_quota_plan_paths():
    """One block up to QUOTA_BLOCK_ROWS rows, one cluster up to
    QUOTA_MAX_CLUSTER x QUOTA_MAX_ROWS, three launches past it; every
    block non-empty, the table at least twice its rows."""
    seen = set()
    for b in (0, 1, 31, 33, 1024, 2048, 2049, 8192, 16384, 16385, 65536,
              65537, 200_000):
        p = pe.quota_plan(b)
        path = (p.blocks == 1, p.launches)
        seen.add(path)
        assert p.blocks * p.rows >= b and (p.blocks - 1) * p.rows < max(b, 1)
        assert p.slots >= 2 * p.rows and p.slots & (p.slots - 1) == 0
        assert p.threads % 32 == 0 and p.threads <= 1024
        assert p.rows <= pe.QUOTA_MAX_ROWS
        if p.launches == 1:
            assert p.blocks <= pe.QUOTA_MAX_CLUSTER
            assert p.scratch_words(34) == 0
        else:
            assert p.scratch_words(34) == 34 * p.blocks * 3 * p.slots
    assert pe.quota_plan(2048).blocks == 1 and pe.quota_plan(2049).blocks == 2
    assert pe.quota_plan(65536).launches == 1
    assert pe.quota_plan(65537).launches == 3
    assert seen == {(True, 1), (False, 1), (False, 3)}


# ---- the engine: the port's step and the kernel formulation over the
# fold's keys against the JAX step, counters carried

N_RULES = 300
QUOTAS = ((2, "source.user", 40, 7), (2, "source.name", 25, 3),
          (2, "source.user", 3000, 4096), (5, "source.user", 60, 1))


def _engines():
    deny = [i for i in range(0, N_RULES, 3) if i not in (2, 5)]
    ref = ref_pe.PolicyEngine(
        ref_workloads.make_rules(N_RULES), ref_workloads.MESH_FINDER,
        deny=[ref_pe.DenySpec(rule=i) for i in deny],
        quotas=[ref_pe.QuotaSpec(rule=r, key_attr=a, max_amount=m,
                                 n_buckets=nb) for r, a, m, nb in QUOTAS])
    got = pe.PolicyEngine(
        workloads.make_rules(N_RULES), workloads.MESH_FINDER,
        deny=[pe.DenySpec(rule=i) for i in deny],
        quotas=[pe.QuotaSpec(rule=r, key_attr=a, max_amount=m,
                             n_buckets=nb) for r, a, m, nb in QUOTAS],
        device="cpu")
    return ref, got


@pytest.fixture(scope="module")
def engines():
    return _engines()


def _quota_dicts(b: int, seed: int) -> tuple[list[dict], list[str]]:
    """Requests aimed at quota rules 2 and 5 (and deny rule 3), users and
    names from small pools (heavy duplication), every tenth key absent →
    (dicts, request namespaces)."""
    rng = np.random.default_rng(seed)
    dicts, ns = [], []
    for i in range(b):
        r = int(rng.choice([2, 2, 5, 3]))
        d = {"destination.service": f"svc{r}.ns{r}.svc.cluster.local",
             "source.namespace": "ns1",
             "request.headers": {"cookie": "session=5"}}
        if rng.random() < 0.9:
            d["source.user"] = f"user{int(rng.zipf(1.5)) % 9}"
        if rng.random() < 0.9:
            d["source.name"] = f"name{int(rng.integers(0, 4))}"
        dicts.append(d)
        ns.append(f"ns{r}")
    return dicts, ns


@pytest.mark.parametrize("b", (255, 256, 257, 1024, 4096))
def test_engine_steps_match_reference_with_counters_carried(engines, b):
    ref, got = engines
    ref.reset_quota()
    got.reset_quota()
    n_b = int(got.quota_counts.shape[1])
    statuses = set()
    for step in range(3):
        dicts, ns = _quota_dicts(b, seed=100 * b + step)
        rb = ref.tensorizer.tensorize([ref_bag(d) for d in dicts])
        pb = got.tensorizer.tensorize([bag_from_mapping(d) for d in dicts])
        req = np.asarray([got.ruleset.namespace_id(x) for x in ns],
                         np.int32)
        before = got.quota_counts.clone()
        want = ref.check(rb, req)
        have = got.check(pb, req)
        for f in ("status", "deny_rule", "valid_duration_s",
                  "valid_use_count"):
            np.testing.assert_array_equal(getattr(have, f).numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f"B={b} step {step} {f}")
        np.testing.assert_array_equal(got.quota_counts.numpy(),
                                      np.asarray(ref.quota_counts))
        # the kernel formulation over the keys the fold ranks
        c = got.fold_consts
        matched, _, err = got.ruleset.fn(got.params, pb, ("matched", "err"))
        rq = torch.from_numpy(req)
        pre = pe.verdict_fold_plain(matched, err, rq, pb, got.params,
                                    before.clone(),
                                    dataclasses.replace(c, has_quota=False))
        status, rule = pre[0].clone(), pre[3].clone()
        rules = got.params["pe_q_rule"].long()
        rns = got.params["pe_rule_ns"][rules]
        vis = (rns[None] == c.default_ns) | (rns[None] == rq[:, None])
        slot = got.params["pe_q_slot"].long()
        act = matched[:, rules] & vis & pb.present[:, slot] & \
            (status == pe.OK)[:, None]
        key = torch.remainder(pb.hash_ids[:, slot],
                              got.params["pe_q_nb"][None]) + \
            torch.arange(len(QUOTAS))[None, :] * n_b
        keys = torch.where(act, key, -1).to(torch.int32).T.contiguous()
        counts = before.clone()
        pe.quota_grant_plain(keys, counts, got.params["pe_q_max"],
                             got.params["pe_q_rule"], status, rule)
        np.testing.assert_array_equal(status.numpy(),
                                      np.asarray(want.status))
        np.testing.assert_array_equal(rule.numpy(),
                                      np.asarray(want.deny_rule))
        np.testing.assert_array_equal(counts.numpy(),
                                      np.asarray(ref.quota_counts))
        statuses |= set(np.asarray(want.status).tolist())
    assert pe.RESOURCE_EXHAUSTED in statuses and pe.OK in statuses


@pytest.mark.parametrize("b", (1, 33, 257, 3000))
def test_reference_rank_plain_matches_kernel_formulation(b):
    """quota_rank_plain (the reference's sort, on key columns: the
    yardstick of chip_smoke's mesh_quota edge cases) equals the kernel
    formulation, several quotas over one row, a dp replica's rows."""
    rng = np.random.default_rng(b)
    n_q, nb = 3, 6
    keys = np.where(rng.random((n_q, b)) < 0.7,
                    rng.integers(0, nb, (n_q, b)) + np.arange(n_q)[:, None]
                    * nb, -1).astype(np.int32)
    counts = torch.from_numpy(rng.integers(0, 30, (n_q, nb))
                              .astype(np.int32))
    q_max = torch.tensor([20, 40, 2], dtype=torch.int32)
    q_rule = torch.tensor([5, 3, 9], dtype=torch.int32)
    out = []
    for fn in (pe.quota_grant_plain, pe.quota_rank_plain):
        c = counts.clone()
        st_ = torch.zeros(b - b // 3, dtype=torch.int32)
        ru = torch.full_like(st_, INT32_MAX)
        fn(torch.from_numpy(keys), c, q_max, q_rule, st_, ru, row0=b // 3)
        out.append((c, st_, ru))
    for x, y in zip(*out):
        assert torch.equal(x, y)
