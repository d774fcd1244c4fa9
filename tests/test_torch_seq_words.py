"""The seq_match kernel's formulation (K12, parallel/seq_match.py) and the
mesh combine's plain path (parallel/mesh_fold.py, models/policy_engine
combine_fold_records) against the JAX package, on the CPU.

K12: the launch plan (`chunk_plan`: register buckets, lanes paths,
sub-chunks) and the kernel's sub-chunk split (each chunk's sub-chunk maps
composed in order) equal to the reference's chunk_transition_map on
random DFAs (S of 1, 2, 19, 32, 33 and 64; converging, two-sink and
never-converging tables; lens of 0, inside a chunk, on seams and past the
row; one chunk; chunk lengths not a multiple of 16); chip_smoke's
chunk_map_work, the table lookups the function needs (its bound's
operations), against a count state by state; and the public
chunk_transition_map / compose_maps / sharded_dfa_match equal to the
reference's on the same inputs.

The combine: each mp window's record (verdict_fold_words_plain with a
window) combined by combine_fold_records, and the sharded step's
mesh_fold_plain, equal to the reference's shard_engine_check at (dp, mp)
in (2, 2), (1, 4) and (4, 1), on the headline world (no RBAC spec) and
on the RBAC world whose allow rows straddle the mp seams. Exact equality
throughout: every value is an int or a bool (the one f32 is a min over
constants)."""
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.ops.regex_dfa import compile_regex as ref_compile_regex
from istio_tpu.parallel.mesh import MeshSpec as RefMeshSpec
from istio_tpu.parallel.mesh import shard_engine_check as ref_shard_check
from istio_tpu.parallel.seq_match import (
    chunk_transition_map as ref_chunk_map, compose_maps as ref_compose,
    sharded_dfa_match as ref_sharded_match)
from istio_tpu.testing import workloads as ref_workloads

from istio_tpu_torch import interop, platform
from istio_tpu_torch.models import policy_engine as pe
from istio_tpu_torch.ops.regex_dfa import compile_regex
from istio_tpu_torch.parallel import seq_match as sm
from istio_tpu_torch.parallel.mesh import (Mesh, MeshSpec, rule_slices,
                                           shard_engine_check)
from istio_tpu_torch.testing import workloads

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load(ROOT / "chip_smoke.py", "_chip_smoke_seq")
S_CASES = (1, 2, 19, 32, 33, 64)
KINDS = ("random", "sinks", "perm")
# CheckVerdict's fields in combine_fold_records' order
FIELDS = ("status", "valid_duration_s", "valid_use_count", "deny_rule",
          "referenced", "err_count")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: the suite runs in several worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def vdevs():
    """8 virtual CPU devices, the previous device list restored after."""
    with platform.force_virtual_devices(8, "cpu") as devs:
        yield devs


def _dfa(rng, s: int, kind: str) -> np.ndarray:
    """int32 [s, 256]: random (walks merge by chance), two absorbing
    sinks (states 0 and s - 1), or a permutation of the states per byte
    (walks never merge)."""
    if kind == "perm":
        return np.stack([rng.permutation(s) for _ in range(256)],
                        1).astype(np.int32)
    t = rng.integers(0, s, (s, 256)).astype(np.int32)
    if kind == "sinks":
        t[s - 1] = s - 1
        t[0] = 0
    return t


def _subjects(rng, b: int, c: int, lc: int, c0: int = 0):
    """data uint8 [b, c, lc] (a slice of wider rows: an odd row stride)
    and lens int32 [b]: 0, one chunk, every chunk, half a chunk, random
    (past the row too)."""
    wide = rng.integers(0, 256, (b, c * lc + 3), dtype=np.uint8)
    data = torch.from_numpy(wide)[:, 1:1 + c * lc].unflatten(1, (c, lc))
    start = c0 * lc
    lens = rng.integers(0, start + c * lc + 20, b)
    lens[:4] = (0, start + lc, start + c * lc, start + lc // 2)[:b]
    return data, torch.from_numpy(lens.astype(np.int32))


def _ref_maps(data: torch.Tensor, lens: torch.Tensor, tr: np.ndarray,
              c0: int = 0) -> np.ndarray:
    """[C, B, S] from the reference's chunk_transition_map, chunk by
    chunk (local lengths as its _runner computes them)."""
    b, c, lc = data.shape
    out = []
    for k in range(c):
        local = np.clip(lens.numpy().astype(np.int64) - (c0 + k) * lc, 0,
                        lc).astype(np.int32)
        out.append(np.asarray(ref_chunk_map(
            jax.numpy.asarray(data[:, k].contiguous().numpy()),
            jax.numpy.asarray(local), jax.numpy.asarray(tr))))
    return np.stack(out)


def _sub_chunk_maps(data: torch.Tensor, lens: torch.Tensor,
                    tr: torch.Tensor, c0: int, plan) -> torch.Tensor:
    """[C, B, S] as the kernel splits a chunk: the maps of the plan's
    `subs` sub-chunks of `sub_len` bytes (each from every entry state,
    chunk_maps_plain on the sub-chunk alone), composed in order."""
    b, c, lc = data.shape
    width = plan.subs * plan.sub_len
    out = []
    for k in range(c):
        local = (lens.long() - (c0 + k) * lc).clamp(0, lc)
        row = torch.zeros((b, max(width, lc)), dtype=torch.uint8)
        row[:, :lc] = data[:, k]
        subs = []
        for j in range(plan.subs):
            piece = row[:, j * plan.sub_len:(j + 1) * plan.sub_len]
            n = (local - j * plan.sub_len).clamp(0, plan.sub_len)
            subs.append(sm.chunk_maps_plain(piece[:, None, :].contiguous(),
                                            n.to(torch.int32), tr)[0])
        out.append(sm.compose_maps(torch.stack(subs)))
    return torch.stack(out)


def _work_by_sets(data: torch.Tensor, lens: torch.Tensor, tr: np.ndarray,
                  c0: int = 0) -> int:
    """chunk_map_work counted state by state: at each byte a chunk walks,
    the set of states its S walks stand on, absorbing ones left out."""
    b, c, lc = data.shape
    s = tr.shape[0]
    absorb = {q for q in range(s) if (tr[q] == q).all()}
    x = data.numpy()
    n = 0
    for r in range(b):
        for k in range(c):
            local = int(np.clip(int(lens[r]) - (c0 + k) * lc, 0, lc))
            states = set(range(s))
            for i in range(local):
                n += len(states - absorb)
                states = {int(tr[q, x[r, k, i]]) for q in states}
    return n


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", (1, 7, 8, 9, 16, 17, 19, 32, 33, 64, 226, 227,
                               240))
def test_chunk_plan_paths_and_sub_chunks(s):
    for lc in (1, 13, 16, 100, 128, 129, 200, 512, 1024, 8192):
        plan = sm.chunk_plan(lc, s)
        if s <= 32:
            assert plan.path == min(k for k in sm.REG_STATES if s <= k)
            assert plan.subs & (plan.subs - 1) == 0
            assert plan.subs <= sm.MAX_SUBS
            # the sub-chunks tile the chunk, none empty, each start keeps
            # the chunk's alignment within a 16-byte word
            assert plan.subs * plan.sub_len >= lc
            assert (plan.subs - 1) * plan.sub_len < max(lc, 1)
            if plan.subs > 1:
                assert plan.sub_len % 16 == 0
                assert plan.sub_len <= sm.SUB_LEN or plan.subs == sm.MAX_SUBS
            else:
                assert lc <= sm.SUB_LEN or plan.subs == sm.MAX_SUBS
        else:
            want = sm.PATH_LANES_SMEM if 4 * (256 * s + 4 * ((s + 127)
                                                            // 128)) \
                <= sm.MAX_SMEM else sm.PATH_LANES_L1
            assert plan.path == want
            assert (plan.subs, plan.sub_len) == (1, max(lc, 1))
    assert sm.chunk_plan(128, 227).path == sm.PATH_LANES_L1
    assert sm.chunk_plan(128, 226).path == sm.PATH_LANES_SMEM


def test_chunk_plan_keywords_and_refusals():
    assert sm.chunk_plan(512, 19, sub_len=64).subs == 8
    assert sm.chunk_plan(512, 19, sub_len=512).subs == 1
    assert sm.chunk_plan(128, 19) == sm.ChunkPlan(32, 1, 128)
    assert sm.chunk_plan(8192, 19) == sm.ChunkPlan(32, 8, 1024)
    for sub_len in (8, 100):
        with pytest.raises(ValueError, match="chunk_plan"):
            sm.chunk_plan(128, 19, sub_len=sub_len)


def test_chunk_map_work_leaves_out_absorbing_states():
    """An anchored pattern's dead state is absorbing: rows that leave the
    pattern at their first byte need S - 1 lookups (the live entry
    states), then none; the needle has no absorbing state (its sticky
    accept is a component), so every byte needs one at least."""
    tr = compile_regex("^/items/[0-9]+/r0$").transitions.astype(np.int32)
    s = tr.shape[0]
    assert [q for q in range(s) if (tr[q] == q).all()] == [1]   # dead
    data = torch.full((3, 2, 40), ord("x"), dtype=torch.uint8)
    lens = torch.tensor([0, 17, 80], dtype=torch.int32)
    # row 1: one chunk walked; row 2: both chunks
    assert SMOKE.chunk_map_work(data, lens, torch.from_numpy(tr), 0) == \
        3 * (s - 1)
    tr = compile_regex("needle-[0-9]+").transitions.astype(np.int32)
    assert not any((tr[q] == q).all() for q in range(tr.shape[0]))
    work = SMOKE.chunk_map_work(data, lens, torch.from_numpy(tr), 0)
    assert 97 <= work < 97 * tr.shape[0]


# ---------------------------------------------------------------------------
# the sub-chunk split and the function's work against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", S_CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_sub_chunk_maps_equal_reference_chunk_maps(s, kind):
    rng = np.random.default_rng(s * 7 + len(kind))
    tr = _dfa(rng, s, kind)
    trt = torch.from_numpy(tr)
    for lc, c, c0 in ((13, 3, 0), (100, 2, 1), (128, 1, 0), (200, 2, 0)):
        data, lens = _subjects(rng, 9, c, lc, c0)
        want = _ref_maps(data, lens, tr, c0)
        np.testing.assert_array_equal(
            sm.chunk_maps_plain(data, lens, trt, c0).numpy(), want)
        np.testing.assert_array_equal(
            sm.chunk_maps(data, lens, trt, c0).numpy(), want)
        for plan in (sm.chunk_plan(lc, s), sm.chunk_plan(lc, s, sub_len=16)):
            got = _sub_chunk_maps(data, lens, trt, c0, plan)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{lc} {plan}")


@pytest.mark.parametrize("s", S_CASES)
def test_chunk_map_work_counts_distinct_live_states(s):
    """chip_smoke.chunk_map_work equals the count state by state; it is
    S a byte walked where walks never meet (a permutation per byte with
    no absorbing state) and less where they stop on sinks."""
    rng = np.random.default_rng(100 + s)
    for kind in KINDS:
        tr = _dfa(rng, s, kind)
        data, lens = _subjects(rng, 7, 3, 100, 1)
        walked = int((lens.long()[:, None] - (torch.arange(3) + 1) * 100)
                     .clamp(0, 100).sum())
        work = SMOKE.chunk_map_work(data, lens, torch.from_numpy(tr), 1)
        assert work == _work_by_sets(data, lens, tr, 1), kind
        assert work <= s * walked
        if kind == "perm" and not (tr == np.arange(s)[:, None]).all(1).any():
            assert work == s * walked
        if kind == "sinks" and s > 2:
            assert work < s * walked


def test_needle_walks_converge():
    """On the headline's subjects the needle's 19 walks stand on a few
    states after their first byte (the pre- and post-match components):
    the function needs well under a quarter of S a byte."""
    data, lens = workloads.make_long_subjects(16, 8, 128, seed=3)
    tr = compile_regex("needle-[0-9]+").transitions.astype(np.int32)
    x = torch.from_numpy(data.reshape(16, 8, 128))
    ln = torch.from_numpy(lens)
    work = SMOKE.chunk_map_work(x, ln, torch.from_numpy(tr), 0)
    assert work * 4 < 19 * int(ln.sum())
    assert work == _work_by_sets(x, ln, tr)


@pytest.mark.parametrize("pattern", workloads.LONG_PATTERNS + (
    "^/items/[0-9]+/r0$",))
def test_sub_chunks_equal_reference_on_pattern_dfas(pattern):
    dfa = compile_regex(pattern)
    ref = ref_compile_regex(pattern)
    np.testing.assert_array_equal(dfa.transitions, ref.transitions)
    data, lens = workloads.make_long_subjects(12, 4, 128, seed=5)
    x = torch.from_numpy(data.reshape(12, 4, 128))
    ln = torch.from_numpy(lens)
    tr = torch.from_numpy(dfa.transitions.astype(np.int32))
    want = _ref_maps(x, ln, dfa.transitions.astype(np.int32))
    for sub_len in (16, 64, 128):
        got = _sub_chunk_maps(x, ln, tr, 0,
                              sm.chunk_plan(128, tr.shape[0], sub_len=sub_len))
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the public functions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", S_CASES)
def test_public_chunk_map_and_compose_equal_reference(s):
    rng = np.random.default_rng(200 + s)
    tr = _dfa(rng, s, "random")
    for lc in (13, 100):
        chunk = rng.integers(0, 256, (7, lc), dtype=np.uint8)
        lens = np.array([0, lc, lc // 2, lc + 5, 1, -2, 3], np.int32)
        got = sm.chunk_transition_map(torch.from_numpy(chunk),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(tr))
        want = ref_chunk_map(jax.numpy.asarray(chunk),
                             jax.numpy.asarray(lens), jax.numpy.asarray(tr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for c in (1, 2, 9):
        maps = rng.integers(0, s, (c, 5, s)).astype(np.int32)
        np.testing.assert_array_equal(
            sm.compose_maps(torch.from_numpy(maps)).numpy(),
            np.asarray(ref_compose(jax.numpy.asarray(maps))))


@pytest.mark.parametrize("s", S_CASES)
@pytest.mark.parametrize("kind", ("sinks", "perm"))
def test_sharded_match_equals_reference(vdevs, s, kind):
    rng = np.random.default_rng(300 + s)
    tr = _dfa(rng, s, kind)
    accept = rng.random(s) < 0.4
    data, lens = _subjects(rng, 10, 8, 13)
    chunked = data.contiguous().numpy()
    mesh = Mesh(np.array(vdevs, dtype=object), ("sp",))
    got = sm.sharded_dfa_match(mesh, "sp", chunked, lens.numpy(), tr, accept)
    ref_mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("sp",))
    want = ref_sharded_match(ref_mesh, "sp", chunked, lens.numpy(), tr,
                             accept)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the mesh combine's plain path against the reference's sharded step
# ---------------------------------------------------------------------------

def _windows(eng, params, batch, req, counts, mp):
    """Each mp window's record over the whole batch (the word fold with a
    window), combined by combine_fold_records (counts updated)."""
    matched, _, err = eng.ruleset.fn(params, batch, ("matched", "err"))
    req = torch.as_tensor(req)
    lstate = eng.list_states(batch, err)
    kind = eng._list_kind if lstate is not None else None
    recs, flags = [], []
    for r0, r1 in rule_slices(int(matched.shape[1]), mp):
        rec, fl = pe.verdict_fold_words_plain(
            matched[:, r0:r1].contiguous(), err[:, r0:r1].contiguous(), req,
            batch, params, None, eng.fold_consts, lstate, kind,
            window=(r0, r1))
        recs.append(rec)
        flags.append(fl)
    return pe.combine_fold_records(recs, flags, req, batch, params, counts,
                                   eng.fold_consts)


def _check(jv, j_counts, got, counts, label):
    for f, g in zip(FIELDS, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(jv, f)),
                                      err_msg=f"{label} {f}")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))


@pytest.mark.parametrize("dp,mp", [(2, 2), (1, 4), (4, 1)])
def test_combine_equals_reference_sharded_step(vdevs, dp, mp):
    """The headline world (no RBAC spec, with quotas): the records of
    every window combined, and the sharded step (mesh_fold_plain), equal
    the reference's shard_engine_check, verdict and counters."""
    n_rules = 64
    ref = ref_workloads.make_engine(n_rules=n_rules, jit=False)
    got = workloads.make_engine(n_rules, with_quota=True, device="cpu")
    assert not got.fold_consts.has_rbac
    b = 8 * dp
    dicts, ns = workloads.make_hit_requests(n_rules, b, seed=dp * 10 + mp)
    rb = ref.tensorizer.tensorize([RefDictBag(d) for d in dicts])
    req = np.asarray([ref.ruleset.namespace_id(x) for x in ns], np.int32)
    counts = np.zeros(np.asarray(ref.quota_counts).shape, np.int32)
    counts[:, ::3] = 1
    jv, j_counts = ref_shard_check(RefMeshSpec(dp=dp, mp=mp).build(), ref)(
        ref.params, rb, req, counts.copy())
    params = interop.params_from_reference(ref.params, device="cpu")
    batch = interop.batch_from_reference(rb, device="cpu")
    qc = interop.quota_counts_from_reference(counts, device="cpu")
    _check(jv, j_counts, _windows(got, params, batch, req, qc, mp), qc,
           "combine_fold_records")
    step = shard_engine_check(MeshSpec(dp=dp, mp=mp).build(), got)
    qc2 = interop.quota_counts_from_reference(counts, device="cpu")
    v, _ = step(params, batch, req, qc2)
    _check(jv, j_counts, [getattr(v, f) for f in FIELDS], qc2,
           "mesh_fold_plain")
    assert len(set(v.status.tolist())) > 1


@pytest.mark.parametrize("dp,mp", [(2, 2), (1, 4), (4, 1)])
def test_combine_rbac_rows_straddling_the_seams(vdevs, dp, mp):
    """An RBAC world (two specs on one rule, one with a guard row, a deny
    and a list rule beside them) whose allow rows, guard row and spec
    rule lie on different mp windows: the combined records and the
    sharded step equal the reference's shard_engine_check."""
    from istio_tpu.attribute.bag import DictBag as RefBag
    from istio_tpu.compiler.ruleset import Rule as RefRule
    from istio_tpu.compiler.ruleset import compile_ruleset as ref_compile
    from istio_tpu.models import policy_engine as ref_pe
    from istio_tpu_torch.compiler.ruleset import Rule, compile_ruleset
    rules = [("deny", 'request.method == "PUT"'),
             ("authz", 'request.method != "HEAD"'),
             ("wl", 'request.method == "GET"'),
             ("a0", 'source.user == "alice"'),
             ("a1", 'request.path.startsWith("/pub/")'),
             ("a2", 'destination.service.endsWith(".prod.svc")'),
             ("guard", "source.user == source.user")]
    ref_specs = {
        "deny": [ref_pe.DenySpec(rule=0, valid_duration_s=2.0)],
        "lists": [ref_pe.ListEntrySpec(rule=2, value_attr="source.name",
                                       entries=["web"])],
        "rbacs": [ref_pe.RbacSpec(rule=1, allow_rows=(3, 4), guard_row=6,
                                  valid_duration_s=42.0),
                  ref_pe.RbacSpec(rule=1, allow_rows=(5,),
                                  valid_duration_s=9.0)]}
    # the rule axis padded to 8 rows, so that every mp divides it
    ref = ref_pe.PolicyEngine(
        finder=ref_workloads.MESH_FINDER, count_rules=3, **ref_specs,
        ruleset=ref_compile([RefRule(*r) for r in rules],
                            ref_workloads.MESH_FINDER, jit=False,
                            rule_pad=4))
    got = pe.PolicyEngine(
        finder=workloads.MESH_FINDER, count_rules=3, device="cpu",
        ruleset=compile_ruleset([Rule(*r) for r in rules],
                                workloads.MESH_FINDER, rule_pad=4,
                                device="cpu"),
        **{k: interop.specs_from_reference(v) for k, v in ref_specs.items()})
    assert got.fold_consts.has_rbac
    rng = np.random.default_rng(dp * 10 + mp)
    dicts = []
    for _ in range(32 * dp):
        d = {"request.method": str(rng.choice(["GET", "PUT", "POST",
                                               "HEAD"])),
             "request.path": str(rng.choice(["/pub/a", "/priv/b"])),
             "destination.service": str(rng.choice(["a.prod.svc",
                                                    "a.dev.svc"])),
             "source.name": str(rng.choice(["web", "db"]))}
        if rng.random() < 0.8:
            d["source.user"] = str(rng.choice(["alice", "bob"]))
        dicts.append(d)
    rb = ref.tensorizer.tensorize([RefBag(d) for d in dicts])
    req = np.zeros(len(dicts), np.int32)
    counts = np.asarray(ref.quota_counts)
    jv, j_counts = ref_shard_check(RefMeshSpec(dp=dp, mp=mp).build(), ref)(
        ref.params, rb, req, counts.copy())
    params = interop.params_from_reference(ref.params, device="cpu")
    batch = interop.batch_from_reference(rb, device="cpu")
    n_rows = int(params["conj_m_idx"].shape[0])
    if mp > 1:      # the first spec's allow rows and guard straddle seams
        slices = rule_slices(n_rows, mp)
        where = {m for m, (r0, r1) in enumerate(slices)
                 for row in (1, 3, 4, 6) if r0 <= row < r1}
        assert len(where) >= 2, slices
    qc = interop.quota_counts_from_reference(counts, device="cpu")
    _check(jv, j_counts, _windows(got, params, batch, req, qc, mp), qc,
           "combine_fold_records")
    step = shard_engine_check(MeshSpec(dp=dp, mp=mp).build(), got)
    qc2 = interop.quota_counts_from_reference(counts, device="cpu")
    v, _ = step(params, batch, req, qc2)
    _check(jv, j_counts, [getattr(v, f) for f in FIELDS], qc2,
           "mesh_fold_plain")
    assert {pe.OK, pe.PERMISSION_DENIED, pe.INTERNAL} <= \
        set(v.status.tolist())
