"""The port's multi-device paths against the JAX package's, on virtual
devices: the dp × mp sharded check step (parallel/mesh.py, the mesh_fold
kernel's plain version on the CPU) bit-identical to the port's unsharded
step and to the reference's sharded step on conftest's 8 virtual CPU
devices, with the reference's params carried across; and the
sequence-parallel DFA match (parallel/seq_match.py, the seq_match
kernel's plain versions) equal to the reference's, to one DFA scan over
the unchunked rows and to Python `re`. Every value is an int or a bool
(the one f32, valid_duration_s, is a min over constants): exact."""
import re

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
from istio_tpu_torch.attribute.bag import DictBag, bag_from_mapping
from istio_tpu_torch.ops import bytes_ops
from istio_tpu_torch.ops.regex_dfa import compile_regex, pack_dfas_classes
from istio_tpu_torch.parallel import mesh as pmesh
from istio_tpu_torch.parallel import seq_match
from istio_tpu_torch.parallel.mesh import (Mesh, MeshSpec, mesh_stage_probe,
                                           rule_slices, shard_engine_check)
from istio_tpu_torch.runtime.config import SnapshotBuilder
from istio_tpu_torch.runtime.fused import build_fused_plan
from istio_tpu_torch.testing import workloads

FIELDS = ("status", "valid_duration_s", "valid_use_count", "referenced",
          "matched", "err", "deny_rule", "err_count")


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


def _equal(got_v, want_v, label=""):
    for f in FIELDS:
        have = getattr(got_v, f)
        have = have.numpy() if isinstance(have, torch.Tensor) else \
            np.asarray(have)
        want = np.asarray(getattr(want_v, f))
        assert have.shape == want.shape, (label, f)
        assert have.dtype == want.dtype, (label, f)
        np.testing.assert_array_equal(have, want, err_msg=f"{label} {f}")


# ---------------------------------------------------------------------------
# the sharded check step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dp,mp", [(8, 1), (4, 2), (2, 4)])
@pytest.mark.parametrize("traffic", ["headline", "hit"])
def test_sharded_check_equals_unsharded_and_reference(vdevs, dp, mp,
                                                      traffic):
    n_rules = 64
    ref = ref_workloads.make_engine(n_rules=n_rules, jit=False)
    got = workloads.make_engine(n_rules, with_quota=True, device="cpu")
    b = 2 * dp if traffic == "headline" else 8 * dp
    if traffic == "headline":
        rb = ref.tensorizer.tensorize(ref_workloads.make_bags(b))
        req = np.asarray(ref_workloads.make_request_ns(ref, b), np.int32)
    else:
        dicts, ns = workloads.make_hit_requests(n_rules, b, seed=dp + mp)
        rb = ref.tensorizer.tensorize([RefDictBag(d) for d in dicts])
        req = np.asarray([ref.ruleset.namespace_id(x) for x in ns],
                         np.int32)
    counts = np.zeros(np.asarray(ref.quota_counts).shape, np.int32)
    counts[:, ::5] = 1
    ref_v, ref_counts = ref.raw_step(ref.params, rb, req, counts.copy())
    ref_mesh = RefMeshSpec(dp=dp, mp=mp).build()
    jv, j_counts = ref_shard_check(ref_mesh, ref)(ref.params, rb, req,
                                                   counts.copy())
    params = interop.params_from_reference(ref.params, device="cpu")
    batch = interop.batch_from_reference(rb, device="cpu")
    step = shard_engine_check(MeshSpec(dp=dp, mp=mp).build(), got)
    qc = interop.quota_counts_from_reference(counts, device="cpu")
    v, out_counts = step(params, batch, req, qc)
    assert out_counts is qc                    # updated in place
    _equal(v, ref_v, "vs reference unsharded")
    _equal(v, jv, "vs reference sharded")
    np.testing.assert_array_equal(out_counts.numpy(), np.asarray(ref_counts))
    np.testing.assert_array_equal(out_counts.numpy(), np.asarray(j_counts))
    qc2 = interop.quota_counts_from_reference(counts, device="cpu")
    uv, u_counts = got.raw_step(params, batch, req, qc2)
    _equal(v, uv, "vs port unsharded")
    assert torch.equal(out_counts, u_counts)
    if traffic == "hit":
        st = set(v.status.tolist())
        assert len(st) > 1, st


def test_sharded_engine_check_carries_quota_across_steps(vdevs):
    """engine.check through a mesh step (as a fused plan sets it):
    three batches with small quotas, counts carried in place, equal to
    an unsharded engine batch by batch; some rows run out."""
    n_rules = 64
    a = workloads.make_engine(n_rules, device="cpu", quota_max=2)
    b = workloads.make_engine(n_rules, device="cpu", quota_max=2)
    b._step = shard_engine_check(MeshSpec(4, 2).build(), b)
    exhausted = 0
    for s in range(3):
        dicts, ns = workloads.make_hit_requests(n_rules, 32, seed=40 + s)
        bags = [DictBag(d) for d in dicts]
        req = np.asarray([a.ruleset.namespace_id(x) for x in ns], np.int32)
        va = a.check(a.tensorizer.tensorize(bags), req)
        vb = b.check(b.tensorizer.tensorize(bags), req)
        _equal(vb, va, f"step {s}")
        assert torch.equal(a.quota_counts, b.quota_counts)
        exhausted += int((vb.status == 8).sum())
    assert exhausted > 0


def test_batch_rows_must_divide_by_dp(vdevs):
    eng = workloads.make_engine(64, device="cpu")
    step = shard_engine_check(MeshSpec(4, 2).build(), eng)
    batch = eng.tensorizer.tensorize(workloads.make_bags(6))
    with pytest.raises(ValueError, match="divisible by dp=4"):
        step(eng.params, batch, np.zeros(6, np.int32), eng.quota_counts)


def test_mesh_without_virtual_devices_raises():
    """No implicit virtual devices: a mesh larger than the card count
    raises as the reference's does (none at all without CUDA)."""
    have = len(platform.devices())
    with pytest.raises(ValueError, match=f"need {have + 1} devices, "
                                         f"have {have}"):
        MeshSpec(have + 1, 1).build()


def test_force_virtual_devices_restores_the_previous_list():
    before = platform.devices()
    with platform.force_virtual_devices(8, "cpu") as devs:
        assert platform.devices() == devs and len(devs) == 8
        assert {d.device.type for d in devs} == {"cpu"}
        assert all(d.stream is None for d in devs)
        with platform.force_virtual_devices(2, "cpu") as inner:
            assert platform.devices() == inner
        assert platform.devices() == devs
        mesh = MeshSpec(4, 2).build()
        assert mesh.shape == {"dp": 4, "mp": 2}
        assert pmesh.policy_mesh(rule_shards=4).shape == {"dp": 2, "mp": 4}
        with pytest.raises(ValueError, match="not divisible"):
            pmesh.policy_mesh(rule_shards=3)
    assert platform.devices() == before


def test_param_shardings_split_only_the_conjunction_matrices(vdevs):
    eng = workloads.make_engine(64, device="cpu")
    spec = pmesh.param_shardings(MeshSpec(4, 2).build(), eng)
    assert set(spec) == set(eng.params)
    assert {k for k, v in spec.items() if v} == {"conj_m_idx", "conj_n_idx"}
    assert all(v in ((), ("mp",)) for v in spec.values())
    assert rule_slices(72, 4) == [(0, 18), (18, 36), (36, 54), (54, 72)]
    assert rule_slices(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]


def test_shard_batch_places_rows_over_dp(vdevs):
    eng = workloads.make_engine(64, device="cpu")
    batch = eng.tensorizer.tensorize(workloads.make_bags(8))
    placed = pmesh.shard_batch(MeshSpec(4, 2).build(), batch)
    assert len(placed) == 4 and all(len(r) == 2 for r in placed)
    for d, row in enumerate(placed):
        for shard in row:
            assert torch.equal(shard.ids, batch.ids[2 * d:2 * d + 2])
            assert torch.equal(shard.str_bytes,
                               batch.str_bytes[2 * d:2 * d + 2])


def test_mesh_stage_probe_reports_every_stage(vdevs):
    eng = workloads.make_engine(64, device="cpu")
    batch = eng.tensorizer.tensorize(workloads.make_bags(8))
    out = mesh_stage_probe(MeshSpec(4, 2).build(), eng, batch,
                           workloads.make_request_ns(eng, 8), steps=1,
                           reps=1)
    assert set(out) >= {"shard_dispatch_ms", "match_ms", "full_step_ms",
                        "fold_collectives_ms"}
    assert out["clock"] == "host" and out["mesh"] == {"dp": 4, "mp": 2}
    assert all(out[k] >= 0 for k in ("shard_dispatch_ms", "match_ms",
                                     "full_step_ms", "fold_collectives_ms"))


def _rbac_engine(n_role_rules: int):
    store = workloads.make_rbac_store(n_role_rules)
    try:
        snap = SnapshotBuilder(workloads.MESH_MANIFEST,
                               device="cpu").build(store)
    finally:
        store.close()
    plan = build_fused_plan(snap, rule_telemetry=False)
    return plan.engine


@pytest.mark.parametrize("dp,mp", [(2, 4), (1, 8)])
def test_rbac_allow_rows_straddling_the_mp_seams(vdevs, dp, mp):
    """One RBAC spec's allow rows, its guard row and its own rule land on
    different mp shards; the sharded fold equals the unsharded one."""
    eng = _rbac_engine(40)
    n_rows = int(eng.params["conj_m_idx"].shape[0])
    slices = rule_slices(n_rows, mp)

    def shard_of(col):
        return next(m for m, (r0, r1) in enumerate(slices) if r0 <= col < r1)

    allow = eng.params["pe_rb_allow"].numpy()
    spans = [{shard_of(c) for c in row if c < n_rows} for row in allow]
    assert max(len(s) for s in spans) >= 2, spans
    rules = eng.params["pe_rb_rule"].numpy()
    assert any(s - {shard_of(int(r))} for r, s in zip(rules, spans))
    dicts = workloads.make_rbac_request_dicts(32)
    batch = eng.tensorizer.tensorize([bag_from_mapping(d) for d in dicts])
    req = np.zeros(len(dicts), np.int32)
    want, _ = eng.raw_step(eng.params, batch, req, eng.quota_counts)
    step = shard_engine_check(MeshSpec(dp, mp).build(), eng)
    got, _ = step(eng.params, batch, req, eng.quota_counts)
    _equal(got, want, f"rbac {dp}x{mp}")
    assert {0, 7} <= set(got.status.tolist())


def test_list_banks_per_mp_shard(vdevs):
    """REGEX and CIDR lists: each mp shard runs the banks of the lists
    whose rules it holds; the undecidable regex rows still err their
    rule, wherever it lies."""
    import importlib.util
    import pathlib
    from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
    spec = importlib.util.spec_from_file_location(
        "_fused_world",
        pathlib.Path(__file__).with_name("test_fused_serving.py"))
    fs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fs)
    store = interop.store_from_reference(fs._store())
    try:
        snap = SnapshotBuilder(GLOBAL_MANIFEST, device="cpu").build(store)
    finally:
        store.close()
    eng = build_fused_plan(snap, rule_telemetry=False).engine
    assert eng._rx_lists is not None and eng._cidr_lists is not None
    bags = fs._bags()
    while len(bags) % 8:
        bags.append(bag_from_mapping({"request.path": "/pad"}))
    batch = eng.tensorizer.tensorize(bags)
    req = np.zeros(len(bags), np.int32)
    want, _ = eng.raw_step(eng.params, batch, req, eng.quota_counts)
    assert bool(want.err.any())
    for dp, mp in ((1, 8), (4, 2)):
        got, _ = shard_engine_check(MeshSpec(dp, mp).build(), eng)(
            eng.params, batch, req, eng.quota_counts)
        _equal(got, want, f"lists {dp}x{mp}")


# ---------------------------------------------------------------------------
# sequence-parallel DFA matching
# ---------------------------------------------------------------------------

def _sp_mesh(devs) -> Mesh:
    return Mesh(np.array(devs, dtype=object), ("sp",))


def _ref_sp_mesh():
    from jax.sharding import Mesh as JaxMesh
    return JaxMesh(np.array(jax.devices("cpu")[:8]), ("sp",))


def _scan_rows(data: np.ndarray, lens: np.ndarray, dfa) -> np.ndarray:
    """dfa_scan (its plain version on the CPU) over the unchunked rows."""
    bank = bytes_ops.DfaBank.of(pack_dfas_classes([dfa]))
    return bytes_ops.dfa_scan(torch.from_numpy(data),
                              torch.from_numpy(lens), bank)[:, 0].numpy()


def _re_rows(pattern: str, data: np.ndarray, lens: np.ndarray) -> np.ndarray:
    return np.array([re.search(pattern, data[i, :lens[i]].tobytes()
                               .decode("latin1")) is not None
                     for i in range(data.shape[0])])


@pytest.mark.parametrize("n_chunks", [8, 16])
@pytest.mark.parametrize("pattern", workloads.LONG_PATTERNS)
def test_sequence_parallel_dfa_matches_scan_re_and_reference(
        vdevs, n_chunks, pattern):
    total = 1024
    data, lens = workloads.make_long_subjects(10, 8, 128, seed=7)
    assert data.shape == (10, total)
    dfa = compile_regex(pattern)
    ref_dfa = ref_compile_regex(pattern)
    np.testing.assert_array_equal(dfa.transitions, ref_dfa.transitions)
    chunked = data.reshape(10, n_chunks, total // n_chunks)
    got = seq_match.sharded_dfa_match(_sp_mesh(vdevs), "sp", chunked, lens,
                                      dfa.transitions, dfa.accept)
    assert got.dtype == torch.bool and got.shape == (10,)
    got = got.numpy()
    np.testing.assert_array_equal(got, _scan_rows(data, lens, dfa))
    np.testing.assert_array_equal(got, _re_rows(pattern, data, lens))
    want_ref = np.asarray(ref_sharded_match(
        _ref_sp_mesh(), "sp", chunked, lens, ref_dfa.transitions,
        ref_dfa.accept))
    np.testing.assert_array_equal(got, want_ref)


def test_long_subjects_cover_every_case():
    data, lens = workloads.make_long_subjects(10, 8, 128, seed=7)
    hits = _re_rows("needle-[0-9]+", data, lens)
    # inside a chunk, across a seam and at the end hit; absent and the
    # short tail miss
    np.testing.assert_array_equal(hits[:5], [True, True, False, True,
                                             False])
    seam = data[1].tobytes().index(workloads.LONG_NEEDLE)
    assert seam // 128 != (seam + len(workloads.LONG_NEEDLE) - 1) // 128
    assert lens[4] == 1024 - 40


def test_chunk_transition_map_composes():
    """Map composition over split halves equals one scan over the whole
    string (the associativity the sharding relies on), and equals the
    reference's maps."""
    dfa = compile_regex("ab+c")
    text = b"zzabbbczz"
    row = np.frombuffer(text, np.uint8)[None, :]
    tr = torch.from_numpy(dfa.transitions.astype(np.int32))
    full = seq_match.chunk_transition_map(
        torch.from_numpy(row.copy()), torch.tensor([len(text)], dtype=torch.int32),
        tr)
    m1 = seq_match.chunk_transition_map(
        torch.from_numpy(row[:, :4].copy()), torch.tensor([4], dtype=torch.int32),
        tr)
    m2 = seq_match.chunk_transition_map(
        torch.from_numpy(row[:, 4:].copy()),
        torch.tensor([len(text) - 4], dtype=torch.int32), tr)
    composed = seq_match.compose_maps(torch.stack([m1, m2]))
    assert torch.equal(full, composed)
    ref_full = ref_chunk_map(jax.numpy.asarray(row),
                             jax.numpy.asarray([len(text)], np.int32),
                             jax.numpy.asarray(dfa.transitions))
    np.testing.assert_array_equal(full.numpy(), np.asarray(ref_full))


def test_chunk_maps_and_compose_equal_the_reference_on_random_chunks():
    rng = np.random.default_rng(3)
    dfa = compile_regex("needle-[0-9]+")
    s = dfa.transitions.shape[0]
    chunks = rng.integers(97, 123, (6, 40), dtype=np.uint8)
    chunks[2, 10:19] = np.frombuffer(b"needle-42", np.uint8)
    lens = np.array([40, 0, 25, 41, -3, 17], np.int32)
    got = seq_match.chunk_transition_map(
        torch.from_numpy(chunks), torch.from_numpy(lens),
        torch.from_numpy(dfa.transitions.astype(np.int32)))
    want = ref_chunk_map(jax.numpy.asarray(chunks), jax.numpy.asarray(lens),
                         jax.numpy.asarray(dfa.transitions))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[1].numpy(), np.arange(s))  # lens 0
    maps = rng.integers(0, s, (5, 6, s)).astype(np.int32)
    np.testing.assert_array_equal(
        seq_match.compose_maps(torch.from_numpy(maps)).numpy(),
        np.asarray(ref_compose(jax.numpy.asarray(maps))))


def test_sequence_parallel_edge_cases(vdevs):
    mesh = _sp_mesh(vdevs)
    dfa = compile_regex("needle-[0-9]+")
    rng = np.random.default_rng(11)
    data = rng.integers(97, 123, (6, 16 * 32), dtype=np.uint8)
    needle = np.frombuffer(b"needle-42", np.uint8)
    data[1, 28:37] = needle                   # across the seam at 32
    data[2, 100:109] = needle
    data[3, 60:69] = needle
    data[4, 500:509] = needle
    # empty row, a needle across a seam, lengths that are not a multiple
    # of Lc (one cuts the needle, one keeps it), and a needle at the end
    lens = np.array([0, 512, 105, 69, 509, 77], np.int32)
    got = seq_match.sharded_dfa_match(mesh, "sp", data.reshape(6, 16, 32),
                                      lens, dfa.transitions, dfa.accept)
    want = _re_rows("needle-[0-9]+", data, lens)
    np.testing.assert_array_equal(want, [False, True, False, True, True,
                                         False])
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _scan_rows(data, lens, dfa))
    with pytest.raises(ValueError, match="multiple of the 'sp' axis size 8"):
        seq_match.sharded_dfa_match(mesh, "sp", data.reshape(6, 4, 128),
                                    lens, dfa.transitions, dfa.accept)


def test_sharded_dfa_match_refuses_tensors_off_the_mesh(vdevs):
    """A tensor input on another device type than the mesh's raises; it
    never runs where the mesh is not."""
    mesh = _sp_mesh(vdevs)
    dfa = compile_regex("needle-[0-9]+")
    data = np.zeros((2, 8, 4), np.uint8)
    lens = np.array([3, 32], np.int32)
    for i, name in enumerate(("data", "lens", "transitions", "accept")):
        args = [data, lens, dfa.transitions, dfa.accept]
        args[i] = torch.empty(np.shape(args[i]), device="meta")
        with pytest.raises(ValueError, match=f"{name} is on meta"):
            seq_match.sharded_dfa_match(mesh, "sp", *args)
    got = seq_match.sharded_dfa_match(mesh, "sp", torch.from_numpy(data),
                                      lens, dfa.transitions, dfa.accept)
    np.testing.assert_array_equal(got.numpy(), [False, False])


def test_seq_match_plain_versions_are_the_cpu_path():
    """A CPU tensor runs the plain versions; counting launches never
    moves."""
    from istio_tpu_torch import kernels
    dfa = compile_regex("^[a-z]")
    data = torch.from_numpy(np.full((3, 4, 8), 97, np.uint8))
    lens = torch.tensor([32, 5, 0], dtype=torch.int32)
    tr = torch.from_numpy(dfa.transitions.astype(np.int32))
    before = dict(kernels.launches)
    maps = seq_match.chunk_maps(data, lens, tr)
    assert torch.equal(maps, seq_match.chunk_maps_plain(data, lens, tr))
    acc = torch.from_numpy(dfa.accept.astype(bool))
    out = seq_match.compose(maps, acc)
    assert out.tolist() == [True, True, False]
    assert dict(kernels.launches) == before
