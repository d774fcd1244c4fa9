"""Mesh serving on the port: a RuntimeServer with ServerArgs(mesh_shape=
(dp, mp)) serves every batch through the dp × mp sharded engine step
(parallel/mesh.py) and must answer exactly as the port's single-device
server and the JAX package's mesh server (tests/test_mesh_serving.py's
scenario) on tests/test_fused_serving.py's store and bags: every
response field, the packed pull byte for byte, the drained rule counts.
The port runs on 8 virtual CPU devices (platform.force_virtual_devices),
the reference on conftest's 8 virtual CPU devices."""
import importlib.util
import pathlib
import threading

import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs

from istio_tpu_torch import interop, platform
from istio_tpu_torch.attribute.bag import bag_from_mapping
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

FIELDS = ("status_code", "status_message", "valid_duration_s",
          "valid_use_count", "referenced", "referenced_presence",
          "deny_rule")
ARGS = dict(initial_prewarm=False, rulestats_drain_s=0,
            batch_window_s=0.001)
MESH_BUCKETS = (16, 64, 256)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: the suite runs in several worker processes."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fused_serving_module():
    path = pathlib.Path(__file__).with_name("test_fused_serving.py")
    spec = importlib.util.spec_from_file_location("_fused_world", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FS = _fused_serving_module()


def _dicts() -> list[dict]:
    """test_fused_serving's bags as mappings, padded to a dp-divisible
    count (check_many bypasses the batcher's bucket padding)."""
    out = [{k: b.get(k)[0] for k in b.names()} for b in FS._bags()]
    while len(out) % 4:
        out.append({"request.path": "/pad"})
    return out


@pytest.fixture(scope="module")
def servers():
    """The port's plain and (4, 2) mesh servers and the reference's mesh
    server, over the same store."""
    with platform.force_virtual_devices(8, "cpu"):
        plain = RuntimeServer(interop.store_from_reference(FS._store()),
                              ServerArgs(**ARGS), device="cpu")
        mesh = RuntimeServer(interop.store_from_reference(FS._store()),
                             ServerArgs(mesh_shape=(4, 2),
                                        buckets=MESH_BUCKETS, **ARGS),
                             device="cpu")
    ref = RefServer(FS._store(), RefArgs(mesh_shape=(4, 2),
                                         buckets=MESH_BUCKETS, audit=False,
                                         **ARGS))
    yield plain, mesh, ref
    for s in (plain, mesh, ref):
        s.close()


def _same(got, want, label: str) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for f in FIELDS:
            gv, wv = getattr(g, f, None), getattr(w, f, None)
            if f == "referenced":
                gv, wv = sorted(map(str, gv)), sorted(map(str, wv))
            assert gv == wv, f"{label} case {i} {f}: {gv!r} != {wv!r}"


def test_mesh_server_is_sharded(servers):
    _, mesh, _ = servers
    plan = mesh.controller.dispatcher.fused
    step = plan.engine._step
    assert getattr(step, "mesh", None) is not None
    assert step.mesh.shape == {"dp": 4, "mp": 2}


def test_mesh_server_matches_plain_and_reference(servers):
    plain, mesh, ref = servers
    dicts = _dicts()
    rp = plain.check_many([bag_from_mapping(d) for d in dicts])
    rm = mesh.check_many([bag_from_mapping(d) for d in dicts])
    rr = ref.check_many([ref_bag(d) for d in dicts])
    _same(rm, rp, "mesh vs plain")
    _same(rm, rr, "mesh vs reference mesh")
    assert {r.status_code for r in rm} >= {0, 5, 7}


@pytest.mark.parametrize("long_path", [False, True])
def test_packed_pull_is_byte_identical(servers, long_path):
    plain, mesh, ref = servers
    dicts = [d for d in _dicts()
             if long_path or len(d.get("request.path", "")) <= 32]
    while len(dicts) % 4:
        dicts.append({"request.path": "/pad"})
    pd, md, rd = (s.controller.dispatcher for s in (plain, mesh, ref))
    bags = [bag_from_mapping(d) for d in dicts]
    ns = md._request_ns_ids(bags)
    a = pd.fused.packed_check(pd.snapshot.tensorizer.tensorize(bags), ns,
                              observe=False)
    h = md.fused.packed_check(md.snapshot.tensorizer.tensorize(bags), ns,
                              observe=False)
    rbags = [ref_bag(d) for d in dicts]
    r = rd.fused.packed_check(rd.snapshot.tensorizer.tensorize(rbags),
                              rd._request_ns_ids(rbags), observe=False)
    assert h.tobytes() == a.tobytes()
    assert h.tobytes() == r.tobytes()


def test_rule_counts_match_plain(servers):
    plain, mesh, _ = servers
    for s in (plain, mesh):
        s.rulestats.drain()
    before = [dict(s.rulestats.counts()) for s in (plain, mesh)]
    dicts = _dicts()
    plain.check_many([bag_from_mapping(d) for d in dicts])
    mesh.check_many([bag_from_mapping(d) for d in dicts])
    after = []
    for s in (plain, mesh):
        s.rulestats.drain()
        after.append(dict(s.rulestats.counts()))
    delta = [{k: v for k, v in a.items() if b.get(k) != v}
             for a, b in zip(after, before)]
    assert delta[0] and delta[0] == delta[1]


def test_batched_check_through_the_mesh_server(servers):
    """Single checks coalesced by the batcher (padded to a dp-divisible
    bucket) through the sharded step equal the plain server's."""
    plain, mesh, _ = servers
    dicts = [{"request.path": f"/admin/{i}"} if i % 2 else
             {"request.path": f"/ok/{i}"} for i in range(10)]
    want = plain.check_many([bag_from_mapping(d) for d in dicts])
    got: list = [None] * len(dicts)

    def one(i):
        got[i] = mesh.check(bag_from_mapping(dicts[i]))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(dicts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    _same(got, want, "batched")


def test_mesh_requires_divisible_buckets():
    with platform.force_virtual_devices(8, "cpu"):
        with pytest.raises(ValueError, match="divisible"):
            RuntimeServer(interop.store_from_reference(FS._store()),
                          ServerArgs(mesh_shape=(4, 2), buckets=(6, 64),
                                     **ARGS), device="cpu")


def test_mesh_requires_fused():
    with platform.force_virtual_devices(8, "cpu"):
        with pytest.raises(ValueError, match="fused=True"):
            RuntimeServer(interop.store_from_reference(FS._store()),
                          ServerArgs(mesh_shape=(4, 2), fused=False,
                                     **ARGS), device="cpu")


def test_mesh_larger_than_the_devices_raises():
    """Without force_virtual_devices the mesh is built over the physical
    cards (none here), and a mesh larger than that raises."""
    have = len(platform.devices())
    with pytest.raises(ValueError, match=f"need {have + 8} devices"):
        RuntimeServer(interop.store_from_reference(FS._store()),
                      ServerArgs(mesh_shape=(have + 8, 1),
                                 buckets=(64 * (have + 8),), **ARGS),
                      device="cpu")
