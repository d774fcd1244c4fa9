"""Mesh construction + sharding rules for the batched policy step.

Port of istio_tpu/parallel/mesh.py. A Mesh is a dp × mp array of
(virtual) devices (platform.py) with axis names ("dp", "mp"):

    batch rows          over dp, replicated over mp
    conj_m_idx / conj_n_idx [R, K]   rules over mp (param_shardings)
    matched / err       [B/dp, R/mp] per shard
    everything else     replicated

`shard_engine_check(mesh, engine)` is the sharded PolicyEngine step.
Shard (d, m) runs, on its own device's stream, the whole match of its
rows against its rule slice (atom stages, dfa_scan, byte_pred and
rule_match: K1–K3) and the list banks of the lists whose rules it
holds; the mesh_fold kernel (K13, parallel/mesh_fold.py) then reduces
over the rule axis — a partial per shard, a combine per dp shard, the
quota rank over the whole batch per dp replica — and the dp outputs,
with the matched / err planes, are gathered onto the engine's device.
The result is bit-identical to the unsharded step, quota counters
included, as jax.jit with these shardings is in the reference.

On one card every device of a mesh is a virtual device
(platform.force_virtual_devices): the gathers are stream waits, the
partitioning and every cross-shard combine run for real, and only the
transport between two physical cards (peer copies) is not exercised.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from istio_tpu_torch import platform
from istio_tpu_torch.compiler.layout import AttributeBatch
from istio_tpu_torch.parallel.mesh_fold import (FoldPart, gather_plane,
                                                mesh_fold)
from istio_tpu_torch.platform import VirtualDevice, fork, handed_over

__all__ = ["Mesh", "MeshSpec", "policy_mesh", "batch_sharding", "shard_batch",
           "param_shardings", "shard_engine_check", "mesh_stage_probe",
           "axis_devices", "rule_slices"]


@dataclasses.dataclass(eq=False)
class Mesh:
    """An n-d array of devices with one name per axis."""
    devices: np.ndarray            # object array of VirtualDevice
    axis_names: tuple[str, ...]

    def __post_init__(self) -> None:
        self.devices = np.asarray(self.devices, dtype=object)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d device array, axis "
                             f"names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def axis_devices(mesh: Mesh, axis: str) -> list[VirtualDevice]:
    """The devices along `axis` (index 0 of every other axis)."""
    i = mesh.axis_names.index(axis)
    arr = np.moveaxis(mesh.devices, i, 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """dp × mp factorization of the available devices."""
    dp: int
    mp: int = 1

    def build(self, devices: Sequence[VirtualDevice] | None = None) -> Mesh:
        devs = list(devices if devices is not None else platform.devices())
        need = self.dp * self.mp
        if len(devs) < need:
            raise ValueError(f"need {need} devices, have {len(devs)}")
        arr = np.empty(need, dtype=object)
        arr[:] = devs[:need]
        return Mesh(arr.reshape(self.dp, self.mp), axis_names=("dp", "mp"))


def policy_mesh(n_devices: int | None = None, rule_shards: int = 1) -> Mesh:
    """Default mesh: dp × mp with `rule_shards` devices on the rule axis."""
    n = n_devices if n_devices is not None else len(platform.devices())
    if n % rule_shards:
        raise ValueError(f"{n} devices not divisible by mp={rule_shards}")
    return MeshSpec(dp=n // rule_shards, mp=rule_shards).build()


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Leading (batch) dim over `axis`, everything else replicated (the
    reference's NamedSharding(mesh, P("dp")))."""
    mesh: Mesh
    axis: str = "dp"


def batch_sharding(mesh: Mesh) -> RowSharding:
    """Prefix sharding for an AttributeBatch: batch rows over dp."""
    return RowSharding(mesh, "dp")


def _row_shards(mesh: Mesh, b: int) -> int:
    dp = mesh.shape["dp"]
    if b % dp:
        raise ValueError(f"batch of {b} rows is not divisible by dp={dp}")
    return b // dp


def shard_batch(mesh: Mesh, batch: AttributeBatch
                ) -> list[list[AttributeBatch]]:
    """Place an AttributeBatch with its rows over dp: [d][m] is dp shard
    d's rows on device (d, m) (replicated over mp), each copy queued on
    that device's stream."""
    bd = _row_shards(mesh, int(batch.ids.shape[0]))
    out = []
    for d, row in enumerate(mesh.devices):
        rows = batch.rows(d * bd, (d + 1) * bd)
        placed = []
        for vd in row:
            with vd.scope():
                placed.append(rows.to(vd.device))
        out.append(placed)
    return out


def param_shardings(mesh: Mesh, engine) -> dict:
    """THE param-sharding policy for the dp/mp layout: every non-rule-
    axis param replicates (an empty spec); only the [R, K] conjunction
    matrices shard their rule axis over mp. One home — the sharded step
    and mesh_stage_probe both read it."""
    spec = {k: () for k in engine.params}
    spec["conj_m_idx"] = ("mp",)
    spec["conj_n_idx"] = ("mp",)
    return spec


def rule_slices(n_rows: int, mp: int) -> list[tuple[int, int]]:
    """The mp contiguous rule slices [r0, r1) of an n_rows rule axis,
    ceil(n_rows / mp) rules each (the last may be shorter)."""
    if n_rows < mp:
        raise ValueError(f"{n_rows} rule rows cannot be split over mp={mp}")
    size = -(-n_rows // mp)
    return [(m * size, min((m + 1) * size, n_rows)) for m in range(mp)]


def _place_params(params, spec: dict, device: torch.device,
                  r0: int, r1: int) -> dict:
    """One shard's params on `device`: rule-axis params sliced to [r0,
    r1) (a row slice of a contiguous [R, K] matrix stays contiguous),
    the rest replicated."""
    out = {}
    for k, v in params.items():
        if spec.get(k, ()) == ("mp",):
            v = v[r0:r1]
        out[k] = v.to(device)
    return out


def _check_mesh(mesh: Mesh, engine) -> None:
    if tuple(mesh.axis_names) != ("dp", "mp"):
        raise ValueError(f"a policy mesh has axes ('dp', 'mp'), got "
                         f"{mesh.axis_names}")
    kinds = {vd.device.type for vd in mesh.devices.flat}
    if kinds != {engine.device.type}:
        raise ValueError(f"mesh devices {sorted(kinds)} do not match the "
                         f"engine's {engine.device}")


def _as_req(req_ns: Any, device: torch.device) -> torch.Tensor:
    if isinstance(req_ns, torch.Tensor):
        return req_ns.to(dtype=torch.int32)
    return torch.from_numpy(np.asarray(req_ns, np.int32)).to(device)


def _match_shards(mesh: Mesh, engine, spec: dict, params, batch, req,
                  slices, ev0) -> list[list[FoldPart]]:
    """Every shard's match on its own stream: its rows (placed on its
    device), its rule slice of the params, K1–K3 and its lists' banks."""
    bd = _row_shards(mesh, int(batch.ids.shape[0]))
    parts = []
    for d, row in enumerate(mesh.devices):
        rows = batch.rows(d * bd, (d + 1) * bd)
        out = []
        for m, vd in enumerate(row):
            r0, r1 = slices[m]
            vd.wait(ev0)
            with vd.scope():
                bt = rows.to(vd.device)
                rq = req[d * bd:(d + 1) * bd].to(vd.device).contiguous()
                pm = _place_params(params, spec, vd.device, r0, r1)
                matched, _, err = engine.ruleset.fn(pm, bt,
                                                    ("matched", "err"))
                lstate = engine.list_states(bt, err, (r0, r1))
                lk = engine._list_kind.to(vd.device) \
                    if lstate is not None else None
            out.append(FoldPart(vd, r0, matched, err, lstate, rq, bt, pm, lk))
        parts.append(out)
    return parts


def shard_engine_check(mesh: Mesh, engine) -> Callable:
    """The PolicyEngine step under the dp/mp layout → fn(params, batch,
    req_ns, quota_counts) → (CheckVerdict, counts), bit-identical to
    engine.raw_step, counts included (updated in place, as raw_step
    does). batch + req_ns shard over dp (the row count must divide by
    dp); the conjunction matrices shard their rule axis over mp; each
    dp replica commits every grant of the batch into its own copy of
    the quota counters (the reference's replicated counts). The
    verdict's planes and fields are gathered onto engine.device, where
    the caller's current stream orders them."""
    from istio_tpu_torch.models.policy_engine import CheckVerdict

    _check_mesh(mesh, engine)
    spec = param_shardings(mesh, engine)
    mp = mesh.shape["mp"]
    home = engine.device

    def step(params, batch: AttributeBatch, req_ns, quota_counts):
        slices = rule_slices(int(params["conj_m_idx"].shape[0]), mp)
        req = _as_req(req_ns, home)
        cur, ev0 = fork(home)
        parts = _match_shards(mesh, engine, spec, params, batch, req, slices,
                              ev0)
        status, dur, uses, deny_rule, referenced, err_count = mesh_fold(
            parts, params, quota_counts, engine.fold_consts,
            engine._list_kind, home)
        # mesh_fold joined every shard stream into the caller's
        for row in parts:
            for p in row:
                handed_over(p.matched, cur)
                handed_over(p.err, cur)
        verdict = CheckVerdict(
            status=status, valid_duration_s=dur, valid_use_count=uses,
            referenced=referenced,
            matched=gather_plane(parts, "matched", home),
            err=gather_plane(parts, "err", home), deny_rule=deny_rule,
            err_count=err_count)
        return verdict, quota_counts

    step.mesh = mesh
    return step


def mesh_stage_probe(mesh: Mesh, engine, batch: AttributeBatch, req_ns,
                     steps: int = 3, reps: int = 2) -> dict:
    """Per-stage times of the sharded check step, median over `reps` of
    `steps` chained calls each (CUDA events on the engine's card; the
    host clock on the CPU, reported under "clock"):

      shard_dispatch_ms    placing the batch rows on every device
                           (shard_batch) per step
      match_ms             every shard's match alone (K1–K3 per shard),
                           outputs left sharded: no cross-shard work
      full_step_ms         match + the sharded verdict fold (mesh_fold's
                           partial, combine and gathers)
      fold_collectives_ms  full − match: the fold plus every gather it
                           forces"""
    _check_mesh(mesh, engine)
    home = engine.device
    spec = param_shardings(mesh, engine)
    slices = rule_slices(int(engine.params["conj_m_idx"].shape[0]),
                         mesh.shape["mp"])
    full_fn = shard_engine_check(mesh, engine)
    staged = batch.to(home)
    req = _as_req(req_ns, home).to(home)
    counts = engine.quota_counts.clone()
    cuda = home.type == "cuda"

    def run_timed(fn) -> float:
        fn()
        ts = []
        for _ in range(reps):
            if cuda:
                torch.cuda.synchronize(home)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(steps):
                    fn()
                end.record()
                torch.cuda.synchronize(home)
                ts.append(start.elapsed_time(end) / steps)
            else:
                t0 = time.perf_counter()
                for _ in range(steps):
                    fn()
                ts.append((time.perf_counter() - t0) * 1e3 / steps)
        return sorted(ts)[len(ts) // 2]

    def dispatch():
        shard_batch(mesh, batch)
        _join(mesh, home)

    def match():
        _match_shards(mesh, engine, spec, engine.params, staged, req,
                      slices, fork(home)[1])
        _join(mesh, home)

    def full():
        full_fn(engine.params, staged, req, counts)

    t_disp = run_timed(dispatch)
    t_match = run_timed(match)
    t_full = run_timed(full)
    return {"shard_dispatch_ms": t_disp, "match_ms": t_match,
            "full_step_ms": t_full,
            "fold_collectives_ms": max(t_full - t_match, 0.0),
            "clock": "cuda_events" if cuda else "host",
            "mesh": dict(mesh.shape)}


def _join(mesh: Mesh, home: torch.device) -> None:
    """Order the caller's stream on `home` after every device's work."""
    if home.type != "cuda":
        return
    cur = torch.cuda.current_stream(home)
    for vd in mesh.devices.flat:
        ev = vd.record()
        if ev is not None:
            cur.wait_event(ev)
