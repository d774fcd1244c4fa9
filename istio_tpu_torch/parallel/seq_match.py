"""Sequence-parallel DFA matching — long strings sharded across devices.

Port of istio_tpu/parallel/seq_match.py. The byte-predicate device path
stores at most `max_str_len` bytes per slot; this is the long-subject
building block: shard a row's byte axis over a mesh axis and run the
SAME dense DFAs (ops/regex_dfa.py) with one gather.

A chunk of input induces a transition MAP f: S → S ("enter the chunk in
state s, leave in f[s]"), and maps compose. Each shard walks only its
own chunks, for every entry state at once (the seq_match kernel's
`chunk_map` entry, K12), composes them left to right (`compose_maps`),
and the [B, S] shard maps are gathered onto the first device of the
axis and composed there, from entry state 0, into accept[final]
(`compose_maps` with the accept gather fused). Acceptance stays a
final-state lookup because compiled unanchored DFAs make accepting
states sticky (regex_dfa.py DFA).

Every function takes tensors on the CPU (the plain versions run) or on
a card (the kernel launches; a CUDA tensor never falls back).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.parallel.mesh import Mesh, axis_devices
from istio_tpu_torch.platform import fork, handed_over

# ---------------------------------------------------------------------------
# K12: seq_match (csrc/seq_match.cu)
# ---------------------------------------------------------------------------

REG_STATES = (8, 16, 32)   # entry states a thread walks in registers (kS)
PATH_LANES_SMEM, PATH_LANES_L1 = 0, -1
SUB_LEN = 128              # bytes a register walk takes before composing
MAX_SUBS = 8               # sub-chunks of one chunk (threads of one block)
MAX_SMEM = 232448          # 227 KB a block on sm_90


class ChunkPlan(NamedTuple):
    """One chunk_map launch (the C entry point's plan arguments): `path`
    the register bucket kS (8, 16, 32) or a lanes path (PATH_LANES_SMEM:
    one thread per entry state, the table byte-major in shared memory;
    PATH_LANES_L1: read through L1); `subs` sub-chunks of `sub_len` bytes
    a chunk, each a thread, composed by the first."""
    path: int
    subs: int
    sub_len: int


def lanes_smem(s: int) -> int:
    """Shared memory of a lanes-path block: the absorbing-state bit words
    (padded to 4) and the [256, S] int32 table."""
    return 4 * ((-(-s // 32) + 3) // 4 * 4 + 256 * s)


def chunk_plan(lc: int, s: int, *, sub_len: int = SUB_LEN) -> ChunkPlan:
    """The plan of a chunk_map launch over chunks of lc bytes under an
    S-state DFA. The wrapper always takes the default sub_len; the
    keyword lets a measurement script time other sub-chunk lengths."""
    if sub_len < 16 or sub_len % 16:
        raise ValueError(f"chunk_plan: sub_len must be a multiple of 16, "
                         f"got {sub_len}")
    if s > REG_STATES[-1]:
        path = PATH_LANES_SMEM if lanes_smem(s) <= MAX_SMEM else \
            PATH_LANES_L1
        return ChunkPlan(path, 1, max(lc, 1))
    path = next(k for k in REG_STATES if s <= k)
    subs = 1
    while subs < MAX_SUBS and subs * sub_len < lc:
        subs *= 2
    # sub-chunk starts keep the chunk's alignment within a 16-byte word
    eff = max(lc, 1) if subs == 1 else 16 * -(-lc // (16 * subs))
    return ChunkPlan(path, subs, eff)


def chunk_maps_plain(data: torch.Tensor, lens: torch.Tensor,
                     transitions: torch.Tensor, c0: int = 0
                     ) -> torch.Tensor:
    """Plain version of the chunk_map entry: data uint8 [B, C, Lc] holds
    chunks c0 .. c0 + C - 1 of each row, lens int32 [B] the rows' TOTAL
    lengths → maps int32 [C, B, S]: the state after chunk c's
    clip(lens - (c0 + c)·Lc, 0, Lc) bytes from every entry state s (the
    reference's chunk_transition_map scan, one chunk per column)."""
    b, c, lc = data.shape
    s = int(transitions.shape[0])
    dev = data.device
    starts = (torch.arange(c, device=dev, dtype=torch.int64) + c0) * lc
    local = (lens.to(torch.int64)[:, None] - starts[None, :]).clamp(0, lc)
    flat = transitions.reshape(-1).to(torch.int64)
    state = torch.arange(s, device=dev, dtype=torch.int64) \
        .expand(b, c, s).clone()
    for i in range(int(local.max()) if local.numel() else 0):
        byte = data[:, :, i].to(torch.int64)[:, :, None]
        nxt = flat[state * 256 + byte]
        state = torch.where((i < local)[:, :, None], nxt, state)
    return state.to(torch.int32).permute(1, 0, 2).contiguous()


def compose_maps_plain(maps: torch.Tensor, accept: torch.Tensor | None = None,
                       entry: int = 0) -> torch.Tensor:
    """Plain version of the compose_maps entry: left-to-right composition
    of maps int32 [C, B, S] → [B, S], out[b, s] = f_{C-1}(… f_0(s)); with
    `accept` bool [S] → bool [B] = accept[out[b, entry]]."""
    c, b, s = maps.shape
    acc = torch.arange(s, device=maps.device, dtype=torch.int64) \
        .expand(b, s)
    for i in range(c):
        acc = torch.gather(maps[i].to(torch.int64), 1, acc)
    if accept is None:
        return acc.to(torch.int32)
    return accept.to(torch.bool)[acc[:, entry]]


_K = kernels
_CHUNK_ARGS = [_K.VP, _K.I64, _K.I32, _K.VP, _K.I32, _K.I32, _K.I32, _K.VP,
               _K.I32, _K.VP] + [_K.I32] * 3 + [_K.VP]
_COMPOSE_ARGS = [_K.VP, _K.I32, _K.I32, _K.I32, _K.VP, _K.I32, _K.VP, _K.VP]


def _on_card(*tensors: torch.Tensor) -> bool:
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(f"seq_match: tensors on mixed/unsupported "
                         f"devices: {sorted({str(t.device) for t in tensors})}")
    return True


def chunk_maps(data: torch.Tensor, lens: torch.Tensor,
               transitions: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """Transition maps int32 [C, B, S] of the chunks data uint8 [B, C, Lc]
    (chunk index c0 + c of each row; lens int32 [B] TOTAL lengths) under
    transitions int32 [S, 256], in one launch. The chunk axis may be a
    slice of a wider row (a stride of the row); each chunk's bytes are
    unit-stride. The launch follows chunk_plan(Lc, S). CPU tensors run
    chunk_maps_plain."""
    if data.dim() != 3 or data.dtype != torch.uint8:
        raise ValueError(f"chunk_maps: data must be uint8 [B, C, Lc], got "
                         f"{data.dtype} {tuple(data.shape)}")
    b, c, lc = data.shape
    if tuple(lens.shape) != (b,) or lens.dtype != torch.int32:
        raise ValueError(f"chunk_maps: lens must be int32 [{b}]")
    if transitions.dim() != 2 or transitions.shape[1] != 256 or \
            transitions.dtype != torch.int32:
        raise ValueError("chunk_maps: transitions must be int32 [S, 256]")
    if not _on_card(data, lens, transitions):
        return chunk_maps_plain(data, lens, transitions, c0)
    if data.stride(2) != 1 or data.stride(1) != lc:
        raise ValueError("chunk_maps: each row's chunks must be contiguous "
                         "bytes (strides (*, Lc, 1))")
    lens = lens.contiguous()
    transitions = transitions.contiguous()
    s = int(transitions.shape[0])
    plan = chunk_plan(lc, s)
    if c * b * max(s, plan.subs) >= 2 ** 31:
        raise ValueError(f"chunk_maps: {c} x {b} x {s} work items exceed "
                         "the kernel's 32-bit indexing")
    out = torch.empty((c, b, s), dtype=torch.int32, device=data.device)
    if out.numel() == 0:
        return out
    fn = kernels.function("seq_match", "chunk_map", _CHUNK_ARGS)
    rc = fn(kernels.ptr(data), data.stride(0), lc, kernels.ptr(lens), b, c,
            int(c0), kernels.ptr(transitions), s, kernels.ptr(out), *plan,
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("seq_match", kernels.check(rc, "seq_match"), "chunk_map",
                     data, lens, transitions, int(c0), entry="chunk_map")
    return out


def compose(maps: torch.Tensor, accept: torch.Tensor | None = None,
            entry: int = 0) -> torch.Tensor:
    """Left-to-right composition of maps int32 [C, B, S] → int32 [B, S],
    or with `accept` bool [S] → bool [B] = accept[composed[:, entry]], in
    one launch. CPU tensors run compose_maps_plain."""
    if maps.dim() != 3 or maps.dtype != torch.int32:
        raise ValueError(f"compose_maps: maps must be int32 [C, B, S], got "
                         f"{maps.dtype} {tuple(maps.shape)}")
    c, b, s = maps.shape
    if accept is not None and (tuple(accept.shape) != (s,) or
                               accept.dtype != torch.bool):
        raise ValueError(f"compose_maps: accept must be bool [{s}]")
    if not 0 <= entry < max(s, 1):
        raise ValueError(f"compose_maps: entry state {entry} out of range")
    on_card = _on_card(maps) if accept is None else _on_card(maps, accept)
    if not on_card:
        return compose_maps_plain(maps, accept, entry)
    maps = maps.contiguous()
    if accept is None:
        out = torch.empty((b, s), dtype=torch.int32, device=maps.device)
    else:
        accept = accept.contiguous()
        out = torch.empty(b, dtype=torch.bool, device=maps.device)
    if b == 0 or s == 0:
        return out
    if c * b * s >= 2 ** 31:
        raise ValueError(f"compose_maps: {c} x {b} x {s} maps exceed the "
                         "kernel's 32-bit indexing")
    if c == 0:
        ident = torch.arange(s, dtype=torch.int32, device=maps.device)
        return ident.expand(b, s).contiguous() if accept is None else \
            accept[entry].expand(b).contiguous()
    fn = kernels.function("seq_match", "compose_maps", _COMPOSE_ARGS)
    rc = fn(kernels.ptr(maps), c, b, s,
            kernels.VP(0) if accept is None else kernels.ptr(accept),
            int(entry), kernels.ptr(out), kernels.VP(kernels.stream_ptr()))
    kernels.launched("seq_match", kernels.check(rc, "seq_match"),
                     "compose_maps", maps, accept, int(entry),
                     entry="compose_maps")
    return out


# ---------------------------------------------------------------------------
# the reference's public functions
# ---------------------------------------------------------------------------

def chunk_transition_map(chunk: torch.Tensor, chunk_lens: torch.Tensor,
                         transitions: torch.Tensor) -> torch.Tensor:
    """Per-row transition map of one chunk: out[b, s] = state after
    feeding row b's first chunk_lens[b] bytes starting from state s.
    chunk uint8 [B, L], chunk_lens int32 [B], transitions int32 [S, 256]
    → [B, S] int32."""
    return chunk_maps(chunk[:, None, :], chunk_lens, transitions)[0]


def compose_maps(maps: torch.Tensor) -> torch.Tensor:
    """Left-to-right composition of per-chunk maps [C, B, S] → [B, S]:
    out[b, s] = f_{C-1}(... f_1(f_0(s)))."""
    return compose(maps)


def _as_tensor(x: Any, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x if x.dtype == dtype else x.to(dtype)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x))).to(dtype)


def sharded_dfa_match(mesh: Mesh, axis: str, data: Any, lens: Any,
                      transitions: Any, accept: Any) -> torch.Tensor:
    """Match one DFA over rows whose byte axis is sharded over `axis`:
    data [B, C, Lc] uint8 (chunk-major), lens [B] int32 TOTAL lengths,
    transitions [S, 256] int32, accept [S] bool → bool [B] on the first
    device of the axis.

    Shard k of the axis holds chunks [k·C/n, (k+1)·C/n): on its own
    stream it maps them (chunk_map) and composes them left to right
    (compose_maps); the n shard maps are gathered onto the first device
    and composed from entry state 0 into accept[final] (one more
    compose_maps). C must be a multiple of the axis size; tensor inputs
    must lie on the mesh's device type (numpy inputs are copied there)."""
    devs = axis_devices(mesh, axis)
    n = len(devs)
    kind = devs[0].device.type
    for name, x in (("data", data), ("lens", lens),
                    ("transitions", transitions), ("accept", accept)):
        if isinstance(x, torch.Tensor) and x.device.type != kind:
            raise ValueError(f"sharded_dfa_match: {name} is on "
                             f"{x.device}, the mesh on {kind}")
    data_t = _as_tensor(data, torch.uint8)
    if data_t.dim() != 3:
        raise ValueError(f"sharded_dfa_match: data must be [B, C, Lc], got "
                         f"{tuple(data_t.shape)}")
    b, c, lc = data_t.shape
    if c % n:
        raise ValueError(f"chunk count {c} must be a multiple of the "
                         f"'{axis}' axis size {n}")
    lens_t = _as_tensor(lens, torch.int32)
    trans_t = _as_tensor(transitions, torch.int32)
    acc_t = _as_tensor(accept, torch.bool)
    per = c // n
    home = devs[0]
    cur, entry_ev = fork(home.device)
    shard_maps, done = [], []
    for k, vd in enumerate(devs):
        vd.wait(entry_ev)
        with vd.scope():
            dk = data_t[:, k * per:(k + 1) * per].to(vd.device,
                                                     non_blocking=True)
            if dk.stride(2) != 1 or dk.stride(1) != lc:
                dk = dk.contiguous()
            maps = chunk_maps(dk, lens_t.to(vd.device), trans_t.to(vd.device),
                              c0=k * per)
            shard_maps.append(maps[0] if per == 1 else compose(maps))
            done.append(vd.record())
    for ev in done:
        if ev is not None:
            cur.wait_event(ev)
    gathered = torch.stack([handed_over(m, cur).to(home.device)
                            for m in shard_maps])
    return compose(gathered, acc_t.to(home.device), entry=0)
