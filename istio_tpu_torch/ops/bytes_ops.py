"""Byte-string predicates and the multi-pattern DFA scan over padded
uint8 planes.

Strings that take part in glob/regex/prefix/suffix predicates ride as
fixed-width ``uint8[B, L]`` rows plus ``int32[B]`` lengths. Two of the
functions here are kernels, each a wrapper around a hand-written CUDA
kernel with its plain PyTorch version beside it:

  dfa_scan   (csrc/dfa_scan.cu)   multi-pattern DFA acceptance; replaces
             the JAX package's dfa_match / dfa_match_many /
             dfa_match_many_onehot / dfa_match_many_onehot_blocked
  byte_pred  (csrc/byte_pred.cu)  constant startsWith / endsWith /
             exact / glob over one subject; replaces prefix_match /
             suffix_match / exact_match / glob_match

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel (or raises). The runtime-pattern predicates
(dyn_*) and lex_cmp stay torch code.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from istio_tpu_torch import kernels

# byte_pred kinds (csrc/byte_pred.cu)
PREFIX, SUFFIX, EXACT = 0, 1, 2


def _kernel_or_plain(*tensors: torch.Tensor) -> bool:
    """True → launch the kernel (every tensor on CUDA); False → plain
    version (every tensor on the CPU). Anything else raises: there is
    no fallback from a CUDA tensor to the plain version."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        return True
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed/unsupported devices: {types}")


def _rows(t: torch.Tensor, name: str) -> torch.Tensor:
    """A [B, L] byte plane whose rows are unit-stride (a slice of
    str_bytes or a broadcast constant row keeps its row stride)."""
    if t.dim() != 2 or t.dtype != torch.uint8:
        raise ValueError(f"{name}: want uint8 [B, L], got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t if t.stride(1) == 1 else t.contiguous()


def _lens(t: torch.Tensor, b: int) -> torch.Tensor:
    if t.dim() != 1 or t.shape[0] != b or t.dtype != torch.int32:
        raise ValueError(f"lens: want int32 [{b}], got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t


# ---------------------------------------------------------------------------
# K3: constant byte predicates
# ---------------------------------------------------------------------------

def glob_kind(pattern: str) -> tuple[int, bytes]:
    """The `match()` extern with a constant pattern (externs.go:108-116):
    trailing '*' = prefix, leading '*' = suffix, else exact."""
    pb = pattern.encode()
    if pb.endswith(b"*"):
        return PREFIX, pb[:-1]
    if pb.startswith(b"*"):
        return SUFFIX, pb[1:]
    return EXACT, pb


@dataclasses.dataclass(eq=False)
class BytePatterns:
    """P constant patterns for one byte_pred launch: pats uint8 [P, Lp]
    (zero padded), plens int32 [P], kind int32 [P] (PREFIX / SUFFIX /
    EXACT). Host arrays; device copies are made once per device."""
    pats: np.ndarray
    plens: np.ndarray
    kind: np.ndarray

    def __post_init__(self) -> None:
        self._dev: dict[torch.device, tuple] = {}

    @classmethod
    def of(cls, items: list[tuple[int, bytes]]) -> "BytePatterns":
        lp = max((len(p) for _, p in items), default=1) or 1
        pats = np.zeros((len(items), lp), np.uint8)
        plens = np.zeros(len(items), np.int32)
        kind = np.zeros(len(items), np.int32)
        for i, (k, p) in enumerate(items):
            pats[i, :len(p)] = np.frombuffer(p, np.uint8)
            plens[i] = len(p)
            kind[i] = k
        return cls(pats, plens, kind)

    @property
    def n(self) -> int:
        return int(self.plens.shape[0])

    def on(self, device: torch.device) -> tuple:
        t = self._dev.get(device)
        if t is None:
            t = (torch.from_numpy(self.pats).to(device),
                 torch.from_numpy(self.plens).to(device),
                 torch.from_numpy(self.kind).to(device))
            self._dev[device] = t
        return t


def byte_pred_plain(data: torch.Tensor, lens: torch.Tensor,
                    pats: torch.Tensor, plens: torch.Tensor,
                    kind: torch.Tensor) -> torch.Tensor:
    """Plain version of the byte_pred kernel: bool [B, P].

    prefix/suffix: an empty pattern is True, one longer than L False,
    else the k-byte window at 0 (prefix) or lens-k (suffix, offsets
    clipped to the row) equals the pattern and lens >= k. exact: the
    whole row equals the zero-padded pattern and lens == k (False when
    k > L)."""
    b, l = data.shape
    lp = pats.shape[1]
    k = plens.to(torch.int32)[None, :]                        # [1, P]
    pos = torch.arange(lp, dtype=torch.int32, device=data.device)
    lens2 = lens[:, None]                                     # [B, 1]
    start = torch.where(kind[None, :] == SUFFIX, lens2 - k,
                        torch.zeros_like(lens2 - k))          # [B, P]
    idx = (start[:, :, None] + pos).clamp(0, l - 1).long()    # [B, P, Lp]
    win = torch.gather(data[:, None, :].expand(b, k.shape[1], l), 2, idx)
    eq = (win == pats[None]) | (pos >= k[:, :, None])
    window_ok = eq.all(dim=2) & (lens2 >= k)
    ps = torch.where(k == 0, True, window_ok) & ~(k > l)
    # exact: compare all L bytes against the pattern padded to L
    w = max(l, lp)
    row = torch.zeros((b, w), dtype=torch.uint8, device=data.device)
    row[:, :l] = data
    pad = torch.zeros((pats.shape[0], w), dtype=torch.uint8,
                      device=data.device)
    pad[:, :lp] = pats
    ex = (row[:, None, :] == pad[None]).all(dim=2) & (lens2 == k) & ~(k > l)
    return torch.where(kind[None, :] == EXACT, ex, ps)


_BYTE_PRED_ARGS = [kernels.VP, kernels.I64, kernels.VP, kernels.I64,
                   kernels.I32, kernels.I32, kernels.VP, kernels.VP,
                   kernels.VP, kernels.I32, kernels.I32, kernels.VP,
                   kernels.VP]


def byte_pred(data: torch.Tensor, lens: torch.Tensor,
              patterns: BytePatterns) -> torch.Tensor:
    """Constant prefix / suffix / exact predicates of one subject plane
    against P patterns in one launch → bool [B, P]."""
    data = _rows(data, "data")
    b, l = data.shape
    _lens(lens, b)
    pats, plens, kind = patterns.on(data.device)
    if not _kernel_or_plain(data, lens):
        return byte_pred_plain(data, lens, pats, plens, kind)
    out = torch.empty((b, patterns.n), dtype=torch.bool, device=data.device)
    if b == 0 or patterns.n == 0:
        return out
    fn = kernels.function("byte_pred", "byte_pred", _BYTE_PRED_ARGS)
    rc = fn(kernels.ptr(data), data.stride(0), kernels.ptr(lens),
            lens.stride(0), b, l, kernels.ptr(pats), kernels.ptr(plens),
            kernels.ptr(kind), patterns.n, pats.shape[1], kernels.ptr(out),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("byte_pred", kernels.check(rc, "byte_pred"), data, lens,
                     patterns)
    return out


# ---------------------------------------------------------------------------
# runtime-pattern predicates and ordered compare (torch code)
# ---------------------------------------------------------------------------

def _take_rows(data: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    return torch.gather(data, 1, offs.long())


def dyn_prefix_match(s_data, s_lens, p_data, p_lens) -> torch.Tensor:
    """startsWith with a RUNTIME prefix: both sides are byte planes.
    [B, L] × [B, L] → bool [B]."""
    l = s_data.shape[1]
    pos = torch.arange(l, dtype=torch.int32, device=s_data.device)[None, :]
    eq = (s_data == p_data) | (pos >= p_lens[:, None])
    return eq.all(dim=1) & (s_lens >= p_lens)


def dyn_suffix_match(s_data, s_lens, p_data, p_lens,
                     p_shift: int = 0) -> torch.Tensor:
    """endsWith with a RUNTIME suffix: compare s's last (p_len - shift)
    bytes against p[shift:] (shift=1 serves `*x` globs)."""
    l = s_data.shape[1]
    k = p_lens - p_shift                       # effective suffix length
    pos = torch.arange(l, dtype=torch.int32, device=s_data.device)[None, :]
    offs = (pos + (s_lens - k)[:, None]).clamp(0, l - 1)
    window = _take_rows(s_data, offs)
    p_cmp = torch.roll(p_data, -p_shift, dims=1) if p_shift else p_data
    eq = (window == p_cmp) | (pos >= k[:, None])
    return eq.all(dim=1) & (s_lens >= k) & (k >= 0)


def dyn_exact_match(s_data, s_lens, p_data, p_lens) -> torch.Tensor:
    return (s_data == p_data).all(dim=1) & (s_lens == p_lens)


def dyn_glob_match(s_data, s_lens, p_data, p_lens) -> torch.Tensor:
    """match() with a RUNTIME pattern (externs.go:108-116 semantics):
    trailing '*' = prefix of p[:-1], leading '*' = suffix of p[1:],
    else exact. All three candidate verdicts are computed and selected."""
    l = s_data.shape[1]
    star = ord("*")
    last = _take_rows(p_data, (p_lens - 1).clamp(0, l - 1)[:, None])[:, 0]
    trailing = (p_lens > 0) & (last == star)
    leading = (p_lens > 0) & (p_data[:, 0] == star)
    prefix = dyn_prefix_match(s_data, s_lens, p_data,
                              (p_lens - 1).clamp(min=0))
    suffix = dyn_suffix_match(s_data, s_lens, p_data, p_lens, p_shift=1)
    exact = dyn_exact_match(s_data, s_lens, p_data, p_lens)
    return torch.where(trailing, prefix, torch.where(leading, suffix, exact))


def lex_cmp(a_data: torch.Tensor, a_lens: torch.Tensor,
            b_data: torch.Tensor, b_lens: torch.Tensor) -> torch.Tensor:
    """Row-wise lexicographic comparison of two padded byte planes →
    int32 [B] in {-1, 0, 1} (sign of a ⋛ b). Padding is zero, so a
    strict prefix sorts first; the length tiebreak settles embedded
    NULs. Truncation handling lives in the caller
    (tensor_expr._compile_cmp)."""
    diff = a_data != b_data                       # [B, L]
    has = diff.any(dim=1)
    first = diff.to(torch.uint8).argmax(dim=1)[:, None]
    av = torch.gather(a_data, 1, first)[:, 0].to(torch.int32)
    bv = torch.gather(b_data, 1, first)[:, 0].to(torch.int32)
    byte_cmp = torch.sign(av - bv)
    len_cmp = torch.sign(a_lens - b_lens).to(torch.int32)
    return torch.where(has, byte_cmp, len_cmp)


# ---------------------------------------------------------------------------
# bit lanes
# ---------------------------------------------------------------------------

def pack_bits(a: np.ndarray) -> np.ndarray:
    """Host-side bit packing of a bool/0-1 array along its LAST axis →
    uint32 lanes, little-endian bit order within each 32-bit word,
    width ceil(n/32). The storage format of the engine's attr mask
    (params["pe_attr_mask_bits"]); `unpack_bits` is its inverse."""
    a = np.ascontiguousarray(np.asarray(a) != 0)
    n = a.shape[-1]
    w = max((n + 31) // 32, 0)
    padded = np.zeros(a.shape[:-1] + (w * 32,), bool)
    padded[..., :n] = a
    packed8 = np.ascontiguousarray(
        np.packbits(padded, axis=-1, bitorder="little"))
    return packed8.view(np.uint32)


def unpack_bits(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of pack_bits: uint32 (or int32-viewed) lanes [..., W] →
    bool [..., n], little-endian within each word."""
    lanes = packed.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (lanes[..., None] >> shifts) & 1
    flat = bits.reshape(packed.shape[:-1] + (-1,))
    return flat[..., :n] != 0


# ---------------------------------------------------------------------------
# K2: multi-pattern DFA scan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(eq=False)
class DfaBank:
    """N automata in one global state space, class-compressed
    (regex_dfa.pack_dfas_classes): table int32 [S, C] = gt[:, rep]
    (next global state per (state, byte class)), class_of int32 [256],
    starts int32 [N], accept uint8 [S, N]."""
    table: np.ndarray
    class_of: np.ndarray
    starts: np.ndarray
    accept: np.ndarray

    def __post_init__(self) -> None:
        self._dev: dict[torch.device, tuple] = {}

    @classmethod
    def of(cls, classes: dict) -> "DfaBank":
        return cls(
            table=np.ascontiguousarray(
                classes["gt"][:, classes["rep"]].astype(np.int32)),
            class_of=np.asarray(classes["class_of"], np.int32),
            starts=np.asarray(classes["starts"], np.int32),
            accept=np.ascontiguousarray(
                (classes["accept"] > 0.5).astype(np.uint8)))

    @property
    def n(self) -> int:
        return int(self.starts.shape[0])

    def on(self, device: torch.device) -> tuple:
        t = self._dev.get(device)
        if t is None:
            t = tuple(torch.from_numpy(a).to(device) for a in
                      (self.table, self.class_of, self.starts, self.accept))
            self._dev[device] = t
        return t


def dfa_scan_plain(data: torch.Tensor, lens: torch.Tensor,
                   table: torch.Tensor, class_of: torch.Tensor,
                   starts: torch.Tensor, accept: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of the dfa_scan kernel: every pattern walks each
    row's first min(len, L) bytes from its start state; → bool [B, N]
    = accept[final state, pattern]."""
    b, l = data.shape
    n = starts.shape[0]
    state = starts.long()[None, :].expand(b, n)
    n_cls = table.shape[1]
    flat = table.reshape(-1).long()
    steps = int(min(int(lens.max()), l)) if b else 0
    for i in range(steps):
        cls = class_of.long()[data[:, i].long()]                  # [B]
        nxt = flat[state * n_cls + cls[:, None]]
        state = torch.where((i < lens)[:, None], nxt, state)
    cols = torch.arange(n, device=data.device)[None, :]
    return accept[state, cols] != 0


_DFA_ARGS = [kernels.VP, kernels.I64, kernels.VP, kernels.I64, kernels.I32,
             kernels.I32, kernels.VP, kernels.VP, kernels.VP, kernels.VP,
             kernels.I32, kernels.I32, kernels.I32, kernels.VP, kernels.VP]


def dfa_scan(data: torch.Tensor, lens: torch.Tensor,
             bank: DfaBank) -> torch.Tensor:
    """Multi-pattern DFA acceptance of N patterns over B subject rows in
    one launch → bool [B, N] (Go regexp.MatchString search semantics
    for the regex_dfa subset; rows stop at their own length)."""
    data = _rows(data, "data")
    b, l = data.shape
    _lens(lens, b)
    table, class_of, starts, accept = bank.on(data.device)
    if not _kernel_or_plain(data, lens):
        return dfa_scan_plain(data, lens, table, class_of, starts, accept)
    out = torch.empty((b, bank.n), dtype=torch.bool, device=data.device)
    if b == 0:
        return out
    fn = kernels.function("dfa_scan", "dfa_scan", _DFA_ARGS)
    rc = fn(kernels.ptr(data), data.stride(0), kernels.ptr(lens),
            lens.stride(0), b, l, kernels.ptr(table), kernels.ptr(class_of),
            kernels.ptr(starts), kernels.ptr(accept), table.shape[0],
            table.shape[1], bank.n, kernels.ptr(out),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("dfa_scan", kernels.check(rc, "dfa_scan"), data, lens,
                     bank)
    return out
