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

Each source has two entry points: the plane one (byte_pred, dfa_scan:
bool [B, P]) and the literal one (byte_lits, dfa_lits), which writes
every pattern's literal pair (m, n) with the subject group's absence,
error and truncation rules straight into its column of rule_match's ext
planes (the ruleset's path). A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel (or raises). The
runtime-pattern predicates (dyn_*) and lex_cmp stay torch code.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from istio_tpu_torch import kernels

# byte_pred kinds (csrc/byte_pred.cu)
PREFIX, SUFFIX, EXACT = 0, 1, 2
# truncation modes of a literal column (csrc/lit_cols.cuh): where a
# possibly truncated row (ok and len >= max_len) is undecidable — never,
# where the pattern missed, always
TRUNC_SAFE, TRUNC_MISS, TRUNC_ALL = 0, 1, 2


class _OnDevice:
    """Host arrays with one copy per device, made on first use."""

    _fields: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        self._dev: dict[torch.device, tuple] = {}

    def on(self, device: torch.device) -> tuple:
        t = self._dev.get(device)
        if t is None:
            t = tuple(torch.from_numpy(np.ascontiguousarray(
                getattr(self, f))).to(device) for f in self._fields)
            self._dev[device] = t
        return t


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


def _aligned(data: torch.Tensor) -> int:
    """1 where the kernels may read data's rows as 32-bit words: the
    first row and the row stride on a 4-byte boundary, L a multiple
    of 4; else they assemble words from byte loads."""
    return int(data.data_ptr() % 4 == 0 and data.stride(0) % 4 == 0
               and data.shape[1] % 4 == 0)


_SMS: dict[int, int] = {}


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    n = _SMS.get(idx)
    if n is None:
        n = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return n


@dataclasses.dataclass(eq=False)
class LitColumns(_OnDevice):
    """Where a subject group's literal pairs go: mode int32 [k] (each
    column's TRUNC_* mode) and cols int32 [k] (its ext column)."""
    mode: np.ndarray
    cols: np.ndarray
    _fields = ("mode", "cols")

    @classmethod
    def of(cls, modes, cols) -> "LitColumns":
        return cls(np.asarray(modes, np.int32), np.asarray(cols, np.int32))

    @property
    def n(self) -> int:
        return int(self.cols.shape[0])


def write_lits_plain(hit: torch.Tensor, lens: torch.Tensor,
                     ok: torch.Tensor | None, err: torch.Tensor | None,
                     mode: torch.Tensor, cols: torch.Tensor, max_len: int,
                     em: torch.Tensor, en: torch.Tensor) -> None:
    """The literal pair of every column of a subject group, in place:
    ee = err | ~ok, or on a possibly truncated row (ok & len >= max_len)
    where the column's mode says so (TRUNC_ALL always, TRUNC_MISS where
    the pattern missed); em[:, cols] = hit & ~ee, en[:, cols] = ~hit &
    ~ee. ok None: present on every row; err None: never an error."""
    okv = torch.ones_like(lens, dtype=torch.bool) if ok is None else ok
    ee0 = ~okv if err is None else err | ~okv
    maybe = (okv & (lens >= max_len))[:, None]
    und = maybe & ((mode == TRUNC_ALL)[None, :]
                   | ((mode == TRUNC_MISS)[None, :] & ~hit))
    ee = ee0[:, None] | und
    c = cols.long()
    em[:, c] = hit & ~ee
    en[:, c] = ~hit & ~ee


def _lit_planes(em: torch.Tensor, en: torch.Tensor, b: int,
                lits: LitColumns, name: str) -> None:
    for t, nm in ((em, "em"), (en, "en")):
        if t.dim() != 2 or t.shape[0] != b or t.dtype != torch.bool or \
                (t.numel() and t.stride(1) != 1) or \
                (lits.n and int(lits.cols.max()) >= t.shape[1]):
            raise ValueError(f"{name}: {nm} must be a bool [{b}, X] plane "
                             "with unit column stride holding every "
                             "column of the group")
    if em.shape != en.shape or (em.numel() and
                                em.stride(0) != en.stride(0)):
        raise ValueError(f"{name}: em and en differ in shape or stride")


def _masks(ok: torch.Tensor | None, err: torch.Tensor | None, b: int,
           name: str) -> list[torch.Tensor]:
    out = []
    for t, nm in ((ok, "ok"), (err, "err")):
        if t is None:
            continue
        if t.dim() != 1 or t.shape[0] != b or t.dtype != torch.bool:
            raise ValueError(f"{name}: {nm} must be bool [{b}] or None")
        out.append(t)
    return out


def _mask_args(t: torch.Tensor | None) -> tuple:
    return (kernels.VP(None), 0) if t is None else \
        (kernels.ptr(t), t.stride(0))


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

    def row_words(self, l: int) -> int:
        """The words of an L-byte row the byte kernel reads: every one
        (ceil(L / 4)) where a suffix or exact pattern fits the row, else
        those below the longest prefix that does."""
        fits = self.plens <= l
        if (fits & (self.kind != PREFIX)).any():
            return -(-l // 4)
        return -(-int(self.plens[fits].max(initial=0)) // 4)

    def words_on(self, device: torch.device) -> torch.Tensor:
        """The patterns as the kernel stages them: little-endian 32-bit
        words int32 [P, ceil(Lp / 4)], zero past each pattern's end."""
        key = ("words", device)
        t = self._dev.get(key)
        if t is None:
            p, lp = self.pats.shape
            w = np.zeros((p, -(-lp // 4) * 4), np.uint8)
            w[:, :lp] = self.pats
            t = self._dev[key] = torch.from_numpy(
                w.view("<u4").view(np.int32).copy()).to(device)
        return t


def byte_smem(need: int, rows: int, chunk: int) -> int:
    """Shared memory of a byte-kernel block (csrc/byte_pred.cu
    smem_bytes): `chunk` patterns of `need` words (an odd word stride)
    with their k, kind, column and mode, and `rows` rows of `need` words
    and a zero word (an odd word stride)."""
    return 4 * (chunk * ((need | 1) + 4) + rows * ((need + 1) | 1))


def byte_plan(b: int, l: int, p: int, device: torch.device,
              need: int | None = None, staged: bool | None = None,
              group: int | None = None, threads: int = 256,
              blocks_per_sm: int = 2) -> tuple[int, int, int, int, int]:
    """The byte kernel's launch: (lanes per row, threads per block,
    patterns staged per round, grid, staged). `need`: the words of a row
    the patterns read (BytePatterns.row_words; default every word). A
    row's group of lanes splits its patterns: by default the power of
    two that gives each pattern a lane, up to a warp (`group=32` is a
    warp per row, `group=1` lanes as rows). Staged (byte_staged, where
    a row and a pattern fit _BYTE_SMEM): a block holds `threads / group`
    rows, halved until they fit _BYTE_SMEM beside one pattern (a group
    then widens so that a block keeps a warp), and stages as many
    patterns a round as fit beside them; else direct (byte_direct: rows
    and patterns read in place, no shared memory). The grid covers the
    rows, at most `blocks_per_sm` blocks an SM. The wrappers pass `need`
    alone; the other keywords are for the variants script (and
    `staged` for chip_smoke's edge checks, which hold both kernels)."""
    need = -(-l // 4) if need is None else need
    if group is None:
        group = min(32, 1 << max(p - 1, 0).bit_length())
    if staged is None:
        staged = byte_smem(need, 1, 1) <= _BYTE_SMEM
    rows = max(1, threads // group)
    rows = 1 << (rows.bit_length() - 1)
    chunk = 1
    if staged:
        while rows > 1 and byte_smem(need, rows, 1) > _BYTE_SMEM:
            rows //= 2
        if byte_smem(need, rows, 1) > _BYTE_SMEM:
            raise ValueError(f"byte kernel: a row of {l} bytes does not "
                             "fit a block's shared memory")
        chunk = max(1, min(p, (_BYTE_SMEM - byte_smem(need, rows, 0))
                           // byte_smem(need, 0, 1)))
    if rows * group < 32:
        group = 32 // rows
    grid = max(1, min(-(-b // rows), blocks_per_sm * _sm_count(device)))
    return group, rows * group, chunk, grid, int(staged)


# shared memory the staged byte kernel may ask for (of 227 KB a block)
_BYTE_SMEM = 96 * 1024


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
                   kernels.I32, kernels.I32, kernels.I32, kernels.I32,
                   kernels.VP, kernels.VP, kernels.VP, kernels.I32,
                   kernels.I32, kernels.VP] + [kernels.I32] * 5 + [kernels.VP]
_BYTE_LITS_ARGS = ([kernels.VP, kernels.I64] * 4
                   + [kernels.I32] * 5 + [kernels.VP] * 5
                   + [kernels.I32] * 2 + [kernels.VP] * 2 + [kernels.I64]
                   + [kernels.I32] * 5 + [kernels.VP])


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
    words = patterns.words_on(data.device)
    need = patterns.row_words(l)
    fn = kernels.function("byte_pred", "byte_pred", _BYTE_PRED_ARGS)
    rc = fn(kernels.ptr(data), data.stride(0), kernels.ptr(lens),
            lens.stride(0), b, l, _aligned(data), need,
            kernels.ptr(words), kernels.ptr(plens), kernels.ptr(kind),
            patterns.n, words.shape[1], kernels.ptr(out),
            *byte_plan(b, l, patterns.n, data.device, need=need),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("byte_pred", kernels.check(rc, "byte_pred"), "plane",
                     data, lens, patterns, entry="byte_pred")
    return out


def byte_lits_plain(data: torch.Tensor, lens: torch.Tensor,
                    ok: torch.Tensor | None, err: torch.Tensor | None,
                    pats: torch.Tensor, plens: torch.Tensor,
                    kind: torch.Tensor, mode: torch.Tensor,
                    cols: torch.Tensor, max_len: int, em: torch.Tensor,
                    en: torch.Tensor) -> None:
    """Plain version of the byte_lits kernel, in place: byte_pred_plain's
    hits, then write_lits_plain into the group's columns."""
    write_lits_plain(byte_pred_plain(data, lens, pats, plens, kind), lens,
                     ok, err, mode, cols, max_len, em, en)


def byte_lits(data: torch.Tensor, lens: torch.Tensor,
              ok: torch.Tensor | None, err: torch.Tensor | None,
              patterns: BytePatterns, lits: LitColumns, max_len: int,
              em: torch.Tensor, en: torch.Tensor) -> None:
    """Every constant prefix / suffix / exact pattern of one subject
    group, its literal pair written in place into its column of the
    bool [B, X] ext planes em / en, in one launch. ok / err: the
    subject's presence and error rows (bool [B]; None = present on
    every row / never an error)."""
    data = _rows(data, "data")
    b, l = data.shape
    _lens(lens, b)
    masks = _masks(ok, err, b, "byte_lits")
    _lit_planes(em, en, b, lits, "byte_lits")
    if lits.n != patterns.n:
        raise ValueError(f"byte_lits: {patterns.n} patterns, {lits.n} "
                         "columns")
    pats, plens, kind = patterns.on(data.device)
    mode, cols = lits.on(data.device)
    if not _kernel_or_plain(data, lens, em, en, *masks):
        byte_lits_plain(data, lens, ok, err, pats, plens, kind, mode, cols,
                        max_len, em, en)
        return
    if b == 0 or patterns.n == 0:
        return
    words = patterns.words_on(data.device)
    need = patterns.row_words(l)
    p = kernels.ptr
    fn = kernels.function("byte_pred", "byte_lits", _BYTE_LITS_ARGS)
    rc = fn(p(data), data.stride(0), p(lens), lens.stride(0),
            *_mask_args(ok), *_mask_args(err), b, l, _aligned(data), need,
            int(max_len), p(words), p(plens), p(kind), p(mode), p(cols),
            patterns.n, words.shape[1], p(em), p(en), em.stride(0),
            *byte_plan(b, l, patterns.n, data.device, need=need),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("byte_pred", kernels.check(rc, "byte_lits"), "lits",
                     data, lens, ok, err, patterns, lits, max_len, em, en,
                     entry="byte_lits")


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


def pack_bool_rows(flags: torch.Tensor, n_words: int) -> torch.Tensor:
    """[B, n_words*32] bool → int32 word rows [n_words, B]: the wire
    convention of every bitpacked plane of the packed pull —
    little-endian bit order within each 32-bit word (bit 31 reads
    negative), transposed so words stack as rows (the referenced and
    overlay words of check_pack_plain, the valid words of
    field_eval_plain). runtime/fused.unpack_word_rows is the host
    inverse."""
    b = flags.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=flags.device)
    words = (flags.reshape(b, n_words, 32).to(torch.int64) << shifts) \
        .sum(dim=2)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).T.contiguous()


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

    def scaled_on(self, device: torch.device) -> torch.Tensor:
        """The table as the kernel walks it: each next state multiplied
        by C (its row offset), int32 [S, C]."""
        key = ("scaled", device)
        t = self._dev.get(key)
        if t is None:
            c = self.table.shape[1]
            if self.table.size and int(self.table.max()) * c >= 2 ** 31:
                raise ValueError("DFA bank: S x C exceeds int32 offsets")
            t = self._dev[key] = torch.from_numpy(
                (self.table.astype(np.int64) * c).astype(np.int32)).to(device)
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


def dfa_lits_plain(data: torch.Tensor, lens: torch.Tensor,
                   ok: torch.Tensor | None, err: torch.Tensor | None,
                   table: torch.Tensor, class_of: torch.Tensor,
                   starts: torch.Tensor, accept: torch.Tensor,
                   mode: torch.Tensor, cols: torch.Tensor, max_len: int,
                   em: torch.Tensor, en: torch.Tensor) -> None:
    """Plain version of the dfa_lits kernel, in place: dfa_scan_plain's
    acceptance, then write_lits_plain into the group's columns."""
    write_lits_plain(dfa_scan_plain(data, lens, table, class_of, starts,
                                    accept), lens, ok, err, mode, cols,
                     max_len, em, en)


def dfa_class_stride(l: int) -> int:
    """Bytes of one row's class string in the kernel's shared memory
    (csrc/dfa_scan.cu class_stride): an odd number of words."""
    return 4 * ((-(-l // 4)) | 1)


def dfa_plan(b: int, l: int, n: int, device: torch.device,
             min_threads: int = 128, max_threads: int = 256,
             tiles_per_sm: float = 2.0) -> tuple[int, int, int]:
    """The DFA kernel's launch: (threads per block, rows per tile,
    grid). A tile is ceil(B / (SMs · tiles_per_sm)) rows (its class
    strings within 64 KB), so the grid is about two blocks an SM; a
    block has a thread for each of its tile's B_tile·N walks, between
    `min_threads` (which copy the table in) and `max_threads` (more
    walks take more rounds). The keywords are for the variants script;
    the wrappers take the defaults."""
    rows = max(1, math.ceil(b / (_sm_count(device) * tiles_per_sm)))
    rows = max(1, min(rows, (64 * 1024) // dfa_class_stride(l)))
    threads = max(min_threads, min(max_threads, -(-rows * n // 32) * 32))
    return threads, rows, max(1, -(-b // rows))


_DFA_ARGS = [kernels.VP, kernels.I64, kernels.VP, kernels.I64, kernels.I32,
             kernels.I32, kernels.I32, kernels.VP, kernels.VP, kernels.VP,
             kernels.VP, kernels.I32, kernels.I32, kernels.I32, kernels.VP
             ] + [kernels.I32] * 3 + [kernels.VP]
_DFA_LITS_ARGS = ([kernels.VP, kernels.I64] * 4 + [kernels.I32] * 4
                  + [kernels.VP] * 6 + [kernels.I32] * 3
                  + [kernels.VP] * 2 + [kernels.I64] + [kernels.I32] * 3
                  + [kernels.VP])


def _dfa_fits(data: torch.Tensor, bank: "DfaBank", name: str) -> None:
    """What the kernel needs of its inputs: at most 256 byte classes and
    one row's class string within a block's shared memory."""
    if bank.table.shape[1] > 256:
        raise ValueError(f"{name}: {bank.table.shape[1]} byte classes, "
                         "at most 256")
    if dfa_class_stride(data.shape[1]) + 256 > _DFA_SMEM:
        raise ValueError(f"{name}: rows of {data.shape[1]} bytes do not "
                         "fit one class string in shared memory")


# shared memory of one block on sm_90 (227 KB)
_DFA_SMEM = 232448


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
    _dfa_fits(data, bank, "dfa_scan")
    out = torch.empty((b, bank.n), dtype=torch.bool, device=data.device)
    if b == 0 or bank.n == 0:
        return out
    fn = kernels.function("dfa_scan", "dfa_scan", _DFA_ARGS)
    rc = fn(kernels.ptr(data), data.stride(0), kernels.ptr(lens),
            lens.stride(0), b, l, _aligned(data),
            kernels.ptr(bank.scaled_on(data.device)),
            kernels.ptr(class_of), kernels.ptr(starts), kernels.ptr(accept),
            table.shape[0], table.shape[1], bank.n, kernels.ptr(out),
            *dfa_plan(b, l, bank.n, data.device),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("dfa_scan", kernels.check(rc, "dfa_scan"), "plane",
                     data, lens, bank, entry="dfa_scan")
    return out


def dfa_lits(data: torch.Tensor, lens: torch.Tensor,
             ok: torch.Tensor | None, err: torch.Tensor | None,
             bank: DfaBank, lits: LitColumns, max_len: int,
             em: torch.Tensor, en: torch.Tensor) -> None:
    """Every constant-pattern regex of one subject group, its literal
    pair written in place into its column of the bool [B, X] ext planes
    em / en, in one launch (ok / err as for byte_lits)."""
    data = _rows(data, "data")
    b, l = data.shape
    _lens(lens, b)
    masks = _masks(ok, err, b, "dfa_lits")
    _lit_planes(em, en, b, lits, "dfa_lits")
    if lits.n != bank.n:
        raise ValueError(f"dfa_lits: {bank.n} patterns, {lits.n} columns")
    table, class_of, starts, accept = bank.on(data.device)
    mode, cols = lits.on(data.device)
    if not _kernel_or_plain(data, lens, em, en, *masks):
        dfa_lits_plain(data, lens, ok, err, table, class_of, starts, accept,
                       mode, cols, max_len, em, en)
        return
    _dfa_fits(data, bank, "dfa_lits")
    if b == 0 or bank.n == 0:
        return
    p = kernels.ptr
    fn = kernels.function("dfa_scan", "dfa_lits", _DFA_LITS_ARGS)
    rc = fn(p(data), data.stride(0), p(lens), lens.stride(0),
            *_mask_args(ok), *_mask_args(err), b, l, _aligned(data),
            int(max_len), p(bank.scaled_on(data.device)), p(class_of),
            p(starts), p(accept),
            p(mode), p(cols), table.shape[0], table.shape[1], bank.n,
            p(em), p(en), em.stride(0),
            *dfa_plan(b, l, bank.n, data.device),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("dfa_scan", kernels.check(rc, "dfa_lits"), "lits",
                     data, lens, ok, err, bank, lits, max_len, em, en,
                     entry="dfa_lits")


# ---------------------------------------------------------------------------
# K7: byte-level list banks (csrc/list_banks.cu)
# ---------------------------------------------------------------------------

# bits of the per-(row, list) state byte the list_banks kernels write and
# the verdict_fold kernel reads
LIST_MEMBER, LIST_UND, LIST_BAD = 1, 2, 4


@dataclasses.dataclass(eq=False)
class RegexLists(_OnDevice):
    """J REGEX lists over the DFA acceptance plane of their banks: list j
    sits at list position pos[j], belongs to rule rule[j] and reads the
    value of byte slot bslot[j]; its patterns are the columns
    pat[ptr[j]:ptr[j+1]] of the acceptance plane, and pdef[n] marks the
    $-free patterns (a prefix hit of theirs is definitive on a truncated
    value). The CSR form of the reference's M / M_def matrices."""
    pos: np.ndarray      # int32 [J]
    rule: np.ndarray     # int32 [J]
    bslot: np.ndarray    # int32 [J]
    ptr: np.ndarray      # int32 [J + 1]
    pat: np.ndarray      # int32 [nnz]
    pdef: np.ndarray     # uint8 [N]
    _fields = ("pos", "rule", "bslot", "ptr", "pat", "pdef")

    @property
    def n(self) -> int:
        return int(self.pos.shape[0])


@dataclasses.dataclass(eq=False)
class CidrLists(_OnDevice):
    """K IP_ADDRESSES lists as per-entry (prefix, mask) byte rows in
    v6-mapped space (v4 nets as ::ffff:0:0/96 + len): list k sits at
    list position pos[k] and reads byte slot bslot[k]; ent_v4 marks the
    v4 entries (membership is version-strict, as `addr in net` is)."""
    pos: np.ndarray      # int32 [K]
    bslot: np.ndarray    # int32 [K]
    prefix: np.ndarray   # uint8 [K, E, 16]
    mask: np.ndarray     # uint8 [K, E, 16]
    valid: np.ndarray    # bool [K, E]
    ent_v4: np.ndarray   # bool [K, E]
    _fields = ("pos", "bslot", "prefix", "mask", "valid", "ent_v4")

    @classmethod
    def of(cls, pos: list[int], bslot: list[int],
           entries: list[list[str]]) -> "CidrLists":
        """Encode each list's CIDR strings (v4 or v6, host bits
        ignored)."""
        import ipaddress

        n_c = len(entries)
        e_max = max((len(e) for e in entries), default=1) or 1
        prefix = np.zeros((n_c, e_max, 16), np.uint8)
        mask = np.zeros((n_c, e_max, 16), np.uint8)
        valid = np.zeros((n_c, e_max), bool)
        ent_v4 = np.zeros((n_c, e_max), bool)
        for r, ents in enumerate(entries):
            for e_i, e in enumerate(ents):
                net = ipaddress.ip_network(str(e), strict=False)
                if net.version == 4:
                    plen = net.prefixlen + 96
                    addr = (b"\x00" * 10 + b"\xff\xff" +
                            net.network_address.packed)
                    ent_v4[r, e_i] = True
                else:
                    plen = net.prefixlen
                    addr = net.network_address.packed
                m_int = (((1 << plen) - 1) << (128 - plen)) if plen else 0
                mbytes = m_int.to_bytes(16, "big")
                prefix[r, e_i] = np.frombuffer(
                    bytes(a & mm for a, mm in zip(addr, mbytes)), np.uint8)
                mask[r, e_i] = np.frombuffer(mbytes, np.uint8)
                valid[r, e_i] = True
        return cls(pos=np.asarray(pos, np.int32),
                   bslot=np.asarray(bslot, np.int32), prefix=prefix,
                   mask=mask, valid=valid, ent_v4=ent_v4)

    @property
    def n(self) -> int:
        return int(self.pos.shape[0])

    def words(self) -> tuple[np.ndarray, ...]:
        """The list_banks kernel's entry tables, in 32-bit little-endian
        words of the v6-mapped bytes: each list's valid entries in CSR
        order, its v4 nets in one run and its v6 nets in another →
        (v4_ptr int32 [K + 1], v4 uint32 [N4, 2]: word 3's mask and
        prefix — a v4 net's words 0..2 are the ::ffff:0:0/96 prefix every
        v4 value carries —, v6_ptr int32 [K + 1], v6 uint32 [N6, 8]: the
        four mask words, then the four prefix words)."""
        w = getattr(self, "_words", None)
        if w is None:
            mask = self.mask.reshape(self.n, -1, 16).view("<u4")
            pre = self.prefix.reshape(self.n, -1, 16).view("<u4")
            v4 = self.valid & self.ent_v4
            v6 = self.valid & ~self.ent_v4
            v4_ptr = np.concatenate([[0], np.cumsum(v4.sum(1))])
            v6_ptr = np.concatenate([[0], np.cumsum(v6.sum(1))])
            w4 = np.stack([mask[..., 3][v4], pre[..., 3][v4]], axis=1)
            w6 = np.concatenate([mask[v6], pre[v6]], axis=1)
            w = self._words = (v4_ptr.astype(np.int32),
                               w4.reshape(-1, 2).astype(np.uint32),
                               v6_ptr.astype(np.int32),
                               w6.reshape(-1, 8).astype(np.uint32))
        return w

    def words_on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """words() on `device` (one copy per device; the uint32 tables as
        int32 bit patterns), each table at least one row."""
        cache = self.__dict__.setdefault("_words_dev", {})
        t = cache.get(device)
        if t is None:
            v4_ptr, v4, v6_ptr, v6 = self.words()
            t = cache[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(
                    a if a.shape[0] else np.zeros((1,) + a.shape[1:],
                                                  a.dtype)).view(np.int32))
                .to(device) for a in (v4_ptr, v4, v6_ptr, v6))
        return t

    def run_lengths(self) -> int:
        """The longest v4 or v6 run of any list (what the kernel's lanes
        a pair cover)."""
        v4_ptr, _, v6_ptr, _ = self.words()
        return int(max(np.diff(v4_ptr).max(initial=0),
                       np.diff(v6_ptr).max(initial=0)))


def regex_list_plain(acc: torch.Tensor, str_lens: torch.Tensor,
                     max_len: int, pos: torch.Tensor, rule: torch.Tensor,
                     bslot: torch.Tensor, ptr: torch.Tensor,
                     pat: torch.Tensor, pdef: torch.Tensor,
                     lstate: torch.Tensor, err: torch.Tensor) -> None:
    """Plain version of list_banks' REGEX bank (the reference's
    policy_engine.py:439-473 after the DFA scan), in place: hit / dec are
    the acceptance plane times the list's pattern matrix M / M_def (> 0);
    member = trunc ? dec : hit, und = trunc & ~dec with trunc = the
    value's length >= max_len; lstate[:, pos] gets member | und << 1 and
    err[:, rule] is OR'd with und."""
    n, j = int(acc.shape[1]), int(pos.shape[0])
    dev = acc.device
    owner = torch.repeat_interleave(
        torch.arange(j, device=dev), (ptr[1:] - ptr[:-1]).long())
    m = torch.zeros((n, j), dtype=torch.float32, device=dev)
    m[pat.long(), owner] = 1.0
    m_def = m * pdef.to(torch.float32)[:, None]
    a = acc.to(torch.float32)                # counts stay exact in f32
    hit = (a @ m) > 0
    dec = (a @ m_def) > 0
    trunc = str_lens[:, bslot.long()] >= max_len               # [B, J]
    member = torch.where(trunc, dec, hit)
    und = trunc & ~dec
    lstate[:, pos.long()] = member.to(torch.uint8) | \
        (und.to(torch.uint8) << 1)
    e8 = err.to(torch.uint8)
    e8.scatter_reduce_(1, rule.long()[None, :].expand(und.shape[0], j),
                       und.to(torch.uint8), reduce="amax")
    err.copy_(e8 != 0)


def cidr_list_plain(str_bytes: torch.Tensor, str_lens: torch.Tensor,
                    pos: torch.Tensor, bslot: torch.Tensor,
                    prefix: torch.Tensor, mask: torch.Tensor,
                    valid: torch.Tensor, ent_v4: torch.Tensor,
                    lstate: torch.Tensor) -> None:
    """Plain version of list_banks' CIDR bank (the reference's
    policy_engine.py:475-502), in place: lstate[:, pos] gets member |
    bad << 2, member = any entry whose prefix the value's v6-mapped
    bytes fall under with the entry's IP version, bad = the value's
    length is neither 4 nor 16."""
    sl = bslot.long()
    vb = str_bytes[:, sl, :16]                                 # [B, K, 16]
    vl = str_lens[:, sl]
    mapped = torch.zeros_like(vb)
    mapped[:, :, 10:12] = 255
    mapped[:, :, 12:16] = vb[:, :, 0:4]
    is4 = vl == 4
    v6m_pre = torch.tensor([0] * 10 + [255, 255], dtype=torch.uint8,
                           device=vb.device)
    val_mapped = (vb[:, :, :12] == v6m_pre).all(dim=2)
    v = torch.where(is4[:, :, None], mapped, vb)
    val_ok = is4 | (vl == 16)
    val_v4 = is4 | ((vl == 16) & val_mapped)
    hit_e = ((v[:, :, None, :] & mask[None]) == prefix[None]).all(dim=3)
    hit_e &= valid[None]
    hit_e &= val_v4[:, :, None] == ent_v4[None]
    member = hit_e.any(dim=2) & val_ok
    lstate[:, pos.long()] = member.to(torch.uint8) | \
        ((~val_ok).to(torch.uint8) << 2)


def _le_words(v: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 16] → int64 [..., 4]: the four little-endian 32-bit
    words the kernel loads."""
    x = v.to(torch.int64).reshape(*v.shape[:-1], 4, 4)
    return x[..., 0] | x[..., 1] << 8 | x[..., 2] << 16 | x[..., 3] << 24


def list_banks_words_plain(acc: torch.Tensor | None,
                           str_bytes: torch.Tensor | None,
                           str_lens: torch.Tensor, max_len: int,
                           rx: RegexLists | None, cidr: CidrLists | None,
                           lstate: torch.Tensor,
                           err: torch.Tensor | None) -> None:
    """Plain version of the list_banks kernel in its own formulation, in
    place (the tests hold it against the JAX package; the served path
    never runs it): REGEX, per list, hit / dec = the OR of acc over its
    CSR row of patterns and over its $-free ones, member = trunc ? dec :
    hit, und = trunc & ~dec, the err plane OR'd with und at the list's
    rule; CIDR from CidrLists.words(): the value's first 16 bytes as
    four little-endian words, a v4 value (length 4 — its word 0 — or 16
    with the ::ffff:0:0/96 prefix) tested against the list's v4 run on
    word 3 alone, a v6 value against its v6 run on all four words, and a
    value of another length bad."""
    if rx is not None and rx.n:
        pos, rule, bslot, ptr, pat, pdef = rx.on(acc.device)
        for j in range(rx.n):
            cols = pat[int(ptr[j]):int(ptr[j + 1])].long()
            a = acc[:, cols]
            hit = a.any(dim=1)
            dec = (a & (pdef[cols] != 0)[None, :]).any(dim=1)
            trunc = str_lens[:, int(bslot[j])] >= max_len
            und = trunc & ~dec
            lstate[:, int(pos[j])] = torch.where(trunc, dec, hit).to(
                torch.uint8) | (und.to(torch.uint8) << 1)
            err[:, int(rule[j])] |= und
    if cidr is not None and cidr.n:
        v4_ptr, v4, v6_ptr, v6 = (torch.from_numpy(a.astype(np.int64))
                                  for a in cidr.words())
        for k in range(cidr.n):
            slot = int(cidr.bslot[k])
            w = _le_words(str_bytes[:, slot, :16]).cpu()
            n = str_lens[:, slot].cpu()
            is4 = n == 4
            ok = is4 | (n == 16)
            v4val = is4 | ((n == 16) & (w[:, 0] == 0) & (w[:, 1] == 0)
                           & (w[:, 2] == 0xFFFF0000))
            w3 = torch.where(is4, w[:, 0], w[:, 3])
            e4 = v4[int(v4_ptr[k]):int(v4_ptr[k + 1])]
            e6 = v6[int(v6_ptr[k]):int(v6_ptr[k + 1])]
            hit4 = ((w3[:, None] & e4[None, :, 0]) == e4[None, :, 1]) \
                .any(dim=1)
            hit6 = ((w[:, None, :] & e6[None, :, :4]) == e6[None, :, 4:]) \
                .all(dim=2).any(dim=1)
            member = ok & torch.where(v4val, hit4, hit6)
            lstate[:, int(cidr.pos[k])] = (member.to(torch.uint8) | (
                (~ok).to(torch.uint8) << 2)).to(lstate.device)


_LIST_BANKS_ARGS = ([kernels.VP, kernels.I32, kernels.I32, kernels.I32]
                    + [kernels.VP] * 7 + [kernels.I32, kernels.I32]
                    + [kernels.VP, kernels.I64, kernels.I64, kernels.I32]
                    + [kernels.VP] * 6 + [kernels.I32, kernels.I32]
                    + [kernels.VP, kernels.I64, kernels.I64, kernels.VP,
                       kernels.I32, kernels.VP])


def _lanes(n: int) -> int:
    """The lanes a (row, list) pair takes for a run of n items: the
    smallest power of two that covers it, at most a warp."""
    return min(32, 1 << max(n - 1, 0).bit_length())


# the threads a list_banks launch aims at, at most (about two waves of an
# H100's 132 SMs x 2,048 resident threads; it beat 2^17, 2^21 and no cap
# on the card, PERF.md §6): past it a bank's lanes a pair are halved
LIST_THREADS = 1 << 19


def list_plan(rx: "RegexLists | None", cidr: "CidrLists | None",
              b: int = 0) -> tuple[int, int]:
    """list_banks' lanes a (row, list) pair → (REGEX lanes, CIDR lanes):
    enough for the longest pattern row of a REGEX list and the longest
    v4 or v6 run of a CIDR list (longer ones take rounds of a warp's 32),
    halved while the bank's B x lists x lanes exceeds LIST_THREADS, so
    a large batch of short lists keeps a few lanes a pair and a small
    batch of long lists a warp."""
    def fit(lanes: int, pairs: int) -> int:
        while lanes > 1 and pairs * lanes > LIST_THREADS:
            lanes //= 2
        return lanes
    rx_l = fit(_lanes(int(np.diff(rx.ptr).max(initial=0))), b * rx.n) \
        if rx is not None else 1
    c_l = fit(_lanes(cidr.run_lengths()), b * cidr.n) \
        if cidr is not None else 1
    return rx_l, c_l


def _planes(lstate: torch.Tensor, str_lens: torch.Tensor,
            lists: RegexLists | CidrLists, b: int, name: str) -> None:
    """The shapes a list_banks launch indexes by: lstate uint8 [B, NL]
    (contiguous) and str_lens int32 [B, S], with every list's position
    and byte slot inside them."""
    if lstate.dim() != 2 or lstate.shape[0] != b or \
            lstate.dtype != torch.uint8 or not lstate.is_contiguous():
        raise ValueError(f"{name}: lstate must be a contiguous uint8 "
                         f"[{b}, NL] tensor, got {lstate.dtype} "
                         f"{tuple(lstate.shape)}")
    if str_lens.dim() != 2 or str_lens.shape[0] != b or \
            str_lens.dtype != torch.int32:
        raise ValueError(f"{name}: str_lens must be int32 [{b}, S], got "
                         f"{str_lens.dtype} {tuple(str_lens.shape)}")
    if lists.n and (int(lists.pos.max()) >= lstate.shape[1] or
                    int(lists.bslot.max()) >= str_lens.shape[1]):
        raise ValueError(f"{name}: a list position or byte slot is "
                         "outside lstate / str_lens")


def list_banks(acc: torch.Tensor | None, str_bytes: torch.Tensor | None,
               str_lens: torch.Tensor, max_len: int,
               rx: RegexLists | None, cidr: CidrLists | None,
               lstate: torch.Tensor, err: torch.Tensor | None) -> None:
    """Membership of every REGEX and IP_ADDRESSES list of a step in ONE
    launch: writes each list's state byte into lstate uint8 [B, NL]
    (REGEX: member | und << 1, from the DFA acceptance plane acc bool
    [B, N] of its banks, setting the err plane bool [B, R] at the list's
    rule where und holds; IP_ADDRESSES: member | bad << 2, from the byte
    plane str_bytes uint8 [B, S, L >= 16]). A bank that is None (with
    its planes) is skipped. CPU tensors run the plain versions."""
    b = int(lstate.shape[0])
    rx = rx if rx is not None and rx.n else None
    cidr = cidr if cidr is not None and cidr.n else None
    ts = [str_lens, lstate]
    if rx is not None:
        _planes(lstate, str_lens, rx, b, "list_banks")
        if acc is None or err is None or acc.dim() != 2 or \
                acc.shape[0] != b or err.dim() != 2 or err.shape[0] != b \
                or rx.pdef.shape[0] != acc.shape[1] or \
                int(rx.rule.max()) >= err.shape[1]:
            raise ValueError("list_banks: acc / err do not fit the REGEX "
                             "lists")
        ts += [acc, err]
    if cidr is not None:
        _planes(lstate, str_lens, cidr, b, "list_banks")
        if str_bytes is None or str_bytes.dim() != 3 or \
                str_bytes.shape[0] != b or str_bytes.shape[2] < 16 or \
                str_bytes.shape[1] != str_lens.shape[1] or \
                str_bytes.stride(2) != 1 or str_bytes.dtype != torch.uint8:
            raise ValueError("list_banks: str_bytes must be uint8 [B, S, L] "
                             "with L >= 16 and unit-stride rows")
        ts.append(str_bytes)
    if not _kernel_or_plain(*ts):
        if rx is not None:
            regex_list_plain(acc, str_lens, max_len, *rx.on(acc.device),
                             lstate, err)
        if cidr is not None:
            cidr_list_plain(str_bytes, str_lens, *cidr.on(str_bytes.device),
                            lstate)
        return
    if rx is not None:
        for t, name in ((acc, "acc"), (err, "err")):
            if t.dtype != torch.bool or not t.is_contiguous():
                raise ValueError(f"list_banks: {name} must be a contiguous "
                                 "bool tensor")
    if b == 0 or (rx is None and cidr is None):
        return
    p = kernels.ptr
    null = kernels.VP(0)
    dev = lstate.device
    rx_l, c_l = list_plan(rx, cidr, b)
    if rx is not None:
        pos, rule, bslot, ptr, pat, pdef = rx.on(dev)
        rx_args = (p(acc), int(acc.shape[1]), int(max_len), rx.n, p(pos),
                   p(rule), p(bslot), p(ptr), p(pat), p(pdef), p(err),
                   int(err.shape[1]), rx_l)
    else:
        rx_args = (null, 0, int(max_len), 0) + (null,) * 7 + (0, rx_l)
    if cidr is not None:
        c_pos, c_bslot = cidr.on(dev)[:2]
        v4_ptr, v4, v6_ptr, v6 = cidr.words_on(dev)
        c_args = (p(str_bytes), str_bytes.stride(0), str_bytes.stride(1),
                  cidr.n, p(c_pos), p(c_bslot), p(v4_ptr), p(v4),
                  p(v6_ptr), p(v6), c_l)
    else:
        c_args = (null, 0, 0, 0) + (null,) * 6 + (c_l,)
    fn = kernels.function("list_banks", "list_banks", _LIST_BANKS_ARGS)
    rc = fn(*rx_args, *c_args, b, p(str_lens), str_lens.stride(0),
            str_lens.stride(1), p(lstate), int(lstate.shape[1]),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("list_banks", kernels.check(rc, "list_banks"),
                     "list_banks", acc, str_bytes, str_lens, max_len, rx,
                     cidr, lstate, err)
