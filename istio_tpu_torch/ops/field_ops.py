"""Op programs: report fields and check atoms, and the two kernels that
interpret them (csrc/field_eval.cu, K8).

An OP PROGRAM is a postfix table of op rows over one record, one op per
node kind of compile_ruleset's and compile_field's masked (val, ok,
err) algebra (compiler/tensor_expr.py). compiler/op_lower.py lowers an
expression to it; every node kind _compile_node takes has an op, so no
closure runs beside a program. Two entry points of one interpreter:

  field_eval  all F report field programs of a batch in one launch;
              replaces the JAX package's ReportLowering.field_planes
              (istio_tpu/runtime/report_lower.py:73-84) and the field
              rows of FusedPlan.packed_report's packr
              (istio_tpu/runtime/fused.py:409-416). Output int32
              [F + ceil(F/32), B]: F value rows (intern ids; 0/1 for
              BOOL fields), then the fields' valid bits (`ok & ~err`)
              bitpacked 32 to a word as pack_bool_rows packs them. A
              value row holds what the reference writes on EVERY cell,
              invalid cells included, so the packed pull is byte-equal.
  atom_eval   the generic-tier check atoms of a ruleset in one launch;
              replaces the per-atom closures of the JAX package's
              compile_ruleset run (istio_tpu/compiler/tensor_expr.py:
              291-775, istio_tpu/compiler/ruleset.py:798) and the
              runtime-pattern predicates and ordered compare
              (istio_tpu/ops/bytes_ops.py:80-131). Each atom's literal
              pair m = val & ~ee, n = ~val & ~ee (ee = err | ~ok) lands
              in its own columns of the [B, X] ext planes rule_match
              reads.

Values on the stack are (val int32, len int32, ok, err). A BYTE VIEW
(BSLOT, BCONST, and OR of two views) carries its source in val: a byte
slot s >= 0 reads str_bytes[b, s, :], a constant -1 - k reads row k of
the program's constant table, whose first str_bytes.shape[2] bytes
serve a narrowed latency-tier batch while len keeps the true length.
No byte plane is copied.

Plain versions: `field_eval_plain` / `atom_eval_plain` run the closures
exactly as the reference does (each wrapper's CPU path), and
`interpret_plain` runs the op table with torch ops and the byte ops'
plain versions (bytes_ops.byte_pred_plain, dfa_scan_plain, dyn_*,
lex_cmp); the tests hold the lowering with it, the kernels run only on
the card.

`launch_plan` maps one launch onto the card: a block per tile of 32
records (one per lane) and group of at most 32 programs (field_eval:
the 32 fields of one valid word; atom_eval: ATOM_GROUP atoms, halved
down to MIN_GROUP while the launch has under FILL_BLOCKS blocks),
min(WARPS, group) warps a block, each warp one program at a time over
the tile; and the stack class: programs of need <= SHALLOW take the
register-stack instantiation, deeper ones the general one.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import numpy as np
import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.compiler.layout import ID_TRUE, AttributeBatch
from istio_tpu_torch.ops import bytes_ops
from istio_tpu_torch.ops.bytes_ops import _kernel_or_plain, pack_bool_rows

# opcodes (csrc/field_eval.cu); an op row is (opcode, a, b, c, d)
(OP_CONST, OP_VAR, OP_DSLOT, OP_MAPSEL, OP_EXTERN, OP_ERR, OP_OR, OP_EQ,
 OP_NEQ, OP_LAND, OP_LOR, OP_BSLOT, OP_BCONST, OP_CMP, OP_DPRED, OP_BPRED,
 OP_DFA) = range(17)
OP_NAMES = ("CONST", "VAR", "DSLOT", "MAPSEL", "EXTERN", "ERR", "OR", "EQ",
            "NEQ", "LAND", "LOR", "BSLOT", "BCONST", "CMP", "DPRED", "BPRED",
            "DFA")
BINARY_OPS = {"OR": OP_OR, "EQ": OP_EQ, "NEQ": OP_NEQ, "LAND": OP_LAND,
              "LOR": OP_LOR}
# ops that pop two values; their row's last operand is the operand-order
# bit: 1 = the right operand was emitted first (it is below the left)
TWO_OPERAND = frozenset({OP_OR, OP_EQ, OP_NEQ, OP_LAND, OP_LOR, OP_CMP,
                         OP_DPRED})
CMP_KINDS = ("LSS", "LEQ", "GTR", "GEQ")
# predicate kinds: BPRED takes bytes_ops' PREFIX / SUFFIX / EXACT, DPRED
# PREFIX / SUFFIX / GLOB
GLOB = 3
OP_WIDTH = 5
# the kernel's per-thread value stack (kStack in csrc/field_eval.cu).
# The lowering emits the operand that needs more stack first, so a tree
# of n nodes needs at most floor(log2(n + 1)) slots
MAX_STACK = 32
# the launch plan (csrc/field_eval.cu PlanField, in this order)
PLAN_FIELDS = ("tiles", "groups", "group", "warps", "s_res", "deep", "smem")
TILE = 32                  # records per block, one per lane (kLanes)
SHALLOW = 4                # the register stack's depth (kShallow)
FIELD_GROUP = 32           # fields per block: one valid word
MAX_GRID_Y = 65535
WARPS = 8                  # warps per block, at most (kMaxThreads / 32)
ATOM_GROUP = 32            # atoms per block, at most
FILL_BLOCKS = 256          # atom groups halve until a launch has this many
MIN_GROUP = 8              # ... or down to this many atoms


@dataclasses.dataclass(eq=False)
class OpProgram:
    """P op programs over one layout.

    ops     int32 [n_ops, 5] postfix op rows of every program, in order
    starts  int32 [P + 1]: program p's ops are ops[starts[p]:starts[p + 1]]
    consts  uint8 [K, W] constant byte rows (views and patterns), W >=
            max_len
    dfa     the DfaBank of the programs' `matches` patterns, or None
    max_len the layout's byte-slot cap (the truncation contract)
    need    the deepest stack any program needs

    Operands: CONST a = intern id or 0/1; VAR a = column, b = is_bool;
    DSLOT a = derived column; MAPSEL a, b = the two derived columns, c,
    d = the two map slots; EXTERN a = extern column; BSLOT a = byte
    slot, b = presence column; BCONST a = constant row, b = length; CMP
    a = index in CMP_KINDS, b = numeric; DPRED a = kind; BPRED a = kind,
    b = constant row, c = pattern length, d = undecidable when the
    subject may be truncated; DFA a = pattern in `dfa`, b = likewise."""
    ops: np.ndarray
    starts: np.ndarray
    consts: np.ndarray
    dfa: bytes_ops.DfaBank | None
    max_len: int
    need: int
    _dev: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.starts) - 1

    def on(self, device: torch.device) -> tuple:
        """(ops, starts, consts) on `device`, then the DFA bank's
        (table, class_of, starts, accept) or four empty tensors; cached."""
        got = self._dev.get(device)
        if got is None:
            own = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                        for a in (self.ops, self.starts, self.consts))
            if self.dfa is not None:
                bank = self.dfa.on(device)
            else:
                bank = (torch.zeros((1, 1), dtype=torch.int32, device=device),
                        torch.zeros(256, dtype=torch.int32, device=device),
                        torch.zeros(1, dtype=torch.int32, device=device),
                        torch.zeros((1, 1), dtype=torch.uint8, device=device))
            got = self._dev[device] = own + tuple(bank)
        return got


@dataclasses.dataclass(eq=False)
class FieldProgram:
    """F compiled report fields: the closure of each field (NodeFn, the
    plain version) and their op programs."""
    fns: list
    prog: OpProgram

    @property
    def n_fields(self) -> int:
        return len(self.fns)

    @property
    def n_words(self) -> int:
        return (self.n_fields + 31) // 32


@dataclasses.dataclass(eq=False)
class AtomProgram:
    """A generic-tier check atoms: the closure of each (NodeFn, the plain
    version), their op programs, and each atom's column in the [B, X]
    ext literal planes."""
    fns: list
    prog: OpProgram
    cols: np.ndarray          # int32 [A]
    _dev: dict = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.fns)

    def cols_on(self, device: torch.device) -> torch.Tensor:
        got = self._dev.get(device)
        if got is None:
            got = self._dev[device] = torch.from_numpy(
                np.ascontiguousarray(self.cols, np.int32)).to(device)
        return got


# ---------------------------------------------------------------------------
# the op table interpreted with torch ops (plain version of the interpreter)
# ---------------------------------------------------------------------------

def _bool(b: int, value: bool, dev) -> torch.Tensor:
    return torch.full((b,), value, dtype=torch.bool, device=dev)


def interpret_plain(batch: AttributeBatch, prog: OpProgram
                    ) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Every program of `prog` over the whole batch, op by op, exactly as
    the kernel interprets it per record → [(val int32, ok, err)] each
    [B] (bools as 0/1)."""
    ids, present, mp = batch.ids, batch.present, batch.map_present
    sb, sl = batch.str_bytes, batch.str_lens
    b, dev = ids.shape[0], ids.device
    w = int(sb.shape[2])
    _, _, consts, table, class_of, dstarts, accept = prog.on(dev)
    one, zero = _bool(b, True, dev), _bool(b, False, dev)
    max_len = prog.max_len
    i32 = torch.int32
    out = []
    for p in range(prog.n):
        # a stack entry: (val, ok, err, view data [B, w] or None, len)
        stack: list[tuple[Any, Any, Any, Any, Any]] = []
        for op, a, x, c, d in prog.ops[prog.starts[p]:prog.starts[p + 1]]:
            op, a, x, c, d = int(op), int(a), int(x), int(c), int(d)
            if op == OP_CONST:
                stack.append((torch.full((b,), a, dtype=i32, device=dev),
                              one, zero, None, None))
            elif op == OP_VAR:
                v = ids[:, a]
                stack.append(((v == ID_TRUE).to(i32) if x else v,
                              present[:, a], zero, None, None))
            elif op == OP_DSLOT:
                stack.append((ids[:, a], present[:, a], zero, None, None))
            elif op == OP_MAPSEL:
                sel = mp[:, c]
                stack.append((torch.where(sel, ids[:, a], ids[:, x]),
                              torch.where(sel, present[:, a],
                                          mp[:, d] & present[:, x]),
                              zero, None, None))
            elif op == OP_EXTERN:
                v, pres = ids[:, a], present[:, a]
                err = pres & (v == 0)
                stack.append((v, pres & ~err, err, None, None))
            elif op == OP_ERR:
                stack.append((torch.zeros(b, dtype=i32, device=dev), zero,
                              one, None, None))
            elif op == OP_BSLOT:
                stack.append((torch.full((b,), a, dtype=i32, device=dev),
                              present[:, x], zero, sb[:, a, :], sl[:, a]))
            elif op == OP_BCONST:
                stack.append((torch.full((b,), -1 - a, dtype=i32,
                                         device=dev), one, zero,
                              consts[a, :w][None, :].expand(b, w),
                              torch.full((b,), x, dtype=i32, device=dev)))
            elif op in (OP_BPRED, OP_DFA):
                _, sok, serr, sdata, slen = stack.pop()
                ee = serr | ~sok
                maybe = sok & (slen >= max_len)
                if op == OP_BPRED:
                    hit = bytes_ops.byte_pred_plain(
                        sdata, slen, consts[x:x + 1, :max(c, 1)],
                        torch.tensor([c], dtype=i32, device=dev),
                        torch.tensor([a], dtype=i32, device=dev))[:, 0]
                    ee = ee | (maybe & bool(d))
                    val = hit & ~ee
                else:
                    hit = bytes_ops.dfa_scan_plain(
                        sdata, slen, table, class_of, dstarts[a:a + 1],
                        accept[:, a:a + 1])[:, 0]
                    val = hit & ~ee
                    ee = ee | (maybe if x else maybe & ~val)
                    val = val & ~ee
                stack.append((val.to(i32), ~ee, ee, None, None))
            elif op in TWO_OPERAND:
                top, below = stack.pop(), stack.pop()
                stack.append(_two(op, a, x, max_len,
                                  *((top, below) if d else (below, top))))
            else:
                raise ValueError(f"op program: bad opcode {op}")
        if len(stack) != 1:
            raise ValueError(f"op program {p} left {len(stack)} values")
        v, ok, err, _, _ = stack[0]
        out.append((v.to(torch.int32), ok, err))
    return out


def _two(op: int, a: int, x: int, max_len: int, left: tuple,
         right: tuple) -> tuple:
    """One two-operand op over stack entries (val, ok, err, view data,
    len); a and x are the op row's first two operands."""
    av, aok, aerr, ad, al = left
    bv, bok, berr, bd, bl = right
    i32 = torch.int32
    if op == OP_OR:
        # values and byte views alike (a view also selects its bytes)
        ok, err = aok | (~aerr & bok), aerr | (~aok & ~aerr & berr)
        if ad is None:
            return (torch.where(aok, av, bv), ok, err, None, None)
        return (torch.where(aok, av, bv), ok, err,
                torch.where(aok[:, None], ad, bd), torch.where(aok, al, bl))
    ea, eb = aerr | ~aok, berr | ~bok
    if op in (OP_EQ, OP_NEQ):
        cmp = (av == bv) if op == OP_EQ else (av != bv)
        ee = ea | eb
        return (cmp.to(i32), ~ee, ee, None, None)
    if op in (OP_LAND, OP_LOR):
        at, bt = av != 0, bv != 0
        if op == OP_LAND:
            err = ea | (~ea & at & eb)
            val = at & bt & ~err
        else:
            err = ea | (~ea & ~at & eb)
            val = ((at & ~ea) | (bt & ~eb)) & ~err
        return (val.to(i32), ~err, err, None, None)
    ee = ea | eb
    if op == OP_CMP:
        c = bytes_ops.lex_cmp(ad, al, bd, bl)
        val = (c < 0, c <= 0, c > 0, c >= 0)[a]
        if x:
            # numeric order keys: empty = NaN (False, never err), one
            # byte = malformed (err)
            nan = (aok & (al == 0)) | (bok & (bl == 0))
            ee = ee | (aok & (al == 1)) | (bok & (bl == 1))
            val = val & ~nan
        else:
            ee = ee | (aok & (al >= max_len)) | (bok & (bl >= max_len))
    elif op == OP_DPRED:
        # a = subject, b = pattern
        fn = {bytes_ops.PREFIX: bytes_ops.dyn_prefix_match,
              bytes_ops.SUFFIX: bytes_ops.dyn_suffix_match,
              GLOB: bytes_ops.dyn_glob_match}[a]
        val = fn(ad, al, bd, bl)
        und = bok & (bl >= max_len)
        if a != bytes_ops.PREFIX:
            und = und | (aok & (al >= max_len))
        ee = ee | und
    else:
        raise ValueError(f"op program: bad opcode {op}")
    val = val & ~ee
    return (val.to(i32), ~ee, ee, None, None)


# ---------------------------------------------------------------------------
# field_eval
# ---------------------------------------------------------------------------

def _pack(vals: list, valid: list, b: int, dev) -> torch.Tensor:
    """[F] value rows and valid rows → the int32 [F + W, B] field rows."""
    n_f = len(vals)
    if not n_f:
        return torch.zeros((0, b), dtype=torch.int32, device=dev)
    n_w = (n_f + 31) // 32
    vpad = torch.zeros((b, n_w * 32), dtype=torch.bool, device=dev)
    vpad[:, :n_f] = torch.stack(valid).T
    return torch.cat([torch.stack(vals), pack_bool_rows(vpad, n_w)])


def field_eval_plain(batch: AttributeBatch, prog: FieldProgram
                     ) -> torch.Tensor:
    """Plain version of the field_eval kernel: the reference's
    ReportLowering.field_planes (each field's closure; values as int32,
    bools as 0/1; valid = ok & ~err) and the valid words of packr."""
    vals, valid = [], []
    for fn in prog.fns:
        t = fn(batch)
        vals.append(t.val.to(torch.int32))
        valid.append(t.ok & ~t.err)
    return _pack(vals, valid, batch.ids.shape[0], batch.ids.device)


def field_eval_ops_plain(batch: AttributeBatch, prog: FieldProgram
                         ) -> torch.Tensor:
    """The field programs interpreted with torch ops (interpret_plain).
    Tests hold it against field_eval_plain."""
    got = interpret_plain(batch, prog.prog)
    return _pack([v for v, _, _ in got], [ok & ~err for _, ok, err in got],
                 batch.ids.shape[0], batch.ids.device)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One field_eval / atom_eval launch on the card (PLAN_FIELDS).

    Block (x, y) runs records [32x, 32x + 32) against programs
    [y * group, y * group + group) (and again every MAX_GRID_Y groups)
    with `warps` warps, warp w running the group's programs w,
    w + warps, ... over the tile. Shared memory (`smem` bytes):
    field_eval's 32 valid masks or atom_eval's [32, s_res] literal
    tile. deep: the general (local-memory stack) instantiation."""
    tiles: int
    groups: int
    group: int
    warps: int
    s_res: int
    deep: int
    smem: int

    @property
    def grid(self) -> tuple[int, int]:
        return self.tiles, min(self.groups, MAX_GRID_Y)

    def fields(self) -> tuple[int, ...]:
        return tuple(getattr(self, f) for f in PLAN_FIELDS)


def launch_plan(entry: str, b: int, prog: OpProgram, *, warps: int = WARPS,
                atom_group: int = ATOM_GROUP, fill_blocks: int = FILL_BLOCKS,
                min_group: int = MIN_GROUP) -> LaunchPlan:
    """The plan of one `entry` ("field_eval" / "atom_eval") launch over
    b records. The wrappers always take the defaults; the keywords let a
    measurement script time other plans of the same kernels."""
    if not 1 <= warps <= 8 or not 1 <= atom_group <= 32 or min_group < 1:
        raise ValueError(f"{entry}: warps must be 1..8 (kMaxThreads 256), "
                         f"atom_group 1..32 and min_group >= 1, got "
                         f"{warps}, {atom_group}, {min_group}")
    n = prog.n
    tiles = -(-b // TILE)
    if entry == "field_eval":
        group = FIELD_GROUP
    else:
        # few atoms or records: smaller groups, more blocks, a program or
        # two a warp; a group under MIN_GROUP leaves most lanes of its
        # row-wise store loop idle
        group = atom_group
        while group > min_group and tiles * -(-n // group) < fill_blocks:
            group //= 2
    # an odd word stride: lanes writing one atom of 32 records hit 32 banks
    s_res = 4 * (-(-group // 4) | 1)
    return LaunchPlan(
        tiles=tiles, groups=-(-n // group), group=group,
        warps=min(warps, group), s_res=s_res, deep=int(prog.need > SHALLOW),
        smem=4 * group if entry == "field_eval" else TILE * s_res)


def _plan_arg(entry: str, b: int, prog: OpProgram):
    """launch_plan of this launch as the C entry point takes it (an int
    array); a few integer operations, so worked out at every launch."""
    return (ctypes.c_int * len(PLAN_FIELDS))(
        *launch_plan(entry, b, prog).fields())


_PLANE_ARGS = ([kernels.VP, kernels.I64] * 3                  # ids, present, map
               + [kernels.VP, kernels.I64, kernels.I64, kernels.I32]  # bytes
               + [kernels.VP, kernels.I64, kernels.I64]      # str_lens
               + [kernels.I32, kernels.I32])                 # B, id_true
_PROGRAM_ARGS = ([kernels.VP, kernels.VP, kernels.I32]       # ops, starts, P
                 + [kernels.VP, kernels.I32]                 # consts, width
                 + [kernels.VP] * 4 + [kernels.I32, kernels.I32]  # dfa bank
                 + [kernels.I32])                            # max_len
_FIELD_EVAL_ARGS = (_PLANE_ARGS + _PROGRAM_ARGS
                    + [kernels.VP, kernels.VP, kernels.VP])  # plan, out
_ATOM_EVAL_ARGS = (_PLANE_ARGS + _PROGRAM_ARGS
                   + [kernels.VP, kernels.VP, kernels.VP, kernels.VP]
                   + [kernels.I64, kernels.VP])   # plan, cols, m, n


def _plane(t: torch.Tensor, dtype: torch.dtype, dims: int, name: str,
           who: str) -> torch.Tensor:
    if t.dim() != dims or t.dtype != dtype or \
            (t.shape[-1] and t.stride(-1) != 1):
        raise ValueError(f"{who}: {name} must be a {dtype} {dims}-d plane "
                         f"with unit last stride, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t


def _launch_args(batch: AttributeBatch, prog: OpProgram, who: str) -> list:
    """The plane and program arguments both entry points take."""
    b = int(batch.ids.shape[0])
    ids = _plane(batch.ids, torch.int32, 2, "ids", who)
    present = _plane(batch.present, torch.bool, 2, "present", who)
    mp = _plane(batch.map_present, torch.bool, 2, "map_present", who)
    sb = _plane(batch.str_bytes, torch.uint8, 3, "str_bytes", who)
    sl = batch.str_lens
    if sl.dim() != 2 or sl.dtype != torch.int32:
        raise ValueError(f"{who}: str_lens must be int32 [B, S], got "
                         f"{sl.dtype} {tuple(sl.shape)}")
    w = int(sb.shape[2])
    if w > prog.consts.shape[1] or prog.need > MAX_STACK:
        raise ValueError(f"{who}: byte plane width {w} exceeds the "
                         f"constant rows ({prog.consts.shape[1]}) or a "
                         f"program needs {prog.need} > {MAX_STACK} slots")
    ops, starts, consts, table, class_of, dstarts, accept = prog.on(
        batch.ids.device)
    p = kernels.ptr
    return [p(ids), ids.stride(0), p(present), present.stride(0), p(mp),
            mp.stride(0), p(sb), sb.stride(0), sb.stride(1), w, p(sl),
            sl.stride(0), sl.stride(1), b, ID_TRUE,
            p(ops), p(starts), prog.n, p(consts), int(consts.shape[1]),
            p(table), p(class_of), p(dstarts), p(accept),
            int(table.shape[1]), int(accept.shape[1]), prog.max_len]


def field_eval(batch: AttributeBatch, prog: FieldProgram,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The report field rows int32 [F + ceil(F/32), B] of one batch,
    written into `out` when given (a row slice of the packed report
    buffer). CPU planes run field_eval_plain; CUDA planes launch the
    kernel."""
    ids = batch.ids
    b, dev = int(ids.shape[0]), ids.device
    n_rows = prog.n_fields + prog.n_words
    if out is not None and (tuple(out.shape) != (n_rows, b) or
                            out.dtype != torch.int32 or out.device != dev or
                            not out.is_contiguous()):
        raise ValueError(f"field_eval: out must be a contiguous int32 "
                         f"[{n_rows}, {b}] tensor on {dev}")
    if not _kernel_or_plain(ids, batch.present, batch.map_present,
                            batch.str_bytes, batch.str_lens):
        got = field_eval_plain(batch, prog)
        return got if out is None else out.copy_(got)
    if out is None:
        out = torch.empty((n_rows, b), dtype=torch.int32, device=dev)
    if b == 0 or prog.n_fields == 0:
        return out
    args = _launch_args(batch, prog.prog, "field_eval")
    fn = kernels.function("field_eval", "field_eval", _FIELD_EVAL_ARGS)
    rc = fn(*args, _plan_arg("field_eval", b, prog.prog),
            kernels.ptr(out), kernels.VP(kernels.stream_ptr()))
    kernels.launched("field_eval", kernels.check(rc, "field_eval"), batch,
                     prog, entry="field_eval")
    return out


# ---------------------------------------------------------------------------
# atom_eval
# ---------------------------------------------------------------------------

def _literals(val, ok, err) -> tuple[torch.Tensor, torch.Tensor]:
    ee = err | ~ok
    v = val != 0
    return v & ~ee, ~v & ~ee


def atom_eval_plain(batch: AttributeBatch, atoms: AtomProgram,
                    ext_m: torch.Tensor, ext_n: torch.Tensor) -> None:
    """Plain version of the atom_eval kernel, in place: each atom's
    closure (the reference's per-atom closures in compile_ruleset's run)
    and its literal pair written into its columns of ext_m / ext_n."""
    if not atoms.n:
        return
    lits = [_literals(t.val, t.ok, t.err)
            for t in (fn(batch) for fn in atoms.fns)]
    cols = atoms.cols_on(ext_m.device).long()
    ext_m[:, cols] = torch.stack([m for m, _ in lits], dim=1)
    ext_n[:, cols] = torch.stack([n for _, n in lits], dim=1)


def atom_eval_ops_plain(batch: AttributeBatch, atoms: AtomProgram,
                        ext_m: torch.Tensor, ext_n: torch.Tensor) -> None:
    """The atom programs interpreted with torch ops (interpret_plain),
    written like atom_eval_plain. Tests hold it against the closures."""
    if not atoms.n:
        return
    lits = [_literals(*t) for t in interpret_plain(batch, atoms.prog)]
    cols = atoms.cols_on(ext_m.device).long()
    ext_m[:, cols] = torch.stack([m for m, _ in lits], dim=1)
    ext_n[:, cols] = torch.stack([n for _, n in lits], dim=1)


def atom_eval(batch: AttributeBatch, atoms: AtomProgram,
              ext_m: torch.Tensor, ext_n: torch.Tensor) -> None:
    """Every atom's literal pair (m, n), written in place into its column
    of the bool [B, X] ext planes that rule_match reads. CPU planes run
    atom_eval_plain; CUDA planes launch the kernel, one launch for all
    atoms."""
    b = int(batch.ids.shape[0])
    for t, name in ((ext_m, "ext_m"), (ext_n, "ext_n")):
        if t.dim() != 2 or t.shape[0] != b or t.dtype != torch.bool or \
                not t.is_contiguous() or \
                (atoms.n and int(atoms.cols.max()) >= t.shape[1]):
            raise ValueError(f"atom_eval: {name} must be a contiguous bool "
                             f"[{b}, X] plane holding every atom's column")
    if not _kernel_or_plain(batch.ids, batch.present, batch.map_present,
                            batch.str_bytes, batch.str_lens, ext_m, ext_n):
        atom_eval_plain(batch, atoms, ext_m, ext_n)
        return
    if b == 0 or atoms.n == 0:
        return
    args = _launch_args(batch, atoms.prog, "atom_eval")
    p = kernels.ptr
    fn = kernels.function("atom_eval", "atom_eval", _ATOM_EVAL_ARGS)
    rc = fn(*args, _plan_arg("atom_eval", b, atoms.prog),
            p(atoms.cols_on(ext_m.device)), p(ext_m), p(ext_n),
            ext_m.stride(0), kernels.VP(kernels.stream_ptr()))
    kernels.launched("atom_eval", kernels.check(rc, "atom_eval"), batch,
                     atoms, ext_m, ext_n, entry="atom_eval")
