"""Regex → byte-level DFA compiler for device-side `matches()`.

The reference evaluates RE2 regexes on the host per call
(mixer/pkg/il/runtime/externs.go:118 `matches`). Here each pattern
compiles ONCE (host side, config time) into a dense uint8-alphabet DFA
transition table; the device then walks the class-compressed tables of
a whole bank in one dfa_scan launch (ops/bytes_ops.py) — thousands of
subjects × patterns per step. The one-hot packers below are the JAX
package's TPU formulations, kept so the host geometry
(pack_dfas_tiered) matches the reference's.

Supported syntax (the subset real mesh configs use): literals, `.`,
character classes `[a-z]`/`[^...]` with escapes, groups `(...)`,
alternation `|`, repetition `* + ? {m} {m,} {m,n}`, anchors `^`/`$` at the
pattern edges, escapes `\\d \\D \\w \\W \\s \\S` and escaped
metacharacters. Unsupported constructs (backreferences, lookaround,
non-greedy — irrelevant for acceptance — inner anchors, unicode classes)
raise UnsupportedRegex; callers fall back to the host oracle.

Semantics target: Go regexp.MatchString — UNANCHORED search. Patterns are
compiled as `.*(pattern)` and acceptance is monitored at every prefix
length, so `search` semantics come out of a single end-state check per
step.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# the bit-lane codec lives with its on-device inverse (unpack_bits);
# re-exported here because the packed one-hot step banks below are its
# heaviest producer
from istio_tpu_torch.ops.bytes_ops import pack_bits

ALPHABET = 256


class UnsupportedRegex(ValueError):
    pass


# ---------------------------------------------------------------------------
# Pattern AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Node:
    kind: str                      # lit/class/any/cat/alt/star/plus/opt/rep/empty
    chars: frozenset[int] | None = None
    children: tuple["_Node", ...] = ()
    lo: int = 0
    hi: int = 0


_CLASS_ESCAPES = {
    "d": frozenset(range(0x30, 0x3A)),
    "w": frozenset(list(range(0x30, 0x3A)) + list(range(0x41, 0x5B)) +
                   list(range(0x61, 0x7B)) + [0x5F]),
    "s": frozenset([0x20, 0x09, 0x0A, 0x0D, 0x0B, 0x0C]),
}
_META = set(".*+?()[]{}|^$\\")


def _negate(s: frozenset[int]) -> frozenset[int]:
    return frozenset(range(ALPHABET)) - s


class _RegexParser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def peek(self) -> str | None:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> tuple[_Node, bool, bool]:
        """Returns (ast, anchored_start, anchored_end)."""
        anchored_start = False
        anchored_end = False
        if self.peek() == "^":
            self.next()
            anchored_start = True
        node = self.alternation()
        # trailing $ is consumed inside alternation handling; detect flag
        if self.i < len(self.p):
            raise UnsupportedRegex(f"trailing junk in pattern: {self.p[self.i:]!r}")
        if node.kind == "cat" and node.children and \
                node.children[-1].kind == "end_anchor":
            node = _Node("cat", children=node.children[:-1])
            anchored_end = True
        elif node.kind == "end_anchor":
            node = _Node("empty")
            anchored_end = True
        return node, anchored_start, anchored_end

    def alternation(self) -> _Node:
        branches = [self.concat()]
        while self.peek() == "|":
            self.next()
            branches.append(self.concat())
        if len(branches) == 1:
            return branches[0]
        if any(b.kind == "end_anchor" or
               (b.kind == "cat" and any(c.kind == "end_anchor"
                                        for c in b.children))
               for b in branches):
            raise UnsupportedRegex("anchor inside alternation")
        return _Node("alt", children=tuple(branches))

    def concat(self) -> _Node:
        parts: list[_Node] = []
        while True:
            c = self.peek()
            if c is None or c in "|)":
                break
            parts.append(self.repeat())
        if not parts:
            return _Node("empty")
        for p in parts[:-1]:
            if p.kind == "end_anchor":
                raise UnsupportedRegex("$ not at pattern end")
        if len(parts) == 1:
            return parts[0]
        return _Node("cat", children=tuple(parts))

    def repeat(self) -> _Node:
        atom = self.atom()
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                atom = _Node("star", children=(atom,))
            elif c == "+":
                self.next()
                atom = _Node("plus", children=(atom,))
            elif c == "?":
                self.next()
                atom = _Node("opt", children=(atom,))
            elif c == "{":
                atom = self.bounded(atom)
            else:
                if self.peek() == "?":  # non-greedy suffix like *? — greedy
                    self.next()         # equivalence holds for acceptance
                    continue
                return atom

    def bounded(self, atom: _Node) -> _Node:
        self.next()  # consume {
        spec = ""
        while self.peek() is not None and self.peek() != "}":
            spec += self.next()
        if self.peek() != "}":
            raise UnsupportedRegex("unterminated {}")
        self.next()
        parts = spec.split(",")
        try:
            if len(parts) == 1:
                lo = hi = int(parts[0])
            elif parts[1] == "":
                lo, hi = int(parts[0]), -1
            else:
                lo, hi = int(parts[0]), int(parts[1])
        except ValueError:
            raise UnsupportedRegex(f"bad repetition {{{spec}}}")
        if hi != -1 and (hi < lo or hi > 64):
            raise UnsupportedRegex(f"repetition bound too large {{{spec}}}")
        return _Node("rep", children=(atom,), lo=lo, hi=hi)

    def atom(self) -> _Node:
        c = self.next()
        if c == "(":
            if self.peek() == "?":
                self.next()
                if self.peek() == ":":
                    self.next()          # (?: non-capturing — fine
                else:
                    raise UnsupportedRegex("(?...) construct")
            node = self.alternation()
            if self.peek() != ")":
                raise UnsupportedRegex("unbalanced paren")
            self.next()
            return node
        if c == "[":
            return self.char_class()
        if c == ".":
            return _Node("any")
        if c == "$":
            return _Node("end_anchor")
        if c == "^":
            raise UnsupportedRegex("^ not at pattern start")
        if c == "\\":
            return self.escape()
        if c in "*+?{":
            raise UnsupportedRegex(f"dangling {c!r}")
        if ord(c) > 255:
            raise UnsupportedRegex("non-byte character")
        return _Node("lit", chars=frozenset([ord(c)]))

    def escape(self) -> _Node:
        if self.peek() is None:
            raise UnsupportedRegex("trailing backslash")
        c = self.next()
        if c in _CLASS_ESCAPES:
            return _Node("class", chars=_CLASS_ESCAPES[c])
        if c.upper() in _CLASS_ESCAPES and c.isupper():
            return _Node("class", chars=_negate(_CLASS_ESCAPES[c.lower()]))
        if c == "n":
            return _Node("lit", chars=frozenset([10]))
        if c == "t":
            return _Node("lit", chars=frozenset([9]))
        if c == "r":
            return _Node("lit", chars=frozenset([13]))
        if c in _META or not c.isalnum():
            return _Node("lit", chars=frozenset([ord(c)]))
        if c.upper() == "B":
            raise UnsupportedRegex("word boundary")
        raise UnsupportedRegex(f"escape \\{c}")

    def char_class(self) -> _Node:
        negated = False
        if self.peek() == "^":
            self.next()
            negated = True
        chars: set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise UnsupportedRegex("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            c = self.next()
            if c == "\\":
                nxt = self.next()
                if nxt in _CLASS_ESCAPES:
                    chars |= _CLASS_ESCAPES[nxt]
                    continue
                if nxt.upper() in _CLASS_ESCAPES and nxt.isupper():
                    chars |= _negate(_CLASS_ESCAPES[nxt.lower()])
                    continue
                lo_ch = {"n": 10, "t": 9, "r": 13}.get(nxt, ord(nxt))
            else:
                lo_ch = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) and \
                    self.p[self.i + 1] != "]":
                self.next()
                hi_c = self.next()
                if hi_c == "\\":
                    hi_c = self.next()
                chars |= set(range(lo_ch, ord(hi_c) + 1))
            else:
                chars.add(lo_ch)
        if any(ch > 255 for ch in chars):
            raise UnsupportedRegex("non-byte character in class")
        return _Node("class",
                     chars=_negate(frozenset(chars)) if negated
                     else frozenset(chars))


# ---------------------------------------------------------------------------
# Thompson NFA
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self) -> None:
        self.eps: list[list[int]] = []
        self.trans: list[list[tuple[frozenset[int], int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].append(b)

    def add_trans(self, a: int, chars: frozenset[int], b: int) -> None:
        self.trans[a].append((chars, b))


_ANY = frozenset(range(ALPHABET))


def _build(nfa: _NFA, node: _Node) -> tuple[int, int]:
    """Thompson construction: returns (start, accept)."""
    s, t = nfa.new_state(), nfa.new_state()
    k = node.kind
    if k == "empty":
        nfa.add_eps(s, t)
    elif k in ("lit", "class"):
        nfa.add_trans(s, node.chars, t)
    elif k == "any":
        nfa.add_trans(s, _ANY, t)
    elif k == "cat":
        prev = s
        for child in node.children:
            cs, ct = _build(nfa, child)
            nfa.add_eps(prev, cs)
            prev = ct
        nfa.add_eps(prev, t)
    elif k == "alt":
        for child in node.children:
            cs, ct = _build(nfa, child)
            nfa.add_eps(s, cs)
            nfa.add_eps(ct, t)
    elif k == "star":
        cs, ct = _build(nfa, node.children[0])
        nfa.add_eps(s, cs)
        nfa.add_eps(s, t)
        nfa.add_eps(ct, cs)
        nfa.add_eps(ct, t)
    elif k == "plus":
        cs, ct = _build(nfa, node.children[0])
        nfa.add_eps(s, cs)
        nfa.add_eps(ct, cs)
        nfa.add_eps(ct, t)
    elif k == "opt":
        cs, ct = _build(nfa, node.children[0])
        nfa.add_eps(s, cs)
        nfa.add_eps(ct, t)
        nfa.add_eps(s, t)
    elif k == "rep":
        prev = s
        for _ in range(node.lo):
            cs, ct = _build(nfa, node.children[0])
            nfa.add_eps(prev, cs)
            prev = ct
        if node.hi == -1:  # {m,}
            cs, ct = _build(nfa, node.children[0])
            nfa.add_eps(prev, cs)
            nfa.add_eps(ct, cs)
            nfa.add_eps(ct, t)
            nfa.add_eps(prev, t)
        else:
            for _ in range(node.hi - node.lo):
                cs, ct = _build(nfa, node.children[0])
                nfa.add_eps(prev, cs)
                nfa.add_eps(prev, t)
                prev = ct
            nfa.add_eps(prev, t)
    elif k == "end_anchor":
        raise UnsupportedRegex("$ in unsupported position")
    else:  # pragma: no cover
        raise UnsupportedRegex(f"internal: node {k}")
    return s, t


# ---------------------------------------------------------------------------
# Subset construction → dense DFA
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DFA:
    """Dense byte DFA. transitions[state, byte] → state;
    accept[state] → bool. State 0 is the start state.

    For unanchored (search) semantics, acceptance is sticky: accepting
    states only transition to accepting states, so checking acceptance
    after consuming all `len` bytes is equivalent to checking at every
    prefix. This keeps the device step to a single scan with one final
    accept gather."""
    transitions: np.ndarray  # int32 [n_states, 256]
    accept: np.ndarray       # bool  [n_states]
    pattern: str

    @property
    def n_states(self) -> int:
        return int(self.transitions.shape[0])


_MAX_DFA_STATES = 2048


def compile_regex(pattern: str) -> DFA:
    """Compile to a dense search-semantics DFA (Go regexp.MatchString
    equivalence for the supported subset)."""
    ast, anchored_start, anchored_end = _RegexParser(pattern).parse()

    # search semantics: allow any prefix unless ^-anchored
    if not anchored_start:
        ast = _Node("cat", children=(_Node("star", children=(_Node("any"),)),
                                     ast))
    # unless $-anchored, allow any suffix — combined with sticky accept
    if not anchored_end:
        ast = _Node("cat", children=(ast,
                                     _Node("star", children=(_Node("any"),))))

    nfa = _NFA()
    start, accept = _build(nfa, ast)

    def eps_closure(states: frozenset[int]) -> frozenset[int]:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eps_closure(frozenset([start]))
    dfa_ids: dict[frozenset[int], int] = {start_set: 0}
    worklist = [start_set]
    rows: list[np.ndarray] = []
    accepts: list[bool] = []

    while worklist:
        cur = worklist.pop()
        cur_id = dfa_ids[cur]
        while len(rows) <= cur_id:
            rows.append(np.zeros(ALPHABET, dtype=np.int32))
            accepts.append(False)
        accepts[cur_id] = accept in cur
        is_accepting = accept in cur

        # group target NFA states by byte
        by_byte: list[set[int]] = [set() for _ in range(ALPHABET)]
        for s in cur:
            for chars, t in nfa.trans[s]:
                for ch in chars:
                    by_byte[ch].add(t)
        row = np.zeros(ALPHABET, dtype=np.int32)
        closure_cache: dict[frozenset[int], int] = {}
        for ch in range(ALPHABET):
            tgt = frozenset(by_byte[ch])
            key = tgt
            if key in closure_cache:
                row[ch] = closure_cache[key]
                continue
            nxt = eps_closure(tgt) if tgt else frozenset()
            # sticky accept for search semantics
            if is_accepting and not anchored_end:
                pass  # suffix .* already keeps acceptance
            tid = dfa_ids.get(nxt)
            if tid is None:
                tid = len(dfa_ids)
                if tid >= _MAX_DFA_STATES:
                    raise UnsupportedRegex(
                        f"DFA for {pattern!r} exceeds {_MAX_DFA_STATES} states")
                dfa_ids[nxt] = tid
                worklist.append(nxt)
            row[ch] = tid
            closure_cache[key] = tid
        rows[cur_id] = row

    while len(rows) < len(dfa_ids):
        rows.append(np.zeros(ALPHABET, dtype=np.int32))
        accepts.append(False)
    # fill states discovered but not yet expanded (empty set sink)
    for st, sid in dfa_ids.items():
        if sid < len(accepts):
            accepts[sid] = accept in st

    return DFA(transitions=np.stack(rows), accept=np.array(accepts, bool),
               pattern=pattern)


def dfa_matches_host(dfa: DFA, subject: bytes) -> bool:
    """Host-side DFA run (oracle for the device kernel)."""
    state = 0
    for b in subject:
        state = int(dfa.transitions[state, b])
    return bool(dfa.accept[state])


def pack_dfas(dfas: list[DFA]) -> tuple[np.ndarray, np.ndarray]:
    """Stack several DFAs into one padded transition bank for the
    vectorized device step: returns (trans [n, S_max, 256] int32,
    accept [n, S_max] bool)."""
    smax = max(d.n_states for d in dfas)
    trans = np.zeros((len(dfas), smax, ALPHABET), dtype=np.int32)
    accept = np.zeros((len(dfas), smax), dtype=bool)
    for i, d in enumerate(dfas):
        trans[i, :d.n_states] = d.transitions
        accept[i, :d.n_states] = d.accept
    return trans, accept


def pack_dfas_classes(dfas: list[DFA]) -> dict:
    """CHEAP phase of the one-hot packing: renumber all automata into
    one global state space and compute the bank-wide byte EQUIVALENCE
    CLASSES (bytes with identical transition columns across every
    state). O(S·256) numpy work — callers size-gate on
    n_states/n_classes BEFORE paying for the step matrix
    (pack_dfas_onehot)."""
    n = len(dfas)
    offs = np.cumsum([0] + [d.n_states for d in dfas])
    s_tot = int(offs[-1])
    gt = np.zeros((s_tot, ALPHABET), np.int32)
    accept = np.zeros((s_tot, n), np.float32)
    for i, d in enumerate(dfas):
        gt[offs[i]:offs[i + 1]] = d.transitions + offs[i]
        accept[offs[i]:offs[i + 1], i] = d.accept
    _, class_of = np.unique(gt, axis=1, return_inverse=True)
    class_of = class_of.reshape(-1)
    n_cls = int(class_of.max()) + 1
    rep = np.zeros(n_cls, np.int64)   # a representative byte per class
    for byte in range(ALPHABET - 1, -1, -1):
        rep[class_of[byte]] = byte
    return {"gt": gt, "class_of": class_of, "rep": rep,
            "starts": offs[:-1].astype(np.int32), "accept": accept,
            "n_states": s_tot, "n_classes": n_cls}


def pack_dfas_onehot(dfas: list[DFA],
                     classes: dict | None = None) -> dict:
    """Pack several DFAs for the JAX package's one-hot matmul
    formulation (its bytes_ops.dfa_match_many_onehot).

    Returns {"step_bits": [S·C, ceil(S/32)] BIT-PACKED one-hot
    transition matrix (row s·C+c → one-hot of next state; pack_bits
    lanes, unpacked to bf16 on device once per kernel invocation —
    bytes_ops.unpack_bits), "cls": [256, C] one-hot byte→class matrix,
    "starts": [N] int32 global start states, "accept": [S, N] pattern
    acceptance matrix}. The step matrix is O(S²·C) one-hot entries —
    bit lanes keep the resident bank at 1/32 of the f32 formulation's
    bytes; size-gate via pack_dfas_classes first."""
    k = classes if classes is not None else pack_dfas_classes(dfas)
    s_tot, n_cls = k["n_states"], k["n_classes"]
    gt, class_of, rep = k["gt"], k["class_of"], k["rep"]
    step = np.zeros((s_tot * n_cls, s_tot), bool)
    rows = (np.arange(s_tot)[:, None] * n_cls
            + np.arange(n_cls)[None, :]).reshape(-1)
    cols = gt[:, rep].reshape(-1)          # [S, C] next states
    step[rows, cols] = True
    cls = np.zeros((ALPHABET, n_cls), np.float32)
    cls[np.arange(ALPHABET), class_of] = 1.0
    return {"step_bits": pack_bits(step), "cls": cls,
            "starts": k["starts"], "accept": k["accept"],
            "n_states": s_tot, "n_classes": n_cls}


def pack_dfas_onehot_blocked(dfas: list[DFA],
                             classes: dict | None = None) -> dict:
    """BLOCK-DIAGONAL one-hot packing: per-pattern step matrices padded
    to the widest automaton, for bytes_ops.dfa_match_many_onehot_blocked
    (a batched matmul over the pattern axis).

    The dense pack_dfas_onehot matrix is O((Σsᵢ)²·C) — quadratic in the
    BANK, so a 23-glob bank blows the size gate and used to fall back
    to the latency-bound gather scan. Blocks are O(N·s_max²·C): states
    never cross patterns, so the dense matrix was block-diagonal
    anyway — this stores only the blocks.

    Returns {"step_bits": [N, s_max·C, ceil(s_max/32)] bit-packed
    blocks (pack_bits lanes, device-unpacked once per invocation),
    "cls": [256, C], "accept": [N, s_max] (acceptance of pattern i's
    own states), "n_states_max", "n_classes", "n_pats"}; pattern i
    starts in its local state 0 (compile_regex numbers the start
    state 0)."""
    k = classes if classes is not None else pack_dfas_classes(dfas)
    n = len(dfas)
    n_cls = int(k["n_classes"])
    class_of, rep = k["class_of"], k["rep"]
    s_max = max(d.n_states for d in dfas)
    step = np.zeros((n, s_max * n_cls, s_max), bool)
    accept = np.zeros((n, s_max), np.float32)
    for i, d in enumerate(dfas):
        s_i = d.n_states
        rows = (np.arange(s_i)[:, None] * n_cls
                + np.arange(n_cls)[None, :]).reshape(-1)
        cols = d.transitions[:, rep].reshape(-1)
        step[i, rows, cols] = True
        accept[i, :s_i] = d.accept
        # padding states self-loop dead (all-zero rows: a one-hot that
        # reaches them vanishes — they are unreachable from state 0)
    cls = np.zeros((ALPHABET, n_cls), np.float32)
    cls[np.arange(ALPHABET), class_of] = 1.0
    return {"step_bits": pack_bits(step), "cls": cls, "accept": accept,
            "n_states_max": s_max, "n_classes": n_cls, "n_pats": n}


def pack_dfas_tiered(dfas: "list[DFA]") -> dict:
    """The reference's DFA bank tier choice, kept so the port's host
    geometry matches it (the port's dfa_scan kernel walks
    `classes` whatever the tier). In the JAX package:
    dense one-hot MXU matmul (small banks), BLOCK-DIAGONAL one-hot
    (banks of many small automata — O(N·s_max²·C) per step where dense
    is quadratic in the whole bank), flat-gather scan (pathological
    single automata too big for either). The MXU formulations win at
    EVERY batch size — the per-step [B, N] gather is latency-bound on
    TPU — so flat tables are built ONLY when both one-hot tiers are
    infeasible (they would otherwise be dead device weight).

    → {"packed", "packed_blk", "trans", "accept", "classes"} with
    exactly one of packed / packed_blk / (trans, accept) non-None.
    """
    classes = pack_dfas_classes(dfas)
    s_max = max(d.n_states for d in dfas)
    dense_ok = (classes["n_states"] ** 2 * classes["n_classes"]
                <= 4_000_000)
    blocked_ok = (len(dfas) * s_max ** 2 * classes["n_classes"]
                  <= 8_000_000)
    packed = pack_dfas_onehot(dfas, classes) if dense_ok else None
    packed_blk = None if dense_ok or not blocked_ok else \
        pack_dfas_onehot_blocked(dfas, classes)
    trans = accept = None
    if packed is None and packed_blk is None:
        trans, accept = pack_dfas(dfas)
    return {"packed": packed, "packed_blk": packed_blk,
            "trans": trans, "accept": accept, "classes": classes}
