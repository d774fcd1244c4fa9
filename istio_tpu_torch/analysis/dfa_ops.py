"""Product-DFA decision procedures over ops/regex_dfa transition tensors.

Port of istio_tpu/analysis/dfa_ops.py.

The reachability core of the snapshot analyzer: language emptiness,
intersection and inclusion over the SAME dense byte-DFA tables the
device kernels execute (`ops/regex_dfa.DFA`), so a static verdict
("these two route regexes overlap") is a statement about the automata
that will actually run, not about a re-parse.

All decisions are frontier-vectorized numpy: pair states explore by
bank-wide byte EQUIVALENCE CLASSES (the pack_dfas_classes trick — two
bytes with identical transition columns in BOTH automata are one
edge), so a product step costs O(frontier × classes) gathers instead
of O(frontier × 256). Witness strings come out of the same search via
parent pointers — every "non-empty" verdict can hand the caller a
concrete accepted input for oracle replay.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from istio_tpu_torch.ops.regex_dfa import ALPHABET, DFA

# pair-state exploration budget: beyond this the analyzer reports
# "unknown" rather than stalling a config swap (callers treat unknown
# conservatively — no finding is emitted on an unproven claim)
DEFAULT_PAIR_BUDGET = 200_000


@dataclasses.dataclass
class ProductResult:
    """Decision outcome. `empty` is None when the pair budget ran out
    (unknown); `witness` is a shortest accepted byte string when the
    intersection is non-empty."""
    empty: bool | None
    witness: bytes | None = None
    pairs_explored: int = 0


def complement(dfa: DFA) -> DFA:
    """¬L: regex_dfa DFAs are complete (every state has all 256
    transitions, missing targets go to the explicit empty-set sink), so
    complement is accept-flip."""
    return DFA(transitions=dfa.transitions,
               accept=~dfa.accept, pattern=f"!({dfa.pattern})")


def _byte_classes(ta: np.ndarray, tb: np.ndarray) -> np.ndarray:
    """Representative bytes whose transition columns are pairwise
    distinct across BOTH automata — the product's byte alphabet."""
    stacked = np.concatenate([ta, tb], axis=0)      # [Sa+Sb, 256]
    _, idx = np.unique(stacked, axis=1, return_index=True)
    return np.sort(idx.astype(np.int64))


def product_intersect(a: DFA, b: DFA, *,
                      pair_budget: int = DEFAULT_PAIR_BUDGET
                      ) -> ProductResult:
    """Is L(a) ∩ L(b) non-empty? BFS over the product automaton from
    (0, 0); returns the shortest jointly-accepted string as witness."""
    ta, tb = a.transitions, b.transitions
    aa, ab = a.accept, b.accept
    sb = tb.shape[0]
    reps = _byte_classes(ta, tb)

    if aa[0] and ab[0]:
        return ProductResult(empty=False, witness=b"", pairs_explored=1)

    visited = np.zeros(ta.shape[0] * sb, dtype=bool)
    visited[0] = True
    # parent pointers for witness reconstruction: flat pair → (parent
    # flat pair, byte). int64 flat ids; -1 = root.
    parent = {0: (-1, 0)}
    frontier = np.array([0], dtype=np.int64)
    explored = 1

    while frontier.size:
        fa, fb = frontier // sb, frontier % sb
        next_ids: list[np.ndarray] = []
        for byte in reps:
            na = ta[fa, byte].astype(np.int64)
            nb = tb[fb, byte].astype(np.int64)
            flat = na * sb + nb
            fresh_mask = ~visited[flat]
            if not fresh_mask.any():
                continue
            fresh = flat[fresh_mask]
            src = frontier[fresh_mask]
            # first-writer wins within the wave (np.unique keeps one)
            fresh, first = np.unique(fresh, return_index=True)
            src = src[first]
            visited[fresh] = True
            for f, s in zip(fresh.tolist(), src.tolist()):
                parent[f] = (s, int(byte))
            hit = fresh[aa[fresh // sb] & ab[fresh % sb]]
            if hit.size:
                return ProductResult(
                    empty=False, witness=_walk(parent, int(hit[0])),
                    pairs_explored=explored + len(parent))
            next_ids.append(fresh)
        explored += sum(x.size for x in next_ids)
        if explored > pair_budget:
            return ProductResult(empty=None, pairs_explored=explored)
        frontier = (np.concatenate(next_ids) if next_ids
                    else np.array([], dtype=np.int64))
    return ProductResult(empty=True, pairs_explored=explored)


def _walk(parent: dict, flat: int) -> bytes:
    out = bytearray()
    while True:
        prev, byte = parent[flat]
        if prev < 0:
            break
        out.append(byte)
        flat = prev
    return bytes(reversed(out))


def language_includes(a: DFA, b: DFA, *,
                      pair_budget: int = DEFAULT_PAIR_BUDGET) -> bool | None:
    """L(b) ⊆ L(a)? (i.e. `b` implies `a`.) Decided as emptiness of
    L(b) ∩ ¬L(a); None = budget exhausted (unknown)."""
    r = product_intersect(b, complement(a), pair_budget=pair_budget)
    return r.empty


def languages_disjoint(a: DFA, b: DFA, *,
                       pair_budget: int = DEFAULT_PAIR_BUDGET
                       ) -> bool | None:
    """L(a) ∩ L(b) = ∅? None = unknown."""
    return product_intersect(a, b, pair_budget=pair_budget).empty


def accepted_strings(dfa: DFA, limit: int = 8,
                     forbid: frozenset[str] = frozenset(),
                     pair_budget: int = DEFAULT_PAIR_BUDGET
                     ) -> list[bytes]:
    """Up to `limit` short accepted strings (BFS order), skipping any
    whose utf-8 decoding lands in `forbid` — the witness enumerator for
    conjunctions that pin a subject with regex constraints AND exclude
    specific values (neq literals)."""
    ta, aa = dfa.transitions, dfa.accept
    out: list[bytes] = []

    def keep(w: bytes) -> bool:
        try:
            return w.decode("utf-8") not in forbid
        except UnicodeDecodeError:
            return True

    if aa[0] and keep(b""):
        out.append(b"")
        if len(out) >= limit:
            return out
    reps = _byte_classes(ta, ta)
    visited = np.zeros(ta.shape[0], dtype=bool)
    visited[0] = True
    paths: dict[int, bytes] = {0: b""}
    frontier = [0]
    explored = 1
    # prefer printable representative bytes so witnesses stay readable
    # (and utf-8 decodable) when the class allows it
    def printable(byte: int, state: int) -> int:
        tgt = ta[state, byte]
        cands = np.nonzero(ta[state] == tgt)[0]
        for c in cands:
            if 0x61 <= c <= 0x7A or 0x30 <= c <= 0x39 or c in (0x2E, 0x2F, 0x2D):
                return int(c)
        return int(byte)

    while frontier and len(out) < limit and explored < pair_budget:
        nxt: list[int] = []
        for state in frontier:
            for byte in reps:
                t = int(ta[state, byte])
                if visited[t]:
                    continue
                visited[t] = True
                explored += 1
                w = paths[state] + bytes([printable(int(byte), state)])
                paths[t] = w
                if aa[t]:
                    if keep(w):
                        out.append(w)
                    else:
                        # the representative's word is forbidden, but a
                        # SIBLING byte of the same class reaches the
                        # same accept state with a different spelling
                        for c in np.nonzero(ta[state] == t)[0]:
                            w2 = paths[state] + bytes([int(c)])
                            if keep(w2):
                                out.append(w2)
                                break
                    if len(out) >= limit:
                        return out
                nxt.append(t)
        frontier = nxt
    return out
