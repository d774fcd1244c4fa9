"""The port's plane-agreement analysis (istio_tpu_torch/analysis) on the
CPU, against the JAX package's (istio_tpu/analysis).

The plane-related cases of tests/test_analysis.py, each run on both
packages with the same inputs and compared:

  * dfa_ops: product intersection with a witness both packages' DFAs
    accept, disjointness and inclusion, complement, accepted strings
    under a forbid set (over each package's own ops/regex_dfa tables);
  * atoms: equality disjointness and implication, the opaque-polarity
    rule, equality implying a regex, default-valued map subjects and
    witness solving;
  * planes: equivalence proved for reordered conjuncts (no finding), and
    a divergence isolated with a witness that both packages' oracles
    replay, over corpus.make_plane_divergence_pairs at three seeds.
    Finding codes, severities, rules and witnesses are equal.
"""
from __future__ import annotations

import pytest

from istio_tpu import analysis as ref_analysis
from istio_tpu.analysis import atoms as ref_atoms
from istio_tpu.analysis import dfa_ops as ref_dfa_ops
from istio_tpu.analysis import findings as ref_findings
from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.oracle import OracleProgram as RefOracle
from istio_tpu.expr.parser import parse as ref_parse
from istio_tpu.ops import regex_dfa as ref_regex_dfa
from istio_tpu.testing import corpus as ref_corpus

from istio_tpu_torch import analysis
from istio_tpu_torch.analysis import atoms, dfa_ops, findings
from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.oracle import OracleProgram
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.ops import regex_dfa
from istio_tpu_torch.testing import corpus


class Pkg:
    """One package's analysis surface."""

    def __init__(self, an, at, dfo, fnd, bag, finder_cls, oracle, prs, rx,
                 manifest):
        self.analysis, self.atoms, self.dfa_ops = an, at, dfo
        self.findings, self.DictBag, self.Oracle = fnd, bag, oracle
        self.parse, self.regex_dfa = prs, rx
        self.finder = finder_cls(manifest)

    def sem(self, text: str):
        return self.atoms.atom_sem(self.parse(text), self.finder)


REF = Pkg(ref_analysis, ref_atoms, ref_dfa_ops, ref_findings, RefDictBag,
          RefFinder, RefOracle, ref_parse, ref_regex_dfa,
          ref_corpus.ANALYZER_MANIFEST)
PORT = Pkg(analysis, atoms, dfa_ops, findings, DictBag,
           AttributeDescriptorFinder, OracleProgram, parse, regex_dfa,
           corpus.ANALYZER_MANIFEST)


def both(scenario):
    """scenario(package) on both packages; the outcomes must be equal."""
    want, got = scenario(REF), scenario(PORT)
    assert got == want
    return got


def test_manifests_agree():
    assert corpus.ANALYZER_MANIFEST.keys() == \
        ref_corpus.ANALYZER_MANIFEST.keys()


# ---------------------------------------------------------------------
# product-DFA decision procedures
# ---------------------------------------------------------------------

def test_product_intersect_witness_replays():
    def scenario(p):
        a = p.regex_dfa.compile_regex("^/api/v[0-9]+/")
        b = p.regex_dfa.compile_regex("^/api/v2/items")
        r = p.dfa_ops.product_intersect(a, b)
        assert r.empty is False
        assert p.regex_dfa.dfa_matches_host(a, r.witness)
        assert p.regex_dfa.dfa_matches_host(b, r.witness)
        return r.empty, r.witness, r.pairs_explored
    both(scenario)


def test_product_disjoint_and_inclusion():
    def scenario(p):
        a = p.regex_dfa.compile_regex("^/api/")
        b = p.regex_dfa.compile_regex("^/static/")
        narrow = p.regex_dfa.compile_regex("^/api/v1/")
        return (p.dfa_ops.languages_disjoint(a, b),
                p.dfa_ops.language_includes(a, narrow),
                p.dfa_ops.language_includes(narrow, a))
    assert both(scenario) == (True, True, False)


def test_complement_flips_membership():
    def scenario(p):
        a = p.regex_dfa.compile_regex("^abc$")
        na = p.dfa_ops.complement(a)
        m = p.regex_dfa.dfa_matches_host
        return (m(a, b"abc"), m(na, b"abc"), m(a, b"zz"), m(na, b"zz"),
                na.pattern, na.accept.tolist())
    got = both(scenario)
    assert got[:4] == (True, False, False, True)


@pytest.mark.parametrize("pattern,limit,forbid", [
    ("^x[ab]$", 4, {"xa"}), ("^/api/v[0-9]+/", 6, set()),
    ("^(get|put)$", 3, {"get"})])
def test_accepted_strings_respects_forbid(pattern, limit, forbid):
    def scenario(p):
        ws = p.dfa_ops.accepted_strings(p.regex_dfa.compile_regex(pattern),
                                        limit=limit,
                                        forbid=frozenset(forbid))
        assert not {w.decode() for w in ws} & forbid
        return ws
    assert both(scenario)


# ---------------------------------------------------------------------
# atom semantics
# ---------------------------------------------------------------------

def test_atom_eq_disjoint_and_implies():
    def scenario(p):
        a = p.sem('request.method == "GET"')
        b = p.sem('request.method == "POST"')
        neq = p.sem('request.method != "POST"')
        A = p.atoms
        return (A.atoms_disjoint(a, b), A.atom_implies(a, a),
                A.atom_implies(a, neq), A.atoms_disjoint(b, neq))
    assert both(scenario) == (True, True, True, True)


def test_opaque_polarity_never_self_implies():
    def scenario(p):
        A = p.atoms
        sem = p.sem("request.path.startsWith(source.user)")
        neg = A.negate(sem)
        ev = p.sem("source.namespace == source.user")
        nev = A.negate(ev)
        return (sem.kind, A.atom_implies(sem, neg), A.atom_implies(neg, sem),
                A.atom_implies(sem, sem), A.atoms_disjoint(sem, neg),
                ev.kind, A.atom_implies(ev, nev), A.atom_implies(ev, ev))
    assert both(scenario) == ("opaque", None, None, True, True, "eqv",
                              None, True)


def test_atom_eq_implies_regex():
    def scenario(p):
        eq = p.sem('request.path == "/api/v1/x"')
        rx = p.sem('"^/api/".matches(request.path)')
        return p.atoms.atom_implies(eq, rx), p.atoms.atom_implies(rx, eq)
    assert both(scenario) == (True, None)


def test_probe_subject_default_semantics():
    def scenario(p):
        sem = p.sem('(request.headers["k"] | "dflt") == "v"')
        sem2 = p.sem('(request.headers["k"] | "dflt") == "dflt"')
        return (sem.kind, sem.subject.kind, sem.subject.has_default,
                sem.subject.default,
                p.atoms.solve_subjects([sem], p.finder),
                p.atoms.solve_subjects([sem2], p.finder))
    assert both(scenario)[4:] == ({"request.headers": {"k": "v"}}, {})


def test_solve_unsat_and_slot_slot():
    def scenario(p):
        a = p.sem('request.method == "GET"')
        b = p.sem('request.method == "POST"')
        with pytest.raises(p.atoms.WitnessUnsat):
            p.atoms.solve_subjects([a, b], p.finder)
        return p.atoms.solve_subjects(
            [p.sem("source.namespace == source.user"),
             p.sem('source.user == "sa1"')], p.finder)
    bag = both(scenario)
    assert bag["source.namespace"] == bag["source.user"] == "sa1"


# ---------------------------------------------------------------------
# planes
# ---------------------------------------------------------------------

def _finding_view(f) -> tuple:
    return (f.code, f.severity.name, int(f.severity), f.message, f.rules,
            None if f.witness is None else dict(f.witness), f.confirmed)


def test_finding_vocabulary_agrees():
    names = [n for n in dir(ref_findings) if n.isupper()]
    assert {n: getattr(findings, n) for n in names} == \
        {n: getattr(ref_findings, n) for n in names}
    assert [(s.name, int(s)) for s in findings.Severity] == \
        [(s.name, int(s)) for s in ref_findings.Severity]


def test_plane_equivalence_proved_for_reordered_conjuncts():
    p1 = ('destination.service == "a.ns1.svc" && '
          'request.method == "GET"')
    p2 = ('request.method == "GET" && '
          'destination.service == "a.ns1.svc"')
    assert both(lambda p: p.analysis.check_plane_pairs(
        [("r", p1, p2)], p.finder)) == []


@pytest.mark.parametrize("seed", [17, 3, 20260803])
def test_plane_divergence_isolated_with_witness(seed):
    pairs, diverge_at = ref_corpus.make_plane_divergence_pairs(seed)

    def scenario(p):
        fs = p.analysis.check_plane_pairs(pairs, p.finder)
        return [_finding_view(f) for f in fs]
    got = both(scenario)
    div = [f for f in got if f[0] == findings.PLANE_DIVERGENCE]
    assert len(div) == 1 and f"route{diverge_at}" in div[0][4]
    assert div[0][5] is not None and div[0][6] and div[0][1] == "ERROR"
    # the witness replays through BOTH packages' oracles: the two planes
    # of the diverged pair disagree on it, and one of them accepts
    _name, pilot, mixer = pairs[diverge_at]
    for p in (REF, PORT):
        verdicts = [bool(p.Oracle.from_ast(p.parse(e), p.finder)
                         .evaluate(p.DictBag(div[0][5])))
                    for e in (pilot, mixer)]
        assert verdicts[0] != verdicts[1]


@pytest.mark.parametrize("pairs", [
    [("unparsable", 'source.service == "a"', 'source.service == ')],
    [("opaque", 'request.path.startsWith(source.user)',
      'request.path.endsWith(source.user)')],
    [("flip", 'request.method == "GET"', 'request.method != "GET"'),
     ("same", 'request.method == "GET"', 'request.method == "GET"')],
    [("truthy", "true", 'request.method == "GET"')],
])
def test_plane_findings_agree_on_edge_pairs(pairs):
    """A parse failure, an unprovable pair, a flipped predicate beside an
    identical one, and 'true' against a constraint: equal findings."""
    got = both(lambda p: [_finding_view(f) for f in
                          p.analysis.check_plane_pairs(pairs, p.finder)])
    assert got
