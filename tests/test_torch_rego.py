"""The port's Rego evaluator and opa adapter against the JAX package's.

Each of the 13 scenarios of tests/test_rego.py (the reference opa
adapter's own policy corpus, mixer/adapter/opa/opa_test.go:180-340) runs
once over each package's `adapters.rego` / `adapters.opa` and records
every query result, check result, validation error and raised error
(type and message: parse errors, complete-rule conflicts, the recursion
guard) with its Python type. The two records must be equal, exactly.
The scenario keeps the original's own assertions too.
"""
import dataclasses
import importlib
import importlib.util
import pathlib

import pytest

PACKAGES = ("istio_tpu", "istio_tpu_torch")


def _load_corpus():
    """tests/test_rego.py's policies, loaded by path."""
    path = pathlib.Path(__file__).with_name("test_rego.py")
    spec = importlib.util.spec_from_file_location("_rego_corpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CORPUS = _load_corpus()
BUCKET, EXAMPLE = CORPUS.BUCKET_POLICY, CORPUS.EXAMPLE
ORG_CHART, SERVICE_GRAPH = CORPUS.ORG_CHART, CORPUS.SERVICE_GRAPH


class Pkg:
    def __init__(self, root: str) -> None:
        self.rego = importlib.import_module(f"{root}.adapters.rego")
        self.opa = importlib.import_module(f"{root}.adapters.opa")
        self.env = importlib.import_module(f"{root}.adapters.sdk").Env("t")

    def engine(self, policies):
        return self.rego.RegoEngine(policies)

    def builder(self, config):
        return self.opa.OpaBuilder(config, self.env)

    def handler(self, config):
        b = self.builder(config)
        errs = b.validate()
        assert not errs, errs
        return b.build()


def typed(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, typed(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return {k: typed(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, [typed(v) for v in x])
    return (type(x).__name__, x)


def raised(fn):
    try:
        return ("value", fn())
    except Exception as exc:   # noqa: BLE001 — the error is the result
        return ("raised", type(exc).__name__, str(exc))


def s_bucket_admin_policy(p: Pkg, rec):
    eng = p.engine([BUCKET])
    for user, method in (("bucket-admins", "storage.buckets.get"),
                         ("someone-else", "storage.buckets.get"),
                         ("bucket-admins", "storage.buckets.delete")):
        rec(eng.query("data.mixerauthz.allow", {
            "subject": {"user": user}, "action": {"method": method}}))


EXAMPLE_CASES = (("bob", "gateway", "landing_page", "/health"),
                 ("bob", "landing_page", "reviews", "/health"),
                 ("bob", "details", "ratings", "/health"),
                 ("bob", "landing_page", "reviews", "/reviews/bob"),
                 ("janet", "landing_page", "reviews", "/reviews/bob"),
                 ("alice", "landing_page", "reviews", "/reviews/bob"),
                 ("ken", "landing_page", "reviews", "/reviews/bob"))


def s_example_service_graph_and_org_chart(p: Pkg, rec):
    eng = p.engine([EXAMPLE, ORG_CHART, SERVICE_GRAPH])
    got = [eng.query("data.example.allow", {
        "subject": {"user": user},
        "action": {"path": path,
                   "properties": {"source": src, "target": tgt}}})
        for user, src, tgt, path in EXAMPLE_CASES]
    assert got == [True, True, False, True, True, False, True]
    rec(got)


def s_parse_errors_reported(p: Pkg, rec):
    for fn in (lambda: p.rego.parse_module("package p\n@@@"),
               lambda: p.engine([""]),
               lambda: p.engine(["package mixerauthz\nallow = true {"]),
               lambda: p.engine(["package p\nx = [1, 2"]),
               lambda: p.engine(["allow { true }"])):
        got = raised(fn)
        assert got[0] == "raised" and got[1] == "RegoError"
        rec(got)


def s_rule_semantics(p: Pkg, rec):
    eng = p.engine(["""package t
        default d = false
        d { input.x = 1 }
        const = "k"
        multi { input.a = 1 }
        multi { input.b = 2 }
        val = v { split(input.s, ",", parts); parts[1] = v }
    """])
    for q, inp in (("data.t.d", {"x": 1}), ("data.t.d", {"x": 2}),
                   ("data.t.const", {}), ("data.t.multi", {"b": 2}),
                   ("data.t.multi", {"c": 3}),
                   ("data.t.val", {"s": "a,b,c"}),
                   ("data.t.nope", {}), ("data.u.d", {})):
        rec(raised(lambda: eng.query(q, inp)))


def s_negation_and_builtins(p: Pkg, rec):
    eng = p.engine(["""package t
        allow { not blocked }
        blocked { input.user = "evil" }
        pre { startswith(input.path, "/api") }
        post { endswith(input.path, "/x") }
        has { contains(input.path, "pi/") }
        low = out { lower(input.name, out) }
        up = out { upper(input.name, out) }
        n = c { count(input.items, c) }
        joined = j { concat("-", input.items, j) }
    """])
    for q, inp in (("data.t.allow", {"user": "good"}),
                   ("data.t.allow", {"user": "evil"}),
                   ("data.t.pre", {"path": "/api/x"}),
                   ("data.t.post", {"path": "/api/x"}),
                   ("data.t.has", {"path": "/api/x"}),
                   ("data.t.low", {"name": "ABC"}),
                   ("data.t.up", {"name": "abc"}),
                   ("data.t.n", {"items": [1, 2, 3]}),
                   ("data.t.joined", {"items": ["a", "b"]})):
        rec(raised(lambda: eng.query(q, inp)))


def s_recursion_guard(p: Pkg, rec):
    eng = p.engine(["package t\na { b }\nb { a }"])
    got = raised(lambda: eng.query("data.t.a", {}))
    assert got[0] == "raised" and "recursion" in got[2]
    rec(got)


def s_complete_rule_conflict_raises(p: Pkg, rec):
    eng = p.engine(["""package t
        v = 1 { input.x = 1 }
        v = 2 { input.x = 1 }
        agree = 1 { input.x = 1 }
        agree = 1 { input.y = 2 }
    """])
    eng_b = p.engine(["package t\np = x { x = input.arr[_] }"])
    eng2 = p.engine(["""package t
        v = 1 { input.x = 1 }
        v = 2 { input.x = 2 }
    """])
    for e, q, inp in ((eng, "data.t.v", {"x": 1}),
                      (eng_b, "data.t.p", {"arr": [1, 2]}),
                      (eng_b, "data.t.p", {"arr": [3, 3]}),
                      (eng, "data.t.agree", {"x": 1, "y": 2}),
                      (eng2, "data.t.v", {"x": 2})):
        rec(raised(lambda: e.query(q, inp)))


def s_rule_memoization_is_per_query(p: Pkg, rec):
    eng = p.engine(["""package t
        base = v { split(input.s, ",", parts); parts[0] = v }
        a { base = "x" }
        b { base = "x"; a }
    """])
    for s in ("x,y", "z,y", "x,q"):
        rec(eng.query("data.t.b", {"s": s}))


def s_opa_adapter_rego_mode(p: Pkg, rec):
    h = p.handler({"policies": [BUCKET],
                   "check_method": "data.mixerauthz.allow"})
    for user in ("bucket-admins", "stranger"):
        rec(h.handle_check("authorization", {
            "subject": {"user": user},
            "action": {"method": "storage.buckets.get"}}))


def s_opa_adapter_example_corpus(p: Pkg, rec):
    h = p.handler({"policies": [EXAMPLE, ORG_CHART, SERVICE_GRAPH],
                   "check_method": "data.example.allow"})
    for user, src, tgt, path in EXAMPLE_CASES:
        rec(h.handle_check("authorization", {
            "subject": {"user": user},
            "action": {"path": path,
                       "properties": {"source": src, "target": tgt}}}))


def s_opa_adapter_bad_policy_fails_closed(p: Pkg, rec):
    bad = "package p\nallow = true {"
    errs = p.builder({"policies": [bad]}).validate()
    assert errs and "rego_parse_error" in errs[0]
    rec(errs)
    for cfg in ({"policies": [bad]}, {"policies": [bad],
                                      "fail_close": False}):
        rec(p.opa.OpaHandler(cfg).handle_check("authorization", {}))
    # a conflict at query time fails closed too
    h = p.handler({"policies": ["package t\nallow = x { x = input."
                                "subject.groups[_] }"],
                   "check_method": "data.t.allow"})
    rec(h.handle_check("authorization", {
        "subject": {"groups": [True, False]}}))


def s_opa_adapter_expression_mode(p: Pkg, rec):
    h = p.handler({"policies": ['subject.user == "admin"']})
    for user in ("admin", "bob"):
        rec(h.handle_check("authorization", {"subject": {"user": user}}))
    rec(p.builder({"policies": ['subject.user']}).validate())
    rec(p.builder({"policies": ['subject.user ==']}).validate())


def s_opa_rego_detection_and_method_validation(p: Pkg, rec):
    h = p.handler({"policies": ["# admins only\n" + BUCKET],
                   "check_method": "data.mixerauthz.allow"})
    rec(h.handle_check("authorization", {
        "subject": {"user": "bucket-admins"},
        "action": {"method": "storage.buckets.get"}}))
    for method in ("data.mixerauth.allow", "data.mixerauthz.alow",
                   "mixerauthz.allow"):
        errs = p.builder({"policies": [BUCKET],
                          "check_method": method}).validate()
        assert errs
        rec(errs)


SCENARIOS = {f.__name__[2:]: f for f in (
    s_bucket_admin_policy, s_example_service_graph_and_org_chart,
    s_parse_errors_reported, s_rule_semantics, s_negation_and_builtins,
    s_recursion_guard, s_complete_rule_conflict_raises,
    s_rule_memoization_is_per_query, s_opa_adapter_rego_mode,
    s_opa_adapter_example_corpus, s_opa_adapter_bad_policy_fails_closed,
    s_opa_adapter_expression_mode,
    s_opa_rego_detection_and_method_validation)}


def test_every_scenario_is_held():
    assert len(SCENARIOS) == 13


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equal_to_reference(name):
    records = []
    for root in PACKAGES:
        out: list = []
        SCENARIOS[name](Pkg(root), lambda x: out.append(typed(x)))
        records.append(out)
    want, got = records
    assert want, "the scenario recorded nothing"
    assert got == want
