"""The expression-conformance corpus: the port's own copy of the JAX
package's istio_tpu/testing/corpus.py (its CORPUS_MANIFEST, Case and
CORPUS, ANALYZER_MANIFEST and the canary corpus; the analyzer's cases are
not copied), so code that may not import the JAX package (chip_smoke.py's
atom world and canary phase) can build from it. tests/test_torch_atoms.py
and tests/test_torch_canary.py hold it equal to the original.

One shared table of cases proving the semantics contract of the policy
expression language (reference behavior defined by mixer/pkg/il/testing/
tests.go and the IL compiler/interpreter it exercises). Cases are
authored against the semantics in SURVEY.md §2.1: 3-valued presence,
`|` fallback, short-circuit booleans, typed equality (IP and TIMESTAMP
via externs), glob/regex string predicates, string-map indexing, and
exact referenced-attribute tracking.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any

from istio_tpu_torch.attribute.types import ValueType, parse_go_duration, parse_ip, parse_rfc3339

V = ValueType

# The attribute vocabulary used by every corpus case.
CORPUS_MANIFEST: dict[str, ValueType] = {
    # generic typed test attributes (reference naming style: a<type>)
    "a": V.INT64, "b": V.INT64, "d": V.INT64, "x": V.INT64, "y": V.INT64,
    "ai": V.INT64, "ai2": V.INT64,
    "ad": V.DOUBLE, "ad2": V.DOUBLE,
    "ab": V.BOOL, "ab2": V.BOOL,
    "as": V.STRING, "as2": V.STRING,
    "ar": V.STRING_MAP, "ar2": V.STRING_MAP,
    "adur": V.DURATION,
    "at": V.TIMESTAMP, "at2": V.TIMESTAMP,
    "aip": V.IP_ADDRESS, "aip2": V.IP_ADDRESS,
    # mesh-flavored attributes
    "request.user": V.STRING, "request.user2": V.STRING,
    "request.user3": V.STRING,
    "request.size": V.INT64,
    "request.path": V.STRING,
    "request.time": V.TIMESTAMP,
    "request.header": V.STRING_MAP,
    "headername": V.STRING,
    "servicename": V.STRING,
    "origin.name": V.STRING,
    "service.name": V.STRING, "service.user": V.STRING,
    "source.name": V.STRING, "source.namespace": V.STRING,
    "source.labels": V.STRING_MAP,
    "destination.service": V.STRING,
    "destination.namespace": V.STRING,
    "context.protocol": V.STRING,
    "target.ip": V.IP_ADDRESS,
    "target.service": V.STRING,
    "connection.duration": V.DURATION,
    "api.operation": V.STRING,
}


@dataclasses.dataclass
class Case:
    e: str                           # expression source
    input: dict[str, Any] = dataclasses.field(default_factory=dict)
    result: Any = None               # expected value (when err is None)
    err: str | None = None           # expected runtime-error substring
    compile_err: str | None = None   # expected parse/type-check error substring
    type_: ValueType | None = None   # expected static type
    referenced: list[str] | None = None  # expected referenced-attribute snapshot
    name: str = ""

    def id(self) -> str:
        return self.name or self.e


_t1 = parse_rfc3339("2015-01-02T15:04:35Z")
_t2 = parse_rfc3339("2015-01-02T15:04:34Z")
_d19 = parse_go_duration("19ms")
_d20 = parse_go_duration("20ms")

CORPUS: list[Case] = [
    # ---- benchmark triple: the reference's ExprBench shapes ----
    Case(name="ExprBench/ok_1st",
         e='ai == 20 || ar["foo"] == "bar"', type_=V.BOOL,
         input={"ai": 20, "ar": {"foo": "bar"}}, result=True,
         referenced=["ai"]),
    Case(name="ExprBench/ok_2nd",
         e='ai == 20 || ar["foo"] == "bar"', type_=V.BOOL,
         input={"ai": 2, "ar": {"foo": "bar"}}, result=True,
         referenced=["ai", "ar", "ar[foo]"]),
    Case(name="ExprBench/not_found",
         e='ai == 20 || ar["foo"] == "bar"', type_=V.BOOL,
         input={"ai": 2, "ar": {"foo": "baz"}}, result=False,
         referenced=["ai", "ar", "ar[foo]"]),

    # ---- literals & bare attributes ----
    Case(e="2", type_=V.INT64, result=2),
    Case(e="2.25", type_=V.DOUBLE, result=2.25),
    Case(e='"str"', type_=V.STRING, result="str"),
    Case(e="true", type_=V.BOOL, result=True),
    Case(e="false", type_=V.BOOL, result=False),
    Case(e='"20ms"', type_=V.DURATION, result=_d20),
    Case(e='"1h2m"', type_=V.DURATION,
         result=parse_go_duration("1h2m")),
    Case(e="a", type_=V.INT64, input={"a": 2}, result=2, referenced=["a"]),
    Case(e="a ", type_=V.INT64, input={"a": 2}, result=2),
    Case(e="as", type_=V.STRING, input={"as": "v"}, result="v"),
    Case(e="ab", type_=V.BOOL, input={"ab": True}, result=True),
    Case(e="ad", type_=V.DOUBLE, input={"ad": 1.5}, result=1.5),
    Case(e="a", input={}, err="lookup failed: 'a'", referenced=["a"]),

    # ---- integer equality ----
    Case(e="a == 2", type_=V.BOOL, input={"a": 2}, result=True,
         referenced=["a"]),
    Case(e="a == 3", type_=V.BOOL, input={"a": 2}, result=False),
    Case(e="a != 2", type_=V.BOOL, input={"a": 2}, result=False,
         referenced=["a"]),
    Case(e="a != 2", type_=V.BOOL, input={"d": 2},
         err="lookup failed: 'a'", referenced=["a"]),
    Case(e="2 != a", type_=V.BOOL, input={"d": 2},
         err="lookup failed: 'a'", referenced=["a"]),
    Case(e="2 == 2", type_=V.BOOL, result=True),
    Case(e="a == b", type_=V.BOOL, input={"a": 5, "b": 5}, result=True),
    Case(e="a == b", type_=V.BOOL, input={"a": 5, "b": 6}, result=False),

    # ---- double / bool / string equality ----
    Case(e="ad == 1.5", type_=V.BOOL, input={"ad": 1.5}, result=True),
    Case(e="ad != 1.5", type_=V.BOOL, input={"ad": 2.5}, result=True),
    Case(e="ab == true", type_=V.BOOL, input={"ab": True}, result=True),
    Case(e="ab == false", type_=V.BOOL, input={"ab": True}, result=False),
    Case(e='as == "v"', type_=V.BOOL, input={"as": "v"}, result=True),
    Case(e='as == "w"', type_=V.BOOL, input={"as": "v"}, result=False),
    Case(e='as == as2', type_=V.BOOL, input={"as": "x", "as2": "x"},
         result=True),
    Case(e='request.user == "user1"', type_=V.BOOL,
         input={"request.user": "user1"}, result=True),

    # ---- type-check failures ----
    Case(e="true == a", input={"a": 2},
         compile_err="typeError got INT64, expected BOOL"),
    Case(e="3.14 == a", input={"a": 2},
         compile_err="typeError got INT64, expected DOUBLE"),
    Case(e='as == 2', input={"as": "v"},
         compile_err="typeError got INT64, expected STRING"),
    Case(e="(x/y) == 30", input={"x": 20, "y": 10},
         compile_err="unknown function: QUO"),
    # ---- ordered comparisons (reference expr/func.go LT/LEQ/GT/GEQ) ----
    Case(e="x < 2", input={"x": 1}, result=True, type_=V.BOOL,
         referenced=["x"]),
    Case(e="x <= 2", input={"x": 2}, result=True),
    Case(e="x > 2", input={"x": 3}, result=True),
    Case(e="x >= 4", input={"x": 3}, result=False),
    Case(e='as < "b"', input={"as": "a"}, result=True),
    Case(e='as >= "b"', input={"as": "a"}, result=False),
    Case(e="ad > 1.5", input={"ad": 1.0}, result=False),
    Case(e="adur <= adur", input={"adur": _d19}, result=True),
    Case(e="x > 2", input={}, err="lookup failed: 'x'"),
    Case(e="ab < ab2", input={"ab": True, "ab2": False},
         err="unordered operand"),
    # ordered-comparison edges the device order keys must get right
    Case(e="ad < 0.0", input={"ad": -0.0}, result=False,
         name="neg zero lt"),
    Case(e="ad >= 0.0", input={"ad": -0.0}, result=True,
         name="neg zero geq"),
    Case(e="ad < 0.5", input={"ad": float("nan")}, result=False,
         name="nan lt"),
    Case(e="ad >= 0.5", input={"ad": float("nan")}, result=False,
         name="nan geq"),
    Case(e="x < 0", input={"x": -5}, result=True),
    Case(e="x >= 1099511627776", input={"x": 1 << 41}, result=True,
         name="big int64 cmp"),
    Case(e="ad2 > ad", input={"ad": -1.5, "ad2": 2.5}, result=True),
    Case(e="at < at2", input={"at": _t2, "at2": _t1}, result=True),
    Case(e='as2 <= as', input={"as": "b", "as2": "ab"}, result=True),
    # dynamic byte patterns (runtime prefix/suffix/glob)
    Case(e="as.startsWith(as2)", input={"as": "hello", "as2": "he"},
         result=True),
    Case(e="as.startsWith(as2)", input={"as": "hello", "as2": "lo"},
         result=False),
    Case(e="as.endsWith(as2)", input={"as": "hello", "as2": "lo"},
         result=True),
    Case(e="match(as, as2)", input={"as": "svc.prod", "as2": "svc.*"},
         result=True, name="dyn glob prefix"),
    Case(e="match(as, as2)", input={"as": "svc.prod", "as2": "*.prod"},
         result=True, name="dyn glob suffix"),
    Case(e="match(as, as2)", input={"as": "svc.prod",
                                    "as2": "svc.prod"},
         result=True, name="dyn glob exact"),
    Case(e="match(as, as2)", input={"as": "svc.prod", "as2": "*x"},
         result=False, name="dyn glob miss"),
    # runtime extern conversions (ingest-normalized on device)
    Case(e='ip(as) == ip("1.2.3.4")', input={"as": "1.2.3.4"},
         result=True, name="runtime ip eq"),
    Case(e='ip(as) == aip', input={"as": "1.2.3.4",
                                   "aip": b"\x00" * 10 + b"\xff\xff"
                                   + bytes([1, 2, 3, 4])},
         result=True, name="runtime ip vs attr"),
    Case(e='ip(as) == ip("1.2.3.5")', input={"as": "not-an-ip"},
         err="could not convert", name="runtime ip bad"),
    Case(e='timestamp(as) == at',
         input={"as": "2015-01-02T15:04:35Z", "at": _t1},
         result=True, name="runtime timestamp eq"),
    # map fallback indexing
    Case(e='(ar | ar2)["foo"]', input={"ar2": {"foo": "x"}},
         result="x", type_=V.STRING, name="map fallback second"),
    Case(e='(ar | ar2)["foo"]', input={"ar": {"foo": "a"},
                                       "ar2": {"foo": "x"}},
         result="a", name="map fallback first"),
    Case(e='(ar | ar2)["foo"] | "dflt"', input={"ar": {"bar": "y"}},
         result="dflt", name="map fallback key miss"),
    Case(e="x < ad", input={"x": 1, "ad": 2.0},
         compile_err="typeError got DOUBLE, expected INT64"),
    Case(e="!ab", input={"ab": True}, compile_err="unknown function: NOT"),
    Case(e="a = 2", input={"a": 2}, compile_err="unable to parse"),
    Case(e="@23", compile_err="unable to parse"),
    Case(e="unknown.attr == 2", compile_err="unknown attribute unknown.attr"),
    Case(e="doesnotexist(as)", input={"as": "v"},
         compile_err="unknown function: doesnotexist"),
    Case(e='match(service.name, 1)', input={"service.name": "x"},
         compile_err="typeError got INT64, expected STRING"),
    Case(e='ip(2)', compile_err="typeError got INT64, expected STRING"),
    Case(e='timestamp(2)', compile_err="typeError got INT64, expected STRING"),
    Case(e='"aaa".matches(23)', compile_err="typeError got INT64, expected STRING"),
    Case(e='"aaa".startsWith(23)', compile_err="typeError got INT64, expected STRING"),
    Case(e='match(as)', input={"as": "v"}, compile_err="arity mismatch"),
    Case(e='startsWith("x")', compile_err="invoking instance method without an instance"),

    # ---- fallback `|` ----
    Case(e='request.user | "user1"', type_=V.STRING,
         input={"request.user": "u"}, result="u",
         referenced=["request.user"]),
    Case(e='request.user | "user1"', type_=V.STRING, input={},
         result="user1", referenced=["request.user"]),
    Case(e='request.user2 | request.user | "user1"', type_=V.STRING,
         input={"request.user": "user2"}, result="user2",
         referenced=["request.user", "request.user2"]),
    Case(e='request.user2 | request.user3 | "user1"', type_=V.STRING,
         input={"request.user": "user2"}, result="user1",
         referenced=["request.user2", "request.user3"]),
    Case(e="request.size | 200", type_=V.INT64,
         input={"request.size": 120}, result=120,
         referenced=["request.size"]),
    Case(e="request.size | 200", type_=V.INT64,
         input={"request.size": 0}, result=0),
    Case(e="request.size | 200", type_=V.INT64,
         input={"request.size1": 0}, result=200),
    Case(e='( origin.name | "unknown" ) == "users"', type_=V.BOOL,
         input={}, result=False),
    Case(e='( origin.name | "unknown" ) == "users"', type_=V.BOOL,
         input={"origin.name": "users"}, result=True),
    Case(e='origin.name | "users"', type_=V.STRING, input={},
         result="users"),
    Case(e="ab | true", type_=V.BOOL, input={}, result=True),
    Case(e="ab | false", type_=V.BOOL, input={"ab": True}, result=True),
    Case(e="ad | 1.25", type_=V.DOUBLE, input={}, result=1.25),
    Case(e='adur | "19ms"', type_=V.DURATION, input={}, result=_d19),
    Case(e='adur | "19ms"', type_=V.DURATION, input={"adur": _d20},
         result=_d20),
    Case(e="ai | ai2 | 42", type_=V.INT64, input={"ai2": 7}, result=7,
         referenced=["ai", "ai2"]),
    # fallback whose right side is a hard error still errors
    Case(e='target.ip | ip("10.1.12.3")', type_=V.IP_ADDRESS, input={},
         result=parse_ip("10.1.12.3"), referenced=["target.ip"]),
    Case(e='target.ip | ip("10.1.12")', type_=V.IP_ADDRESS, input={},
         err="could not convert 10.1.12 to IP_ADDRESS"),
    Case(e='request.time | timestamp("2015-01-02T15:04:35Z")',
         type_=V.TIMESTAMP, input={}, result=_t1,
         referenced=["request.time"]),
    Case(e='request.time | timestamp("242233")', type_=V.TIMESTAMP,
         input={}, err="could not convert '242233' to TIMESTAMP"),
    # type mismatch across `|` arms
    Case(e='request.size | "big"', compile_err="typeError"),

    # ---- short-circuit && / || ----
    Case(e="(x == 20 && y == 10) || x == 30", type_=V.BOOL,
         input={"x": 20, "y": 10}, result=True),
    Case(e="x == 20 && y == 10", input={"a": 20, "b": 10},
         err="lookup failed: 'x'"),
    Case(e="x == 20 && y == 10", input={"x": 20},
         err="lookup failed: 'y'"),
    # false && <error> short-circuits: no error
    Case(e="x == 21 && y == 10", type_=V.BOOL, input={"x": 20},
         result=False, referenced=["x"]),
    # true || <error> short-circuits: no error
    Case(e="x == 20 || y == 10", type_=V.BOOL, input={"x": 20},
         result=True, referenced=["x"]),
    Case(e="x == 21 || y == 10", input={"x": 20},
         err="lookup failed: 'y'", referenced=["x", "y"]),
    Case(e="ab && ab2", type_=V.BOOL, input={"ab": True, "ab2": True},
         result=True),
    Case(e="ab && ab2", type_=V.BOOL, input={"ab": False}, result=False),
    Case(e="ab || ab2", type_=V.BOOL, input={"ab": False, "ab2": True},
         result=True),
    Case(e="true && false", type_=V.BOOL, result=False,
         name="bench/land_tf"),
    Case(e="true && true", type_=V.BOOL, result=True, name="bench/land_tt"),
    Case(e="false && false", type_=V.BOOL, result=False,
         name="bench/land_ff"),
    Case(e="ab == true && as == \"v\"", type_=V.BOOL,
         input={"ab": True, "as": "v"}, result=True),

    # ---- string maps ----
    Case(e='ar["foo"]', type_=V.STRING, input={"ar": {"foo": "bar"}},
         result="bar", referenced=["ar", "ar[foo]"]),
    Case(e='ar["foo"]', input={"ar": {"baz": "bar"}},
         err="member lookup failed: 'foo'", referenced=["ar", "ar[foo]"]),
    Case(e='ar["foo"]', input={}, err="lookup failed: 'ar'",
         referenced=["ar"]),
    Case(e='request.header["X-FORWARDED-HOST"] == "aaa"', type_=V.BOOL,
         input={"request.header": {"X-FORWARDED-HOST": "bbb"}},
         result=False,
         referenced=["request.header", "request.header[X-FORWARDED-HOST]"]),
    Case(e='request.header["X-FORWARDED-HOST"] == "aaa"',
         input={"request.header1": {"X-FORWARDED-HOST": "bbb"}},
         err="lookup failed: 'request.header'",
         referenced=["request.header"]),
    Case(e='request.header[headername] == "aaa"',
         input={"request.header": {"X-FORWARDED-HOST": "bbb"}},
         err="lookup failed: 'headername'"),
    Case(e='request.header[headername] == "aaa"', type_=V.BOOL,
         input={"request.header": {"X-FORWARDED-HOST": "aaa"},
                "headername": "X-FORWARDED-HOST"},
         result=True),
    Case(e='ar["foo"] | "dflt"', type_=V.STRING,
         input={"ar": {"foo": "bar"}}, result="bar"),
    Case(e='ar["foo"] | "dflt"', type_=V.STRING,
         input={"ar": {"baz": "bar"}}, result="dflt"),
    # map absent under fallback ALSO falls through (tresolve_m path)
    Case(e='ar["foo"] | "dflt"', type_=V.STRING, input={},
         result="dflt"),
    Case(e='ar[as] | "dflt"', type_=V.STRING,
         input={"ar": {"k": "x"}, "as": "k"}, result="x"),
    Case(e='ar[as] | "dflt"', type_=V.STRING, input={"ar": {"k": "x"}},
         result="dflt"),
    Case(e='ar["a"] == ar2["b"]', type_=V.BOOL,
         input={"ar": {"a": "same"}, "ar2": {"b": "same"}}, result=True),

    # ---- externs: match (glob) ----
    Case(e='match(service.name, "*.ns1.cluster")', type_=V.BOOL,
         input={"service.name": "svc1.ns1.cluster"}, result=True,
         referenced=["service.name"]),
    Case(e='match(service.name, "*.ns1.cluster")', type_=V.BOOL,
         input={"service.name": "svc1.ns2.cluster"}, result=False),
    Case(e='match(service.name, "svc1.*")', type_=V.BOOL,
         input={"service.name": "svc1.ns1.cluster"}, result=True),
    Case(e='match(service.name, "svc1.*")', type_=V.BOOL,
         input={"service.name": "svc2.ns1.cluster"}, result=False),
    Case(e='match(service.name, "svc1.ns1.cluster")', type_=V.BOOL,
         input={"service.name": "svc1.ns1.cluster"}, result=True),
    Case(e='match(service.name, "svc1.ns1.cluster")', type_=V.BOOL,
         input={"service.name": "svc1.ns1.clusterX"}, result=False),
    Case(e='match(service.name, servicename)', input={"servicename": "*.a"},
         err="lookup failed: 'service.name'",
         referenced=["service.name"]),
    Case(e='match(service.name, servicename)',
         input={"service.name": "x"}, err="lookup failed: 'servicename'"),
    Case(e='match(service.name, "*.ns1.cluster") && service.user == "admin"',
         type_=V.BOOL,
         input={"service.name": "svc1.ns1.cluster", "service.user": "admin"},
         result=True),

    # ---- externs: matches (regex), startsWith, endsWith ----
    # NOTE: the RECEIVER of .matches() is the PATTERN, the argument is the
    # subject (reference corpus: `".*".matches("abc")` is true; extern
    # binding pushes the target first, externs.go:118 externMatches).
    Case(e='"st.*".matches(as)', type_=V.BOOL, input={"as": "str"},
         result=True),
    Case(e='"st.*".matches(as)', type_=V.BOOL, input={"as": "ts"},
         result=False),
    Case(e='"a.c".matches("abc")', type_=V.BOOL, result=True),
    Case(e='"^b".matches("abc")', type_=V.BOOL, result=False),
    Case(e='"ab.*d".matches("abc")', type_=V.BOOL, result=False),
    Case(e='"^/api/v[0-9]+/users/[^/]+$".matches(request.path)',
         type_=V.BOOL, input={"request.path": "/api/v1/users/alice"},
         result=True),
    Case(e='"^/api/v[0-9]+/users/[^/]+$".matches(request.path)',
         type_=V.BOOL, input={"request.path": "/api/v1/users/alice/pets"},
         result=False),
    Case(e='as.startsWith("pre")', type_=V.BOOL, input={"as": "prefix"},
         result=True),
    Case(e='as.startsWith("pre")', type_=V.BOOL, input={"as": "xprefix"},
         result=False),
    Case(e='as.endsWith("fix")', type_=V.BOOL, input={"as": "prefix"},
         result=True),
    Case(e='as.endsWith("fix")', type_=V.BOOL, input={"as": "fixed"},
         result=False),
    Case(e='"abc".startsWith("ab")', type_=V.BOOL, result=True),
    Case(e='"abc".endsWith("bc")', type_=V.BOOL, result=True),
    Case(e='as.matches("st.*")', input={},
         err="lookup failed: 'as'"),

    # ---- externs: ip / timestamp equality ----
    Case(e='aip == ip("10.1.12.3")', type_=V.BOOL,
         input={"aip": parse_ip("10.1.12.3")}, result=True),
    Case(e='aip == ip("10.1.12.4")', type_=V.BOOL,
         input={"aip": parse_ip("10.1.12.3")}, result=False),
    Case(e='aip == aip2', type_=V.BOOL,
         input={"aip": parse_ip("10.1.12.3"),
                "aip2": parse_ip("10.1.12.3")}, result=True),
    Case(e='at == at2', type_=V.BOOL, input={"at": _t1, "at2": _t1},
         result=True),
    Case(e='at == at2', type_=V.BOOL, input={"at": _t1, "at2": _t2},
         result=False),
    Case(e='at != at2', type_=V.BOOL, input={"at": _t1, "at2": _t2},
         result=True),
    Case(e='at == timestamp("2015-01-02T15:04:35Z")', type_=V.BOOL,
         input={"at": _t1}, result=True),

    # ---- fallback chains & typed defaults (tests.go OR breadth) ----
    Case(e="a | b | 2", type_=V.INT64, input={"a": 7, "b": 9}, result=7),
    Case(e="a | b | 2", type_=V.INT64, input={"b": 9}, result=9),
    Case(e="a | b | 2", type_=V.INT64, input={}, result=2),
    Case(e="(a | b) | 2", type_=V.INT64, input={"b": 5}, result=5),
    Case(e="a | b", type_=V.INT64, input={},
         err="lookup failed: 'b'"),
    Case(e="ab | true", type_=V.BOOL, input={}, result=True),
    Case(e="ab | false", type_=V.BOOL, input={"ab": True}, result=True),
    Case(e="ad | 0.5", type_=V.DOUBLE, input={}, result=0.5),
    Case(e='as | as2 | "z"', type_=V.STRING, input={"as2": "y"},
         result="y"),
    Case(e='ar["k"] | ar2["k"] | "d"', type_=V.STRING,
         input={"ar": {}, "ar2": {"k": "v2"}}, result="v2"),
    Case(e='ar[as] | "d"', type_=V.STRING, input={"ar": {"k": "x"}},
         result="d", name="dynkey-absent-key-falls-back"),
    Case(e='(ab | true) && (as | "x") == "x"', type_=V.BOOL,
         input={}, result=True),
    Case(e='a | "x"', compile_err="typeError"),

    # ---- error-masking boolean semantics (short-circuit parity) ----
    Case(e="false && a == 1", type_=V.BOOL, input={}, result=False,
         name="land-short-circuit-masks-absence"),
    Case(e="a == 1 && false", input={},
         err="lookup failed: 'a'",
         name="land-left-error-raises"),
    Case(e="true || a == 1", type_=V.BOOL, input={}, result=True,
         name="lor-short-circuit-masks-absence"),
    Case(e="a == 1 || true", input={},
         err="lookup failed: 'a'",
         name="lor-left-error-raises"),
    Case(e="ab && a == 1", input={"ab": True},
         err="lookup failed: 'a'"),
    Case(e="ab && a == 1", type_=V.BOOL, input={"ab": False},
         result=False),
    Case(e="(a == 1 || b == 2) && (as == \"x\" || ab)", type_=V.BOOL,
         input={"a": 9, "b": 2, "as": "y", "ab": True}, result=True),
    Case(e="(a == 1 || b == 2) && (as == \"x\" || ab)", type_=V.BOOL,
         input={"a": 1, "b": 9, "as": "y", "ab": False}, result=False),

    # ---- map edge semantics ----
    Case(e='ar[as]', input={"ar": {"k": "v"}, "as": "missing"},
         err="member lookup failed: 'missing'"),
    Case(e='ar[""]', type_=V.STRING, input={"ar": {"": "empty-key"}},
         result="empty-key", name="empty-string-map-key"),
    Case(e='ar["k"] == ar["k"]', type_=V.BOOL, input={"ar": {"k": "v"}},
         result=True, referenced=["ar", "ar[k]"]),
    Case(e='ar["a"] == ar["b"]', input={"ar": {"a": "x"}},
         err="member lookup failed: 'b'"),

    # ---- extern runtime errors & edge patterns ----
    Case(e='ip(as)', input={"as": "not-an-ip"},
         err="could not convert not-an-ip to IP_ADDRESS"),
    Case(e='timestamp(as)', input={"as": "not-a-time"},
         err="to TIMESTAMP. expected format: RFC3339"),
    Case(e='match(as, "*")', type_=V.BOOL, input={"as": "anything"},
         result=True, name="glob-star-matches-all"),
    Case(e='match(as, "")', type_=V.BOOL, input={"as": ""},
         result=True, name="glob-empty-exact"),
    Case(e='match(as, "")', type_=V.BOOL, input={"as": "x"},
         result=False),
    Case(e='match(as, "exact")', type_=V.BOOL, input={"as": "exact"},
         result=True),
    Case(e='match(as, "ex*") && match(as2, "*ct")', type_=V.BOOL,
         input={"as": "extra", "as2": "exact"}, result=True),
    Case(e='"[".matches(as)', input={"as": "x"},
         err="bad regex"),
    Case(e='"ab.*f".matches(as)', type_=V.BOOL, input={"as": "xabcdefy"},
         result=True, name="regex-unanchored-search"),
    Case(e='"^ab$".matches(as)', type_=V.BOOL, input={"as": "xaby"},
         result=False, name="regex-anchors-honored"),
    Case(e='as.startsWith("")', type_=V.BOOL, input={"as": "x"},
         result=True),
    Case(e='as.startsWith(as)', type_=V.BOOL, input={"as": "full"},
         result=True, name="prefix-equal-to-string"),
    Case(e='as.startsWith("longer-than-value")', type_=V.BOOL,
         input={"as": "lon"}, result=False),
    Case(e='as.endsWith("")', type_=V.BOOL, input={"as": "x"},
         result=True),
    Case(e='as.endsWith(as2)', type_=V.BOOL,
         input={"as": "a.svc.cluster", "as2": ".cluster"}, result=True),

    # ---- typed equality breadth ----
    Case(e='adur == "19ms"', type_=V.BOOL, input={"adur": _d19},
         result=True),
    Case(e='adur == "20ms"', type_=V.BOOL, input={"adur": _d19},
         result=False),
    Case(e="at == at2", type_=V.BOOL, input={"at": _t1, "at2": _t1},
         result=True),
    Case(e="at != at2", type_=V.BOOL, input={"at": _t1, "at2": _t2},
         result=True),
    Case(e='aip == ip("1.2.3.4")', type_=V.BOOL,
         input={"aip": parse_ip("1.2.3.4")}, result=True),
    Case(e='aip == ip("::ffff:1.2.3.4")', type_=V.BOOL,
         input={"aip": parse_ip("1.2.3.4")}, result=True,
         name="v4-equals-v4-in-v6"),
    Case(e='timestamp("2015-01-02T15:04:35Z") == at', type_=V.BOOL,
         input={"at": _t1}, result=True),

    # ---- parsing edges ----
    Case(e="((a)) == (2)", type_=V.BOOL, input={"a": 2}, result=True),
    Case(e='as == "quote\\"inside"', type_=V.BOOL,
         input={"as": 'quote"inside'}, result=True),
    Case(e="a==2&&b==3", type_=V.BOOL, input={"a": 2, "b": 3},
         result=True, name="no-whitespace"),

    # ---- realistic mesh predicates (the resolver's diet) ----
    Case(e='destination.service == "reviews.default.svc.cluster.local"',
         type_=V.BOOL,
         input={"destination.service": "reviews.default.svc.cluster.local"},
         result=True),
    Case(e='context.protocol == "tcp" && destination.service == "db.ns.svc"',
         type_=V.BOOL,
         input={"context.protocol": "http",
                "destination.service": "db.ns.svc"},
         result=False, referenced=["context.protocol"]),
    Case(e='source.labels["app"] == "reviews" && '
           'destination.namespace == "default"',
         type_=V.BOOL,
         input={"source.labels": {"app": "reviews"},
                "destination.namespace": "default"},
         result=True),
    # `|` binds tighter than `==` (Go precedence level 4 vs 3)
    Case(e='(source.namespace | "default") == "prod" || '
           'request.header["x-debug"] | "off" == "on"',
         type_=V.BOOL, input={}, result=False),
    Case(e='request.header["x-debug"] | "off" == "on"', type_=V.BOOL,
         input={"request.header": {"x-debug": "on"}}, result=True),
    Case(e='match(destination.service, "*.svc.cluster.local") && '
           '(request.user | "nobody") != "admin"',
         type_=V.BOOL,
         input={"destination.service": "a.svc.cluster.local"},
         result=True),
    Case(e='api.operation == "getPets" && '
           'request.header["authorization"].startsWith("Bearer ")',
         type_=V.BOOL,
         input={"api.operation": "getPets",
                "request.header": {"authorization": "Bearer tok"}},
         result=True),

    # ---- glob `match` edge semantics (externs.go:108-116: suffix-star
    # checked FIRST, so "*" alone is a prefix test against "") ----
    Case(e='match(as, "*")', type_=V.BOOL, input={"as": "anything"},
         result=True, name="glob-star-alone"),
    Case(e='match(as, "*")', type_=V.BOOL, input={"as": ""},
         result=True, name="glob-star-empty-value"),
    Case(e='match(as, "")', type_=V.BOOL, input={"as": ""},
         result=True, name="glob-empty-pattern-empty-value"),
    Case(e='match(as, "")', type_=V.BOOL, input={"as": "x"},
         result=False, name="glob-empty-pattern"),
    Case(e='match(as, "*x*")', type_=V.BOOL, input={"as": "axb"},
         result=False, name="glob-middle-star-is-literal-prefix"),
    Case(e='match(as, "*x*")', type_=V.BOOL, input={"as": "*xfoo"},
         result=True, name="glob-suffix-star-wins-over-prefix-star"),
    Case(e='match(as, "a*c")', type_=V.BOOL, input={"as": "abc"},
         result=False, name="glob-inner-star-not-wild"),
    Case(e='match(as, "a*c")', type_=V.BOOL, input={"as": "a*c"},
         result=True, name="glob-inner-star-literal-eq"),
    Case(e='match(as, "ns.*")', type_=V.BOOL, input={"as": "ns."},
         result=True, name="glob-prefix-boundary"),
    Case(e='match(as, "*.cluster")', type_=V.BOOL, input={"as": ".cluster"},
         result=True, name="glob-suffix-boundary"),
    Case(e='match(as, "*.cluster")', type_=V.BOOL, input={"as": "cluster"},
         result=False, name="glob-suffix-needs-dot"),
    Case(e="match(as, as2)", input={"as": "v"},
         err="lookup failed: 'as2'", referenced=["as", "as2"],
         name="glob-dynamic-pattern-absent"),

    # ---- regex `matches` edges (Go regexp.MatchString: unanchored) --
    Case(e='"".matches(as)', type_=V.BOOL, input={"as": "anything"},
         result=True, name="regex-empty-matches-all"),
    Case(e='"^$".matches(as)', type_=V.BOOL, input={"as": ""},
         result=True, name="regex-anchored-empty"),
    Case(e='"^$".matches(as)', type_=V.BOOL, input={"as": "x"},
         result=False),
    Case(e='"c$".matches(as)', type_=V.BOOL, input={"as": "abc"},
         result=True, name="regex-dollar-anchor"),
    Case(e='"^a".matches(as)', type_=V.BOOL, input={"as": "abc"},
         result=True),
    Case(e='"b".matches(as)', type_=V.BOOL, input={"as": "abc"},
         result=True, name="regex-unanchored-mid"),
    Case(e='"[0-9]+".matches(request.path)', type_=V.BOOL,
         input={"request.path": "/v2/pets"}, result=True),
    Case(e='"^/v[0-9]$".matches(request.path)', type_=V.BOOL,
         input={"request.path": "/v2/pets"}, result=False),
    Case(e='"(a|b)c".matches(as)', type_=V.BOOL, input={"as": "zbc"},
         result=True, name="regex-alternation"),
    Case(e='"a{2}".matches(as)', type_=V.BOOL, input={"as": "caab"},
         result=True, name="regex-repetition"),

    # ---- startsWith / endsWith edges ----
    Case(e='as.startsWith("")', type_=V.BOOL, input={"as": "x"},
         result=True, name="startswith-empty-prefix"),
    Case(e='as.endsWith("")', type_=V.BOOL, input={"as": "x"},
         result=True, name="endswith-empty-suffix"),
    Case(e='as.startsWith("xy")', type_=V.BOOL, input={"as": "x"},
         result=False, name="startswith-longer-than-value"),
    Case(e='as.endsWith("xy")', type_=V.BOOL, input={"as": "y"},
         result=False, name="endswith-longer-than-value"),
    Case(e='as.startsWith(as)', type_=V.BOOL, input={"as": "self"},
         result=True, name="startswith-self"),
    Case(e='as.startsWith("pre")', input={},
         err="lookup failed: 'as'", referenced=["as"]),

    # ---- fallback chains: maps and extern args ----
    Case(e='(ar | ar2)["foo"]', type_=V.STRING,
         input={"ar": {"foo": "bar"}}, result="bar",
         name="map-fallback-first"),
    Case(e='(ar | ar2)["foo"]', type_=V.STRING,
         input={"ar2": {"foo": "baz"}}, result="baz",
         name="map-fallback-second"),
    Case(e='(ar | ar2)["foo"]', input={},
         err="lookup failed", name="map-fallback-both-absent"),
    Case(e='(ar | ar2)["foo"]', input={"ar": {"x": "y"}},
         err="lookup failed", name="map-fallback-present-key-missing"),
    Case(e='ip(as | "5.6.7.8")', type_=V.IP_ADDRESS,
         input={}, result=parse_ip("5.6.7.8"),
         name="extern-arg-fallback-const"),
    Case(e='ip(as | "5.6.7.8")', type_=V.IP_ADDRESS,
         input={"as": "1.2.3.4"}, result=parse_ip("1.2.3.4"),
         name="extern-arg-fallback-attr"),
    Case(e='ip(as | as2)', input={}, err="lookup failed",
         name="extern-arg-fallback-both-absent"),
    Case(e='ip(ar["foo"])', type_=V.IP_ADDRESS,
         input={"ar": {"foo": "9.8.7.6"}}, result=parse_ip("9.8.7.6"),
         name="extern-arg-map-index"),
    Case(e='ip(as)', input={"as": "not-an-ip"},
         err="could not convert", name="ip-convert-error"),
    Case(e='timestamp(as)', input={"as": "242233"},
         err="could not convert", name="timestamp-convert-error"),

    # ---- empty-string and unicode values ----
    Case(e='as == ""', type_=V.BOOL, input={"as": ""}, result=True),
    Case(e='as == ""', type_=V.BOOL, input={"as": "x"}, result=False),
    Case(e='as == "héllo wörld"', type_=V.BOOL,
         input={"as": "héllo wörld"}, result=True, name="unicode-eq"),
    Case(e='as.startsWith("hé")', type_=V.BOOL,
         input={"as": "héllo"}, result=True, name="unicode-prefix"),
    Case(e='ar[""]', type_=V.STRING, input={"ar": {"": "empty-key-2"}},
         result="empty-key-2", name="map-empty-key"),
    Case(e='as | ""', type_=V.STRING, input={}, result="",
         name="fallback-to-empty-string"),

    # ---- referenced-attribute tracking through operators ----
    Case(e='(as | as2 | "z") == "y"', type_=V.BOOL, input={"as2": "y"},
         result=True, referenced=["as", "as2"],
         name="referenced-fallback-stops-at-hit"),
    Case(e="a == 1 && b == 2", type_=V.BOOL, input={"a": 1, "b": 2},
         result=True, referenced=["a", "b"]),
    Case(e="a == 9 && b == 2", type_=V.BOOL, input={"a": 1, "b": 2},
         result=False, referenced=["a"],
         name="referenced-shortcircuit-skips-right"),
    Case(e='match(service.name, "*.x") || match(as, "y.*")',
         type_=V.BOOL, input={"service.name": "q.z", "as": "y.q"},
         result=True, referenced=["service.name", "as"],
         name="referenced-both-extern-args"),

    # ---- type-mismatch breadth (checker parity) ----
    Case(e="a == ad", compile_err="typeError"),
    Case(e="as == a", compile_err="typeError"),
    Case(e="at == adur", compile_err="typeError"),
    Case(e="aip == as", compile_err="typeError"),
    Case(e="ab | 2", compile_err="typeError"),
    Case(e='adur | "x"', compile_err="typeError",
         name="duration-fallback-bad-literal"),
    Case(e="ar == ar2", type_=V.BOOL,
         input={"ar": {"a": "1"}, "ar2": {"a": "1"}}, result=True,
         name="map-equality-deep"),
    Case(e="ar != ar2", type_=V.BOOL,
         input={"ar": {"a": "1"}, "ar2": {"a": "2"}}, result=True,
         name="map-inequality-deep"),
    Case(e='ar | "x"', compile_err="typeError",
         name="map-fallback-to-string-rejected"),
    Case(e="a && ab", compile_err="typeError"),
    Case(e="as && ab", compile_err="typeError"),
    Case(e='match(a, "x")', compile_err="typeError"),
    Case(e="endsWith()",
         compile_err="invoking instance method without an instance"),
    Case(e="matches()",
         compile_err="invoking instance method without an instance"),
    Case(e='"a".startsWith("b", "c")', compile_err="arity mismatch"),

    # ---- three-valued AND/OR completeness (il semantics: an error on
    # one side survives only if the other side cannot decide) ----
    Case(e="ab || a == 1", type_=V.BOOL, input={"ab": True},
         result=True, name="lor-true-masks-right-absence"),
    Case(e="ab || a == 1", input={"ab": False},
         err="lookup failed: 'a'", name="lor-false-left-raises-right"),
    Case(e="ab && ab2", input={"ab": True},
         err="lookup failed: 'ab2'", name="land-true-left-needs-right"),
    Case(e="(a == 1 || true) && (b == 2 || true)", input={},
         err="lookup failed: 'a'",
         name="nested-lor-left-error-still-raises"),
    Case(e="false || false || true", type_=V.BOOL, result=True),
    Case(e="true && true && false", type_=V.BOOL, result=False),
    Case(e="(ab || ab2) && as == \"v\"", type_=V.BOOL,
         input={"ab": True, "as": "v"}, result=True,
         name="mixed-shortcircuit-chain"),
]


# The attribute vocabulary of the analyzer and canary worlds.
ANALYZER_MANIFEST = {
    "destination.service": V.STRING,
    "source.namespace": V.STRING,
    "source.user": V.STRING,
    "request.path": V.STRING,
    "request.method": V.STRING,
    "request.host": V.STRING,
    "request.headers": V.STRING_MAP,
    "connection.mtls": V.BOOL,
}


# MemStore-ready config docs: the base (the world live traffic was
# recorded against), a SEMANTICALLY IDENTICAL rewrite (conjuncts
# reordered, store insertion order shuffled — the canary must publish
# it with zero reported divergences), and a DELIBERATELY DIVERGENT
# rewrite planting exactly one decision-flipping defect class at an
# rng-chosen victim (port of istio_tpu/testing/corpus.py:899-1070, made
# with numpy from the seed, so both packages give the same docs).
# Consumed by tests/test_torch_canary.py and chip_smoke.py's phase 15.

@dataclasses.dataclass
class CanaryPair:
    """One seeded (identical, divergent) snapshot pair."""
    kind: str                  # planted defect class (see below)
    expected: str              # divergence kind the differ must report
    base_docs: list            # [(key, spec)] — MemStore.set pairs
    identical_docs: list
    divergent_docs: list
    divergent_rule: str        # qualified rule name ("ns/name") the
    #                            report must attribute divergences to
    services: list             # victim services (traffic targets)


def _canary_world(rng, n_rules: int) -> tuple[list, list, dict]:
    """(docs, rule specs, meta) for one seeded base world: denier /
    whitelist handlers + per-service rules, every 3rd carrying the
    deny action, one rng-chosen rule the quota rule."""
    docs = [
        (("handler", "istio-system", "denyall"),
         {"adapter": "denier",
          "params": {"status_code": 7,
                     "status_message": "denied by canary world",
                     "valid_duration_s": 2.5,
                     "valid_use_count": 500}}),
        (("handler", "istio-system", "mq"),
         {"adapter": "memquota",
          "params": {"quotas": [{"name": "rq.istio-system",
                                 "max_amount": 1 << 20,
                                 "valid_duration_s": 600.0}]}}),
        (("instance", "istio-system", "rq"),
         {"template": "quota", "params": {"dimensions": {}}}),
        (("instance", "istio-system", "nothing"),
         {"template": "checknothing", "params": {}}),
    ]
    # the quota rule must not double as a deny rule: a tightened match
    # on a deny+quota rule classifies as status_flip (checked first),
    # and the quota-drop pair pins the pure quota-delta class
    quota_at = int(rng.integers(n_rules))
    while quota_at % 3 == 0:
        quota_at = int(rng.integers(n_rules))
    rules = []
    for i in range(n_rules):
        ns = f"ns{i % 5}"
        svc = f"svc{i}.{ns}.svc.cluster.local"
        conjuncts = [f'destination.service == "{svc}"',
                     f'source.namespace != "locked{int(rng.integers(7))}"']
        actions = []
        if i % 3 == 0:
            actions.append({"handler": "denyall.istio-system",
                            "instances": ["nothing.istio-system"]})
        if i == quota_at:
            actions.append({"handler": "mq.istio-system",
                            "instances": ["rq.istio-system"]})
        rules.append({"name": f"canary{i}", "namespace": ns,
                      "svc": svc, "conjuncts": conjuncts,
                      "actions": actions, "idx": i})
    meta = {"quota_at": quota_at,
            "deny_idx": [i for i in range(n_rules) if i % 3 == 0]}
    return docs, rules, meta


def _canary_rule_doc(r, conjuncts=None) -> tuple:
    return (("rule", r["namespace"], r["name"]),
            {"match": " && ".join(conjuncts or r["conjuncts"]),
             "actions": [dict(a) for a in r["actions"]]})


def make_canary_snapshot_pairs(seed: int, n_rules: int = 12
                               ) -> list[CanaryPair]:
    """Three seeded pairs, one per divergence class the differ
    classifies:

      tightened-match — a firing deny rule's match gains an extra
          conjunct excluding the recorded traffic: DENY→OK status
          flips attributed to that rule;
      ttl-change — the shared denier handler's valid_duration_s
          param changes: same statuses, precondition (TTL) divergence
          on every denied row;
      quota-drop — the quota rule's match is tightened so it stops
          activating for recorded traffic: quota-set divergence.

    Identical variants reorder each rule's conjuncts AND reverse the
    store insertion order (rule indices renumber; decisions must not).
    """
    import numpy as np

    out: list[CanaryPair] = []
    rng = np.random.default_rng(seed)

    def build():
        docs, rules, meta = _canary_world(
            np.random.default_rng(int(rng.integers(1 << 30))), n_rules)
        base = list(docs) + [_canary_rule_doc(r) for r in rules]
        ident_rules = [_canary_rule_doc(r, list(reversed(r["conjuncts"])))
                       for r in rules]
        identical = list(docs) + list(reversed(ident_rules))
        return docs, rules, meta, base, identical

    # 1. tightened-match → status_flip on an rng-chosen deny rule
    docs, rules, meta, base, identical = build()
    victim = rules[int(rng.choice(meta["deny_idx"]))]
    divergent = list(docs) + [
        _canary_rule_doc(r, r["conjuncts"] +
                         ['request.method == "DELETE"']
                         if r is victim else None)
        for r in rules]
    out.append(CanaryPair(
        kind="tightened-match", expected="status_flip",
        base_docs=base, identical_docs=identical,
        divergent_docs=divergent,
        divergent_rule=f"{victim['namespace']}/{victim['name']}",
        services=[r["svc"] for r in rules]))

    # 2. ttl-change → precondition divergence on every denied row
    docs, rules, meta, base, identical = build()
    victim = rules[meta["deny_idx"][0]]
    divergent = []
    for key, spec in base:
        if key == ("handler", "istio-system", "denyall"):
            spec = {"adapter": "denier",
                    "params": dict(spec["params"],
                                   valid_duration_s=1.25)}
        divergent.append((key, spec))
    out.append(CanaryPair(
        kind="ttl-change", expected="precondition",
        base_docs=base, identical_docs=identical,
        divergent_docs=divergent,
        divergent_rule=f"{victim['namespace']}/{victim['name']}",
        services=[r["svc"] for r in rules]))

    # 3. quota-drop → quota-set divergence on the quota rule
    docs, rules, meta, base, identical = build()
    victim = rules[meta["quota_at"]]
    divergent = list(docs) + [
        _canary_rule_doc(r, r["conjuncts"] +
                         ['request.method == "DELETE"']
                         if r is victim else None)
        for r in rules]
    out.append(CanaryPair(
        kind="quota-drop", expected="quota",
        base_docs=base, identical_docs=identical,
        divergent_docs=divergent,
        divergent_rule=f"{victim['namespace']}/{victim['name']}",
        services=[r["svc"] for r in rules]))
    return out


def make_canary_traffic(pair: CanaryPair, seed: int,
                        extra_noise: int = 8) -> list[dict]:
    """Seeded request dicts exercising every rule of a canary world
    (GET traffic per victim service — the divergent variants all key
    on method/quota activity for that traffic) plus rng noise rows
    addressed at unknown services."""
    import numpy as np

    rng = np.random.default_rng(seed)
    dicts = []
    for svc in pair.services:
        dicts.append({
            "destination.service": svc,
            "source.namespace": f"src{int(rng.integers(9))}",
            "request.method": "GET",
            "request.path": f"/api/v{int(rng.integers(3))}/items",
        })
    for _ in range(extra_noise):
        dicts.append({
            "destination.service":
                f"noise{int(rng.integers(99))}.nsX.svc.cluster.local",
            "source.namespace": "srcN",
            "request.method": "GET",
            "request.path": "/healthz",
        })
    return dicts
