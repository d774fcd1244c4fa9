"""The port's served Report() path against the JAX package's.

Report instance fields lower to the same specs and field rows
(runtime/report_lower.py); the field_eval kernel's plain versions — the
closures (field_eval_plain) and the op-table interpreter
(field_eval_ops_plain) — equal the reference's field_planes +
pack_bool_rows bit for bit, on every conformance-corpus expression and on
stores whose field programs take every op (byte predicates, ordered
compares, a subtree deeper than a left-to-right stack of 8) with no
closure beside them, and F not a multiple of 32;
FusedPlan.packed_report's pull is byte-equal; Dispatcher.report and
RuntimeServer.report deliver == instances in the same order on
tests/test_report_lower.py's stores and seeded sweep and on the
telemetry world (Istio's default Mixer telemetry config over
make_store(24), chip_smoke.telemetry_world), chunked across buckets;
report traffic leaves rule counts and quota state alone; the report
coalescer conserves records (accepted == exported + rejected), sheds a
full queue as a typed RESOURCE_EXHAUSTED and keeps records across a
config swap. The port runs on the CPU (plain versions of every kernel).
"""
import datetime
import importlib.util
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import bag_from_mapping as ref_bag
from istio_tpu.compiler import layout as ref_layout
from istio_tpu.compiler import tensor_expr as ref_te
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.parser import parse as ref_parse
from istio_tpu.runtime import MemStore as RefMemStore
from istio_tpu.runtime import RuntimeServer as RefServer
from istio_tpu.runtime import ServerArgs as RefArgs
from istio_tpu.runtime.batcher import pad_to_bucket as ref_pad
from istio_tpu.runtime.fused import pack_bool_rows as ref_pack_bool_rows
from istio_tpu.testing import workloads as ref_workloads
from istio_tpu.testing.corpus import CORPUS, CORPUS_MANIFEST, Case

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import DictBag, bag_from_mapping
from istio_tpu_torch.compiler import layout as pt_layout
from istio_tpu_torch.compiler import tensor_expr as pt_te
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.ops import field_ops
from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
from istio_tpu_torch.runtime import monitor
from istio_tpu_torch.compiler.op_lower import lower_programs
from istio_tpu_torch.runtime.resilience import ResourceExhaustedError
from istio_tpu_torch.testing import workloads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ROOT = pathlib.Path(__file__).resolve().parent.parent
REF_ARGS = dict(initial_prewarm=False, audit=False, rulestats_drain_s=0)
PORT_ARGS = dict(initial_prewarm=False, rulestats_drain_s=0)
T0 = datetime.datetime(2018, 3, 1, 12, 0, 0, tzinfo=datetime.timezone.utc)


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REPORT_LOWER = _load(ROOT / "tests" / "test_report_lower.py",
                     "_report_lower_world")
SMOKE = _load(ROOT / "chip_smoke.py", "_chip_smoke")


class Capture:
    """Stands in for a built adapter: records (template, instances)."""

    def __init__(self) -> None:
        self.calls: list = []

    def handle_report(self, template, instances) -> None:
        self.calls.append((template, [dict(i) for i in instances]))

    def flat(self) -> list:
        return [i for _, insts in self.calls for i in insts]


def _leaf_store():
    """A metric whose dimensions take every op of the field programs:
    byte predicates (startsWith, a suffix glob, a regex, a
    runtime-pattern prefix), an ordered compare, a right-nested `|`
    chain deeper than a left-to-right stack of 8, map fallback selects, extern
    ip() / timestamp() columns, LAND / LOR / EQ / NEQ; and an instance
    whose only field is an invalid ip() constant (always an error)."""
    s = RefMemStore()
    s.set(("handler", "istio-system", "sink"), {"adapter": "noop",
                                                "params": {}})
    chain = " | (".join(["source.user", "destination.user", "request.host",
                         "request.method", "request.path", "request.scheme",
                         "source.name", "destination.name",
                         "source.namespace", "request.id"]) + \
        ' | "zz"' + ")" * 9
    s.set(("instance", "istio-system", "lf"), {
        "template": "metric", "params": {
            "value": "request.size | 0",
            "dimensions": {
                "api": 'request.path.startsWith("/api")',
                "local": 'match(request.host, "*.local")',
                "rx": '"^/api/v[0-9]+/".matches(request.path)',
                "dyn": "request.path.startsWith(request.host)",
                "big": "request.size > 100",
                "chain": chain,
                "same": "source.user == destination.user",
                "hdr": '(request.headers | response.headers)["host"]',
                "hdr2": 'request.headers["host"] | "none"',
                "xip": 'ip(request.headers["x-ip"])',
                "xts": 'timestamp(request.headers["ts"])',
                "sip": 'source.ip | ip("10.0.0.1")',
                "land": 'connection.mtls && request.method == "GET"',
                "lor": "connection.mtls || request.size == 7",
                "neq": 'request.method != "GET"',
                "mtls": "connection.mtls | false"},
            "monitored_resource_type": '"UNSPECIFIED"'}})
    s.set(("instance", "istio-system", "bad"), {
        "template": "metric", "params": {"value": 'ip("not-an-ip")'}})
    s.set(("rule", "istio-system", "all"), {
        "match": "",
        "actions": [{"handler": "sink", "instances": ["lf", "bad"]}]})
    return s


def _leaf_dicts(n: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    out = []
    for j in range(n):
        d = {}
        for attr, vals in (
                ("request.path", ["/api/v1/x", "/apx", "svc.local/x", "",
                                  "/api/" + "y" * 140]),
                ("request.host", ["svc.local", "a.b", "/api", "h" * 130]),
                ("request.size", [7, 99, 100, 101, 5000]),
                ("request.method", ["GET", "POST"]),
                ("source.user", ["alice", "bob"]),
                ("destination.user", ["alice", "carol"]),
                ("request.scheme", ["http", "https"]),
                ("connection.mtls", [True, False]),
                ("source.ip", [bytes([10, 1, 2, 3]), bytes([9, 9, 9, 9])]),
                ("request.headers", [{"host": "h1", "x-ip": "10.0.0.9",
                                      "ts": "2018-03-01T12:00:00Z"},
                                     {"x-ip": "bad", "ts": "never"}, {}]),
                ("response.headers", [{"host": "h2"}, {}])):
            if j % 4 == 1:
                d[attr] = vals[0]          # every field valid: lf lands
            elif rng.random() < 0.75:
                d[attr] = pick(vals)
        if j % 5 == 0:
            d = {}
        out.append(d)
    return out


def _report_lower_dicts(seed: int) -> list[dict]:
    """test_report_lower's seeded sweep (test_seeded_instance_parity_
    property): every 3rd record without response.size."""
    dicts = workloads.make_request_dicts(12, seed=seed)
    for j, d in enumerate(dicts):
        if j % 3:
            d["response.size"] = 100 + j
        d["response.code"] = 200 if j % 2 else 404
        d["request.time"] = T0
        d["response.duration"] = datetime.timedelta(milliseconds=j)
        d["request.headers"] = {"path": f"/p{j}",
                                **({"host": f"h{j}.com"} if j % 2 else {})}
    return dicts


def _telemetry_store():
    s = ref_workloads.make_store(24)
    SMOKE.telemetry_world(s)
    return s


# store factory, traffic, report handlers
WORLDS = {
    "report_lower": (REPORT_LOWER._store,
                     lambda: [dict(b._values) for b in REPORT_LOWER._bags()]
                     + _report_lower_dicts(5) + _report_lower_dicts(11),
                     ("sink.istio-system",)),
    "zero_map": (REPORT_LOWER._zero_map_store,
                 lambda: [{"destination.service": "a.default.svc",
                           "response.size": 7}, {}],
                 ("sink.istio-system",)),
    "leaves": (_leaf_store, lambda: _leaf_dicts(37, seed=3),
               ("sink.istio-system",)),
    "telemetry": (_telemetry_store, lambda: SMOKE.telemetry_dicts(45, 7),
                  ("handler.istio-system", "sink.istio-system")),
}


def _pair(world: str, **args):
    """(reference server, port server) over one store, CPU."""
    ref_store = WORLDS[world][0]()
    port_store = interop.store_from_reference(ref_store)
    ref = RefServer(ref_store, RefArgs(**REF_ARGS, **args))
    port = RuntimeServer(port_store, ServerArgs(**PORT_ARGS, **args),
                         device="cpu")
    return ref, port, (ref, port, ref_store, port_store)


def _close(objs) -> None:
    for x in objs:
        x.close()


@pytest.fixture(scope="module")
def pairs():
    made: dict = {}

    def get(world: str):
        if world not in made:
            made[world] = _pair(world, buckets=(8, 16))
        return made[world]
    yield get
    for _, _, objs in made.values():
        _close(objs)


def _spec_view(rl) -> tuple:
    return ({k: (s.name, tuple((f.path, f.row, f.is_bool) for f in s.fields),
                 s.consts, s.containers) for k, s in rl.specs.items()},
            set(rl.host_instances), rl.n_fields, rl.n_valid_words)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_lowering_equal(pairs, world):
    ref, port, _ = pairs(world)
    want = ref.controller.dispatcher.fused.report_lowering
    got = port.controller.dispatcher.fused.report_lowering
    assert _spec_view(got) == _spec_view(want)
    prog = got.program.prog
    assert len(prog.starts) == got.n_fields + 1
    # need-first operand order: a program of n op rows needs at most
    # floor(log2(n + 1)) stack slots
    sizes = np.diff(prog.starts)
    assert prog.need <= int(np.log2(sizes.max() + 1))
    if world == "telemetry":
        assert (got.n_fields, len(got.specs)) == (60, 8)
    if world == "leaves":
        ops = {int(o) for o in prog.ops[:, 0]}
        assert ops == set(range(len(field_ops.OP_NAMES))), \
            sorted(field_ops.OP_NAMES[o] for o in ops)
        assert got.n_fields % 32 and prog.need == 2


def _batches(ref, world: str, n: int | None = None):
    dicts = WORLDS[world][1]()[:n]
    d = ref.controller.dispatcher
    ref_batch, ns = d._tensorize_for_device([ref_bag(x) for x in dicts])
    return ref_batch, ns, interop.batch_from_reference(ref_batch, "cpu")


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_field_rows_equal_reference(pairs, world):
    """field_eval (CPU: the closures), field_eval_plain and the op-table
    interpreter equal the reference's field_planes + pack_bool_rows."""
    ref, port, _ = pairs(world)
    ref_batch, _, batch = _batches(ref, world)
    rl = ref.controller.dispatcher.fused.report_lowering
    vals, valid = rl.field_planes(ref_batch)
    b, n_f, n_w = batch.ids.shape[0], rl.n_fields, rl.n_valid_words
    vpad = np.zeros((b, n_w * 32), bool)
    vpad[:, :n_f] = np.asarray(valid).T
    want = np.concatenate([np.asarray(vals),
                           np.asarray(ref_pack_bool_rows(vpad, n_w))])
    prog = port.controller.dispatcher.fused.report_lowering.program
    for fn in (field_ops.field_eval, field_ops.field_eval_plain,
               field_ops.field_eval_ops_plain):
        np.testing.assert_array_equal(fn(batch, prog).numpy(), want,
                                      err_msg=fn.__name__)
    if world == "leaves":
        assert (want[:n_f] < 0).any()   # ephemeral ids in value rows
    out = torch.full((n_f + n_w, b), 7, dtype=torch.int32)
    assert field_ops.field_eval(batch, prog, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_packed_report_pull_byte_equal(pairs, world):
    ref, port, _ = pairs(world)
    dicts = WORLDS[world][1]()[:16]
    padded = ref_pad([ref_bag(x) for x in dicts], (16,))
    ref_batch, ns = ref.controller.dispatcher._tensorize_for_device(padded)
    want = ref.controller.dispatcher.fused.packed_report(ref_batch, ns)
    got = port.controller.dispatcher.fused.packed_report(
        interop.batch_from_reference(ref_batch, "cpu"), ns)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _served_instances(srv, world: str, dicts, make_bag, via: str):
    caps = {h: Capture() for h in WORLDS[world][2]}
    d = srv.controller.dispatcher
    saved = {h: d.handlers.get(h) for h in caps}
    d.handlers.update(caps)
    try:
        bags = [make_bag(x) for x in dicts]
        if via == "dispatcher":
            d.report(bags)
        else:
            srv.report(bags)
    finally:
        d.handlers.update(saved)
    return {h: c.calls for h, c in caps.items()}


@pytest.mark.parametrize("via", ["dispatcher", "server"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_report_instances_equal(world, via):
    """== instances, in the same order, on both packages; records chunk
    across the buckets (4, 8) and the report coalescer runs one batch at
    a time (pipeline=1) so the order is defined."""
    ref, port, objs = _pair(world, buckets=(4, 8), max_batch=8, pipeline=1)
    try:
        dicts = WORLDS[world][1]()
        want = _served_instances(ref, world, dicts, ref_bag, via)
        got = _served_instances(port, world, dicts, bag_from_mapping, via)
        assert got == want
        n = sum(len(insts) for calls in got.values() for _, insts in calls)
        assert n > 0
    finally:
        _close(objs)


def test_absent_value_aborts_instance():
    """test_report_lower's bag 2 has no response.size: the metric is
    absent from the adapter call, counted as a dispatch error, while the
    same rule's logentry still lands."""
    _, port, objs = _pair("report_lower", buckets=(4,), max_batch=4)
    try:
        errs = monitor.DISPATCH_ERRORS.value()
        got = _served_instances(port, "report_lower",
                                WORLDS["report_lower"][1]()[:4],
                                bag_from_mapping, "dispatcher")
        flat = [i for _, insts in got["sink.istio-system"] for i in insts]
        names = [i["name"] for i in flat]
        assert names.count("m.istio-system") == 4
        assert not [i for i in flat
                    if i.get("dimensions", {}).get("svc") == "c.default.svc"]
        assert monitor.DISPATCH_ERRORS.value() - errs >= 1
    finally:
        _close(objs)


@pytest.mark.parametrize("world", ["report_lower", "telemetry"])
def test_inline_report_equal_and_conserved(world):
    """report_batching=False: records dispatch inline in the caller's
    thread, chunked across the buckets (4, 8). The instances equal the
    reference's, in order; both ledgers count every record accepted and
    exported with no future returned; a dispatch failure rejects the
    whole call as "error" and re-raises."""
    from istio_tpu.runtime import monitor as ref_monitor
    ref, port, objs = _pair(world, buckets=(4, 8), max_batch=8,
                            report_batching=False)
    try:
        assert port._report_batcher is None
        dicts = WORLDS[world][1]()
        bases = (ref_monitor.report_conservation(),
                 monitor.report_conservation())
        want = _served_instances(ref, world, dicts, ref_bag, "server")
        got = _served_instances(port, world, dicts, bag_from_mapping,
                                "server")
        assert got == want
        assert sum(len(i) for c in got.values() for _, i in c) > 0
        assert port.submit_report([]) == []
        ref_cons, cons = (m.report_conservation(since=b) for m, b in
                          zip((ref_monitor, monitor), bases))
        assert cons == ref_cons
        assert (cons["accepted"], cons["exported"], cons["rejected_total"],
                cons["in_flight"]) == (len(dicts), len(dicts), 0, 0)
        assert cons["exact"]

        def fail(bags):
            raise RuntimeError("dispatch failed")

        port.controller.dispatcher.report = fail
        base = monitor.report_conservation()
        with pytest.raises(RuntimeError, match="dispatch failed"):
            port.report([bag_from_mapping(x) for x in dicts[:3]])
        cons = monitor.report_conservation(since=base)
        assert (cons["accepted"], cons["exported"],
                cons["rejected"]["error"]) == (3, 0, 3)
        assert cons["exact"]
    finally:
        _close(objs)


def _rule_counts(srv) -> dict:
    srv.rulestats.drain()
    return srv.rulestats.counts()


def test_report_leaves_rule_counts_and_quota_alone():
    _, port, objs = _pair("telemetry", buckets=(8, 16))
    try:
        port.check_many([bag_from_mapping(x)
                         for x in SMOKE.telemetry_dicts(10, 2)])
        before = _rule_counts(port)
        plan = port.controller.dispatcher.fused
        quota = plan.engine.quota_counts.clone()
        port.report([bag_from_mapping(x)
                     for x in SMOKE.telemetry_dicts(30, 3)])
        assert _rule_counts(port) == before
        assert torch.equal(plan.engine.quota_counts, quota)
        assert all(int(t.sum()) == 0 for t in plan.telemetry.state())
    finally:
        _close(objs)


# ---------------------------------------------------------------------------
# the op-table interpreter on the conformance corpus
# ---------------------------------------------------------------------------

RUNNABLE = [c for c in CORPUS if c.compile_err is None]
INPUTS = [c.input for c in RUNNABLE]
REF_FINDER = RefFinder(CORPUS_MANIFEST)
PT_MANIFEST = interop.manifest_from_reference(CORPUS_MANIFEST)
PT_FINDER = AttributeDescriptorFinder(PT_MANIFEST)


def _layout_args(reqs):
    return (sorted(reqs.derived_keys), sorted(reqs.byte_sources, key=str),
            [(n, k, ast) for (n, k), ast in reqs.extern_sources.items()])


def _ref_rows(text: str) -> np.ndarray:
    """The reference's compile_field node over every corpus input, as
    the field rows it packs: [value row, valid word]."""
    from istio_tpu.attribute.bag import DictBag as RefDictBag
    ast = ref_parse(text)
    dk, bs, ex = _layout_args(ref_te.collect_requirements(ast, REF_FINDER))
    lay = ref_layout.build_layout(CORPUS_MANIFEST, dk, bs, extern_sources=ex)
    interner = ref_layout.InternTable()
    node, _ = ref_te.compile_field(ast, REF_FINDER, lay, interner)
    t = node(ref_layout.Tensorizer(lay, interner).tensorize(
        [RefDictBag(d) for d in INPUTS]))
    vpad = np.zeros((len(INPUTS), 32), bool)
    vpad[:, 0] = np.asarray(t.ok & ~t.err)
    return np.concatenate([np.asarray(t.val).astype(np.int32)[None],
                           np.asarray(ref_pack_bool_rows(vpad, 1))])


def _port_program(text: str):
    """(one-field FieldProgram, batch of every corpus input)."""
    ast = parse(text)
    dk, bs, ex = _layout_args(pt_te.collect_requirements(ast, PT_FINDER))
    lay = pt_layout.build_layout(PT_MANIFEST, dk, bs, extern_sources=ex)
    interner = pt_layout.InternTable()
    node, _ = pt_te.compile_field(ast, PT_FINDER, lay, interner)
    prog = field_ops.FieldProgram(
        fns=[node], prog=lower_programs([ast], lay, interner, PT_FINDER))
    batch = pt_layout.Tensorizer(lay, interner).tensorize(
        [DictBag(d) for d in INPUTS])
    return prog, batch


@pytest.mark.parametrize("case", RUNNABLE, ids=lambda c: c.id())
def test_corpus_field_program_equals_reference(case: Case):
    """Every corpus expression as one report field: the op table
    interpreted (field_eval_ops_plain) and the closure (field_eval_plain)
    equal the reference's compile_field node — the value on every cell,
    invalid ones included, and the valid bits — over every corpus
    input; host-fallback decisions agree."""
    try:
        want = _ref_rows(case.e)
    except ref_te.HostFallback:
        with pytest.raises(pt_te.HostFallback):
            _port_program(case.e)
        return
    prog, batch = _port_program(case.e)
    for fn in (field_ops.field_eval_ops_plain, field_ops.field_eval_plain):
        np.testing.assert_array_equal(fn(batch, prog).numpy(), want,
                                      err_msg=fn.__name__)


# ---------------------------------------------------------------------------
# the report coalescer: conservation, typed overflow, config swaps
# ---------------------------------------------------------------------------

class Sink:
    """Counts records; optionally blocks (wedging the coalescer)."""

    def __init__(self, block: threading.Event | None = None):
        self.block = block
        self.records = 0
        self._lock = threading.Lock()

    def handle_report(self, template, instances) -> None:
        if self.block is not None:
            self.block.wait(timeout=30)
        with self._lock:
            self.records += len(instances)


def _mesh_server(store=None, **kw) -> RuntimeServer:
    args = dict(batch_window_s=0.0005, max_batch=8, buckets=(4, 8),
                default_manifest=workloads.MESH_MANIFEST,
                rulestats_drain_s=0)
    args.update(kw)
    return RuntimeServer(store or workloads.make_store(8), ServerArgs(**args),
                         device="cpu")


def _sink(srv, block=None) -> Sink:
    h = Sink(block=block)
    srv.controller.dispatcher.handlers["prom.istio-system"] = h
    return h


def _drain_cons(base: dict, deadline_s: float = 20.0) -> dict:
    end = time.time() + deadline_s
    cons = monitor.report_conservation(since=base)
    while time.time() < end and cons["in_flight"]:
        time.sleep(0.01)
        cons = monitor.report_conservation(since=base)
    return cons


def _bags(n: int, seed: int = 2):
    return [bag_from_mapping(d)
            for d in workloads.make_request_dicts(n, seed=seed)]


def test_conservation_exact_through_coalescer():
    srv = _mesh_server()
    try:
        sink = _sink(srv)
        base = monitor.report_conservation()
        futs = srv.submit_report(_bags(20))
        assert len(futs) == 20
        cons = _drain_cons(base)
        assert (cons["accepted"], cons["exported"],
                cons["rejected_total"]) == (20, 20, 0)
        assert cons["exact"] and cons["in_flight"] == 0
        assert sink.records == 20
        assert monitor.REPORT_STAGE_SECONDS.sum("coalesce_wait") > 0
    finally:
        srv.close()


def test_ack_after_enqueue_is_nonblocking():
    block = threading.Event()
    srv = _mesh_server()
    try:
        sink = _sink(srv, block=block)
        base = monitor.report_conservation()
        t0 = time.perf_counter()
        futs = srv.submit_report(_bags(4))
        assert time.perf_counter() - t0 < 1.0
        assert not any(f.done() for f in futs)
        block.set()
        cons = _drain_cons(base)
        assert cons["exported"] == 4 and cons["exact"]
        assert sink.records == 4
    finally:
        block.set()
        srv.close()


def test_overflow_sheds_typed_resource_exhausted():
    block = threading.Event()
    srv = _mesh_server(report_queue_cap=3, pipeline=1, max_batch=4,
                       buckets=(4,))
    try:
        sink = _sink(srv, block=block)
        base = monitor.report_conservation()
        shed = None
        for _ in range(40):
            futs = srv.submit_report(_bags(2))
            shed = next((f.exception() for f in futs
                         if f.done() and f.exception()), None)
            if shed is not None:
                break
            time.sleep(0.01)
        assert isinstance(shed, ResourceExhaustedError), shed
        block.set()
        cons = _drain_cons(base)
        assert cons["exact"] and cons["in_flight"] == 0
        assert cons["rejected"]["queue_full"] > 0
        assert cons["accepted"] == cons["exported"] + cons["rejected_total"]
        assert sink.records == cons["exported"]
    finally:
        block.set()
        srv.close()


def test_records_kept_across_config_swap():
    store = workloads.make_store(8)
    srv = _mesh_server(store)
    try:
        _sink(srv)
        rev0 = srv.controller.dispatcher.snapshot.revision
        base = monitor.report_conservation()
        bags = _bags(24)
        futs = srv.submit_report(bags[:8])
        store.set(("rule", "istio-system", "swap-marker"), {
            "match": 'request.method == "PATCH"',
            "actions": [{"handler": "denyall", "instances": ["nothing"]}]})
        futs += srv.submit_report(bags[8:16])
        deadline = time.time() + 20
        while time.time() < deadline and \
                srv.controller.dispatcher.snapshot.revision == rev0:
            time.sleep(0.02)
        assert srv.controller.dispatcher.snapshot.revision != rev0
        futs += srv.submit_report(bags[16:])
        cons = _drain_cons(base)
        assert (cons["accepted"], cons["exported"]) == (24, 24), cons
        assert cons["exact"] and all(f.done() for f in futs)
        assert all(f.exception() is None for f in futs)
    finally:
        srv.close()
        store.close()
