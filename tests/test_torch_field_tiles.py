"""The launch plan of the op-program interpreter (csrc/field_eval.cu:
field_eval and atom_eval) and its plain versions at the plan's seams,
on the CPU.

  * field_ops.launch_plan: the stack class follows the programs' need
    (need <= SHALLOW the register-stack kernels, deeper ones the general
    kernels); the block loop the kernels run over the plan (a model of
    it here: tiles of 32 records, groups of programs, warps taking every
    WARPS-th program of a group) covers every (record, program) pair
    exactly once, and field_eval's valid words once per record, at
    record counts either side of a tile and of 2,048, atom counts
    either side of a group and the served worlds' 13 and 306, field
    counts either side of a valid word, for the served plan and every
    plan scripts/torch_fe_variants.py launches; atom groups shrink for
    launches of few atoms; the literal tile is bank-conflict free;
  * field_eval and atom_eval on CPU planes (their closures) and the
    op-table interpreter equal the JAX package's closures at those
    seams: atoms written at scattered columns of wider ext planes that
    keep a seeded pattern everywhere else, fields written into rows of
    a larger buffer;
  * the port's logging configures its own logger namespace and leaves
    the JAX package's "istio_tpu" logger as it was.
Every value is an int or a bool: the tolerance is exact equality."""
import importlib.util
import logging
import pathlib

import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.attribute.global_dict import GLOBAL_MANIFEST as REF_GLOBAL
from istio_tpu.attribute.types import ValueType as RefV
from istio_tpu.compiler import layout as ref_layout
from istio_tpu.compiler import tensor_expr as ref_te
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.parser import parse as ref_parse
from istio_tpu.runtime.fused import pack_bool_rows as ref_pack_bool_rows

from istio_tpu_torch import interop
from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.compiler import layout as pt_layout
from istio_tpu_torch.compiler import op_lower
from istio_tpu_torch.compiler import tensor_expr as pt_te
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.ops import field_ops as fo
from istio_tpu_torch.utils import log as pt_log


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load(ROOT / "chip_smoke.py", "_chip_smoke_tiles")
SEAM_B = SMOKE.SEAM_B
SEAM_A = SMOKE.SEAM_A
SEAM_F = SMOKE.SEAM_F
# the served plan ({}) and the plans the variants script times
PLANS = tuple(_load(ROOT / "scripts" / "torch_fe_variants.py",
                    "_fe_variants_tiles").PLAN_VARIANTS.values())


def _synthetic(n: int, seed: int, need: int = 2) -> fo.OpProgram:
    """n programs of 1-7 op rows each (only the row counts and `need`
    matter to the plan)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 8, n)
    starts = np.zeros(n + 1, np.int32)
    starts[1:] = np.cumsum(lens)
    return fo.OpProgram(ops=np.zeros((int(starts[-1]), fo.OP_WIDTH),
                                     np.int32),
                        starts=starts, consts=np.zeros((1, 128), np.uint8),
                        dfa=None, max_len=128, need=need)


def _covered(entry: str, b: int, plan: fo.LaunchPlan, n: int):
    """The kernels' block loop over `plan`, modelled: → (times each
    (record, program) pair ran [b, n], times each record's valid word w
    was written [b, groups] (field_eval), programs per thread at most)."""
    pairs = np.zeros((b, n), np.int64)
    words = np.zeros((b, plan.groups), np.int64)
    most = 0
    gx, gy = plan.grid
    for x in range(gx):
        rec = slice(x * fo.TILE, min(x * fo.TILE + fo.TILE, b))
        for y in range(gy):
            for g in range(y, plan.groups, gy):
                p0 = g * plan.group
                np_ = min(plan.group, n - p0)
                for warp in range(plan.warps):
                    js = range(warp, np_, plan.warps)
                    most = max(most, len(js))
                    for j in js:
                        pairs[rec, p0 + j] += 1
                if entry == "field_eval":
                    words[rec, g] += 1
    return pairs, words, most


@pytest.mark.parametrize("kw", PLANS, ids=str)
@pytest.mark.parametrize("n", SEAM_A)
@pytest.mark.parametrize("b", SEAM_B)
def test_atom_plan_covers_every_pair_once(b, n, kw):
    prog = _synthetic(n, seed=n)
    plan = fo.launch_plan("atom_eval", b, prog, **kw)
    warps = kw.get("warps", fo.WARPS)
    top = kw.get("atom_group", fo.ATOM_GROUP)
    fill = kw.get("fill_blocks", fo.FILL_BLOCKS)
    least = kw.get("min_group", fo.MIN_GROUP)
    assert plan.tiles == -(-b // 32)
    assert plan.groups == -(-n // plan.group)
    assert 1 <= plan.group <= top
    assert plan.warps == min(warps, plan.group)
    # the first of the top group, halved in turn down to the least
    # group, that gives fill blocks, or the last
    halvings = [top]
    while halvings[-1] > least:
        halvings.append(halvings[-1] // 2)
    k = halvings.index(plan.group)
    assert all(plan.tiles * -(-n // g) < fill for g in halvings[:k])
    assert plan.group == halvings[-1] or plan.tiles * plan.groups >= fill
    pairs, _, most = _covered("atom_eval", b, plan, n)
    assert (pairs == 1).all()
    assert most <= -(-plan.group // plan.warps)


@pytest.mark.parametrize("kw", PLANS, ids=str)
@pytest.mark.parametrize("n", SEAM_F)
@pytest.mark.parametrize("b", SEAM_B)
def test_field_plan_covers_every_pair_and_word_once(b, n, kw):
    prog = _synthetic(n, seed=n)
    plan = fo.launch_plan("field_eval", b, prog, **kw)
    warps = kw.get("warps", fo.WARPS)
    assert plan.group == 32 and plan.groups == -(-n // 32)
    assert plan.warps == warps
    pairs, words, most = _covered("field_eval", b, plan, n)
    assert (pairs == 1).all() and (words == 1).all()
    assert most <= -(-32 // warps)


def test_served_sizes_fill_the_card():
    """At B = 2,048 the report trip (F = 60) runs 128 blocks of 8 warps,
    at most 4 fields a thread (the first port: 32 blocks, up to 32 a
    thread); the authz world's 306 atoms 640 blocks, at most 4 atoms a
    thread (the first port: one thread a program, 4,896 blocks); the
    route world's 13 atoms 128 blocks of 8 atoms (8 warps), one a
    thread; at B = 64 the authz atoms take groups of 8 (78 blocks), not
    smaller."""
    fp = fo.launch_plan("field_eval", 2048, _synthetic(60, 1))
    assert fp.grid == (64, 2) and fp.warps == 8
    ap = fo.launch_plan("atom_eval", 2048, _synthetic(306, 2, need=3))
    assert ap.grid == (64, 10) and not ap.deep
    assert _covered("atom_eval", 2048, ap, 306)[2] == 4
    rp = fo.launch_plan("atom_eval", 2048, _synthetic(13, 3))
    assert rp.grid == (64, 2) and rp.group == 8 and rp.warps == 8
    assert _covered("atom_eval", 2048, rp, 13)[2] == 1
    sp = fo.launch_plan("atom_eval", 64, _synthetic(306, 2, need=3))
    assert sp.grid == (2, 39) and sp.group == 8 and sp.warps == 8


@pytest.mark.parametrize("need,deep", [(1, 0), (2, 0), (3, 0), (4, 0),
                                       (5, 1), (6, 1), (32, 1)])
def test_stack_class_follows_need(need, deep):
    for entry in ("field_eval", "atom_eval"):
        plan = fo.launch_plan(entry, 100, _synthetic(5, 3, need))
        assert plan.deep == deep


def _balanced_program(k: int) -> fo.OpProgram:
    """The op program of a balanced tree of k EQ leaves over
    GLOBAL_MANIFEST (chip_smoke.balanced)."""
    manifest = interop.manifest_from_reference(REF_GLOBAL)
    finder = AttributeDescriptorFinder(manifest)
    ast = parse(SMOKE.balanced([f"request.size == {i}" for i in range(k)]))
    reqs = pt_te.Requirements()
    pt_te.collect_requirements(ast, finder, reqs)
    lay = pt_layout.build_layout(manifest, sorted(reqs.derived_keys),
                                 sorted(reqs.byte_sources, key=str))
    return op_lower.lower_programs([ast], lay, pt_layout.InternTable(),
                                   finder)


@pytest.mark.parametrize("leaves,need", [(1, 2), (2, 3), (4, 4), (8, 5),
                                         (16, 6)])
def test_lowered_need_picks_the_instantiation(leaves, need):
    """Balanced trees of 2^k EQ leaves need k + 2 slots (the seams'
    programs), and need 5 is the first to take the general kernels; the
    chip-smoke helper that measures a program's need agrees."""
    prog = _balanced_program(leaves)
    assert prog.need == need == SMOKE.stack_need(prog.ops)
    plan = fo.launch_plan("atom_eval", 64, prog)
    assert plan.deep == int(need > fo.SHALLOW)


@pytest.mark.parametrize("n", (1, 13, 32, 306))
@pytest.mark.parametrize("entry", ["field_eval", "atom_eval"])
def test_shared_layout(entry, n):
    """Shared memory holds field_eval's 32 valid masks, or atom_eval's
    literal tile at an odd word stride (lanes writing one atom of 32
    records hit 32 banks), under the 48 KB a block gets without opting
    in (the kernels do not opt in)."""
    plan = fo.launch_plan(entry, 2048, _synthetic(n, 4))
    assert (plan.s_res // 4) % 2 == 1 and plan.s_res >= plan.group
    assert len(set(np.arange(32) * plan.s_res // 4 % 32)) == 32
    aux = 4 * 32 if entry == "field_eval" else 32 * plan.s_res
    assert plan.smem == aux <= 48 * 1024


@pytest.mark.parametrize("kw", [dict(warps=9), dict(warps=0),
                                dict(atom_group=33), dict(atom_group=0),
                                dict(min_group=0)],
                         ids=str)
def test_bad_plans_refused(kw):
    with pytest.raises(ValueError, match="warps"):
        fo.launch_plan("atom_eval", 64, _synthetic(3, 6), **kw)


def test_plan_argument_is_the_served_plan():
    """The C entry points' plan argument is the default launch_plan in
    PLAN_FIELDS order, worked out at each launch: nothing is stored on
    the program, whatever batch sizes it meets."""
    prog = _synthetic(40, 7)
    before = dict(prog._dev)
    for b in (70, 71, 2048):
        got = fo._plan_arg("atom_eval", b, prog)
        assert tuple(got) == fo.launch_plan("atom_eval", b, prog).fields()
        assert len(got) == len(fo.PLAN_FIELDS)
    assert prog._dev == before


def test_plan_fields_match_the_kernel_source():
    """PLAN_FIELDS is the PlanField enum of csrc/field_eval.cu, in order."""
    src = (ROOT / "istio_tpu_torch" / "csrc" / "field_eval.cu").read_text()
    body = src[src.index("enum PlanField"):]
    body = body[body.index("{") + 1:body.index("}")]
    names = [t.strip().split("=")[0].strip() for t in body.split(",")]
    want = ["k" + "".join(p.capitalize() for p in f.split("_"))
            for f in fo.PLAN_FIELDS] + ["kPlanFields"]
    assert names == want


# ---------------------------------------------------------------------------
# the plain versions at the seams, against the JAX package
# ---------------------------------------------------------------------------

EDGE_REF_MANIFEST = {k: RefV[v] for k, v in SMOKE.EDGE_ATOM_MANIFEST.items()}
NEED_TEXTS = ["b"] + [SMOKE.balanced([f"{'nm'[i % 2]} == {i % 5}"
                                      for i in range(k)])
                      for k in SMOKE.SEAM_NEED_LEAVES.values()]


def _layout_args(reqs):
    return (sorted(reqs.derived_keys), sorted(reqs.byte_sources, key=str),
            [(n, k, ast) for (n, k), ast in reqs.extern_sources.items()])


@pytest.fixture(scope="module")
def atom_worlds():
    """The edge atoms and the seam programs (need 1, 3, 4, 5) over both
    packages' layouts, 33 records (cap 8) → (texts, reference rows
    [(val, ok, err)], port closures, port OpProgram, port batch)."""
    from istio_tpu.expr.checker import DEFAULT_FUNCS as REF_FUNCS
    from istio_tpu.expr.checker import eval_type as ref_eval_type
    dicts = SMOKE.edge_atom_dicts(33, seed=64)
    rfinder = RefFinder(EDGE_REF_MANIFEST)
    texts = []
    for t in list(SMOKE.EDGE_ATOMS) + NEED_TEXTS:
        try:
            ast = ref_parse(t)
            if ref_eval_type(ast, rfinder, REF_FUNCS) != RefV.BOOL:
                continue
        except Exception:
            continue
        texts.append(t)
    rasts = [ref_parse(t) for t in texts]
    rreqs = ref_te.Requirements()
    for a in rasts:
        ref_te.collect_requirements(a, rfinder, rreqs)
    rlay = ref_layout.build_layout(EDGE_REF_MANIFEST, *_layout_args(rreqs)[:2],
                                   max_str_len=8,
                                   extern_sources=_layout_args(rreqs)[2])
    rint = ref_layout.InternTable()
    rctx = ref_te._Ctx(rlay, rint, rfinder)
    manifest = interop.manifest_from_reference(EDGE_REF_MANIFEST)
    finder = AttributeDescriptorFinder(manifest)
    asts = [parse(t) for t in texts]
    reqs = pt_te.Requirements()
    for a in asts:
        pt_te.collect_requirements(a, finder, reqs)
    lay = pt_layout.build_layout(manifest, *_layout_args(reqs)[:2],
                                 max_str_len=8,
                                 extern_sources=_layout_args(reqs)[2])
    interner = pt_layout.InternTable()
    ctx = pt_te._Ctx(lay, interner, finder)
    keep, nodes, rnodes = [], [], []
    for i, (ra, a) in enumerate(zip(rasts, asts)):
        try:
            rn = ref_te._compile_node(ra, rctx)
        except ref_te.HostFallback:
            with pytest.raises(pt_te.HostFallback):
                pt_te._compile_node(a, ctx)
            continue
        rnodes.append(rn)
        nodes.append(pt_te._compile_node(a, ctx))
        keep.append(i)
    rbatch = ref_layout.Tensorizer(rlay, rint).tensorize(
        [RefDictBag(d) for d in dicts])
    want = []
    for rn in rnodes:
        t = rn(rbatch)
        want.append((np.asarray(t.val).astype(np.int32), np.asarray(t.ok),
                     np.asarray(t.err)))
    prog = op_lower.lower_programs([asts[i] for i in keep], lay, interner,
                                   finder)
    batch = pt_layout.Tensorizer(lay, interner).tensorize(
        [DictBag(d) for d in dicts])
    return [texts[i] for i in keep], want, nodes, prog, batch


def _needs(prog) -> list[int]:
    return [SMOKE.stack_need(prog.ops[prog.starts[i]:prog.starts[i + 1]])
            for i in range(prog.n)]


@pytest.mark.parametrize("kind", ["shallow", "deep"])
@pytest.mark.parametrize("n", SEAM_A)
@pytest.mark.parametrize("b", (1, 31, 32, 33))
def test_atoms_at_seams_equal_reference(atom_worlds, b, n, kind):
    """n atoms (repeating the edge atoms; with a need-5 atom for the
    general kernels' launch) over the first b records, written at
    scattered columns of [b, 2n + 7] ext planes holding a seeded
    pattern: atom_eval on CPU planes (the closures) and the op-table
    interpreter equal the reference closures' literal pairs, and every
    other column keeps the pattern."""
    texts, want, nodes, whole, full = atom_worlds
    needs = _needs(whole)
    assert {1, 3, 4, 5} <= set(needs)
    shallow = [i for i, k in enumerate(needs) if k <= fo.SHALLOW]
    picks = [shallow[i % len(shallow)] for i in range(n)]
    if kind == "deep":
        picks = picks[:-1] + [needs.index(5)]
    rng = np.random.default_rng(1000 * n + b)
    x = 2 * n + 7
    cols = rng.permutation(x)[:n].astype(np.int32)
    atoms = fo.AtomProgram(fns=[nodes[i] for i in picks],
                           prog=SMOKE.sub_program(whole, picks), cols=cols)
    assert (atoms.prog.need > fo.SHALLOW) == (kind == "deep")
    batch = full.rows(0, b)
    base = tuple(torch.from_numpy(rng.random((b, x)) < 0.5)
                 for _ in range(2))
    keep = np.ones(x, bool)
    keep[cols] = False
    for fn in (fo.atom_eval, fo.atom_eval_ops_plain):
        em, en = (t.clone() for t in base)
        fn(batch, atoms, em, en)
        for j, i in enumerate(picks):
            val, ok, err = (w[:b] for w in want[i])
            ee = err | ~ok
            m, nn = (val != 0) & ~ee, (val == 0) & ~ee
            np.testing.assert_array_equal(em[:, cols[j]].numpy(), m,
                                          err_msg=f"{texts[i]}: m")
            np.testing.assert_array_equal(en[:, cols[j]].numpy(), nn,
                                          err_msg=f"{texts[i]}: n")
        np.testing.assert_array_equal(em.numpy()[:, keep],
                                      base[0].numpy()[:, keep])
        np.testing.assert_array_equal(en.numpy()[:, keep],
                                      base[1].numpy()[:, keep])


@pytest.fixture(scope="module")
def field_world():
    """chip_smoke.EDGE_FIELDS and balanced BOOL fields of need 3, 4, 5
    over GLOBAL_MANIFEST, 33 records → (reference value rows [n, 33] and
    valid rows [n, 33], port closures, OpProgram, batch)."""
    texts = list(SMOKE.EDGE_FIELDS) + [
        SMOKE.balanced([f"{('request.size', 'response.code')[i % 2]} == {i}"
                        for i in range(k)])
        for k in SMOKE.SEAM_NEED_LEAVES.values()]
    dicts = SMOKE.edge_field_dicts(33, seed=23)
    rfinder = RefFinder(REF_GLOBAL)
    rasts = [ref_parse(t) for t in texts]
    rreqs = ref_te.Requirements()
    for a in rasts:
        ref_te.collect_requirements(a, rfinder, rreqs)
    dk, bs, ex = _layout_args(rreqs)
    rlay = ref_layout.build_layout(REF_GLOBAL, dk, bs, extern_sources=ex)
    rint = ref_layout.InternTable()
    rnodes = [ref_te.compile_field(a, rfinder, rlay, rint)[0] for a in rasts]
    rbatch = ref_layout.Tensorizer(rlay, rint).tensorize(
        [RefDictBag(d) for d in dicts])
    vals, valid = [], []
    for rn in rnodes:
        t = rn(rbatch)
        vals.append(np.asarray(t.val).astype(np.int32))
        valid.append(np.asarray(t.ok & ~t.err))
    manifest = interop.manifest_from_reference(REF_GLOBAL)
    finder = AttributeDescriptorFinder(manifest)
    asts = [parse(t) for t in texts]
    reqs = pt_te.Requirements()
    for a in asts:
        pt_te.collect_requirements(a, finder, reqs)
    dk, bs, ex = _layout_args(reqs)
    lay = pt_layout.build_layout(manifest, dk, bs, extern_sources=ex)
    interner = pt_layout.InternTable()
    fns = [pt_te.compile_field(a, finder, lay, interner)[0] for a in asts]
    prog = op_lower.lower_programs(asts, lay, interner, finder)
    batch = pt_layout.Tensorizer(lay, interner).tensorize(
        [DictBag(d) for d in dicts])
    return np.stack(vals), np.stack(valid), fns, prog, batch


@pytest.mark.parametrize("n,kind", [(n, k) for n in SEAM_F
                                    for k in ("shallow", "deep")
                                    if n or k == "shallow"])
@pytest.mark.parametrize("b", (1, 31, 32, 33))
def test_fields_at_seams_equal_reference(field_world, b, n, kind):
    """n fields (repeating the edge fields; with a need-5 field for the
    general kernels' launch) over the first b records: field_eval on CPU
    planes (the closures), written into rows of a larger buffer, and the
    op-table interpreter equal the reference's value rows and
    pack_bool_rows valid words; the buffer's other rows are untouched."""
    vals, valid, fns, whole, full = field_world
    needs = _needs(whole)
    assert {1, 3, 4, 5} <= set(needs)
    shallow = [i for i, k in enumerate(needs) if k <= fo.SHALLOW]
    picks = [shallow[i % len(shallow)] for i in range(n)]
    if kind == "deep":
        picks = picks[:-1] + [needs.index(5)]
    prog = fo.FieldProgram(fns=[fns[i] for i in picks],
                           prog=SMOKE.sub_program(whole, picks))
    words = -(-n // 32)
    vpad = np.zeros((b, 32 * words), bool)
    vpad[:, :n] = valid[picks][:, :b].T
    want = np.concatenate(
        [vals[picks][:, :b].reshape(n, b),
         np.asarray(ref_pack_bool_rows(vpad, words)).reshape(words, b)])
    batch = full.rows(0, b)
    buf = torch.full((n + words + 3, b), -5, dtype=torch.int32)
    fo.field_eval(batch, prog, out=buf[3:])
    np.testing.assert_array_equal(buf[3:].numpy(), want)
    assert (buf[:3] == -5).all()
    np.testing.assert_array_equal(fo.field_eval_ops_plain(batch, prog)
                                  .numpy(), want)


# ---------------------------------------------------------------------------
# logging
# ---------------------------------------------------------------------------

def test_port_logging_leaves_reference_logger_alone():
    """configure_logging and scope work in the port's own namespace: the
    JAX package's "istio_tpu" logger keeps its handlers, level and
    propagate flag, and every scope logs under istio_tpu_torch."""
    ref = logging.getLogger("istio_tpu")
    mine = logging.getLogger("istio_tpu_torch")
    saved = (list(ref.handlers), ref.level, ref.propagate,
             list(mine.handlers), mine.level, mine.propagate,
             pt_log._configured)
    marker = logging.NullHandler()
    ref.addHandler(marker)
    ref.setLevel(logging.WARNING)
    ref.propagate = True
    try:
        before = (list(ref.handlers), ref.level, ref.propagate)
        pt_log.configure_logging(level="debug", output_paths=["stdout"])
        assert (list(ref.handlers), ref.level, ref.propagate) == before
        assert mine.level == logging.DEBUG and not mine.propagate
        assert len(mine.handlers) == 1
        assert pt_log.scope("runtime.fused").name == \
            "istio_tpu_torch.runtime.fused"
        assert (list(ref.handlers), ref.level, ref.propagate) == before
    finally:
        ref.removeHandler(marker)
        ref.handlers[:], ref.level, ref.propagate = saved[:3]
        mine.handlers[:], mine.level, mine.propagate = saved[3:6]
        pt_log._configured = saved[6]


def test_port_modules_log_under_their_package():
    """Every module of the port that logs through utils.log.scope names a
    logger under istio_tpu_torch."""
    from istio_tpu_torch.models import policy_engine
    from istio_tpu_torch.runtime import (device_quota, fused, report_lower,
                                         rulestats, server)
    for mod in (fused, server, report_lower, rulestats, device_quota,
                policy_engine):
        assert mod.log.name.startswith("istio_tpu_torch."), mod.__name__
