"""The port's expression compiler against the JAX package's: every
conformance-corpus expression compiled by both `compile_expression`s
and evaluated over every corpus input in one batch. Values, validity
and host-fallback decisions must be equal exactly (plain versions of
the kernels on the CPU)."""
import numpy as np
import pytest
import torch

from istio_tpu.attribute.bag import DictBag as RefDictBag
from istio_tpu.compiler import layout as ref_layout
from istio_tpu.compiler import tensor_expr as ref_te
from istio_tpu.expr.checker import AttributeDescriptorFinder as RefFinder
from istio_tpu.expr.parser import parse as ref_parse
from istio_tpu.testing.corpus import CORPUS, CORPUS_MANIFEST, Case

from istio_tpu_torch.attribute.bag import DictBag
from istio_tpu_torch.compiler import layout as pt_layout
from istio_tpu_torch.compiler import tensor_expr as pt_te
from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
from istio_tpu_torch.expr.parser import parse
from istio_tpu_torch.interop import manifest_from_reference


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep torch's CPU ops to one thread: the suite runs in several
    worker processes beside timing-sensitive serving tests."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


RUNNABLE = [c for c in CORPUS if c.compile_err is None]
INPUTS = [c.input for c in RUNNABLE]
REF_FINDER = RefFinder(CORPUS_MANIFEST)
PT_MANIFEST = manifest_from_reference(CORPUS_MANIFEST)
PT_FINDER = AttributeDescriptorFinder(PT_MANIFEST)


def _layout_args(reqs):
    return (sorted(reqs.derived_keys), sorted(reqs.byte_sources, key=str),
            [(n, k, ast) for (n, k), ast in reqs.extern_sources.items()])


def _ref(text):
    reqs = ref_te.collect_requirements(ref_parse(text), REF_FINDER)
    dk, bs, ex = _layout_args(reqs)
    lay = ref_layout.build_layout(CORPUS_MANIFEST, dk, bs, extern_sources=ex)
    interner = ref_layout.InternTable()
    prog = ref_te.compile_expression(text, REF_FINDER, lay, interner,
                                     jit=False)
    batch = ref_layout.Tensorizer(lay, interner).tensorize(
        [RefDictBag(d) for d in INPUTS])
    val, valid = prog(batch)
    return np.asarray(val), np.asarray(valid)


def _port(text):
    reqs = pt_te.collect_requirements(parse(text), PT_FINDER)
    dk, bs, ex = _layout_args(reqs)
    lay = pt_layout.build_layout(PT_MANIFEST, dk, bs, extern_sources=ex)
    interner = pt_layout.InternTable()
    prog = pt_te.compile_expression(text, PT_FINDER, lay, interner,
                                    device="cpu")
    batch = pt_layout.Tensorizer(lay, interner).tensorize(
        [DictBag(d) for d in INPUTS])
    val, valid = prog(batch)
    return val.numpy(), valid.numpy()


@pytest.mark.parametrize("case", RUNNABLE, ids=lambda c: c.id())
def test_corpus_expression_parity(case: Case):
    try:
        want = _ref(case.e)
    except ref_te.HostFallback:
        with pytest.raises(pt_te.HostFallback):
            _port(case.e)
        return
    got_val, got_valid = _port(case.e)
    want_val, want_valid = want
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got_val, want_val)
