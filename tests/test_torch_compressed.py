"""The port's compressed-bag codec (istio_tpu_torch/attribute/compressed.py)
against the JAX package's (istio_tpu/attribute/compressed.py).

The same bags, made from a numpy seed with every attribute type (global
dictionary words and message-local words, strings, ints, doubles, bools,
timestamps, durations, bytes, string maps, empty values), encode to
equal CompressedAttributes in both packages; each package decodes the
other's encoding back to the original values; and both refuse the same
malformed inputs. The 169-word global dictionary is the reference's,
word for word. Exact equality throughout.
"""
import dataclasses
import datetime

import numpy as np
import pytest

from istio_tpu.attribute import compressed as ref_c
from istio_tpu.attribute import global_dict as ref_gd
from istio_tpu.attribute.bag import bag_from_mapping as ref_bag

from istio_tpu_torch.attribute import compressed as pt_c
from istio_tpu_torch.attribute import global_dict as pt_gd
from istio_tpu_torch.attribute.bag import bag_from_mapping as pt_bag
from istio_tpu_torch.testing import workloads


def _values(seed: int, n: int) -> list[dict]:
    """n attribute dicts with every value type the codec carries."""
    rng = np.random.default_rng(seed)
    t0 = datetime.datetime(2026, 8, 3, 12, 0, tzinfo=datetime.timezone.utc)
    out = []
    for i in range(n):
        d = {
            "destination.service":
                f"svc{int(rng.integers(50))}.ns{i % 4}.svc.cluster.local",
            "source.namespace": "ns" if i % 3 else "",
            "request.method": ("GET", "POST", "DELETE")[i % 3],
            "request.size": int(rng.integers(-2**40, 2**40)),
            "response.code": 200 + i,
            "request.time": t0 + datetime.timedelta(
                seconds=int(rng.integers(1_000_000))),
            "response.duration": datetime.timedelta(
                microseconds=int(rng.integers(10**7))),
            "source.ip": bytes(rng.integers(0, 256, 4 if i % 2 else 16,
                                            dtype=np.uint8)),
            "connection.mtls": bool(i % 2),
            "request.headers": {"x-user": f"u{int(rng.integers(9))}",
                                "cookie": "session=1",
                                # a value that is also a global word
                                "source.ip": "request.path"},
            # a name outside the global dictionary, a double
            f"custom.attr{i % 5}": float(rng.random()) * 1e3,
        }
        if i % 4 == 0:
            d["request.headers"] = {}
        out.append(d)
    return out


CASES = {"typed": _values(7, 24),
         "workload": workloads.make_request_dicts(32, seed=5)}


def test_global_dictionary_is_the_references():
    assert pt_gd.GLOBAL_WORD_LIST == ref_gd.GLOBAL_WORD_LIST
    assert pt_gd.GLOBAL_WORD_INDEX == ref_gd.GLOBAL_WORD_INDEX
    assert len(pt_gd.GLOBAL_WORD_LIST) == 169


@pytest.mark.parametrize("case", sorted(CASES))
def test_encode_equals_the_reference(case):
    for d in CASES[case]:
        got = pt_c.encode(pt_bag(d))
        want = ref_c.encode(ref_bag(d))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_round_trips_across_packages(case):
    for d in CASES[case]:
        pt_ca = pt_c.encode(pt_bag(d))
        ref_ca = ref_c.encode(ref_bag(d))
        for bag in (pt_c.decode(pt_ca),
                    pt_c.decode(ref_c.CompressedAttributes(
                        **dataclasses.asdict(ref_ca)))):
            assert sorted(bag.names()) == sorted(d)
            for name, want in d.items():
                got, ok = bag.get(name)
                assert ok and got == want, name
        back = ref_c.decode(ref_c.CompressedAttributes(
            **dataclasses.asdict(pt_ca)))
        assert {n: back.get(n)[0] for n in back.names()} == d


def test_malformed_inputs_fail_alike():
    for c in (pt_c, ref_c):
        with pytest.raises(c.WordResolutionError):
            c.decode(c.CompressedAttributes(strings={10_000: 0}))
        with pytest.raises(c.WordResolutionError):
            c.decode(c.CompressedAttributes(strings={-3: 0},
                                            words=["a"]))
    with pytest.raises(TypeError) as pt_err:
        pt_c.encode(pt_bag({"a": [1, 2]}))
    with pytest.raises(TypeError) as ref_err:
        ref_c.encode(ref_bag({"a": [1, 2]}))
    assert str(pt_err.value).replace("istio_tpu_torch", "istio_tpu") == \
        str(ref_err.value)
    assert pt_c.slot_to_index(3) == ref_c.slot_to_index(3) == -4
    assert pt_c.index_to_slot(-4) == ref_c.index_to_slot(-4) == 3
