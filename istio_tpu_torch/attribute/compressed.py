"""Dictionary-compressed attribute wire codec.

Port of istio_tpu/attribute/compressed.py (standard library only). Role
of the reference's CompressedAttributes encode/decode
(mixer/pkg/attribute/mutableBag.go:230 ToProto, :296 GetBagFromProto;
protoBag.go:49 NewProtoBag): attribute names and string values travel as
int32 dictionary indices. Index >= 0 points into the 169-word global
dictionary; index < 0 points into the per-message word list at slot
``-index - 1`` (dictState.go:74-81).

The config canary compresses every recorded bag through it
(canary/recorder.py). The wire fronts that decode it, and the Report
stream's delta decoding (`decode_deltas`), are not ported.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Mapping

from istio_tpu_torch.attribute.bag import Bag, DictBag
from istio_tpu_torch.attribute.global_dict import (GLOBAL_WORD_INDEX,
                                                 GLOBAL_WORD_LIST)


def slot_to_index(slot: int) -> int:
    return -slot - 1


def index_to_slot(index: int) -> int:
    return -index - 1


@dataclasses.dataclass
class CompressedAttributes:
    """Wire-shaped attribute record (mirrors istio.mixer.v1
    CompressedAttributes field-for-field in spirit)."""

    words: list[str] = dataclasses.field(default_factory=list)
    strings: dict[int, int] = dataclasses.field(default_factory=dict)
    int64s: dict[int, int] = dataclasses.field(default_factory=dict)
    doubles: dict[int, float] = dataclasses.field(default_factory=dict)
    bools: dict[int, bool] = dataclasses.field(default_factory=dict)
    timestamps: dict[int, datetime.datetime] = dataclasses.field(default_factory=dict)
    durations: dict[int, datetime.timedelta] = dataclasses.field(default_factory=dict)
    bytes_: dict[int, bytes] = dataclasses.field(default_factory=dict)
    string_maps: dict[int, dict[int, int]] = dataclasses.field(default_factory=dict)


class _DictState:
    """Assigns per-message word slots for words outside the global
    dictionary (reference: dictState.go:17-80)."""

    def __init__(self, global_index: Mapping[str, int]):
        self._global = global_index
        self._message: dict[str, int] = {}

    def assign(self, word: str) -> int:
        idx = self._global.get(word)
        if idx is not None:
            return idx
        idx = self._message.get(word)
        if idx is not None:
            return idx
        idx = slot_to_index(len(self._message))
        self._message[word] = idx
        return idx

    def word_list(self) -> list[str]:
        words = [""] * len(self._message)
        for w, idx in self._message.items():
            words[index_to_slot(idx)] = w
        return words


def encode(bag: Bag, global_index: Mapping[str, int] | None = None) -> CompressedAttributes:
    """Bag → CompressedAttributes (reference: mutableBag.go:230 ToProto)."""
    gi = GLOBAL_WORD_INDEX if global_index is None else global_index
    ds = _DictState(gi)
    out = CompressedAttributes()
    for name in bag.names():
        v, ok = bag.get(name)
        if not ok:
            continue
        k = ds.assign(name)
        if isinstance(v, bool):
            out.bools[k] = v
        elif isinstance(v, int):
            out.int64s[k] = v
        elif isinstance(v, float):
            out.doubles[k] = v
        elif isinstance(v, str):
            out.strings[k] = ds.assign(v)
        elif isinstance(v, bytes):
            out.bytes_[k] = v
        elif isinstance(v, datetime.timedelta):
            out.durations[k] = v
        elif isinstance(v, datetime.datetime):
            out.timestamps[k] = v
        elif isinstance(v, Mapping):
            out.string_maps[k] = {ds.assign(mk): ds.assign(mv) for mk, mv in v.items()}
        else:
            raise TypeError(f"unsupported attribute value type for {name}: {type(v)}")
    out.words = ds.word_list()
    return out


class WordResolutionError(KeyError):
    pass


def _lookup_word(index: int, message_words: list[str],
                 global_words: list[str]) -> str:
    if index >= 0:
        if index < len(global_words):
            return global_words[index]
        raise WordResolutionError(f"global dictionary index {index} out of range")
    slot = index_to_slot(index)
    if slot < len(message_words):
        return message_words[slot]
    raise WordResolutionError(f"message word slot {slot} out of range")


def decode(ca: CompressedAttributes,
           global_words: list[str] | None = None) -> DictBag:
    """CompressedAttributes → eager DictBag (reference:
    mutableBag.go:296 GetBagFromProto + :311 UpdateBagFromProto)."""
    gw = GLOBAL_WORD_LIST if global_words is None else global_words
    values: dict[str, Any] = {}

    def word(i: int) -> str:
        return _lookup_word(i, ca.words, gw)

    for k, vi in ca.strings.items():
        values[word(k)] = word(vi)
    for k, v in ca.int64s.items():
        values[word(k)] = v
    for k, v in ca.doubles.items():
        values[word(k)] = v
    for k, v in ca.bools.items():
        values[word(k)] = v
    for k, v in ca.timestamps.items():
        values[word(k)] = v
    for k, v in ca.durations.items():
        values[word(k)] = v
    for k, v in ca.bytes_.items():
        values[word(k)] = v
    for k, m in ca.string_maps.items():
        values[word(k)] = {word(mk): word(mv) for mk, mv in m.items()}
    return DictBag(values)

