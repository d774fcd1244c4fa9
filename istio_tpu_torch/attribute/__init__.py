"""Attribute system (reference: mixer/pkg/attribute). The wire codec
(compressed.py, global_dict.py) is off the Check() path and not ported."""

from istio_tpu_torch.attribute.bag import (Bag, DictBag, MutableBag,
                                           TrackingBag, CONDITION_ABSENCE,
                                           CONDITION_EXACT)
from istio_tpu_torch.attribute.types import ValueType

__all__ = [
    "Bag", "DictBag", "MutableBag", "TrackingBag",
    "CONDITION_ABSENCE", "CONDITION_EXACT", "ValueType",
]
