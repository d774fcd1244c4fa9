"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


class NotPorted(NotImplementedError):
    """A feature of the reference that this slice of the port does not
    carry yet (see ROADMAP.md)."""


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """→ a torch.device. "cuda" (the default of every entry point)
    raises when no CUDA device is present: the port never drops to the
    CPU unless the caller asks for it with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "istio_tpu_torch: CUDA requested but torch.cuda.is_available()"
                " is False; pass device='cpu' to run the plain versions")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
