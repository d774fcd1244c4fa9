"""The devices a mesh is built over.

Port of istio_tpu/platform.py. The JAX package verifies its multi-device
paths on `force_cpu_platform(n)`: n virtual CPU devices in one process.
The port's counterpart is `force_virtual_devices(n, device)`: n virtual
devices over ONE physical device, each with its own CUDA stream on a card
(no stream on the CPU). Every shard of a mesh built over them runs its
kernels on its own stream, and every cross-shard gather is a copy (or,
within one physical device, a stream wait on the producer's event).

    devices()                      the physical CUDA devices, or the
                                   forced virtual ones
    force_virtual_devices(8, "cuda:0")    process-wide; also a context
                                   manager that restores the previous list

It is never called implicitly: without it a mesh larger than the card
count raises (parallel/mesh.py MeshSpec.build).
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import nullcontext
from typing import Any

import torch


@dataclasses.dataclass(eq=False)
class VirtualDevice:
    """One device of a mesh: a physical torch device and, on a card, the
    CUDA stream every launch of this device's shards is queued on."""
    id: int
    device: torch.device
    stream: Any = None          # torch.cuda.Stream on a card, else None

    def scope(self):
        """Make this device's stream current (a no-op on the CPU)."""
        if self.stream is None:
            return nullcontext()
        return torch.cuda.stream(self.stream)

    def record(self):
        """An event at the current end of this device's stream (None on
        the CPU, where every op has run when it returns)."""
        if self.stream is None:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def wait(self, event) -> None:
        """Order this device's later work after `event`."""
        if event is not None and self.stream is not None:
            self.stream.wait_event(event)

    def __repr__(self) -> str:
        return f"VirtualDevice(id={self.id}, {self.device})"


def fork(device: torch.device) -> tuple[Any, Any]:
    """(the caller's current stream on `device`, an event at its end):
    each shard's stream waits on the event before it starts, so it sees
    everything the caller queued. (None, None) on the CPU."""
    if device.type != "cuda":
        return None, None
    cur = torch.cuda.current_stream(device)
    ev = torch.cuda.Event()
    ev.record(cur)
    return cur, ev


def handed_over(t: torch.Tensor, stream) -> torch.Tensor:
    """Tell the caching allocator that `t` is read on `stream` too (a
    tensor made on one device's stream and consumed on another's), so
    its block is not reused before that stream's queued reads ran."""
    if stream is not None and t.is_cuda:
        t.record_stream(stream)
    return t


_lock = threading.Lock()
_forced: list[VirtualDevice] | None = None
_physical: list[VirtualDevice] | None = None


def _new_stream(dev: torch.device):
    return torch.cuda.Stream(device=dev) if dev.type == "cuda" else None


def devices() -> list[VirtualDevice]:
    """The devices a mesh is built over: the forced virtual devices, or
    one per physical CUDA device (none without CUDA: the port never
    builds a mesh on the CPU unless the caller forces it)."""
    global _physical
    with _lock:
        if _forced is not None:
            return list(_forced)
        if _physical is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            _physical = [VirtualDevice(i, torch.device("cuda", i),
                                       _new_stream(torch.device("cuda", i)))
                         for i in range(n)]
        return list(_physical)


class force_virtual_devices:    # noqa: N801 — used as a function
    """Make `devices()` return `n` virtual devices over the physical
    `device` ("cpu" or "cuda:k"), each with its own stream on a card.
    Takes effect at the call; as a context manager it restores the
    previous device list on exit."""

    def __init__(self, n: int, device: str | torch.device = "cuda:0"):
        global _forced
        if n < 1:
            raise ValueError(f"need at least one virtual device, got {n}")
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("force_virtual_devices: CUDA requested "
                                   "but torch.cuda.is_available() is False")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"unsupported device {dev}")
        with _lock:
            self._previous = _forced
            _forced = [VirtualDevice(i, dev, _new_stream(dev))
                       for i in range(n)]
            self.devices = list(_forced)

    def __enter__(self) -> list[VirtualDevice]:
        return self.devices

    def __exit__(self, *exc) -> None:
        global _forced
        with _lock:
            _forced = self._previous
