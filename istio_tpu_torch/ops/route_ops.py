"""Route selection's device tail: the winner reduction and the compact
byte-plane re-densify (B12), each beside its plain PyTorch version.

Port of istio_tpu/pilot/route_nfa.py `_winner` (:115) and the
re-densify half of `_select_on_device_compact` (:270-308). On CUDA
tensors the wrappers launch the hand-written kernel route_select
(csrc/route_select.cu, K10); on CPU tensors they run the plain
versions, which are the reference's formulas in torch. There is no
fallback from a CUDA tensor to a plain version.
"""
from __future__ import annotations

import torch

from istio_tpu_torch import kernels
from istio_tpu_torch.ops.bytes_ops import _kernel_or_plain


# ---------------------------------------------------------------------------
# winner
# ---------------------------------------------------------------------------

def route_winner_plain(matched: torch.Tensor, weight: torch.Tensor,
                       default_index: int) -> torch.Tensor:
    """The highest weight among matched rules wins (the first on ties,
    as argmax); nothing matched → default_index. bool [B, R] × int32 [R]
    → int32 [B]."""
    scores = matched.to(torch.int32) * weight[None, :]
    best = torch.argmax(scores, dim=1)
    hit = scores.max(dim=1).values > 0
    return torch.where(hit, best, default_index).to(torch.int32)


def route_winner(matched: torch.Tensor, weight: torch.Tensor,
                 default_index: int) -> torch.Tensor:
    """Winning route per row of `matched` bool [B, R] under `weight`
    int32 [R] → int32 [B]."""
    if matched.dim() != 2 or matched.dtype != torch.bool:
        raise ValueError(f"route_winner: matched must be bool [B, R], got "
                         f"{matched.dtype} {tuple(matched.shape)}")
    b, r = matched.shape
    if weight.dtype != torch.int32 or tuple(weight.shape) != (r,):
        raise ValueError(f"route_winner: weight must be int32 [{r}]")
    if r == 0:
        raise ValueError("route_winner: no routes")
    if not _kernel_or_plain(matched, weight):
        return route_winner_plain(matched, weight, default_index)
    if matched.stride(1) != 1:
        matched = matched.contiguous()
    weight = weight.contiguous()
    out = torch.empty(b, dtype=torch.int32, device=matched.device)
    if b == 0:
        return out
    fn = kernels.function("route_select", "route_winner", _WINNER_ARGS)
    rc = fn(kernels.ptr(matched), matched.stride(0), b, r,
            kernels.ptr(weight), int(default_index), kernels.ptr(out),
            kernels.VP(kernels.stream_ptr()))
    kernels.launched("route_select", kernels.check(rc, "route_winner"),
                     "winner", matched, weight, int(default_index),
                     entry="route_winner")
    return out


# ---------------------------------------------------------------------------
# densify
# ---------------------------------------------------------------------------

def route_densify_plain(flat: torch.Tensor, lens16: torch.Tensor,
                        pres_packed: torch.Tensor, n_cols: int, max_len: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ragged byte plane back to dense: flat uint8 [cap], lens int16
    [B, nbyte], presence uint8 [B, P8] (bits little-endian) → (str_bytes
    uint8 [B, nbyte, L], str_lens int32 [B, nbyte], present bool
    [B, n_cols])."""
    dev = flat.device
    lens = lens16.to(torch.int32)
    b, nbyte = lens.shape
    flat_lens = lens.reshape(-1)
    starts = (torch.cumsum(flat_lens, 0, dtype=torch.int32)
              - flat_lens).reshape(b, nbyte)
    j = torch.arange(max_len, dtype=torch.int32, device=dev)
    idx = starts[:, :, None] + j[None, None, :]
    sb = flat[torch.clamp(idx, 0, flat.shape[0] - 1).long()]
    sb = torch.where(j[None, None, :] < lens[:, :, None], sb,
                     torch.zeros((), dtype=torch.uint8, device=dev))
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = ((pres_packed[:, :, None] >> shifts) & 1) > 0
    present = bits.reshape(b, -1)[:, :n_cols]
    return sb, lens, present


def route_densify(flat: torch.Tensor, lens16: torch.Tensor,
                  pres_packed: torch.Tensor, n_cols: int, max_len: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """route_densify_plain's function in one launch of four grids on
    CUDA tensors."""
    if flat.dim() != 1 or flat.dtype != torch.uint8 or flat.shape[0] < 1:
        raise ValueError("route_densify: flat must be a non-empty uint8 "
                         "[cap] tensor")
    if lens16.dim() != 2 or lens16.dtype != torch.int16:
        raise ValueError("route_densify: lens must be int16 [B, nbyte]")
    b, nbyte = lens16.shape
    if pres_packed.dim() != 2 or pres_packed.dtype != torch.uint8 or \
            pres_packed.shape[0] != b or 8 * pres_packed.shape[1] < n_cols:
        raise ValueError(f"route_densify: presence must be uint8 [{b}, "
                         f">= {n_cols} / 8]")
    if not _kernel_or_plain(flat, lens16, pres_packed):
        return route_densify_plain(flat, lens16, pres_packed, n_cols,
                                   max_len)
    dev = flat.device
    flat, lens16, pres_packed = (x.contiguous() for x in
                                 (flat, lens16, pres_packed))
    n = b * nbyte
    str_bytes = torch.empty((b, nbyte, max_len), dtype=torch.uint8,
                            device=dev)
    str_lens = torch.empty((b, nbyte), dtype=torch.int32, device=dev)
    present = torch.empty((b, n_cols), dtype=torch.bool, device=dev)
    sums = torch.empty(max(-(-n // _TILE), 1), dtype=torch.int32, device=dev)
    starts = torch.empty(max(n, 1), dtype=torch.int32, device=dev)
    p = kernels.ptr
    fn = kernels.function("route_select", "route_densify", _DENSIFY_ARGS)
    rc = fn(p(flat), flat.shape[0], p(lens16), b, nbyte, p(pres_packed),
            pres_packed.shape[1], int(n_cols), int(max_len), p(str_lens),
            p(sums), p(starts), p(str_bytes), p(present),
            kernels.VP(kernels.stream_ptr()))
    grids = kernels.check(rc, "route_densify")
    if grids:
        kernels.launched("route_select", grids, "densify", flat, lens16,
                         pres_packed, int(n_cols), int(max_len),
                         entry="route_densify")
    return str_bytes, str_lens, present


_TILE = 1024     # csrc/route_select.cu kTile: lens per scan tile
_K = kernels
_WINNER_ARGS = [_K.VP, _K.I64, _K.I32, _K.I32, _K.VP, _K.I32, _K.VP, _K.VP]
_DENSIFY_ARGS = ([_K.VP, _K.I64, _K.VP, _K.I32, _K.I32, _K.VP, _K.I32,
                  _K.I32, _K.I32] + [_K.VP] * 6)
