"""Quota allocation helpers (port of istio_tpu/models/quota_alloc.py).

Only `batch_rank` is carried in this slice: it is the plain version of
the verdict_fold kernel's quota rank. The classic pool-flush and rolling
window kernels (the reference's make_alloc_step / make_rolling_alloc_step)
are still to port (ROADMAP.md).
"""
from __future__ import annotations

import torch


def batch_rank(key: torch.Tensor) -> torch.Tensor:
    """rank[i] = #{j < i in stable sort order : key[j] == key[i]} — the
    occurrence index of each element within its key group (sentinel
    keys get unused ranks). int32 [N] → int32 [N]."""
    n = key.shape[0]
    order = torch.argsort(key, stable=True)
    sk = key[order]
    idx = torch.arange(n, dtype=torch.int32, device=key.device)
    newseg = torch.ones(n, dtype=torch.bool, device=key.device)
    newseg[1:] = sk[1:] != sk[:-1]
    seg_first = torch.cummax(torch.where(newseg, idx, 0), dim=0).values
    rank_sorted = (idx - seg_first).to(torch.int32)
    out = torch.zeros(n, dtype=torch.int32, device=key.device)
    out[order] = rank_sorted
    return out
