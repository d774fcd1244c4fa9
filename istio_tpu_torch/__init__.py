"""istio_tpu_torch — the fused Check() policy step in PyTorch and CUDA.

A port of `istio_tpu` (the JAX package, kept beside it as the reference)
to one NVIDIA H100. It imports torch and numpy, never jax, and nothing of
`istio_tpu`: every host module it needs is its own copy.

Layout (each module keeps the reference's path and names):
  utils/      log, LRU cache
  attribute/  attribute bags and value types
  expr/       expression parser, type checker, externs, oracle interpreter
  compiler/   layout + Tensorizer, expression → torch closures, ruleset
  ops/        regex → DFA compiler, byte predicates and the DFA scan
  models/     PolicyEngine (the fused step) and the quota rank
  testing/    the synthetic mesh workloads
  kernels/    build + ctypes loader of csrc/*.cu and launch counters
  csrc/       the hand-written CUDA kernels (sm_90a)
  interop.py  carries the JAX package's compiled state across

Every entry point takes `device=`; it defaults to "cuda" and raises when
CUDA is absent. The CPU runs only when the caller passes device="cpu",
and there each kernel wrapper runs its plain PyTorch version.
"""
from istio_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
