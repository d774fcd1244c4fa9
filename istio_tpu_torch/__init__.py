"""istio_tpu_torch — the served Mixer paths and Pilot in PyTorch and CUDA.

A port of `istio_tpu` (the JAX package, kept beside it as the reference)
to one NVIDIA H100. It imports torch and numpy, never jax, and nothing of
`istio_tpu`: every host module it needs is its own copy.

Layout (each module keeps the reference's path and names):
  utils/      log, LRU cache, tracing spans
  attribute/  attribute bags and value types
  expr/       expression parser, type checker, externs, oracle interpreter
  compiler/   layout + Tensorizer, expression → torch closures, ruleset
  ops/        regex → DFA compiler, byte predicates and the DFA scan,
              report field programs, route winner and re-densify
  models/     PolicyEngine (the fused step) and the quota rank
  runtime/    the served Check() path: store, snapshot builder, fused
              plan, rule telemetry, dispatcher, batcher, controller,
              server
  templates/  the template registry; adapters/ the host adapters
  pilot/      Pilot: service model, registries, route and Envoy config
              builders, discovery snapshots and service, route automaton
  sharding/   the namespace shard planner discovery snapshots use
  testing/    the synthetic mesh workloads and config stores
  kernels/    build + ctypes loader of csrc/*.cu and launch counters
  csrc/       the hand-written CUDA kernels (sm_90a)
  interop.py  carries the JAX package's compiled state across

Every entry point takes `device=`; it defaults to "cuda" and raises when
CUDA is absent. The CPU runs only when the caller passes device="cpu",
and there each kernel wrapper runs its plain PyTorch version.
"""
from istio_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
