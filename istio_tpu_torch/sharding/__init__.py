"""Sharded serving plane — namespace-sharded compiled banks behind
replica-parallel serving lanes.

The scale-out analog of the reference resolver's namespace-scoped rule
resolution (mixer/pkg/runtime/resolver.go builds per-namespace rule
lists so a request only walks the rules that can apply to it): here a
snapshot's rules are PARTITIONED by namespace into K banks, each
compiled through the existing compiler/ruleset.py pipeline into its own
RuleSetProgram + FusedPlan, and a shard-aware dispatch path routes each
batch row to its namespace's bank and folds the per-shard verdicts back
into row order — verdict-identical to the monolithic compile by
construction (a request's visible rule set = default-namespace rules +
its namespace's rules, and every bank holds exactly that set for its
namespaces).

Layers (each its own module):

  planner.py  ShardPlan / plan_shards — namespaces packed onto K
              shards balanced by the predicted device budget of their
              rules (the tile-entry cost model)
  banks.py    shard sub-snapshots + ShardBank — each shard compiled
              into its own Snapshot/RuleSetProgram/FusedPlan/
              Dispatcher (the full serving machinery per bank: deny/
              list fusion, host overlay, telemetry, canary tap)
  router.py   ShardRouter (per-batch route → per-bank check → fold,
              on the lane's own CUDA stream) and ReplicaRouter (N
              CheckBatcher serving lanes behind one front,
              sticky-by-namespace)
  parity.py   SnapshotOracle-backed expected statuses — the exact
              parity surface the sharded path is judged against

Port of istio_tpu/sharding/.
"""
from istio_tpu_torch.sharding.planner import (ShardPlan, ShardPlanError,
                                              plan_shards,
                                              predict_rule_costs)
from istio_tpu_torch.sharding.banks import (ShardBank, ShardingUnsupported,
                                            bank_content_key,
                                            build_shard_banks,
                                            compile_shard_bank, rebind_bank,
                                            shard_snapshot,
                                            snapshot_static_digest)
from istio_tpu_torch.sharding.router import ReplicaRouter, ShardRouter
from istio_tpu_torch.sharding.parity import oracle_check_statuses

__all__ = [
    "ShardPlan", "ShardPlanError", "plan_shards", "predict_rule_costs",
    "ShardBank", "ShardingUnsupported", "bank_content_key",
    "build_shard_banks", "compile_shard_bank", "rebind_bank",
    "shard_snapshot", "snapshot_static_digest",
    "ReplicaRouter", "ShardRouter", "oracle_check_statuses",
]
