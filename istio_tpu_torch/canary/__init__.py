"""Config canary — record live Check() traffic, shadow-replay
prospective snapshots on the device, gate the swap.

Port of istio_tpu/canary. Before the Controller's atomic publish swaps
a rebuilt snapshot in, the candidate `FusedPlan` is validated against
RECORDED live traffic on the same hardware:

  record  — `TrafficRecorder` (recorder.py): a lock-light sampling
            ring buffer tapped at the dispatcher boundary captures
            recent Check() traffic as compressed attribute bags plus
            the device's decision.
  replay  — `replay_entries` (replay.py): the corpus batch-replays
            through the candidate plan in observe-off mode (no
            rule telemetry / stage-metric / chaos pollution) on the
            card: one fused trip a chunk through K1-K5.
  diff    — `diff_decisions` (differ.py): per-request divergence
            classification (status flip, precondition TTL/use-count
            change, quota delta) aggregated per rule, with reservoir
            exemplars (bag + trace id) and oracle re-confirmation.
  gate    — `ConfigCanary` (gate.py): ServerArgs.canary={off,warn,gate};
            `gate` vetoes the publish (typed `CanaryRejected`, old
            dispatcher keeps serving), `warn` publishes but records the
            report. On a CUDA server a replay device fault raises
            instead of failing open (gate.py).

The `mixer_canary_*` families live on utils/metrics.default_registry.
Not ported: the /debug/canary view and /metrics scrape (introspect),
kube/admission.register_canary_admission, the `canary` CLI subcommand,
bench.py's `canary_*` keys and the shard-bank dispatchers' taps.
"""
from istio_tpu_torch.canary.differ import (CanaryReport, Divergence,
                                           diff_decisions, oracle_decision)
from istio_tpu_torch.canary.gate import (CanaryConfig, CanaryRejected,
                                         ConfigCanary)
from istio_tpu_torch.canary.recorder import (CanaryEntry, TrafficRecorder,
                                             entry_from_json, entry_to_json,
                                             load_corpus, save_corpus)
from istio_tpu_torch.canary.replay import ReplayResult, replay_entries

__all__ = [
    "CanaryConfig", "CanaryEntry", "CanaryRejected", "CanaryReport",
    "ConfigCanary", "Divergence", "ReplayResult", "TrafficRecorder",
    "diff_decisions", "entry_from_json", "entry_to_json",
    "load_corpus", "oracle_decision", "replay_entries", "save_corpus",
]
