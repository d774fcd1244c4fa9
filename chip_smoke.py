#!/usr/bin/env python3
"""Drive the port's served Check(), Report() and Quota() paths, Pilot's route
selection and discovery service, sequence-parallel DFA matching and mesh
serving on virtual devices, the config canary's shadow replay, the sharded
serving plane, the tail-latency forensics plane, and their kernels on one
NVIDIA H100.

    python3 chip_smoke.py            (from the root of a checkout)

Phases, each fatal on failure:
  1. the card (nvidia-smi name and power limit) and torch / CUDA versions;
  2. build every kernel of istio_tpu_torch/csrc/ with nvcc (in parallel);
  3. at the headline world (make_engine(10_000, with_quota=True), B=2048)
     record what the main path hands each kernel, on two traffics: the
     headline traffic of bench.py (workloads.make_bags +
     make_request_ns) and make_hit_requests (aimed at deny, list and
     quota rules, so that every branch of the fold runs). Hold each
     kernel against its plain PyTorch version on both (exact equality);
     on the headline traffic also time both (profiler device time and
     CUDA events) and compute each kernel's bound; then (3b) hold every
     kernel against its plain version on edge-case inputs neither
     traffic produces, and (3c) rule_match on atom-less, empty, all-EQ,
     host-fallback and rule_pad snapshots at B=2048 and B in K1_EDGE_B.
     Every rule_match launch replayed (rule_match_check) is held against
     rule_match_plain and rule_match_words_plain (the bit-sliced
     formulation over the kernel's own tables) with the planes its caller
     asked for and the full triple; a timed launch also with every plane
     subset and its first K1_EDGE_B rows. rule_match makes at most two
     `__global__` launches per call wherever a phase counts grids. Every
     verdict_fold launch replayed is held against verdict_fold_plain and
     verdict_fold_words_plain (the formulation over the kernel's
     rule-word tables), every check_pack launch against check_pack_plain
     and check_pack_words_plain, and their rows print the dense-plane
     floor beside the bound. Then (3d) verdict_fold, mesh_partial and
     check_pack on edge inputs (FOLD_EDGE_*): rule axes of 0, 8 and odd
     length mod 16 with quotas (two grids a fold), B from 0 to 2,048
     either side of a warp, request namespaces -1, -7, the default, the
     largest id and one past it and the int32 extremes, windows of the
     rule axis off a 32-rule word whose kernel records combine into the
     unsharded fold, and 3 and 11 instance words; and whole folds with
     quotas of limit 3 on make_engine(1,000) at QUOTA_FOLD_B (one quota
     block, a cluster of 2, a cluster of 8), three batches carried, equal
     to verdict_fold_plain and, the quota step alone, to
     quota_grant_plain (the kernel's formulation), two grids a fold. The
     headline row times the row fold and the quota launch apart, with the
     quota launch's bound and the stable argsort of its keys;
  4. end to end at B ∈ {64, 256, 2048}: three consecutive batches of
     each traffic with quota carried, every verdict field and the quota
     counters equal to the plain path (the same engine on the CPU) run
     from the same state; an engine with small quotas must hit
     RESOURCE_EXHAUSTED; the matched / err planes agree with the
     expression oracle on a sample; device step ms and checks/s on the
     headline traffic; the launch counters, zeroed just before this
     phase, must show every kernel ran;
  5. the served Check() path (this slice's main path): the port's
     RuntimeServer over make_store(10_000) on the card answers
     check_many(make_bags(B)) for B ∈ {64, 256, 2048}; its responses
     equal a device="cpu" server's on B=256 samples of the headline and
     the hit traffic, and so do the rule counts its rule-stats drainer
     and aggregator keep; every timed loop's counts equal its repeat
     count times the plain server's for its batch; served walls (p50 /
     p99), checks/s, device busy, idle share, the host stage breakdown
     and kernel calls / grids per served step are printed; the launch
     counters, zeroed just before this phase, must show all six kernels
     ran. Then (5c) a config swap through the store watch: the new plan
     is warmed and published, the next batch runs on the card and
     equals the CPU server, and no rule count is lost across the
     publish (launch counters zeroed before it and read after). Then
     (5b) every kernel
     against its plain version on the served path's own inputs at
     B=2048 (timed, with its bound: the kernels table), and check_pack /
     rule_stats on edge inputs (W > 1, C > 32, bit 31, padding rows,
     unknown namespaces, a served host-overlay world), and rule_stats
     on its own edge shapes (K6_EDGE: a ragged rule axis, planes off an
     8-byte boundary, S = 1 and 80, one, alternating and unknown
     namespaces, an all-padding batch, B = 333);
  6. the authz world (BASELINE config 2): make_rbac_store(1000) — one
     authorization rule whose rbac policy lowers to ~1,000 pseudo-rule
     rows — served on the card under MESH_MANIFEST against a
     device="cpu" server at B ∈ {64, 256, 2048} of
     make_rbac_request_dicts (responses and rule counts exact, the
     denied fraction printed), timed like phase 5; K1, K3, K4, K5, K6
     and atom_eval (the 306 check atoms as op programs) held against
     their plain versions on its B=2048 inputs (timed; atom_eval on ext
     planes holding a seeded pattern, every column outside the atoms'
     unchanged); counters zeroed before, every kernel of the path must
     launch, and atom_eval exactly once per step; then (6b) atom_eval
     against its plain versions on the atom world (every BOOL
     expression of the port's copy of the conformance corpus that
     lowers on the device, over the corpus inputs tiled to B=2048) and
     on edge atoms (runtime and constant patterns, strings at the cap,
     NaN and malformed order keys, a narrowed byte plane, operand swaps,
     a 40-deep LAND chain), and at the launch plan's seams (SEAM_A atoms
     x SEAM_B records, programs of stack need 1, 3, 4 and 5 so both
     stack instantiations run, atoms at scattered columns, strided
     planes);
  7. the list world (tests/test_fused_serving.py's store, rebuilt here
     with the port's MemStore): REGEX and CIDR lists fused beside STRINGS
     lists and deniers, served on the card against the CPU server on
     bags that hit the regex prefix, a truncated path, IPv4, IPv6,
     v4-mapped IPv6, malformed IP lengths and an absent source.ip; every
     kernel must launch (list_banks among them) and is held against its
     plain version on the B=2048 inputs (timed: the list_banks row);
     then (7b) list_banks (one launch for both banks) against its plain
     versions (the reference's formulas and the word formulation,
     list_banks_words_plain) on random inputs at B=2048 (64 REGEX lists
     over 256 patterns with truncated rows, 64 CIDR lists x 16 entries),
     on CIDR lists of E = 0, 1, 31, 32, 33 and 1,024 entries (mixed,
     v4-only and v6-only; K = 64 lists of 33) over value rows contiguous,
     at an odd address and strided, and on the sized list world (a
     1,024-entry blocklist, about 90 % v4, and a 64-pattern path list);
  8. the report path (this slice's main path): the telemetry world —
     make_store(10_000) plus Istio's default Mixer telemetry config
     (telemetry_world: six metrics into prometheus, the accesslog into
     stdio writing a temporary file; 10,005 rules, 8 lowered report
     instances, F = 60 field programs) — served through the port's
     RuntimeServer.report on the card against a device="cpu" server,
     capture sinks in place of both report handlers: the delivered
     instances equal in order and the prometheus series equal at
     B ∈ {64, 256, 2048}; one field_eval
     launch and one device-to-host copy per report trip, no rule-
     telemetry fold and unchanged rule counts; report() timed (p50 /
     p99, records/s, the five report stages, device busy and idle
     share); field_eval (every field an op program, no LEAF rows) held
     against its plain versions on the B=2048 trip's inputs (timed: its
     kernels-table row), then (8b) on edge inputs (every opcode, F = 0 /
     1 / 22 / 33, empty rows, ephemeral ids, full and narrowed byte
     planes) and at the launch plan's seams (SEAM_F fields x SEAM_B
     records, both stack instantiations, rows of a larger buffer,
     strided planes); then (8c) the host adapters on the card
     (adapters_phase; counters zeroed just before it): the port's
     RuntimeServer on the card against a device="cpu" one at B in
     {64, 256}. (a) The telemetry world as upstream writes it (the
     access log in stdio, writing a temporary file) with real handlers,
     and statsd, circonus, stackdriver and fluentd beside prometheus:
     report()'s stdio lines, statsd datagrams (an AF_UNIX socketpair
     seam), fluentd bytes (the same), circonus and stackdriver payloads
     (their transport seams) and prometheus series equal, one
     field_eval launch per report trip. (b) The APA world
     (make_store(10_000) + a kubernetesenv handler over 1,000 static
     pods, attribute_bindings, a deny rule on a bound label, a stdio
     access log of the bound attributes): bound attributes, check_many
     responses, rule counts, report()'s stdio lines and prometheus
     series equal; rows denied only through a bound attribute; one
     rule_match launch per preprocessed bag plus one per trip; a sample
     of the preprocess launches (K1, K2, K3) held against their plain
     versions. (c) On the same world OPA (expression and Rego mode) and
     servicecontrol check actions: rows denied by each and by the fused
     plan, and the B=256 check trip's launches held against their plain
     versions. Walls (p50 / p99), busy and idle share of every drive;
  9. the Quota() path (this slice's main path): the quota world —
     make_store(10_000) with its memquota limit set to the default quota
     of Istio's Bookinfo rate-limit sample (5,000 per 1 s window) — on
     the card against a device="cpu" server, each pool on an injected
     clock: 100,000 unique users fill the keymap (classic path, fast-mode
     flushes), then zipf(1.3) users at amount 1 through check_many +
     quota_fused (unit-mode flushes) and through
     check_batch_quota_instep, and at amounts 1-5 in-step (the seg kernel
     gated on the verdict), B in {64, 256, 2048}: every CheckResponse and
     QuotaResult equal; (d) then both servers' auditors read the pool:
     quota_conservation ok over the 100,000 live keys, its device_pools
     evidence equal on the card and the CPU, violated under
     quota_negative_cells_skew=1; mixed-amount classic flushes on the
     card alone;
     one quota_alloc launch per flush and per in-step trip; the plane
     reads back the grants of each key's window and no key gets more
     than 5,000 in one; quota_alloc against its plain version on a
     captured trip of every mode and the scan on a captured seg batch
     (timed), then (9b) on edge inputs, and on K9's launch paths: unit,
     seg and gated seg at 8,192 / 8,193 / 16,384 / 16,385 / 65,536 /
     65,537 zipf rows, one hot bucket whose run spans every block of the
     cluster, all-distinct buckets and K = 1, with its grids per call
     (one up to the cluster's 65,536 rows); walls of both paths, busy
     and idle share, quota_alloc per mode at 512 and 2048 rows; then
     (9c) quota_alloc above 8,192 rows (one cluster launch; the scan
     oracle on the multi-launch path) against its plain version at
     8,193 and 32,768 rows in unit, seg, scan and gated seg on zipf keys
     (the hottest key's run spans several scan tiles and a block seam),
     timed with its grids, bound, argsort yardstick and stage stamps
     (the probe build), and an in-step trip of 16,384 rows (one cluster
     launch) on a ServerArgs(max_batch=16384) server warmed at a 16,384
     bucket, equal to a CPU server result by result, with conservation
     on the card's plane;
  10. Pilot's route selection (BASELINE config 3): make_route_world
     (10_000) — 1,000 services, 10,000 route rules — in a RouteTable on
     the card against one on the CPU at B in {64, 256, 2048, 8192} of
     make_route_requests: selects index-equal to the CPU table and to
     select_host on 256 rows per B, the compact select (K10's
     route_densify) equal to the dense one, H2D bytes of both, exactly
     one rule_match, one atom_eval (the cookie-fallback atoms) and one
     route_winner launch per dense select and one more route_densify
     per compact one; p50 / p99, busy and idle share;
     every kernel of the B=2048 selects held against its plain version
     (timed), then (10b) route_winner / route_densify on edge inputs and
     a host-fallback world;
  11. Pilot's discovery service at bench.py's fleet (10,000 sidecars,
     2,500 route rules): a DiscoveryService on the card against one on
     the CPU, every sidecar's RDS byte-equal cold and warm, CDS / LDS /
     SDS for one node in every fourth namespace, the same node groups,
     8 rounds of
     one-namespace churn with every RDS equal after each and the scope
     program carried while its digest holds; one rule_match launch per
     batched generation, every one of them held against its plain
     versions and the largest timed; cold / warm poll rates and the
     route_eval stage; (e) two small make_store(40) servers (card, CPU)
     whose auditors attach the two services: plane_agreement ok over
     the scope program's pairs, pairs and evidence equal, a tampered
     pair (SEAMS.plane_pairs_extra) violated with a witness finding;
  12. sequence-parallel DFA matching (B13) on 8 virtual devices of card
     0, each its own stream: long subjects (2,048 rows of 8 KiB as 64
     chunks of 128 bytes; 256 rows at Envoy's 60 KiB header limit as 480
     chunks; 2,048 rows as 16 chunks, two per device) under
     tests/test_parallel.py's three patterns and the full-match regexes
     of make_route_world(10_000); sharded_dfa_match equal to dfa_scan
     (K2) over the unchunked rows and to Python re on 64 rows, with 8
     chunk_map and 8 + 1 (or 1) compose_maps launches per match; K12
     equal to its plain version on every launch of the drive and on
     edge inputs (SEQ_EDGE_*: S 1 to 240, a table over 227 KB read
     through L1, Lc of 13 to 512, odd addresses and strides, lengths 0,
     on seams and past the row, converging and never-converging DFAs;
     compose_maps over up to 300 chunks); each launch of one headline
     match timed alone on one stream (a CUDA graph of SEQ_GRAPH_REPS
     launches, its output held against the plain version) with its
     bound and the table lookups chunk_map's function needs;
  13. mesh serving (B14) on the same 8 virtual devices:
     make_store(10_000) under ServerArgs(mesh_shape=(4, 2), buckets=(64,
     256, 2048)) against a mesh-less server on the card, at B ∈ {64,
     256, 2048} of the headline and hit traffic: every response field,
     the packed pull byte for byte and the rule counts equal; per step 8
     rule_match (matched and err only, each held against its plain
     versions) and one mesh_fold launch, no verdict_fold; walls beside
     the mesh-less server's; mesh_stage_probe; K13 against its plain
     version on the B=2048 trip (timed; each entry point's device time
     a launch from profiler windows that saw every launch, the
     combine's bound and torch.amin yardstick), every shard's
     mesh_partial record against verdict_fold_words_plain over its
     window. Then (13b) make_rbac_store(1000) at (2, 4) (RBAC allow rows
     across mp slices), the headline world at (8, 1) and (1, 1),
     shard_engine_check on make_engine(10_000, with_quota=True) with
     small quotas, counters carried (one mesh_quota grid a dp replica),
     mesh_quota against quota_rank_plain on synthetic key columns on
     every path of the quota plan (MESH_QUOTA_B: B = 0 to 65,537, one
     block, a cluster, three launches; Q = 1 and 34; three batches
     carried; composite keys near INT32_MAX over a 2 x (2^30 - 1) counter
     plane), and mesh_combine (with mesh_quota)
     against combine_fold_records on edge records (COMBINE_EDGE_*: MP 1
     to 8, 0 / 1 / 33 RBAC specs, 0 / 3 quotas, row counts off a block,
     every int field INT32_MAX);
  14. the Check() resilience plane (resilience_phase): a card server with
     breaker_failures=2 and breaker_reset_s=0.2 beside a device="cpu"
     server on one make_store(10_000) store, batches of B=256 (half
     headline, half hit traffic), every response held against the CPU
     server's: (a) a clean trip; (b) one injected device failure the
     retry absorbs; (c) 2 x breaker_failures injected failures, two
     batches answered by the host oracle, the breaker opens; (d) a batch
     while it is open, answered by the oracle with no launch; (e) after
     breaker_reset_s the half-open probe, one device trip whose launches
     are held against their plain versions; (f) device and oracle both
     failing: fail_policy "closed" gives UnavailableError (14), "open"
     OK with a 1 s / 1-use TTL; check_many walls at B = 64 and 256; (g)
     brownout under 64 concurrent check() callers (some shed
     RESOURCE_EXHAUSTED, the admitted equal to the CPU server); (h)
     continuous batching across a config publish (each response from
     its generation, none stale after the publish returned); (i) a
     failing kernel build raises from RuntimeServer(device="cuda");
     (j) a device fault that CHAOS did not inject raises to the caller
     of the card server, with no retry, fallback or breaker failure.
     Every count of (a)-(g) and (j) — device trips, kernel launches,
     retries, fallbacks by reason, breaker transitions, CHAOS
     injections, sheds — equals what the injected schedule predicts.
     Every other phase ends at a gate (resilience_gate): no retry,
     fallback or breaker transition since the last gate and every CHAOS
     lever inert; and on the host plane (the adapter executor that every
     default server now runs its host actions on), no outcome other than
     ok since the last gate, the conservation ledger exact and every
     lane breaker closed; or the run fails naming the phase;
  14b. the adapter-executor plane (executor_phase): a card server with
     host_breaker_failures=2, host_breaker_reset_s=0.2 and 2 workers a
     lane beside a device="cpu" server with host_executor=False (the
     inline oracle) on make_store(10_000, host_overlay_every=5) (every
     fifth rule carries a host list action on cilist, provlist or
     dynpat), B = 64 and 256 bags aimed at the overlay rules: (a) clean,
     every response equal to the inline oracle's, one probe trip held
     against the plain versions; (b) one injected adapter failure the
     lane's retry absorbs; (c) a cilist adapter that raises on both
     servers: INTERNAL as the inline path answers it, the lane opens and
     the next batch answers UNAVAILABLE, the half-open probe closes it;
     (d) provlist wedged under a 50 ms batch deadline: its rows answer
     UNAVAILABLE (overrun / expired) within the deadline and a slack,
     the other handlers' rows unchanged, the late completions counted;
     (e) host_fail_policy "open": the wedged rows answer OK with a 1 s /
     1-use TTL; (f) quota() through the memquota lane under the server's
     default deadline, equal to the CPU server's grants, then a wedge,
     injected failures and an open lane answering quota_fallback's
     results, one K1 trip a call; (g) check-cache grants on a
     check_grants=True card server: TTLs in [floor, cap], revocation
     before the swap on a store delete, the first response of the new
     generation at the floor's bound; (h) the maintenance lane: a
     list provider refreshed every 0.1 s, a failing one counted with its
     last good list kept. Every count (outcomes by handler, retries,
     late completions, device trips, launches) equals what the schedule
     predicts; check_many walls with the executor on and off, and
     quota() walls; (g) also holds the grant server's auditor:
     grant_coherence ok across the store-delete publish, revocations
     keeping pace with publishes, and violated under grant_issue_skew;
  15. the config canary (canary_phase; counters zeroed just before it,
     every kernel of a replay trip must launch): (a) the three seeded
     pairs of testing/corpus.make_canary_snapshot_pairs on a card server
     (canary="gate", buckets (16, 32)) beside a device="cpu" server fed
     the same traffic: the divergent swap vetoed on both with equal
     reports (the planted rule under the planted kind, every status-flip
     exemplar oracle-confirmed), the old dispatcher serving on with the
     base's answers, the identical swap published with 0 divergences;
     canary="warn" publishes the divergent candidate, re-baselines the
     ring, and the refilled ring replays with 0 divergences; on the first
     pair a replay device fault CHAOS did not inject (rule_match made to
     raise) raises out of Controller.rebuild() with nothing published.
     (b) make_store(10_000) on a card server with canary="gate" at the
     defaults (capacity 2,048, replay_limit 1,024): 2,048 check_many
     rows (headline and hit traffic interleaved) recorded; a deny rule
     that fired, with `&& request.method == "DELETE"` appended, vetoed
     with exactly the status flips the saved corpus counts; the replay's
     launches exactly rule_match, dfa_scan, byte_pred, verdict_fold and
     check_pack, one trip a chunk, each held against its plain version;
     the saved corpus replayed by the CPU port equal to the card's
     replay; check_many and quota() after the veto unchanged; the same
     rules in reversed store order published with 0 divergences; replay
     wall and rows/s, publish delay and candidate host compile printed.
     (c) make_store(10_000, host_overlay_every=5) with the executor on:
     served rows carry host-overlay denials the recorded device planes
     lack, and the identical swap publishes with 0 divergences. Its
     gate starts from a reading taken after 14b, and the gate after
     every phase also fails on any canary evaluation that failed open
     (mixer_canary_errors_total);
  16. the sharded serving plane (shards_phase; counters zeroed just
     before it, every kernel of a bank trip, the pair world's and the
     quota leg's must launch): (a) make_fleet_store(100_000, 512, seed=7)
     on a card server with shards=8, replicas=2, telemetry off and
     scripts/shard_smoke.py's buckets (16,): the parent plan is never
     warmed and runs no trip, every bank plan is warmed before the lanes
     see it; every config rule in exactly one bank and LPT balance;
     check_many at B = 64, 256, 2,048 (512 rows of each held against
     oracle_check_statuses on status and global deny_rule; walls and the
     shard_dispatch / bank_check / fold split); 2,048 rows through both
     lanes at once from two threads equal to check_many; routing_stats
     with 0 misroutes and exactly the rows served; one B = 2,048 batch
     captured: one rule_match, verdict_fold and check_pack a (bank,
     chunk) trip, each held against its plain version. (b) the
     one-namespace constant edit of scripts/delta_smoke.py republished:
     1 bank recompiled, 7 carried as the same objects, plan stability
     byte-stable, the probe flips from deny to allow, oracle parity
     again. (c) make_store(10_000) with shards=0, replicas=2 and
     telemetry on: lane 0 on the published dispatcher, lane 1 on its own
     plan, responses and rule counts equal to a card server without
     replicas. (d) tests/test_sharding.py's pair world (240 rules, 3
     shards, 2 lanes) and global quota leg equal to the CPU port; an
     RBAC snapshot falls back to replica-only and says why; a fault
     CHAOS did not inject raises out of check_many; a CHAOS fault on one
     bank opens that bank's breaker alone and its oracle answers; (g) the
     fleet server's auditor: routing_conservation ok with rows_total the
     rows routed, a skewed misroute reading violated;
  17. the tail-latency forensics plane (forensics_phase; counters zeroed
     just before its drive, every kernel of a served trip must launch):
     make_store(10_000, host_overlay_every=5) on a card server with the
     executor on (scripts/forensics_smoke.py's lane breaker: 2 failures,
     0.4 s) beside a device="cpu" server with the inline host path.
     (a) 20 batches of B = 64 at a 10,000 ms threshold capture no
     exemplar and drop nothing; (g) one B = 256 batch with the recorder
     on at the default threshold equals the CPU server's, is captured,
     and its rule_match, verdict_fold, check_pack (and every other)
     launch is held against its plain version; (b) at a 250 ms threshold
     and a 600 ms deadline a wedged cilist adapter gives an exemplar
     whose top stage is host:cilist, e2e over the threshold, stage sum
     under e2e, with a chaos_wedge or breaker event beside it, and the
     lane closes again once unwedged; (c) at a near-zero threshold a
     store change published under check_many traffic (kept up 1 s past
     the publish) records config_publish for the new generation and
     prewarm events, and annotates an exemplar with one of them; (d) a
     torch.profiler capture of 1 s (RuntimeServer.capture_profile) while
     a thread serves B = 256: a Chrome trace whose kernels include
     rule_match, verdict_fold and check_pack, and a thread dump naming
     the batcher thread; (e) check_many B = 256 walls with the recorder
     off, on at a 10 s threshold and on at the default threshold, 7
     interleaved rounds (forensics_overhead_pct of each "on"); (f) the
     SLO scorecard, whose check_wire plane has data;
  17b. the mesh audit plane (audit_phase, on phase 17's servers; counters
     zeroed just before its drive, every kernel of a served trip must
     launch): (a) after check_many and a drained report() on both, the
     six invariants ok, no violation counted, explainability a vacuous
     1.0, the scorecard's audit plane ok, the card's snapshot equal to
     the CPU server's less walls; (b) cilist wedged for 6 checks under a
     600 ms deadline, then 3 injected device faults over 6 checks: both
     explained by named evidence, rate 1.0, none unexplained (the gate
     re-based after it); (c) report_accepted_skew=7 violated within
     stuck_floor_s + 10 s (healthy false, an audit_violation event,
     in_flight 7, the scorecard's audit plane miss), ok once cleared; (h)
     check_many B = 256 walls with the auditor on at 0.2 s and stopped,
     30 calls each (audit_overhead_pct, no limit), one evaluate(), the
     quota read and the plane check timed;
  18. print the kernels JSON line, the card line, and last the device
     line {"ok": true, "device": {...}}.
Exits non-zero, with no result line, when CUDA is absent or the package
is not beside this script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import logging
import os
import subprocess
import sys
import time

HEADLINE_RULES = 10_000
# the kernels of PolicyEngine.step (phases 3-4); the served path adds
# check_pack and rule_stats; the authz world (phase 6) runs no regex, the
# list world (phase 7) adds list_banks, and the report path (phase 8)
# runs the engine, check_pack and field_eval (REPORT_KERNELS)
ENGINE_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold")
SERVED_KERNELS = ENGINE_KERNELS + ("check_pack", "rule_stats")
AUTHZ_KERNELS = ("rule_match", "byte_pred", "verdict_fold", "check_pack",
                 "rule_stats", "atom_eval")
LIST_KERNELS = SERVED_KERNELS + ("list_banks",)
AUTHZ_ROLE_RULES = 1000     # BASELINE config 2: make_rbac_store(1000)
HEADLINE_B = 2048
E2E_BATCHES = (64, 256, 2048)
N_STEPS = 3                 # consecutive batches with quota carried
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
INT32_LANES_PER_SM = 64     # Hopper: one simple int32 op per lane per clock
OK, RESOURCE_EXHAUSTED = 0, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def int_ops_per_s() -> tuple[float, str]:
    """Peak simple int32 ops/s of card 0: INT32 lanes × SMs × the
    maximum SM clock (an add or compare is one op; the published
    67 TFLOP/s float32 rate counts an FMA as two on twice the lanes)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    rate = INT32_LANES_PER_SM * sms * mhz * 1e6
    return rate, f"{INT32_LANES_PER_SM} lanes x {sms} SMs x {mhz:.0f} MHz"


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call of fn over `iters` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float | None:
    """Mean device time per call of fn: the sum of every kernel and copy
    the profiler saw on the card during `iters` calls, over iters. None
    when the profiler recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / iters if us > 0 else None


PROFILE_WARMUP_CALLS = 3   # calls a profile window runs before it records


def profile_calls(fn, calls: int, warm: bool = True):
    """torch.profiler (CPU and CUDA) over `calls` calls of fn, each
    call's CUDA work finished before the next; PROFILE_WARMUP_CALLS calls
    run first with the profiler already tracing and are left out of the
    result. A window opened cold misses every kernel record of a call
    now and then, the more of them the more the process has run before
    (PERF.md §7): the warm-up keeps that start out of the window. With
    warm=False, the cold window the run used before: the calls alone,
    one synchronize after the last (kept to compare the two)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    if not warm:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return prof
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=PROFILE_WARMUP_CALLS,
                                   active=calls, repeat=1)) as prof:
        for _ in range(PROFILE_WARMUP_CALLS + calls):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def timed(fn, iters: int) -> tuple[float, float, str]:
    """→ (ms, call_ms, source): call_ms is CUDA-event time per call of a
    back-to-back loop (host launch cost included); ms is the profiler's
    device time per call, or call_ms where the profiler saw none."""
    call = time_ms(fn, iters)
    dev = device_ms(fn, max(iters // 5, 2))
    return (dev, call, "profiler") if dev is not None else \
        (call, call, "cuda_events")


def ms_label(how: str) -> str:
    """What a time from `timed` is, for a log line: only the profiler's
    sum is a kernel's device time; CUDA events around a loop of calls
    include the host's launch cost between them."""
    return "kernel" if how == "profiler" else "call (CUDA events)"


def graph_ms(fn, reps: int, want=None, replays: int = 5) -> float:
    """Device ms of one call of fn, alone on one stream: `reps` calls
    captured back to back into one CUDA graph, the graph replayed
    `replays` times between CUDA events, so no host launch cost sits
    between the calls. fn launches on the current stream and returns a
    tensor; it runs twice first, outside the graph. With `want`, the
    graph's last output is overwritten, the graph replayed once more and
    the output held against `want`: the graph holds the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        outs = [fn() for _ in range(reps)]
    if want is not None:
        last = outs[-1]
        last.copy_(~want if want.dtype == torch.bool else
                   torch.full_like(want, -1))
        g.replay()
        torch.cuda.synchronize()
        assert_equal("graph_ms replay", last, want)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def kernel_ms(fn, name: str, per_call: int, iters: int = 2,
              windows: int = 7, warm: bool = True) -> tuple[float, int]:
    """Device ms per launch of the `__global__` function `name` (a
    substring of the profiler's kernel name) made `per_call` times by
    each call of fn: the median over profiler windows of `iters` calls
    whose kernel-record count is exactly per_call * iters (the profiler
    drops records now and then: a window short of one is profiled again,
    up to 8 * windows windows) → (ms, windows kept). Raises, with the
    counts seen and, for the short windows, the launches each saw by
    device and stream (launch_sites), when no window saw every launch.
    warm=False profiles through the cold window (profile_calls)."""
    import torch
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    kept, seen, short = [], [], {}
    for _ in range(8 * windows):
        prof = profile_calls(fn, iters, warm)
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key]
        n = sum(e.count for e in evs)
        seen.append(n)
        if n == per_call * iters:
            kept.append(sum(e.self_device_time_total for e in evs) / 1e3 / n)
            if len(kept) == windows:
                break
        else:
            sites = json.dumps(launch_sites(prof, name), sort_keys=True)
            short[sites] = short.get(sites, 0) + 1
    if not kept:
        raise AssertionError(
            f"kernel_ms: no profiler window saw all {per_call * iters} "
            f"launches of {name} (saw {sorted(set(seen))}); the launches "
            f"by device and stream of the short windows (→ how many "
            f"windows saw that split): {short}; the calling thread's "
            f"stream {torch.cuda.current_stream()}")
    return sorted(kept)[len(kept) // 2], len(kept)


def cold_kernel_ms(fn, name: str, per_call: int) -> float | None:
    """kernel_ms through the cold window, beside the warm one in the same
    run, so a change of window shows as a change of time; None where no
    cold window saw every launch (of up to 24)."""
    try:
        return kernel_ms(fn, name, per_call, windows=3, warm=False)[0]
    except AssertionError:
        return None


def fmt_ms(ms: float | None) -> str:
    return "none whole" if ms is None else f"{ms:.5f} ms"


def launch_sites(prof, name: str) -> dict:
    """The profiled kernel records whose name holds `name`, counted by
    device and stream ("cuda:<device> stream <id>" → records), from
    prof.events()."""
    from torch.autograd import DeviceType
    out: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or name not in e.name:
            continue
        stream = getattr(e, "device_resource_id", None)
        if stream is None:
            stream = getattr(e, "thread", "?")
        key = f"cuda:{getattr(e, 'device_index', '?')} stream {stream}"
        out[key] = out.get(key, 0) + 1
    return out


def assert_equal(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype or \
            not torch.equal(got.cpu(), want.cpu()):
        raise AssertionError(f"{name}: kernel and plain version differ "
                             f"(shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, dtype {got.dtype} vs "
                             f"{want.dtype})")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def bound(bytes_moved: float, ops: float, int_rate: float
          ) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fold_work(matched, req, batch, params, c, quota0, quota1, got,
              lstate=None, list_kind=None) -> tuple[float, float]:
    """(bytes, ops) the verdict fold must move and do on this run's
    data. A request row reads, of the rules its namespace sees, the
    matched cells of the rules that carry a fused action (deny, list,
    rbac, quota) and the err cells of the rules the error count covers;
    the columns its RBAC specs' allow and guard rows name; the per-rule
    tables of the rules any row sees, the batch columns the list and
    quota banks name, the list-state bytes of its byte-level lists, and
    one read per quota counter an active row keys into plus one write
    per counter that changed (quota1 vs quota0); got is the fold's
    output."""
    import torch
    status = got[0]
    rule_ns = params["pe_rule_ns"]
    n_rules = rule_ns.shape[0]
    ns_ok = (rule_ns[None, :] == c.default_ns) | \
        (rule_ns[None, :] == req[:, None])
    active = matched & ns_ok
    acting = params["pe_deny_mask"].clone()
    if c.has_lists:
        acting[params["pe_list_rule"].long()] = True
    if c.has_rbac:
        acting[params["pe_rb_rule"].long()] = True
    if c.has_quota:
        acting[params["pe_q_rule"].long()] = True
    counted = params.get("pe_err_rule_mask")
    counted = torch.ones_like(acting) if counted is None else counted
    cells = int(ns_ok.sum())
    m_cells = int((ns_ok & acting[None, :]).sum())
    e_cells = int((ns_ok & counted[None, :]).sum())
    seen = int(ns_ok.any(0).sum())
    per_rule = [params[k] for k in ("pe_deny_mask", "pe_deny_status",
                                    "pe_deny_dur", "pe_deny_uses",
                                    "pe_err_rule_mask")
                if params.get(k) is not None]
    nb = matched.shape[0]
    b = nbytes(req, rule_ns, params["pe_ref_table"], *got) * 1.0
    b += m_cells + e_cells + seen * sum(t.element_size() for t in per_rule)
    ops = 2.0 * cells + m_cells + e_cells
    if c.has_rbac:
        cols = torch.cat([params["pe_rb_allow"].reshape(-1),
                          params["pe_rb_guard"]])
        n_cols = int(torch.unique(cols[cols < n_rules]).numel())
        b += nb * n_cols + nbytes(*(params[k] for k in (
            "pe_rb_rule", "pe_rb_dur", "pe_rb_guard", "pe_rb_allow")))
        ops += float(nb) * (params["pe_rb_allow"].numel() + 8 *
                            params["pe_rb_rule"].numel())
    if lstate is not None:
        b += nbytes(lstate)
    slots_p: set[int] = set()
    if c.has_lists:
        b += nbytes(*(params[k] for k in (
            "pe_list_ids", "pe_list_rule", "pe_list_slot", "pe_list_black",
            "pe_list_code", "pe_list_dur", "pe_list_uses")))
        l_slot = params["pe_list_slot"].long()
        slots = set(l_slot.tolist())
        slots_p |= slots
        b += nb * len(slots) * batch.ids.element_size()
        l_act = active[:, params["pe_list_rule"].long()] & \
            batch.present[:, l_slot]
        scan = torch.full_like(l_slot, params["pe_list_ids"].shape[1])
        if lstate is not None:      # a state byte, not an id scan
            scan = torch.where(list_kind != 0, 2, scan)
        ops += float((l_act.double() * scan.double()[None, :]).sum())
    if c.has_quota:
        if bool((params["pe_deny_status"] == RESOURCE_EXHAUSTED).any()) or \
                bool((params["pe_list_code"] == RESOURCE_EXHAUSTED).any()):
            raise AssertionError("fold_work: a deny or list status is "
                                 "RESOURCE_EXHAUSTED; quota rows unknown")
        q_slot = params["pe_q_slot"].long()
        b += nbytes(*(params[k] for k in (
            "pe_q_rule", "pe_q_slot", "pe_q_max", "pe_q_nb")))
        slots = set(q_slot.tolist())
        slots_p |= slots
        b += nb * len(slots) * batch.hash_ids.element_size()
        pre_ok = (status == OK) | (status == RESOURCE_EXHAUSTED)
        q_act = active[:, params["pe_q_rule"].long()] & \
            batch.present[:, q_slot] & pre_ok[:, None]
        n_q, n_b = quota0.shape
        key = torch.remainder(batch.hash_ids[:, q_slot],
                              params["pe_q_nb"][None, :]) + \
            torch.arange(n_q, device=quota0.device)[None, :] * n_b
        reads = int(torch.unique(key[q_act]).numel())
        writes = int((quota1 != quota0).sum())
        b += (reads + writes) * quota0.element_size()
        per_q = q_act.sum(0).double()
        ops += float((per_q * (per_q - 1) / 2).sum()) + float(per_q.sum())
    b += nb * len(slots_p) * batch.present.element_size()
    return b, ops


def quota_keys(matched, req, batch, params, c, n_buckets: int,
               lstate=None, list_kind=None):
    """int32 [Q, B]: the composite keys the fold's quota rank sorts —
    q·NB + the key's bucket where the row's status before quota is OK,
    the quota's rule matched and visible to the row's namespace and its
    key attribute present; INT32_MAX elsewhere (verdict_fold_plain's
    ckey, transposed)."""
    import dataclasses as dc
    import torch
    from istio_tpu_torch.models import policy_engine as pe
    q0 = torch.zeros(1, 1, dtype=torch.int32, device=matched.device)
    status = pe.verdict_fold_plain(matched, torch.zeros_like(matched), req,
                                   batch, params, q0,
                                   dc.replace(c, has_quota=False), lstate,
                                   list_kind)[0]
    rule = params["pe_q_rule"].long()
    rns = params["pe_rule_ns"][rule]
    vis = (rns[None, :] == c.default_ns) | (rns[None, :] == req[:, None])
    slot = params["pe_q_slot"].long()
    act = matched[:, rule] & vis & batch.present[:, slot] & \
        (status == OK)[:, None]
    n_q = int(rule.shape[0])
    key = torch.remainder(batch.hash_ids[:, slot], params["pe_q_nb"][None]) \
        + torch.arange(n_q, device=act.device)[None, :] * n_buckets
    return torch.where(act, key, pe.INT32_MAX).to(torch.int32).T \
        .contiguous()


def quota_grant_work(keys, q0, q1, over_rows: int) -> tuple[float, float]:
    """(bytes, ops) the quota rank / grant / commit must move and do on
    this run's data: every key read once, one counter read per distinct
    active key and one write per counter that changed (q1 vs q0), the
    status and deny rule written for each over-limit row, the q_max /
    q_rule tables; an op per key to find its group, one per group to
    grant and one per row to decide."""
    import torch
    from istio_tpu_torch.models.policy_engine import INT32_MAX
    live = keys[keys != INT32_MAX]
    groups = int(torch.unique(live).numel())
    changed = int((q1 != q0).sum())
    n_q = int(keys.shape[0])
    moved = keys.numel() * 4 + groups * 4 + changed * 4 + over_rows * 8 \
        + n_q * 8
    return float(moved), float(2 * live.numel() + groups)


def pack_work(inputs, got) -> tuple[float, float]:
    """(bytes, ops) check_pack must move and do on this run's data: a
    row reads the matched cells of the rules its namespace sees (the
    item ORs) and of the overlay columns, the per-rule namespace and
    mask words once, its verdict head and referenced bytes, and writes
    its packed column."""
    status, dur, uses, deny_rule, err_count, referenced, matched, req, t = \
        inputs
    ns_ok = (t.rule_ns[None, :] == t.default_ns) | \
        (t.rule_ns[None, :] == req[:, None])
    cells = float(ns_ok.sum())
    nb = matched.shape[0]
    n_ov = int(t.cols.numel())
    words = int(t.inst_bits.shape[1] + t.pred_bits.shape[1]) \
        if t.n_items else 0
    b = cells + nb * n_ov + nbytes(t.rule_ns, t.cols, status, dur, uses,
                                   deny_rule, err_count, req, got)
    b += int(t.rule_ns.numel()) * words * 4 + nb * t.n_cols
    ops = cells * (2 + words) + nb * (n_ov + t.n_words * 32)
    return b, ops


def plane_floor_ms(*planes) -> float:
    """The dense-plane floor of a fold or pack launch: every byte of its
    [B, R] planes read once at HBM_BYTES_PER_S. One visible rule in 23,
    interleaved (the headline world), puts a visible byte in every
    32-byte sector, so a byte-plane kernel can reach no less."""
    return nbytes(*planes) / HBM_BYTES_PER_S * 1e3


def pack_library_ms(inputs) -> tuple[float | None, str]:
    """check_pack's instance OR as one library call: torch._int_mm of the
    int8 active plane (matched and namespace-visible) [B, R] by the int8
    instance mask [R, n_items], the product the reference computes
    (istio_tpu/runtime/fused.py:345-349)."""
    import torch
    from istio_tpu_torch.ops.bytes_ops import unpack_bits
    _, _, _, _, _, _, matched, req, t = inputs
    if not t.n_items:
        return None, "no instance items"
    ns_ok = (t.rule_ns[None, :] == t.default_ns) | \
        (t.rule_ns[None, :] == req[:, None])
    ms, how = int_mm_ms(matched & ns_ok, unpack_bits(t.inst_bits,
                                                     t.n_items))
    return ms, how + " (the instance OR's product)"


def fold_words_check(tag: str, inputs, quota0, got, quota_got) -> None:
    """A verdict_fold launch's outputs (got, and the counters it left,
    quota_got) equal verdict_fold_words_plain's on the same inputs from
    the same counters quota0."""
    from istio_tpu_torch.models import policy_engine as pe
    matched, errp, req, batch, params, _, c, lstate, kind = inputs
    qw = quota0.clone()
    want = pe.verdict_fold_words_plain(matched, errp, req, batch, params, qw,
                                       c, lstate, kind)
    for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                           "referenced", "err_count"), got, want):
        assert_equal(f"{tag}.{part} (word plain)", g, w)
    assert_equal(f"{tag}.quota_counts (word plain)", quota_got, qw)


def rulestats_zeros(inputs):
    """Fresh (hit, deny, err) accumulators for a captured rule_stats
    launch."""
    import torch
    matched, n_slots = inputs[0], inputs[8]
    dev, r = matched.device, matched.shape[1]
    return (torch.zeros((n_slots, r), dtype=torch.int32, device=dev),
            torch.zeros((n_slots, r), dtype=torch.int32, device=dev),
            torch.zeros(r, dtype=torch.int32, device=dev))


def stats_work(inputs, delta) -> tuple[float, float]:
    """(bytes, ops) rule_stats must move and do on this run's data: the
    matched and err cells of the rules each real row's namespace sees,
    the per-rule tables once, the per-row verdict inputs, and a 4-byte
    read plus a 4-byte write of every accumulator cell the batch
    changes (delta: the batch's counts from zero)."""
    (matched, err, status, deny_rule, req, real, rule_ns, default_ns,
     n_slots, err_rows) = inputs
    ns_ok = (rule_ns[None, :] == default_ns) | \
        (rule_ns[None, :] == req[:, None])
    cells = float((ns_ok & real[:, None]).sum())
    touched = sum(int((d != 0).sum()) for d in delta)
    b = 2 * cells + nbytes(rule_ns, err_rows, status, deny_rule, req,
                           real) + 8 * touched
    ops = 4 * cells + 4 * matched.shape[0]
    return b, ops


def stats_library_ms(inputs) -> tuple[float, str]:
    """Time of one PyTorch call computing the hit fold of rule_stats
    (the [S, B] x [B, R] one-hot product of the reference's delta) on
    this launch's inputs: torch._int_mm on int8, or index_add_ where
    _int_mm refuses the shapes."""
    import torch
    (matched, err, status, deny_rule, req, real, rule_ns, default_ns,
     n_slots, err_rows) = inputs
    ns_ok = (rule_ns[None, :] == default_ns) | \
        (rule_ns[None, :] == req[:, None])
    active = (matched & ns_ok & real[:, None])
    slot = torch.where(req < 0, n_slots - 1, req.clamp(0, n_slots - 1))
    onehot = (slot[None, :] == torch.arange(
        n_slots, device=req.device)[:, None]).to(torch.int8)
    a8 = active.to(torch.int8)
    try:
        torch._int_mm(onehot, a8)
        torch.cuda.synchronize()
        return time_ms(lambda: torch._int_mm(onehot, a8), 50), \
            "torch._int_mm of the hit product"
    except RuntimeError:
        hit = torch.zeros((n_slots, matched.shape[1]), dtype=torch.int32,
                          device=matched.device)
        ai = active.to(torch.int32)
        sl = slot.long()
        return time_ms(lambda: hit.index_add_(0, sl, ai), 50), \
            "index_add_ of the hit plane"


def int_mm_ms(a, b01) -> tuple[float | None, str]:
    """Time of one torch._int_mm of the 0/1 planes a [m, k] and b01
    [k, n] as int8, zero-padded to the shapes it accepts (m > 16, k and
    n multiples of 8); None when it refuses them."""
    import torch
    m, k = a.shape
    n = b01.shape[1]
    up = lambda x, q: max(q, -(-x // q) * q)  # noqa: E731
    a8 = torch.zeros((max(m, 32), up(k, 16)), dtype=torch.int8,
                     device=a.device)
    a8[:m, :k] = a.to(torch.int8)
    b8 = torch.zeros((up(k, 16), up(n, 16)), dtype=torch.int8,
                     device=a.device)
    b8[:k, :n] = b01.to(torch.int8)
    try:
        torch._int_mm(a8, b8)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return None, f"torch._int_mm refused the shapes ({exc})"
    return time_ms(lambda: torch._int_mm(a8, b8), 50), \
        f"torch._int_mm int8 [{a8.shape[0]}, {a8.shape[1]}] x " \
        f"[{b8.shape[0]}, {b8.shape[1]}]"


def rbac_library_ms(matched, params) -> tuple[float | None, str]:
    """The RBAC allow product of the verdict fold as one library call:
    matched int8 [B, R] x the specs' one-hot allow matrix [R, n_rbac]."""
    import torch
    n_rules = matched.shape[1]
    allow = params["pe_rb_allow"].long()
    onehot = torch.zeros((n_rules + 2, allow.shape[0]), dtype=torch.bool,
                         device=matched.device)
    onehot[allow, torch.arange(allow.shape[0],
                               device=matched.device)[:, None]] = True
    ms, how = int_mm_ms(matched, onehot[:n_rules])
    return ms, how + " (RBAC allow product only)"


def list_work(inputs, lstate, err) -> tuple[float, float]:
    """(bytes, ops) a list_banks call must move and do on this run's
    data (a launch of both banks: the sum of its banks'). regex_list:
    each (row, list) reads the acceptance bytes of the
    list's patterns and the value's length, writes its state byte, and
    an err byte where und holds; cidr_list: each (row, list) reads the
    value's 16 bytes and length and writes its state byte, and compares
    every valid entry of the value's IP version up to the first hit (a
    masked compare of one 32-bit word for a v4 value, four for a v6
    one: 2 and 8 ops). The tables are read once, in words."""
    import torch
    if inputs[0] == "list_banks":     # both banks of one launch
        _, acc, sb, sl, ml, rx, cidr, _, _ = inputs
        parts = ([("regex_list", acc, sl, ml, rx, None, None)]
                 if rx is not None else []) + \
            ([("cidr_list", sb, sl, cidr, None)] if cidr is not None else [])
        work = [list_work(x, lstate, err) for x in parts]
        return float(sum(w[0] for w in work)), float(sum(w[1] for w in work))
    if inputs[0] == "regex_list":
        _, acc, str_lens, max_len, lists, _, _ = inputs
        pos, rule, bslot, ptr, pat, pdef = lists.on(acc.device)
        nb, nnz, j = acc.shape[0], pat.numel(), lists.n
        und = int(((lstate[:, pos.long()] & 2) != 0).sum())
        b = nb * (nnz + 5 * j) + und + nbytes(pos, rule, bslot, ptr, pat,
                                              pdef)
        return float(b), float(nb) * (nnz + 4 * j)
    _, str_bytes, str_lens, lists, _ = inputs
    pos, bslot, prefix, mask, valid, ent_v4 = lists.on(str_bytes.device)
    nb, k = str_bytes.shape[0], lists.n
    sl = bslot.long()
    vb = str_bytes[:, sl, :16]
    vl = str_lens[:, sl]
    is4 = vl == 4
    v4m = torch.tensor([0] * 10 + [255, 255], dtype=torch.uint8,
                       device=vb.device)
    val_v4 = is4 | ((vl == 16) & (vb[:, :, :12] == v4m).all(dim=2))
    mapped = torch.cat([v4m.expand(nb, k, 12), vb[:, :, :4]], dim=2)
    v = torch.where(is4[:, :, None], mapped, vb)
    cand = valid[None] & (ent_v4[None] == val_v4[:, :, None])  # [B, K, E]
    hit = cand & ((v[:, :, None, :] & mask[None]) == prefix[None]).all(3)
    first = torch.where(hit.any(2), hit.to(torch.int8).argmax(2) + 1,
                        hit.shape[2])
    upto = torch.arange(hit.shape[2], device=hit.device)[None, None, :] \
        < first[:, :, None]
    compared = cand & upto
    n4 = int((compared & val_v4[:, :, None]).sum())
    n6 = int(compared.sum()) - n4
    # the entry tables as words: a v4 net's word-3 mask and prefix, a v6
    # net's four of each
    tables = 8 * int((valid & ent_v4).sum()) + 32 * int((valid & ~ent_v4)
                                                        .sum())
    b = nb * k * 21 + nbytes(pos, bslot) + tables
    return float(b), float(nb * k * 16 + 2 * n4 + 8 * n6)


K1_EDGE_B = (0, 1, 31, 32, 33, 97)   # rule_match edge request counts


def k1_work(ids, present, em, en, params, c, planes) -> tuple[float, float]:
    """(bytes, ops) a rule_match call must move and do on these inputs:
    the ids and present columns its literals read and the ext planes,
    once each; the word tables (the literals, the conjunctions, and the
    rule OR's index rows of the planes asked for); each plane asked for
    written once. Operations: one compare per distinct literal per
    request, then per 32 requests one AND per conjunction literal, one OR
    per rule-OR index that is not the CONJ_FALSE pad, and two per err
    word."""
    import torch
    from istio_tpu_torch.compiler import ruleset
    want = [p in planes for p in ruleset.PLANES]
    need_n = want[1] or want[2]
    nb, n_rows = ids.shape[0], params["conj_m_idx"].shape[0]
    cols = torch.unique(torch.cat([c.lit_a, c.lit_b[c.n_cmp:]]))
    lit_true = 2 * c.n_lits + 1
    ands = float((c.conj_lit != lit_true).sum())
    idx = [params["conj_m_idx"]] + ([params["conj_n_idx"]] if need_n
                                    else [])
    ors = float(sum(int((t != c.n_sat).sum()) for t in idx))
    words = -(-nb // 32)
    b = (nb * int(cols.numel()) * 5 + nbytes(em, en, c.lit_a, c.lit_b,
                                             c.conj_lit, *idx)
         + nb * n_rows * sum(want))
    ops = float(nb) * (c.n_cmp + c.n_ss) + words * (
        ands + ors + (2.0 * n_rows if want[2] else 0.0))
    return float(b), ops


def k1_old_work(ids, present, em, en, params, c) -> tuple[float, float]:
    """(bytes, ops) of the K1 bound as PRs 1-9 stated it: every input
    and the reference's index tables once, all three planes written,
    and every request row charged the per-row walk of the fused table,
    lit_idx and both rule-OR tables."""
    tabs = [params[k] for k in ("eqc_col", "eqc_cid", "eqc_xor", "eqc_pad",
                                "lit_idx", "conj_m_idx", "conj_n_idx")]
    nb, n_rows = ids.shape[0], params["conj_m_idx"].shape[0]
    b = nbytes(ids, present, em, en, *tabs, c.eq_cols, c.eq_cids,
               c.eq_neg, c.ss_a, c.ss_b, c.ss_neg) + 3 * nb * n_rows
    ops = float(nb) * (params["eqc_col"].numel() * 3 +
                       params["lit_idx"].numel() +
                       2 * params["conj_m_idx"].numel() + 3 * n_rows)
    return float(b), ops


def k1_library_ms(ids, present, em, en, params, c) -> tuple[float, str]:
    """One PyTorch call for the rule-OR gather of K1: index_select of the
    reference's byte sat plane [B, n_sat + 2] by the flattened
    conj_m_idx (the plane itself is built outside the timing)."""
    import torch
    from istio_tpu_torch.compiler import ruleset
    sat = ruleset.sat_plane_plain(ids, present, em, en, params, c)
    idx = params["conj_m_idx"].reshape(-1)
    return time_ms(lambda: torch.index_select(sat, 1, idx), 50), \
        "torch.index_select(sat_ext, 1, conj_m_idx.flatten()) " \
        "(the rule-OR gather only)"


def rule_match_check(tag: str, inputs, edges: bool = False) -> int:
    """One captured rule_match launch replayed: the planes it asked for
    equal rule_match_plain's (the others None), the full triple too, and
    the word formulation's plain version equal to the reference's; with
    `edges`, every plane subset and the first K1_EDGE_B request rows of
    the same inputs as well. → cases checked."""
    import itertools
    from istio_tpu_torch.compiler import ruleset
    ids, present, em, en, params, c, *rest = inputs
    planes = rest[0] if rest else ruleset.PLANES
    want = ruleset.rule_match_plain(ids, present, em, en, params, c)
    words = ruleset.rule_match_words_plain(ids, present, em, en, params, c)
    subsets = [planes, ruleset.PLANES]
    if edges:
        subsets += [s for k in (1, 2) for s in
                    itertools.combinations(ruleset.PLANES, k)]
    n = 0
    for sub in subsets:
        got = ruleset.rule_match(ids, present, em, en, params, c, sub)
        for part, g, w, x in zip(ruleset.PLANES, got, want, words):
            assert_equal(f"{tag}.{part} (word plain)", x, w)
            if part not in sub:
                if g is not None:
                    raise AssertionError(f"{tag}.{part}: stored though "
                                         f"only {sub} were asked for")
                continue
            assert_equal(f"{tag}.{part} {'+'.join(sub)}", g, w)
        n += 1
    for b in (K1_EDGE_B if edges else ()):
        args = (ids[:b], present[:b], em[:b], en[:b], params, c)
        want = ruleset.rule_match_plain(*args)
        for part, g, w, x in zip(ruleset.PLANES, ruleset.rule_match(*args),
                                 want, ruleset.rule_match_words_plain(*args)):
            assert_equal(f"{tag}.{part} B={b}", g, w)
            assert_equal(f"{tag}.{part} B={b} (word plain)", x, w)
        n += 1
    return n


def prefilled_planes(b: int, x: int, seed: int, device):
    """bool [B, X] planes filled with a seeded pattern: what a subject
    group does not write must survive its launch."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    fill = torch.rand((2, b, x), generator=g) < 0.5
    return fill[0].to(device), fill[1].to(device)


def subject_plain(name: str, kind: str, args, planes=None):
    """The plain version of one K2 / K3 call (byte_pred_plain /
    dfa_scan_plain for the plane entry points; byte_lits_plain /
    dfa_lits_plain into `planes` for the literal ones)."""
    from istio_tpu_torch.ops import bytes_ops
    if kind == "plane":
        data, lens, table = args
        fn = bytes_ops.dfa_scan_plain if name == "dfa_scan" else \
            bytes_ops.byte_pred_plain
        return fn(data, lens, *table.on(data.device))
    data, lens, ok, err, table, lits, max_len, _, _ = args
    fn = bytes_ops.dfa_lits_plain if name == "dfa_scan" else \
        bytes_ops.byte_lits_plain
    fn(data, lens, ok, err, *table.on(data.device), *lits.on(data.device),
       max_len, *planes)
    return planes


def subject_kernel(name: str, kind: str, args, planes=None):
    """One K2 / K3 call through its wrapper (the kernel on the card)."""
    from istio_tpu_torch.ops import bytes_ops
    if kind == "plane":
        fn = bytes_ops.dfa_scan if name == "dfa_scan" else bytes_ops.byte_pred
        return fn(*args)
    data, lens, ok, err, table, lits, max_len, _, _ = args
    fn = bytes_ops.dfa_lits if name == "dfa_scan" else bytes_ops.byte_lits
    fn(data, lens, ok, err, table, lits, max_len, *planes)
    return planes


def subject_check(name: str, kind: str, args, tag: str, seed: int = 3):
    """A K2 / K3 call against its plain version, byte for byte: the
    plane, or both ext planes pre-filled with a seeded pattern (the
    group's columns written, every other column kept). → (got, want)
    as lists of tensors."""
    if kind == "plane":
        got = [subject_kernel(name, kind, args)]
        want = [subject_plain(name, kind, args)]
    else:
        em = args[7]
        fill = prefilled_planes(em.shape[0], em.shape[1], seed, em.device)
        got = list(subject_kernel(name, kind, args,
                                  [t.clone() for t in fill]))
        want = list(subject_plain(name, kind, args,
                                  [t.clone() for t in fill]))
    for part, g, w in zip(("m", "n") if kind == "lits" else ("plane",),
                          got, want):
        assert_equal(f"{tag}.{part}", g, w)
    return got, want


def subject_work(name: str, kind: str, args) -> tuple[float, float]:
    """(bytes, ops) of one K2 / K3 call on this run's data: the row
    bytes the function reads (each row's first min(len, L) bytes; every
    L bytes where a byte group has an exact pattern; where every pattern
    is a prefix, only those below the longest that fits,
    min(len, 4·row_words(L))), the lengths, the presence and error rows
    where the view has them, the tables, and the outputs (the [B, k]
    plane, or the 2·B·k literal bytes); byte groups compare their
    patterns' bytes on every row (B·Σk ops, 4 more a literal pair); a
    DFA walk maps each byte of a row to its class once and takes one
    transition a byte a pattern (steps·(N + 1) ops)."""
    import torch
    from istio_tpu_torch.ops import bytes_ops
    data, lens, table = (args[0], args[1], args[2]) if kind == "plane" \
        else (args[0], args[1], args[4])
    b, l = data.shape
    steps = int(torch.clamp(lens, 0, l).sum())
    n = table.n
    if name == "byte_pred":
        p, pl, kd = table.on(data.device)
        need = table.row_words(l)
        if bool((kd == bytes_ops.EXACT).any()):
            row_bytes = b * l
        elif need < -(-l // 4):     # a prefix-only group
            row_bytes = int(torch.clamp(lens, 0, min(4 * need, l)).sum())
        else:
            row_bytes = steps
        ops = float(b) * float(pl.sum())
        tabs = nbytes(table.words_on(data.device), pl, kd)
    else:
        row_bytes = steps
        ops = float(steps) * (n + 1)
        tabs = nbytes(*table.on(data.device))
    moved = row_bytes + nbytes(lens) + tabs
    if kind == "plane":
        return moved + b * n, ops
    ok, err, lits = args[2], args[3], args[5]
    masks = sum(b for t in (ok, err) if t is not None)
    return moved + masks + 2 * b * n + nbytes(*lits.on(data.device)), \
        ops + 4.0 * b * n


def subject_glue(name: str, args, planes) -> None:
    """The parent's formulation of a literal call: the plane kernel,
    then the literal pair in torch ops (write_lits_plain)."""
    from istio_tpu_torch.ops import bytes_ops
    data, lens, ok, err, table, lits, max_len, _, _ = args
    plane = subject_kernel(name, "plane", (data, lens, table))
    bytes_ops.write_lits_plain(plane, lens, ok, err, *lits.on(data.device),
                               max_len, *planes)


def subject_times(name: str, kind: str, args, int_rate: float):
    """Time one captured K2 / K3 call: the kernel (profiler device time
    and per-call time with its launch), its plain version and, for a
    literal call, the plane kernel plus torch glue that it replaces
    (the yardstick; no single PyTorch call computes these functions).
    → (ms, call, how, plain, bytes, ops, extra)."""
    from istio_tpu_torch import kernels
    from istio_tpu_torch.ops import bytes_ops
    data = args[0]
    b, l = data.shape
    planes = None
    if kind == "lits":
        em = args[7]
        planes = [t.clone() for t in prefilled_planes(
            em.shape[0], em.shape[1], 3, em.device)]
    ms, call, how = timed(lambda: subject_kernel(name, kind, args, planes),
                          200)
    plain, _, _ = timed(lambda: subject_plain(name, kind, args, planes), 20)
    moved, ops = subject_work(name, kind, args)
    n = (args[2] if kind == "plane" else args[4]).n
    plan = (bytes_ops.dfa_plan(b, l, n, data.device) if name == "dfa_scan"
            else bytes_ops.byte_plan(b, l, n, data.device))
    detail = {"entry": kernels.ENTRY_POINTS[name][kind == "lits"], "B": b, "L": l, "patterns": n, "ms": ms, "call_ms": call,
              "plain_ms": plain, "bytes": moved, "ops": ops,
              "aligned": bytes_ops._aligned(data), "plan": list(plan)}
    detail["bound_ms"], detail["bound_by"] = bound(moved, ops, int_rate)
    extra = {"call_detail": detail}
    glue_txt = ""
    if kind == "lits":
        glue, _, _ = timed(lambda: subject_glue(name, args, planes), 50)
        detail["glue_ms"] = extra["glue_ms"] = glue
        glue_txt = f"; plane kernel + torch glue {glue:.5f} ms"
    log(f"  {name}.{kind:<6} B={b} L={l} k={n} plan {list(plan)} "
        f"aligned {detail['aligned']}{glue_txt}")
    return ms, call, how, plain, moved, ops, extra


def check_kernels(captured: list, quota0, int_rate: float | None = None
                  ) -> list[dict]:
    """Phase 3: every captured launch, kernel vs plain (exact equality).
    With int_rate, also time both and compute each kernel's bound →
    the kernels table rows. quota0 is the quota state the captured
    verdict_fold launch started from."""
    import torch
    from istio_tpu_torch.compiler import ruleset
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.ops import bytes_ops, field_ops, route_ops
    from istio_tpu_torch.runtime import fused, rulestats

    rows: dict[str, dict] = {}
    for idx, (name, inputs) in enumerate(captured):
        tag = f"{name}#{idx}"
        lib, lib_call = None, None
        extra: dict = {}
        if name in ("dfa_scan", "byte_pred"):
            kind, *args = inputs
            tag = f"{name}.{kind}#{idx}"
            got, want = subject_check(name, kind, args, tag)
            if int_rate is None:
                continue
            ms, call, how, plain, b, ops, extra = subject_times(
                name, kind, args, int_rate)
            src, rep = ((f"{name}.cu", "istio_tpu/ops/bytes_ops.py:221")
                        if name == "dfa_scan" else
                        (f"{name}.cu", "istio_tpu/ops/bytes_ops.py:26"))
            err = int(sum(int((g != w).sum()) for g, w in zip(got, want)))
        elif name == "rule_match":
            ids, present, em, en, params, c, *rest = inputs
            planes = rest[0] if rest else ruleset.PLANES
            cases = rule_match_check(tag, inputs, int_rate is not None)
            if int_rate is None:
                continue
            log(f"  {tag:<16} {cases} cases equal to rule_match_plain and "
                "rule_match_words_plain (the captured planes "
                f"{'+'.join(planes)}, every subset, B = "
                f"{', '.join(map(str, K1_EDGE_B))})")
            ms, call, how = timed(lambda: ruleset.rule_match(
                ids, present, em, en, params, c, planes), 50)
            plain, _, _ = timed(lambda: ruleset.rule_match_plain(
                ids, present, em, en, params, c, planes), 10)
            b, ops = k1_work(ids, present, em, en, params, c, planes)
            ob, oops = k1_old_work(ids, present, em, en, params, c)
            extra["bound_old_ms"], extra["bound_old_by"] = bound(
                ob, oops, int_rate)
            extra["planes"] = list(planes)
            lib, lib_call = k1_library_ms(ids, present, em, en, params, c)
            src, rep = "rule_match.cu", "istio_tpu/compiler/ruleset.py:798"
            err = 0
        elif name == "verdict_fold":
            matched, errp, req, batch, params, _, c, lstate, kind = inputs
            qk, qp = quota0.clone(), quota0.clone()
            got = pe.verdict_fold(matched, errp, req, batch, params, qk, c,
                                  lstate, kind)
            want = pe.verdict_fold_plain(matched, errp, req, batch, params,
                                         qp, c, lstate, kind)
            fold_words_check(tag, inputs, quota0, got, qk)
            for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                                   "referenced", "err_count"), got, want):
                assert_equal(f"{tag}.{part}", g, w)
            assert_equal(f"{tag}.quota_counts", qk, qp)
            if int_rate is None:
                continue
            scratch = quota0.clone()
            ms, call, how = timed(lambda: pe.verdict_fold(
                matched, errp, req, batch, params, scratch, c, lstate,
                kind), 50)
            plain, _, _ = timed(lambda: pe.verdict_fold_plain(
                matched, errp, req, batch, params, scratch, c, lstate,
                kind), 10)
            b, ops = fold_work(matched, req, batch, params, c, quota0, qk,
                               got, lstate, kind)
            extra["floor_ms"] = plane_floor_ms(matched, errp)
            if c.has_quota and matched.shape[0]:
                # each grid alone: the row fold, and the quota launch with
                # its bound and the stable argsort of the same keys
                fold = lambda: pe.verdict_fold(  # noqa: E731
                    matched, errp, req, batch, params, scratch, c, lstate,
                    kind)
                extra["row_fold_ms"] = kernel_ms(fold, "row_fold", 1)[0]
                per = pe.quota_plan(int(matched.shape[0])).launches
                extra["quota_ms"] = kernel_ms(fold, "quota_grant",
                                              per)[0] * per
                cold = cold_kernel_ms(fold, "quota_grant", per)
                extra["cold_window"] = {
                    "row_fold_ms": cold_kernel_ms(fold, "row_fold", 1),
                    "quota_ms": None if cold is None else cold * per}
                keys = quota_keys(matched, req, batch, params, c,
                                  int(quota0.shape[1]), lstate, kind)
                qb, qo = quota_grant_work(
                    keys, quota0, qk,
                    int((got[0] == RESOURCE_EXHAUSTED).sum()))
                extra["quota_bound_ms"], extra["quota_bound_by"] = bound(
                    qb, qo, int_rate)
                flat = keys.reshape(-1)
                extra["quota_argsort_ms"] = time_ms(
                    lambda: torch.argsort(flat, stable=True), 50)
            if c.has_rbac:
                lib, lib_call = rbac_library_ms(matched, params)
            src, rep = ("verdict_fold.cu",
                        "istio_tpu/models/policy_engine.py:379")
            err = int(sum(int((g.float() != w.float()).sum())
                          for g, w in zip(got, want)))
        elif name == "check_pack":
            got = fused.check_pack(*inputs)
            want = fused.check_pack_plain(*inputs)
            assert_equal(tag, got, want)
            assert_equal(f"{tag} (word plain)", got,
                         fused.check_pack_words_plain(*inputs))
            if int_rate is None:
                continue
            ms, call, how = timed(lambda: fused.check_pack(*inputs), 200)
            plain, _, _ = timed(lambda: fused.check_pack_plain(*inputs), 20)
            b, ops = pack_work(inputs, got)
            extra["floor_ms"] = plane_floor_ms(inputs[6])
            lib, lib_call = pack_library_ms(inputs)
            src, rep = "check_pack.cu", "istio_tpu/runtime/fused.py:315"
            err = int((got != want).sum())
        elif name == "rule_stats":
            accs = [rulestats_zeros(inputs) for _ in range(2)]
            rulestats.rule_stats(*inputs, *accs[0])
            rulestats.rule_stats_plain(*inputs, *accs[1])
            for part, g, w in zip(("hit", "deny", "err"), *accs):
                assert_equal(f"{tag}.{part}", g, w)
            if int_rate is None:
                continue
            scratch = rulestats_zeros(inputs)
            ms, call, how = timed(
                lambda: rulestats.rule_stats(*inputs, *scratch), 200)
            plain, _, _ = timed(
                lambda: rulestats.rule_stats_plain(*inputs, *scratch), 20)
            b, ops = stats_work(inputs, accs[1])
            lib, lib_call = stats_library_ms(inputs)
            src, rep = ("rule_stats.cu",
                        "istio_tpu/runtime/rulestats.py:165")
            err = int(sum(int((g != w).sum()) for g, w in zip(*accs)))
        elif name == "list_banks":
            kind, acc, sb, sl, ml, rx, cidr, ls0, err0 = inputs
            if err0 is None:
                err0 = torch.zeros((ls0.shape[0], 0), dtype=torch.bool,
                                   device=ls0.device)
            run = lambda ls, e: bytes_ops.list_banks(  # noqa: E731
                acc, sb, sl, ml, rx, cidr, ls, e)

            def run_plain(ls, e):
                if rx is not None:
                    bytes_ops.regex_list_plain(acc, sl, ml,
                                               *rx.on(acc.device), ls, e)
                if cidr is not None:
                    bytes_ops.cidr_list_plain(sb, sl, *cidr.on(sb.device),
                                              ls)
            # from a zero state plane and the err plane as captured
            outs = [(torch.zeros_like(ls0), err0.clone()) for _ in range(3)]
            run(*outs[0])
            run_plain(*outs[1])
            bytes_ops.list_banks_words_plain(acc, sb, sl, ml, rx, cidr,
                                             *outs[2])
            for part, g, w, x in zip(("lstate", "err"), *outs):
                assert_equal(f"{tag}.{part}", g, w)
                assert_equal(f"{tag}.{part} (word plain)", x, w)
            if int_rate is None:
                continue
            scratch = (torch.zeros_like(ls0), err0.clone())
            ms, call, how = timed(lambda: run(*scratch), 200)
            plain, _, _ = timed(lambda: run_plain(*scratch), 20)
            b, ops = list_work(inputs, *outs[0])
            if rx is not None:
                _, _, _, ptr, pat, _ = rx.on(acc.device)
                owner = torch.repeat_interleave(
                    torch.arange(rx.n, device=acc.device),
                    (ptr[1:] - ptr[:-1]).long())
                m01 = torch.zeros((acc.shape[1], rx.n), dtype=torch.bool,
                                  device=acc.device)
                m01[pat.long(), owner] = True
                lib, lib_call = int_mm_ms(acc, m01)
                lib_call += " (REGEX hit product only)"
            extra["lanes"] = list(bytes_ops.list_plan(rx, cidr,
                                                      int(ls0.shape[0])))
            src, rep = ("list_banks.cu",
                        "istio_tpu/models/policy_engine.py:439")
            err = int(sum(int((g != w).sum()) for g, w in zip(*outs[:2])))
        elif name == "field_eval":
            batch, prog = inputs
            got = field_ops.field_eval(batch, prog)
            want = field_ops.field_eval_plain(batch, prog)
            assert_equal(tag, got, want)
            assert_equal(f"{tag} (op table)", got,
                         field_ops.field_eval_ops_plain(batch, prog))
            if int_rate is None:
                continue
            ms, call, how = timed(
                lambda: field_ops.field_eval(batch, prog), 200)
            plain, _, _ = timed(
                lambda: field_ops.field_eval_plain(batch, prog), 20)
            b, ops = field_work(batch, prog, got)
            lib, lib_call = program_library_ms(batch, prog.prog)
            src, rep = ("field_eval.cu",
                        "istio_tpu/runtime/report_lower.py:73")
            err = int((got != want).sum())
        elif name == "atom_eval":
            batch, atoms, em, en = inputs
            got, want = atom_eval_checked(tag, batch, atoms, em.shape[1])
            if int_rate is None:
                continue
            scratch = (torch.zeros_like(em), torch.zeros_like(en))
            ms, call, how = timed(
                lambda: field_ops.atom_eval(batch, atoms, *scratch), 200)
            plain, _, _ = timed(lambda: field_ops.atom_eval_plain(
                batch, atoms, *scratch), 10)
            b, ops = atom_work(batch, atoms)
            lib, lib_call = program_library_ms(batch, atoms.prog)
            src, rep = "field_eval.cu", "istio_tpu/compiler/tensor_expr.py:291"
            err = int(sum(int((g != w).sum()) for g, w in zip(got, want)))
        elif name == "quota_alloc":
            mode, before, *qrows, gate = inputs
            tag = f"{name}.{mode}" + ("+gate" if gate is not None else "")
            if quota_alloc_check(tag, mode, before, qrows, gate) and \
                    mode == "seg":
                # the sequential oracle on the same captured seg batch
                quota_alloc_check(f"{tag}.scan", "scan", before, qrows, gate)
            if int_rate is None:
                continue
            ms, call, how, plain, b, ops, lib, lib_call = quota_alloc_times(
                mode, before, qrows, gate)
            src, rep = "quota_alloc.cu", QUOTA_REPLACES[
                "instep" if gate is not None else mode]
            err = 0
        elif name == "route_select":
            kind, *args = inputs
            tag = f"{name}.{kind}"
            err = 0
            if kind == "winner":
                matched, weight, default = args
                got = route_ops.route_winner(matched, weight, default)
                want = route_ops.route_winner_plain(matched, weight,
                                                    default)
                assert_equal(tag, got, want)
                if int_rate is None:
                    continue
                ms, call, how = timed(lambda: route_ops.route_winner(
                    matched, weight, default), 200)
                plain, _, _ = timed(lambda: route_ops.route_winner_plain(
                    matched, weight, default), 20)
                b = nbytes(matched, weight, got)
                ops = 2.0 * matched.numel()     # a select and a compare
                lib = time_ms(lambda: torch.max(
                    matched.int() * weight, dim=1), 50)
                lib_call = ("torch.max(matched.int() * weight, dim=1) "
                            "(the max only)")
                rep = "istio_tpu/pilot/route_nfa.py:115"
            else:
                flat, lens16, pres, n_cols, max_len = args
                got = route_ops.route_densify(flat, lens16, pres, n_cols,
                                              max_len)
                want = route_ops.route_densify_plain(flat, lens16, pres,
                                                     n_cols, max_len)
                for part, g, w in zip(("str_bytes", "str_lens", "present"),
                                      got, want):
                    assert_equal(f"{tag}.{part}", g, w)
                if int_rate is None:
                    continue
                ms, call, how = timed(lambda: route_ops.route_densify(
                    flat, lens16, pres, n_cols, max_len), 200)
                plain, _, _ = timed(lambda: route_ops.route_densify_plain(
                    flat, lens16, pres, n_cols, max_len), 20)
                # the flat bytes the lens cover, the lens and presence
                # in; the dense planes out
                b = int(lens16.int().clamp(min=0).sum()) + \
                    nbytes(lens16, pres, *got)
                ops = float(got[0].numel())     # one select per byte out
                flat_lens = lens16.reshape(-1).int()
                lib = time_ms(lambda: torch.cumsum(flat_lens, 0), 200)
                lib_call = "torch.cumsum of the lens (the offsets only)"
                rep = "istio_tpu/pilot/route_nfa.py:270"
            src = "route_select.cu"
        else:
            raise AssertionError(f"unknown kernel {name}")
        bms, by = bound(b, ops, int_rate)
        log(f"  {tag:<16} {ms_label(how)} {ms:9.5f} ms (per call incl. "
            f"launch {call:8.5f})   plain {plain:9.5f} ms   bound "
            f"{bms:8.5f} ms "
            f"({by}; {b:.0f} B, {ops:.0f} ops)   equal: yes   [{how}]"
            + ("" if "floor_ms" not in extra else
               f"   dense-plane floor {extra['floor_ms']:.5f} ms")
            + ("" if "quota_ms" not in extra else
               f"   row fold {extra['row_fold_ms']:.5f} ms, quota launch "
               f"{extra['quota_ms']:.5f} ms (bound "
               f"{extra['quota_bound_ms']:.6f}, "
               f"{extra['quota_bound_by']}; stable argsort of the keys "
               f"{extra['quota_argsort_ms']:.5f}); cold windows: row fold "
               f"{fmt_ms(extra['cold_window']['row_fold_ms'])}, quota "
               f"launch {fmt_ms(extra['cold_window']['quota_ms'])}")
            + ("" if lib is None else
               f"   library {lib:9.5f} ms ({lib_call})"))
        row = rows.setdefault(name, {
            "name": name, "route": "cuda",
            "source": f"istio_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": 0, "max_abs_err": 0, "ms": 0.0, "plain_ms": 0.0,
            "bound_ms": 0.0, "bound_by": by, "library_ms": lib,
            "library_call": lib_call,
            "calls_per_step": 0, "grid_launches": 0, "call_ms": 0.0,
            "ms_source": how, "bytes": 0.0, "ops": 0.0})
        # a kernel called more than once per step (byte_pred: one call
        # per subject) reports the sum over its calls, and the bound of
        # their summed work
        row["ms"] += ms
        row["call_ms"] += call
        row["plain_ms"] += plain
        row["bytes"] += b
        row["ops"] += ops
        row["bound_ms"], row["bound_by"] = bound(row["bytes"], row["ops"],
                                                 int_rate)
        row["max_abs_err"] = max(row["max_abs_err"], err)
        glue = extra.pop("glue_ms", None)
        detail = extra.pop("call_detail", None)
        row.update(extra)
        if glue is not None:
            row["glue_ms"] = row.get("glue_ms", 0.0) + glue
        if detail is not None:
            row.setdefault("calls", []).append({"tag": tag, **detail})
        row["calls_per_step"] += 1
        if row["library_ms"] is None and lib is not None:
            row["library_ms"], row["library_call"] = lib, lib_call
    return list(rows.values())


# verdict_fold / mesh_partial / check_pack edge inputs (phase 3d): request
# counts either side of a warp and a block; engines whose rule axis is 0
# mod 16 (make_engine(10_000)), 8 mod 16 (1,000) and odd (1,001), each with
# quotas (the in-fold rank / grant / commit: two grids a call); windows of the
# rule axis that start off a 32-rule word and have odd widths; request
# namespaces: unknown, the pad namespace, the default, the largest id and
# one past it, and the int32 extremes (FOLD_EDGE_NS, the ids filled in per
# world)
FOLD_EDGE_B = (0, 1, 7, 8, 9, 31, 32, 33, 97, 2048)
FOLD_EDGE_RULES = (10_000, 1000, 1001)
FOLD_EDGE_NS = (-1, -7, 0, "max", "max+1", -2 ** 31, 2 ** 31 - 1)


def edge_namespaces(req, max_id: int):
    """req with every other row's namespace one of FOLD_EDGE_NS."""
    import torch
    vals = [max_id if v == "max" else max_id + 1 if v == "max+1" else v
            for v in FOLD_EDGE_NS]
    out = req.clone()
    n = out.shape[0]
    pick = torch.tensor([vals[i % len(vals)] for i in range(0, n, 2)],
                        dtype=torch.int32)
    out[0::2] = pick.to(out.device)
    return out


def fold_edge_checks(worlds: dict) -> int:
    """Phase 3d: verdict_fold, mesh_partial and check_pack against their
    plain versions (and the fold against verdict_fold_words_plain) on
    edge inputs: for each engine of `worlds` (rules → a cuda engine), a
    captured B = 2,048 step's planes cut to every FOLD_EDGE_B and given
    FOLD_EDGE_NS namespaces, from the same quota counters (two grids a
    call where B > 0: the row fold and one quota launch); mesh_partial
    over windows of the rule axis that start off a word boundary, whose
    kernel records combine into the unsharded fold; check_pack on random
    instance and predicate masks of 3 and 11 instance words (registers
    alone, and the warp's shared words) over the world's namespaces.
    → cases."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.parallel import mesh_fold as mf
    from istio_tpu_torch.runtime import fused
    n = 0
    rng = np.random.default_rng(31)
    for n_rules, eng in worlds.items():
        bags, req = hit_batch(eng, n_rules, HEADLINE_B, seed=700 + n_rules)
        batch = eng.tensorizer.tensorize(bags).to("cuda")
        req = torch.as_tensor(req).to("cuda")
        with kernels.launches.capture() as cap:
            eng.check(batch, req)
        torch.cuda.synchronize()
        ((_, ins),) = [x for x in cap if x[0] == "verdict_fold"]
        matched, errp, _, _, params, _, c, lstate, kind = ins
        r = matched.shape[1]
        max_id = max(eng.ruleset.ns_ids.values())
        q0 = eng.quota_counts.clone()
        for b in FOLD_EDGE_B:
            rq = edge_namespaces(req[:b], max_id)
            bt = batch.rows(0, b)
            args = (matched[:b], errp[:b], rq, bt, params)
            ls = None if lstate is None else lstate[:b]
            qk, qp, qw = q0.clone(), q0.clone(), q0.clone()
            g0 = kernels.launches.grids["verdict_fold"]
            got = pe.verdict_fold(*args, qk, c, ls, kind)
            grids = kernels.launches.grids["verdict_fold"] - g0
            want = pe.verdict_fold_plain(*args, qp, c, ls, kind)
            words = pe.verdict_fold_words_plain(*args, qw, c, ls, kind)
            tag = f"fold edge R={r} B={b}"
            for part, g, w, x in zip(("status", "dur", "uses", "deny_rule",
                                      "referenced", "err_count"), got, want,
                                     words):
                assert_equal(f"{tag}.{part}", g, w)
                assert_equal(f"{tag}.{part} (word plain)", x, w)
            assert_equal(f"{tag}.quota_counts", qk, qp)
            assert_equal(f"{tag}.quota_counts (word plain)", qw, qp)
            if grids != (2 if b else 0):
                raise AssertionError(f"{tag}: {grids} grids, want "
                                     f"{2 if b else 0}")
            n += 1
        # mesh_partial over windows off a word boundary, odd widths
        cuts = [0, 37, 101, r // 2 + 3, r - 5, r]
        rq = edge_namespaces(req, max_id)
        n_q = int(q0.shape[0]) if c.has_quota else 0
        recs, flags = [], []
        for r0, r1 in zip(cuts, cuts[1:]):
            part = mf.FoldPart(None, r0, matched[:, r0:r1].contiguous(),
                               errp[:, r0:r1].contiguous(), lstate, rq,
                               batch, params, kind)
            rec, flg, _ = mf.partial_record(part, r, c, n_q)
            want_r, want_f = pe.verdict_fold_words_plain(
                part.matched, part.err, rq, batch, params, None, c, lstate,
                kind, window=(r0, r1))
            nf = want_f.shape[1]
            tag = f"mesh_partial edge R={r} [{r0}, {r1})"
            assert_equal(f"{tag}.rec", rec, want_r)
            assert_equal(f"{tag}.flags", flg[:, :nf].contiguous(), want_f)
            recs.append(rec)
            flags.append(flg[:, :nf])
            n += 1
        qc, qp = q0.clone(), q0.clone()
        combined = pe.combine_fold_records(recs, flags, rq, batch, params,
                                           qc, c)
        want = pe.verdict_fold_plain(matched, errp, rq, batch, params, qp, c,
                                     lstate, kind)
        for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                               "referenced", "err_count"), combined, want):
            assert_equal(f"mesh_partial edge R={r} combined.{part}", g, w)
        assert_equal(f"mesh_partial edge R={r} combined.quota_counts", qc,
                     qp)
        # check_pack over the world's namespaces, 3 and 11 instance words
        for n_cols, n_maps, n_ov in ((26, 40, 70), (300, 37, 5)):
            n_items = n_cols + n_maps
            inst = rng.random((r, n_items)) < 0.02
            inst[::5, 31] = True
            t = fused.PackTables.of(
                eng.ruleset.rule_ns, 0, inst, rng.random((r, n_maps)) < 0.05,
                rng.choice(r, size=n_ov, replace=False), n_cols, n_items,
                "cuda")
            g = torch.Generator(device="cuda").manual_seed(n_items)
            for b in FOLD_EDGE_B:
                rq = edge_namespaces(req[:b], max_id)
                ins = (torch.randint(0, 14, (b,), dtype=torch.int32,
                                     device="cuda", generator=g),
                       torch.rand(b, device="cuda", generator=g),
                       torch.randint(0, 1 << 30, (b,), dtype=torch.int32,
                                     device="cuda", generator=g),
                       torch.randint(-1, r + 1, (b,), dtype=torch.int32,
                                     device="cuda", generator=g),
                       torch.tensor(5, dtype=torch.int32, device="cuda"),
                       torch.rand(b, n_cols, device="cuda",
                                  generator=g) < 0.5,
                       matched[:b], rq, t)
                got = fused.check_pack(*ins)
                tag = f"check_pack edge R={r} B={b} items={n_items}"
                assert_equal(tag, got, fused.check_pack_plain(*ins))
                assert_equal(f"{tag} (word plain)", got,
                             fused.check_pack_words_plain(*ins))
                n += 1
    return n


# whole folds with quotas on the quota plan's paths (phase 3d): one block
# (B <= QUOTA_BLOCK_ROWS), one past it (a cluster of 2) and B = 8,192 (a
# cluster of 4), on make_engine(1,000) with limits of 3 so that groups
# run over their limit inside a batch, three batches carried
QUOTA_FOLD_B = (1, 33, 2048, 2049, 8192)
QUOTA_FOLD_RULES = 1000


def quota_fold_checks() -> int:
    """Phase 3d: verdict_fold with quotas at QUOTA_FOLD_B rows of the hit
    traffic on make_engine(QUOTA_FOLD_RULES, quota_max=3), three batches
    with the counters carried: every verdict field and the counters equal
    to verdict_fold_plain (and the quota step alone, over the fold's
    keys, equal to quota_grant_plain), two grids a call, and some rows
    RESOURCE_EXHAUSTED → cases."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.testing import workloads
    eng = workloads.make_engine(QUOTA_FOLD_RULES, with_quota=True,
                                device="cuda", quota_max=3)
    n = exhausted = 0
    for b in QUOTA_FOLD_B:
        qk = eng.quota_counts.clone()
        qp = qk.clone()
        for s in range(N_STEPS):
            bags, req = hit_batch(eng, QUOTA_FOLD_RULES, b,
                                  seed=400 + 7 * b + s)
            batch = eng.tensorizer.tensorize(bags).to("cuda")
            req = torch.as_tensor(req).to("cuda")
            with kernels.launches.capture() as cap:
                eng.check(batch, req)
            torch.cuda.synchronize()
            ((_, ins),) = [x for x in cap if x[0] == "verdict_fold"]
            m, e, rq, bt, params, _, c, ls, kind = ins
            g0 = kernels.launches.grids["verdict_fold"]
            got = pe.verdict_fold(m, e, rq, bt, params, qk, c, ls, kind)
            grids = kernels.launches.grids["verdict_fold"] - g0
            q_before = qp.clone()
            want = pe.verdict_fold_plain(m, e, rq, bt, params, qp, c, ls,
                                         kind)
            tag = f"quota fold B={b} step {s}"
            for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                                   "referenced", "err_count"), got, want):
                assert_equal(f"{tag}.{part}", g, w)
            assert_equal(f"{tag}.quota_counts", qk, qp)
            if grids != 2:
                raise AssertionError(f"{tag}: {grids} grids, want 2")
            # the quota step alone, in the kernel's own formulation
            keys = quota_keys(m, rq, bt, params, c, int(qp.shape[1]), ls,
                              kind)
            keys = torch.where(keys == pe.INT32_MAX, -1, keys)
            pre = pe.verdict_fold_plain(m, e, rq, bt, params,
                                        q_before.clone(),
                                        dataclasses.replace(
                                            c, has_quota=False), ls, kind)
            st, rule, q2 = pre[0].clone(), pre[3].clone(), q_before.clone()
            pe.quota_grant_plain(keys, q2, params["pe_q_max"],
                                 params["pe_q_rule"], st, rule)
            assert_equal(f"{tag}.status (grant plain)", got[0], st)
            assert_equal(f"{tag}.deny_rule (grant plain)", got[3], rule)
            assert_equal(f"{tag}.quota_counts (grant plain)", qk, q2)
            exhausted += int((got[0] == RESOURCE_EXHAUSTED).sum())
            n += 1
    if not exhausted:
        raise AssertionError("quota fold edge: no row ran over its limit")
    return n


def headline_batch(engine, b: int):
    """bench.py's Check() traffic: make_bags(b) and make_request_ns."""
    from istio_tpu_torch.testing import workloads
    return (workloads.make_bags(b),
            workloads.make_request_ns(engine, b))


def hit_batch(engine, n_rules: int, b: int, seed: int):
    import numpy as np
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.testing import workloads
    dicts, ns = workloads.make_hit_requests(n_rules, b, seed=seed)
    bags = [bag_from_mapping(d) for d in dicts]
    req = np.asarray([engine.ruleset.namespace_id(x) for x in ns], np.int32)
    return bags, req


FIELDS = ("status", "valid_duration_s", "valid_use_count", "referenced",
          "matched", "err", "deny_rule", "err_count")


def compare_step(gpu, cpu, bags, req, label: str):
    """One step of the kernel path (gpu engine) and the plain path (cpu
    engine) from the same quota state; → the gpu verdict."""
    import torch
    cpu.quota_counts.copy_(gpu.quota_counts.cpu())
    batch = gpu.tensorizer.tensorize(bags)
    vg = gpu.check(batch.to("cuda"), req)
    vc = cpu.check(batch, req)
    torch.cuda.synchronize()
    for f in FIELDS:
        assert_equal(f"{label}.{f}", getattr(vg, f).cpu(), getattr(vc, f))
    assert_equal(f"{label}.quota_counts", gpu.quota_counts.cpu(),
                 cpu.quota_counts)
    for f in ("status", "valid_use_count", "deny_rule"):
        t = getattr(vg, f)
        assert t.shape == (len(bags),) and t.dtype == torch.int32, f
    assert bool(torch.isfinite(vg.valid_duration_s).all()), "TTL not finite"
    return vg


def oracle_sample(engine, bags, vg, n_rules: int) -> int:
    """matched / not-matched / err of sampled (rule, request) cells
    against the expression oracle; → cells checked."""
    import numpy as np
    from istio_tpu_torch.expr.oracle import OracleProgram
    from istio_tpu_torch.testing import workloads
    rng = np.random.default_rng(11)
    rules = workloads.make_rules(n_rules)
    matched = vg.matched.cpu().numpy()
    err = vg.err.cpu().numpy()
    n = 0
    for r in rng.integers(0, n_rules, size=40):
        prog = OracleProgram(rules[r].match, workloads.MESH_FINDER)
        for b in rng.integers(0, len(bags), size=8):
            try:
                want_m, want_e = bool(prog.evaluate(bags[b])), False
            except Exception:
                want_m, want_e = False, True
            got = (bool(matched[b, r]), bool(err[b, r]))
            if got != (want_m, want_e):
                raise AssertionError(f"rule {r} request {b}: device {got} "
                                     f"oracle {(want_m, want_e)}")
            n += 1
    return n


EDGE_RULES = [
    ("slot-eq", "source.name == destination.name", ""),
    ("slot-neq", 'source.name != destination.name && request.method == "GET"',
     ""),
    ("bytes-or", 'request.path.endsWith("/x") || '
     'request.host.startsWith("svc1")', "ns1"),
    ("exact-glob", 'match(request.host, "exact.host")', ""),
    ("anchored", '"/(a|b)+$".matches(request.path)', "ns2"),
    ("header", 'request.headers["cookie"] == "c1"', ""),
    ("fallback-chain", '(source.user | "anon") == "anon"', "ns1"),
    ("dyn-prefix", "request.path.startsWith(request.host)", ""),
    ("size", "request.size == 7", ""),
    ("always", "", ""),
    ("mtls", "connection.mtls", "ns2"),
    ("glob-suffix", 'match(request.host, "*.local")', ""),
]


def rule_match_edge_worlds() -> int:
    """Phase 3c: rule_match on snapshots the headline world is not, at
    B = HEADLINE_B and K1_EDGE_B rows, every plane subset against the
    reference's triple: atom-less (an empty match and `false`: the empty
    literal block), an empty ruleset, all-EQ with no legacy stage,
    host-fallback rules (an empty M) beside device ones, and rule_pad
    rows (61 rules padded to 64) over every atom tier. → cases."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.compiler import ruleset
    from istio_tpu_torch.compiler.layout import Tensorizer
    from istio_tpu_torch.testing import workloads
    rule = ruleset.Rule
    worlds = {
        "atom-less": ([rule("t", ""), rule("f", "false")], 1),
        "empty": ([], 1),
        "all-EQ": ([rule("eq", 'source.name == "a"'),
                    rule("neq", 'source.name != "b"', "ns1")], 1),
        "fallback": ([rule(*r) for r in EDGE_RULES]
                     + [rule("host", 'request.headers[source.name] == "v"'),
                        rule("host-ns", 'request.headers[request.method] '
                             '== "x" || source.name == "a"', "ns1")], 1),
        "rule_pad": ([rule(r.name, r.match, r.namespace) for r in
                      workloads.make_rules(61, with_regex=True)], 8),
    }
    n = 0
    for w, (name, (rules, pad)) in enumerate(worlds.items()):
        prog = ruleset.compile_ruleset(rules, workloads.MESH_FINDER,
                                       rule_pad=pad, device="cuda")
        if name == "fallback" and len(prog.host_fallback) < 2:
            raise AssertionError("the fallback world compiled "
                                 f"{len(prog.host_fallback)} host rules")
        dicts, _ = edge_bags(HEADLINE_B, seed=300 + w)
        batch = Tensorizer(prog.layout, prog.interner).tensorize(
            [bag_from_mapping(d) for d in dicts]).to("cuda")
        with kernels.launches.capture() as cap:
            prog(batch)
        torch.cuda.synchronize()
        k1 = [args for kname, args in cap if kname == "rule_match"]
        if len(k1) != 1:
            raise AssertionError(f"{name}: {len(k1)} rule_match launches")
        n += rule_match_check(f"rule_match {name}", k1[0], edges=True)
    return n


def edge_bags(n: int, seed: int) -> tuple[list[dict], list[str]]:
    import numpy as np
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    out, ns = [], []
    for _ in range(n):
        d = {}
        for attr, vals in (
                ("source.name", ["a", "b", ""]),
                ("destination.name", ["a", "c"]),
                ("request.method", ["GET", "POST"]),
                ("request.path", ["/x", "/ab", "/aba", "svc1/x", "",
                                  "/" + "a" * 200, "/b/x"]),
                ("request.host", ["svc1", "exact.host", "a.local", "svc1.b",
                                  "h" * 130]),
                ("request.headers", [{"cookie": "c1"}, {"x": "y"}, {}]),
                ("source.user", ["anon", "u1", "u2"]),
                ("request.size", [7, 8]),
                ("connection.mtls", [True, False])):
            if rng.random() < 0.8:
                d[attr] = pick(vals)
        out.append(d)
        ns.append(pick(["", "ns1", "ns2", "nowhere"]))
    return out, ns


# K2 / K3 edge inputs (phase 3b): widths 8, 13 and 128 at B 0 to 33, and
# 128 at B 2,047 and 2,048
LITS_EDGE_L = (8, 13, 128)
LITS_EDGE_B = (0, 1, 31, 32, 33)
LITS_BIG_B = (2047, 2048)
LITS_REGEXES = ("a+b*", "(ab|ba)+$", "^b", "[^a]b", "^$", "a", "b$", "^ab",
                "ab")
# long rows (width, batch sizes): fewer rows a byte-kernel block, groups
# of one and two patterns (a block of 256 one-pattern rows of 1,024
# bytes would not fit its shared memory)
LITS_LONG = ((1024, (1, 2048)), (1790, (33,)), (2000, (300,)))
# lits_patterns indices: a single suffix of L - 1 bytes, prefix of 3,
# exact of L and exact row; a pair prefix L - 1 + suffix 3; a pair of
# prefixes (3 and 1: every pattern a prefix)
LITS_LONG_GROUPS = ((10,), (6,), (14,), (18,), (9, 7), (6, 3))


def lits_views(b: int, l: int, seed: int) -> list[tuple]:
    """Subject views of B rows of width L on the card, from a numpy
    seed: (label, data, lens, ok, err, max_len). Rows of 'a' / 'b' with
    lengths 0, 1, 2, 3, L/2, L-2, L-1, L, L+1, L+4 and random ones;
    absent and error rows. Views: contiguous rows; the lean masks (ok
    and err None); a plane narrowed to L of max_len 2L (rows longer than
    the plane: the suffix clip shows); bytes past each length that are
    not zero; a column of a [B, 3, L] plane (row stride 3L) with strided
    lens and presence; rows at an odd address (a [B, L+1] plane from
    byte 1); a stride-0 broadcast constant row."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    ab = np.frombuffer(b"ab", np.uint8)
    lens = rng.choice([0, 1, 2, 3, l // 2, l - 2, l - 1, l, l + 1, l + 4],
                      size=b).astype(np.int32)
    lens[::3] = rng.integers(0, l + 1, size=len(lens[::3]))
    data = np.zeros((b, l), np.uint8)
    for i, n in enumerate(lens):
        data[i, :min(int(n), l)] = rng.choice(ab, min(int(n), l))
    garbage = data.copy()
    for i, n in enumerate(lens):
        garbage[i, min(int(n), l):] = rng.integers(1, 256,
                                                   l - min(int(n), l))
    ok = rng.random(b) < 0.85
    err = rng.random(b) < 0.1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()
    d, ln = t(data), t(lens)
    three = t(np.stack([garbage[::-1], data, garbage], axis=1))
    pres = t(np.stack([~ok, ok], axis=1))
    lens2 = t(np.stack([lens, -lens], axis=1))
    wide = t(np.concatenate([np.full((b, 1), 7, np.uint8), data], axis=1))
    n0 = int(lens[0]) if b else 0
    row = t(data[0] if b else np.zeros(l, np.uint8))
    return [("rows", d, ln, t(ok), t(err), l),
            ("lean", d, ln, None, None, l),
            ("narrowed", d, ln, t(ok), None, 2 * l),
            ("garbage", t(garbage), ln, t(ok), t(err), l),
            ("strided", three[:, 1, :], lens2[:, 0], pres[:, 1], t(err), l),
            ("unaligned", wide[:, 1:], ln, t(ok), t(err), l),
            ("broadcast", row[None, :].expand(b, l),
             torch.full((b,), n0, dtype=torch.int32, device="cuda"), None,
             None, l)]


def lits_patterns(data, lens, l: int, rng):
    """Byte patterns of every kind with k = 0, 1, 3, L-1, L and L+1, cut
    from the rows (so they hit) where a row is long enough, and three
    rows as exact patterns; → BytePatterns."""
    from istio_tpu_torch.ops import bytes_ops
    rows = [bytes(data[i, :min(int(n), l)].tolist())
            for i, n in enumerate(lens.tolist())]
    rows = [r for r in rows if r] or [b"ab"]
    items = []
    for k in (0, 1, 3, l - 1, l, l + 1):
        src = [r for r in rows if len(r) >= k]
        for kind in (bytes_ops.PREFIX, bytes_ops.SUFFIX, bytes_ops.EXACT):
            if src and k:
                r = src[int(rng.integers(len(src)))]
                pat = r[len(r) - k:] if kind == bytes_ops.SUFFIX else r[:k]
            else:
                pat = bytes(rng.choice(list(b"ab"), k).tolist())
            items.append((kind, pat))
    items += [(bytes_ops.EXACT, r) for r in rows[:3]]
    return bytes_ops.BytePatterns.of(items)


def lits_banks() -> list[tuple]:
    """(label, DfaBank) for the edge checks: small regexes over 'ab'
    (anchored and not), a C = 1 bank (the empty regex), an S = 1 bank
    (one state, three classes, built by hand) and one too large for
    shared memory (200 anchored hex patterns: 7,490 states x 13
    classes)."""
    import numpy as np
    from istio_tpu_torch.ops import bytes_ops, regex_dfa

    def bank(pats):
        return bytes_ops.DfaBank.of(regex_dfa.pack_dfas_classes(
            [regex_dfa.compile_regex(p) for p in pats]))
    one_state = bytes_ops.DfaBank(
        table=np.zeros((1, 3), np.int32),
        class_of=(np.arange(256) % 3).astype(np.int32),
        starts=np.zeros(2, np.int32), accept=np.array([[1, 0]], np.uint8))
    return [("small", bank(LITS_REGEXES)), ("C=1", bank(["", "^$"])),
            ("S=1", one_state),
            ("large", bank([f"^x{i}[0-9a-f]{{32}}$" for i in range(200)]))]


@contextlib.contextmanager
def byte_path(staged: bool):
    """The byte wrappers launch the staged (or the direct) kernel in the
    block, whatever the size rule of bytes_ops.byte_plan picks."""
    from istio_tpu_torch.ops import bytes_ops
    served = bytes_ops.byte_plan
    bytes_ops.byte_plan = functools.partial(served, staged=staged)
    try:
        yield
    finally:
        bytes_ops.byte_plan = served


def lits_edge_checks() -> int:
    """Phase 3b: byte_pred, byte_lits, dfa_scan and dfa_lits against
    their plain versions, byte for byte, on every subject view of
    lits_views at widths LITS_EDGE_L and B ∈ LITS_EDGE_B (B ∈ LITS_BIG_B
    at L = 128): the byte patterns of lits_patterns with random
    TRUNC_SAFE / TRUNC_ALL columns (and their prefixes alone, of which
    the kernel stages only the words below the longest that fits), every
    bank of lits_banks with
    random TRUNC_MISS / TRUNC_ALL columns, literal columns scattered in
    planes of 2k + 5 columns pre-filled with a seeded pattern (which
    must survive); the large bank also on hex rows that hit it; and
    rows of LITS_LONG widths, every view, the byte groups of
    LITS_LONG_GROUPS and the small bank. → the number of calls held."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import bytes_ops

    n = 0
    banks = lits_banks()

    def part(pats, idx):
        idx = np.asarray(idx)
        return bytes_ops.BytePatterns(pats.pats[idx], pats.plens[idx],
                                      pats.kind[idx])
    cases = [(l, b) for l in LITS_EDGE_L
             for b in LITS_EDGE_B + (LITS_BIG_B if l == 128 else ())]
    cases += [(l, b) for l, bs in LITS_LONG for b in bs]
    for l, b in cases:
        rng = np.random.default_rng(1000 * l + b)
        views = lits_views(b, l, seed=1000 * l + b)
        host = views[0]
        pats = lits_patterns(host[1].cpu(), host[2].cpu(), l, rng)
        if l in LITS_EDGE_L:
            pre = pats.kind == bytes_ops.PREFIX  # rows read in part
            tables = [("byte_pred", "bytes", pats),
                      ("byte_pred", "prefixes",
                       part(pats, np.flatnonzero(pre)))] + [
                ("dfa_scan", lbl, bk) for lbl, bk in banks]
        else:
            tables = [("byte_pred", f"group{list(ix)}", part(pats, ix))
                      for ix in LITS_LONG_GROUPS] + [
                ("dfa_scan", "small", banks[0][1])]
        for label, data, lens, ok, err, max_len in views:
            for name, tlabel, table in tables:
                modes = (bytes_ops.TRUNC_SAFE, bytes_ops.TRUNC_ALL) \
                    if name == "byte_pred" else \
                    (bytes_ops.TRUNC_MISS, bytes_ops.TRUNC_ALL)
                k = table.n
                x = 2 * k + 5
                lits = bytes_ops.LitColumns.of(
                    rng.choice(modes, k),
                    np.sort(rng.permutation(x)[:k]))
                em = torch.empty((b, x), dtype=torch.bool, device="cuda")
                for staged in (True, False) if name == "byte_pred" \
                        else (None,):
                    tag = f"{name} {tlabel} {label} L={l} B={b}" + (
                        "" if staged is None else
                        " staged" if staged else " direct")
                    with byte_path(staged) if staged is not None \
                            else contextlib.nullcontext():
                        subject_check(name, "plane", (data, lens, table),
                                      tag)
                        subject_check(name, "lits", (
                            data, lens, ok, err, table, lits, max_len, em,
                            em), tag, seed=b + k)
                    n += 2
    # the large bank on rows that reach its accepting states
    large = banks[-1][1]
    rng = np.random.default_rng(77)
    alphabet = np.frombuffer(b"abcx0123456789f", np.uint8)
    data = rng.choice(alphabet, size=(500, 40))
    data[::7, :2] = np.frombuffer(b"x1", np.uint8)
    data[::7, 2:34] = rng.choice(np.frombuffer(b"0123456789abcdef",
                                               np.uint8), (72, 32))
    lens = rng.integers(0, 41, size=500).astype(np.int32)
    lens[::14] = 34
    d, ln = torch.from_numpy(data).cuda(), torch.from_numpy(lens).cuda()
    hit = subject_check("dfa_scan", "plane", (d, ln, large),
                        "dfa_scan large hex")[0][0]
    if not bool(hit.any()):
        raise AssertionError("large bank: no row reached an accept state")
    em = torch.empty((500, 205), dtype=torch.bool, device="cuda")
    subject_check("dfa_scan", "lits", (
        d, ln, None, None, large, bytes_ops.LitColumns.of(
            rng.choice((bytes_ops.TRUNC_MISS, bytes_ops.TRUNC_ALL), 200),
            np.sort(rng.permutation(205)[:200])), 30, em, em),
        "dfa_lits large hex")
    return n + 2


def edge_checks() -> int:
    """Phase 3b: each kernel against its plain version on inputs the
    headline world does not produce: slot-vs-slot atoms, an all-EQ and
    an empty ruleset, two lists on one rule, negative hash keys under
    the floor modulo, unknown namespaces (K2 and K3: lits_edge_checks).
    → cases."""
    import numpy as np
    import torch
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.compiler.ruleset import Rule
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.testing import workloads

    n = 0
    worlds = [
        ([Rule(*r) for r in EDGE_RULES],
         {"deny": [pe.DenySpec(rule=0, valid_duration_s=3.0),
                   pe.DenySpec(rule=5, status=16, valid_use_count=9)],
          "lists": [pe.ListEntrySpec(rule=9, value_attr="source.user",
                                     entries=["u1"], blacklist=True),
                    pe.ListEntrySpec(rule=9, value_attr="source.name",
                                     entries=["a", "c"]),
                    pe.ListEntrySpec(rule=3, value_attr="request.method",
                                     entries=["GET"])],
          "quotas": [pe.QuotaSpec(rule=9, key_attr="source.user",
                                  max_amount=3, n_buckets=5),
                     pe.QuotaSpec(rule=8, key_attr="source.name",
                                  max_amount=2, n_buckets=3)]}),
        ([Rule("eq", 'source.name == "a"'),
          Rule("neq", 'source.name != "b"', "ns1")],
         {"deny": [pe.DenySpec(rule=1)]}),
        ([], {}),
    ]
    for w, (rules, specs) in enumerate(worlds):
        gpu = pe.PolicyEngine(rules, workloads.MESH_FINDER, device="cuda",
                              count_rules=max(len(rules) - 1, 0), **specs)
        cpu = pe.PolicyEngine(rules, workloads.MESH_FINDER, device="cpu",
                              count_rules=max(len(rules) - 1, 0), **specs)
        for step, b in enumerate((1, 300, 77)):
            dicts, ns = edge_bags(b, seed=100 * w + step)
            bags = [bag_from_mapping(d) for d in dicts]
            req = np.asarray([gpu.ruleset.namespace_id(x) for x in ns],
                             np.int32)
            req[::11] = -7                     # the pad rows' namespace
            batch = gpu.tensorizer.tensorize(bags)
            batch.hash_ids[::3] = -batch.hash_ids[::3] - 1  # floor modulo
            cpu.quota_counts.copy_(gpu.quota_counts.cpu())
            vg = gpu.check(batch.to("cuda"), req)
            vc = cpu.check(batch, req)
            for f in FIELDS:
                assert_equal(f"edge world {w} B={b}.{f}",
                             getattr(vg, f).cpu(), getattr(vc, f))
            assert_equal(f"edge world {w} B={b}.quota_counts",
                         gpu.quota_counts.cpu(), cpu.quota_counts)
            n += 1
    return n


RESPONSE_FIELDS = ("status_code", "status_message", "valid_duration_s",
                   "valid_use_count", "referenced", "referenced_presence",
                   "deny_rule", "active_quota_rules")
SERVED_ITERS = 30            # timed check_many calls per batch size


def compare_responses(label: str, got, want) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} responses, want "
                             f"{len(want)}")
    for i, (a, b) in enumerate(zip(got, want)):
        for f in RESPONSE_FIELDS:
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(f"{label}: request {i} field {f}: "
                                     f"card {getattr(a, f)!r}, plain "
                                     f"{getattr(b, f)!r}")


def compare_drains(label: str, got: dict, want: dict, times: int = 1
                   ) -> None:
    import numpy as np
    for k in ("hit", "deny", "err"):
        if not np.array_equal(got[k], times * want[k]):
            raise AssertionError(f"{label}: drained {k} differs from "
                                 f"{times} x the plain fold")


def rule_counts(srv) -> dict:
    """The server's cumulative rule counts after one more drain,
    flattened to {(rule, namespace or "", field): n}."""
    srv.rulestats.drain()
    out = {}
    for name, v in srv.rulestats.counts().items():
        for f in ("hits", "denies", "errors"):
            out[(name, "", f)] = v[f]
        for ns, per in v["ns"].items():
            for f, n in per.items():
                out[(name, ns, f)] = n
    return out


def counts_since(srv, before: dict) -> dict:
    """Nonzero growth of rule_counts(srv) since `before`."""
    after = rule_counts(srv)
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def compare_counts(label: str, got: dict, want: dict, times: int = 1
                   ) -> None:
    if not want:
        raise AssertionError(f"{label}: the plain server counted nothing")
    if got != {k: times * n for k, n in want.items()}:
        raise AssertionError(f"{label}: rule counts differ from {times} x "
                             "the plain server's")


def served(n_rules: int, device: str, args: dict | None = None,
           **store_kw):
    """The port's RuntimeServer over make_store(n_rules) on `device`
    with ServerArgs(**args), and its store."""
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads
    store = workloads.make_store(n_rules, **store_kw)
    return RuntimeServer(store, ServerArgs(**(args or {})),
                         device=device), store


def served_traffic(traffic: str, n_rules: int, b: int, seed: int):
    """Bags of bench.py's headline traffic (make_bags), or of the
    port-only hit traffic aimed at make_store's deny / list rules, with
    every fifth request from a namespace no rule names."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.testing import workloads
    if traffic == "headline":
        return workloads.make_bags(b, seed=seed)
    dicts, _ = workloads.make_hit_requests(n_rules, b, seed=seed)
    for d in dicts[::5]:
        d["destination.service"] = "svc1.nowhere.svc.cluster.local"
    return [bag_from_mapping(d) for d in dicts]


def stage_sums() -> dict:
    from istio_tpu_torch.runtime import monitor
    h = monitor.CHECK_STAGE_SECONDS
    return {st: h.sum(st) for st in monitor.CHECK_STAGES}


# the plain server: no drainer thread (drains are explicit), and one
# small bucket to warm at a config swap
CPU_SERVER = dict(initial_prewarm=False, rulestats_drain_s=0, buckets=(64,))


def served_phase() -> dict:
    """Phase 5: the served Check() path at the headline world, with the
    launch counters zeroed just before it and read just after. The
    card's server runs at the default ServerArgs (its rule-stats
    drainer thread included) with E2E_BATCHES as its buckets, so its
    constructor warms every timed shape. → the counts, per-B results,
    the captured B=2048 kernel inputs, and both servers for phase 5c."""
    import torch
    from istio_tpu_torch import kernels

    t0 = time.perf_counter()
    srv, store = served(HEADLINE_RULES, "cuda", dict(buckets=E2E_BATCHES))
    build_s = time.perf_counter() - t0
    cpu, cpu_store = served(HEADLINE_RULES, "cpu", CPU_SERVER)
    d = srv.controller.dispatcher
    plan, snap = d.fused, d.snapshot
    rs = snap.ruleset
    log(f"[5] served snapshot + plan + warm of "
        f"{len(plan._warmed_shapes)} (bucket, tier) shapes on the card in "
        f"{build_s:.2f} s (publish {srv.controller.last_publish_wall_s:.2f}"
        f" s): {len(snap.rules)} rules, {rs.rule_ns.shape[0]} rule rows, "
        f"{len(rs.ns_ids) + 1} telemetry slots, {len(plan.item_names)} "
        f"items ({plan.n_ref_words} words), {len(plan.overlay_cols)} "
        f"overlay columns ({plan.n_overlay_words} words), "
        f"{plan.fused_deny} deny / {plan.fused_lists} lists fused, "
        f"{len(plan.host_actions)} host-overlay rules, tiers "
        f"{plan.str_tiers}, errors {len(snap.errors)}")
    if plan._warmed_shapes != set(plan.all_warm_shapes(E2E_BATCHES)):
        raise AssertionError(f"constructor warmed {plan._warmed_shapes}")

    kernels.launches.reset()
    steps = 0
    for traffic in ("headline", "hit"):
        bags = served_traffic(traffic, HEADLINE_RULES, 256, seed=41)
        before, cpu_before = rule_counts(srv), rule_counts(cpu)
        compare_responses(f"served {traffic} B=256", srv.check_many(bags),
                          cpu.check_many(bags))
        compare_counts(f"served {traffic} B=256", counts_since(srv, before),
                       counts_since(cpu, cpu_before))
        steps += 1
    log("[5] B=256 headline and hit traffic: every response field and "
        "the drained rule counts equal to the device='cpu' server")
    big = served_traffic("headline", HEADLINE_RULES, HEADLINE_B, seed=1)
    with kernels.launches.capture() as captured:
        srv.check_many(big)
    steps += 1
    torch.cuda.synchronize()
    stage = check_ext_stage(f"[5] served B={HEADLINE_B}",
                            lambda: srv.check_many(big), rs)
    steps += stage["calls"]
    results = {}
    for b in E2E_BATCHES:
        bags = served_traffic("headline", HEADLINE_RULES, b, seed=1)
        results[b], n = time_check_many(srv, cpu, bags, "[5] served")
        steps += n
    out = path_counts("[5] served path", SERVED_KERNELS, steps)
    one_lit_launch_per_group("[5] served path", out, rs)
    out["ext_stage"] = stage
    return {**out, "results": results, "captured": captured,
            "quota0": plan.engine.quota_counts.clone(),
            "servers": (srv, store, cpu, cpu_store)}


def time_check_many(srv, cpu, bags, label: str) -> tuple[dict, int]:
    """Time srv.check_many(bags) over SERVED_ITERS calls after two warm
    ones: wall p50 / p99, checks/s, device busy and idle share, and the
    host stage breakdown; the loop's rule counts must equal SERVED_ITERS
    x the plain server's for the batch. → (result, served steps)."""
    import numpy as np
    b = len(bags)
    for _ in range(2):
        srv.check_many(bags)
    cpu_before = rule_counts(cpu)
    cpu.check_many(bags)
    once = counts_since(cpu, cpu_before)
    before = rule_counts(srv)
    t_before = stage_sums()
    walls = []
    for _ in range(SERVED_ITERS):
        t = time.perf_counter()
        srv.check_many(bags)
        walls.append((time.perf_counter() - t) * 1e3)
    t_after = stage_sums()
    compare_counts(f"{label} B={b} timed loop", counts_since(srv, before),
                   once, times=SERVED_ITERS)
    busy = device_ms(lambda: srv.check_many(bags), 5)
    p50, p99 = (float(np.percentile(walls, q)) for q in (50, 99))
    stages = {k: (t_after[k] - t_before[k]) * 1e3 / SERVED_ITERS
              for k in t_after}
    idle = "not measured" if busy is None else \
        f"busy {busy:.4f} ms, idle share {1 - busy / p50:.3f}"
    log(f"{label} B={b:5d}: wall p50 {p50:.4f} ms p99 {p99:.4f} ms "
        f"= {b / p50 * 1e3:,.0f} checks/s ({idle}); stages ms/batch "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
        + f"; rule counts = {SERVED_ITERS} x the plain server's")
    return {"p50_ms": p50, "p99_ms": p99, "checks_per_s": b / p50 * 1e3,
            "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / p50,
            "stages_ms": stages}, 2 + SERVED_ITERS + 6


def k1_grids_per_call(label: str, counts: dict, grids: dict) -> None:
    """rule_match makes at most two `__global__` launches per call."""
    if grids["rule_match"] > 2 * counts["rule_match"]:
        raise AssertionError(f"{label}: {grids['rule_match']} rule_match "
                             f"grids for {counts['rule_match']} calls")


def path_counts(label: str, required: tuple, steps: int) -> dict:
    """Read the launch counters after a path's run (zeroed just before
    it); every kernel of the path must have launched."""
    from istio_tpu_torch import kernels
    counts = dict(kernels.launches)
    grids = dict(kernels.launches.grids)
    missing = [k for k in required if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on {label}: "
                             f"{missing}")
    k1_grids_per_call(label, counts, grids)
    per_step = {k: counts[k] / steps for k in kernels.KERNELS}
    per_call = {k: grids[k] / counts[k] for k in kernels.KERNELS
                if counts[k]}
    entries = dict(kernels.launches.entries)
    log(f"{label} ({steps} served steps): wrapper calls {counts}; "
        f"__global__ launches {grids}; calls per step "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_step.items())
        + "; grids per call "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_call.items()))
    return {"counts": counts, "grids": grids, "steps": steps,
            "per_step": per_step, "entries": entries}


def one_lit_launch_per_group(label: str, out: dict, ruleset,
                             plane_ok: tuple = ()) -> None:
    """Every rule_match launch of the path's drive came with one
    byte_lits launch per byte group and one dfa_lits launch per DFA
    group of the ruleset (each one grid), and no plane launch of K2 / K3
    (but for the entry points in `plane_ok`)."""
    counts, e = out["counts"], out["entries"]
    g = ruleset.geometry
    steps = counts["rule_match"]
    want = {"byte_lits": steps * g["n_byte_groups"],
            "dfa_lits": steps * g["n_dfa_groups"],
            "byte_pred": 0, "dfa_scan": 0}
    got = {k: e[k] for k in want}
    for k in plane_ok:
        want[k] = got[k]
    grids = out["grids"]
    if got != want or grids["byte_pred"] != counts["byte_pred"] or \
            grids["dfa_scan"] != counts["dfa_scan"]:
        raise AssertionError(f"{label}: K2 / K3 entry points {got} "
                             f"(grids {grids['byte_pred']} / "
                             f"{grids['dfa_scan']}) for {steps} rule_match "
                             f"launches, {g['n_byte_groups']} byte and "
                             f"{g['n_dfa_groups']} DFA groups; want {want}")
    log(f"{label}: one launch per subject group per step ({steps} steps x "
        f"({g['n_byte_groups']} byte_lits + {g['n_dfa_groups']} dfa_lits))"
        + (f"; plane launches {', '.join(f'{k} {got[k]}' for k in plane_ok)}"
           if plane_ok else "; no plane launch"))


def hand_written() -> dict:
    """The `__global__` functions of csrc/ → their source: what the
    profiler's kernel names are matched against."""
    import re
    from istio_tpu_torch import kernels
    out = {}
    for src in sorted(kernels.SRC_DIR.glob("*.cu")):
        for name in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                r"(\w+)", src.read_text()):
            out[name] = src.stem
    return out


def source_of_event(name: str, table: dict) -> tuple[str | None, str]:
    """(csrc/ source, `__global__` function) of a profiler kernel name;
    (None, the name) for a library kernel, a copy or a memset."""
    import re
    for fn, src in table.items():
        if re.search(r"(?:^|[\s:])" + fn + r"[<(]", name):
            return src, fn
    return None, name[:60]


def ext_stage(fn, steps: int, srcs=("byte_pred", "dfa_scan")) -> dict:
    """Profile `steps` calls of fn (one step each) and read the ext
    stages in them — every device op from the first kernel of `srcs` (K2
    / K3) to the next rule_match kernel, glue included — and the device
    time of every op that is not a hand-written kernel. → {"stages": one
    dict a stage seen ("launches", "k23" (launches of `srcs`),
    "all_hand_written", "ms", "ops"), "other_ms", "other_ops" (a
    step's)}; "stages" is empty where the profiler saw no device
    activity. The profiler drops a kernel record now and then (PERF.md
    §7): a stage may read one launch short, never one long."""
    import torch
    from torch.autograd import DeviceType
    table = hand_written()
    fn()
    torch.cuda.synchronize()
    prof = profile_calls(fn, steps)
    # a window's prof.step() adds a ProfilerStep annotation on the device
    # that spans the step's work: no op of it
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)
                  and not e.name.startswith("ProfilerStep")),
                 key=lambda e: e.time_range.start)
    tagged = [(e, *source_of_event(e.name, table)) for e in evs]
    other = [e for e, src, _ in tagged if src is None]
    stages, cur = [], None
    for e, src, name in tagged:
        if cur is None and src in srcs:
            cur = []
        if cur is not None:
            # the stage ends at K1 (or, should the profiler have dropped
            # both K1 records, at the next hand-written kernel of another
            # source)
            if src is not None and src not in (*srcs, "field_eval"):
                stages.append(cur)
                cur = None
            else:
                cur.append((e, src, name))
    return {"stages": [{
        "launches": len(st), "k23": sum(src in srcs for _, src, _ in st),
        "all_hand_written": all(src is not None for _, src, _ in st),
        "ms": sum(e.time_range.elapsed_us() for e, _, _ in st) / 1e3,
        "ops": sorted({name for _, _, name in st})} for st in stages],
        "other_ms": sum(e.time_range.elapsed_us() for e in other)
        / 1e3 / steps,
        "other_ops": len(other) / steps}


def check_ext_stage(label: str, fn, ruleset, steps: int = 10,
                    tries: int = 3) -> dict:
    """The ext stage of `steps` profiled calls: exactly one hand-written
    launch per subject group, then atom_eval where the ruleset has op
    programs, and nothing else before rule_match. Every stage the
    profile shows must hold only hand-written kernels and no launch too
    many, and most of the steps (more than half) must show their stage
    whole (the profiler drops a record now and then: such a profile is
    taken again, up to `tries` profiles in all). A profile with no
    stage in it fails. → what was seen, with "calls" (fn's
    calls, warm-ups included)."""
    g = ruleset.geometry
    groups = g["n_byte_groups"] + g["n_dfa_groups"]
    want = groups + (1 if ruleset.atoms.n else 0)
    need = steps // 2 + 1
    seen = []
    for attempt in range(1, tries + 1):
        st = ext_stage(fn, steps)
        stages = st["stages"]
        if not stages:
            raise AssertionError(f"{label}: the profile of {steps} steps "
                                 "shows no ext stage (no device events?)")
        bad = [x for x in stages if not x["all_hand_written"]
               or x["launches"] > want or x["k23"] > groups]
        if bad:
            raise AssertionError(f"{label}: ext stage {bad[0]}; want "
                                 f"{want} hand-written launches a step "
                                 f"({groups} subject groups"
                                 + (" + atom_eval" if ruleset.atoms.n
                                    else "") + ") and nothing else")
        whole = [x for x in stages
                 if x["launches"] == want and x["k23"] == groups]
        seen.append(len(whole))
        if len(whole) >= need:
            break
        log(f"{label}: profile {attempt} showed {len(whole)} of {steps} "
            "ext stages whole (dropped records); profiling again")
    else:
        raise AssertionError(f"{label}: ext stage seen whole in {seen} of "
                             f"{steps} steps in {tries} profiles; want "
                             f"{need}")
    ms = sorted(x["ms"] for x in whole)[len(whole) // 2]
    ops = sorted({o for x in whole for o in x["ops"]})
    log(f"{label}: ext stage {want} launches a step ({', '.join(ops)}; "
        f"{len(whole)} of {steps} profiled steps seen whole, profile "
        f"{attempt}), all hand-written ({groups} subject groups"
        + (" + atom_eval" if ruleset.atoms.n else "")
        + f"), device {ms:.5f} ms a step (median whole stage); every op "
        f"that is not a hand-written kernel: {st['other_ops']:.1f} a step, "
        f"{st['other_ms']:.5f} ms a step")
    return {"launches": want, "ms": ms, "ops": ops, "whole": len(whole),
            "steps": steps, "profiles": attempt,
            "calls": attempt * (steps + 1 + PROFILE_WARMUP_CALLS),
            "other_ms": st["other_ms"],
            "other_ops": st["other_ops"]}


def swap_phase(srv, store, cpu, cpu_store) -> None:
    """Phase 5c: a config swap through the store watch on both servers
    (every denier now answers UNAVAILABLE with a short TTL), with the
    launch counters zeroed just before it and read just after. The new
    plan warms every serving shape on the card before it is published;
    the batches after the swap run on the device and equal the CPU
    server's, and no rule count is lost across the publish."""
    from istio_tpu_torch import kernels

    bags = served_traffic("hit", HEADLINE_RULES, 256, seed=43)
    kernels.launches.reset()
    before, cpu_before = rule_counts(srv), rule_counts(cpu)
    compare_responses("pre-swap B=256", srv.check_many(bags),
                      cpu.check_many(bags))
    old = (srv.controller.dispatcher, cpu.controller.dispatcher)
    spec = {"adapter": "denier",
            "params": {"status_code": 14, "valid_duration_s": 1.5}}
    t0 = time.perf_counter()
    for st in (store, cpu_store):
        st.set(("handler", "istio-system", "denyall"), spec)
    deadline = t0 + 120
    for x, was in zip((srv, cpu), old):
        while x.controller.dispatcher is was:
            if time.perf_counter() > deadline:
                raise AssertionError("config swap never published")
            time.sleep(0.005)
        if x is srv:
            seen_s = time.perf_counter() - t0
    plan = srv.controller.dispatcher.fused
    n_warm = len(plan._warmed_shapes)
    if plan._warmed_shapes != set(plan.all_warm_shapes(E2E_BATCHES)):
        raise AssertionError(f"swap warmed {plan._warmed_shapes}")
    trips = []
    packed_check = plan.packed_check

    def counted(*a, **kw):
        trips.append(1)
        return packed_check(*a, **kw)

    plan.packed_check = counted
    got = srv.check_many(bags)
    compare_responses("post-swap B=256", got, cpu.check_many(bags))
    del plan.packed_check
    if not trips or not any(r.status_code == 14 for r in got):
        raise AssertionError("post-swap batch did not serve the new "
                             "config on the device")
    compare_counts("across the swap", counts_since(srv, before),
                   counts_since(cpu, cpu_before))
    counts = dict(kernels.launches)
    missing = [k for k in SERVED_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched across the swap: "
                             f"{missing}")
    codes = sorted({r.status_code for r in got})
    log(f"[5c] config swap through the store watch: published on the "
        f"card {seen_s:.2f} s after store.set (rebuild + warm of "
        f"{n_warm} shapes "
        f"{srv.controller.last_publish_wall_s:.2f} s); the next B=256 "
        f"batch served on the device (statuses {codes}) equal to the CPU "
        f"server, rule counts across the publish equal; wrapper calls "
        f"{counts}")
    for x in (srv, cpu, store, cpu_store):
        x.close()


def served_edge_checks() -> int:
    """Phase 5b: check_pack and rule_stats against their plain versions
    on inputs the headline world does not produce — more than one item
    word, more than 32 overlay columns, bit 31 of a word set, padding
    rows, unknown and pad-row namespaces, empty item and overlay sets —
    and a served host-overlay world on the card against the same server
    on the CPU, with padded batches. → cases."""
    import numpy as np
    import torch
    from istio_tpu_torch.runtime import fused, rulestats
    from istio_tpu_torch.runtime.batcher import pad_to_bucket

    rng = np.random.default_rng(9)
    n = 0
    for b, r, n_cols, n_maps, c in ((77, 300, 50, 20, 70),
                                    (33, 64, 31, 2, 40), (5, 40, 0, 0, 0),
                                    (97, 1001, 300, 40, 33),
                                    (2048, 10008, 26, 3, 2)):
        n_items = n_cols + n_maps
        rule_ns = torch.from_numpy(
            rng.integers(-1, 5, size=r).astype(np.int32))
        rule_ns[-3:] = -7
        inst = rng.random((r, n_items)) < 0.05
        if n_items > 31:
            inst[::3, 31] = True
        pred = rng.random((r, n_maps)) < 0.1
        t = fused.PackTables.of(rule_ns.numpy(), 0, inst, pred,
                                rng.choice(r, size=c, replace=False),
                                n_cols, n_items, "cuda")
        g = torch.Generator(device="cuda").manual_seed(b)
        status = torch.randint(0, 14, (b,), dtype=torch.int32,
                               device="cuda", generator=g)
        dur = torch.rand(b, device="cuda", generator=g)
        uses = torch.randint(0, 1 << 30, (b,), dtype=torch.int32,
                             device="cuda", generator=g)
        deny_rule = torch.randint(-1, r + 1, (b,), dtype=torch.int32,
                                  device="cuda", generator=g)
        err_count = torch.tensor(17, dtype=torch.int32, device="cuda")
        referenced = torch.rand(b, max(n_cols, 1), device="cuda",
                                generator=g) < 0.5
        matched = torch.rand(b, r, device="cuda", generator=g) < 0.3
        req = torch.randint(-1, 5, (b,), dtype=torch.int32, device="cuda",
                            generator=g)
        req[::7] = -7
        ins = (status, dur, uses, deny_rule, err_count, referenced, matched,
               req, t)
        got = fused.check_pack(*ins)
        assert_equal(f"check_pack edge B={b} R={r} items={n_items} C={c}",
                     got, fused.check_pack_plain(*ins))
        assert_equal(f"check_pack edge B={b} R={r} items={n_items} C={c} "
                     "(word plain)", got, fused.check_pack_words_plain(*ins))
        if n_items > 31 and not bool((got[5:5 + t.n_words] < 0).any()):
            raise AssertionError("check_pack edge: no word with bit 31 set")
        s = 6
        err = torch.rand(b, r, device="cuda", generator=g) < 0.1
        real = torch.arange(b, device="cuda") < b - 2
        err_rows = torch.rand(r, device="cuda", generator=g) < 0.9
        sin = (matched, err, status, deny_rule, req, real, t.rule_ns, 0, s,
               err_rows)
        accs = [rulestats_zeros(sin) for _ in range(2)]
        for a in accs:
            a[0].fill_(3)          # fold into non-zero state
        rulestats.rule_stats(*sin, *accs[0])
        rulestats.rule_stats_plain(*sin, *accs[1])
        for part, x, y in zip(("hit", "deny", "err"), *accs):
            assert_equal(f"rule_stats edge B={b} R={r}.{part}", x, y)
        n += 2
    # a served world with more than 32 overlay columns and several item
    # words, on padded batches with unknown namespaces
    args = dict(initial_prewarm=False, rulestats_drain_s=0)
    gpu, gs = served(200, "cuda", args, host_overlay_every=5)
    cpu, cs = served(200, "cpu", args, host_overlay_every=5)
    buckets = (16, 64)
    for step, b in enumerate((5, 40, 64)):
        bags = served_traffic("hit", 200, b, seed=300 + step)
        padded = pad_to_bucket(bags, buckets)
        compare_responses(f"served edge B={b}",
                          gpu.controller.dispatcher.check(padded),
                          cpu.controller.dispatcher.check(padded))
        n += 1
    compare_drains("served edge telemetry",
                   gpu.controller.dispatcher.fused.telemetry.drain(),
                   cpu.controller.dispatcher.fused.telemetry.drain())
    for x in (gpu, cpu, gs, cs):
        x.close()
    return n + 1

# rule_stats's edge shapes (phase 5b): (B, R, S, kind). R not a multiple
# of the 8-column run (1001, 300, 13: ragged last runs and rows that start
# off an 8-byte boundary), one slot, more than 64, every row one
# namespace, rows alternating namespaces, an all-padding batch, unknown
# namespaces only (slot S - 1), B not a multiple of a row chunk
K6_EDGE = ((2048, 1001, 6, "random"), (2048, 30, 4, "random"),
           (77, 1001, 6, "random"), (333, 10008, 80, "random"),
           (64, 96, 1, "random"), (130, 200, 6, "one"),
           (130, 200, 6, "alternate"), (50, 64, 6, "padding"),
           (90, 64, 6, "unknown"), (5, 13, 3, "random"))


def rule_stats_edge_checks() -> int:
    """Phase 5b: rule_stats against its plain version on K6_EDGE, each on
    planes that start on an 8-byte boundary and on planes that start 3
    bytes past one (views into a larger buffer), folded into non-zero
    state. → cases."""
    import torch
    from istio_tpu_torch.runtime import rulestats
    g = torch.Generator(device="cuda").manual_seed(3)
    n = 0
    for b, r, s, kind in K6_EDGE:
        def rnd(*shape):
            return torch.rand(*shape, device="cuda", generator=g)

        def ints(lo, hi, size):
            return torch.randint(lo, hi, size, dtype=torch.int32,
                                 device="cuda", generator=g)

        matched, err = rnd(b, r) < 0.3, rnd(b, r) < 0.1
        status, deny_rule = ints(0, 3, (b,)), ints(-1, r + 1, (b,))
        req = ints(-1, s + 2, (b,))
        if kind == "one":
            req[:] = min(2, s - 1)
        elif kind == "alternate":
            req = torch.where(torch.arange(b, device="cuda") % 2 == 0, 1,
                              3).to(torch.int32)
        elif kind == "unknown":
            req[::2], req[1::2] = -1, s + 5
        real = rnd(b) < 0.9
        if kind == "padding":
            real[:] = False
        rule_ns = ints(0, max(s - 1, 1), (r,))
        rule_ns[::7] = 0
        err_rows = rnd(r) < 0.9
        for off in (0, 3):
            planes = [torch.zeros(b * r + off, dtype=torch.bool,
                                  device="cuda") for _ in range(2)]
            planes[0][off:] = matched.view(-1)
            planes[1][off:] = err.view(-1)
            m, e = (x[off:].view(b, r) for x in planes)
            sin = (m, e, status, deny_rule, req, real, rule_ns, 0, s,
                   err_rows)
            accs = [rulestats_zeros(sin) for _ in range(2)]
            for acc in accs:
                acc[0].fill_(3)
            rulestats.rule_stats(*sin, *accs[0])
            rulestats.rule_stats_plain(*sin, *accs[1])
            for part, x, y in zip(("hit", "deny", "err"), *accs):
                assert_equal(f"rule_stats edge B={b} R={r} S={s} {kind} "
                             f"offset {off}.{part}", x, y)
            n += 1
    torch.cuda.synchronize()
    return n


def authz_phase(int_rate: float) -> dict:
    """Phase 6: the authz world (BASELINE config 2): make_rbac_store(1000)
    served under default_manifest=MESH_MANIFEST on the card against a
    device="cpu" server, with the launch counters zeroed just before its
    drive and read just after. make_rbac_request_dicts(B) at B ∈
    E2E_BATCHES: every response field and the rule counts equal, then
    the timed loop; the B=2048 batch is captured and K1, K3, K4, K5 and
    K6 are held against their plain versions on it (timed, with the
    bounds and the RBAC allow product as a library call)."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads

    man = workloads.MESH_MANIFEST
    t0 = time.perf_counter()
    store = workloads.make_rbac_store(AUTHZ_ROLE_RULES)
    srv = RuntimeServer(store, ServerArgs(default_manifest=man,
                                          buckets=E2E_BATCHES),
                        device="cuda")
    build_s = time.perf_counter() - t0
    cpu_store = workloads.make_rbac_store(AUTHZ_ROLE_RULES)
    cpu = RuntimeServer(cpu_store, ServerArgs(default_manifest=man,
                                              **CPU_SERVER), device="cpu")
    d = srv.controller.dispatcher
    plan, snap = d.fused, d.snapshot
    ((key, g),) = snap.rbac_groups.items()
    if not g.lowered or plan.host_actions or plan.rbac_rules != {0}:
        raise AssertionError(f"authz policy did not fuse: {g.reason}")
    log(f"[6] authz world make_rbac_store({AUTHZ_ROLE_RULES}): snapshot + "
        f"plan + warm on the card {build_s:.2f} s; {len(snap.rules)} config "
        f"rule, rbac group {key}: {len(g.allow_rows)} allow rows "
        f"({g.n_triples} (binding, subject, role-rule) triples) + guard "
        f"row {g.guard_row}; {snap.ruleset.n_rules} ruleset rows, "
        f"{snap.ruleset.rule_ns.shape[0]} after the pad to 8; "
        f"{len(plan.item_names)} items, {len(plan.overlay_cols)} overlay "
        f"columns")
    kernels.launches.reset()
    steps, results, denied = 0, {}, {}
    for b in E2E_BATCHES:
        bags = [bag_from_mapping(x) for x in
                workloads.make_rbac_request_dicts(b, seed=b)]
        before, cpu_before = rule_counts(srv), rule_counts(cpu)
        got = srv.check_many(bags)
        compare_responses(f"authz B={b}", got, cpu.check_many(bags))
        compare_counts(f"authz B={b}", counts_since(srv, before),
                       counts_since(cpu, cpu_before))
        steps += 1
        codes = [r.status_code for r in got]
        denied[b] = sum(c != OK for c in codes) / b
        if not {0, 7} <= set(codes):
            raise AssertionError(f"authz B={b}: statuses {set(codes)}")
        log(f"[6] authz B={b}: every response field and the rule counts "
            f"equal to the device='cpu' server; denied fraction "
            f"{denied[b]:.4f} (statuses {sorted(set(codes))})")
        if b == HEADLINE_B:
            with kernels.launches.capture() as captured:
                srv.check_many(bags)
            steps += 1
            torch.cuda.synchronize()
            stage = check_ext_stage(f"[6] authz B={b}",
                                    lambda: srv.check_many(bags),
                                    snap.ruleset)
            steps += stage["calls"]
        results[b], n = time_check_many(srv, cpu, bags, "[6] authz")
        steps += n
    out = path_counts("[6] authz path", AUTHZ_KERNELS, steps)
    one_atom_launch_per_step("[6] authz path", out, snap.ruleset)
    one_lit_launch_per_group("[6] authz path", out, snap.ruleset)
    out["ext_stage"] = stage
    log(f"[6] authz path, B={HEADLINE_B}: K1, K3, K4, K5, K6 and "
        "atom_eval against their plain versions on its own inputs (timed):")
    rows = check_kernels(captured, plan.engine.quota_counts.clone(),
                         int_rate)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    return {**out, "results": results, "denied": denied, "rows": rows,
            "pseudo_rows": len(g.allow_rows) + 1}


def one_atom_launch_per_step(label: str, out: dict, ruleset) -> None:
    """Every rule_match launch of the path's drive came with exactly one
    atom_eval launch (one grid), where the ruleset has op-program atoms;
    none where it has none."""
    counts, grids = out["counts"], out["grids"]
    want = counts["rule_match"] if ruleset.atoms.n else 0
    if counts["atom_eval"] != want or grids["atom_eval"] != want:
        raise AssertionError(f"{label}: {counts['atom_eval']} atom_eval "
                             f"launches ({grids['atom_eval']} grids) for "
                             f"{counts['rule_match']} rule_match launches "
                             f"and {ruleset.atoms.n} op-program atoms")
    log(f"{label}: one atom_eval launch per step ({want} launches, "
        f"{ruleset.atoms.n} atoms as {len(ruleset.atoms.prog.ops)} op "
        f"rows, stack {ruleset.atoms.prog.need}); no per-atom closure")


# atoms for atom_eval's edge inputs (phase 6b) over EDGE_ATOM_MANIFEST:
# runtime and constant patterns (empty, `*` only, leading / trailing `*`,
# longer than the subject), subjects at and past the cap, regexes, ordered
# compares with numeric NaN and malformed order keys, type mismatches,
# `|` views and map views, operand-order swaps with an error on either
# side, and a 40-deep LAND chain
EDGE_ATOM_MANIFEST = {"s": "STRING", "p": "STRING", "q": "STRING",
                      "n": "INT64", "m": "INT64", "d": "DOUBLE",
                      "d2": "DOUBLE", "t": "TIMESTAMP", "b": "BOOL",
                      "b2": "BOOL", "h": "STRING_MAP"}
EDGE_ATOMS = (
    "s.startsWith(p)", "s.endsWith(p)", "match(s, p)",
    "(s | q).startsWith(p | q)", 'match(h["k"] | s, h["j"] | "*")',
    'match("abc", p)', '"".endsWith(p)', 's.startsWith("abc")',
    's.endsWith("bc")', 'match(s, "*bc")', 'match(s, "abc*")',
    'match(s, "abcdefgh")', 's.endsWith("abcdefghijk")', '"^ab".matches(s)',
    '"c$".matches(s)', '"b+c".matches(h["k"] | p)', '"(".matches(s)',
    "s < p", "q >= p", '"abc" < s', 's >= "abcdefgh"', "n < m", "d < d2",
    "d > 1.5", "b < b2", "s < n", "b || (b2 && (n == 1 || m == 2))",
    'timestamp(s) == t || (b && (b2 || n == 1))',
    '(s | (p | (q | "z"))) == "abc"', 's < (p | (q | "zz"))',
    'match(s, p | (q | "*"))',
    " && ".join(f"n == {i % 3}" if i % 3 == 0 else
                ("b" if i % 3 == 1 else 's.startsWith("ab")')
                for i in range(40)))


def edge_atom_dicts(b: int, seed: int) -> list[dict]:
    """Records for atom_eval's edge inputs: strings around the cap of 8
    (empty, 1, 3, 7, 8, 10 bytes, `*`-led and -ended), NaN / inf / -0.0
    doubles, malformed numbers, maps, every attribute absent on some."""
    import datetime

    import numpy as np
    rng = np.random.default_rng(seed)
    strs = ["", "a", "abc", "abcdefg", "abcdefgh", "abcdefghij", "xbc",
            "*bc", "bc", "abc*", "*", "**", "a*c", "abcdefghijk"]
    nums = [0, -3, 7, 2 ** 40, "malformed", 7.5, 1]
    dbls = [float("nan"), 1.5, -0.0, 0.0, 2.5, "bad", float("inf")]
    t0 = datetime.datetime(2018, 3, 1, tzinfo=datetime.timezone.utc)
    out = []
    for _ in range(b):
        d = {}
        for k, vals in (("s", strs), ("p", strs), ("q", strs), ("n", nums),
                        ("m", nums), ("d", dbls), ("d2", dbls),
                        ("t", [t0]), ("b", [True, False]),
                        ("b2", [True, False])):
            if rng.random() < 0.8:
                d[k] = vals[int(rng.integers(len(vals)))]
        if rng.random() < 0.3:
            d["s"] = "2018-03-01T00:00:00Z"
        if rng.random() < 0.5:
            d["h"] = {"k": strs[int(rng.integers(len(strs)))],
                      "j": strs[int(rng.integers(len(strs)))]}
        out.append(d)
    return out


def atom_world(texts, manifest: dict, dicts, max_str_len: int):
    """BOOL expressions that lower on the device as one atom each over
    one layout → (AtomProgram, CPU batch of `dicts`)."""
    import numpy as np
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.compiler import layout as lay_mod
    from istio_tpu_torch.compiler import tensor_expr as te
    from istio_tpu_torch.compiler.op_lower import lower_programs
    from istio_tpu_torch.expr.checker import (AttributeDescriptorFinder,
                                              DEFAULT_FUNCS, eval_type)
    from istio_tpu_torch.expr.parser import parse
    from istio_tpu_torch.ops import field_ops as fo

    finder = AttributeDescriptorFinder(manifest)
    asts, reqs = [], te.Requirements()
    for text in texts:
        try:
            ast = parse(text)
            if eval_type(ast, finder, DEFAULT_FUNCS).name != "BOOL":
                continue
            r = te.Requirements()
            te.collect_requirements(ast, finder, r)
        except Exception:          # parse / type errors, host fallback
            continue
        reqs.merge(r)
        asts.append(ast)
    layout = lay_mod.build_layout(
        manifest, sorted(reqs.derived_keys),
        sorted(reqs.byte_sources, key=str), max_str_len=max_str_len,
        extern_sources=[(n, k, a) for (n, k), a in
                        sorted(reqs.extern_sources.items(),
                               key=lambda kv: kv[0])])
    interner = lay_mod.InternTable()
    ctx = te._Ctx(layout, interner, finder)
    fns, kept = [], []
    for ast in asts:
        try:
            fns.append(te._compile_node(ast, ctx))
        except te.HostFallback:
            continue
        kept.append(ast)
    atoms = fo.AtomProgram(
        fns=fns, prog=lower_programs(kept, layout, interner, finder),
        cols=np.arange(len(fns), dtype=np.int32))
    batch = lay_mod.Tensorizer(layout, interner).tensorize(
        [bag_from_mapping(d) for d in dicts])
    return atoms, batch


def atom_edge_checks(int_rate: float) -> list[dict]:
    """Phase 6b: atom_eval against atom_eval_plain (the closures) and
    atom_eval_ops_plain (the op table) on the card: the atom world —
    every BOOL expression of the port's copy of the conformance corpus
    that lowers on the device, one atom each, over the corpus inputs
    tiled to B=2048 — and EDGE_ATOMS over B = 777 records at a cap of 8
    bytes, and at a cap of 32 on a plane narrowed to 12 bytes (records
    whose strings fit). Each world's launch is timed beside its plain
    version and its bound: the byte ops (B3's rest) dominate the edge
    worlds. → one row per world."""
    import torch
    from istio_tpu_torch.attribute.types import ValueType
    from istio_tpu_torch.ops import field_ops as fo
    from istio_tpu_torch.testing import corpus

    inputs = [c.input for c in corpus.CORPUS if c.compile_err is None]
    edge_man = {k: ValueType[v] for k, v in EDGE_ATOM_MANIFEST.items()}
    edge = edge_atom_dicts(777, seed=61)
    worlds = [("corpus", [c.e for c in corpus.CORPUS],
               corpus.CORPUS_MANIFEST,
               (inputs * (HEADLINE_B // len(inputs) + 1))[:HEADLINE_B], 128,
               None),
              ("edge cap 8", EDGE_ATOMS, edge_man, edge, 8, None),
              ("edge narrowed", EDGE_ATOMS, edge_man, [d for d in edge if all(
                  len(v) <= 12 for v in d.values() if isinstance(v, str))],
               32, 12)]
    rows = []
    for tag, texts, man, dicts, cap, width in worlds:
        atoms, batch = atom_world(texts, man, dicts, cap)
        if width is not None:
            batch = dataclasses.replace(
                batch, str_bytes=batch.str_bytes[:, :, :width].contiguous())
        batch = batch.to("cuda")
        b = batch.ids.shape[0]
        got, want = atom_eval_checked(f"atom_eval {tag}", batch, atoms,
                                      atoms.n)
        opcodes = {int(o) for o in atoms.prog.ops[:, 0]}
        ms, call, how = timed(lambda: fo.atom_eval(batch, atoms, *got), 100)
        plain, _, _ = timed(lambda: fo.atom_eval_plain(batch, atoms, *want),
                            5)
        nb, ops = atom_work(batch, atoms)
        bms, by = bound(nb, ops, int_rate)
        log(f"[6b] atom_eval {tag}: {atoms.n} atoms ({len(atoms.prog.ops)} "
            f"op rows, {len(opcodes)} opcodes, stack {atoms.prog.need}) x "
            f"B={b} width {batch.str_bytes.shape[2]}: m and n equal to the "
            f"closures and to the op table; {ms_label(how)} {ms:.5f} ms "
            "(per call "
            f"incl. launch {call:.5f}) plain {plain:.5f} ms bound "
            f"{bms:.6f} ms ({by}; {nb:.0f} B, {ops:.0f} ops) [{how}]")
        rows.append({"world": tag, "atoms": atoms.n, "b": b, "ms": ms,
                     "call_ms": call, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by})
    return rows


# atom_eval / field_eval seams (phases 6b, 8b): record counts either side
# of a tile of 32 and of 2,048; atom counts either side of a group of 32,
# the route world's 13 and the authz world's 306; field counts either side
# of a valid word; programs whose stacks need 1, 3, 4 (the register-stack
# kernels) and 5 (the general one): balanced trees of EQ leaves
SEAM_B = (1, 31, 32, 33, 2047, 2048)
SEAM_A = (1, 13, 31, 32, 33, 306)
SEAM_F = (0, 1, 31, 32, 33, 64, 65)
SEAM_NEED_LEAVES = {3: 2, 4: 4, 5: 8}


def balanced(leaves: list[str], ops=("&&", "||")) -> str:
    """A balanced tree of `leaves`, alternating the two operators by
    level: of 2^k EQ leaves, its program needs a stack of k + 2."""
    level = 0
    while len(leaves) > 1:
        op = ops[level % len(ops)]
        leaves = [f"({leaves[i]} {op} {leaves[i + 1]})"
                  if i + 1 < len(leaves) else leaves[i]
                  for i in range(0, len(leaves), 2)]
        level += 1
    return leaves[0]


def stack_need(rows) -> int:
    """The deepest stack the op rows of one program reach."""
    from istio_tpu_torch.ops import field_ops as fo
    depth = best = 0
    for op in rows[:, 0]:
        if int(op) in fo.TWO_OPERAND:
            depth -= 1
        elif int(op) not in (fo.OP_BPRED, fo.OP_DFA):
            depth += 1
        best = max(best, depth)
    return best


def sub_program(prog, picks):
    """The OpProgram of programs `picks` (indices into prog, repeats
    allowed) over prog's layout, constant rows and DFA bank."""
    import numpy as np
    from istio_tpu_torch.ops import field_ops as fo
    rows = [prog.ops[prog.starts[i]:prog.starts[i + 1]] for i in picks]
    starts = np.zeros(len(picks) + 1, np.int32)
    starts[1:] = np.cumsum([len(r) for r in rows])
    ops = np.concatenate(rows).astype(np.int32) if rows else \
        np.zeros((0, fo.OP_WIDTH), np.int32)
    return fo.OpProgram(ops=ops, starts=starts, consts=prog.consts,
                        dfa=prog.dfa, max_len=prog.max_len,
                        need=max([stack_need(r) for r in rows], default=1))


def strided_planes(batch):
    """The batch with ids, present and map_present as column views of
    wider planes whose rows start off a 16-byte boundary, the columns
    beside them filled with junk."""
    import torch

    def widen(t, junk):
        w = torch.full((t.shape[0], t.shape[1] + 8), junk, dtype=t.dtype,
                       device=t.device)
        w[:, 3:3 + t.shape[1]] = t
        return w[:, 3:3 + t.shape[1]]
    return dataclasses.replace(batch, ids=widen(batch.ids, 12345),
                               present=widen(batch.present, True),
                               map_present=widen(batch.map_present, True))


def planned(entry: str, batch, prog):
    from istio_tpu_torch.ops import field_ops as fo
    return fo.launch_plan(entry, int(batch.ids.shape[0]), prog)


def atom_seam_checks() -> int:
    """Phase 6b seams: atom_eval against both plain versions at every
    SEAM_A atoms x SEAM_B records, each with a register-stack launch
    (every program of need <= 4) and a general one (a need-5 program
    among them), atoms at scattered columns of ext planes twice as wide
    that hold a seeded pattern elsewhere; then, at (306, 2,047) and
    (33, 33), the same launches with ids / present / map_present as
    strided views, and the narrowed edge world (cap 32, byte plane 12
    wide) on strided planes. → cases."""
    import numpy as np
    from istio_tpu_torch.attribute.types import ValueType
    from istio_tpu_torch.ops import field_ops as fo
    edge_man = {k: ValueType[v] for k, v in EDGE_ATOM_MANIFEST.items()}
    need_texts = ["b"] + [balanced([f"{'nm'[i % 2]} == {i % 5}"
                                    for i in range(k)])
                          for k in SEAM_NEED_LEAVES.values()]
    atoms, full = atom_world(list(EDGE_ATOMS) + need_texts, edge_man,
                             edge_atom_dicts(max(SEAM_B), seed=62), 8)
    full = full.to("cuda")
    needs = [stack_need(atoms.prog.ops[atoms.prog.starts[i]:
                                       atoms.prog.starts[i + 1]])
             for i in range(atoms.n)]
    if not {1, 3, 4, 5} <= set(needs):
        raise AssertionError(f"atom seams: stack needs {sorted(set(needs))}")
    shallow = [i for i, n in enumerate(needs) if n <= fo.SHALLOW]
    deep = needs.index(5)
    rng = np.random.default_rng(63)
    cases = 0

    def run(tag, batch, picks, cols, x):
        prog = fo.AtomProgram(fns=[atoms.fns[i] for i in picks],
                              prog=sub_program(atoms.prog, picks),
                              cols=cols)
        plan = planned("atom_eval", batch, prog.prog)
        if plan.deep != (prog.prog.need > fo.SHALLOW):
            raise AssertionError(f"{tag}: plan deep={plan.deep} for need "
                                 f"{prog.prog.need}")
        atom_eval_checked(tag, batch, prog, x, seed=len(picks))

    for a in SEAM_A:
        x = 2 * a + 7
        cols = rng.permutation(x)[:a].astype(np.int32)
        kinds = {"shallow": [shallow[i % len(shallow)] for i in range(a)]}
        kinds["deep"] = kinds["shallow"][:-1] + [deep]
        for b in SEAM_B:
            batch = full.rows(0, b)
            for kind, picks in kinds.items():
                run(f"atom_eval seam A={a} B={b} {kind}", batch, picks, cols,
                    x)
                cases += 1
            if (a, b) not in ((306, 2047), (33, 33)):
                continue
            for kind, picks in kinds.items():
                run(f"atom_eval seam A={a} B={b} {kind} strided",
                    strided_planes(batch), picks, cols, x)
                cases += 1
    edge = edge_atom_dicts(777, seed=61)
    narrow, nbatch = atom_world(EDGE_ATOMS, edge_man, [d for d in edge if all(
        len(v) <= 12 for v in d.values() if isinstance(v, str))], 32)
    nbatch = dataclasses.replace(
        nbatch, str_bytes=nbatch.str_bytes[:, :, :12].contiguous()).to("cuda")
    atom_eval_checked("atom_eval seam narrowed", strided_planes(nbatch),
                      narrow, narrow.n)
    return cases + 1


def list_world_store():
    """tests/test_fused_serving.py's store (the listchecker's usual
    deployments beside deniers): a STRINGS whitelist, a map-derived
    STRINGS blacklist, a fallback-expression whitelist and a
    case-insensitive list (both stay on the host), a REGEX path
    blacklist and an IP_ADDRESSES blacklist over source.ip, a denier, a
    host-fallback predicate and a namespace-scoped rule."""
    from istio_tpu_torch.runtime.store import MemStore
    s = MemStore()
    lst = lambda **p: {"adapter": "list", "params": p}  # noqa: E731
    inst = lambda t, **p: {"template": t, "params": p}  # noqa: E731
    for name, spec in (
            ("nswhitelist", lst(overrides=["default", "prod"],
                                blacklist=False, caching_ttl_s=30.0)),
            ("uablacklist", lst(overrides=["badbot"], blacklist=True)),
            ("verwhitelist", lst(overrides=["v1", "v2"], blacklist=False)),
            ("rxlist", lst(overrides=["^/api/"], entry_type="REGEX",
                           blacklist=True)),
            ("ipblock", lst(overrides=["10.0.0.0/8", "2001:db8::/32"],
                            entry_type="IP_ADDRESSES", blacklist=True)),
            ("cilist", lst(overrides=["Mozilla"],
                           entry_type="CASE_INSENSITIVE_STRINGS",
                           blacklist=True)),
            ("denyall", {"adapter": "denier", "params": {
                "status_code": 7, "status_message": "admin is off limits",
                "valid_duration_s": 3.0, "valid_use_count": 100}})):
        s.set(("handler", "istio-system", name), spec)
    for name, spec in (
            ("srcns", inst("listentry", value="source.namespace")),
            ("ua", inst("listentry", value='request.headers["user-agent"]')),
            ("appversion", inst("listentry",
                                value='source.labels["version"] | "none"')),
            ("path", inst("listentry", value="request.path")),
            ("srcip", inst("listentry", value="source.ip")),
            ("nothing", inst("checknothing"))):
        s.set(("instance", "istio-system", name), spec)
    rule = lambda m, *acts: {"match": m, "actions": [  # noqa: E731
        {"handler": h, "instances": list(i)} for h, *i in acts]}
    for ns, name, spec in (
            ("istio-system", "r0-denyadmin",
             rule('request.path.startsWith("/admin")',
                  ("denyall", "nothing"))),
            ("istio-system", "r1-nscheck",
             rule('destination.service == "ratings.default.svc.cluster.local"',
                  ("nswhitelist", "srcns"))),
            ("istio-system", "r2-uacheck",
             rule("connection.mtls", ("uablacklist", "ua"))),
            ("istio-system", "r3-version",
             rule('request.method == "POST"', ("verwhitelist", "appversion"))),
            ("istio-system", "r4-rx",
             rule('request.scheme == "http"', ("rxlist", "path"))),
            ("istio-system", "r5-dynkey",
             rule('request.headers[request.method] == "x"',
                  ("denyall", "nothing"))),
            ("prod", "r6-prodonly",
             rule("request.size > 100", ("denyall.istio-system",
                                          "nothing.istio-system"))),
            ("istio-system", "r7-mixed",
             rule('request.method == "DELETE"', ("denyall", "nothing"),
                  ("verwhitelist", "appversion"))),
            ("istio-system", "r8-ip",
             rule('request.scheme == "https"', ("ipblock", "srcip"))),
            ("istio-system", "r9-ci",
             rule('request.useragent == "x"', ("cilist", "ua")))):
        s.set(("rule", ns, name), spec)
    return s


def list_world_dicts() -> list[dict]:
    """Bags for the list world: a regex prefix hit and miss, truncated
    paths either way, IPv4, IPv6, v4-mapped IPv6 in and out of the nets,
    malformed IP lengths, an absent source.ip and path, beside the
    store's denier, whitelist and blacklist cases."""
    v4m = b"\x00" * 10 + b"\xff\xff"
    http, https = {"request.scheme": "http"}, {"request.scheme": "https"}
    return [
        {"request.path": "/admin/keys"}, {"request.path": "/ratings/1"},
        {"destination.service": "ratings.default.svc.cluster.local",
         "source.namespace": "evil"},
        {"connection.mtls": True, "request.headers": {"user-agent": "badbot"}},
        {"request.method": "POST", "source.labels": {"version": "v9"}},
        {"request.method": "GET", "request.headers": {"GET": "x"}},
        {"destination.service": "api.prod.svc.cluster.local",
         "request.size": 500},
        dict(http, **{"request.path": "/api/x"}),
        dict(http, **{"request.path": "/web/x"}),
        dict(http, **{"request.path": "/api/" + "x" * 200}),
        dict(http, **{"request.path": "/web/" + "x" * 200}),
        dict(http),
        dict(https, **{"source.ip": v4m + bytes([10, 1, 2, 3])}),
        dict(https, **{"source.ip": bytes([10, 0, 0, 1])}),
        dict(https, **{"source.ip": bytes.fromhex("20010db8") + b"\0" * 12}),
        dict(https, **{"source.ip": v4m + bytes([11, 1, 2, 3])}),
        dict(https, **{"source.ip": bytes([11, 0, 0, 1])}),
        dict(https, **{"source.ip": bytes.fromhex("fe80") + b"\0" * 14}),
        dict(https, **{"source.ip": b"\x01\x02\x03"}),
        dict(https, **{"source.ip": b""}),
        dict(https),
        {"request.useragent": "x",
         "request.headers": {"user-agent": "mozilla"}},
    ]


def list_phase(int_rate: float) -> dict:
    """Phase 7: the list world on the card against the same store served
    on the CPU, with the launch counters zeroed just before its drive and
    read just after: every response field and the rule counts equal at
    B ∈ {the bags once, 64, 2048 (the bags repeated)}, with the byte
    tiers both used; every kernel must launch, list_banks among them.
    The B=2048 batch is captured, and every kernel of it is held against
    its plain version (timed: the list_banks row)."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

    store, cpu_store = list_world_store(), list_world_store()
    srv = RuntimeServer(store, ServerArgs(buckets=E2E_BATCHES),
                        device="cuda")
    cpu = RuntimeServer(cpu_store, ServerArgs(**CPU_SERVER), device="cpu")
    plan = srv.controller.dispatcher.fused
    eng = plan.engine
    log(f"[7] list world: {plan.fused_deny} deny / {plan.fused_lists} lists "
        f"fused ({eng._rx_lists.n} REGEX, {eng._cidr_lists.n} IP_ADDRESSES); "
        f"host-overlay rules {sorted(plan.host_actions)}; unfused list kinds "
        f"{list(plan.unfused_list_kinds)}")
    dicts = list_world_dicts()
    kernels.launches.reset()
    steps = 0
    for b in (len(dicts), 64, HEADLINE_B):
        bags = [bag_from_mapping(x) for x in
                (dicts * (b // len(dicts) + 1))[:b]]
        before, cpu_before = rule_counts(srv), rule_counts(cpu)
        got = srv.check_many(bags)
        compare_responses(f"lists B={b}", got, cpu.check_many(bags))
        compare_counts(f"lists B={b}", counts_since(srv, before),
                       counts_since(cpu, cpu_before))
        steps += 1
        codes = sorted({r.status_code for r in got})
        if b == len(dicts):
            short = [bag_from_mapping(x) for x in dicts
                     if len(x.get("request.path", "")) <= 32]
            compare_responses("lists, small byte tier",
                              srv.check_many(short), cpu.check_many(short))
            steps += 1
            if codes != [0, 5, 7, 13]:
                raise AssertionError(f"list world statuses {codes}")
        log(f"[7] lists B={b}: every response field and the rule counts "
            f"equal to the device='cpu' server (statuses {codes})")
        if b == HEADLINE_B:
            with kernels.launches.capture() as captured:
                srv.check_many(bags)
            steps += 1
            torch.cuda.synchronize()
    out = path_counts("[7] list path", LIST_KERNELS, steps)
    one_lit_launch_per_group("[7] list path", out, eng.ruleset,
                             plane_ok=("dfa_scan",))
    log(f"[7] list path, B={HEADLINE_B}: every kernel against its plain "
        "version on its own inputs (timed):")
    rows = check_kernels(captured, eng.quota_counts.clone(), int_rate)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    return {**out, "rows": rows}


def random_list_world(b: int = HEADLINE_B, seed: int = 12):
    """Phase 7b's random list world on the card: 64 REGEX lists over 256
    acceptance columns (a third of the patterns with `$`), values on four
    byte slots with a quarter of the rows truncated, lists sharing rules;
    and 64 IP_ADDRESSES lists x 16 entries of mixed versions and prefix
    lengths over values of length 4, 16 (v4-mapped or not) and malformed
    lengths → (acc, str_bytes, (regex lens, ip lens), max_len, rx, cidr,
    n_rules): lstate has 128 positions."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import bytes_ops

    rng = np.random.default_rng(seed)
    n_slots, width, n_pat, n_rules = 4, 128, 256, 200
    acc = torch.from_numpy(rng.random((b, n_pat)) < 0.05).cuda()
    lens = rng.integers(0, width + 40, size=(b, n_slots)).astype(np.int32)
    lens[rng.random((b, n_slots)) < 0.25] = width
    ptr, pat = [0], []
    for _ in range(64):
        pat.extend(rng.choice(n_pat, size=int(rng.integers(1, 9)),
                              replace=False).tolist())
        ptr.append(len(pat))
    rx = bytes_ops.RegexLists(
        pos=np.arange(0, 128, 2, dtype=np.int32),
        rule=rng.integers(0, n_rules, size=64).astype(np.int32),
        bslot=rng.integers(0, n_slots, size=64).astype(np.int32),
        ptr=np.asarray(ptr, np.int32), pat=np.asarray(pat, np.int32),
        pdef=(rng.random(n_pat) > 1 / 3).astype(np.uint8))
    nets = []
    for _ in range(64):
        ents = []
        for _ in range(16):
            if rng.random() < 0.5:
                a = rng.integers(0, 256, size=4)
                ents.append(f"{a[0]}.{a[1]}.{a[2]}.{a[3]}/"
                            f"{int(rng.integers(0, 33))}")
            else:
                a = rng.integers(0, 1 << 16, size=8)
                ents.append(":".join(f"{x:x}" for x in a) +
                            f"/{int(rng.integers(0, 129))}")
        nets.append(ents)
    cidr = bytes_ops.CidrLists.of(list(range(1, 128, 2)),
                                  rng.integers(0, n_slots, size=64).tolist(),
                                  nets)
    data = rng.integers(0, 256, size=(b, n_slots, width)).astype(np.uint8)
    data[::3, :, :8] = 0                      # near the :: and v4 nets
    data[1::3, :, :12] = np.frombuffer(b"\0" * 10 + b"\xff\xff", np.uint8)
    data[:, :, 12:16] = np.where(rng.random((b, n_slots, 1)) < 0.5, 10,
                                 data[:, :, 12:16])
    ip_lens = rng.choice([4, 16, 16, 0, 3, 5, 17], size=(b, n_slots))
    return (acc, torch.from_numpy(data).cuda(),
            (torch.from_numpy(lens).cuda(),
             torch.from_numpy(ip_lens.astype(np.int32)).cuda()),
            width, rx, cidr, n_rules)


# the sized list world: one blocklist about the size of a public one
# (Spamhaus DROP: about a thousand CIDR nets) and one REGEX path list
SIZED_CIDR_ENTRIES = 1024
SIZED_REGEX_PATTERNS = 64


def cidr_nets(rng, n: int, v6_share: float) -> list:
    """n CIDR nets made from rng: v4 /8 to /32, and (a v6_share of
    them) v6 /16 to /128."""
    import ipaddress
    nets = []
    for _ in range(n):
        if rng.random() >= v6_share:
            a = rng.integers(0, 256, size=4)
            nets.append(ipaddress.ip_network(
                f"{a[0]}.{a[1]}.{a[2]}.{a[3]}/{int(rng.integers(8, 33))}",
                strict=False))
        else:
            a = rng.integers(0, 1 << 16, size=8)
            nets.append(ipaddress.ip_network(
                ":".join(f"{x:x}" for x in a) +
                f"/{int(rng.integers(16, 129))}", strict=False))
    return nets


def cidr_values(rng, nets: list, b: int, width: int = 128):
    """b IP values (uint8 [b, width], int32 lengths) over `nets`: half
    inside a net (where there is one), a tenth of the v4 ones v4-mapped
    16-byte values, a tenth of the rest v6, one in 64 of a malformed
    length (0, 3, 5 or 17)."""
    import numpy as np
    data = np.zeros((b, width), np.uint8)
    lens = np.zeros(b, np.int32)
    for i in range(b):
        inside = bool(nets) and rng.random() < 0.5
        net = nets[int(rng.integers(0, len(nets)))] if inside else None
        v6 = net.version == 6 if inside else rng.random() < 0.1
        if inside:
            host = int.from_bytes(rng.bytes(16), "big") & int(net.hostmask)
            addr = int(net.network_address) | host
        else:
            addr = int.from_bytes(rng.bytes(16 if v6 else 4), "big")
        if v6:
            raw = addr.to_bytes(16, "big")
        elif rng.random() < 0.1:                    # v4-mapped IPv6
            raw = b"\0" * 10 + b"\xff\xff" + addr.to_bytes(4, "big")
        else:
            raw = addr.to_bytes(4, "big")
        data[i, :len(raw)] = np.frombuffer(raw, np.uint8)
        lens[i] = len(raw) if rng.random() >= 1 / 64 else \
            int(rng.choice([0, 3, 5, 17]))
    return data, lens


def sized_list_world(b: int = HEADLINE_B, seed: int = 15,
                     n_entries: int = SIZED_CIDR_ENTRIES):
    """The sized list world on the card: one IP_ADDRESSES blocklist of
    n_entries CIDR nets made from a seed (about 90 % v4, /8 to /32; about
    10 % v6, /16 to /128) on byte slot 0, and one REGEX path list of
    SIZED_REGEX_PATTERNS patterns (two thirds `$`-free) on slot 1. Of the
    b values (cidr_values), half lie inside some entry, about a tenth
    are v6 and a tenth v4-mapped, one in 64 has a malformed length; half
    the paths have a pattern hit in the acceptance plane and a quarter
    are truncated → (acc, str_bytes, str_lens, max_len, rx, cidr,
    n_rules): lstate has 2 positions (the REGEX list at 0, the blocklist
    at 1)."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import bytes_ops

    rng = np.random.default_rng(seed)
    width, n_pat, n_rules = 128, SIZED_REGEX_PATTERNS, 4
    nets = cidr_nets(rng, n_entries, 0.1)
    data = np.zeros((b, 2, width), np.uint8)
    lens = np.zeros((b, 2), np.int32)
    data[:, 0], lens[:, 0] = cidr_values(rng, nets, b, width)
    data[:, 1] = rng.integers(32, 127, size=(b, width))
    lens[:, 1] = rng.integers(1, width, size=b)
    lens[rng.random(b) < 0.25, 1] = width               # truncated
    acc = np.zeros((b, n_pat), bool)
    hit = rng.random(b) < 0.5
    acc[hit, rng.integers(0, n_pat, size=int(hit.sum()))] = True
    rx = bytes_ops.RegexLists(
        pos=np.zeros(1, np.int32), rule=np.zeros(1, np.int32),
        bslot=np.ones(1, np.int32), ptr=np.asarray([0, n_pat], np.int32),
        pat=np.arange(n_pat, dtype=np.int32),
        pdef=(rng.random(n_pat) > 1 / 3).astype(np.uint8))
    cidr = bytes_ops.CidrLists.of([1], [0], [[str(x) for x in nets]])
    return (torch.from_numpy(acc).cuda(), torch.from_numpy(data).cuda(),
            torch.from_numpy(lens).cuda(), width, rx, cidr, n_rules)


# list_banks edge lists (phase 7b): entries a CIDR list, each as a mixed,
# a v4-only and a v6-only list, and 64 lists of 33 entries
LIST_EDGE_E = (0, 1, 31, 32, 33, 1024)


def list_edge_worlds(b: int = HEADLINE_B):
    """Phase 7b's CIDR edge worlds on the card → [(tag, str_bytes,
    str_lens, cidr, n_pos)]: for each LIST_EDGE_E a mixed, a v4-only and
    a v6-only list over one slot of values inside their nets (and not),
    and K = 64 lists of 33 entries over four slots; each world also with
    its value rows at an odd address and with a row stride of two rows
    (a strided view)."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import bytes_ops
    rng = np.random.default_rng(71)
    width = 40
    worlds = []
    for e in LIST_EDGE_E:
        nets = [cidr_nets(rng, e, share) for share in (0.3, 0.0, 1.0)]
        data, lens = cidr_values(rng, [x for n in nets for x in n], b,
                                 width)
        cidr = bytes_ops.CidrLists.of([0, 1, 2], [0, 0, 0],
                                      [[str(x) for x in n] for n in nets])
        worlds.append((f"E={e}", data[:, None], lens[:, None], cidr, 3))
    nets = [cidr_nets(rng, 33, float(rng.random())) for _ in range(64)]
    data = np.zeros((b, 4, width), np.uint8)
    lens = np.zeros((b, 4), np.int32)
    flat = [x for n in nets for x in n]
    for slot in range(4):
        data[:, slot], lens[:, slot] = cidr_values(rng, flat, b, width)
    cidr = bytes_ops.CidrLists.of(list(range(64)),
                                  rng.integers(0, 4, 64).tolist(),
                                  [[str(x) for x in n] for n in nets])
    worlds.append(("K=64 E=33", data, lens, cidr, 64))
    out = []
    for tag, data, lens, cidr, n_pos in worlds:
        sb = torch.from_numpy(data).cuda()
        sl = torch.from_numpy(lens).cuda()
        odd = torch.zeros((b, sb.shape[1], width + 1), dtype=torch.uint8,
                          device="cuda")
        odd[:, :, 1:] = sb
        wide = torch.zeros((2 * b, sb.shape[1], width), dtype=torch.uint8,
                           device="cuda")
        wide[::2] = sb
        out += [(tag, sb, sl, cidr, n_pos),
                (f"{tag} odd address", odd[:, :, 1:], sl, cidr, n_pos),
                (f"{tag} strided", wide[::2], sl, cidr, n_pos)]
    return out


def list_banks_edge_checks() -> int:
    """Phase 7b: list_banks against its plain versions (the reference's
    formulas and the word formulation, list_banks_words_plain) on random
    inputs at B=2048 (random_list_world: 64 REGEX lists over 256 pattern
    columns, 64 IP_ADDRESSES lists x 16 entries) on its two value
    layouts; on the CIDR edge worlds (list_edge_worlds: E = 0, 1, 31, 32,
    33 and 1,024 as mixed, v4-only and v6-only lists, K = 64 lists,
    value rows contiguous, at an odd address and strided); and on the
    sized list world (a 1,024-entry blocklist and a 64-pattern path
    list, both banks in one launch). → cases."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.ops import bytes_ops

    acc, sb, lens_pair, width, rx, cidr, n_rules = random_list_world()
    b = int(acc.shape[0])
    cases = 0
    for sl in lens_pair:
        outs = [(torch.zeros((b, 128), dtype=torch.uint8, device="cuda"),
                 torch.rand(b, n_rules, device="cuda") < 0.01)
                for _ in range(2)]
        outs[1][1].copy_(outs[0][1])
        bytes_ops.list_banks(acc, sb, sl, width, rx, cidr, *outs[0])
        bytes_ops.regex_list_plain(acc, sl, width, *rx.on(acc.device),
                                   *outs[1])
        bytes_ops.cidr_list_plain(sb, sl, *cidr.on(sb.device), outs[1][0])
        for part, g, w in zip(("lstate", "err"), *outs):
            assert_equal(f"list_banks edge {part}", g, w)
        st = outs[0][0]
        bits = [int(((st & m) != 0).sum()) for m in (1, 2, 4)]
        if sl is lens_pair[0] and not (bits[0] and bits[1]):
            raise AssertionError(f"list_banks edge: member / und {bits}")
        if sl is not lens_pair[0] and not (bits[0] and bits[2]):
            raise AssertionError(f"list_banks edge: member / bad {bits}")
        cases += 1
    # CIDR edge lists, both banks of the sized world in one launch
    worlds = [(tag, None, sb, sl, 0, None, c, n_pos, 1)
              for tag, sb, sl, c, n_pos in list_edge_worlds(b)]
    acc, sb, sl, width, rx, cidr, n_rules = sized_list_world(b)
    worlds.append(("sized", acc, sb, sl, width, rx, cidr, 2, n_rules))
    for tag, acc, sb, sl, width, rx, cidr, n_pos, n_rules in worlds:
        outs = [(torch.zeros((b, n_pos), dtype=torch.uint8, device="cuda"),
                 torch.zeros((b, n_rules), dtype=torch.bool, device="cuda"))
                for _ in range(3)]
        g0 = kernels.launches.grids["list_banks"]
        bytes_ops.list_banks(acc, sb, sl, width, rx, cidr, *outs[0])
        if kernels.launches.grids["list_banks"] - g0 != 1:
            raise AssertionError(f"list_banks edge {tag}: not one launch")
        if rx is not None:
            bytes_ops.regex_list_plain(acc, sl, width, *rx.on(acc.device),
                                       *outs[1])
        bytes_ops.cidr_list_plain(sb, sl, *cidr.on(sb.device), outs[1][0])
        bytes_ops.list_banks_words_plain(acc, sb, sl, width, rx, cidr,
                                         *outs[2])
        for part, g, w, x in zip(("lstate", "err"), *outs):
            assert_equal(f"list_banks edge {tag} {part}", g, w)
            assert_equal(f"list_banks edge {tag} {part} (word plain)", x, w)
        st = outs[0][0]
        e_n = int(cidr.valid.sum())
        if e_n and not bool(((st & 1) != 0).any()):
            raise AssertionError(f"list_banks edge {tag}: no member")
        cases += 1
    return cases


TELEMETRY_HTTP = ("requestcount", "requestduration", "requestsize",
                  "responsesize")
TELEMETRY_TCP = ("tcpbytesent", "tcpbytereceived")


def telemetry_world(store, log_stream: str) -> None:
    """Istio's default Mixer telemetry config (install/kubernetes/
    istio.yaml of Istio 0.4/0.5: its metric, prometheus, stdio, logentry
    and rule resources) added to `store` with store.set alone, so that
    either package's MemStore takes it: six metrics into a prometheus
    handler `handler` and the accesslog logentry into a stdio handler
    `stdio`. The one change to upstream's config is the stdio handler's
    `log_stream`: upstream writes STDOUT, here the lines go to the file
    `log_stream`, so that this script's output stays its own."""
    ns = "istio-system"
    labels = ["source_service", "source_version", "destination_service",
              "destination_version", "response_code", "connection_mtls"]
    tcp_labels = [x for x in labels if x != "response_code"]
    kinds = {"requestcount": "COUNTER", "requestduration": "DISTRIBUTION",
             "requestsize": "DISTRIBUTION", "responsesize": "DISTRIBUTION",
             "tcpbytesent": "COUNTER", "tcpbytereceived": "COUNTER"}
    store.set(("handler", ns, "handler"), {
        "adapter": "prometheus", "params": {"metrics": [
            {"name": f"{m}.{ns}", "kind": kinds[m],
             "label_names": labels if m in TELEMETRY_HTTP else tcp_labels}
            for m in TELEMETRY_HTTP + TELEMETRY_TCP]}})
    store.set(("handler", ns, "stdio"), {
        "adapter": "stdio", "params": {"log_stream": log_stream}})
    dims = {"source_service": 'source.service | "unknown"',
            "source_version": 'source.labels["version"] | "unknown"',
            "destination_service": 'destination.service | "unknown"',
            "destination_version":
                'destination.labels["version"] | "unknown"',
            "response_code": "response.code | 200",
            "connection_mtls": "connection.mtls | false"}
    values = {"requestcount": "1",
              "requestduration": 'response.duration | "0ms"',
              "requestsize": "request.size | 0",
              "responsesize": "response.size | 0",
              "tcpbytesent": "connection.sent.bytes | 0",
              "tcpbytereceived": "connection.received.bytes | 0"}
    for m, value in values.items():
        store.set(("instance", ns, m), {"template": "metric", "params": {
            "value": value,
            "dimensions": {k: v for k, v in dims.items()
                           if m in TELEMETRY_HTTP or k != "response_code"},
            "monitored_resource_type": '"UNSPECIFIED"'}})
    store.set(("instance", ns, "accesslog"), {
        "template": "logentry", "params": {
            "severity": '"Default"', "timestamp": "request.time",
            "variables": {
                "sourceIp": 'source.ip | ip("0.0.0.0")',
                "destinationIp": 'destination.ip | ip("0.0.0.0")',
                "sourceUser": 'source.user | ""',
                "method": 'request.method | ""',
                "url": 'request.path | ""',
                "protocol": 'request.scheme | "http"',
                "responseCode": "response.code | 0",
                "responseSize": "response.size | 0",
                "requestSize": "request.size | 0",
                "latency": 'response.duration | "0ms"'}}})
    q = lambda *names: [f"{x}.{ns}" for x in names]  # noqa: E731
    for name, match, handler, insts in (
            ("promhttp", 'context.protocol == "http"', "handler",
             TELEMETRY_HTTP),
            ("promtcp", 'context.protocol == "tcp"', "handler",
             TELEMETRY_TCP),
            ("stdio", "true", "stdio", ("accesslog",))):
        store.set(("rule", ns, name), {"match": match, "actions": [
            {"handler": f"{handler}.{ns}", "instances": q(*insts)}]})


def telemetry_dicts(b: int, seed: int) -> list[dict]:
    """Report traffic for the telemetry world: make_request_dicts(b,
    seed) plus seeded report attributes — context.protocol http on 90 %
    of records and tcp on 10 %, response.code in {200, 404, 503},
    response.size (absent on 1 in 6), response.duration, request.time,
    source.service, source / destination labels with version v1 or v2
    (absent on 1 in 5), IPv4 source / destination ips (absent on 1 in
    7), and the connection byte counts on tcp records. These ratios are
    a synthetic mix chosen for parity coverage (every default branch of
    the config, both rules), not taken from a measured deployment: the
    http / tcp split sets the instances per record (5 against 3), so
    report() walls at this mix are this mix's only."""
    import datetime

    import numpy as np
    from istio_tpu_torch.testing import workloads
    rng = np.random.default_rng(seed)
    t0 = datetime.datetime(2018, 3, 1, 12, 0, 0,
                           tzinfo=datetime.timezone.utc)
    dicts = workloads.make_request_dicts(b, seed=seed)
    for j, d in enumerate(dicts):
        tcp = rng.random() < 0.1
        d["context.protocol"] = "tcp" if tcp else "http"
        d["response.code"] = int(rng.choice([200, 404, 503]))
        if rng.random() >= 1 / 6:
            d["response.size"] = int(rng.integers(0, 1 << 20))
        d["response.duration"] = datetime.timedelta(
            microseconds=int(rng.integers(0, 2_000_000)))
        d["request.time"] = t0 + datetime.timedelta(milliseconds=j)
        d["source.service"] = \
            f"svc{rng.integers(0, 512)}.ns{rng.integers(0, 23)}" \
            ".svc.cluster.local"
        for side in ("source", "destination"):
            if rng.random() >= 1 / 5:
                d[f"{side}.labels"] = {
                    "version": "v1" if rng.random() < 0.5 else "v2",
                    "app": f"app{rng.integers(0, 40)}"}
            if rng.random() >= 1 / 7:
                d[f"{side}.ip"] = bytes(rng.integers(0, 256, size=4)
                                        .astype(np.uint8).tolist())
        if tcp:
            d["connection.sent.bytes"] = int(rng.integers(0, 1 << 24))
            d["connection.received.bytes"] = int(rng.integers(0, 1 << 24))
    return dicts


class CaptureSink:
    """Stands in for a built report handler: keeps every (template,
    instances) call when `keep` (else counts instances), and hands each
    instance on, one at a time, to the handler it replaced. The
    prometheus adapter refuses a DURATION value (float() of a timedelta,
    as in the JAX package's adapter); those refusals are counted, where
    the dispatcher would log each one as an adapter failure."""

    def __init__(self, inner) -> None:
        self.inner = inner
        self.keep = True
        self.calls: list = []
        self.instances = 0
        self.refused = 0

    def handle_report(self, template, instances) -> None:
        if self.keep:
            self.calls.append((template, [dict(i) for i in instances]))
        self.instances += len(instances)
        for inst in instances:
            try:
                self.inner.handle_report(template, [inst])
            except TypeError:
                self.refused += 1


def program_work(batch, prog) -> tuple[float, float]:
    """(bytes, ops) an op program interpreter must read and do on this
    run's data: each record reads the id and presence of every distinct
    column the programs name, the map-presence byte of every map slot,
    and the length and the stored bytes (up to its length) of every
    byte slot; the op and constant tables are read once. Each op row is
    a few int32 ops per record, and each byte op compares one byte per
    stored byte of the slot it reads."""
    import torch
    from istio_tpu_torch.ops import field_ops as fo
    ops = prog.ops
    cols, maps, slots, byte_rows = set(), set(), set(), {}
    for o in ops:
        if o[0] in (fo.OP_VAR, fo.OP_DSLOT, fo.OP_EXTERN):
            cols.add(int(o[1]))
        elif o[0] == fo.OP_MAPSEL:
            cols |= {int(o[1]), int(o[2])}
            maps |= {int(o[3]), int(o[4])}
        elif o[0] == fo.OP_BSLOT:
            cols.add(int(o[2]))
            slots.add(int(o[1]))
            byte_rows[int(o[1])] = byte_rows.get(int(o[1]), 0) + 1
    nb = batch.ids.shape[0]
    w = batch.str_bytes.shape[2]
    stored = {s: int(torch.clamp(batch.str_lens[:, s], 0, w).sum())
              for s in slots}
    b = nb * (5 * len(cols) + len(maps) + 4 * len(slots)) + \
        sum(stored.values()) + ops.nbytes + prog.starts.nbytes + \
        prog.consts.nbytes
    return float(b), float(nb) * 4 * len(ops) + float(
        sum(stored[s] * k for s, k in byte_rows.items()))


def field_work(batch, prog, got) -> tuple[float, float]:
    """(bytes, ops) field_eval must move and do on this run's data: its
    programs' reads (program_work) and the output rows, written once."""
    b, ops = program_work(batch, prog.prog)
    return b + nbytes(got), ops


def atom_work(batch, atoms) -> tuple[float, float]:
    """(bytes, ops) atom_eval must move and do on this run's data: its
    programs' reads (program_work) and each atom's m and n bytes per
    record, written once."""
    b, ops = program_work(batch, atoms.prog)
    return b + 2.0 * batch.ids.shape[0] * atoms.n + atoms.cols.nbytes, ops


def program_library_ms(batch, prog) -> tuple[float | None, str]:
    """One PyTorch call for a part of an op-program launch: index_select
    of the ids columns its programs read (VAR, DSLOT, EXTERN, MAPSEL),
    the gather only, timed as K1's library rows are. None where the
    programs read no column."""
    import torch
    from istio_tpu_torch.ops import field_ops as fo
    cols = set()
    for o in prog.ops:
        if o[0] in (fo.OP_VAR, fo.OP_DSLOT, fo.OP_EXTERN):
            cols.add(int(o[1]))
        elif o[0] == fo.OP_MAPSEL:
            cols |= {int(o[1]), int(o[2])}
    if not cols:
        return None, "none (the programs read no ids column)"
    idx = torch.tensor(sorted(cols), dtype=torch.long,
                       device=batch.ids.device)
    return time_ms(lambda: torch.index_select(batch.ids, 1, idx), 50), \
        f"torch.index_select(ids, 1, the {len(cols)} columns the " \
        "programs read) (the gather only)"


def seeded_planes(b: int, x: int, seed: int, device: str = "cuda"):
    """Two bool [b, x] ext planes filled with a seeded random pattern
    (the columns atom_eval must leave alone keep it)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random((b, x)) < 0.5).to(device)
                 for _ in range(2))


def atom_eval_checked(tag: str, batch, atoms, x: int, seed: int = 5):
    """atom_eval on ext planes [B, x] holding a seeded pattern, held
    against atom_eval_plain and atom_eval_ops_plain on the same pattern
    (every byte of both planes), and every column outside the atoms'
    columns held unchanged. → (got, want) planes."""
    import torch
    from istio_tpu_torch.ops import field_ops as fo
    b = int(batch.ids.shape[0])
    base = seeded_planes(b, x, seed, str(batch.ids.device))
    got, want, ops_want = (tuple(t.clone() for t in base) for _ in range(3))
    fo.atom_eval(batch, atoms, *got)
    fo.atom_eval_plain(batch, atoms, *want)
    fo.atom_eval_ops_plain(batch, atoms, *ops_want)
    keep = torch.ones(x, dtype=torch.bool, device=base[0].device)
    keep[atoms.cols_on(keep.device).long()] = False
    for part, g, w, o, b0 in zip(("m", "n"), got, want, ops_want, base):
        assert_equal(f"{tag}.{part}", g, w)
        assert_equal(f"{tag}.{part} (op table)", g, o)
        assert_equal(f"{tag}.{part} (columns outside the atoms)",
                     g[:, keep], b0[:, keep])
    return got, want


# report fields for field_eval's edge inputs: every op of the op programs
# (CONST, VAR, DSLOT, MAPSEL, EXTERN, ERR, OR, EQ, NEQ, LAND, LOR, the byte
# views BSLOT and BCONST, an ordered compare CMP, a runtime-pattern prefix
# DPRED, constant byte predicates BPRED, a regex DFA, and a `|` chain
# deeper than a left-to-right stack of 8)
EDGE_FIELDS = (
    "request.size | 0", "connection.mtls", 'source.user | "anon"',
    'request.headers["host"]', '(request.headers | response.headers)["host"]',
    'ip(request.headers["x-ip"])', 'timestamp(request.headers["ts"])',
    'ip("not-an-ip")', 'source.ip | ip("10.0.0.1")',
    "source.user == destination.user", 'request.method != "GET"',
    'connection.mtls && request.method == "GET"',
    "connection.mtls || request.size == 7",
    'request.path.startsWith("/api")', 'match(request.host, "*.local")',
    '"^/api/v[0-9]+/".matches(request.path)',
    "request.path.startsWith(request.host)", "request.size > 100",
    " | (".join(["source.user", "destination.user", "request.host",
                 "request.method", "request.path", "request.scheme",
                 "source.name", "destination.name", "source.namespace",
                 "request.id"]) + ' | "zz"' + ")" * 9,
    "response.code | 200", "true", "request.time")


def edge_field_dicts(b: int, seed: int) -> list[dict]:
    """Records for field_eval's edge inputs: each attribute present on 3
    in 4 records, every fifth record empty, runtime values that are not
    interned (ephemeral ids), strings past the byte-slot width."""
    import datetime

    import numpy as np
    rng = np.random.default_rng(seed)
    pick = lambda xs: xs[int(rng.integers(len(xs)))]  # noqa: E731
    t0 = datetime.datetime(2018, 3, 1, tzinfo=datetime.timezone.utc)
    out = []
    for j in range(b):
        d = {}
        for attr, vals in (
                ("request.path", ["/api/v1/x", "/apx", "svc.local/x", "",
                                  f"/p{j}", "/api/" + "y" * 140]),
                ("request.host", ["svc.local", "a.b", "/api", f"h{j}",
                                  "h" * 130]),
                ("request.size", [7, 99, 100, 101, j]),
                ("request.method", ["GET", "POST"]),
                ("source.user", ["alice", "bob", f"u{j}"]),
                ("destination.user", ["alice", "carol"]),
                ("connection.mtls", [True, False]),
                ("response.code", [200, 503]),
                ("request.time", [t0, t0 + datetime.timedelta(seconds=j)]),
                ("source.ip", [bytes([10, 1, 2, 3]),
                               bytes([9, 9, j % 256, 9])]),
                ("request.headers", [{"host": "h1", "x-ip": "10.0.0.9",
                                      "ts": "2018-03-01T12:00:00Z"},
                                     {"x-ip": "bad", "ts": "never"},
                                     {"host": f"x{j}"}, {}]),
                ("response.headers", [{"host": "h2"}, {}])):
            if rng.random() < 0.75:
                d[attr] = pick(vals)
        out.append({} if j % 5 == 0 else d)
    return out


def field_edge_checks() -> int:
    """Phase 8b: field_eval against field_eval_plain (the closures) and
    field_eval_ops_plain (the op table) on the card, on EDGE_FIELDS over
    GLOBAL_MANIFEST: F = 0, 1, 22 and 33 fields, B = 777 records (not a
    multiple of the block) with empty rows and ephemeral ids, every
    opcode present, on the full byte plane and on one narrowed to 32
    bytes (records whose strings fit). → cases."""
    import torch
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
    from istio_tpu_torch.compiler import layout as lay_mod
    from istio_tpu_torch.compiler import tensor_expr as te
    from istio_tpu_torch.compiler.op_lower import lower_programs
    from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
    from istio_tpu_torch.expr.parser import parse
    from istio_tpu_torch.ops import field_ops as fo

    finder = AttributeDescriptorFinder(GLOBAL_MANIFEST)
    asts = [parse(t) for t in EDGE_FIELDS]
    reqs = te.Requirements()
    for a in asts:
        te.collect_requirements(a, finder, reqs)
    layout = lay_mod.build_layout(
        GLOBAL_MANIFEST, sorted(reqs.derived_keys),
        sorted(reqs.byte_sources, key=str),
        extern_sources=[(n, k, a) for (n, k), a in
                        sorted(reqs.extern_sources.items(),
                               key=lambda kv: kv[0])])
    interner = lay_mod.InternTable()
    fns = [te.compile_field(a, finder, layout, interner)[0] for a in asts]
    dicts = edge_field_dicts(777, seed=21)
    tens = lay_mod.Tensorizer(layout, interner)
    full = tens.tensorize([bag_from_mapping(d) for d in dicts]).to("cuda")
    short = tens.tensorize([bag_from_mapping(d) for d in dicts if all(
        len(v) <= 32 for v in d.values() if isinstance(v, str))])
    short = dataclasses.replace(
        short, str_bytes=short.str_bytes[:, :, :32].contiguous()).to("cuda")
    n = len(asts)
    cases = 0
    for pick in ([], [0], list(range(n)), [i % n for i in range(33)]):
        prog = fo.FieldProgram(
            fns=[fns[i] for i in pick],
            prog=lower_programs([asts[i] for i in pick], layout, interner,
                                finder))
        for width, batch in (("full", full), ("narrowed", short)):
            got = fo.field_eval(batch, prog)
            torch.cuda.synchronize()
            tag = f"field_eval edge F={len(pick)} {width}"
            assert_equal(tag, got, fo.field_eval_plain(batch, prog))
            assert_equal(f"{tag} (op table)", got,
                         fo.field_eval_ops_plain(batch, prog))
            cases += 1
        if len(pick) == n:
            seen = {int(o) for o in prog.prog.ops[:, 0]}
            if seen != set(range(len(fo.OP_NAMES))):
                raise AssertionError(f"field_eval edge: opcodes {seen}")
            got = fo.field_eval(full, prog)
            if not bool((got[:len(pick)] < 0).any()):
                raise AssertionError("field_eval edge: no ephemeral id")
    return cases


def field_eval_checked(tag: str, batch, prog) -> None:
    """field_eval written into rows of a larger buffer, held against
    field_eval_plain and field_eval_ops_plain, the buffer's other rows
    unchanged."""
    import torch
    from istio_tpu_torch.ops import field_ops as fo
    b = int(batch.ids.shape[0])
    n_rows = prog.n_fields + prog.n_words
    buf = torch.full((n_rows + 3, b), -5, dtype=torch.int32,
                     device=batch.ids.device)
    fo.field_eval(batch, prog, out=buf[3:])
    assert_equal(tag, buf[3:], fo.field_eval_plain(batch, prog))
    assert_equal(f"{tag} (op table)", buf[3:],
                 fo.field_eval_ops_plain(batch, prog))
    assert_equal(f"{tag} (rows before out)", buf[:3],
                 torch.full_like(buf[:3], -5))


def field_seam_checks() -> int:
    """Phase 8b seams: field_eval against both plain versions at every
    SEAM_F fields x SEAM_B records (EDGE_FIELDS and balanced BOOL fields
    over GLOBAL_MANIFEST), each with a register-stack launch and, from
    F = 1, a general one (a need-5 field among them), written into rows
    of a larger buffer; at (65, 2,047) and (33, 33) also with strided
    ids / present / map_present, and on strided planes with a byte
    plane narrowed to 32. → cases."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
    from istio_tpu_torch.compiler import layout as lay_mod
    from istio_tpu_torch.compiler import tensor_expr as te
    from istio_tpu_torch.compiler.op_lower import lower_programs
    from istio_tpu_torch.expr.checker import AttributeDescriptorFinder
    from istio_tpu_torch.expr.parser import parse
    from istio_tpu_torch.ops import field_ops as fo

    finder = AttributeDescriptorFinder(GLOBAL_MANIFEST)
    texts = list(EDGE_FIELDS) + [
        balanced([f"{('request.size', 'response.code')[i % 2]} == {i}"
                  for i in range(k)]) for k in SEAM_NEED_LEAVES.values()]
    asts = [parse(t) for t in texts]
    reqs = te.Requirements()
    for a in asts:
        te.collect_requirements(a, finder, reqs)
    layout = lay_mod.build_layout(
        GLOBAL_MANIFEST, sorted(reqs.derived_keys),
        sorted(reqs.byte_sources, key=str),
        extern_sources=[(n, k, a) for (n, k), a in
                        sorted(reqs.extern_sources.items(),
                               key=lambda kv: kv[0])])
    interner = lay_mod.InternTable()
    fns = [te.compile_field(a, finder, layout, interner)[0] for a in asts]
    whole = lower_programs(asts, layout, interner, finder)
    needs = [stack_need(whole.ops[whole.starts[i]:whole.starts[i + 1]])
             for i in range(len(asts))]
    if not {1, 3, 4, 5} <= set(needs):
        raise AssertionError(f"field seams: stack needs {sorted(set(needs))}")
    shallow = [i for i, n in enumerate(needs) if n <= fo.SHALLOW]
    deep = needs.index(5)
    dicts = edge_field_dicts(max(SEAM_B), seed=22)
    tens = lay_mod.Tensorizer(layout, interner)
    full = tens.tensorize([bag_from_mapping(d) for d in dicts]).to("cuda")
    short = tens.tensorize([bag_from_mapping(d) for d in dicts if all(
        len(v) <= 32 for v in d.values() if isinstance(v, str))])
    short = dataclasses.replace(
        short, str_bytes=short.str_bytes[:, :, :32].contiguous()).to("cuda")
    cases = 0

    def run(tag, batch, picks):
        prog = fo.FieldProgram(fns=[fns[i] for i in picks],
                               prog=sub_program(whole, picks))
        plan = planned("field_eval", batch, prog.prog)
        if plan.deep != (prog.prog.need > fo.SHALLOW):
            raise AssertionError(f"{tag}: plan deep={plan.deep} for need "
                                 f"{prog.prog.need}")
        field_eval_checked(tag, batch, prog)

    for f in SEAM_F:
        kinds = {"shallow": [shallow[i % len(shallow)] for i in range(f)]}
        if f:
            kinds["deep"] = kinds["shallow"][:-1] + [deep]
        for b in SEAM_B:
            batch = full.rows(0, b)
            for kind, picks in kinds.items():
                run(f"field_eval seam F={f} B={b} {kind}", batch, picks)
                cases += 1
            if (f, b) not in ((65, 2047), (33, 33)):
                continue
            for kind, picks in kinds.items():
                run(f"field_eval seam F={f} B={b} {kind} strided",
                    strided_planes(batch), picks)
                cases += 1
    run("field_eval seam narrowed", strided_planes(short),
        list(range(len(asts))))
    return cases + 1


REPORT_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold",
                  "check_pack", "field_eval")


def report_stage_sums() -> dict:
    from istio_tpu_torch.runtime import monitor
    h = monitor.REPORT_STAGE_SECONDS
    return {st: h.sum(st) for st in monitor.REPORT_STAGES}


def telemetry_server(device: str, args: dict, log_stream: str):
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads
    store = workloads.make_store(HEADLINE_RULES)
    telemetry_world(store, log_stream)
    srv = RuntimeServer(store, ServerArgs(**args), device=device)
    d = srv.controller.dispatcher
    sinks = {h: CaptureSink(d.handlers[h]) for h in
             ("handler.istio-system", "stdio.istio-system")}
    d.handlers.update(sinks)
    return srv, store, sinks


class FullGcClock:
    """gc.callbacks hook: the wall time of each collection of the
    interpreter's oldest generation (a full collection walks every live
    object, the 10k-rule snapshots' among them)."""

    def __init__(self) -> None:
        self.t0 = None
        self.pauses: list[float] = []

    def __call__(self, phase: str, info: dict) -> None:
        if info.get("generation") != 2:
            return
        if phase == "start":
            self.t0 = time.perf_counter()
        elif self.t0 is not None:
            self.pauses.append((time.perf_counter() - self.t0) * 1e3)
            self.t0 = None


def dtoh_copies(fn) -> int | None:
    """Device→host copies the profiler saw during fn(); None when it
    recorded no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not evs:
        return None
    return sum(e.count for e in evs if "DtoH" in e.key)


def report_pull_checks(captured, pull, head: int, cpu_plan, batch,
                       ns_ids) -> None:
    """The one pull of a captured report trip, row block by row block:
    check_pack's rows (written through its out= view of the shared
    buffer) equal check_pack_plain on the trip's captured inputs,
    field_eval's rows equal field_eval_plain on its captured inputs, and
    the whole pull is byte-equal to the device="cpu" server's plan on
    the same tensorized batch."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import field_ops
    from istio_tpu_torch.runtime import fused
    ins = {}
    for name, inputs in captured:
        ins.setdefault(name, []).append(inputs)
    if len(ins.get("check_pack", ())) != 1 or \
            len(ins.get("field_eval", ())) != 1:
        raise AssertionError("report trip: want one check_pack and one "
                             "field_eval launch, got "
                             f"{ {k: len(v) for k, v in ins.items()} }")
    got = torch.from_numpy(np.ascontiguousarray(pull))
    assert_equal("report pull: check_pack rows", got[:head],
                 fused.check_pack_plain(*ins["check_pack"][0]))
    assert_equal("report pull: field_eval rows", got[head:],
                 field_ops.field_eval_plain(*ins["field_eval"][0]))
    want = cpu_plan.packed_report(batch, ns_ids)
    if want.dtype != pull.dtype or not np.array_equal(want, pull):
        raise AssertionError("report pull differs from the device='cpu' "
                             "server's packed_report on the same batch")
    log(f"[8] report pull [{pull.shape[0]}, {pull.shape[1]}] int32: the "
        f"{head} check_pack rows and the {pull.shape[0] - head} field_eval "
        "rows equal their plain versions on the trip's inputs; the whole "
        "pull byte-equal to the device='cpu' server's")


def report_phase(int_rate: float) -> dict:
    """Phase 8: the served Report() path at the telemetry world
    (make_store(10_000) + Istio's default telemetry config), the launch
    counters zeroed just before its drive and read just after. The
    card's RuntimeServer (report coalescer on, pipeline=1 so records
    export in order) against a device="cpu" server: == instances into the
    capture sinks and equal prometheus series at B ∈ E2E_BATCHES; rule
    counts untouched by report traffic; one field_eval launch and one
    device→host copy per report trip; report() timed (p50 / p99,
    records/s, the five report stages, trips per call, device busy and
    idle share); field_eval held against its plain version on the
    path's B=2048 trip, with every other kernel of that trip (timed:
    field_eval's kernels table row and the others' report rows), and the
    trip's one pull checked block by block (report_pull_checks)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping

    t0 = time.perf_counter()
    logs = tempfile.mkdtemp(prefix="chip_smoke_report_")
    # no rule-stats drainer: its pulls would land among the report trips'
    srv, store, sinks = telemetry_server(
        "cuda", dict(buckets=E2E_BATCHES, max_batch=HEADLINE_B, pipeline=1,
                     rulestats_drain_s=0), f"{logs}/card.log")
    build_s = time.perf_counter() - t0
    cpu, cpu_store, cpu_sinks = telemetry_server(
        "cpu", dict(CPU_SERVER, max_batch=HEADLINE_B, pipeline=1),
        f"{logs}/cpu.log")
    d = srv.controller.dispatcher
    plan, snap = d.fused, d.snapshot
    rl = plan.report_lowering
    head = 5 + plan.n_ref_words + plan.n_overlay_words
    shape = (len(snap.rules), len(plan.report_rules), len(rl.specs),
             len(rl.host_instances), rl.n_fields)
    log(f"[8] telemetry world: snapshot + plan + warm on the card "
        f"{build_s:.2f} s; {shape[0]} rules, errors {len(snap.errors)}, "
        f"{shape[1]} report rules, {shape[2]} report instances lowered "
        f"({shape[3]} host-built), F = {shape[4]} field programs "
        f"({len(rl.program.prog.ops)} op rows, stack "
        f"{rl.program.prog.need}, 0 LEAF rows: every field an op program); "
        f"pull {head} check rows + {rl.n_fields} value rows + "
        f"{rl.n_valid_words} valid words = "
        f"{head + rl.n_fields + rl.n_valid_words} int32 rows x B")
    if shape != (HEADLINE_RULES + 5, 4, 8, 0, 60) or snap.errors:
        raise AssertionError(f"telemetry world {shape}, errors "
                             f"{snap.errors[:3]}")
    trips, last = [], []
    packed_report = plan.packed_report

    def counted(*a, **kw):
        trips.append(1)
        last[:] = [a, packed_report(*a, **kw)]
        return last[1]

    plan.packed_report = counted
    kernels.launches.reset()
    before = rule_counts(srv)
    for b in E2E_BATCHES:
        bags = [bag_from_mapping(x) for x in telemetry_dicts(b, seed=b)]
        for s in (*sinks.values(), *cpu_sinks.values()):
            s.calls, s.refused = [], 0
        n0 = len(trips)
        pulls = dtoh_copies(lambda: srv.report(bags))
        n_trips = len(trips) - n0
        cpu.report(bags)
        for h, s in sinks.items():
            c = cpu_sinks[h]
            if s.calls != c.calls or s.refused != c.refused:
                raise AssertionError(f"report B={b}: instances into {h} "
                                     "differ from the CPU server's")
        prom, cprom = (x["handler.istio-system"].inner
                       for x in (sinks, cpu_sinks))
        if prom.series != cprom.series or not prom.series:
            raise AssertionError(f"report B={b}: prometheus series differ")
        if pulls is None or pulls != n_trips:
            raise AssertionError(f"report B={b}: {pulls} device-to-host "
                                 f"copies for {n_trips} trips")
        per_tmpl: dict = {}
        for s in sinks.values():
            for tmpl, insts in s.calls:
                per_tmpl[tmpl] = per_tmpl.get(tmpl, 0) + len(insts)
        log(f"[8] report B={b}: instances equal to the device='cpu' "
            f"server's in order ({per_tmpl}; prometheus refused "
            f"{sinks['handler.istio-system'].refused} DURATION values on "
            f"both), {len(prom.series)} prometheus series equal; "
            f"{n_trips} trips, {pulls} device-to-host copies")
    for s in sinks.values():
        s.keep = False
    results = {}
    for b in E2E_BATCHES:
        bags = [bag_from_mapping(x) for x in telemetry_dicts(b, seed=b)]
        for _ in range(2):
            srv.report(bags)
        st0, n0 = report_stage_sums(), len(trips)
        walls = []
        gc_clock = FullGcClock()
        gc.callbacks.append(gc_clock)
        try:
            for _ in range(SERVED_ITERS):
                t = time.perf_counter()
                srv.report(bags)
                walls.append((time.perf_counter() - t) * 1e3)
        finally:
            gc.callbacks.remove(gc_clock)
        st1 = report_stage_sums()
        gcs = gc_clock.pauses
        per_call = (len(trips) - n0) / SERVED_ITERS
        busy = device_ms(lambda: srv.report(bags), 5)
        p50, p99 = (float(np.percentile(walls, q)) for q in (50, 99))
        stages = {k: (st1[k] - st0[k]) * 1e3 / SERVED_ITERS for k in st1}
        idle = "not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {1 - busy / p50:.3f}"
        # the same records as ONE trip: Dispatcher.report, no coalescer
        n1 = len(trips)
        one = []
        for _ in range(SERVED_ITERS):
            t = time.perf_counter()
            d.report(bags)
            one.append((time.perf_counter() - t) * 1e3)
        if len(trips) - n1 != SERVED_ITERS:
            raise AssertionError("Dispatcher.report took more than one trip")
        one_p50 = float(np.percentile(one, 50))
        one_busy = device_ms(lambda: d.report(bags), 5)
        log(f"[8] report B={b:5d}: wall p50 {p50:.4f} ms p99 {p99:.4f} ms "
            f"= {b / p50 * 1e3:,.0f} records/s; {per_call:.2f} trips per "
            f"call ({idle}); stages ms/call "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
            + f"; {len(gcs)} full GC collections in the loop"
            + (f" (max {max(gcs):.1f} ms, sum {sum(gcs):.1f} ms)" if gcs
               else "")
            + f"; as one trip (Dispatcher.report) p50 {one_p50:.4f} ms = "
            f"{b / one_p50 * 1e3:,.0f} records/s, "
            + ("busy not measured" if one_busy is None else
               f"busy {one_busy:.4f} ms, idle share "
               f"{1 - one_busy / one_p50:.3f} per trip"))
        results[b] = {"p50_ms": p50, "p99_ms": p99,
                      "records_per_s": b / p50 * 1e3,
                      "trips_per_call": per_call, "busy_ms": busy,
                      "idle_share": None if busy is None else
                      1 - busy / p50, "stages_ms": stages,
                      "one_trip_p50_ms": one_p50,
                      "one_trip_busy_ms": one_busy, "full_gc_ms": gcs}
    bags = [bag_from_mapping(x) for x in
            telemetry_dicts(HEADLINE_B, seed=HEADLINE_B)]
    n1 = len(trips)
    with kernels.launches.capture() as captured:
        d.report(bags)
    torch.cuda.synchronize()
    if len(trips) != n1 + 1:
        raise AssertionError("the captured report took more than one trip")
    (batch, ns_ids), pull = last
    del plan.packed_report
    if rule_counts(srv) != before:
        raise AssertionError("report traffic changed the rule counts")
    steps = len(trips)
    out = path_counts("[8] report path", REPORT_KERNELS, steps)
    one_atom_launch_per_step("[8] report path", out, snap.ruleset)
    if out["counts"]["field_eval"] != steps or out["counts"]["rule_stats"]:
        raise AssertionError(f"report path: {out['counts']['field_eval']} "
                             f"field_eval launches for {steps} trips, "
                             f"{out['counts']['rule_stats']} rule_stats")
    log(f"[8] report path: one field_eval launch per trip ({steps} trips), "
        "no rule-telemetry fold, rule counts unchanged; every kernel of "
        f"the B={HEADLINE_B} trip against its plain version on that trip's "
        "inputs (timed):")
    rows = check_kernels(captured, plan.engine.quota_counts.clone(),
                         int_rate)
    report_pull_checks(captured, pull, head,
                       cpu.controller.dispatcher.fused, batch, ns_ids)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    shutil.rmtree(logs, ignore_errors=True)
    return {**out, "results": results, "rows": rows}


# ---------------------------------------------------------------------------
# phase 8c: the host adapters on the card
# ---------------------------------------------------------------------------

ADAPTER_B = (64, 256)       # phase 8c's batches
ADAPTER_ITERS = 5           # timed calls per batch in phase 8c
APA_PODS = 1000             # pods in the APA world's kubernetesenv cache
APA_KERNELS = SERVED_KERNELS + ("field_eval",)
# the stackdriver handler's clock in phase 8c (its time series' interval)
ADAPTER_NOW = 1_520_000_000.0


def adapter_telemetry_world(store, log_stream: str, sent: dict) -> None:
    """telemetry_world (stdio writing `log_stream`) plus a handler of each
    of statsd, circonus and stackdriver for three of its metrics, and
    fluentd and stackdriver for the access log, on http records. The
    circonus and stackdriver transports append each payload to
    sent["circonus"] / sent["stackdriver"]; statsd's and fluentd's
    sockets are swapped for SocketSeams after the build
    (attach_seams)."""
    ns = "istio-system"
    telemetry_world(store, log_stream)
    metrics = [f"{m}.{ns}" for m in ("requestcount", "requestsize",
                                     "responsesize")]
    store.set(("handler", ns, "statsd"), {"adapter": "statsd", "params": {
        "prefix": "istio.", "metrics": [
            {"name": metrics[0], "type": "COUNTER",
             "name_template": "${destination_service}.${response_code}"},
            {"name": metrics[1], "type": "TIMING", "sample_rate": 0.5},
            {"name": metrics[2], "type": "GAUGE"}]}})
    store.set(("handler", ns, "circonus"), {"adapter": "circonus", "params": {
        "submission_url": "https://trap.example/module/httptrap/a/b",
        "submission_interval_s": 3600,
        "metrics": [{"name": metrics[0], "type": "counter"},
                    {"name": metrics[1], "type": "distribution"},
                    {"name": metrics[2], "type": "gauge"}],
        "transport": lambda url, payload: sent["circonus"].append(
            (url, payload))}})
    store.set(("handler", ns, "stackdriver"), {
        "adapter": "stackdriver", "params": {
            "project_id": "mesh-1", "push_interval_s": 3600,
            "now": lambda: ADAPTER_NOW,
            "metric_info": {
                metrics[0]: {"kind": "DELTA", "value": "INT64"},
                metrics[1]: {"kind": "DELTA", "value": "DISTRIBUTION",
                             "buckets": {"exponential": {
                                 "num_finite_buckets": 12,
                                 "growth_factor": 4.0, "scale": 1.0}}},
                metrics[2]: {"kind": "GAUGE", "value": "INT64"}},
            "log_info": {f"accesslog.{ns}": {
                "payload_template": "{method} {url} {responseCode}",
                "http_mapping": {"requestMethod": "method",
                                 "status": "responseCode"}}},
            "transport": lambda method, batch: sent["stackdriver"].append(
                (method, batch))}})
    store.set(("handler", ns, "fluentd"), {"adapter": "fluentd",
                                           "params": {}})
    acts = [{"handler": f"{h}.{ns}", "instances": metrics}
            for h in ("statsd", "circonus", "stackdriver")]
    acts += [{"handler": f"{h}.{ns}", "instances": [f"accesslog.{ns}"]}
             for h in ("stackdriver", "fluentd")]
    store.set(("rule", ns, "adapters"), {
        "match": 'context.protocol == "http"', "actions": acts})


class SocketSeam:
    """A socket seam for statsd (`sendto`, datagrams) or fluentd
    (`sendall`, a byte stream): the handler writes into one end of an
    AF_UNIX socketpair, whose sender blocks rather than drops when the
    reader falls behind, and a thread keeps everything the other end
    reads. take() waits for every byte sent and hands back what arrived
    (a list of datagrams, or the stream's bytes)."""

    def __init__(self, datagrams: bool) -> None:
        import socket
        import threading
        kind = socket.SOCK_DGRAM if datagrams else socket.SOCK_STREAM
        self._tx, self._rx = socket.socketpair(socket.AF_UNIX, kind)
        self._rx.settimeout(0.1)
        self.datagrams = datagrams
        self.sent = self.received = 0
        self.got: list[bytes] = []
        self.addresses: set = set()
        self._stop = False
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        import socket
        while not self._stop:
            try:
                data = self._rx.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            self.got.append(data)
            self.received += len(data)

    def sendto(self, data: bytes, address) -> int:
        self.addresses.add(address)
        self.sent += len(data)
        return self._tx.send(data)

    def sendall(self, data: bytes) -> None:
        self.sent += len(data)
        self._tx.sendall(data)

    def take(self):
        deadline = time.time() + 30
        while self.received < self.sent:
            if time.time() > deadline:
                raise AssertionError(f"socket seam: {self.received} of "
                                     f"{self.sent} bytes arrived")
            time.sleep(0.001)
        got, self.got = self.got, []
        return got if self.datagrams else b"".join(got)

    def close(self) -> None:
        self._stop = True
        self._reader.join()
        self._tx.close()
        self._rx.close()


def attach_seams(srv) -> dict:
    """Swap the statsd handler's UDP socket and the fluentd handler's
    TCP connection for SocketSeams; → {"statsd": seam, "fluentd": seam}."""
    hs = srv.controller.dispatcher.handlers
    statsd, fluentd = hs["statsd.istio-system"], hs["fluentd.istio-system"]
    statsd._sock.close()
    statsd._sock = SocketSeam(datagrams=True)
    fluentd._sock = SocketSeam(datagrams=False)
    return {"statsd": statsd._sock, "fluentd": fluentd._sock}


def flush_pushers(srv) -> None:
    """Push what circonus and stackdriver aggregated (their tickers run
    once an hour here)."""
    hs = srv.controller.dispatcher.handlers
    hs["circonus.istio-system"]._flush()
    sd = hs["stackdriver.istio-system"]
    sd._metrics.flush()
    sd._logs.flush()


class AdapterFailures(logging.Filter):
    """Counts the dispatcher's "adapter report failed" records and keeps
    them out of the log (the prometheus adapter refuses every DURATION
    value, as in the JAX package); other records pass."""

    def __init__(self) -> None:
        super().__init__()
        self.n = 0

    def filter(self, record) -> bool:
        if record.getMessage() == "adapter report failed":
            self.n += 1
            return False
        return True


def apa_pod_ip(k: int) -> bytes:
    return bytes([10, 64 + (k >> 16) % 64, (k >> 8) & 255, k & 255])


def apa_world(store, n_pods: int, log_stream: str) -> None:
    """tests/test_runtime.py's APA world (test_apa_preprocess) added to
    make_store's `store`: a kubernetesenv handler `kube` over `n_pods`
    static pods (web<k>.ns<k % 23>, every 8th on the canary track), a
    kubernetes instance whose attribute_bindings put the pod's name,
    namespace and labels into the request, an APA rule with match "", a
    deny rule on a bound attribute (the pod's track label, through
    make_store's denier), and an access log of the bound attributes to
    a stdio handler writing `log_stream`."""
    import ipaddress
    ns = "istio-system"
    pods = {}
    for k in range(n_pods):
        track = "canary" if k % 8 == 0 else "stable"
        pods[f"web{k}.ns{k % 23}"] = {
            "pod_name": f"web{k}-{track}", "namespace": f"ns{k % 23}",
            "labels": {"app": f"app{k % 40}", "track": track},
            "pod_ip": str(ipaddress.ip_address(apa_pod_ip(k))),
            "service_account_name": f"sa{k % 61}"}
    store.set(("handler", ns, "kube"), {"adapter": "kubernetesenv",
                                        "params": {"pods": pods}})
    store.set(("instance", ns, "kubeattrs"), {
        "template": "kubernetes", "params": {
            "source_uid": 'source.uid | ""',
            "source_ip": 'source.ip | ip("0.0.0.0")',
            "attribute_bindings": {
                "source.name": "$out.source_pod_name",
                "source.namespace": "$out.source_namespace",
                "source.labels": "$out.source_labels"}}})
    store.set(("rule", ns, "kubeapa"), {"match": "", "actions": [
        {"handler": "kube", "instances": ["kubeattrs"]}]})
    store.set(("rule", ns, "denycanary"), {
        "match": 'source.labels["track"] == "canary"',
        "actions": [{"handler": "denyall", "instances": ["nothing"]}]})
    store.set(("handler", ns, "podstdio"), {
        "adapter": "stdio", "params": {"log_stream": log_stream}})
    store.set(("instance", ns, "podlog"), {"template": "logentry", "params": {
        "severity": '"Info"',
        "timestamp": 'timestamp("2018-03-01T12:00:00Z")',
        "variables": {"pod": 'source.name | "none"',
                      "podns": 'source.namespace | "none"',
                      "track": 'source.labels["track"] | "none"',
                      "path": 'request.path | ""'}}})
    store.set(("rule", ns, "podlog"), {"match": "", "actions": [
        {"handler": "podstdio", "instances": ["podlog"]}]})


def apa_dicts(b: int, seed: int, n_pods: int) -> list[dict]:
    """make_request_dicts(b, seed) with a source pod each: 45 % by
    source.uid, 40 % by source.ip, 15 % from an ip no pod has; one pod
    in 11 unknown to the cache."""
    import numpy as np
    from istio_tpu_torch.testing import workloads
    rng = np.random.default_rng(seed)
    dicts = workloads.make_request_dicts(b, seed=seed)
    for d in dicts:
        k = int(rng.integers(0, n_pods + n_pods // 10))
        u = rng.random()
        if u < 0.45:
            d["source.uid"] = f"kubernetes://web{k}.ns{k % 23}"
        elif u < 0.85:
            d["source.ip"] = apa_pod_ip(k)
        else:
            d["source.ip"] = bytes([192, 168, int(rng.integers(0, 256)),
                                    int(rng.integers(1, 255))])
    return dicts


# the Rego policy of the APA world's OPA rule: a GET of a path that ends
# in 7 is refused
APA_REGO = """package mixerauthz
default allow = false
allow { not blocked }
blocked { endswith(input.action.path, "7") }
"""


def apikey_transport(method: str, service: str, payload: dict) -> dict:
    """servicecontrol's in-process Service Control API: an api key whose
    session number is a multiple of 9 is invalid."""
    key = payload["operation"]["consumerId"]
    if int(key.rsplit("=", 1)[1]) % 9 == 0:
        return {"checkErrors": [{"code": "API_KEY_INVALID",
                                 "detail": f"{key} revoked"}]}
    return {}


def check_actions_world(store) -> None:
    """Host check actions beside make_store's rules: an OPA rule in
    expression mode on POSTs (allowed to /api/v0/ only), one in Rego
    mode on GETs (APA_REGO), and a servicecontrol apikey rule on mTLS
    connections whose key is the session cookie (apikey_transport)."""
    ns = "istio-system"
    store.set(("handler", ns, "opaexpr"), {"adapter": "opa", "params": {
        "policies": ['action.path.startsWith("/api/v0/")']}})
    store.set(("handler", ns, "oparego"), {"adapter": "opa", "params": {
        "policies": [APA_REGO], "check_method": "data.mixerauthz.allow"}})
    store.set(("handler", ns, "sc"), {"adapter": "servicecontrol", "params": {
        "service_configs": [{"mesh_service_name": "productpage.default",
                             "google_service_name": "bookinfo.example"}],
        "runtime_config": {"check_result_expiration_s": 30},
        "transport": apikey_transport}})
    store.set(("instance", ns, "authz"), {"template": "authorization",
                                          "params": {
        "subject": {"user": 'source.user | ""'},
        "action": {"namespace": 'destination.namespace | "default"',
                   "service": 'destination.service | ""',
                   "method": 'request.method | ""',
                   "path": 'request.path | ""'}}})
    store.set(("instance", ns, "apikey"), {"template": "apikey", "params": {
        "api_key": 'request.headers["cookie"] | ""',
        "api_operation": 'request.method | ""'}})
    for name, match, handler, inst in (
            ("opa-expr", 'request.method == "POST"', "opaexpr", "authz"),
            ("opa-rego", 'request.method == "GET"', "oparego", "authz"),
            ("apikey", "connection.mtls", "sc", "apikey")):
        store.set(("rule", ns, name), {"match": match, "actions": [
            {"handler": handler, "instances": [inst]}]})


def deny_causes(responses) -> dict:
    """Denied responses by cause: the OPA rules, servicecontrol, or the
    fused plan (every other non-OK status)."""
    out = {"opa": 0, "servicecontrol": 0, "fused": 0}
    for r in responses:
        if r.status_code == OK:
            continue
        msg = r.status_message
        key = "opa" if msg.startswith("opa:") else "servicecontrol" \
            if msg.startswith("API_KEY_INVALID") else "fused"
        out[key] += 1
    return out


@contextlib.contextmanager
def uncounted():
    """Launches inside the block (replays of captured launches against
    their plain versions) leave the launch counters as they were."""
    from istio_tpu_torch import kernels
    n = kernels.launches
    saved = dict(n), dict(n.grids), dict(n.entries)
    try:
        yield
    finally:
        n.update(saved[0])
        n.grids.update(saved[1])
        n.entries.update(saved[2])


def timed_walls(fn, iters: int) -> dict:
    """fn() timed over `iters` calls: wall p50 / p99 ms, and the device
    busy ms a call and idle share (profiler, one more call after one
    untimed one: a profiled APA call of 257 trips takes seconds)."""
    import numpy as np
    walls = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t) * 1e3)
    busy = device_ms(fn, 1)
    p50, p99 = (float(np.percentile(walls, q)) for q in (50, 99))
    return {"p50_ms": p50, "p99_ms": p99, "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / p50}


def wall_line(r: dict) -> str:
    idle = "busy not measured" if r["busy_ms"] is None else \
        f"busy {r['busy_ms']:.4f} ms, idle share {r['idle_share']:.4f}"
    return f"p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms ({idle})"


def counted_trips(plan) -> list:
    """Count the plan's check and report trips: → a list that grows by
    one entry per trip ("check" or "report")."""
    trips: list = []
    for kind in ("check", "report"):
        orig = getattr(plan, f"packed_{kind}")

        def counted(*a, _orig=orig, _kind=kind, **kw):
            trips.append(_kind)
            return _orig(*a, **kw)
        setattr(plan, f"packed_{kind}", counted)
    return trips


def adapters_phase() -> dict:
    """Phase 8c: the host adapters on the card, the launch counters
    zeroed just before its drive and read just after. The port's
    RuntimeServer on the card against a device="cpu" one, each over its
    own store of the same config and fed the same bags, at B in
    ADAPTER_B:
    (a) the telemetry world as upstream writes it (stdio writing a file)
        with real handlers, and statsd, circonus, stackdriver and
        fluentd beside prometheus (adapter_telemetry_world): report()'s
        stdio lines, statsd datagrams, fluentd bytes, circonus and
        stackdriver payloads and prometheus series equal to the CPU
        server's, and one field_eval launch per report trip;
    (b) the APA world (apa_world over make_store(10_000), APA_PODS pods)
        with the host check actions of check_actions_world: check_many()
        and report() equal to the CPU server (responses, rule counts,
        the bound attributes of preprocessed bags, the stdio access log
        of the bound attributes, prometheus series); some rows denied
        only through a bound attribute (OK on the same bags without the
        APA phase); rule_match once per preprocessed bag plus once per
        fused trip; a sample of the preprocess launches (K1, K2, K3)
        held against their plain versions;
    (c) on the same world, rows denied by OPA (both modes), by
        servicecontrol and by the fused plan, and every kernel of one
        B=256 check trip held against its plain version (parity).
    Every drive timed (p50 / p99, device busy and idle share)."""
    import shutil
    import tempfile

    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads

    t_phase = time.perf_counter()
    logs = tempfile.mkdtemp(prefix="chip_smoke_adapters_")
    quiet = AdapterFailures()
    dlog = logging.getLogger("istio_tpu_torch.runtime.dispatcher")
    dlog.addFilter(quiet)
    card_args = dict(buckets=ADAPTER_B, max_batch=ADAPTER_B[-1],
                     pipeline=1, rulestats_drain_s=0)
    cpu_args = dict(CPU_SERVER, max_batch=ADAPTER_B[-1], pipeline=1)

    def server(device: str, world) -> tuple:
        store = workloads.make_store(HEADLINE_RULES)
        world(store, device)
        srv = RuntimeServer(store, ServerArgs(
            **(card_args if device == "cuda" else cpu_args)), device=device)
        errors = srv.controller.dispatcher.snapshot.errors
        if errors:
            raise AssertionError(f"8c {device} world errors {errors[:3]}")
        return srv, store

    def lines(path: str) -> list[str]:
        with open(path, encoding="utf-8") as f:
            return f.read().splitlines()

    # ---- (a) the telemetry world with real handlers
    sent = {dev: {"circonus": [], "stackdriver": []}
            for dev in ("cuda", "cpu")}
    t0 = time.perf_counter()
    (srv, store), (cpu, cpu_store) = (server(dev, lambda s, dev: (
        adapter_telemetry_world(s, f"{logs}/telemetry_{dev}.log",
                                sent[dev]))) for dev in ("cuda", "cpu"))
    build_a = time.perf_counter() - t0
    seams = {srv: attach_seams(srv), cpu: attach_seams(cpu)}
    plan = srv.controller.dispatcher.fused
    trips = counted_trips(plan)
    kernels.launches.reset()
    results: dict = {"telemetry": {}, "apa_check": {}, "apa_report": {}}
    n_lines = 0
    for b in ADAPTER_B:
        bags = [bag_from_mapping(x) for x in telemetry_dicts(b, seed=80 + b)]
        got = {}
        for s in (srv, cpu):
            f0 = quiet.n
            s.report(bags)
            flush_pushers(s)
            dev = "cuda" if s is srv else "cpu"
            got[s] = {"refused": quiet.n - f0,
                      "stdio": lines(f"{logs}/telemetry_{dev}.log"),
                      **{k: v.take() for k, v in seams[s].items()},
                      **{k: list(v) for k, v in sent[dev].items()}}
            for v in sent[dev].values():
                v.clear()
        prom = [s.controller.dispatcher.handlers["handler.istio-system"]
                .series for s in (srv, cpu)]
        for k, want in got[cpu].items():
            if got[srv][k] != want:
                raise AssertionError(f"8c telemetry B={b}: {k} differs "
                                     "from the CPU server's")
        if prom[0] != prom[1] or not prom[0]:
            raise AssertionError(f"8c telemetry B={b}: prometheus series "
                                 "differ")
        g = got[srv]
        if not all((g["stdio"], g["statsd"], g["fluentd"], g["circonus"],
                    g["stackdriver"])) or len(g["stdio"]) - n_lines != b:
            raise AssertionError(f"8c telemetry B={b}: a handler got "
                                 f"nothing, or {len(g['stdio']) - n_lines} "
                                 "stdio lines")
        n_lines = len(g["stdio"])
        log(f"[8c] telemetry B={b}: report() equal to the CPU server: "
            f"stdio {n_lines} lines line for line, {len(g['statsd'])} "
            f"statsd datagrams, {len(g['fluentd'])} fluentd bytes, "
            f"{len(g['circonus'])} circonus and {len(g['stackdriver'])} "
            f"stackdriver pushes, {len(prom[0])} prometheus series; "
            f"{g['refused']} prometheus refusals (DURATION) on both")
    report_trips = trips.count("report")
    for b in ADAPTER_B:
        bags = [bag_from_mapping(x) for x in telemetry_dicts(b, seed=80 + b)]
        srv.report(bags)
        results["telemetry"][b] = r = timed_walls(
            lambda: srv.report(bags), ADAPTER_ITERS)
        log(f"[8c] telemetry report() B={b}: {wall_line(r)}")
    field_launches = kernels.launches["field_eval"]
    if field_launches != trips.count("report") or not report_trips:
        raise AssertionError(f"8c telemetry: {field_launches} field_eval "
                             f"launches for {trips.count('report')} trips")
    steps = len(trips)
    for s in seams.values():
        for seam in s.values():
            seam.take()
    for x in (srv, cpu, store, cpu_store):
        x.close()
    for s in seams.values():
        for seam in s.values():
            seam.close()

    # ---- (b), (c) the APA world with host check actions
    def apa(s, dev):
        apa_world(s, APA_PODS, f"{logs}/pods_{dev}.log")
        check_actions_world(s)

    t0 = time.perf_counter()
    with uncounted():       # the publish warms the plan: not the drive
        (srv, store), (cpu, cpu_store) = (server(dev, apa)
                                          for dev in ("cuda", "cpu"))
    build_b = time.perf_counter() - t0
    seconds_a = t0 - t_phase
    d = srv.controller.dispatcher
    plan, snap = d.fused, d.snapshot
    if not d.has_apa or len(plan.host_actions) != 3:
        raise AssertionError(f"8c APA world: has_apa {d.has_apa}, "
                             f"{len(plan.host_actions)} host-overlay rules")
    trips = counted_trips(plan)
    quota0 = plan.engine.quota_counts.clone()
    causes = {}
    n_lines = 0
    for b in ADAPTER_B:
        bags = [bag_from_mapping(x) for x in apa_dicts(b, 90 + b, APA_PODS)]
        if b == ADAPTER_B[0]:
            pre = [dict(srv.preprocess(x)._values) for x in bags]
            if pre != [dict(cpu.preprocess(x)._values) for x in bags]:
                raise AssertionError(f"8c APA B={b}: bound attributes "
                                     "differ")
            log(f"[8c] APA B={b}: the bound attributes of every "
                f"preprocessed bag equal the CPU server's "
                f"({sum(len(p) for p in pre)} bound in {b} bags)")
        k1, n0 = kernels.launches["rule_match"], len(trips)
        before, cpu_before = rule_counts(srv), rule_counts(cpu)
        got, want = srv.check_many(bags), cpu.check_many(bags)
        k1_check = kernels.launches["rule_match"] - k1
        compare_responses(f"8c APA check B={b}", got, want)
        compare_counts(f"8c APA check B={b}", counts_since(srv, before),
                       counts_since(cpu, cpu_before))
        if k1_check != b + (len(trips) - n0) or \
                trips[n0:] != ["check"] * (len(trips) - n0):
            raise AssertionError(f"8c APA B={b}: {k1_check} rule_match "
                                 f"launches for {b} bags and "
                                 f"{len(trips) - n0} trips")
        # the same bags without the APA phase, on the CPU server
        raw = cpu.controller.dispatcher.check(bags)
        bound_only = sum(1 for g, r in zip(got, raw)
                         if g.status_code != OK and r.status_code == OK)
        causes[b] = deny_causes(got)
        if bound_only == 0 or 0 in causes[b].values():
            raise AssertionError(f"8c APA B={b}: {bound_only} rows denied "
                                 f"only through a bound attribute; causes "
                                 f"{causes[b]}")
        k1, n0 = kernels.launches["rule_match"], len(trips)
        srv.report(bags)
        cpu.report(bags)
        k1_report = kernels.launches["rule_match"] - k1
        card_lines, cpu_lines = (lines(f"{logs}/pods_{dev}.log")
                                 for dev in ("cuda", "cpu"))
        prom = [s.controller.dispatcher.handlers["prom.istio-system"]
                .series for s in (srv, cpu)]
        if card_lines != cpu_lines or len(card_lines) - n_lines != b or \
                prom[0] != prom[1] or not prom[0]:
            raise AssertionError(f"8c APA report B={b}: stdio lines or "
                                 "prometheus series differ from the CPU "
                                 "server's")
        if k1_report != b + (len(trips) - n0):
            raise AssertionError(f"8c APA report B={b}: {k1_report} "
                                 f"rule_match launches for {b} bags and "
                                 f"{len(trips) - n0} trips")
        n_lines = len(card_lines)
        log(f"[8c] APA B={b}: check_many responses and rule "
            f"counts equal to the CPU server; {bound_only} rows denied "
            f"only through a bound attribute; denied by cause "
            f"{causes[b]}; report() stdio {n_lines} lines line for line "
            f"and prometheus series equal; rule_match {k1_check} launches "
            f"in check_many ({b} preprocessed bags + {k1_check - b} "
            f"trips), {k1_report} in report ({b} + {k1_report - b})")
    with kernels.launches.capture() as captured:
        for x in apa_dicts(4, 7, APA_PODS):
            srv.preprocess(bag_from_mapping(x))
    torch.cuda.synchronize()
    names = sorted({n for n, _ in captured})
    with uncounted():
        check_kernels(captured, quota0)
    log(f"[8c] {len(captured)} captured preprocess launches of 4 bags "
        f"({', '.join(names)}) equal to their plain versions")
    bags = [bag_from_mapping(x)
            for x in apa_dicts(ADAPTER_B[-1], 99, APA_PODS)]
    pre = [srv.preprocess(x) for x in bags]
    quota0 = plan.engine.quota_counts.clone()
    with kernels.launches.capture() as captured:
        srv.controller.dispatcher.check(pre)
    torch.cuda.synchronize()
    trip_names = sorted({n for n, _ in captured})
    if not {"rule_match", "verdict_fold", "check_pack",
            "rule_stats"} <= set(trip_names):
        raise AssertionError(f"8c check trip launched {trip_names}")
    with uncounted():
        check_kernels(captured, quota0)
    log(f"[8c] the B=256 check trip's {len(captured)} launches "
        f"({', '.join(trip_names)}) equal to their plain versions")
    seconds_b = time.perf_counter() - t0
    t0 = time.perf_counter()
    for b in ADAPTER_B:
        bags = [bag_from_mapping(x) for x in apa_dicts(b, 90 + b, APA_PODS)]
        results["apa_check"][b] = r = timed_walls(
            lambda: srv.check_many(bags), ADAPTER_ITERS)
        log(f"[8c] APA check_many() B={b}: {wall_line(r)}")
        results["apa_report"][b] = r = timed_walls(
            lambda: srv.report(bags), ADAPTER_ITERS)
        log(f"[8c] APA report() B={b}: {wall_line(r)}")
    seconds_t = time.perf_counter() - t0
    steps += len(trips)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    dlog.removeFilter(quiet)
    shutil.rmtree(logs, ignore_errors=True)
    out = path_counts("[8c] host adapters", APA_KERNELS, steps)
    seconds = time.perf_counter() - t_phase
    log(f"[8c] host adapters: phase {seconds:.1f} s: (a) {seconds_a:.1f} "
        f"s (servers built in {build_a:.2f} s), (b) and (c) "
        f"{seconds_b:.1f} s (servers built in {build_b:.2f} s), their "
        f"timed loops {seconds_t:.1f} s")
    return {**out, "results": results, "causes": causes, "rows": [],
            "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 9: the served Quota() path (K9 quota_alloc)
# ---------------------------------------------------------------------------

QUOTA_INSTANCE = "rq.istio-system"
QUOTA_KEYS = 100_000          # bench.py's config 4: 100k live keys
# the default quota of Istio's Bookinfo rate-limit sample
# (samples/bookinfo/kube/mixer-rule-ratings-ratelimit.yaml: maxAmount
# 5000, validDuration 1s); its per-destination overrides are dropped
QUOTA_MAX, QUOTA_WINDOW_S = 5000, 1.0
QUOTA_T0, QUOTA_STEP_S = 1000.0, 0.01   # injected clock, step per batch
QUOTA_ZIPF = 1.3              # bench.py:2290's key skew
# compared batches per stage: enough unit traffic at 2048 that the hot
# keys ask for more than QUOTA_MAX inside one window
QUOTA_UNIT_BATCHES = {64: 3, 256: 3, 2048: 10}
QUOTA_MIXED_BATCHES = {64: 3, 256: 3, 2048: 4}
QUOTA_ITERS = 20              # timed calls per batch size
QUOTA_KERNELS = SERVED_KERNELS + ("quota_alloc",)
QUOTA_REPLACES = {
    "fast": "istio_tpu/models/quota_alloc.py:177",
    "unit": "istio_tpu/models/quota_alloc.py:313",
    "seg": "istio_tpu/models/quota_alloc.py:230",
    "scan": "istio_tpu/models/quota_alloc.py:195",
    "instep": "istio_tpu/runtime/fused.py:467"}


def quota_world(store) -> None:
    """make_store's memquota handler `mq` with the Bookinfo sample's
    default limit on its `rq` quota (dimensions user: source.user |
    "anon", sent there by make_store's quota-rule, match "")."""
    store.set(("handler", "istio-system", "mq"), {
        "adapter": "memquota",
        "params": {"quotas": [{"name": QUOTA_INSTANCE,
                               "max_amount": QUOTA_MAX,
                               "valid_duration_s": QUOTA_WINDOW_S}]}})


class StepClock:
    """The pools' injected clock: moved only between batches."""

    def __init__(self) -> None:
        self.t = QUOTA_T0

    def __call__(self) -> float:
        return self.t


def quota_server(device: str, args: dict):
    """The quota world served on `device` with quota_in_step on → (server,
    store, its one pool, the pool's clock)."""
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads
    store = workloads.make_store(HEADLINE_RULES)
    quota_world(store)
    srv = RuntimeServer(store, ServerArgs(quota_in_step=True, **args),
                        device=device)
    pools = set(srv.controller.device_quotas.values())
    if len(pools) != 1:
        raise AssertionError(f"quota world: {len(pools)} device pools")
    pool = pools.pop()
    clock = StepClock()
    pool._clock = clock
    return srv, store, pool, clock


def quota_bags(users, seed: int) -> tuple[list, list]:
    """make_request_dicts traffic with source.user = user<u> → the same
    requests as bags for the card's server and for the CPU's."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.testing import workloads
    dicts = workloads.make_request_dicts(len(users), seed=seed)
    for d, u in zip(dicts, users):
        d["source.user"] = f"user{int(u)}"
    return ([bag_from_mapping(d) for d in dicts],
            [bag_from_mapping(d) for d in dicts])


def zipf_users(rng, b: int):
    return (rng.zipf(QUOTA_ZIPF, b) - 1) % QUOTA_KEYS


def capture_if(on: bool):
    """kernels.launches.capture() when `on`, else an empty list."""
    from contextlib import nullcontext
    from istio_tpu_torch import kernels
    return kernels.launches.capture() if on else nullcontext([])


def same_quota(label: str, got, want) -> None:
    for f in ("granted_amount", "status_code", "valid_duration_s",
              "status_message"):
        if getattr(got, f) != getattr(want, f):
            raise AssertionError(f"{label}: QuotaResult.{f}: card "
                                 f"{getattr(got, f)!r}, plain "
                                 f"{getattr(want, f)!r}")


def resolve(q):
    return q.result() if hasattr(q, "result") else q


def classic_round(srv, bags, args):
    """The served defer path: check_many, then quota_fused for every row
    whose check passed (the fronts' grpcServer.go:188 gate) → (responses,
    {row: QuotaResult})."""
    resp = srv.check_many(bags)
    futs = {i: srv.quota_fused(bags[i], "rq", a, r)
            for i, (r, a) in enumerate(zip(resp, args))
            if r.status_code == OK}
    return resp, {i: resolve(q) for i, q in futs.items()}


def quota_alloc_check(tag: str, mode: str, before, rows, gate) -> bool:
    """K9 against its plain version on one set of inputs: granted, the
    whole plane after the alloc, and the gate. → True."""
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    got_plane, want_plane = before.clone(), before.clone()
    b = int(rows[0].shape[0])
    gate_k = None if gate is None else torch.full(
        (b,), -1, dtype=torch.int32, device=before.device)
    got = qa.quota_alloc(mode, got_plane, *rows, gate=gate, gate_out=gate_k)
    want, want_gate = qa.quota_alloc_plain(mode, want_plane, *rows, gate)
    assert_equal(f"{tag} {mode} granted", got, want)
    assert_equal(f"{tag} {mode} plane", got_plane, want_plane)
    if gate is not None:
        assert_equal(f"{tag} {mode} gate", gate_k, want_gate.to(torch.int32))
    return True


def quota_work(mode: str, before, rows, gate) -> tuple[float, float]:
    """(bytes, int32 ops) the alloc needs on these inputs: each row input
    read once, granted (and gate) written once, and the rows of the
    plane its live rows touch read and written once; ops: the roll and
    the sum over K per live row, the grant's ~20, and for the contended
    modes a comparison sort's B log2 B."""
    import math
    import torch
    b = int(rows[0].shape[0])
    k = int(before.shape[1])
    live = rows[4] != 0
    touched = int(torch.unique(rows[0][live]).numel())
    n_bytes = 4.0 * b * len(rows) + 4.0 * b + 2 * 4.0 * k * touched
    if gate is not None:
        n_bytes += 4.0 * b * 4 + b + 4.0 * b   # status, rule, ns x2; matched
    ops = float(int(live.sum())) * (2 * k + 20)
    if mode != "fast":
        ops += b * math.log2(max(b, 2))
    return n_bytes, ops


def quota_alloc_times(mode: str, before, rows, gate):
    """Time K9 (in place on a scratch plane: later calls find the rolls
    done and the hot buckets fuller), its plain version and the
    library's stable argsort of the batch's bucket keys."""
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    scratch = before.clone()
    b = int(rows[0].shape[0])
    gate_k = None if gate is None else torch.zeros(
        b, dtype=torch.int32, device=before.device)
    ms, call, how = timed(lambda: qa.quota_alloc(
        mode, scratch, *rows, gate=gate, gate_out=gate_k), 200)
    plain, _, _ = timed(lambda: qa.quota_alloc_plain(
        mode, scratch, *rows, gate), 5 if mode == "scan" else 20)
    n_bytes, ops = quota_work(mode, before, rows, gate)
    lib, lib_call = None, None
    if mode != "fast":
        key = torch.where(rows[4] != 0, rows[0], 2**31 - 1)
        lib = time_ms(lambda: torch.argsort(key, stable=True), 200)
        lib_call = "torch.argsort(stable=True) of the bucket keys only"
    return ms, call, how, plain, n_bytes, ops, lib, lib_call


def quota_edge_rows(rng, n_buckets: int, k: int, b: int, kind: str,
                    device: str):
    """One edge batch → (plane, the 8 row tensors, modes to hold)."""
    import numpy as np
    import torch
    nb = n_buckets
    buckets = rng.integers(0, min(nb, 3 + b // 8), b)
    amounts = rng.integers(-2, 9, b)
    be = rng.random(b) < 0.4
    mx = np.take(rng.integers(5, 40, nb), buckets)
    active = rng.random(b) < 0.9
    ticks = np.take(rng.integers(20, 40, nb), buckets)
    gap = np.take(rng.choice([0, 1, k, k + 3, 3 * k, -1], nb), buckets)
    lasts = ticks - gap
    rolling = np.take(rng.random(nb) < 0.6, buckets)
    plane = rng.integers(0, 4, (nb, k))
    modes = ("scan", "unit", "seg")
    if kind == "over_domain":
        amounts[rng.random(b) < 0.2] = 1_500_000_000
        amounts[rng.random(b) < 0.1] = 1 << 21
        amounts[rng.random(b) < 0.1] = 0
    elif kind == "shrunken":
        plane[:, 0] = 2**31 - 5
        mx = mx - 50
    elif kind == "ties":
        amounts = rng.choice([3, 3, 3, 5], b)
        plane[:] = 2
    elif kind == "unique":
        buckets = rng.permutation(nb)[:b]
        mx, ticks = np.take(rng.integers(5, 40, nb), buckets), \
            np.take(rng.integers(20, 40, nb), buckets)
        lasts = ticks - np.take(rng.choice([0, 1, k, k + 3], nb), buckets)
        rolling = np.take(rng.random(nb) < 0.6, buckets)
        modes = ("scan", "fast", "seg")
    rows = [torch.from_numpy(np.asarray(x, np.int32)).to(device)
            for x in (buckets, amounts, be, mx, active, ticks, lasts,
                      rolling)]
    return torch.from_numpy(plane.astype(np.int32)).to(device), rows, modes


def quota_edge_checks(device: str = "cuda") -> int:
    """Phase 9b: K9 against its plain version on inputs the served
    traffic does not produce: negative, zero, DOMAIN_MAX and over-domain
    amounts; used > max; same-amount ties at the budget boundary;
    rolling and exact rows mixed with ticks - last of 0, 1, K, more
    than K and negative; K = 1; B = 1, 64, 512, 2048 and a ragged 777;
    the in-step gate with rule -1, a denied status, an invisible
    namespace, an unmatched rule and R = 0."""
    import numpy as np
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    rng = np.random.default_rng(77)
    n = 0
    for b, kind, k in ((1, "plain", 10), (64, "over_domain", 10),
                       (512, "shrunken", 10), (2048, "ties", 10),
                       (777, "plain", 10), (512, "unique", 10),
                       (2048, "unique", 10), (777, "over_domain", 1),
                       (64, "ties", 1)):
        plane, rows, modes = quota_edge_rows(rng, 4096, k, b, kind, device)
        if k == 1:
            rows[7].zero_()           # make_alloc_step: no row rolls
        for mode in modes:
            quota_alloc_check(f"edge {kind} B={b} K={k}", mode, plane, rows,
                              None)
            n += 1
        for n_rules in (5, 0):
            gate = qa.QuotaGate(
                status=torch.from_numpy(np.where(
                    rng.random(b) < 0.2, 7, 0).astype(np.int32)).to(device),
                matched=torch.from_numpy(rng.random((b, n_rules)) < 0.7).to(
                    device),
                rule_idx=torch.from_numpy(rng.integers(
                    -1, n_rules + 1, b).astype(np.int32)).to(device),
                rule_ns=torch.from_numpy(rng.integers(
                    0, 3, n_rules).astype(np.int32)).to(device),
                req_ns=torch.from_numpy(rng.integers(
                    -1, 3, b).astype(np.int32)).to(device),
                default_ns=0)
            quota_alloc_check(f"edge {kind} B={b} gate R={n_rules}", "seg",
                              plane, rows, gate)
            n += 1
    if device == "cuda":
        torch.cuda.synchronize()
    return n


def quota_ledger_checks(pool, ledger: list) -> dict:
    """Conservation on the card's pool after the drive: for every bucket
    a grant was committed to, the plane's row reads back exactly the sum
    of the grants committed at the ticks its last roll kept (last tick -
    K, last tick]; rows past the keymap are zero; and no key was granted
    more than QUOTA_MAX inside any window of K ticks."""
    import numpy as np
    from istio_tpu_torch.adapters.memquota import _key
    k = pool.k_ticks
    tick_len = QUOTA_WINDOW_S / k
    key_of = pool._bucket_of
    buckets = np.asarray([key_of[_key({"name": QUOTA_INSTANCE,
                                       "dimensions": {"user": u}})]
                          for u, _, _ in ledger], np.int64)
    ticks = np.asarray([int(now / tick_len) for _, now, _ in ledger],
                       np.int64)
    grants = np.asarray([g for _, _, g in ledger], np.int64)
    t0 = int(ticks.min())
    span = int(ticks.max()) - t0 + 1
    touched, inv = np.unique(buckets, return_inverse=True)
    per_tick = np.zeros((touched.size, span + k), np.int64)
    np.add.at(per_tick, (inv, ticks - t0 + k), grants)
    cum = np.cumsum(per_tick, axis=1)
    window = cum[:, k:] - cum[:, :-k]      # window ending at each tick
    worst = int(window.max())
    if worst > QUOTA_MAX:
        raise AssertionError(f"a key was granted {worst} > {QUOTA_MAX} "
                             "inside one window")
    last = pool._last_tick[touched] - t0
    if (last < 0).any() or (last >= span).any():
        raise AssertionError("a touched bucket's last tick lies outside "
                             "the drive")
    expect = window[np.arange(touched.size), last]
    plane = pool.counts.cpu().numpy().astype(np.int64)
    got = plane[touched].sum(axis=1)
    bad = np.nonzero(got != expect)[0]
    if bad.size:
        i = int(bad[0])
        raise AssertionError(f"bucket {int(touched[i])} reads back "
                             f"{int(got[i])}, its grants in the window sum "
                             f"to {int(expect[i])} ({bad.size} buckets "
                             "differ)")
    beyond = int(np.count_nonzero(plane[len(key_of):]))
    if beyond:
        raise AssertionError(f"{beyond} nonzero cells past the keymap")
    return {"buckets": int(touched.size), "grants": int(grants.sum()),
            "max_window": worst, "ticks": span}


def audit_quota_leg(srv, cpu) -> None:
    """Phase 9 (d): the audit plane's quota_conservation over the live
    pool (QUOTA_KEYS keys, fed alike on both servers so far): ok, its
    device_pools evidence equal on the card and the CPU, and a skewed
    negative-cell reading violated."""
    from istio_tpu_torch.runtime.audit import SEAMS
    t0 = time.perf_counter()
    got = fresh_quota_check(srv.audit)
    read_s = time.perf_counter() - t0
    want = fresh_quota_check(cpu.audit)
    pools = got["evidence"]["device_pools"]
    if got["status"] != "ok" or want["status"] != "ok" or \
            pools != want["evidence"]["device_pools"] or \
            [p["n_used"] for p in pools.values()] != [QUOTA_KEYS]:
        raise AssertionError(f"[9d] quota_conservation card {got}, CPU "
                             f"{want}")
    SEAMS.quota_negative_cells_skew = 1
    try:
        bad = fresh_quota_check(srv.audit)
    finally:
        SEAMS.reset()
    if bad["status"] != "violated":
        raise AssertionError(f"[9d] a negative cell read {bad}")
    log(f"[9d] audit quota_conservation over the live pool ok, an "
        f"evaluate() that reads it {read_s * 1e3:.2f} ms (the counter plane "
        f"pulled on the auditor's stream after its producing stream): "
        f"{json.dumps(pools)}, equal to the CPU "
        f"server's; quota_negative_cells_skew=1 → violated ({bad['note']})")


def quota_phase(int_rate: float) -> dict:
    """Phase 9: the served Quota() path on the quota world
    (make_store(10_000) + the Bookinfo sample's limit, 100,000 live
    keys), the launch counters zeroed just before its drive and read just
    after. The card's server and a device="cpu" server, each pool on its
    own injected clock stepped QUOTA_STEP_S per batch:
      fill         100,000 unique users in a random order, check_many +
                   quota_fused per row on the card, the CPU pool's alloc
                   on the same instances (fast-mode flushes);
      classic unit zipf users, amount 1, check_many + quota_fused per
                   passed row from one thread (unit-mode flushes);
      in-step      check_batch_quota_instep on zipf users at amount 1,
                   then at amounts 1-5 (the seg kernel with the gate);
    every CheckResponse and QuotaResult equal to the CPU server's, at
    B in E2E_BATCHES. Then classic mixed amounts on the card alone
    (seg-mode flushes, whose grants depend on flush boundaries: held at
    the kernel level). One quota_alloc launch per flush and per in-step
    trip; conservation and the window limit on the card's plane; K9 vs
    its plain version on a captured trip of every mode (timed), then
    edge inputs (9b); walls, busy and idle share; K9 per mode at 512 and
    2048 rows."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.adapters.sdk import QuotaArgs

    t0 = time.perf_counter()
    srv, store, pool, clock = quota_server(
        "cuda", dict(buckets=E2E_BATCHES, max_batch=HEADLINE_B,
                     rulestats_drain_s=0))
    build_s = time.perf_counter() - t0
    cpu, cpu_store, cpu_pool, cpu_clock = quota_server(
        "cpu", dict(CPU_SERVER, max_batch=HEADLINE_B))
    plan = srv.controller.dispatcher.fused
    if srv.instep_quota_target() is None or \
            cpu.instep_quota_target() is None:
        raise AssertionError("quota world: the snapshot is not in-step "
                             "eligible")
    warmed = plan._instep_warmed
    log(f"[9] quota world: snapshot + plan + in-step warm {sorted(warmed)} "
        f"on the card {build_s:.2f} s; "
        f"{len(srv.controller.dispatcher.snapshot.rules)} rules, pool "
        f"[{pool.n_buckets}, {pool.k_ticks}] int32 "
        f"({pool.counts.numel() * 4 / 1e6:.2f} MB), limit {QUOTA_MAX} per "
        f"{QUOTA_WINDOW_S} s window")
    flushes, trips = [], []
    flush, instep = pool._flush, plan.packed_check_instep

    def counted_flush(batch):
        flushes.append(len(batch))
        return flush(batch)

    def counted_instep(*a, **kw):
        trips.append(1)
        return instep(*a, **kw)

    pool._flush, plan.packed_check_instep = counted_flush, counted_instep
    ledger: list = []       # (user, now, units consumed) on the card

    def book(users, results, resp=None):
        for i, q in results.items():
            if resp is None or resp[i].status_code == OK:
                ledger.append((f"user{int(users[i])}", clock.t,
                               q.granted_amount))

    def step():
        clock.t += QUOTA_STEP_S
        cpu_clock.t += QUOTA_STEP_S

    rng = np.random.default_rng(2279)
    captured: dict = {}
    kernels.launches.reset()
    checks = 0
    # ---- fill: 100k unique users through the classic path
    t_fill = time.perf_counter()
    users_all = rng.permutation(QUOTA_KEYS)
    inst = cpu.controller.dispatcher.snapshot.instances[QUOTA_INSTANCE]
    one = QuotaArgs(quota_amount=1)
    for n, lo in enumerate(range(0, QUOTA_KEYS, HEADLINE_B)):
        users = users_all[lo:lo + HEADLINE_B]
        bags, cbags = quota_bags(users, seed=lo)
        with capture_if(n == 0) as cap:
            resp = srv.check_many(bags)
            futs = [srv.quota_fused(b, "rq", one, r)
                    for b, r in zip(bags, resp)]
            got = {i: resolve(q) for i, q in enumerate(futs)}
        checks += 1
        want = [cpu_pool.alloc(QUOTA_INSTANCE, inst.build(b), one)
                for b in cbags]
        for i, q in enumerate(want):
            same_quota(f"fill batch {n} row {i}", got[i], q.result())
        book(users, got)
        if n == 0:
            captured["fast"] = [c for c in cap if c[0] == "quota_alloc"]
        step()
    if len(pool._bucket_of) != QUOTA_KEYS:
        raise AssertionError(f"fill: {len(pool._bucket_of)} live keys")
    modes = {c[1][0] for c in captured["fast"]}
    if modes != {"fast"}:
        raise AssertionError(f"fill flushes ran {modes}")
    log(f"[9] fill: {QUOTA_KEYS:,} unique users, {len(flushes)} flushes "
        f"(fast mode), every QuotaResult equal to the CPU pool's; "
        f"{len(pool._bucket_of):,} live keys of {pool.n_buckets:,} "
        f"({time.perf_counter() - t_fill:.1f} s)")
    # ---- classic path, unit amounts, one thread: grant by grant
    exhausted = {"classic": 0, "in-step unit": 0, "in-step mixed": 0}
    for b, n_batches in QUOTA_UNIT_BATCHES.items():
        for s in range(n_batches):
            users = zipf_users(rng, b)
            bags, cbags = quota_bags(users, seed=b + s)
            args = [one] * b
            cap_this = b == HEADLINE_B and s == 0
            with capture_if(cap_this) as cap:
                resp, got = classic_round(srv, bags, args)
            checks += 1
            cresp, want = classic_round(cpu, cbags, args)
            compare_responses(f"classic B={b} batch {s}", resp, cresp)
            if set(got) != set(want):
                raise AssertionError(f"classic B={b}: quota rows differ")
            for i in got:
                same_quota(f"classic B={b} batch {s} row {i}", got[i],
                           want[i])
            exhausted["classic"] += sum(q.status_code == RESOURCE_EXHAUSTED
                                        for q in got.values())
            book(users, got)
            if cap_this:
                captured["unit"] = [c for c in cap if c[0] == "quota_alloc"]
            step()
    modes = {c[1][0] for c in captured["unit"]}
    if modes != {"unit"}:
        raise AssertionError(f"contended unit flushes ran {modes}")
    log(f"[9] classic path (check_many + quota_fused), unit amounts: "
        f"{sum(QUOTA_UNIT_BATCHES.values())} batches at B in "
        f"{list(QUOTA_UNIT_BATCHES)}, responses and QuotaResults equal to "
        f"the CPU server's grant by grant; {exhausted['classic']} "
        "RESOURCE_EXHAUSTED (the hot keys pass the limit)")
    # ---- in-step: unit, then mixed amounts
    for label, batches in (("in-step unit", QUOTA_UNIT_BATCHES),
                           ("in-step mixed", QUOTA_MIXED_BATCHES)):
        for b, n_batches in batches.items():
            for s in range(n_batches):
                users = zipf_users(rng, b)
                amounts = np.ones(b, np.int64) if label == "in-step unit" \
                    else rng.integers(1, 6, b)
                be = rng.random(b) < 0.5
                bags, cbags = quota_bags(users, seed=7 * b + s)
                qrows = [(i, "rq", QuotaArgs(quota_amount=int(a),
                                             best_effort=bool(e)))
                         for i, (a, e) in enumerate(zip(amounts, be))]
                cap_this = b == HEADLINE_B and label == "in-step mixed"
                with capture_if(cap_this) as cap:
                    resp, got = srv.check_batch_quota_instep(
                        bags, qrows, srv.instep_quota_target())
                checks += 1
                cresp, want = cpu.check_batch_quota_instep(
                    cbags, qrows, cpu.instep_quota_target())
                compare_responses(f"{label} B={b} batch {s}", resp, cresp)
                if set(got) != set(want):
                    raise AssertionError(f"{label} B={b}: quota rows differ")
                for i in got:
                    same_quota(f"{label} B={b} batch {s} row {i}", got[i],
                               want[i])
                exhausted[label] += sum(
                    got[i].status_code == RESOURCE_EXHAUSTED
                    for i in got if resp[i].status_code == OK)
                book(users, got, resp)
                if cap_this:
                    captured["instep"] = [c for c in cap
                                          if c[0] == "quota_alloc"]
                step()
    log(f"[9] in-step path (check_batch_quota_instep): unit and mixed "
        f"amounts at B in {list(E2E_BATCHES)}, every CheckResponse and "
        f"QuotaResult equal to the CPU server's; RESOURCE_EXHAUSTED: "
        f"{exhausted['in-step unit']} unit, {exhausted['in-step mixed']} "
        "mixed")
    audit_quota_leg(srv, cpu)
    # ---- classic path, mixed amounts, the card alone (seg flushes)
    for s in range(2):
        users = zipf_users(rng, HEADLINE_B)
        bags, _ = quota_bags(users, seed=99 + s)
        args = [QuotaArgs(quota_amount=int(a), best_effort=bool(e))
                for a, e in zip(rng.integers(1, 6, HEADLINE_B),
                                rng.random(HEADLINE_B) < 0.5)]
        with capture_if(s == 0) as cap:
            resp, got = classic_round(srv, bags, args)
        checks += 1
        book(users, got)
        if s == 0:
            captured["seg"] = [c for c in cap if c[0] == "quota_alloc"]
        step()
    modes = {c[1][0] for c in captured["seg"]}
    if modes != {"seg"}:
        raise AssertionError(f"contended mixed flushes ran {modes}")
    torch.cuda.synchronize()
    pool._flush, plan.packed_check_instep = flush, instep
    out = path_counts("[9] quota path", QUOTA_KERNELS, checks)
    n_launch = out["counts"]["quota_alloc"]
    if n_launch != len(flushes) + len(trips) or \
            out["grids"]["quota_alloc"] != n_launch:
        raise AssertionError(f"quota_alloc: {n_launch} launches for "
                             f"{len(flushes)} flushes and {len(trips)} "
                             "in-step trips")
    log(f"[9] quota_alloc: {n_launch} launches = {len(flushes)} flushes "
        f"+ {len(trips)} in-step trips (one each)")
    cons = quota_ledger_checks(pool, ledger)
    log(f"[9] conservation: {cons['buckets']:,} buckets read back exactly "
        f"the grants committed inside their window ({cons['grants']:,} "
        f"units over {cons['ticks']} ticks); the most any key got inside "
        f"a window: {cons['max_window']} <= {QUOTA_MAX}; no cell past the "
        "keymap")
    # ---- K9 against its plain version on a captured trip of each mode
    rows = {}
    log("[9] quota_alloc against its plain version on captured trips "
        "(timed; seg also through the sequential scan):")
    for mode in ("fast", "unit", "seg", "instep"):
        caps = captured[mode]
        if not caps:
            raise AssertionError(f"no captured {mode} launch")
        for c in caps[1:]:
            check_kernels([c], None)
        # the largest captured launch of the mode is its timed row
        big = max(caps, key=lambda c: int(c[1][2].shape[0]))
        rows[mode] = check_kernels([big], None, int_rate)[0]
    mode_rows = quota_mode_times(pool, rng, int_rate)
    n_edge = quota_edge_checks(pool.counts.device.type)
    log(f"[9b] {n_edge} edge cases: quota_alloc equal to its plain version")
    quota_cluster_checks(rng)
    results = quota_walls(srv, rng)
    for x in (srv, cpu, store, cpu_store):
        x.close()
    log("[9c] quota_alloc above 8,192 rows (one cluster launch; scan on "
        "the multi-launch path) against its plain version, zipf keys over "
        "the 100,000-key pool (timed; "
        f"{time.perf_counter() - t0:.1f} s into phase 9):")
    mode_rows.update(quota_big_checks(int_rate, rng))
    big = quota_instep_big(rng)
    row = dict(rows["instep"])
    row["path"] = "quota"
    row["modes"] = {m: {k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "bytes", "ops", "grids")
                        if k in r}
                    for m, r in {**rows, **mode_rows}.items()}
    return {**out, "results": results, "rows": [row], "conservation": cons,
            "flushes": len(flushes), "trips": len(trips),
            "instep_16384": big}


QUOTA_BIG_BATCHES = (8193, 32768)   # timed above 8,192 rows
# held against the plain version, with K9's grids per call: both sides of
# the one-block scan's limit, of a block seam and of the cluster's
# capacity (csrc/quota_alloc.cu kClusterRows = 65,536)
QUOTA_SEAM_BATCHES = (8192, 8193, 16384, 16385, 65536, 65537)
QUOTA_INSTEP_BIG = 16384            # ServerArgs(max_batch=16384) trip
QUOTA_INSTEP_BIG_TRIPS = 1
K9_SCAN_TILE = 4096                 # csrc/quota_alloc.cu kScanTile
K9_CLUSTER_ROWS = 65536             # csrc/quota_alloc.cu kClusterRows


def quota_big_rows(rng, b: int, mode: str, device: str, keys=None,
                   k: int = 10):
    """One contended batch of `b` rows: zipf(QUOTA_ZIPF) keys (or `keys`)
    over the QUOTA_KEYS pool (per-key max / tick / last / rolling),
    amounts 1 (unit) or -1..5, a random [QUOTA_KEYS, k] plane, and for
    "gate" the in-step gate inputs → (plane, rows, gate, the hot key's
    run)."""
    import numpy as np
    import torch
    from istio_tpu_torch.models import quota_alloc as qa
    nb = QUOTA_KEYS
    keys = zipf_users(rng, b).astype(np.int64) if keys is None else \
        np.asarray(keys, np.int64)
    amounts = np.ones(b) if mode == "unit" else rng.integers(-1, 6, b)
    per_key = [rng.integers(40, 400, nb), rng.integers(0, 3 * k, nb),
               rng.integers(0, 3 * k, nb), rng.random(nb) < 0.7]
    mx, ticks, lasts, rolling = (np.take(x, keys) for x in per_key)
    rows = [torch.from_numpy(np.asarray(x).astype(np.int32)).to(device)
            for x in (keys, amounts, rng.random(b) < 0.4, mx,
                      rng.random(b) < 0.9, ticks, lasts, rolling)]
    plane = torch.from_numpy(rng.integers(0, 3, (nb, k)).astype(
        np.int32)).to(device)
    gate = None
    if mode == "gate":
        n_rules = 5

        def t(x):
            return torch.from_numpy(np.asarray(x)).to(device)

        gate = qa.QuotaGate(
            status=t(np.where(rng.random(b) < 0.2, 7, 0).astype(np.int32)),
            matched=t(rng.random((b, n_rules)) < 0.7),
            rule_idx=t(rng.integers(-1, n_rules + 1, b).astype(np.int32)),
            rule_ns=t(rng.integers(0, 3, n_rules).astype(np.int32)),
            req_ns=t(rng.integers(-1, 3, b).astype(np.int32)),
            default_ns=0)
    hot = int(np.bincount(keys).max())
    return plane, rows, gate, hot


K9_PROBE_SLOTS = 32                 # csrc/quota_alloc.cu kProbeSlots
# the cluster kernel's stamp slots (each stamped at the end of its stage)
K9_STAGES = {1: "prep", 10: "run flags + scan 1", 11: "used",
             12: "grants (unit) / all-or-nothing (seg)", 13: "scan 2",
             14: "commits", 15: "pass 1 rank", 16: "pass 1 counter scan",
             17: "pass 1 local order", 18: "pass 1 cluster offsets",
             **{2 + p: f"radix pass {p + 1}" for p in range(8)}}


def k9_stage_split(mode: str, plane, rows, gate) -> list[dict]:
    """Where one K9 call spends its time: the call run from the probe
    build of quota_alloc.cu (kernels.probing), whose kernels stamp
    (%globaltimer, clock64) from thread 0 of each block at every stage
    boundary (the multi-launch path: a one-thread stamp kernel between
    its launches). Run twice (the first call warms), on a copy of the
    plane. → per stamped slot: {"slot", "us" (globaltimer since slot 0
    of block 0), "cycles" (clock64 since slot 0, block 0), "last_us"
    (the latest block's stamp)}."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.models import quota_alloc as qa
    b = int(rows[0].shape[0])
    buf = torch.zeros(64 * K9_PROBE_SLOTS * 2, dtype=torch.int64,
                      device=plane.device)
    gate_k = None if gate is None else torch.zeros(
        b, dtype=torch.int32, device=plane.device)
    with kernels.probing("quota_alloc") as lib:
        setp = lib.quota_alloc_probe
        setp.argtypes, setp.restype = [kernels.VP], int
        for _ in range(2):
            buf.zero_()
            torch.cuda.synchronize()
            if kernels.check(setp(kernels.ptr(buf)), "quota_alloc_probe"):
                raise AssertionError("quota_alloc_probe")
            qa.quota_alloc(mode, plane.clone(), *rows, gate=gate,
                           gate_out=gate_k)
            torch.cuda.synchronize()
        setp(None)
    st = buf.view(64, K9_PROBE_SLOTS, 2).cpu()
    if int(st[0, 0, 0]) == 0:
        raise AssertionError("k9 stage split: no stamp in slot 0")
    t0, c0 = int(st[0, 0, 0]), int(st[0, 0, 1])
    out = []
    for i in range(K9_PROBE_SLOTS):
        ns = st[:, i, 0]
        if int(ns[0]) == 0:
            continue
        out.append({"slot": i, "us": (int(ns[0]) - t0) / 1e3,
                    "cycles": int(st[0, i, 1]) - c0,
                    "last_us": (int(ns.max()) - t0) / 1e3})
    return out


def k9_grids(mode: str, b: int) -> int:
    """`__global__` launches one K9 call of `mode` at `b` rows must make:
    one up to the cluster's capacity (scan: the one-block limit), more
    above it."""
    from istio_tpu_torch.models import quota_alloc as qa
    limit = qa.SCAN_BLOCK_ROWS if mode == "scan" else qa.CLUSTER_ROWS
    return 1 if mode == "fast" or b <= limit else 2


def quota_call_grids(mode: str, plane, rows, gate) -> int:
    """One K9 call on a copy of the plane → its `__global__` launches."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.models import quota_alloc as qa
    b = int(rows[0].shape[0])
    g0 = kernels.launches.grids["quota_alloc"]
    gate_k = None if gate is None else torch.zeros(
        b, dtype=torch.int32, device=plane.device)
    qa.quota_alloc(mode, plane.clone(), *rows, gate=gate, gate_out=gate_k)
    return kernels.launches.grids["quota_alloc"] - g0


def quota_cluster_checks(rng) -> int:
    """Phase 9b on K9's launch paths: unit, seg and gated seg at
    QUOTA_SEAM_BATCHES zipf rows, then at 16,384 and 65,536 rows one hot
    bucket (90 % of the rows, a run across every block of the cluster)
    and all-distinct buckets, and K = 1 fixed counters at 16,385 rows:
    each equal to the plain version, with K9's `__global__` grids per
    call printed (one up to the cluster's capacity). → cases."""
    import numpy as np
    n = 0
    cases = [(b, mode, "zipf", 10) for b in QUOTA_SEAM_BATCHES
             for mode in ("unit", "seg", "gate")]
    cases += [(b, mode, kind, 10) for b in (16384, K9_CLUSTER_ROWS)
              for kind in ("hot", "distinct") for mode in ("unit", "seg",
                                                           "gate")]
    cases += [(16385, mode, "zipf", 1) for mode in ("unit", "seg")]
    grids_at: dict = {}
    for b, mode, kind, k in cases:
        keys = None
        if kind == "hot":
            keys = zipf_users(rng, b)
            keys[rng.random(b) < 0.9] = 4242
        elif kind == "distinct":
            keys = rng.permutation(QUOTA_KEYS)[:b]
        plane, rows, gate, hot = quota_big_rows(rng, b, mode, "cuda", keys,
                                                k)
        if k == 1:
            rows[7].zero_()           # make_alloc_step: no row rolls
        kmode = "seg" if mode == "gate" else mode
        quota_alloc_check(f"cluster {kind} {mode} B={b} K={k}", kmode,
                          plane, rows, gate)
        grids = quota_call_grids(kmode, plane, rows, gate)
        want = k9_grids(kmode, b)
        if (want == 1) != (grids == 1):
            raise AssertionError(f"K9 {mode} B={b}: {grids} grids per call")
        grids_at.setdefault(b, set()).add(grids)
        n += 1
    log("[9b] " + f"{n} cluster-path cases equal to the plain version "
        "(zipf, one hot bucket, all-distinct, K = 1); K9 grids per call: "
        + ", ".join(f"B={b}: {'/'.join(map(str, sorted(g)))}"
                    for b, g in sorted(grids_at.items())))
    return n


def quota_big_checks(int_rate: float, rng) -> dict:
    """Phase 9c: quota_alloc above the one-block scan's 8,192 rows,
    against its plain version in unit, seg, scan and gated seg at
    QUOTA_BIG_BATCHES rows, each timed with its grids, bound, the stable
    argsort of its keys and its stage split (k9_stage_split). At 32,768
    rows the hottest key's run is longer than a scan tile, so the scan's
    sums and running maxima cross tile and block seams."""
    out = {}
    for b in QUOTA_BIG_BATCHES:
        for mode in ("unit", "seg", "scan", "gate"):
            plane, rows, gate, hot = quota_big_rows(rng, b, mode, "cuda")
            if b == QUOTA_BIG_BATCHES[-1] and hot <= K9_SCAN_TILE:
                raise AssertionError(f"B={b}: the hottest key has {hot} "
                                     "rows, no run spans several tiles")
            kmode = "seg" if mode == "gate" else mode
            quota_alloc_check(f"big {mode} B={b}", kmode, plane, rows, gate)
            grids = quota_call_grids(kmode, plane, rows, gate)
            if (k9_grids(kmode, b) == 1) != (grids == 1):
                raise AssertionError(f"B={b} {mode}: {grids} grid(s) per "
                                     "call")
            ms, call, how, plain, n_bytes, ops, lib, _ = quota_alloc_times(
                kmode, plane, rows, gate)
            bms, by = bound(n_bytes, ops, int_rate)
            log(f"  quota_alloc {mode:<5} B={b:6d} {ms_label(how)} "
                f"{ms:9.5f} ms "
                f"(per call incl. launch {call:8.5f}, {grids} grids)   plain "
                f"{plain:9.5f} ms   bound {bms:9.7f} ms ({by})   equal: yes"
                f"   hottest key {hot} rows   [{how}]   argsort "
                f"{lib:9.5f} ms")
            row = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                   "bound_by": by, "library_ms": lib, "bytes": n_bytes,
                   "ops": ops, "grids": grids, "hot_rows": hot}
            if mode != "scan":
                row["stages"] = k9_stage_split(kmode, plane, rows, gate)
                log("    stage stamps (us since the start, block 0): "
                    + ", ".join(f"{K9_STAGES.get(st['slot'], st['slot'])}"
                                f" {st['us']:.2f}" for st in row["stages"]))
            out[f"{mode}@{b}"] = row
    return out


def quota_instep_big(rng) -> dict:
    """Phase 9: in-step trips of QUOTA_INSTEP_BIG rows — the card's
    server at ServerArgs(max_batch=16384, quota_in_step=True) with a
    16,384 bucket (its constructor warms it) against a device="cpu"
    server: every CheckResponse and QuotaResult equal, one quota_alloc
    call of one `__global__` launch (the cluster path), and conservation
    on the card's plane."""
    import numpy as np
    from istio_tpu_torch import kernels
    from istio_tpu_torch.adapters.sdk import QuotaArgs
    b = QUOTA_INSTEP_BIG
    t_build = time.perf_counter()
    srv, store, pool, clock = quota_server(
        "cuda", dict(buckets=(b,), max_batch=b, rulestats_drain_s=0))
    cpu, cpu_store, _, cpu_clock = quota_server(
        "cpu", dict(CPU_SERVER, max_batch=b))
    build_s = time.perf_counter() - t_build
    plan = srv.controller.dispatcher.fused
    if not any(b in key[0] for key in plan._instep_warmed):
        raise AssertionError(f"in-step warm {sorted(plan._instep_warmed)} "
                             f"lacks the {b} bucket")
    ledger, walls, cpu_walls = [], [], []
    for s in range(QUOTA_INSTEP_BIG_TRIPS):
        users = zipf_users(rng, b)
        bags, cbags = quota_bags(users, seed=31 + s)
        qrows = [(i, "rq", QuotaArgs(quota_amount=int(a),
                                     best_effort=bool(e)))
                 for i, (a, e) in enumerate(zip(rng.integers(1, 6, b),
                                                rng.random(b) < 0.5))]
        g0 = dict(kernels.launches.grids)
        n0 = kernels.launches["quota_alloc"]
        t0 = time.perf_counter()
        resp, got = srv.check_batch_quota_instep(
            bags, qrows, srv.instep_quota_target())
        walls.append((time.perf_counter() - t0) * 1e3)
        if kernels.launches["quota_alloc"] != n0 + 1 or \
                kernels.launches.grids["quota_alloc"] - \
                g0["quota_alloc"] != 1:
            raise AssertionError(f"in-step B={b}: not one quota_alloc "
                                 "call of one cluster launch")
        t0 = time.perf_counter()
        cresp, want = cpu.check_batch_quota_instep(
            cbags, qrows, cpu.instep_quota_target())
        cpu_walls.append((time.perf_counter() - t0) * 1e3)
        compare_responses(f"in-step B={b} trip {s}", resp, cresp)
        if set(got) != set(want):
            raise AssertionError(f"in-step B={b}: quota rows differ")
        for i in got:
            same_quota(f"in-step B={b} trip {s} row {i}", got[i], want[i])
            if resp[i].status_code == OK:
                ledger.append((f"user{int(users[i])}", clock.t,
                               got[i].granted_amount))
        clock.t += QUOTA_STEP_S
        cpu_clock.t += QUOTA_STEP_S
    cons = quota_ledger_checks(pool, ledger)
    n_ex = sum(q.status_code == RESOURCE_EXHAUSTED for q in got.values())
    log(f"[9] in-step B={b} (ServerArgs(max_batch={b}), bucket {b}; both "
        f"servers built in {build_s:.1f} s): {len(walls)} trip(s), every "
        f"CheckResponse and QuotaResult equal to the CPU server's, one "
        f"quota_alloc cluster launch each; card walls "
        + " / ".join(f"{w:.1f}" for w in walls) + " ms, CPU "
        + " / ".join(f"{w:.1f}" for w in cpu_walls) + f" ms; {n_ex} "
        f"RESOURCE_EXHAUSTED; conservation: {cons['buckets']:,} buckets "
        f"read back their grants, most in a window {cons['max_window']}")
    for x in (srv, cpu, store, cpu_store):
        x.close()
    return {"walls_ms": walls, "conservation": cons}


def quota_mode_times(pool, rng, int_rate: float) -> dict:
    """K9 per mode at 512 and 2048 rows on the live plane: the rows a
    flush of zipf users (unique users for fast) would stage."""
    import numpy as np
    import torch
    out = {}
    tick_len = QUOTA_WINDOW_S / pool.k_ticks
    abs_tick = int(pool._clock() / tick_len)
    for b in (512, HEADLINE_B):
        for mode in ("fast", "unit", "seg", "scan"):
            users = rng.permutation(QUOTA_KEYS)[:b] if mode == "fast" \
                else zipf_users(rng, b)
            buckets = users.astype(np.int64)   # the fill's keys: any rows
            amounts = np.ones(b) if mode == "unit" else rng.integers(1, 6, b)
            base = pool._tick_base[buckets]
            staged = np.stack([
                buckets, amounts, rng.random(b) < 0.5,
                np.full(b, QUOTA_MAX), np.ones(b), abs_tick - base,
                pool._last_tick[buckets] - base, np.ones(b)]).astype(np.int32)
            qrows = list(torch.from_numpy(staged).to(pool.counts.device))
            quota_alloc_check(f"{mode} B={b}", mode, pool.counts, qrows, None)
            ms, call, how, plain, n_bytes, ops, lib, _ = quota_alloc_times(
                mode, pool.counts, qrows, None)
            bms, by = bound(n_bytes, ops, int_rate)
            log(f"  quota_alloc {mode:<5} B={b:5d} {ms_label(how)} "
                f"{ms:9.5f} ms "
                f"(per call incl. launch {call:8.5f})   plain {plain:9.5f} "
                "ms   "
                f"bound {bms:9.7f} ms ({by})   equal: yes   [{how}]"
                + ("" if lib is None else f"   argsort {lib:9.5f} ms"))
            out[f"{mode}@{b}"] = {"ms": ms, "plain_ms": plain,
                                  "bound_ms": bms, "bound_by": by,
                                  "library_ms": lib, "bytes": n_bytes,
                                  "ops": ops}
    return out


def quota_walls(srv, rng) -> dict:
    """Walls of the two served paths on the card (zipf users): the
    in-step trip (mixed amounts) and the classic check-then-quota round
    (unit amounts), p50 / p99 over QUOTA_ITERS calls, and the in-step
    trip's device busy and idle share."""
    import numpy as np
    from istio_tpu_torch.adapters.sdk import QuotaArgs
    out = {}
    for b in E2E_BATCHES:
        users = zipf_users(rng, b)
        bags, _ = quota_bags(users, seed=5 * b)
        qrows = [(i, "rq", QuotaArgs(quota_amount=int(a)))
                 for i, a in enumerate(rng.integers(1, 6, b))]
        args = [QuotaArgs(quota_amount=1)] * b

        def instep():
            return srv.check_batch_quota_instep(bags, qrows,
                                                srv.instep_quota_target())

        pulls = dtoh_copies(instep)
        if pulls is not None and pulls != 1:
            raise AssertionError(f"in-step B={b}: {pulls} device-to-host "
                                 "copies in one trip")

        walls = {"instep": [], "classic": []}
        for name, fn in (("instep", instep),
                         ("classic", lambda: classic_round(srv, bags, args))):
            fn()
            for _ in range(QUOTA_ITERS):
                t = time.perf_counter()
                fn()
                walls[name].append((time.perf_counter() - t) * 1e3)
        busy = device_ms(instep, 5)
        r = {name: {"p50_ms": float(np.percentile(w, 50)),
                    "p99_ms": float(np.percentile(w, 99))}
             for name, w in walls.items()}
        r["instep"]["busy_ms"] = busy
        r["instep"]["idle_share"] = None if busy is None else \
            1 - busy / r["instep"]["p50_ms"]
        out[b] = r
        idle = "busy not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {1 - busy / r['instep']['p50_ms']:.3f}"
        log(f"[9] B={b:5d}: check_batch_quota_instep ({pulls} "
            "device-to-host copy) p50 "
            f"{r['instep']['p50_ms']:.4f} ms p99 {r['instep']['p99_ms']:.4f}"
            f" ms ({idle}); classic check_many + quota_fused p50 "
            f"{r['classic']['p50_ms']:.4f} ms p99 "
            f"{r['classic']['p99_ms']:.4f} ms")
    return out


ROUTE_RULES = 10_000          # BASELINE config 3: 10k route rules
ROUTE_BATCHES = (64, 256, 2048, 8192)
ROUTE_ITERS = 20              # timed selects per batch size
ROUTE_ORACLE_ROWS = 256       # select_host sample per batch size
ROUTE_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "route_select",
                 "atom_eval")


def route_h2d_bytes(batch, planes) -> tuple[int, int]:
    """Host-to-device bytes of one select: the dense batch's planes (what
    AttributeBatch.to moves) and the compact select's."""
    dense = nbytes(batch.ids, batch.present, batch.map_present,
                   batch.str_bytes, batch.str_lens, batch.hash_ids)
    compact = nbytes(batch.ids, batch.map_present) + int(sum(
        x.nbytes for x in planes))
    return dense, compact


def compact_select(tbl, batch):
    """The compact select of one tensorized batch → (int32 [B] on the
    device, the shipped host planes)."""
    planes = tbl._compact_planes(batch)
    if planes is None:
        raise AssertionError("compact select: the dense plane is smaller")
    flat, pres, lens = planes
    return tbl._select_on_device_compact(batch.ids, pres, batch.map_present,
                                         flat, lens), planes


def route_entry_counts() -> dict:
    """rule_match calls and the entry points of the route path's
    sources (route_select, field_eval)."""
    from istio_tpu_torch import kernels
    e = kernels.launches.entries
    return {"rule_match": kernels.launches["rule_match"],
            **{k: e[k] for src in ("route_select", "field_eval",
                                   "byte_pred", "dfa_scan")
               for k in kernels.ENTRY_POINTS[src]}}


def route_edge_checks() -> int:
    """Phase 10b: route_winner and route_densify against their plain
    versions on inputs the route traffic does not produce (no match,
    every row matched, R = 1, ties and non-positive weights; lens 0 and
    L with cap > total, n_cols not a multiple of 8, several byte slots),
    and a host-fallback world (tests/test_pilot.py:414's backreference
    rule) selected on the card equal to the CPU table and select_host."""
    import numpy as np
    import torch
    from istio_tpu_torch.ops import route_ops
    from istio_tpu_torch.pilot.model import (Config, ConfigMeta, Port,
                                             Service)
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    rng = np.random.default_rng(10)
    n = 0
    for b, r, p, kind in ((2048, ROUTE_RULES, 0.0, "no match"),
                          (256, ROUTE_RULES, 1.0, "all matched"),
                          (300, 1, 0.5, "R = 1"), (64, 300, 0.3, "ties"),
                          (64, 300, 0.3, "non-positive")):
        m = torch.from_numpy(rng.random((b, r)) < p).cuda()
        w = rng.permutation(r).astype(np.int32) + 1
        if kind == "ties":
            w = rng.integers(1, 4, r).astype(np.int32)
        elif kind == "non-positive":
            w = rng.integers(-3, 2, r).astype(np.int32)
        w = torch.from_numpy(w).cuda()
        assert_equal(f"route_winner {kind}", route_ops.route_winner(m, w, r),
                     route_ops.route_winner_plain(m, w, r))
        n += 1
    for b, nbyte, max_len, n_cols in ((2048, 1, 256, 7), (300, 3, 256, 19),
                                      (8192, 1, 256, 7), (5, 2, 16, 3)):
        lens = rng.integers(0, 40, (b, nbyte))
        lens[::3] = 0
        lens[1::5] = max_len
        cap = max(1024, 1 << int(lens.sum()).bit_length())
        flat = torch.from_numpy(rng.integers(0, 256, cap).astype(
            np.uint8)).cuda()
        l16 = torch.from_numpy(lens.astype(np.int16)).cuda()
        pres = torch.from_numpy(rng.integers(0, 256, (b, -(-n_cols // 8)))
                                .astype(np.uint8)).cuda()
        got = route_ops.route_densify(flat, l16, pres, n_cols, max_len)
        want = route_ops.route_densify_plain(flat, l16, pres, n_cols,
                                             max_len)
        for part, g, w_ in zip(("bytes", "lens", "present"), got, want):
            assert_equal(f"route_densify B={b} nbyte={nbyte} {part}", g, w_)
        n += 1
    svc = Service(hostname="svc0.default.svc.cluster.local",
                  address="10.0.0.1", ports=(Port("http", 80, "HTTP"),))

    def rule(name, headers):
        return Config(ConfigMeta(type="route-rule", name=name,
                                 namespace="default"),
                      {"destination": {"name": "svc0"},
                       "match": {"request": {"headers": headers}},
                       "route": [{"labels": {}}]})

    rules = {svc.hostname: [rule("rr-backref", {"uri": {"regex":
                                                        r"^/(a+)\1$"}}),
                            rule("rr-plain", {"uri": {"prefix": "/api/"}})]}
    card = RouteTable([svc], rules, device="cuda")
    cpu = RouteTable([svc], rules, device="cpu")
    if not card.program.host_fallback:
        raise AssertionError("host-fallback world: no rule fell back")
    reqs = [{"destination.service": svc.hostname, "request.path": p}
            for p in ("/aaaa", "/aaa", "/api/x", "/other", "/aa")]
    got = card.select(reqs)
    if not (got == cpu.select(reqs)).all() or \
            list(got) != [card.select_host(q) for q in reqs]:
        raise AssertionError("host-fallback world: selections differ")
    torch.cuda.synchronize()
    return n + 1


def route_phase(int_rate: float) -> dict:
    """Phase 10: Pilot's route selection at BASELINE config 3 —
    make_route_world(10_000), 1,000 services and 10,000 route rules
    (URI prefix, full-match regex, cookie exact, source-constrained
    prefix) — on the card against the same RouteTable on the CPU, the
    launch counters zeroed just before the drive and read just after. At
    each B of ROUTE_BATCHES (make_route_requests): the dense select
    index-equal to the CPU table and to select_host on a sample, the
    compact select equal to the dense one, the H2D bytes of both, and
    the launches of one select of each (dense: one rule_match and one
    route_winner; compact: one more route_densify); select p50 / p99,
    device busy and idle share. Every kernel of the B=2048 trips held
    against its plain version (timed), then edge inputs (10b)."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.pilot.route_nfa import RouteTable
    from istio_tpu_torch.testing import workloads

    t0 = time.perf_counter()
    services, rules = workloads.make_route_world(ROUTE_RULES)
    tbl = RouteTable(services, rules, device="cuda")
    compile_s = time.perf_counter() - t0
    cpu = RouteTable(services, rules, device="cpu")
    if tbl.program.host_fallback:
        raise AssertionError("route world: host-fallback rules")
    log(f"[10] route world: {len(services)} services, {len(tbl.entries)} "
        f"route rules compiled on the card in {compile_s:.2f} s; geometry "
        f"{json.dumps(tbl.program.geometry)}")
    rng = np.random.default_rng(1010)
    n_atom = int(tbl.program.atoms.n > 0)     # atom_eval per select
    # one literal launch per subject group per select, no plane launch
    lits = {"byte_lits": tbl.program.geometry["n_byte_groups"],
            "dfa_lits": tbl.program.geometry["n_dfa_groups"],
            "byte_pred": 0, "dfa_scan": 0}
    kernels.launches.reset()
    steps, results, captured = 0, {}, {}
    for b in ROUTE_BATCHES:
        reqs = workloads.make_route_requests(b, n_services=len(services),
                                             seed=b)
        bags = [bag_from_mapping(r) for r in reqs]
        c0 = route_entry_counts()
        with capture_if(b == HEADLINE_B) as cap:
            got = tbl.select(bags)
        torch.cuda.synchronize()
        c1 = route_entry_counts()
        steps += 1
        if {k: c1[k] - c0[k] for k in c1} != {
                "rule_match": 1, "route_winner": 1, "route_densify": 0,
                "field_eval": 0, "atom_eval": n_atom, **lits}:
            raise AssertionError(f"B={b} dense select launched "
                                 f"{ {k: c1[k] - c0[k] for k in c1} }")
        want = cpu.select(bags)
        if not (got == want).all():
            raise AssertionError(f"B={b}: card and CPU tables select "
                                 f"differently in {(got != want).sum()} rows")
        sample = rng.choice(b, min(b, ROUTE_ORACLE_ROWS), replace=False)
        for i in sample:
            if tbl.select_host(reqs[i]) != got[i]:
                raise AssertionError(f"B={b} row {i}: select_host differs")
        batch = tbl.tensorizer.tensorize(bags)
        with capture_if(b == HEADLINE_B) as cap_c:
            comp, planes = compact_select(tbl, batch)
            comp = comp.cpu().numpy()
        c2 = route_entry_counts()
        steps += 1
        if {k: c2[k] - c1[k] for k in c2} != {
                "rule_match": 1, "route_winner": 1, "route_densify": 1,
                "field_eval": 0, "atom_eval": n_atom, **lits}:
            raise AssertionError(f"B={b} compact select launched "
                                 f"{ {k: c2[k] - c1[k] for k in c2} }")
        if not (comp == got).all():
            raise AssertionError(f"B={b}: compact and dense selects differ")
        dense_b, compact_b = route_h2d_bytes(batch, planes)
        if b == HEADLINE_B:
            captured = {"dense": cap, "compact": cap_c}
        walls = []
        for _ in range(ROUTE_ITERS):
            t = time.perf_counter()
            tbl.select(bags)
            walls.append((time.perf_counter() - t) * 1e3)
        steps += ROUTE_ITERS
        staged = batch.to("cuda")
        busy = device_ms(lambda: tbl._select_on_device(staged), 5)
        steps += 6
        if b == HEADLINE_B:
            stage = check_ext_stage(f"[10] dense select B={b}",
                                    lambda: tbl._select_on_device(staged),
                                    tbl.program)
            steps += stage["calls"]
        p50 = float(np.percentile(walls, 50))
        r = {"p50_ms": p50, "p99_ms": float(np.percentile(walls, 99)),
             "busy_ms": busy, "idle_share": None if busy is None else
             1 - busy / p50, "selects_per_s": b / p50 * 1e3,
             "h2d_dense": dense_b, "h2d_compact": compact_b,
             "hit_rows": int((got != tbl.default_index).sum())}
        results[b] = r
        idle = "busy not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {r['idle_share']:.3f}"
        log(f"[10] B={b:5d}: select equal to the CPU table and to "
            f"select_host on {len(sample)} rows; compact equal to dense; "
            f"{r['hit_rows']} rows routed; select p50 {p50:.4f} ms p99 "
            f"{r['p99_ms']:.4f} ms ({r['selects_per_s']:,.0f} requests/s; "
            f"{idle}); H2D dense {dense_b:,} B, compact {compact_b:,} B; "
            "launches per select: dense rule_match 1 + atom_eval 1 + "
            f"byte_lits {lits['byte_lits']} + dfa_lits {lits['dfa_lits']} "
            "+ route_winner 1, compact + route_densify 1")
    out = path_counts("[10] route path", ROUTE_KERNELS, steps)
    one_atom_launch_per_step("[10] route path", out, tbl.program)
    one_lit_launch_per_group("[10] route path", out, tbl.program)
    out["ext_stage"] = stage
    out["entries"] = dict(kernels.launches.entries)
    log(f"[10] route_select entry points: {out['entries']}")
    log(f"[10] every kernel of the B={HEADLINE_B} dense select against its "
        "plain version (timed):")
    rows = check_kernels(captured["dense"], None, int_rate)
    log(f"[10] route_densify of the B={HEADLINE_B} compact select (timed):")
    dens = [c for c in captured["compact"] if c[0] == "route_select"
            and c[1][0] == "densify"]
    check_kernels([c for c in captured["compact"] if c not in dens], None)
    dens_row = check_kernels(dens, None, int_rate)[0]
    win_row = next(r for r in rows if r["name"] == "route_select")
    win_row["entries"] = {e: {k: r[k] for k in (
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "library_call", "bytes", "ops")} for e, r in (
            ("route_winner", win_row), ("route_densify", dens_row))}
    log(f"[10b] {route_edge_checks()} edge cases: route_winner and "
        "route_densify equal to their plain versions; a host-fallback "
        "world equal to the CPU table and select_host")
    return {**out, "results": results, "rows": rows}


DISCOVERY_FLEET = dict(n_services=2000, n_namespaces=64, replicas=5,
                       n_routes=2500, source_ns=2, seed=17)   # bench.py:2072
DISCOVERY_CHURN_ROUNDS = 8


def discovery_poll(ds, nodes, meta) -> tuple[list, float]:
    """Every sidecar's RDS poll (its namespace's port) → (bodies, s)."""
    replicas = DISCOVERY_FLEET["replicas"]
    t0 = time.perf_counter()
    bodies = [ds.list_routes(str(8000 + meta["ns_of"][i // replicas]), "c",
                             n) for i, n in enumerate(nodes)]
    return bodies, time.perf_counter() - t0


AUDIT_DISCOVERY_RULES = 40     # (e): the small servers whose auditors
#                                attach the fleet's discovery services


def audit_discovery_leg(ds, cpu_ds) -> dict:
    """Phase 11 (e): the auditor of a small server on each side with the
    fleet's DiscoveryService attached (the card's to the card server's):
    plane_agreement ok over the scope program's pairs, the pairs and the
    evidence equal on the card and the CPU; a tampered pair in
    SEAMS.plane_pairs_extra violated with a witness finding."""
    from istio_tpu_torch.runtime.audit import SEAMS
    t0 = time.perf_counter()
    args = dict(initial_prewarm=False, buckets=(8,), max_batch=8)
    built = [served(AUDIT_DISCOVERY_RULES, dev, args)
             for dev in ("cuda", "cpu")]
    try:
        (srv, _), (cpu, _) = built
        srv.audit.attach_discovery(ds)
        cpu.audit.attach_discovery(cpu_ds)
        got = audit_check(srv.audit.evaluate(), "plane_agreement")
        want = audit_check(cpu.audit.evaluate(), "plane_agreement")
        limit = srv.audit.max_pairs
        pairs = ds.snapshot.scope_audit_pairs(limit=limit)
        strip = lambda c: {k: v for k, v in c["evidence"].items()
                           if k not in AUDIT_VOLATILE}
        if got["status"] != "ok" or strip(got) != strip(want) or \
                got["evidence"]["n_discovery_pairs"] != len(pairs) or \
                not pairs or pairs != cpu_ds.snapshot.scope_audit_pairs(
                    limit=limit):
            raise AssertionError(f"[11e] plane_agreement card {got}, CPU "
                                 f"{want}; {len(pairs)} pairs")
        tamper = (f"tampered:{pairs[0][0]}", pairs[0][1], "true")
        SEAMS.plane_pairs_extra = [tamper]
        try:
            bad = audit_check(srv.audit.evaluate(), "plane_agreement")
        finally:
            SEAMS.reset()
        found = bad["evidence"].get("findings", [])
        again = audit_check(srv.audit.evaluate(), "plane_agreement")
        if bad["status"] != "violated" or \
                [f["code"] for f in found] != ["plane-divergence"] or \
                again["status"] != "ok":
            raise AssertionError(f"[11e] tampered pair {tamper}: {bad}; "
                                 f"after the seam cleared {again}")
    finally:
        for x in built:
            for y in x:
                y.close()
    seconds = time.perf_counter() - t0
    log(f"[11e] audit plane_agreement with the fleet's discovery attached: "
        f"ok over {got['evidence']['n_pairs']} mixer and "
        f"{len(pairs)} discovery pairs (e.g. {pairs[0]}), equal to the CPU "
        f"port's; the tampered pair {tamper} violated ({found[0]['message']})"
        f"; ok again once cleared ({seconds:.1f} s with the two small "
        "servers' builds)")
    return {"pairs": len(pairs), "seconds": seconds}


def discovery_phase(int_rate: float) -> dict:
    """Phase 11: Pilot's discovery service at bench.py's fleet
    (make_discovery_world: 2,000 services over 64 namespaces, 5 replicas
    = 10,000 sidecars, 2,500 route rules, the first 2 namespaces
    source-constrained) — a DiscoveryService on the card against one on
    the CPU, the launch counters zeroed just before the drive and read
    just after: every sidecar's RDS byte-equal on a cold and a warm poll,
    CDS / LDS / SDS byte-equal for one node per namespace, the same
    node groups; then DISCOVERY_CHURN_ROUNDS rounds of one-namespace
    churn, every sidecar's RDS equal after each and the scope program
    carried while its digest holds. Exactly one rule_match launch per
    admit_rows call that reaches the program; one captured launch held
    against its plain version (timed)."""
    from istio_tpu_torch import kernels
    from istio_tpu_torch.pilot.discovery import DiscoveryService
    from istio_tpu_torch.runtime import monitor
    from istio_tpu_torch.testing import workloads

    t0 = time.perf_counter()
    registry, store, nodes, meta = workloads.make_discovery_world(
        **DISCOVERY_FLEET)
    c_registry, c_store, _, _ = workloads.make_discovery_world(
        **DISCOVERY_FLEET)
    ds = DiscoveryService(registry, store, device="cuda")
    cpu = DiscoveryService(c_registry, c_store, device="cpu")
    build_s = time.perf_counter() - t0
    snap = ds.snapshot
    log(f"[11] discovery fleet: {len(nodes):,} sidecars, "
        f"{snap.n_services:,} services, {snap.n_rules:,} route rules "
        f"({snap.scope.n_constrained} source-constrained) built on both in "
        f"{build_s:.2f} s")
    admits = {"calls": 0, "program": 0}
    counted = set()

    def count_admits():
        """Count the admit_rows calls of the card's current scope
        program (each snapshot's program is wrapped once)."""
        scope = ds.snapshot.scope
        if id(scope) in counted:
            return
        counted.add(id(scope))
        real = scope.admit_rows

        def admit_rows(sources):
            admits["calls"] += 1
            if scope._program is not None and sources:
                admits["program"] += 1
            return real(sources)
        scope.admit_rows = admit_rows

    count_admits()
    kernels.launches.reset()
    base = monitor.discovery_stage_baseline()
    with kernels.launches.capture() as cap:
        cold, cold_s = discovery_poll(ds, nodes, meta)
    lat = monitor.discovery_latency_snapshot(base)["stages"]
    c_cold, c_cold_s = discovery_poll(cpu, nodes, meta)
    bad = sum(a != b for a, b in zip(cold, c_cold))
    if bad:
        raise AssertionError(f"cold poll: {bad} sidecars' RDS differ")
    groups = ds._cache.stats()["by_endpoint"]
    if groups != cpu._cache.stats()["by_endpoint"]:
        raise AssertionError("node-group counts differ")
    warm, warm_s = discovery_poll(ds, nodes, meta)
    if warm != cold:
        raise AssertionError("warm poll served other bytes")
    k_of = {}
    for i, n in enumerate(nodes):
        k_of.setdefault(meta["ns_of"][i // DISCOVERY_FLEET["replicas"]], n)
    n_other = 0
    for k, n in sorted(k_of.items()):
        host = meta["hosts_by_ns"][k][0]
        for fn, args in ((ds.list_clusters, ("c", n)),
                         (ds.list_listeners, ("c", n)),
                         (ds.list_endpoints, (f"{host}|http",))):
            other = getattr(cpu, fn.__name__)(*args)
            if fn(*args) != other:
                raise AssertionError(f"{fn.__name__}{args} differs")
            n_other += 1
    log(f"[11] cold poll: {len(nodes):,} sidecars' RDS byte-equal to the "
        f"CPU service, {groups.get('rds', 0)} RDS node groups; card "
        f"{cold_s:.3f} s ({len(nodes) / cold_s:,.0f} polls/s), CPU "
        f"{c_cold_s:.3f} s; warm poll {warm_s:.3f} s "
        f"({len(nodes) / warm_s:,.0f} polls/s); CDS / LDS / SDS equal for "
        f"{len(k_of)} namespaces ({n_other} payloads)")
    reused, churn_walls = 0, []
    ks = sorted(meta["rules_by_ns"])
    for tick in range(DISCOVERY_CHURN_ROUNDS):
        k = ks[(tick * 7) % len(ks)]
        prev = ds.snapshot.scope
        workloads.churn_discovery_rule(store, meta, k, tick)
        workloads.churn_discovery_rule(c_store, meta, k, tick)
        if ds.snapshot.scope_reused != cpu.snapshot.scope_reused:
            raise AssertionError(f"churn {tick}: scope reuse differs")
        if ds.snapshot.scope_reused:
            if ds.snapshot.scope is not prev:
                raise AssertionError(f"churn {tick}: digest held but the "
                                     "scope program was not carried")
            reused += 1
        count_admits()
        bodies, s = discovery_poll(ds, nodes, meta)
        churn_walls.append(s)
        c_bodies, _ = discovery_poll(cpu, nodes, meta)
        bad = sum(a != b for a, b in zip(bodies, c_bodies))
        if bad:
            raise AssertionError(f"churn round {tick} (ns{k}): {bad} "
                                 "sidecars' RDS differ")
        if ds._last_publish["changed_scopes"] != \
                cpu._last_publish["changed_scopes"]:
            raise AssertionError(f"churn {tick}: changed scopes differ")
    out = path_counts("[11] discovery path", ("rule_match",),
                      admits["program"])
    if out["counts"]["rule_match"] != admits["program"]:
        raise AssertionError(f"rule_match: {out['counts']['rule_match']} "
                             f"launches for {admits['program']} admit_rows "
                             "calls that reach the program")
    route_eval = lat.get("route_eval", {})
    log(f"[11] {DISCOVERY_CHURN_ROUNDS} churn rounds: every sidecar's RDS "
        f"equal after each; scope program carried in {reused}; poll after "
        f"churn {min(churn_walls):.3f}-{max(churn_walls):.3f} s; "
        f"admit_rows calls {admits['calls']} ({admits['program']} reach "
        f"the program), rule_match launches {out['counts']['rule_match']} "
        f"= one per batched generation; the card's cold poll: route_eval "
        f"{route_eval}, generate {lat.get('generate', {})}")
    k1 = [c for c in cap if c[0] == "rule_match"]
    check_kernels(k1, None)
    big = max(k1, key=lambda c: c[1][0].shape[0] *
              c[1][4]["conj_m_idx"].shape[0])
    log(f"[11] every captured admit_rows trip's rule_match ({len(k1)}) "
        "equal to its plain versions; the largest ([sources, R] = "
        f"[{big[1][0].shape[0]}, {big[1][4]['conj_m_idx'].shape[0]}]) "
        "timed:")
    rows = check_kernels([big], None, int_rate)
    try:
        disc_audit = audit_discovery_leg(ds, cpu)
    finally:
        for d in (ds, cpu):
            d.stop()
    return {**out, "rows": rows, "cold_s": cold_s, "warm_s": warm_s,
            "audit": disc_audit,
            "churn_s": churn_walls, "stages": lat,
            "sidecars": len(nodes), "groups": groups, "admits": admits,
            "scope_reused": reused}


# ---------------------------------------------------------------------------
# phase 12: sequence-parallel DFA matching (K12 seq_match, B13)
# ---------------------------------------------------------------------------

N_VIRTUAL = 8                  # virtual devices over card 0 (phases 12-13)
# (rows, chunks, chunk bytes): 8 KiB rows as 64 chunks of the layout's
# default max_str_len, Envoy's default request-header limit (60 KiB,
# max_request_headers_kb) as 480 chunks, and 16 chunks over the 8-way
# axis (two per device)
SEQ_LAYOUTS = ((2048, 64, 128), (256, 480, 128), (2048, 16, 512))
SEQ_RE_ROWS = 64               # rows held against Python `re`
SEQ_ITERS = 20


def route_regexes(n_routes: int) -> list[str]:
    """The full-match URI regexes of make_route_world(n_routes)."""
    from istio_tpu_torch.testing import workloads
    _, rules = workloads.make_route_world(n_routes)
    out = set()
    for cfgs in rules.values():
        for cfg in cfgs:
            uri = cfg.spec.get("match", {}).get("request", {}) \
                .get("headers", {}).get("uri", {})
            if "regex" in uri:
                out.add(uri["regex"])
    return sorted(out)


def route_subjects(b: int, total: int, seed: int):
    """Long URI paths for the route regexes: every third row a full
    match of `^/items/[0-9]+/r<k>$` whose digits run across chunk seams,
    every third one the same with a trailing byte (the `$` fails), the
    rest random lowercase bytes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    data = rng.integers(97, 123, (b, total), dtype=np.uint8)
    lens = np.full(b, total, np.int32)
    for i in range(0, b, 3):
        for j, tail in ((i, b""), (i + 1, b"x")):
            if j >= b:
                continue
            n_dig = int(rng.integers(1, total // 2))
            digits = rng.integers(48, 58, n_dig, dtype=np.uint8).tobytes()
            path = b"/items/" + digits + f"/r{j % 11}".encode() + tail
            data[j, :len(path)] = np.frombuffer(path, np.uint8)
            lens[j] = len(path)
    return data, lens


def chunk_map_work(data, lens, tr, c0: int) -> float:
    """The table lookups chunk_map's function needs on one launch's
    inputs: at each byte a chunk walks, one for each distinct state its S
    entry-state walks stand on, absorbing states (every byte leads back
    to them) left out. Walks that have met step as one, and a walk on an
    absorbing state needs no step; S a byte is what walks that never meet
    make."""
    import torch
    nb, nc, lc = data.shape
    s = int(tr.shape[0])
    flat = tr.reshape(-1).long()
    absorb = (tr.long() == torch.arange(s, device=tr.device)[:, None]) \
        .all(dim=1)
    starts = (torch.arange(nc, device=data.device) + c0) * lc
    walked = (lens.long()[:, None] - starts[None, :]).clamp(0, lc)
    state = torch.arange(s, device=data.device).expand(nb, nc, s)
    n = torch.zeros((), dtype=torch.int64, device=data.device)
    for i in range(int(walked.max()) if walked.numel() else 0):
        srt = state.sort(dim=2).values
        new = torch.ones_like(srt, dtype=torch.bool)
        new[..., 1:] = srt[..., 1:] != srt[..., :-1]
        on = i < walked
        n += ((new & ~absorb[srt]).sum(dim=2) * on).sum()
        nxt = flat[state * 256 + data[:, :, i].long()[..., None]]
        state = torch.where(on[..., None], nxt, state)
    return float(n)


def seq_work(launches: list) -> tuple[float, float, float]:
    """(bytes, ops, ops of every walk) of K12's launches in one sharded
    match on this run's data: chunk_map reads each chunk's walked bytes,
    the lens and the table once and writes its [C, B, S] maps, doing 1
    int op per table lookup its function needs (chunk_map_work), the
    next-state index state * 256 + byte, one IMAD (the table read is a
    load, not an ALU op; the loop's position check is overhead of the
    walk, not the function's work); S a byte walked is the third figure,
    the work of walks that never meet, a reference only. compose_maps
    reads its maps and writes [B, S] (or [B] bools), one gather per
    (chunk, row, entry state)."""
    import torch
    b = ops = every = 0.0
    for name, inputs in launches:
        kind, *args = inputs
        if kind == "chunk_map":
            data, lens, tr, c0 = args
            nb, nc, lc = data.shape
            s = int(tr.shape[0])
            starts = (torch.arange(nc, device=data.device) + c0) * lc
            walked = (lens.long()[:, None] - starts[None, :]).clamp(0, lc)
            steps = float(walked.sum())
            b += steps + nbytes(lens, tr) + nc * nb * s * 4
            ops += chunk_map_work(data, lens, tr, c0)
            every += steps * s
        else:
            maps, accept, entry = args
            nc, nb, s = maps.shape
            b += nbytes(maps) + (nb if accept is not None else nb * s * 4)
            if accept is not None:
                b += nbytes(accept)
            ops += float(nc) * nb * (1 if accept is not None else s)
            every += float(nc) * nb * (1 if accept is not None else s)
    return b, ops, every


def seq_fns(kind: str):
    """(kernel wrapper, plain version) of K12's entry point `kind`; both
    take the captured inputs after the kind."""
    from istio_tpu_torch.parallel import seq_match as sm
    if kind == "chunk_map":
        return sm.chunk_maps, sm.chunk_maps_plain
    return sm.compose, sm.compose_maps_plain


SEQ_GRAPH_REPS = 50            # launches of one graph (seq_times)


def seq_times(captured: list, int_rate: float) -> dict:
    """K12's entry points on one match's captured launches (`captured`:
    kernels.launches.capture() of one sharded_dfa_match): each launch
    timed alone on one stream (graph_ms, its graph's output held against
    the plain version), summed per entry point into device ms a match,
    beside the plain version and the bound (seq_work); for chunk_map
    `lookups` are the table lookups its function needs (the bound's
    ops) and `lookups_all_walks` S a byte walked → {kind: row}."""
    parts = {}
    for kind in ("chunk_map", "compose_maps"):
        ls = [x[1][1:] for x in captured if x[1][0] == kind]
        kern, plain_fn = seq_fns(kind)
        per = [graph_ms(lambda a=a: kern(*a), SEQ_GRAPH_REPS,
                        want=plain_fn(*a)) for a in ls]
        plain, _, _ = timed(lambda: [plain_fn(*a) for a in ls], 3)
        bb, ops, every = seq_work([(kind, (kind, *a)) for a in ls])
        bms, by = bound(bb, ops, int_rate)
        parts[kind] = {"ms": sum(per), "per_launch_ms": per,
                       "ms_source": "cuda_graph", "plain_ms": plain,
                       "bound_ms": bms, "bound_by": by, "bytes": bb,
                       "ops": ops, "launches_per_match": len(ls),
                       "library_ms": None}
        if kind == "chunk_map":
            parts[kind].update(lookups=ops, lookups_all_walks=every)
    return parts


# K12 edge inputs (phase 12): states S on every path (the register
# buckets 8 / 16 / 32 and past them, 33 and 64 with the table in shared
# memory, 240 with a 240 KB table read through L1), chunk lengths under
# 16 bytes, not a multiple of 16, one and several sub-chunks; rows at odd
# addresses and odd strides; lengths of 0, inside a chunk, on chunk seams
# and past the row; DFAs that converge (random, and with two absorbing
# states) and one that never does (a permutation of the states per byte)
SEQ_EDGE_S = (1, 2, 7, 19, 32, 33, 64, 240)
SEQ_EDGE_LC = (13, 100, 128, 200, 512)
SEQ_EDGE_KINDS = ("random", "sinks", "perm")
SEQ_EDGE_COMPOSE_C = (1, 2, 8, 60, 300)


def seq_edge_dfa(rng, s: int, kind: str):
    """An int32 [s, 256] transition table of `kind`."""
    import numpy as np
    if kind == "perm":
        return np.stack([rng.permutation(s) for _ in range(256)],
                        1).astype(np.int32)
    t = rng.integers(0, s, (s, 256)).astype(np.int32)
    if kind == "sinks":
        t[s - 1] = s - 1
        t[0] = 0
    return t


def seq_edge_checks() -> int:
    """chunk_map and compose_maps against their plain versions on
    SEQ_EDGE_* inputs → calls checked."""
    import numpy as np
    import torch
    from istio_tpu_torch.parallel import seq_match as sm
    rng = np.random.default_rng(1214)
    n = 0
    for i_s, s in enumerate(SEQ_EDGE_S):
        for i_k, kind in enumerate(SEQ_EDGE_KINDS):
            tr = torch.from_numpy(seq_edge_dfa(rng, s, kind)).cuda()
            for i_l, lc in enumerate(SEQ_EDGE_LC):
                i = i_s + i_k + i_l
                c, off, b = (1, 3)[i % 2], (0, 1, 7)[i % 3], (1, 33)[i % 2]
                width = c * lc + off + (i % 2) * 3   # odd strides too
                buf = torch.from_numpy(rng.integers(
                    0, 256, (b, width), dtype=np.uint8)).cuda()
                data = buf[:, off:off + c * lc].unflatten(1, (c, lc))
                c0 = i % 3
                start = c0 * lc
                lens = rng.integers(0, start + c * lc + 20, b)
                lens[:4] = (0, start + lc, start + c * lc,
                            start + lc // 2)[:b]
                lens = torch.from_numpy(lens.astype(np.int32)).cuda()
                assert_equal(f"chunk_map S={s} {kind} Lc={lc} C={c} "
                             f"off={off}", sm.chunk_maps(data, lens, tr, c0),
                             sm.chunk_maps_plain(data, lens, tr, c0))
                n += 1
            for cc in SEQ_EDGE_COMPOSE_C:
                bb = (1, 33, 2048)[(i_s + cc) % 3]
                maps = torch.from_numpy(rng.integers(
                    0, s, (cc, bb, s)).astype(np.int32)).cuda()
                acc = torch.from_numpy(rng.random(s) < 0.5).cuda()
                entry = int(rng.integers(0, s))
                assert_equal(f"compose_maps S={s} C={cc} B={bb}",
                             sm.compose(maps), sm.compose_maps_plain(maps))
                assert_equal(f"compose_maps accept S={s} C={cc} B={bb}",
                             sm.compose(maps, acc, entry),
                             sm.compose_maps_plain(maps, acc, entry))
                n += 2
    torch.cuda.synchronize()
    return n


def seq_phase(int_rate: float) -> dict:
    """Phase 12: sequence-parallel DFA matching (B13) on N_VIRTUAL
    virtual devices of card 0 (each its own stream), the launch counters
    zeroed just before the drive and read just after. At each layout of
    SEQ_LAYOUTS and each pattern (tests/test_parallel.py's three over
    make_long_subjects' rows, the full-match regexes of
    make_route_world(10_000) over route-shaped paths):
    sharded_dfa_match equal to dfa_scan (K2) over the unchunked rows
    and to Python `re` on SEQ_RE_ROWS rows, with exactly N chunk_map and
    N (or 1 with one chunk per device) + 1 compose_maps launches per
    match; every captured K12 launch equal to its plain version, and K12
    on SEQ_EDGE_* inputs; the launches of one headline match (2048 rows x
    8 KiB, the needle) each timed alone on one stream (seq_times) with
    their bound and the table lookups chunk_map's function needs; the
    sharded match
    beside one dfa_scan over the same rows."""
    import re
    import numpy as np
    import torch
    from istio_tpu_torch import kernels, platform
    from istio_tpu_torch.ops import bytes_ops
    from istio_tpu_torch.ops.regex_dfa import compile_regex, pack_dfas_classes
    from istio_tpu_torch.parallel.mesh import Mesh
    from istio_tpu_torch.parallel import seq_match as sm
    from istio_tpu_torch.testing import workloads

    rx = route_regexes(ROUTE_RULES)
    pats = [(p, "long") for p in workloads.LONG_PATTERNS] + \
        [(p, "route") for p in rx]
    dfas = {p: compile_regex(p) for p, _ in pats}
    s_route = max(dfas[p].transitions.shape[0] for p in rx)
    log(f"[12] {len(pats)} patterns: {len(workloads.LONG_PATTERNS)} of "
        f"tests/test_parallel.py and the {len(rx)} full-match regexes of "
        f"make_route_world({ROUTE_RULES}); states S "
        + ", ".join(f"{p!r} {dfas[p].transitions.shape[0]}"
                    for p, _ in pats[:4])
        + f", route max {s_route} ({s_route} KB of table: shared memory)")
    rng = np.random.default_rng(1213)
    worlds = {}
    for b, c, lc in SEQ_LAYOUTS:
        total = c * lc
        if (b, total) not in worlds:
            worlds[(b, total)] = {
                "long": workloads.make_long_subjects(b, c, lc, seed=b),
                "route": route_subjects(b, total, seed=b + 1)}
    # the oracles first: dfa_scan (K2) over the unchunked rows and re
    oracle = {}
    for b, c, lc in SEQ_LAYOUTS:
        for p, kind in pats:
            key = (b, c * lc, p)
            if key in oracle:
                continue
            data, lens = worlds[(b, c * lc)][kind]
            bank = bytes_ops.DfaBank.of(pack_dfas_classes([dfas[p]]))
            scan = bytes_ops.dfa_scan(torch.from_numpy(data).cuda(),
                                      torch.from_numpy(lens).cuda(),
                                      bank)[:, 0].cpu()
            want = [re.search(p, data[i, :lens[i]].tobytes()
                              .decode("latin1")) is not None
                    for i in range(min(b, SEQ_RE_ROWS))]
            if scan[:len(want)].tolist() != want:
                raise AssertionError(f"dfa_scan {p!r} differs from re")
            oracle[key] = scan
    steps, caps, captured = 0, [], None
    with platform.force_virtual_devices(N_VIRTUAL, "cuda:0") as devs:
        mesh = Mesh(np.array(devs, dtype=object), ("sp",))
        kernels.launches.reset()
        for b, c, lc in SEQ_LAYOUTS:
            total = c * lc
            per = c // N_VIRTUAL
            hits = 0
            for p, kind in pats:
                data, lens = worlds[(b, total)][kind]
                dfa = dfas[p]
                e0 = dict(kernels.launches.entries)
                with kernels.launches.capture() as cap:
                    got = sm.sharded_dfa_match(
                        mesh, "sp", data.reshape(b, c, lc), lens,
                        dfa.transitions, dfa.accept)
                    torch.cuda.synchronize()
                steps += 1
                d_cm = kernels.launches.entries["chunk_map"] - e0["chunk_map"]
                d_co = kernels.launches.entries["compose_maps"] - \
                    e0["compose_maps"]
                want_co = (N_VIRTUAL if per > 1 else 0) + 1
                if (d_cm, d_co) != (N_VIRTUAL, want_co):
                    raise AssertionError(
                        f"{p!r} {b}x{c}x{lc}: {d_cm} chunk_map / {d_co} "
                        f"compose_maps launches, want {N_VIRTUAL} / "
                        f"{want_co}")
                if (b, c, lc) == SEQ_LAYOUTS[0] and p == pats[0][0]:
                    captured = list(cap)
                caps.append((p, list(cap)))
                assert_equal(f"sharded {p!r} vs dfa_scan {b}x{total}",
                             got.cpu(), oracle[(b, total, p)])
                hits += int(got.sum())
            log(f"[12] B={b} x {total:,} bytes as {c} chunks of {lc} "
                f"({per} per device): {len(pats)} patterns sharded equal to "
                f"dfa_scan (K2) over the unchunked rows and to re on "
                f"{SEQ_RE_ROWS} rows; {hits} matches")
        out = path_counts("[12] sequence-parallel path", ("seq_match",),
                          steps)
        out["entries"] = {e: kernels.launches.entries[e]
                          for e in kernels.ENTRY_POINTS["seq_match"]}
        n = 0
        for p, cap in caps:
            for _, (kind, *args) in cap:
                kern, plain = seq_fns(kind)
                assert_equal(f"seq_match.{kind} {p!r}", kern(*args),
                             plain(*args))
                n += 1
        log(f"[12] K12 equal to its plain version on all {n} launches of "
            "the drive")
        log(f"[12] K12 equal to its plain version on {seq_edge_checks()} "
            f"edge calls (S {SEQ_EDGE_S}, Lc {SEQ_EDGE_LC}, odd addresses "
            f"and strides, {', '.join(SEQ_EDGE_KINDS)} DFAs; compose C "
            f"{SEQ_EDGE_COMPOSE_C})")
        # ---- K12 timed on the headline match's own launches, each one
        # alone on one stream (seq_times), with the lookups it needs
        b, c, lc = SEQ_LAYOUTS[0]
        p = pats[0][0]
        data, lens = worlds[(b, c * lc)]["long"]
        dfa = dfas[p]
        parts = seq_times(captured, int_rate)
        for kind, x in parts.items():
            walks = "" if "lookups" not in x else \
                (f": the table lookups the function needs; "
                 f"{x['lookups_all_walks']:.0f} if no walks met")
            log(f"  seq_match.{kind:<13} {x['launches_per_match']} launches: "
                f"kernel {x['ms']:9.5f} ms a match (CUDA graph, each launch "
                f"alone: {', '.join(f'{t:.5f}' for t in x['per_launch_ms'])})"
                f"   plain {x['plain_ms']:9.5f} ms   bound "
                f"{x['bound_ms']:8.5f}"
                f" ms ({x['bound_by']}; {x['bytes']:.0f} B, {x['ops']:.0f} "
                f"ops{walks})   equal: yes")
        flat = torch.from_numpy(data.reshape(b, c, lc)).cuda()
        ln = torch.from_numpy(lens).cuda()
        bank = bytes_ops.DfaBank.of(pack_dfas_classes([dfa]))
        whole = time_ms(lambda: sm.sharded_dfa_match(
            mesh, "sp", flat, ln, dfa.transitions, dfa.accept), SEQ_ITERS)
        one = time_ms(lambda: bytes_ops.dfa_scan(
            flat.reshape(b, c * lc), ln, bank), SEQ_ITERS)
        log(f"[12] headline match ({b} rows x {c * lc:,} bytes, {p!r}, S "
            f"{dfa.transitions.shape[0]}): sharded_dfa_match {whole:.5f} ms "
            f"per call on {N_VIRTUAL} streams (CUDA events, host launch "
            f"cost included) against one dfa_scan over the unchunked rows "
            f"{one:.5f} ms")
    bb = sum(x["bytes"] for x in parts.values())
    ops = sum(x["ops"] for x in parts.values())
    bms, by = bound(bb, ops, int_rate)
    row = {"name": "seq_match", "route": "cuda",
           "source": "istio_tpu_torch/csrc/seq_match.cu",
           "replaces": "istio_tpu/parallel/seq_match.py:34",
           "launches": 0, "max_abs_err": 0,
           "ms": sum(x["ms"] for x in parts.values()),
           "plain_ms": sum(x["plain_ms"] for x in parts.values()),
           "bound_ms": bms, "bound_by": by, "library_ms": None,
           "library_call": None,
           "calls_per_step": sum(x["launches_per_match"]
                                 for x in parts.values()),
           "grid_launches": 0, "ms_source": parts["chunk_map"]["ms_source"],
           "bytes": bb, "ops": ops, "entries": parts,
           "lookups": parts["chunk_map"]["lookups"],
           "lookups_all_walks": parts["chunk_map"]["lookups_all_walks"],
           "sharded_match_ms": whole, "dfa_scan_ms": one,
           "route_max_states": s_route}
    return {**out, "rows": [row]}


# ---------------------------------------------------------------------------
# phase 13: mesh serving (K13 mesh_fold, B14)
# ---------------------------------------------------------------------------

MESH_SHAPE = (4, 2)
MESH_ITERS = 10                # timed check_many calls per batch size
MESH_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "mesh_fold",
                "check_pack", "rule_stats")


def mesh_server(store, shape, buckets, manifest=None, device="cuda"):
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    kw = dict(buckets=buckets, rulestats_drain_s=0)
    if manifest is not None:
        kw["default_manifest"] = manifest
    if shape is not None:
        kw["mesh_shape"] = shape
    return RuntimeServer(store, ServerArgs(**kw), device=device)


def pull_of(srv, bags):
    """The plan's packed pull of `bags` (the served trip's one D2H)."""
    d = srv.controller.dispatcher
    return d.fused.packed_check(d.snapshot.tensorizer.tensorize(bags),
                                d._request_ns_ids(bags), observe=False)


def mesh_partial_checks(tag: str, parts, c, n_q: int) -> int:
    """Every shard's mesh_partial launch (its partial record, on its own
    stream) equal to verdict_fold_words_plain over the shard's window.
    → shards checked."""
    import torch
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.parallel import mesh_fold as mf
    for d, row in enumerate(parts):
        for m, p in enumerate(row):
            n_rules = int(p.params["pe_deny_dur"].shape[0])
            with p.vdev.scope():
                rec, flags, _ = mf.partial_record(p, n_rules, c, n_q)
            torch.cuda.synchronize()
            lk = p.list_kind if p.lstate is not None else None
            want_r, want_f = pe.verdict_fold_words_plain(
                p.matched, p.err, p.req_ns, p.batch, p.params, None, c,
                p.lstate, lk, window=(p.r0, p.r0 + int(p.matched.shape[1])))
            nf = want_f.shape[1]
            assert_equal(f"{tag} mesh_partial ({d}, {m}).rec", rec, want_r)
            assert_equal(f"{tag} mesh_partial ({d}, {m}).flags",
                         flags[:, :nf].contiguous(), want_f)
    return sum(len(row) for row in parts)


def combine_work(mp: int, bd: int, n_rbac: int, n_q: int,
                 n_attr: int) -> tuple[float, float]:
    """(bytes, ops) of one dp shard's mesh_combine: it reads the mp
    records (REC_ROWS int32 a row) and flag rows (NRB + Q bytes), the
    request namespaces, the RBAC rules and TTLs and each quota's hash id
    and presence, and writes status, dur, uses, deny_rule, the referenced
    row and the quota keys; per row an op per record field and flag byte,
    4 per RBAC decision and 3 per quota key."""
    from istio_tpu_torch.models.policy_engine import REC_ROWS
    nf = n_rbac + n_q
    moved = bd * (mp * (REC_ROWS * 4 + nf) + 4 + 16 + n_attr + n_q * 9) \
        + 8 * n_rbac
    ops = bd * (mp * (REC_ROWS + nf) + 4 * n_rbac + 3 * n_q)
    return float(moved), float(ops)


# mesh_combine edge records (phase 13): mp records 1 / 2 / 4 / 8, RBAC
# specs 0 / 1 / 33 (a warp's lanes and one more), quotas 0 / 3, row counts
# off the 4 rows a block takes, random records and records whose every
# int field is INT32_MAX (the duration field 3.4e38, the largest a partial
# writes: its INT32_MAX bits are a NaN no partial writes)
COMBINE_EDGE_MP = (1, 2, 4, 8)
COMBINE_EDGE_NRB = (0, 1, 33)
COMBINE_EDGE_Q = (0, 3)
COMBINE_EDGE_BD = (1, 7, 33, 1001)


def combine_edge_world(rng, mp: int, n_rbac: int, n_q: int, bd: int,
                       maxed: bool):
    """Synthetic mesh_combine inputs on the card → (rec, flags, req_ns,
    batch, params, quota_counts, consts)."""
    import numpy as np
    import torch
    from istio_tpu_torch.compiler.layout import AttributeBatch
    from istio_tpu_torch.models import policy_engine as pe
    i32 = np.int32
    imax = pe.INT32_MAX
    n_rules, n_cols, n_attr, n_b, t_rows = 64, 6, 5, 16, 4

    def t(x, dt=torch.int32):
        return torch.as_tensor(np.asarray(x)).to(dt).cuda()

    def maybe(lo, hi, p_max):
        v = rng.integers(lo, hi, bd)
        return np.where(rng.random(bd) < p_max, imax, v)

    rec = np.empty((mp, pe.REC_ROWS, bd), i32)
    for m in range(mp):
        if maxed:
            rec[m] = imax
            rec[m, pe.REC_DUR] = np.full(bd, 3.4e38, np.float32).view(i32)
            continue
        rec[m, pe.REC_DENY] = maybe(0, n_rules, 0.6)
        rec[m, pe.REC_DUR] = rng.choice(np.array(
            [0.5, 1.0, 5.0, 3.4e38], np.float32), bd).view(i32)
        rec[m, pe.REC_USES] = maybe(0, 20000, 0.5)
        rec[m, pe.REC_ERR] = rng.integers(0, 4, bd)
        rec[m, pe.REC_LRULE] = maybe(0, n_rules, 0.6)
        rec[m, pe.REC_LARG] = rng.integers(0, 3, bd)
        rec[m, pe.REC_LSTATUS] = rng.choice([5, 7, 13], bd)
    nf = n_rbac + n_q
    flags = rng.integers(0, 8, (mp, bd, nf)).astype(np.uint8)
    flags[:, :, n_rbac:] &= 1
    params = {
        "pe_deny_status": t(rng.choice([7, 13, 16], n_rules)),
        "pe_rb_rule": t(rng.integers(0, n_rules, n_rbac)),
        "pe_rb_dur": t(rng.choice([2.0, 30.0], n_rbac), torch.float32),
        "pe_q_slot": t(rng.integers(0, n_cols, n_q)),
        "pe_q_nb": t(rng.choice([1, 7, n_b], n_q)),
        "pe_q_max": t(rng.integers(1, 4, n_q)),
        "pe_q_rule": t(rng.integers(0, n_rules, n_q)),
        "pe_ref_table": t(rng.random((t_rows, n_attr + 2)) < 0.5,
                          torch.bool)}
    batch = AttributeBatch(
        ids=t(rng.integers(-3, 50, (bd, n_cols))),
        present=t(rng.random((bd, n_cols)) < 0.8, torch.bool),
        map_present=t(np.zeros((bd, 0), bool), torch.bool),
        str_bytes=t(np.zeros((bd, 0, 1), np.uint8), torch.uint8),
        str_lens=t(np.zeros((bd, 0), i32)),
        hash_ids=t(rng.integers(-2 ** 31, 2 ** 31 - 1, (bd, n_cols))))
    counts = t(rng.integers(0, 3, (max(n_q, 1), n_b)))
    consts = pe.FoldConsts(default_ns=0, has_lists=False,
                           has_quota=n_q > 0, n_attr_cols=n_attr,
                           has_rbac=n_rbac > 0)
    req = t(rng.integers(-2, t_rows + 1, bd))
    return (t(rec), t(flags, torch.uint8), req, batch, params, counts,
            consts)


def combine_edge_checks() -> int:
    """mesh_combine (with mesh_quota where Q > 0) against
    combine_fold_records on COMBINE_EDGE_* records → calls checked."""
    import numpy as np
    import torch
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.parallel import mesh_fold as mf
    rng = np.random.default_rng(1314)
    n = 0
    for i, (mp, n_rbac, n_q) in enumerate(
            (a, r, q) for a in COMBINE_EDGE_MP for r in COMBINE_EDGE_NRB
            for q in COMBINE_EDGE_Q):
        for maxed in (False, True):
            bd = COMBINE_EDGE_BD[(i + maxed) % len(COMBINE_EDGE_BD)]
            rec, flags, req, batch, params, counts, c = combine_edge_world(
                rng, mp, n_rbac, n_q, bd, maxed)
            qk, qp = counts.clone(), counts.clone()
            got = mf.combine_records(rec, flags, req, batch, params, qk, c)
            want = pe.combine_fold_records(list(rec), list(flags), req,
                                           batch, params, qp, c)
            tag = (f"mesh_combine MP={mp} NRB={n_rbac} Q={n_q} Bd={bd}"
                   + (" INT32_MAX" if maxed else ""))
            for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                                   "referenced", "err_count"), got, want):
                assert_equal(f"{tag}.{part}", g, w)
            assert_equal(f"{tag}.quota_counts", qk, qp)
            n += 1
    torch.cuda.synchronize()
    return n


# mesh_quota on synthetic key columns (phase 13b): every path of the quota
# plan — one block (B <= 2,048), a cluster (2,049 to 65,536 rows) and the
# three launches past it — at Q = 1 and 34, key columns with one hot key,
# a few keys, many keys and none, counters at q_max - 1 and q_max, a dp
# replica's rows, three batches carried; and composite keys near
# INT32_MAX over a counter plane of 2 x (2^30 - 1) cells
MESH_QUOTA_B = (0, 1, 31, 33, 2048, 2049, 8192, 65536, 65537)
MESH_QUOTA_Q = (1, 34)


def mesh_quota_columns(rng, n_q: int, b: int, kind: str, nb: int = 64):
    """Synthetic mesh_quota inputs on the card → (keys int32 [Q, B] with
    -1 inactive, counts [Q, nb], q_max, q_rule)."""
    import numpy as np
    import torch
    if kind == "hot":
        bucket = np.where(rng.random((n_q, b)) < 0.9,
                          rng.integers(0, nb, (n_q, 1)), -1)
    elif kind == "few":
        bucket = np.where(rng.random((n_q, b)) < 0.5,
                          rng.integers(0, 3, (n_q, b)), -1)
    elif kind == "many":
        bucket = np.where(rng.random((n_q, b)) < 0.6,
                          rng.integers(0, nb, (n_q, b)), -1)
    else:
        bucket = np.full((n_q, b), -1)
    keys = np.where(bucket >= 0, bucket + np.arange(n_q)[:, None] * nb, -1)
    q_max = rng.integers(1, max(b // 4, 2) + 3, n_q)
    counts = rng.integers(0, 4, (n_q, nb))
    near = rng.random((n_q, nb))
    counts = np.where(near < 0.2, q_max[:, None] - 1, counts)
    counts = np.where((near >= 0.2) & (near < 0.3), q_max[:, None], counts)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x).astype(np.int32)) \
            .cuda()
    return (t(keys), t(counts), t(q_max), t(rng.integers(0, 50, n_q)))


def mesh_quota_edge_checks() -> int:
    """Phase 13b: mesh_quota against quota_rank_plain (the reference's
    sort) on MESH_QUOTA_B x MESH_QUOTA_Q synthetic key columns (and
    quota_grant_plain, the kernel's formulation, where B <= 2,048), a dp
    replica's rows from row0 = B / 4, three batches with the counters
    carried; `__global__` grids per call as the quota plan says (1 up to
    65,536 rows, 3 past); then keys near INT32_MAX → cases."""
    import numpy as np
    import torch
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.parallel import mesh_fold as mf
    rng = np.random.default_rng(1315)
    n = 0
    kinds = ("hot", "few", "many", "none")
    for b in MESH_QUOTA_B:
        for n_q in MESH_QUOTA_Q:
            kind = kinds[n % len(kinds)]
            plan = pe.quota_plan(b)
            _, counts, q_max, q_rule = mesh_quota_columns(rng, n_q, b, kind)
            ck, cp, cg = counts.clone(), counts.clone(), counts.clone()
            row0 = b // 4
            for step in range(N_STEPS):
                keys = mesh_quota_columns(rng, n_q, b, kind)[0]
                outs = []
                for c in (ck, cp, cg):
                    outs.append((torch.zeros(b - row0, dtype=torch.int32,
                                             device="cuda"),
                                 torch.full((b - row0,), pe.INT32_MAX,
                                            dtype=torch.int32,
                                            device="cuda")))
                grids = mf.mesh_quota(keys, q_max, q_rule, ck, row0,
                                      *outs[0])
                pe.quota_rank_plain(keys, cp, q_max, q_rule, *outs[1],
                                    row0)
                tag = f"mesh_quota B={b} Q={n_q} {kind} step {step}"
                want = plan.launches if b else 0
                if grids != want:
                    raise AssertionError(f"{tag}: {grids} grids, want "
                                         f"{want}")
                assert_equal(f"{tag}.counts", ck, cp)
                for part, g, w in zip(("status", "deny_rule"), outs[0],
                                      outs[1]):
                    assert_equal(f"{tag}.{part}", g, w)
                if b <= 2048:
                    pe.quota_grant_plain(keys, cg, q_max, q_rule, *outs[2],
                                         row0)
                    assert_equal(f"{tag}.counts (grant plain)", ck, cg)
                    for part, g, w in zip(("status", "deny_rule"), outs[0],
                                          outs[2]):
                        assert_equal(f"{tag}.{part} (grant plain)", g, w)
                else:
                    cg.copy_(ck)
                n += 1
    # composite keys near INT32_MAX: 2 quotas x (2^30 - 1) buckets
    nb = 2 ** 30 - 1
    big = torch.zeros((2, nb), dtype=torch.int32, device="cuda")
    for b in (257, 2048):
        top = nb - 1 - rng.integers(0, 6, (2, b))
        keys = torch.from_numpy(np.where(
            rng.random((2, b)) < 0.8, top + np.arange(2)[:, None] * nb,
            -1).astype(np.int32)).cuda()
        q_max = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
        q_rule = torch.tensor([7, 1], dtype=torch.int32, device="cuda")
        live = torch.unique(keys[keys >= 0]).long()
        big.view(-1)[live] = torch.randint(0, 4, (live.numel(),),
                                           dtype=torch.int32, device="cuda")
        before = big.view(-1)[live].clone()
        outs = [(torch.zeros(b, dtype=torch.int32, device="cuda"),
                 torch.full((b,), pe.INT32_MAX, dtype=torch.int32,
                            device="cuda")) for _ in range(2)]
        mf.mesh_quota(keys, q_max, q_rule, big, 0, *outs[0])
        got = big.view(-1)[live].clone()
        big.view(-1)[live] = before
        pe.quota_rank_plain(keys, big, q_max, q_rule, *outs[1])
        tag = f"mesh_quota B={b} keys near INT32_MAX"
        assert_equal(f"{tag}.counts", got, big.view(-1)[live])
        for part, g, w in zip(("status", "deny_rule"), *outs):
            assert_equal(f"{tag}.{part}", g, w)
        n += 1
    del big
    torch.cuda.synchronize()
    return n


def mesh_fold_check(tag: str, inputs, int_rate: float | None) -> dict:
    """K13 against its plain version on one captured launch's inputs
    (from its quota state), and with int_rate timed with its bound."""
    import torch
    from istio_tpu_torch.compiler.layout import AttributeBatch
    from istio_tpu_torch.parallel import mesh_fold as mf
    parts, params, before, c, lk, dev = inputs
    q0 = before if before is not None else torch.zeros(1, 1, dtype=torch.int32,
                                                       device=dev)
    mesh_partial_checks(tag, parts, c, int(q0.shape[0]) if c.has_quota
                        else 0)
    qk, qp = q0.clone(), q0.clone()
    got = mf.mesh_fold(parts, params, qk, c, lk, dev)
    want = mf.mesh_fold_plain(parts, params, qp, c, lk, dev)
    for part, g, w in zip(("status", "dur", "uses", "deny_rule",
                           "referenced", "err_count"), got, want):
        assert_equal(f"{tag}.{part}", g, w)
    assert_equal(f"{tag}.quota_counts", qk, qp)
    if int_rate is None:
        return {}
    scratch = q0.clone()
    ms, call, how = timed(lambda: mf.mesh_fold(parts, params, scratch, c, lk,
                                               dev), 50)
    plain, _, _ = timed(lambda: mf.mesh_fold_plain(parts, params, scratch, c,
                                                   lk, dev), 10)
    matched = mf.gather_plane(parts, "matched", dev)
    req = torch.cat([row[0].req_ns for row in parts])
    batch = AttributeBatch.cat([row[0].batch for row in parts], dev)
    lstate = mf.gather_lstate(parts, dev)
    b, ops = fold_work(matched, req, batch, params, c, q0, qk, got, lstate,
                       lk if lstate is not None else None)
    # the partial records cross shards: written once, read once
    dp, mp = len(parts), len(parts[0])
    n_flags = int(parts[0][0].params["pe_rb_rule"].numel()) * c.has_rbac
    b += 2.0 * matched.shape[0] * mp * (mf.REC_ROWS * 4 + n_flags)
    bms, by = bound(b, ops, int_rate)
    log(f"  {tag:<16} {ms_label(how)} {ms:9.5f} ms (per call incl. launch "
        f"{call:8.5f})   plain {plain:9.5f} ms   bound {bms:8.5f} ms ({by}; "
        f"{b:.0f} B, {ops:.0f} ops)   equal: yes   [{how}]")
    return {"ms": ms, "call_ms": call, "ms_source": how, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "bytes": b, "ops": ops,
            "mesh": f"{dp}x{mp}",
            "entries": mesh_entry_times(tag, inputs, int_rate, (b, ops))}


def mesh_entry_times(tag: str, inputs, int_rate: float,
                     call_work: tuple[float, float] | None = None) -> dict:
    """Each entry point of one captured mesh_fold call, device ms per
    launch from the profiler's records of that `__global__` function
    (kernel_ms: windows that saw every launch), beside its launches per
    call; mesh_combine also with its bound (combine_work) and the
    torch.amin over dp shard 0's stacked records (the min only); given
    the whole call's (bytes, ops), also mesh_partial's bound a launch
    (the call's work less the combines' and the quota launches') and
    mesh_quota's (quota_grant_work: the keys and the counters they read,
    once a replica)."""
    import torch
    from istio_tpu_torch.models import policy_engine as pe
    from istio_tpu_torch.parallel import mesh_fold as mf
    parts, params, before, c, lk, dev = inputs
    dp, mp = len(parts), len(parts[0])
    n_q = int(before.shape[0]) if c.has_quota else 0
    n_rbac = int(parts[0][0].params["pe_rb_rule"].numel()) * c.has_rbac
    n_rules = int(params["pe_deny_dur"].shape[0])
    scratch = before.clone() if before is not None else \
        torch.zeros(1, 1, dtype=torch.int32, device=dev)
    out = {}
    for ent, kname, per in (("mesh_partial", "partial_kernel", dp * mp),
                            ("mesh_combine", "combine_kernel", dp),
                            ("mesh_quota", "quota_grant",
                             dp * (n_q > 0) * pe.quota_plan(
                                 dp * int(parts[0][0].matched.shape[0]))
                             .launches)):
        if not per:
            continue
        ms, kept = kernel_ms(lambda: mf.mesh_fold(parts, params, scratch, c,
                                                  lk, dev), kname, per)
        out[ent] = {"ms": ms, "launches_per_call": per, "windows": kept,
                    "ms_source": "profiler (every launch seen)",
                    "cold_ms": cold_kernel_ms(lambda: mf.mesh_fold(
                        parts, params, scratch, c, lk, dev), kname, per)}
    bd = int(parts[0][0].matched.shape[0])
    rec = torch.stack([mf.partial_record(p, n_rules, c, n_q)[0]
                       for p in parts[0]])
    torch.cuda.synchronize()
    moved, ops = combine_work(mp, bd, n_rbac, n_q, c.n_attr_cols)
    comb = out["mesh_combine"]
    comb["bound_ms"], comb["bound_by"] = bound(moved, ops, int_rate)
    comb["bytes"], comb["ops"] = moved, ops
    comb["library_ms"] = time_ms(lambda: torch.amin(rec, dim=0), 200)
    comb["library_call"] = "torch.amin of the stacked [MP, 7, Bd] records"
    if call_work is not None:
        # mesh_partial's share of the call's work: the whole call's less
        # the combines' and the quota launches' (quota_grant_work over the
        # gathered keys, once a replica), a launch's of it
        part_b = call_work[0] - dp * moved
        part_o = call_work[1] - dp * ops
        if n_q:
            keys = quota_keys(mf.gather_plane(parts, "matched", dev),
                              torch.cat([r[0].req_ns for r in parts]),
                              type(parts[0][0].batch).cat(
                                  [r[0].batch for r in parts], dev),
                              params, c, int(before.shape[1]),
                              mf.gather_lstate(parts, dev), lk)
            qb, qo = quota_grant_work(keys, before, before, 0)
            part_b -= dp * qb
            part_o -= dp * qo
            out["mesh_quota"]["bound_ms"], out["mesh_quota"]["bound_by"] = \
                bound(qb, qo, int_rate)
        part = out["mesh_partial"]
        part["bound_ms"], part["bound_by"] = bound(
            max(part_b, 0.0) / (dp * mp), max(part_o, 0.0) / (dp * mp),
            int_rate)
    log(f"  {tag:<16} per launch: " + ", ".join(
        f"{e} {x['ms']:.5f} ms x {x['launches_per_call']} (cold windows "
        f"{fmt_ms(x['cold_ms'])})" for e, x in out.items())
        + f"; mesh_combine bound {comb['bound_ms']:.6f} ms "
        f"({comb['bound_by']}), torch.amin {comb['library_ms']:.5f} ms"
        + "".join(f"; {e} bound {x['bound_ms']:.7f} ms ({x['bound_by']})"
                  for e, x in out.items()
                  if e != "mesh_combine" and "bound_ms" in x))
    return out


def mesh_phase(int_rate: float) -> dict:
    """Phase 13: mesh serving (B14) on N_VIRTUAL virtual devices of card
    0. The headline world, make_store(10_000) under MESH_MANIFEST, served
    by ServerArgs(mesh_shape=(4, 2), buckets=(64, 256, 2048)) against a
    mesh-less RuntimeServer on the card: at B ∈ E2E_BATCHES of the
    headline and the hit traffic every response field, the packed pull
    byte for byte and the drained rule counts equal; the launch counters
    zeroed just before the mesh server's drive and read just after (per
    step: rule_match, dfa_scan and byte_pred once per shard, mesh_fold
    once, verdict_fold never); walls beside the mesh-less server's;
    mesh_stage_probe at B=2048; one device-to-host copy per trip; K13
    against its plain version on the B=2048 trip's inputs (timed: the
    kernels row). Then (13b) the authz
    world make_rbac_store(1000) at (2, 4), whose RBAC allow rows span
    two mp slices; the headline world at (8, 1) and (1, 1) at B=256; and
    shard_engine_check on make_engine(10_000, with_quota=True, quota
    max 2) at (4, 2), three batches with the counters carried, equal to
    the unsharded engine, verdict and counters, some rows exhausted."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels, platform
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.parallel.mesh import (MeshSpec, mesh_stage_probe,
                                               rule_slices,
                                               shard_engine_check)
    from istio_tpu_torch.testing import workloads

    man = workloads.MESH_MANIFEST
    with platform.force_virtual_devices(N_VIRTUAL, "cuda:0"):
        t0 = time.perf_counter()
        msrv = mesh_server(workloads.make_store(HEADLINE_RULES), MESH_SHAPE,
                           E2E_BATCHES, man)
        build_s = time.perf_counter() - t0
        psrv = mesh_server(workloads.make_store(HEADLINE_RULES), None,
                           E2E_BATCHES, man)
        plan = msrv.controller.dispatcher.fused
        if getattr(plan.engine._step, "mesh", None) is None:
            raise AssertionError("the mesh server's engine is not sharded")
        n_rows = int(plan.engine.ruleset.rule_ns.shape[0])
        log(f"[13] headline world on a {MESH_SHAPE[0]}x{MESH_SHAPE[1]} mesh "
            f"of virtual devices: snapshot + plan + warm of "
            f"{len(plan._warmed_shapes)} shapes in {build_s:.2f} s; "
            f"{n_rows} rule rows in slices "
            f"{rule_slices(n_rows, MESH_SHAPE[1])}")
        traffic = {(t, b): served_traffic(t, HEADLINE_RULES, b, seed=b + 3)
                   for t in ("headline", "hit") for b in E2E_BATCHES}
        want, want_pull, want_counts = {}, {}, {}
        for key, bags in traffic.items():
            before = rule_counts(psrv)
            want[key] = psrv.check_many(bags)
            want_counts[key] = counts_since(psrv, before)
            want_pull[key] = pull_of(psrv, bags)
        kernels.launches.reset()
        steps, got, got_pull, got_counts = 0, {}, {}, {}
        for key, bags in traffic.items():
            before = rule_counts(msrv)
            if key == ("headline", HEADLINE_B):
                with kernels.launches.capture() as captured:
                    got[key] = msrv.check_many(bags)
                torch.cuda.synchronize()
            else:
                got[key] = msrv.check_many(bags)
            got_counts[key] = counts_since(msrv, before)
            got_pull[key] = pull_of(msrv, bags)
            steps += 2
        results = {}
        for b in E2E_BATCHES:
            bags = traffic[("headline", b)]
            walls = []
            for _ in range(MESH_ITERS):
                t = time.perf_counter()
                msrv.check_many(bags)
                walls.append((time.perf_counter() - t) * 1e3)
            steps += MESH_ITERS
            results[b] = {"p50_ms": float(np.percentile(walls, 50)),
                          "p99_ms": float(np.percentile(walls, 99))}
        counts = path_counts("[13] mesh path", MESH_KERNELS, steps)
        per = counts["per_step"]
        shards = MESH_SHAPE[0] * MESH_SHAPE[1]
        if counts["counts"]["verdict_fold"] or per["mesh_fold"] != 1 or \
                per["rule_match"] != shards:
            raise AssertionError(f"mesh path launches per step {per}")
        for key in traffic:
            compare_responses(f"mesh {key}", got[key], want[key])
            compare_counts(f"mesh {key}", got_counts[key], want_counts[key])
            if got_pull[key].tobytes() != want_pull[key].tobytes():
                raise AssertionError(f"mesh {key}: packed pull differs")
        for b in E2E_BATCHES:
            bags = traffic[("headline", b)]
            walls = []
            for _ in range(MESH_ITERS):
                t = time.perf_counter()
                psrv.check_many(bags)
                walls.append((time.perf_counter() - t) * 1e3)
            results[b]["plain_p50_ms"] = float(np.percentile(walls, 50))
        log(f"[13] mesh {MESH_SHAPE}: B in {E2E_BATCHES}, headline and hit "
            "traffic: every response field, the packed pull byte for byte "
            "and the rule counts equal to the mesh-less server on the "
            "card; per step rule_match / dfa_scan / byte_pred "
            f"{per['rule_match']:.0f} / {per['dfa_scan']:.0f} / "
            f"{per['byte_pred']:.0f}, mesh_fold {per['mesh_fold']:.0f} "
            f"({counts['grids']['mesh_fold'] / counts['counts']['mesh_fold']:.0f}"
            " grids), verdict_fold 0; walls " + ", ".join(
                f"B={b} p50 {r['p50_ms']:.2f} ms (mesh-less "
                f"{r['plain_p50_ms']:.2f})" for b, r in results.items()))
        eng = plan.engine
        big = traffic[("headline", HEADLINE_B)]
        d = msrv.controller.dispatcher
        batch = d.snapshot.tensorizer.tensorize(big)
        probe = mesh_stage_probe(plan.engine._step.mesh, eng, batch,
                                 np.asarray(d._request_ns_ids(big),
                                            np.int32))
        log(f"[13] mesh_stage_probe B={HEADLINE_B}: {json.dumps(probe)}")
        n_d2h = dtoh_copies(lambda: pull_of(msrv, big))
        if n_d2h not in (1, None):
            raise AssertionError(f"a mesh trip made {n_d2h} device-to-host "
                                 "copies, want one pull")
        log(f"[13] a B={HEADLINE_B} mesh trip: {n_d2h} device-to-host copy")
        shard_k1 = [x for x in captured if x[0] == "rule_match"]
        if not shard_k1 or len(shard_k1) % shards:
            raise AssertionError(f"{len(shard_k1)} rule_match launches in "
                                 f"served trips of {shards} shards")
        check_kernels(shard_k1, None)
        log(f"[13] the B={HEADLINE_B} trip's {len(shard_k1)} shard "
            "rule_match launches (matched and err only) equal to their "
            "plain versions")
        folds = [x for x in captured if x[0] == "mesh_fold"]
        if len(folds) != 1:
            raise AssertionError(f"{len(folds)} mesh_fold launches in one "
                                 "served trip")
        log(f"[13] K13 on the B={HEADLINE_B} served trip's own inputs "
            "(timed):")
        k13 = mesh_fold_check("mesh_fold", folds[0][1], int_rate)
        for s in (msrv, psrv):
            s.close()

        # ---- 13b: the authz world at (2, 4)
        az_store = workloads.make_rbac_store(AUTHZ_ROLE_RULES)
        az = mesh_server(az_store, (2, 4), (256, HEADLINE_B), man)
        az_plain = mesh_server(workloads.make_rbac_store(AUTHZ_ROLE_RULES),
                               None, (256, HEADLINE_B), man)
        aeng = az.controller.dispatcher.fused.engine
        n_rows = int(aeng.ruleset.rule_ns.shape[0])
        sl = rule_slices(n_rows, 4)
        allow = aeng.params["pe_rb_allow"].cpu().numpy()
        spans = [{m for m, (r0, r1) in enumerate(sl)
                  if ((row >= r0) & (row < r1)).any()} for row in allow]
        if max(len(s) for s in spans) < 2:
            raise AssertionError(f"authz: no RBAC spec spans two mp slices "
                                 f"({spans})")
        for b in (256, HEADLINE_B):
            bags = [bag_from_mapping(x) for x in
                    workloads.make_rbac_request_dicts(b, seed=b)]
            compare_responses(f"authz mesh (2, 4) B={b}", az.check_many(bags),
                              az_plain.check_many(bags))
            if pull_of(az, bags).tobytes() != \
                    pull_of(az_plain, bags).tobytes():
                raise AssertionError(f"authz mesh B={b}: pull differs")
        with kernels.launches.capture() as cap:
            az.check_many(bags)
        torch.cuda.synchronize()
        k13_az = mesh_fold_check(
            "mesh_fold.authz", [x for x in cap if x[0] == "mesh_fold"][0][1],
            int_rate)
        log(f"[13b] authz world (2, 4): {n_rows} rule rows in slices {sl}; "
            f"RBAC allow rows span mp slices {sorted(spans[0])}; responses "
            f"and pulls equal to the mesh-less server at B = 256, {HEADLINE_B}")
        for s in (az, az_plain):
            s.close()

        # ---- 13b: the headline world at (8, 1) and (1, 1)
        bags = traffic[("hit", 256)]
        for shape in ((8, 1), (1, 1)):
            s = mesh_server(workloads.make_store(HEADLINE_RULES), shape,
                            (256,), man)
            compare_responses(f"mesh {shape} B=256", s.check_many(bags),
                              want[("hit", 256)])
            if pull_of(s, bags).tobytes() != \
                    want_pull[("hit", 256)].tobytes():
                raise AssertionError(f"mesh {shape}: pull differs")
            s.close()
        log("[13b] headline world at (8, 1) and (1, 1), B=256 hit traffic: "
            "responses and pulls equal to the mesh-less server")

        # ---- 13b: shard_engine_check with quotas, counts carried
        a = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                  device="cuda", quota_max=2)
        m = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                  device="cuda", quota_max=2)
        step = shard_engine_check(MeshSpec(*MESH_SHAPE).build(), m)
        exhausted = 0
        for s in range(N_STEPS):
            bags, req = hit_batch(a, HEADLINE_RULES, 256, seed=7000 + s)
            batch = a.tensorizer.tensorize(bags)
            va, _ = a.raw_step(a.params, batch, req, a.quota_counts)
            g0 = kernels.launches.grids["mesh_fold"]
            with kernels.launches.capture() as cap:
                vm, _ = step(m.params, batch, req, m.quota_counts)
            torch.cuda.synchronize()
            dp, mp = MESH_SHAPE
            grids = kernels.launches.grids["mesh_fold"] - g0
            if grids != dp * mp + 2 * dp:
                raise AssertionError(
                    f"quota mesh step: {grids} grids, want {dp * mp} "
                    f"partial + {dp} combine + {dp} mesh_quota (one a "
                    "replica)")
            for f in FIELDS:
                assert_equal(f"shard_engine_check step {s} {f}",
                             getattr(vm, f), getattr(va, f))
            assert_equal(f"shard_engine_check step {s} quota_counts",
                         m.quota_counts, a.quota_counts)
            exhausted += int((vm.status == RESOURCE_EXHAUSTED).sum())
            mesh_fold_check(f"mesh_fold.quota#{s}",
                            [x for x in cap if x[0] == "mesh_fold"][0][1],
                            None)
        if not exhausted:
            raise AssertionError("sharded quota never ran out")
        log(f"[13b] shard_engine_check on make_engine({HEADLINE_RULES}, "
            f"with_quota=True) at {MESH_SHAPE}: {N_STEPS} batches of 256 "
            f"with the counters carried equal to the unsharded engine "
            f"(every verdict field, the counters); {exhausted} "
            "RESOURCE_EXHAUSTED; K13 (with its quota launches, one "
            "mesh_quota grid a dp replica) equal to its plain version on "
            "each")
        t0 = time.perf_counter()
        log(f"[13b] mesh_quota equal to quota_rank_plain on "
            f"{mesh_quota_edge_checks()} key-column cases (B = "
            f"{', '.join(map(str, MESH_QUOTA_B))}: one block, a cluster, "
            f"three launches past 65,536; Q = {MESH_QUOTA_Q}; hot / few / "
            "many / no keys, counters at q_max - 1 and q_max, a replica's "
            f"rows, {N_STEPS} batches carried; keys near INT32_MAX), and to "
            "quota_grant_plain up to 2,048 rows; grids per call as the "
            "quota plan says")
        log(f"[t] 13b mesh_quota edge cases took "
            f"{time.perf_counter() - t0:.1f} s")
        log(f"[13b] mesh_combine (and mesh_quota) equal to "
            f"combine_fold_records on {combine_edge_checks()} edge record "
            f"sets (MP {COMBINE_EDGE_MP}, NRB {COMBINE_EDGE_NRB}, Q "
            f"{COMBINE_EDGE_Q}, Bd {COMBINE_EDGE_BD}, every int field "
            "INT32_MAX)")
    row = {"name": "mesh_fold", "route": "cuda",
           "source": "istio_tpu_torch/csrc/verdict_fold.cu",
           "replaces": "istio_tpu/parallel/mesh.py:146", "launches": 0,
           "max_abs_err": 0, "library_ms": None, "library_call": None,
           "calls_per_step": 1, **k13, "authz": k13_az}
    return {**counts, "rows": [row], "results": results, "probe": probe}


# ---- phase 14: the Check() resilience plane

RESILIENCE_B = 256           # each batch: 128 headline + 128 hit requests
RESILIENCE_WALL_B = (64, 256)
# the card server of phase 14: the breaker of the issue's schedule, and
# a check batcher small enough (16 rows a trip, one trip in flight, a
# queue of 16) that concurrent callers fill its queue past the brownout
# threshold
RESILIENCE_ARGS = dict(breaker_failures=2, breaker_reset_s=0.2,
                       buckets=(16, 64, 256), max_batch=16, pipeline=1,
                       check_queue_cap=16, brownout=True,
                       continuous_batching=True)
BROWNOUT_CALLERS = 64        # closed-loop check() callers in (g)
BROWNOUT_CALLS = 4           # calls each
CONTINUOUS_CALLERS = 6       # (h): under half the queue cap, so no shed
BREAKER_STATES = ("closed", "half_open", "open")


def resilience_reading() -> dict:
    """The process-wide resilience counters (monitor), the executor
    plane's host-action counters and CHAOS seams."""
    from istio_tpu_torch.runtime import monitor
    from istio_tpu_torch.runtime.resilience import CHAOS
    c = monitor.resilience_counters()
    snap = CHAOS.snapshot()
    return {"retries": c["device_retries_total"],
            "fallback": dict(c["fallback"]),
            "shed": dict(c["shed"]),
            "transitions": {s: int(monitor.BREAKER_TRANSITIONS.value(s))
                            for s in BREAKER_STATES},
            "injected": {"device": snap["injected_device"],
                         "oracle": snap["injected_oracle"],
                         "adapter": snap["injected_adapter"]},
            "host": monitor.host_action_counters(),
            "canary_errors": canary_errors(),
            "armed": CHAOS.armed()}


_GATE: dict = {}
# every executor lane the run built (track_lanes): the gate reads their
# breakers
_LANES: list = []


def track_lanes() -> None:
    """Record every HandlerLane the port builds from now on."""
    from istio_tpu_torch.runtime import executor
    init = executor.HandlerLane.__init__
    if getattr(init, "_tracked", False):
        return

    def tracked(self, *a, **kw):
        init(self, *a, **kw)
        _LANES.append(self)

    tracked._tracked = True
    executor.HandlerLane.__init__ = tracked


def resilience_gate(label: str) -> None:
    """The end of every phase but 14 and 14b: no retry, no fallback and
    no breaker transition since the last gate (so every breaker stayed
    closed), and every CHAOS lever inert; on the host plane no outcome
    other than ok and no injected adapter failure since the last gate,
    the conservation ledger exact and every lane breaker closed; or the
    run fails naming the phase; and no canary evaluation that failed open
    (mixer_canary_errors_total). A card server raises a device fault
    that CHAOS did not inject; this gate also catches any degraded
    answer that would have slipped past that, and a host adapter that
    failed for real on the card's host."""
    now = resilience_reading()
    base = _GATE.get("base", now)
    moved = {k: (base[k], now[k]) for k in ("retries", "fallback",
                                            "transitions", "injected",
                                            "canary_errors")
             if now[k] != base[k]}
    host, host0 = now["host"], base["host"]
    not_ok = {o: n - host0["outcomes"][o]
              for o, n in host["outcomes"].items()
              if o != "ok" and n != host0["outcomes"][o]}
    if host["late"]["error"] != host0["late"]["error"]:
        not_ok["late_error"] = host["late"]["error"] - host0["late"]["error"]
    open_lanes = {ln.name: ln.breaker.state for ln in _LANES
                  if ln.breaker.state != "closed"}
    if moved or now["armed"] or not_ok or not host["exact"] or open_lanes:
        raise AssertionError(
            f"{label}: degraded check path: moved {moved}, armed CHAOS "
            f"levers {now['armed']}; host actions: outcomes other than ok "
            f"{not_ok}, ledger exact {host['exact']} (submitted "
            f"{host['submitted']}, resolved {host['resolved']}), lane "
            f"breakers not closed {open_lanes}")
    _GATE["base"] = now
    ok = host["outcomes"]["ok"] - host0["outcomes"]["ok"]
    log(f"{label}: no retry, fallback or breaker transition; CHAOS "
        f"inert; {ok} host actions since the last gate, all ok, ledger "
        f"exact, {len(_LANES)} lanes closed")


def served_trip(ruleset) -> dict:
    """Wrapper calls of one served check trip on the headline world:
    K1, one K2 / K3 literal launch per subject group, atom_eval where
    the world has op-program atoms, K4, K5 and the rule-telemetry
    fold."""
    from istio_tpu_torch import kernels
    g = ruleset.geometry
    trip = {k: 0 for k in kernels.KERNELS}
    trip.update(rule_match=1, dfa_scan=g["n_dfa_groups"],
                byte_pred=g["n_byte_groups"], verdict_fold=1,
                check_pack=1, rule_stats=1,
                atom_eval=int(g["n_prog_atoms"] > 0))
    return trip


class ResilienceWindow:
    """Exact accounting of one step of phase 14: the device trips the
    ResilientChecker admitted (a spy on its device callable), the
    kernel wrapper calls, and the deltas of retries, fallbacks by
    reason, breaker transitions and CHAOS injections must equal what
    the injected schedule predicts. `shed` is read after the step, so
    a drive may fill it in."""

    def __init__(self, srv, trip: dict):
        from istio_tpu_torch import kernels
        self.trip = trip
        self.trips = 0
        self._kernels = kernels
        device = srv.resilience.device

        def spied(bags, deadline=None):
            out = device(bags, deadline=deadline)
            self.trips += 1
            return out

        srv.resilience.device = spied

    def run(self, label: str, fn, trips: int | None, retries: int = 0,
            fallback: dict | None = None, transitions: dict | None = None,
            injected: tuple = (0, 0), shed: dict | None = None):
        n0, k0 = self.trips, dict(self._kernels.launches)
        r0 = resilience_reading()
        out = fn()
        r1 = resilience_reading()
        if trips is None:   # a drive whose batches the batcher formed
            trips = self.trips - n0
        got = {
            "trips": self.trips - n0,
            "launches": {k: self._kernels.launches[k] - k0[k]
                         for k in self._kernels.KERNELS},
            "retries": r1["retries"] - r0["retries"],
            "fallback": {k: r1["fallback"][k] - r0["fallback"][k]
                         for k in r1["fallback"]},
            "transitions": {k: r1["transitions"][k] - r0["transitions"][k]
                            for k in BREAKER_STATES},
            "injected": (r1["injected"]["device"] - r0["injected"]["device"],
                         r1["injected"]["oracle"] - r0["injected"]["oracle"]),
            "shed": {k: r1["shed"][k] - r0["shed"][k] for k in r1["shed"]}}
        want = {
            "trips": trips,
            "launches": {k: trips * v for k, v in self.trip.items()},
            "retries": retries,
            "fallback": {k: (fallback or {}).get(k, 0)
                         for k in r1["fallback"]},
            "transitions": {k: (transitions or {}).get(k, 0)
                            for k in BREAKER_STATES},
            "injected": injected,
            "shed": {k: (shed or {}).get(k, 0) for k in r1["shed"]}}
        if got != want:
            raise AssertionError(f"{label}: counts {got}, the schedule "
                                 f"predicts {want}")
        return out


def degraded_equal(label: str, got, want, want_oracle) -> None:
    """An oracle answer: every field equal to the CPU server's host
    oracle, and status and TTL equal to its served (device-path)
    answer."""
    compare_responses(label, got, want_oracle)
    ttl = [(r.status_code, r.valid_duration_s, r.valid_use_count)
           for r in got]
    if ttl != [(r.status_code, r.valid_duration_s, r.valid_use_count)
               for r in want]:
        raise AssertionError(f"{label}: oracle statuses / TTLs differ "
                             "from the served path's")


def resilience_phase() -> dict:
    """Phase 14: the Check() resilience plane on the card. A card server
    with breaker_failures=2 and breaker_reset_s=0.2 (RESILIENCE_ARGS)
    and a device="cpu" server on one make_store(10_000) store; batches of
    B=256 (half headline, half hit traffic), every response held against
    the CPU server's. (a) a clean trip; (b) one injected device failure,
    absorbed by the retry; (c) 2 x breaker_failures injected failures:
    two batches answered by the oracle, the breaker opens; (d) a batch
    while it is open, answered by the oracle, no launch; (e) after
    breaker_reset_s the half-open probe, one device trip whose launches
    are held against their plain versions, and the breaker closes; (f)
    device and oracle both failing: fail_policy "closed" raises
    UnavailableError (14), "open" answers OK with a 1 s / 1-use TTL,
    then a probe closes the breaker; check_many walls at
    RESILIENCE_WALL_B; (g) brownout under 64 concurrent check() callers;
    (h) continuous batching across a config publish; (i) a failed
    kernel build raises from the RuntimeServer constructor; (j) a device
    fault that CHAOS did not inject raises from check_many: no retry, no
    fallback, no breaker failure. Every count of (a)-(g) and (j) is
    exact (ResilienceWindow); the launch counters are zeroed before (a)
    and read after (h)."""
    import threading

    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs, monitor
    from istio_tpu_torch.runtime.resilience import (CHAOS,
                                                    ResourceExhaustedError,
                                                    UnavailableError)
    from istio_tpu_torch.testing import workloads

    t_phase = time.perf_counter()
    store = workloads.make_store(HEADLINE_RULES)
    srv = RuntimeServer(store, ServerArgs(**RESILIENCE_ARGS), device="cuda")
    cpu = RuntimeServer(store, ServerArgs(**CPU_SERVER), device="cpu")
    try:
        bags = (served_traffic("headline", HEADLINE_RULES,
                               RESILIENCE_B // 2, seed=61)
                + served_traffic("hit", HEADLINE_RULES,
                                 RESILIENCE_B // 2, seed=62))
        n = len(bags)
        want = cpu.check_many(bags)
        want_oracle = cpu.controller.dispatcher.check_host_oracle(bags)
        rs = srv.controller.dispatcher.snapshot.ruleset
        trip = served_trip(rs)
        win = ResilienceWindow(srv, trip)
        breaker = srv.resilience.breaker
        log(f"[14] card server {RESILIENCE_ARGS} and CPU server built in "
            f"{time.perf_counter() - t_phase:.2f} s; one served trip "
            f"launches {dict((k, v) for k, v in trip.items() if v)}")

        kernels.launches.reset()
        got = win.run("(a) clean trip", lambda: srv.check_many(bags), 1)
        compare_responses("[14a]", got, want)

        CHAOS.device_failures = 1
        got = win.run("(b) one injected failure",
                      lambda: srv.check_many(bags), 1, retries=1,
                      injected=(1, 0))
        compare_responses("[14b]", got, want)
        if breaker.state != "closed":
            raise AssertionError(f"(b) left the breaker {breaker.state}")

        CHAOS.device_failures = 2 * RESILIENCE_ARGS["breaker_failures"]
        got = win.run("(c) first failing batch",
                      lambda: srv.check_many(bags), 0, retries=1,
                      fallback={"device_error": n}, injected=(2, 0))
        degraded_equal("[14c] batch 1", got, want, want_oracle)
        if breaker.state != "closed":
            raise AssertionError("(c) one failure opened the breaker")
        box: dict = {}

        def second_and_open():
            """(c)'s second batch opens the breaker and is answered by the
            oracle (about 1 s on the host for 256 requests, longer than
            breaker_reset_s); (d) runs while that answer is computed, so
            it meets the breaker open."""
            t = threading.Thread(
                target=lambda: box.update(c=srv.check_many(bags)))
            t.start()
            while breaker.state != "open":
                if not t.is_alive():
                    raise AssertionError("(c) never opened the breaker")
                time.sleep(0.0005)
            box["opened"] = time.perf_counter()
            box["d"] = srv.check_many(bags)
            t.join()
            return box

        win.run("(c) second failing batch + (d) batch while open",
                second_and_open, 0, retries=1,
                fallback={"device_error": n, "breaker_open": n},
                transitions={"open": 1}, injected=(2, 0))
        degraded_equal("[14c] batch 2", box["c"], want, want_oracle)
        degraded_equal("[14d]", box["d"], want, want_oracle)
        if breaker.state != "open":
            raise AssertionError(f"(d) left the breaker {breaker.state}")

        time.sleep(max(0.0, box["opened"] + RESILIENCE_ARGS[
            "breaker_reset_s"] + 0.01 - time.perf_counter()))
        plan = srv.controller.dispatcher.fused
        quota0 = plan.engine.quota_counts.clone()
        with kernels.launches.capture() as probe:
            got = win.run("(e) half-open probe",
                          lambda: srv.check_many(bags), 1,
                          transitions={"half_open": 1, "closed": 1})
        compare_responses("[14e]", got, want)
        torch.cuda.synchronize()
        with uncounted():
            check_kernels(probe, quota0)
        log(f"[14e] the probe's {len(probe)} launches equal their plain "
            "versions: " + ", ".join(sorted({k for k, _ in probe})))

        cfg = srv.resilience.config
        CHAOS.device_failures = 10 ** 9
        CHAOS.oracle_failures = 10 ** 9
        try:
            cfg.fail_policy = "closed"

            def closed_raises():
                try:
                    srv.check_many(bags)
                except UnavailableError as exc:
                    return exc
                raise AssertionError("(f) fail-closed answered")

            exc = win.run("(f) fail closed", closed_raises, 0, retries=1,
                          injected=(2, 1))
            if exc.grpc_code != 14:
                raise AssertionError(f"(f) fail-closed code {exc.grpc_code}")
            cfg.fail_policy = "open"
            got = win.run("(f) fail open", lambda: srv.check_many(bags), 0,
                          retries=1, fallback={"fail_open": n},
                          transitions={"open": 1}, injected=(2, 1))
            if [(r.status_code, r.valid_duration_s, r.valid_use_count)
                    for r in got] != [(0, 1.0, 1)] * n:
                raise AssertionError("(f) fail-open answers are not OK "
                                     "with a 1 s / 1-use TTL")
        finally:
            cfg.fail_policy = "closed"
            CHAOS.reset()
        time.sleep(RESILIENCE_ARGS["breaker_reset_s"] + 0.01)
        got = win.run("(f) probe", lambda: srv.check_many(bags), 1,
                      transitions={"half_open": 1, "closed": 1})
        compare_responses("[14f] probe", got, want)
        log(f"[14] (a)-(f) exact: device trips, launches ({n}-row "
            "batches), retries, fallbacks by reason, breaker transitions "
            "and injections as scheduled; device answers equal the CPU "
            "server's, oracle answers its host oracle's (and its statuses "
            "and TTLs); fail-closed UnavailableError (14), fail-open OK "
            "1 s / 1 use; breaker closed")

        walls = {}
        for b in RESILIENCE_WALL_B:
            sub = bags[:b]

            def timed_loop():
                ws = []
                for i in range(SERVED_ITERS + 2):
                    t = time.perf_counter()
                    srv.check_many(sub)
                    if i >= 2:
                        ws.append((time.perf_counter() - t) * 1e3)
                return ws

            ws = win.run(f"walls B={b}", timed_loop, SERVED_ITERS + 2)
            walls[b] = {"p50_ms": float(np.percentile(ws, 50)),
                        "p99_ms": float(np.percentile(ws, 99))}
        log("[14] check_many through the resilient path: " + ", ".join(
            f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms"
            for b, r in walls.items()))

        live = monitor.refresh_latency_gauges()
        sheds = {"brownout": 0, "queue_full": 0}
        served_rows: list = []
        other: list = []
        lock = threading.Lock()

        def caller(k: int) -> None:
            for j in range(BROWNOUT_CALLS):
                i = (k * BROWNOUT_CALLS + j) % n
                try:
                    r = srv.check(bags[i])
                except ResourceExhaustedError as exc:
                    with lock:
                        sheds["brownout" if "brownout" in str(exc)
                              else "queue_full"] += 1
                    continue
                except Exception as exc:   # noqa: BLE001 — reported below
                    other.append(repr(exc))
                    continue
                served_rows.append((i, r))

        def brownout_drive():
            ts = [threading.Thread(target=caller, args=(k,))
                  for k in range(BROWNOUT_CALLERS)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()

        trips0 = win.trips
        win.run("(g) brownout", brownout_drive, None, shed=sheds)
        g_trips = win.trips - trips0
        if other or not sheds["brownout"]:
            raise AssertionError(f"(g) brownout shed {sheds}, other errors "
                                 f"{other[:3]} (live p99 "
                                 f"{live['p99_ms']:.3f} ms)")
        for i, r in served_rows:
            compare_responses(f"[14g] row {i}", [r], [want[i]])
        log(f"[14g] brownout: {BROWNOUT_CALLERS} callers x "
            f"{BROWNOUT_CALLS} check(): {len(served_rows)} served in "
            f"{g_trips} trips (equal to the CPU server), shed {sheds} "
            f"(RESOURCE_EXHAUSTED; counters equal); live p99 "
            f"{live['p99_ms']:.3f} ms over the "
            f"{monitor.CHECK_P99_TARGET_MS} ms target")

        h = continuous_across_publish(srv, cpu, store)
        out = path_counts("[14] resilience path", SERVED_KERNELS, win.trips)
        build_failure_raises(store)
        real_fault_raises(srv, win, bags)
        seconds = time.perf_counter() - t_phase
        log(f"[t] phase 14 took {seconds:.1f} s")
        return {**out, "rows": [], "walls": walls, "sheds": sheds,
                "continuous": h, "seconds": seconds}
    finally:
        CHAOS.reset()
        srv.close()
        cpu.close()
        store.close()


def continuous_across_publish(srv, cpu, store) -> dict:
    """Phase 14 (h): CONTINUOUS_CALLERS closed-loop check() callers on
    the continuous-batching card server while a config publish (every
    denier answers UNAVAILABLE) lands on both servers through their
    shared store. Every response equals the CPU server's answer under
    the old or the new generation; every request submitted after the
    card's publish returned, and at least one of every request whose
    answer changed, gets the new one."""
    import threading
    from istio_tpu_torch.runtime.resilience import ResourceExhaustedError

    bags = served_traffic("hit", HEADLINE_RULES, 48, seed=63)
    gen_a = cpu.check_many(bags)
    rows: list = []
    errors: list = []
    stop = threading.Event()

    def caller(k: int) -> None:
        i = k
        while not stop.is_set():
            t = time.perf_counter()
            try:
                r = srv.check(bags[i])
            except ResourceExhaustedError as exc:
                errors.append(repr(exc))
            else:
                rows.append((i, t, r))
            i = (i + CONTINUOUS_CALLERS) % len(bags)

    ts = [threading.Thread(target=caller, args=(k,))
          for k in range(CONTINUOUS_CALLERS)]
    for t in ts:
        t.start()
    try:
        time.sleep(0.3)
        old = (srv.controller.dispatcher, cpu.controller.dispatcher)
        t0 = time.perf_counter()
        store.set(("handler", "istio-system", "denyall"), {
            "adapter": "denier",
            "params": {"status_code": 14, "valid_duration_s": 1.5}})
        end = t0 + 120
        published = []
        for x, was in zip((srv, cpu), old):
            while x.controller.dispatcher is was:
                if time.perf_counter() > end:
                    raise AssertionError("(h) the publish never landed")
                time.sleep(0.002)
            published.append(time.perf_counter())
        t_pub = published[0]
        while time.perf_counter() < end and {
                i for i, t, _ in list(rows) if t > t_pub} != set(
                range(len(bags))):
            time.sleep(0.01)
    finally:
        stop.set()
        for t in ts:
            t.join()
    gen_b = cpu.check_many(bags)

    def key(r):
        return tuple(getattr(r, f) for f in RESPONSE_FIELDS)

    a, b = [key(r) for r in gen_a], [key(r) for r in gen_b]
    changed = {i for i in range(len(bags)) if a[i] != b[i]}
    after = [(i, r) for i, t, r in rows if t > t_pub]
    stale = [i for i, r in after if key(r) != b[i]]
    foreign = [i for i, _, r in rows if key(r) not in (a[i], b[i])]
    if errors or stale or foreign or not changed or \
            not changed <= {i for i, _ in after}:
        raise AssertionError(
            f"(h) {len(rows)} responses: sheds {errors[:3]}, stale after "
            f"the publish {stale[:5]}, neither generation {foreign[:5]}, "
            f"{len(changed)} changed answers, served after the publish "
            f"{sorted({i for i, _ in after})[:10]}")
    log(f"[14h] continuous batching ({CONTINUOUS_CALLERS} callers): "
        f"{len(rows)} responses, {len(after)} after the publish returned "
        f"({t_pub - t0:.2f} s after store.set); each equal to the CPU "
        f"server under its generation, none stale; {len(changed)} of "
        f"{len(bags)} answers changed")
    return {"responses": len(rows), "after_publish": len(after),
            "publish_s": t_pub - t0, "changed": len(changed)}


def build_failure_raises(store) -> None:
    """Phase 14 (i): with kernels.build failing, RuntimeServer on the
    card raises from its constructor (before any batch could reach the
    breaker as a device error)."""
    from istio_tpu_torch import kernels
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs

    real = kernels.build

    def failing(*a, **kw):
        raise RuntimeError("kernel build failed (injected by chip_smoke)")

    kernels.build = failing
    try:
        RuntimeServer(store, ServerArgs(), device="cuda")
    except RuntimeError as exc:
        if "injected by chip_smoke" not in str(exc):
            raise
    else:
        raise AssertionError("(i) RuntimeServer(device='cuda') built with a "
                             "failing kernel build")
    finally:
        kernels.build = real
    log("[14i] a failing kernel build raises from "
        "RuntimeServer(device='cuda')")


def real_fault_raises(srv, win, bags) -> None:
    """Phase 14 (j): the card server's device trip raises an exception
    that CHAOS did not inject (as a kernel that fails to launch would).
    check_many raises it: no retry, no fallback, no breaker transition,
    no trip admitted; the breaker stays closed."""
    spied = srv.resilience.device

    def faulty(bags, deadline=None):
        raise RuntimeError("device fault (raised by chip_smoke)")

    def drive():
        try:
            srv.check_many(bags)
        except RuntimeError as exc:
            if "raised by chip_smoke" not in str(exc):
                raise
            return
        raise AssertionError("(j) a real device fault was answered")

    srv.resilience.device = faulty
    try:
        win.run("(j) real device fault", drive, 0)
    finally:
        srv.resilience.device = spied
    if srv.resilience.breaker.state != "closed":
        raise AssertionError(f"(j) left the breaker "
                             f"{srv.resilience.breaker.state}")
    log("[14j] a device fault CHAOS did not inject raises from the card "
        "server's check_many: no retry, fallback or breaker transition")


# ---- phase 14b: the adapter-executor plane

# the card server of phase 14b: a lane breaker of two failures and a
# 0.2 s window, two workers a lane, and quota()'s default deadline
EXECUTOR_ARGS = dict(host_breaker_failures=2, host_breaker_reset_s=0.2,
                     executor_workers=2, default_check_deadline_ms=250.0,
                     buckets=(64, 256))
EXECUTOR_B = (64, 256)
EXECUTOR_ITERS = 20          # timed check_many calls per B and mode
EXECUTOR_QUOTA_ITERS = 20    # quota() calls, each held against the CPU's
EXECUTOR_DEADLINE_S = 0.05   # (d), (e): the batch deadline
# what a call may take past its deadline: on an H100 80GB HBM3 at 700 W
# the wedged batches of (d) and (e) returned 5.7 and 4.3 ms past their
# 50 ms deadline and the wedged quota() of (f) 0.9 ms past its 250 ms,
# with the overlay world's B = 64 check_many p99 at 51.4 ms
EXECUTOR_SLACK_S = 0.15
HOST_HANDLERS = ("cilist.istio-system", "provlist.istio-system",
                 "dynpat.istio-system")
MQ_HANDLER = "mq.istio-system"


def overlay_traffic(b: int, n_rules: int) -> tuple[list, list]:
    """b bags aimed at make_store(host_overlay_every=5)'s overlay rules:
    bag j hits rule 5j + 2 alone, whose host list action is on
    HOST_HANDLERS[j % 3] (tests/test_executor.py's _overlay_bag) →
    (bags, the handler of each bag)."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    n_services = n_rules // 2
    bags = []
    for j in range(b):
        i = 5 * j + 2
        bags.append(bag_from_mapping({
            "destination.service":
                f"svc{i % n_services}.ns{i % 23}.svc.cluster.local",
            "source.namespace": "ns2",
            "request.method": "GET",
            "request.path": f"/api/v{i % 3}/items"}))
    return bags, [HOST_HANDLERS[j % 3] for j in range(b)]


def host_delta(before: dict) -> dict:
    """host_action_counters() growth since `before`, per handler:
    submitted and every outcome that moved; late completions; retries;
    and whether the ledger is exact now."""
    from istio_tpu_torch.runtime import monitor
    after = monitor.host_action_counters()
    by = {}
    for h, v in after["by_handler"].items():
        b = before["by_handler"].get(h, {"submitted": 0, "outcomes": {}})
        row = {o: n - b["outcomes"].get(o, 0)
               for o, n in v["outcomes"].items()
               if n != b["outcomes"].get(o, 0)}
        if v["submitted"] != b["submitted"]:
            row["submitted"] = v["submitted"] - b["submitted"]
        if row:
            by[h] = row
    return {"by_handler": by,
            "late": {k: after["late"][k] - before["late"][k]
                     for k in after["late"]},
            "retries": after["retries"] - before["retries"],
            "exact": after["exact"]}


def host_want(handlers: list, late_ok: int = 0, retries: int = 0,
              **outcomes) -> dict:
    """The host_delta a step's schedule predicts: every action of
    `handlers` (one a bag) ok, except the handlers named in `outcomes`
    (handler key → {outcome: n}, the rest of its actions ok)."""
    by: dict = {}
    for h in handlers:
        row = by.setdefault(h, {"submitted": 0})
        row["submitted"] += 1
    for key, outs in outcomes.items():
        h = f"{key}.istio-system"
        by.setdefault(h, {"submitted": 0})
        by[h].update({o: n for o, n in outs.items() if n})
    for h, row in by.items():
        rest = row["submitted"] - sum(v for k, v in row.items()
                                      if k != "submitted")
        if rest:
            row["ok"] = rest
    return {"by_handler": by, "late": {"ok": late_ok, "error": 0},
            "retries": retries, "exact": True}


def host_step(label: str, want: dict, before: dict, wait_late: bool = False
              ) -> dict:
    """Hold host_delta(before) against `want`; with wait_late, first wait
    (at most 5 s) for the late completions `want` predicts."""
    end = time.perf_counter() + 5.0
    got = host_delta(before)
    while wait_late and got["late"] != want["late"] and \
            time.perf_counter() < end:
        time.sleep(0.005)
        got = host_delta(before)
    if got != want:
        raise AssertionError(f"{label}: host actions {got}, the schedule "
                             f"predicts {want}")
    return got


def with_fallback(resp, result):
    """A copy of `resp` with one more host result merged the
    dispatcher's way (lowest rule wins, TTLs take the min)."""
    from istio_tpu_torch.runtime.dispatcher import Dispatcher
    out = dataclasses.replace(resp)
    Dispatcher._combine(out, result)
    return out


def grants_store():
    """tests/test_cache_grants.py's store (a denier on /admin paths),
    plus a rule no request matches, so the world keeps a rule when the
    deny rule is deleted."""
    from istio_tpu_torch.runtime.store import MemStore
    s = MemStore()
    s.set(("handler", "istio-system", "denyadmin"), {
        "adapter": "denier",
        "params": {"status_code": 7, "status_message": "admin is off limits",
                   "valid_duration_s": 600.0, "valid_use_count": 100000}})
    s.set(("instance", "istio-system", "nothing"), {
        "template": "checknothing", "params": {}})
    s.set(("rule", "istio-system", "r-deny"), {
        "match": 'request.path.startsWith("/admin")',
        "actions": [{"handler": "denyadmin", "instances": ["nothing"]}]})
    s.set(("rule", "istio-system", "r-none"), {
        "match": 'destination.service == "nowhere.prod.svc.cluster.local"',
        "actions": [{"handler": "denyadmin", "instances": ["nothing"]}]})
    return s


GRANT_ARGS = dict(check_grants=True, grant_ttl_floor_s=0.3,
                  grant_ttl_cap_s=1.2, grant_ttl_ramp_per_s=2.0,
                  buckets=(8,), max_batch=8)


def grant_audit_leg(gsrv, before: dict) -> None:
    """Phase 14b (g): the audit plane's grant_coherence on the
    check_grants card server, ok before and after the store-delete
    publish with revocations keeping pace with publishes; a grant issued
    past the watermark (grant_issue_skew) violated."""
    from istio_tpu_torch.runtime.audit import SEAMS
    after = audit_check(gsrv.audit.evaluate(), "grant_coherence")
    ev = after["evidence"]
    if before["status"] != "ok" or after["status"] != "ok" or \
            ev["publishes_since_audit_start"] < 1 or \
            ev["revocations_since_audit_start"] < \
            ev["publishes_since_audit_start"]:
        raise AssertionError(f"[14b g] grant_coherence before {before}, "
                             f"after the publish {after}")
    SEAMS.grant_issue_skew = ev["policy_generation"] + 10
    try:
        bad = audit_check(gsrv.audit.evaluate(), "grant_coherence")
    finally:
        SEAMS.reset()
    if bad["status"] != "violated":
        raise AssertionError(f"[14b g] grant_issue_skew: {bad}")
    log(f"[14b g] audit grant_coherence ok across the publish: "
        f"{json.dumps(ev)}; grant_issue_skew → violated ({bad['note']})")


def executor_phase() -> dict:
    """Phase 14b: the adapter-executor plane on the card. A card server
    (EXECUTOR_ARGS) and a device="cpu" server with host_executor=False
    (the inline oracle) on one make_store(10_000, host_overlay_every=5)
    store; overlay_traffic at B = 64 and 256. (a) clean: every response
    equal to the inline oracle's, every action ok, one trip's launches
    held against their plain versions; (b) one injected cilist failure,
    absorbed by the lane's retry; (c) a cilist adapter that raises on
    both servers, in a batch of host_breaker_failures cilist rows:
    INTERNAL with the inline path's status and message
    (after the exception's type name the executor adds, as the
    reference's does), the lane opens, the next batch answers
    UNAVAILABLE (breaker_open), and after host_breaker_reset_s the
    half-open probe closes it; (d) provlist wedged, a batch under a 50
    ms deadline: its rows UNAVAILABLE (overrun / expired) within the
    deadline and EXECUTOR_SLACK_S, the other rows unchanged (the
    bulkhead), the lane open, a second batch short-circuited; once
    unwedged, the late completions counted and the answers equal (a)'s
    again; (e) host_fail_policy "open": the wedged rows answer OK with a
    1 s / 1-use TTL; (f) quota() through the memquota lane under the
    server's default deadline: grants equal to the CPU server's, a
    wedged call answering UNAVAILABLE by that deadline, injected
    failures and the open lane answering quota_fallback's results, one
    K1 trip a call; (g) a check_grants=True card server: TTLs in [floor,
    cap] for an allow and a deny, the policy revoking before the
    dispatcher swap on a store delete, the first response of the new
    generation within the floor's bound; (h) the maintenance lane: a
    list provider refreshed every 0.1 s, a failing one counted and its
    last good list kept. Outcomes by handler, retries, late completions,
    device trips and launches are exact in every step; the device
    breaker never moves. Timed: check_many at EXECUTOR_B with the
    executor on and off (the dispatcher's executor set aside), quota()."""
    import numpy as np
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.adapters.list_adapter import ListHandler
    from istio_tpu_torch.adapters.sdk import CheckResult, QuotaArgs
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime import (RuntimeServer, ServerArgs, grants,
                                         monitor)
    from istio_tpu_torch.runtime.executor import (AdapterExecutor,
                                                  ExecutorConfig,
                                                  quota_fallback)
    from istio_tpu_torch.runtime.fused import FusedPlan
    from istio_tpu_torch.runtime.resilience import CHAOS
    from istio_tpu_torch.testing import workloads

    t_phase = time.perf_counter()
    ci, prov, _dyn = HOST_HANDLERS
    store = workloads.make_store(HEADLINE_RULES, host_overlay_every=5)
    srv = RuntimeServer(store, ServerArgs(**EXECUTOR_ARGS), device="cuda")
    cpu = RuntimeServer(store, ServerArgs(
        host_executor=False, **{**CPU_SERVER, "buckets": (64, 256)}),
        device="cpu")
    gstore = grants_store()
    gsrv = RuntimeServer(gstore, ServerArgs(**GRANT_ARGS), device="cuda")
    try:
        d = srv.controller.dispatcher
        rs = d.snapshot.ruleset
        trip = served_trip(rs)
        win = ResilienceWindow(srv, trip)
        ex = srv.executor
        traffic = {b: overlay_traffic(b, HEADLINE_RULES) for b in EXECUTOR_B}
        bags, hs = traffic[64]
        n_kind = {h: hs.count(h) for h in HOST_HANDLERS}
        want_cpu = {b: cpu.check_many(tb) for b, (tb, _) in traffic.items()}
        clean = want_cpu[64]
        log(f"[14b] card server {EXECUTOR_ARGS}, inline CPU server and a "
            f"check_grants card server built in "
            f"{time.perf_counter() - t_phase:.2f} s; "
            f"{len(d.fused.host_actions)} host-overlay rules; B=64 actions "
            f"by handler {n_kind}; published refreshables "
            f"{sorted(ex.snapshot()['maintenance'])}")

        kernels.launches.reset()
        # (a) clean, both batch sizes; one B=256 trip captured
        for b, (tb, th) in traffic.items():
            h0 = monitor.host_action_counters()
            plan = srv.controller.dispatcher.fused
            quota0 = plan.engine.quota_counts.clone()
            with kernels.launches.capture() as probe:
                got = win.run(f"(a) clean B={b}",
                              lambda: srv.check_many(tb), 1)
            compare_responses(f"[14b a] B={b}", got, want_cpu[b])
            host_step(f"(a) B={b}", host_want(th), h0)
        torch.cuda.synchronize()
        with uncounted():
            check_kernels(probe, quota0)
        log(f"[14b a] B=64 and 256: every response equal to the inline "
            f"oracle's; every host action ok, ledger exact; one device "
            f"trip a batch; the B=256 trip's {len(probe)} launches equal "
            "their plain versions")

        # (b) one injected failure on cilist: the retry absorbs it
        h0 = monitor.host_action_counters()
        i0 = CHAOS.injected_adapter
        CHAOS.adapter_failures[ci] = 1
        got = win.run("(b) one adapter failure",
                      lambda: srv.check_many(bags), 1)
        compare_responses("[14b b]", got, clean)
        host_step("(b)", host_want(hs, retries=1), h0)
        if (CHAOS.injected_adapter - i0, ex.lane(ci).breaker.state) != \
                (1, "closed"):
            raise AssertionError("(b) injected / lane state")
        CHAOS.reset()
        log("[14b b] one injected cilist failure: one retry, every answer "
            "equal to (a)'s, the lane closed")

        # (c) a cilist adapter that raises, on both servers
        def flaky(template, instance):
            raise RuntimeError("flaky adapter (raised by chip_smoke)")

        raising = [x.controller.dispatcher.handlers[ci] for x in (srv, cpu)]
        for h in raising:
            h.handle_check = flaky
        # the inline loop logs a traceback a failed action
        quiet = logging.getLogger("istio_tpu_torch.runtime.dispatcher")
        level = quiet.level
        quiet.setLevel(logging.CRITICAL)
        try:
            # exactly host_breaker_failures cilist rows: the lane's
            # workers run while the fold still submits, so in a larger
            # batch the lane opens part way through the submissions
            few = bags[:3 * EXECUTOR_ARGS["host_breaker_failures"]]
            n_few = hs[:len(few)].count(ci)
            want_c = cpu.check_many(few)
            h0 = monitor.host_action_counters()
            got = win.run("(c) raising adapter",
                          lambda: srv.check_many(few), 1)
            host_step("(c) batch 1", host_want(
                hs[:len(few)], retries=n_few, cilist={"error": n_few}), h0)
            inline_msgs = 0
            for i, (a, w) in enumerate(zip(got, want_c)):
                if hs[i] == ci:
                    # the reference's executor names the exception's type
                    # in its INTERNAL message; the inline loop does not
                    w = dataclasses.replace(w, status_message=w.status_message
                                            .replace("adapter panic: ",
                                                     "adapter panic: "
                                                     "RuntimeError: "))
                    inline_msgs += w.status_code == 13
                compare_responses(f"[14b c] row {i}", [a], [w])
            if not inline_msgs or ex.lane(ci).breaker.state != "open":
                raise AssertionError(f"(c) {inline_msgs} INTERNAL rows, lane "
                                     f"{ex.lane(ci).breaker.state}")
            h0 = monitor.host_action_counters()
            got = win.run("(c) lane open", lambda: srv.check_many(bags), 1)
            host_step("(c) batch 2", host_want(
                hs, cilist={"breaker_open": n_kind[ci]}), h0)
            fb = CheckResult(status_code=14, status_message=(
                "host adapter unavailable (breaker_open)"))
            compare_responses("[14b c] lane open", got, [
                with_fallback(c, fb) if h == ci else c
                for c, h in zip(clean, hs)])
        finally:
            quiet.setLevel(level)
            for h in raising:
                del h.handle_check
        time.sleep(EXECUTOR_ARGS["host_breaker_reset_s"] + 0.01)
        h0 = monitor.host_action_counters()
        got = win.run("(c) half-open probe",
                      lambda: srv.check_many(bags[:1]), 1)
        compare_responses("[14b c] probe", got, clean[:1])
        host_step("(c) probe", host_want(hs[:1]), h0)
        if ex.lane(ci).breaker.state != "closed":
            raise AssertionError("(c) the probe left the lane "
                                 f"{ex.lane(ci).breaker.state}")
        log(f"[14b c] a raising cilist adapter: {n_few} rows INTERNAL "
            "as the inline path answers (its message after the type name), "
            f"{n_few} retries, the lane open; the next batch "
            "UNAVAILABLE (breaker_open) on those rows, the rest unchanged; "
            "the half-open probe closed the lane")

        # (d) provlist wedged under a 50 ms batch deadline; (e) fail-open
        def wedged(label, policy):
            ex.config.fail_policy = policy
            h0 = monitor.host_action_counters()
            CHAOS.wedge_adapter(prov)
            try:
                t = time.perf_counter()
                got = win.run(label, lambda: srv._run_check_batch(
                    bags, deadline=time.perf_counter()
                    + EXECUTOR_DEADLINE_S), 1)
                wall = time.perf_counter() - t
                state = ex.lane(prov).breaker.state
                again = win.run(label + " lane open", lambda:
                                srv._run_check_batch(
                                    bags, deadline=time.perf_counter()
                                    + EXECUTOR_DEADLINE_S), 1)
            finally:
                CHAOS.unwedge_adapter(prov)
                ex.config.fail_policy = "closed"
            n_p = n_kind[prov]
            mid = host_delta(h0)["by_handler"][prov]
            over = mid.get("overrun", 0)
            if over > 1 or over + mid.get("expired", 0) != n_p:
                raise AssertionError(f"{label}: provlist outcomes {mid}")
            # the first claim waits out the deadline (overrun), the later
            # ones find it gone (expired); which of the two the first one
            # counts depends on the host's time to the claim
            host_step(label, host_want(
                hs + hs, late_ok=n_p, provlist={
                    "overrun": over, "expired": n_p - over,
                    "breaker_open": n_p}), h0, wait_late=True)
            if wall > EXECUTOR_DEADLINE_S + EXECUTOR_SLACK_S or \
                    state != "open":
                raise AssertionError(f"{label}: {wall:.3f} s, lane {state}")
            return got, again, wall

        got, again, wall = wedged("(d) provlist wedged", "closed")
        for i, (a, c, h) in enumerate(zip(got, clean, hs)):
            if h == prov:
                if a.status_code != (14 if c.status_code == 0
                                     else c.status_code) or \
                        "host adapter unavailable (" not in a.status_message:
                    raise AssertionError(f"(d) row {i}: {a}")
            else:
                compare_responses(f"[14b d] row {i}", [a], [c])
        compare_responses("[14b d] lane open", again, [
            with_fallback(c, CheckResult(status_code=14, status_message=(
                "host adapter unavailable (breaker_open)"))) if h == prov
            else c for c, h in zip(clean, hs)])
        time.sleep(EXECUTOR_ARGS["host_breaker_reset_s"] + 0.01)
        h0 = monitor.host_action_counters()
        got = win.run("(d) recovered", lambda: srv.check_many(bags), 1)
        compare_responses("[14b d] recovered", got, clean)
        host_step("(d) recovered", host_want(hs), h0)
        log(f"[14b d] provlist wedged: {n_kind[prov]} rows UNAVAILABLE in "
            f"{wall * 1e3:.1f} ms (deadline {EXECUTOR_DEADLINE_S * 1e3:.0f} "
            "ms), every other row equal to (a)'s, the lane open and the "
            "next batch short-circuited; once unwedged the late completions "
            "counted (their successes close the lane, as the reference's "
            "do) and every answer equal to (a)'s")

        fo = CheckResult(status_code=0, valid_duration_s=1.0,
                         valid_use_count=1)
        got, again, wall = wedged("(e) fail open", "open")
        for tag, out in (("wedged", got), ("lane open", again)):
            compare_responses(f"[14b e] {tag}", out, [
                with_fallback(c, fo) if h == prov else c
                for c, h in zip(clean, hs)])
        time.sleep(EXECUTOR_ARGS["host_breaker_reset_s"] + 0.01)
        h0 = monitor.host_action_counters()
        compare_responses("[14b e] recovered", win.run(
            "(e) recovered", lambda: srv.check_many(bags), 1), clean)
        host_step("(e) recovered", host_want(hs), h0)
        log("[14b e] host_fail_policy open: the wedged provlist rows answer "
            "OK with a 1 s / 1-use TTL (deny rows keep their status), in "
            f"{wall * 1e3:.1f} ms")

        walls = {}
        for b, (tb, th) in traffic.items():
            walls[b] = {}
            for mode in ("on", "off"):
                d = srv.controller.dispatcher
                d.executor = ex if mode == "on" else None
                try:
                    h0 = monitor.host_action_counters()

                    def loop(tb=tb):
                        ws = []
                        for i in range(EXECUTOR_ITERS + 2):
                            t = time.perf_counter()
                            srv.check_many(tb)
                            if i >= 2:
                                ws.append((time.perf_counter() - t) * 1e3)
                        return ws

                    ws = win.run(f"walls B={b} executor {mode}", loop,
                                 EXECUTOR_ITERS + 2)
                finally:
                    d.executor = ex
                host_step(f"walls B={b} {mode}", host_want(
                    th * (EXECUTOR_ITERS + 2) if mode == "on" else []), h0)
                walls[b][mode] = {"p50_ms": float(np.percentile(ws, 50)),
                                  "p99_ms": float(np.percentile(ws, 99))}
        log("[14b] check_many on the overlay world, executor on / off: "
            + ", ".join(f"B={b} p50 {r['on']['p50_ms']:.4f} / "
                        f"{r['off']['p50_ms']:.4f} ms p99 "
                        f"{r['on']['p99_ms']:.4f} / {r['off']['p99_ms']:.4f} "
                        "ms" for b, r in walls.items()))

        # (f) quota() through the memquota lane
        g = rs.geometry
        k1_trip = {"rule_match": 1, "dfa_scan": g["n_dfa_groups"],
                   "byte_pred": g["n_byte_groups"],
                   "atom_eval": int(g["n_prog_atoms"] > 0)}
        qbags = [bag_from_mapping({"source.user": f"user{k % 7}",
                                   "destination.service":
                                       f"svc{k}.ns{k % 23}.svc.cluster.local"})
                 for k in range(EXECUTOR_QUOTA_ITERS)]
        h0 = monitor.host_action_counters()
        k0 = dict(kernels.launches)
        i0 = CHAOS.injected_adapter
        qw = []
        for k, qb in enumerate(qbags):
            qa = QuotaArgs(quota_amount=1 + k % 3)
            t = time.perf_counter()
            r = srv.quota(qb, "rq", qa)
            qw.append((time.perf_counter() - t) * 1e3)
            w = cpu.quota(qb, "rq", qa)
            if (r.granted_amount, r.status_code, r.status_message) != \
                    (w.granted_amount, w.status_code, w.status_message):
                raise AssertionError(f"(f) quota {k}: card {r}, CPU {w}")
        calls = len(qbags)
        CHAOS.wedge_adapter(MQ_HANDLER)
        try:
            t = time.perf_counter()
            r = srv.quota(qbags[0], "rq", QuotaArgs(quota_amount=2))
            q_wall = time.perf_counter() - t
        finally:
            CHAOS.unwedge_adapter(MQ_HANDLER)
        calls += 1
        dl = EXECUTOR_ARGS["default_check_deadline_ms"] / 1e3
        if r != quota_fallback("closed", "overrun", 2) or \
                not dl <= q_wall < dl + EXECUTOR_SLACK_S:
            raise AssertionError(f"(f) wedged quota {r} in {q_wall:.3f} s")
        host_step("(f) wedged", {
            "by_handler": {MQ_HANDLER: {"submitted": calls,
                                        "ok": calls - 1, "overrun": 1}},
            "late": {"ok": 1, "error": 0}, "retries": 0, "exact": True},
            h0, wait_late=True)
        CHAOS.adapter_failures[MQ_HANDLER] = 10 ** 6
        msg = (f"RuntimeError: chaos: injected adapter failure "
               f"({MQ_HANDLER})")
        for k, (policy, reason) in enumerate((("error", msg),
                                              ("error", msg),
                                              ("closed", "breaker_open"))):
            r = srv.quota(qbags[k], "rq", QuotaArgs(quota_amount=3))
            if r != quota_fallback(policy, reason, 3):
                raise AssertionError(f"(f) failing quota {k}: {r}")
        calls += 3
        injected = CHAOS.injected_adapter - i0
        CHAOS.reset()
        time.sleep(EXECUTOR_ARGS["host_breaker_reset_s"] + 0.01)
        r, w = (x.quota(qbags[1], "rq", QuotaArgs(quota_amount=1))
                for x in (srv, cpu))
        calls += 1
        if (r.granted_amount, r.status_code) != \
                (w.granted_amount, w.status_code) or \
                ex.lane(MQ_HANDLER).breaker.state != "closed":
            raise AssertionError(f"(f) probe {r} / {w}, lane "
                                 f"{ex.lane(MQ_HANDLER).breaker.state}")
        host_step("(f)", {
            "by_handler": {MQ_HANDLER: {
                "submitted": calls, "ok": calls - 4, "overrun": 1,
                "error": 2, "breaker_open": 1}},
            "late": {"ok": 1, "error": 0}, "retries": 2, "exact": True}, h0)
        launched = {k: kernels.launches[k] - k0[k] for k in kernels.KERNELS}
        want_l = {k: calls * k1_trip.get(k, 0) for k in kernels.KERNELS}
        if launched != want_l or injected != 4:
            raise AssertionError(f"(f) launches {launched}, want {want_l}; "
                                 f"injected {injected}")
        quota_walls = {"p50_ms": float(np.percentile(qw, 50)),
                       "p99_ms": float(np.percentile(qw, 99))}
        log(f"[14b f] quota(): {EXECUTOR_QUOTA_ITERS} grants equal to the "
            f"CPU server's (p50 {quota_walls['p50_ms']:.4f} ms p99 "
            f"{quota_walls['p99_ms']:.4f} ms); a wedged backend answered "
            f"UNAVAILABLE by the default deadline in {q_wall * 1e3:.1f} ms; "
            "2 injected failures INTERNAL, the open lane UNAVAILABLE, as "
            f"quota_fallback builds them; the probe closed the lane; "
            f"{calls} calls, {calls} K1 trips: launches {launched}")

        # (g) check-cache grants on the check_grants card server
        gwin = ResilienceWindow(gsrv, served_trip(
            gsrv.controller.dispatcher.snapshot.ruleset))
        mk = bag_from_mapping
        allow = {"destination.service": "web.prod.svc.cluster.local",
                 "request.path": "/api/items"}
        deny = dict(allow, **{"request.path": "/admin/keys"})
        pol = gsrv.grants
        floor, cap = pol.ttl_floor_s, pol.ttl_cap_s
        got = gwin.run("(g) grants", lambda: gsrv.check_many(
            [mk(dict(allow)), mk(dict(deny))]), 1)
        if [r.status_code for r in got] != [0, 7] or not all(
                floor <= r.valid_duration_s <= cap and
                grants.USE_FLOOR <= r.valid_use_count <= grants.USE_CAP
                for r in got):
            raise AssertionError(f"(g) grants {got}")
        old = gsrv.controller.dispatcher
        seen: list = []
        real = pol.on_publish

        def spy(changed=None):
            seen.append((gsrv.controller._dispatcher is old,
                         pol.generation))
            real(changed)

        pol.on_publish = spy
        warm_trips: list = []
        real_warm = FusedPlan.prewarm

        def counted_warm(plan, buckets):
            warm_trips.append(len(plan.all_warm_shapes(buckets)))
            return real_warm(plan, buckets)

        FusedPlan.prewarm = counted_warm
        k0 = dict(kernels.launches)
        g_audit = audit_check(gsrv.audit.evaluate(), "grant_coherence")
        try:
            gen0 = pol.generation
            gstore.delete(("rule", "istio-system", "r-deny"))
            end = time.perf_counter() + 60.0
            while gsrv.controller.dispatcher is old:
                if time.perf_counter() > end:
                    raise AssertionError("(g) the publish never landed")
                time.sleep(0.001)
            # the new generation's world has no byte group left
            gwin2 = ResilienceWindow(gsrv, served_trip(
                gsrv.controller.dispatcher.snapshot.ruleset))
            first = gwin2.run("(g) new generation", lambda: gsrv.check_many(
                [mk(dict(deny)), mk(dict(allow))]), 1)
        finally:
            pol.on_publish = real
            FusedPlan.prewarm = real_warm
        st = pol.stats()
        age_q = (st["global_age_s"] // pol.quantum_s) * pol.quantum_s
        bound = min(cap, floor + age_q * pol.ttl_ramp_per_s)
        k1 = kernels.launches["rule_match"] - k0["rule_match"]
        if seen != [(True, gen0)] or pol.generation != gen0 + 1 or \
                [r.status_code for r in first] != [0, 0] or \
                not all(floor <= r.valid_duration_s <= bound + 0.05
                        for r in first) or k1 != 1 + sum(warm_trips):
            raise AssertionError(
                f"(g) revocations {seen} (generation {gen0} → "
                f"{pol.generation}); first responses {first}, bound "
                f"{bound}; rule_match {k1}, warm trips {warm_trips}")
        log(f"[14b g] grants: allow and deny TTLs in [{floor}, {cap}]; the "
            "store delete revoked (generation "
            f"{gen0} → {pol.generation}) while the old dispatcher still "
            "served; the new generation's first responses OK at "
            f"{first[0].valid_duration_s} s (bound {bound}); "
            f"{sum(warm_trips)} warm trips + 1 served trip")
        grant_audit_leg(gsrv, g_audit)

        # (h) the maintenance lane
        calls_h = {"ok": 0, "fail": 0}
        failing = {"on": False}

        def provider():
            if failing["on"]:
                calls_h["fail"] += 1
                raise RuntimeError("provider down (raised by chip_smoke)")
            calls_h["ok"] += 1
            return ["ns2", "ns4"]

        lh = ListHandler({"provider": provider, "refresh_interval_s": 0.1},
                         env=None)
        calls_h["ok"] = 0
        t0 = int(monitor.LIST_REFRESH_TOTAL.value())
        f0 = int(monitor.LIST_REFRESH_FAILURES.value())
        mex = AdapterExecutor(ExecutorConfig(maintenance_tick_s=0.02))
        try:
            mex.register_refreshable("chip.provlist", lh)
            end = time.perf_counter() + 10.0
            while calls_h["ok"] < 2 and time.perf_counter() < end:
                time.sleep(0.01)
            failing["on"] = True
            while calls_h["fail"] < 2 and time.perf_counter() < end:
                time.sleep(0.01)
        finally:
            mex.close()
        snap = mex.snapshot()["maintenance"]["chip.provlist"]
        total = int(monitor.LIST_REFRESH_TOTAL.value()) - t0
        fails = int(monitor.LIST_REFRESH_FAILURES.value()) - f0
        keeps = [lh.handle_check("listentry", {"value": v}).ok
                 for v in ("ns2", "ns3")]
        if calls_h["ok"] < 2 or calls_h["fail"] < 2 or \
                total != calls_h["ok"] + calls_h["fail"] or \
                fails != calls_h["fail"] or \
                (snap["refresh_total"], snap["refresh_failures"]) != \
                (total, fails) or \
                lh.refresh_stats()["refresh_failures"] != fails or \
                keeps != [True, False]:
            raise AssertionError(
                f"(h) provider calls {calls_h}, refresh totals {total} / "
                f"{fails}, maintenance view {snap}, last good list {keeps}")
        log(f"[14b h] maintenance lane: {total} refreshes every 0.1 s, "
            f"{fails} failing ones counted, the last good list kept")

        out = path_counts("[14b] executor path", SERVED_KERNELS,
                          win.trips + gwin.trips + calls + sum(warm_trips))
        hc = monitor.host_action_counters()
        if not hc["exact"] or [ln for ln in (ex.lane(h) for h in
                                             HOST_HANDLERS + (MQ_HANDLER,))
                               if ln.breaker.state != "closed"]:
            raise AssertionError(f"(14b) at quiescence: {hc}")
        seconds = time.perf_counter() - t_phase
        log(f"[t] phase 14b took {seconds:.1f} s")
        return {**out, "rows": [], "walls": walls, "quota": quota_walls,
                "seconds": seconds}
    finally:
        CHAOS.reset()
        for x in (srv, cpu, gsrv):
            x.close()
        store.close()
        gstore.close()


# ---- phase 15: the config canary

CANARY_SEED = 20
CANARY_BUCKETS = (16, 32)    # scripts/canary_smoke.py's serving buckets
CANARY_B = 2048              # (b): recorded rows, half headline, half hit
CANARY_OVERLAY_B = 256       # (c): overlay rows, half of them host-denied
# the kernels of a replay trip: no rule_stats (observe off), no quota
CANARY_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold",
                  "check_pack")


def canary_errors() -> float:
    """mixer_canary_errors_total: canary evaluations that failed open."""
    from istio_tpu_torch.canary.gate import FAMILIES
    return FAMILIES["errors"].value()


def canary_view(rep) -> dict:
    """A CanaryReport without wall times and trace ids."""
    d = rep.to_dict()
    for k in ("replay_rows_per_s", "replay_wall_s"):
        d.pop(k)
    for c in d["per_rule"].values():
        for ex in c["exemplars"]:
            ex.pop("trace_id")
    return d


def canary_docs(store, docs) -> None:
    """Apply [(key, spec)] docs with no watcher delivery: the phase
    rebuilds explicitly, and a debounced rebuild would race it."""
    from istio_tpu_torch.runtime.store import Event
    store.apply_events([Event(k, dict(s)) for k, s in docs], notify=False)


def canary_swap(store, old_docs, new_docs) -> None:
    from istio_tpu_torch.runtime.store import Event
    gone = {k for k, _ in old_docs} - {k for k, _ in new_docs}
    store.apply_events([Event(k, None) for k in gone], notify=False)
    canary_docs(store, new_docs)


def canary_serve(srv, bags, buckets=CANARY_BUCKETS) -> list:
    """check_many over chunks of the largest bucket, each padded to its
    bucket (the shapes the batcher forms)."""
    from istio_tpu_torch.runtime.batcher import pad_to_bucket
    out = []
    for lo in range(0, len(bags), buckets[-1]):
        chunk = bags[lo:lo + buckets[-1]]
        out.extend(srv.check_many(pad_to_bucket(chunk, buckets))[:len(chunk)])
    return out


class ReplaySpy:
    """Keeps each ReplayResult the gate's replay_entries returns (the
    main path's own replay, not a second one)."""

    def __init__(self):
        from istio_tpu_torch.canary import gate
        self._gate, self._real = gate, gate.replay_entries
        self.results: list = []

        def spied(*a, **kw):
            out = self._real(*a, **kw)
            self.results.append(out)
            return out

        gate.replay_entries = spied

    def close(self) -> None:
        self._gate.replay_entries = self._real


def canary_pairs_leg() -> int:
    """(a) The three seeded pairs (testing/corpus.make_canary_snapshot_pairs)
    on a card server and a device="cpu" server fed the same traffic, in
    gate mode and in warn mode. → the number of oracle-confirmed
    status-flip exemplars."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.canary import CanaryRejected
    from istio_tpu_torch.compiler import ruleset
    from istio_tpu_torch.runtime import MemStore, RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import corpus

    args = dict(batch_window_s=0.0005, max_batch=CANARY_BUCKETS[-1],
                buckets=CANARY_BUCKETS, rulestats_drain_s=0,
                default_manifest=corpus.ANALYZER_MANIFEST)
    confirmed = 0
    for pi, pair in enumerate(corpus.make_canary_snapshot_pairs(CANARY_SEED)):
        tag = f"[15a {pair.kind}]"
        bags = [bag_from_mapping(d)
                for d in corpus.make_canary_traffic(pair, CANARY_SEED)]
        for mode in ("gate", "warn"):
            legs = {}
            for dev in ("cuda", "cpu"):
                store = MemStore()
                canary_docs(store, pair.base_docs)
                legs[dev] = (RuntimeServer(store, ServerArgs(
                    canary=mode, **args), device=dev), store)
            try:
                (srv, store), (cpu, cpu_store) = legs["cuda"], legs["cpu"]
                base = canary_serve(srv, bags)
                compare_responses(f"{tag} {mode} recorded", base,
                                  canary_serve(cpu, bags))
                d0 = srv.controller.dispatcher
                for st in (store, cpu_store):
                    canary_swap(st, pair.base_docs, pair.divergent_docs)
                d1 = srv.controller.rebuild()
                c1 = cpu.controller.rebuild()
                rep = srv.canary.reports()[-1]
                if canary_view(rep) != canary_view(cpu.canary.reports()[-1]):
                    raise AssertionError(f"{tag} {mode}: the card's report "
                                         "differs from the CPU server's")
                c = rep.per_rule.get(pair.divergent_rule, {})
                if not c.get(pair.expected):
                    raise AssertionError(
                        f"{tag} {mode}: planted rule {pair.divergent_rule} "
                        f"not named under {pair.expected}: "
                        f"{sorted(rep.per_rule)}")
                if mode == "warn":
                    if d1 is d0 or rep.verdict != "warn" or \
                            srv.canary.recorder.stats()["entries"]:
                        raise AssertionError(
                            f"{tag} warn: published {d1 is not d0}, "
                            f"verdict {rep.verdict}, ring "
                            f"{srv.canary.recorder.stats()}")
                    # re-baselined: refilled under the published config,
                    # the same config replays with no divergence
                    compare_responses(f"{tag} warn refill",
                                      canary_serve(srv, bags),
                                      canary_serve(cpu, bags))
                    srv.controller.rebuild()
                    cpu.controller.rebuild()
                    for x in (srv, cpu):
                        last = x.canary.reports()[-1]
                        if last.verdict != "publish" or last.n_divergent:
                            raise AssertionError(
                                f"{tag} warn: the re-baselined ring "
                                f"reported {last.n_divergent} divergences")
                    continue
                rej = srv.controller.last_canary_rejection
                if d1 is not d0 or c1 is not cpu.controller.dispatcher or \
                        not isinstance(rej, CanaryRejected) or \
                        rep.verdict != "veto":
                    raise AssertionError(f"{tag}: the divergent candidate "
                                         "was not vetoed on both servers")
                for ex in c["exemplars"]:
                    if ex["kind"] == "status_flip":
                        if ex.get("oracle_confirmed") is not True:
                            raise AssertionError(f"{tag}: exemplar not "
                                                 f"oracle-confirmed: {ex}")
                        confirmed += 1
                after = canary_serve(srv, bags)
                compare_responses(f"{tag} after the veto", after, base)
                if srv.controller.dispatcher is not d0:
                    raise AssertionError(f"{tag}: the veto swapped")
                if pi == 0:
                    canary_strict_fault(srv, ruleset, tag)
                for st in (store, cpu_store):
                    canary_swap(st, pair.divergent_docs,
                                pair.identical_docs)
                d2 = srv.controller.rebuild()
                cpu.controller.rebuild()
                for x in (srv, cpu):
                    last = x.canary.reports()[-1]
                    if last.verdict != "publish" or last.n_divergent:
                        raise AssertionError(
                            f"{tag}: the identical swap reported "
                            f"{last.n_divergent} divergences")
                if d2 is d0 or srv.controller.last_canary_rejection:
                    raise AssertionError(f"{tag}: the identical candidate "
                                         "did not publish")
            finally:
                for x, st in legs.values():
                    x.close()
                    st.close()
        log(f"{tag} vetoed on the card and the CPU server with equal "
            f"reports (planted {pair.divergent_rule} under {pair.expected}, "
            f"{rep.n_divergent}/{rep.n_rows} rows); the old dispatcher "
            "served on, equal to the base; the identical swap published "
            "with 0 divergences; warn mode published, re-baselined, and "
            "the refilled ring replayed with 0 divergences")
    return confirmed


def canary_strict_fault(srv, ruleset, tag: str) -> None:
    """(a) on the first pair: the replay's device trip raises an exception
    CHAOS did not inject (rule_match made to fail, as a kernel that does
    not launch would). The card server's strict canary raises it out of
    Controller.rebuild(): no swap, mixer_canary_errors_total unchanged."""
    real = ruleset.rule_match

    def failing(*a, **kw):
        raise RuntimeError("rule_match launch failed (raised by chip_smoke)")

    d0, e0 = srv.controller.dispatcher, canary_errors()
    ruleset.rule_match = failing
    try:
        srv.controller.rebuild()
    except RuntimeError as exc:
        if not getattr(exc, "canary_strict", False):
            raise
    else:
        raise AssertionError(f"{tag}: a replay device fault published")
    finally:
        ruleset.rule_match = real
    if srv.controller.dispatcher is not d0 or canary_errors() != e0:
        raise AssertionError(f"{tag}: the strict fault swapped or failed "
                             "open")
    log(f"{tag} a replay device fault CHAOS did not inject raised out of "
        "rebuild(): no swap, no canary error counted")


def canary_full_width() -> dict:
    """(b) make_store(10_000) on a card server with canary="gate" at the
    defaults (capacity 2,048, replay_limit 1,024, sample_every 1)."""
    import os
    import tempfile
    from collections import Counter
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.adapters.sdk import QuotaArgs
    from istio_tpu_torch.canary import (load_corpus, replay_entries,
                                        save_corpus)
    from istio_tpu_torch.attribute.global_dict import GLOBAL_MANIFEST
    from istio_tpu_torch.canary.gate import FAMILIES
    from istio_tpu_torch.compiler.layout import InternTable
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.runtime.config import SnapshotBuilder
    from istio_tpu_torch.runtime.fused import build_fused_plan
    from istio_tpu_torch.runtime.store import Event
    from istio_tpu_torch.testing import workloads

    t0 = time.perf_counter()
    store = workloads.make_store(HEADLINE_RULES)
    srv = RuntimeServer(store, ServerArgs(canary="gate"), device="cuda")
    spy = ReplaySpy()
    try:
        build_s = time.perf_counter() - t0
        cfg = srv.canary.config
        half = CANARY_B // 2
        head = served_traffic("headline", HEADLINE_RULES, half, seed=150)
        hit = served_traffic("hit", HEADLINE_RULES, half, seed=151)
        bags = [b for pair in zip(head, hit) for b in pair]
        cap = srv.args.max_batch
        served = []
        for lo in range(0, len(bags), cap):
            served += srv.check_many(bags[lo:lo + cap])
        quota_bag = bags[1]
        q_before = [srv.quota(quota_bag, "rq.istio-system", QuotaArgs())
                    for _ in range(2)]
        rec = srv.canary.recorder.stats()
        if rec["entries"] != cfg.capacity or rec["seen"] != CANARY_B:
            raise AssertionError(f"[15b] recorder {rec}")
        entries = srv.canary.recorder.corpus(limit=cfg.replay_limit)
        path = os.path.join(tempfile.mkdtemp(), "canary_corpus.json")
        save_corpus(path, entries)
        names = srv.controller.dispatcher.snapshot.qualified_rule_names()
        # the victim: the deny rule that fired on most replayed rows
        denies = Counter(e.deny_rule for e in entries
                         if e.status and e.deny_rule)
        victim = next(n for n, _ in denies.most_common()
                      if n.split("/")[-1].startswith("rule")
                      and int(n.split("rule")[-1]) % 3 == 0)
        ns, rule = victim.split("/", 1)
        key = ("rule", ns, rule)
        spec = store.get(key)
        # the divergent count, from the saved corpus alone: rows the
        # victim denied whose method is not DELETE
        want_div = 0
        for e in load_corpus(path):
            method, _ = e.bag().get("request.method")
            want_div += e.deny_rule == victim and method != "DELETE"
        divergent = dict(spec, match=spec["match"]
                         + ' && request.method == "DELETE"')
        store.apply_events([Event(key, divergent)], notify=False)
        d0 = srv.controller.dispatcher
        delay = FAMILIES["publish_delay_seconds"]
        s0 = delay.sum()
        k0 = dict(kernels.launches)
        t1 = time.perf_counter()
        with kernels.launches.capture() as captured:
            srv.controller.rebuild()
        torch.cuda.synchronize()
        counts = {k: v - k0[k] for k, v in kernels.launches.items()
                  if v != k0[k]}
        rebuild_s = time.perf_counter() - t1
        delay_s = delay.sum() - s0
        rej = srv.controller.last_canary_rejection
        rep = rej.report if rej is not None else None
        if srv.controller.dispatcher is not d0 or rep is None or \
                rep.verdict != "veto":
            raise AssertionError("[15b] the divergent candidate was not "
                                 "vetoed")
        if rep.n_rows != cfg.replay_limit or \
                rep.diverging_rules() != [victim] or \
                rep.n_divergent != want_div or \
                rep.by_kind != {"status_flip": want_div}:
            raise AssertionError(
                f"[15b] report: {rep.n_divergent}/{rep.n_rows} rows "
                f"{rep.by_kind} rules {rep.diverging_rules()[:5]}; the "
                f"corpus says {want_div} rows of {victim}")
        replay = spy.results[-1]
        # the replay's launches: exactly the kernels of a check trip
        # without the telemetry fold, one trip a chunk
        got = sorted({n for n, _ in captured})
        if got != sorted(CANARY_KERNELS):
            raise AssertionError(f"[15b] the replay launched {got}, want "
                                 f"{sorted(CANARY_KERNELS)}")
        chunks = -(-cfg.replay_limit // srv._buckets[-1])
        plan = rej.candidate_plan
        trip = {k: v for k, v in served_trip(plan.engine.ruleset).items()
                if v and k != "rule_stats"}
        if counts != {k: chunks * v for k, v in trip.items()}:
            raise AssertionError(f"[15b] replay launches {counts}, "
                                 f"{chunks} chunks of {trip}")
        with uncounted():
            check_kernels(captured, plan.engine.quota_counts.clone())
        # card against CPU: the saved corpus replayed by the CPU port
        t2 = time.perf_counter()
        cpu_snap = SnapshotBuilder(GLOBAL_MANIFEST, InternTable(), None,
                                   lower_rbac=True, device="cpu").build(store)
        cpu_plan = build_fused_plan(cpu_snap)
        cpu_replay = replay_entries(cpu_snap, cpu_plan, load_corpus(path),
                                    buckets=srv._buckets)
        cpu_s = time.perf_counter() - t2
        fields = ("status", "valid_duration_s", "valid_use_count",
                  "deny_rule", "quota_rules", "n_rows")
        for f in fields:
            if getattr(replay, f) != getattr(cpu_replay, f):
                raise AssertionError(f"[15b] the card's replay {f} differs "
                                     "from the CPU port's")
        # the veto left the serving state as it was
        again = []
        for lo in range(0, len(bags), cap):
            again += srv.check_many(bags[lo:lo + cap])
        compare_responses("[15b] check_many after the veto", again, served)
        q_after = [srv.quota(quota_bag, "rq.istio-system", QuotaArgs())
                   for _ in range(2)]
        if q_after != q_before:
            raise AssertionError(f"[15b] quota() after the veto {q_after}, "
                                 f"before {q_before}")
        # the identical candidate: the base rules in reversed store order
        rules = [k for k in store.list("rule")]
        specs = {k: store.get(k) for k in rules}
        specs[key] = spec
        store.apply_events([Event(k, None) for k in rules]
                           + [Event(k, specs[k]) for k in reversed(rules)],
                           notify=False)
        t3 = time.perf_counter()
        d2 = srv.controller.rebuild()
        ident_s = time.perf_counter() - t3
        last = srv.canary.reports()[-1]
        renumbered = d2.snapshot.qualified_rule_names() != names
        if d2 is d0 or last.verdict != "publish" or last.n_divergent or \
                not renumbered:
            raise AssertionError(
                f"[15b] the identical candidate: published {d2 is not d0}, "
                f"{last.n_divergent} divergences, renumbered {renumbered}")
        out = {"rules": len(names), "rows": replay.n_rows,
               "divergent": rep.n_divergent, "victim": victim,
               "replay_wall_s": replay.wall_s,
               "replay_rows_per_s": replay.rows_per_s,
               "publish_delay_s": delay_s,
               "host_compile_s": rebuild_s - delay_s,
               "identical_rebuild_s": ident_s, "server_build_s": build_s,
               "cpu_replay_s": cpu_s, "chunks": chunks,
               "launches_per_chunk": {k: v / chunks
                                      for k, v in counts.items()}}
        log(f"[15b] make_store({HEADLINE_RULES}) ({len(names)} rules), "
            f"canary=gate at the defaults: {CANARY_B} served rows "
            f"recorded, the newest {replay.n_rows} replayed in {chunks} "
            f"chunk(s); the divergent candidate ({victim} && DELETE) "
            f"vetoed with {rep.n_divergent} status flips, as the saved "
            f"corpus counts; replay {replay.wall_s * 1e3:.2f} ms = "
            f"{replay.rows_per_s:,.0f} rows/s; publish delay "
            f"{delay_s * 1e3:.2f} ms; candidate host compile "
            f"{rebuild_s - delay_s:.2f} s; launches a chunk "
            f"{out['launches_per_chunk']}, each equal to its plain version;"
            f" the CPU port's replay of the saved corpus equal "
            f"({cpu_s:.2f} s); check_many and quota() after the veto "
            f"unchanged; the reversed store order published with 0 "
            f"divergences (rebuild {ident_s:.2f} s)")
        return out
    finally:
        spy.close()
        srv.close()
        store.close()


def canary_overlay() -> dict:
    """(c) make_store(10_000, host_overlay_every=5) on a card server with
    the executor on: half the overlay rows are denied by their host list
    action, which the device planes never see; the recorder keeps the
    device planes, so an identical swap publishes with 0 divergences."""
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads

    store = workloads.make_store(HEADLINE_RULES, host_overlay_every=5)
    srv = RuntimeServer(store, ServerArgs(canary="gate"), device="cuda")
    try:
        bags, _handlers = overlay_traffic(CANARY_OVERLAY_B, HEADLINE_RULES)
        from istio_tpu_torch.attribute.bag import bag_from_mapping
        # a namespace no whitelist holds: cilist and provlist deny it
        bags = [bag_from_mapping({**{n: b.get(n)[0] for n in b.names()},
                                  "source.namespace": "ns1"})
                if j % 2 else b for j, b in enumerate(bags)]
        got = srv.check_many(bags)
        entries = srv.canary.recorder.corpus()
        host_denied = sum(1 for r, e in zip(got, entries)
                          if r.status_code != 0 and e.status == 0)
        if not host_denied:
            raise AssertionError("[15c] no served row carries a host-overlay "
                                 "verdict the device planes lack")
        d0 = srv.controller.dispatcher
        d1 = srv.controller.rebuild()            # the identical config
        last = srv.canary.reports()[-1]
        if d1 is d0 or last.verdict != "publish" or last.n_divergent:
            raise AssertionError(f"[15c] the identical overlay swap: "
                                 f"{last.n_divergent} divergences")
        log(f"[15c] overlay world (make_store({HEADLINE_RULES}, "
            f"host_overlay_every=5)), executor on: {host_denied} of "
            f"{len(bags)} served rows denied by a host list action the "
            f"device planes lack; recorded {len(entries)} device-plane "
            "rows; the identical swap published with 0 divergences")
        return {"host_denied": host_denied, "rows": len(entries)}
    finally:
        srv.close()
        store.close()


def canary_phase() -> dict:
    """Phase 15: the config canary on the card, counters zeroed just
    before its drive and read just after: (a) the seeded pairs beside a
    CPU server, (b) the headline world at full width, (c) the overlay
    world."""
    from istio_tpu_torch import kernels
    t_phase = time.perf_counter()
    kernels.launches.reset()
    confirmed = canary_pairs_leg()
    log(f"[15a] {confirmed} status-flip exemplars, every one "
        "oracle-confirmed")
    full = canary_full_width()
    overlay = canary_overlay()
    out = path_counts("[15] canary path", CANARY_KERNELS,
                      kernels.launches["check_pack"])
    seconds = time.perf_counter() - t_phase
    log(f"[t] phase 15 took {seconds:.1f} s")
    return {**out, "rows": [], "full": full, "overlay": overlay,
            "confirmed": confirmed, "seconds": seconds}


# ---- phase 16: the sharded serving plane

SHARD_RULES = 100_000        # scripts/shard_smoke.py's gate: 100,000 rules
SHARD_NAMESPACES = 512       # over 512 namespaces,
SHARD_COUNT = 8              # 8 shards
SHARD_REPLICAS = 2           # behind 2 replica lanes
SHARD_SEED = 7
# scripts/shard_smoke.py's serving args (its buckets: every bank trip is
# a 16-row chunk)
SHARD_ARGS = dict(batch_window_s=0.0005, max_batch=16, buckets=(16,),
                  rule_telemetry=False, initial_prewarm=False)
SHARD_B = (64, 256, 2048)
SHARD_ORACLE_ROWS = 512      # rows of each batch size held against the oracle
SHARD_ITERS = 10             # timed check_many calls per batch size
SHARD_LANE_ROWS = 2048       # rows submitted through both lanes at once,
SHARD_LANE_WINDOW = 32       # by closed-loop callers of this many in flight
# the kernels of phase 16: a fleet bank trip is rule_match, verdict_fold
# and check_pack (no subject group, telemetry off); the pair world adds
# the subject groups' dfa_scan / byte_pred and rule_stats, the global
# quota leg quota_alloc (the classic pool flush)
SHARD_KERNELS = ("rule_match", "dfa_scan", "byte_pred", "verdict_fold",
                 "check_pack", "rule_stats", "quota_alloc")
# the pair world of tests/test_sharding.py
PAIR_RULES = 240
PAIR_ARGS = dict(batch_window_s=0.001, buckets=(16, 64), max_batch=64)


class PlanSpy:
    """Counts FusedPlan.packed_check calls by plan: every bank trip is
    one (phase 16 requires one rule_match launch a trip and none from
    the parent plan)."""

    def __init__(self):
        from istio_tpu_torch.runtime.fused import FusedPlan
        self._cls, self._real = FusedPlan, FusedPlan.packed_check
        self.calls: dict[int, int] = {}
        spy = self

        def packed_check(plan, *a, **kw):
            spy.calls[id(plan)] = spy.calls.get(id(plan), 0) + 1
            return spy._real(plan, *a, **kw)

        FusedPlan.packed_check = packed_check

    def close(self) -> None:
        self._cls.packed_check = self._real


class CompileSpy:
    """Times each bank compile of the server's rebuilds (the sharding
    package's compile_shard_bank, which _rebuild_sharded looks up per
    call)."""

    def __init__(self):
        import istio_tpu_torch.sharding as pkg
        self._pkg, self._real = pkg, pkg.compile_shard_bank
        self.walls: list[tuple[int, float]] = []

        def timed_compile(*a, **kw):
            t = time.perf_counter()
            bank = self._real(*a, **kw)
            self.walls.append((bank.shard_id, time.perf_counter() - t))
            return bank

        pkg.compile_shard_bank = timed_compile

    def close(self) -> None:
        self._pkg.compile_shard_bank = self._real


def fleet_bags(n: int) -> list:
    """The first `n` rows of make_fleet_traffic against the fleet world
    (its seed must be the store's: the traffic aims at the rules of the
    namespace assignment that seed makes)."""
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.testing import workloads
    return [bag_from_mapping(d) for d in workloads.make_fleet_traffic(
        n, SHARD_RULES, SHARD_NAMESPACES, SHARD_SEED)]


def bank_trips(srv, bags) -> dict:
    """{bank plan id: trips} a check_many of `bags` makes: one a
    16-row chunk of each bank's rows."""
    from istio_tpu_torch.runtime.dispatcher import _namespace_of
    st = srv._sharded
    rows: dict[int, int] = {}
    for b in bags:
        k = st["plan"].shard_of(_namespace_of(b, srv.args.identity_attr))
        rows[k] = rows.get(k, 0) + 1
    banks = {b.shard_id: b for b in st["banks"]}
    out = {}
    for k, n in rows.items():
        cap = banks[k].dispatcher.buckets[-1]
        out[id(banks[k].dispatcher.fused)] = -(-n // cap)
    return out


def oracle_parity(label: str, srv, bags, got) -> int:
    """Every served row's status and global deny_rule equal
    oracle_check_statuses' over the parent snapshot. → denied rows."""
    from istio_tpu_torch.sharding import oracle_check_statuses
    d = srv.controller.dispatcher
    want = oracle_check_statuses(d.snapshot, d.fused, bags)
    denied = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if (g.status_code, g.deny_rule) != (w["status"], w["deny_rule"]):
            raise AssertionError(
                f"{label}: row {i} status {g.status_code} deny_rule "
                f"{g.deny_rule}, the oracle {w['status']} / "
                f"{w['deny_rule']}")
        denied += w["status"] != 0
    if not denied:
        raise AssertionError(f"{label}: the oracle saw no deny")
    return denied


def shard_plan_checks(srv) -> dict:
    """(a) plan: every config rule in exactly one bank, the global rules
    in all of them, LPT balance as scripts/shard_smoke.py's check 3."""
    st = srv._sharded
    plan, banks = st["plan"], st["banks"]
    n_cfg = len(srv.controller.dispatcher.snapshot.rules)
    if st["mode"] != "sharded" or len(banks) != SHARD_COUNT:
        raise AssertionError(f"[16a] mode {st['mode']} "
                             f"({st['fallback_reason']}), {len(banks)} banks")
    n_global = len(plan.global_rules)
    covered = sum(len(r) for r in plan.shard_rules)
    seen = set()
    for k, idxs in enumerate(plan.shard_rules):
        seen.update(idxs)
        if banks[k].n_rules != len(idxs) or \
                list(banks[k].local_to_global) != idxs:
            raise AssertionError(f"[16a] bank {k} holds {banks[k].n_rules} "
                                 f"rules, the plan {len(idxs)}")
    if covered != n_cfg + (SHARD_COUNT - 1) * n_global or \
            len(seen) != n_cfg:
        raise AssertionError(f"[16a] the plan covers {covered} rule slots "
                             f"({len(seen)} distinct) of {n_cfg} rules and "
                             f"{n_global} globals")
    bal = plan.balance()
    if bal["max_over_mean_cost"] > 2.0:
        raise AssertionError(f"[16a] shard balance {bal}")
    return bal


def shard_walls(serve, bags_by_b: dict) -> dict:
    """(a) check_many walls at each B (the first batch of each B, timed
    SHARD_ITERS times; every repeat equal to the first answer) and the
    shard stage split over the timed calls."""
    from istio_tpu_torch.runtime import monitor
    out = {}
    for b, batches in bags_by_b.items():
        first = serve(batches[0])
        base = monitor.shard_stage_baseline()
        r = timed_walls(lambda: serve(batches[0]), SHARD_ITERS)
        r["stages"] = monitor.shard_latency_snapshot(since=base)["stages"]
        compare_responses(f"[16a] B={b} repeat", serve(batches[0]), first)
        out[b] = r
        log(f"[16a] B={b:5d}: check_many {wall_line(r)}; stages "
            + ", ".join(f"{s} n={v['count']} sum {v['sum_ms']:.3f} ms "
                        f"p50 {v['p50_ms']:.3f} p99 {v['p99_ms']:.3f}"
                        for s, v in r["stages"].items()))
    return out


def lane_streams(srv) -> list:
    """Each replica lane's CUDA stream (its router's virtual device)."""
    return [r.lane.stream for r in srv.batcher.routers]


def both_lanes(srv, bags) -> list:
    """(a) `bags` submitted through the replica front from two threads
    at once (each thread half the rows, SHARD_LANE_WINDOW in flight at a
    time, well under each lane's queue cap); → the responses in
    order."""
    import threading
    out: list = [None] * len(bags)
    errors: list = []

    def submit(lo: int, hi: int) -> None:
        try:
            for w in range(lo, hi, SHARD_LANE_WINDOW):
                idx = range(w, min(w + SHARD_LANE_WINDOW, hi))
                futs = [srv.batcher.submit(bags[i]) for i in idx]
                for i, f in zip(idx, futs):
                    out[i] = f.result(timeout=300)
        except Exception as exc:   # noqa: BLE001 — re-raised below
            errors.append(exc)

    half = len(bags) // 2
    threads = [threading.Thread(target=submit, args=(0, half)),
               threading.Thread(target=submit, args=(half, len(bags)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError("[16a] a submitting thread hung")
    if errors:
        raise errors[0]
    return out


def routing_audit_leg(srv, routing: dict, rows: int) -> None:
    """Phase 16 (g): the audit plane's routing_conservation on the
    sharded card server: ok, its rows_total the rows the phase routed;
    a misrouted reading (routing_misrouted_skew) violated."""
    from istio_tpu_torch.runtime.audit import SEAMS
    chk = audit_check(srv.audit.evaluate(), "routing_conservation")
    ev = chk["evidence"]
    if chk["status"] != "ok" or not ev["enabled"] or \
            ev["rows_total"] != rows or \
            ev["rows_per_shard"] != routing["rows_per_shard"]:
        raise AssertionError(f"[16g] routing_conservation {chk}, routed "
                             f"{rows}")
    SEAMS.routing_misrouted_skew = 1
    try:
        bad = audit_check(srv.audit.evaluate(), "routing_conservation")
    finally:
        SEAMS.reset()
    if bad["status"] != "violated":
        raise AssertionError(f"[16g] routing_misrouted_skew: {bad}")
    log(f"[16g] audit routing_conservation ok: rows_total "
        f"{ev['rows_total']} = the rows routed, misrouted "
        f"{ev['misrouted']}; routing_misrouted_skew=1 → violated "
        f"({bad['note']})")


def shards_full() -> dict:
    """(a) + (b): make_fleet_store(100_000, 512) on a card server with
    8 shards behind 2 replica lanes, then a one-namespace constant edit
    republished on the same server."""
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.runtime.store import Event
    from istio_tpu_torch.testing import workloads
    from istio_tpu_torch.testing.workloads import _fleet_ns_assignment

    t0 = time.perf_counter()
    store = workloads.make_fleet_store(SHARD_RULES, SHARD_NAMESPACES,
                                       SHARD_SEED)
    store_s = time.perf_counter() - t0
    spy, comp = PlanSpy(), CompileSpy()
    srv = None
    try:
        t1 = time.perf_counter()
        srv = RuntimeServer(store, ServerArgs(
            shards=SHARD_COUNT, replicas=SHARD_REPLICAS,
            default_manifest=workloads.MESH_MANIFEST, **SHARD_ARGS),
            device="cuda")
        build_s = time.perf_counter() - t1
        parent = srv.controller.dispatcher.fused
        parent_s = srv.controller.last_publish_wall_s
        st = srv._sharded
        gen_s = st["build_wall_s"]
        bank_s = sorted(comp.walls)
        if spy.calls.get(id(parent)) or srv.controller.warm_parent_plans:
            raise AssertionError("[16a] the parent plan was warmed")
        bank_plans = {id(b.dispatcher.fused) for b in st["banks"]}
        if set(spy.calls) != bank_plans:
            raise AssertionError("[16a] not every bank plan was warmed "
                                 "before the lanes saw it")
        bal = shard_plan_checks(srv)
        log(f"[16a] make_fleet_store({SHARD_RULES}, {SHARD_NAMESPACES}) in "
            f"{store_s:.2f} s; server build {build_s:.2f} s: parent host "
            f"compile (snapshot, fused plan, never warmed) {parent_s:.2f} s, "
            f"sharded generation {gen_s:.2f} s, bank compiles "
            + ", ".join(f"{k}: {s:.2f} s" for k, s in bank_s)
            + f"; rules a bank {bal['rules_per_shard']}, namespaces a bank "
            f"{bal['namespaces_per_shard']}, max / mean cost "
            f"{bal['max_over_mean_cost']}")
        # every check_many of (a) goes through serve(), which counts
        # the rows the routers must account for
        served = [0]

        def serve(batch):
            served[0] += len(batch)
            return srv.check_many(batch)

        # -- serving: the same SHARD_ORACLE_ROWS rows served at each
        # batch size (as SHARD_ORACLE_ROWS / B batches, or leading a
        # larger batch), each size's answers held against one oracle
        # pass over them
        traffic = fleet_bags(max(SHARD_B) + SHARD_LANE_ROWS)
        sample = traffic[:SHARD_ORACLE_ROWS]
        fill = traffic[SHARD_ORACLE_ROWS:max(SHARD_B)]
        bags_by_b, got_by_b = {}, {}
        for b in SHARD_B:
            rows = sample + fill[:max(b - SHARD_ORACLE_ROWS, 0)]
            bags_by_b[b] = [rows[lo:lo + b] for lo in range(0, len(rows), b)]
            got_by_b[b] = [r for batch in bags_by_b[b]
                           for r in serve(batch)][:SHARD_ORACLE_ROWS]
        walls = shard_walls(serve, bags_by_b)
        t2 = time.perf_counter()
        denied = oracle_parity("[16a] oracle", srv, sample,
                               got_by_b[SHARD_B[0]])
        oracle_s = time.perf_counter() - t2
        for b in SHARD_B[1:]:
            compare_responses(f"[16a] B={b} against B={SHARD_B[0]}",
                              got_by_b[b], got_by_b[SHARD_B[0]])
        # -- both lanes at once, from two threads
        lane_bags = traffic[max(SHARD_B):]
        want = serve(lane_bags)
        r0 = [r.stats()["rows"] for r in srv.batcher.routers]
        t3 = time.perf_counter()
        lanes = both_lanes(srv, lane_bags)
        lane_s = time.perf_counter() - t3
        compare_responses("[16a] lane-served rows", lanes, want)
        r1 = [r.stats()["rows"] for r in srv.batcher.routers]
        streams = lane_streams(srv)
        if r1[1] == r0[1] or None in streams or \
                len(set(map(id, streams))) != SHARD_REPLICAS:
            raise AssertionError(f"[16a] lane 1 served {r1[1] - r0[1]} rows "
                                 "or a lane has no stream of its own")
        served[0] += SHARD_LANE_ROWS
        # -- the launches of one B = 2,048 batch
        cap_bags = bags_by_b[SHARD_B[-1]][0]
        trips = bank_trips(srv, cap_bags)
        spy.calls.clear()
        k0 = dict(kernels.launches)
        with kernels.launches.capture() as captured:
            serve(cap_bags)
        torch.cuda.synchronize()
        counts = {k: v - k0[k] for k, v in kernels.launches.items()
                  if v != k0[k]}
        n_trips = sum(trips.values())
        if spy.calls != trips or counts != {"rule_match": n_trips,
                                            "verdict_fold": n_trips,
                                            "check_pack": n_trips}:
            raise AssertionError(f"[16a] B=2048 launches {counts}, trips by "
                                 f"plan {spy.calls}, want {trips}")
        if id(parent) in spy.calls:
            raise AssertionError("[16a] the parent plan ran a trip")
        with uncounted():
            check_kernels(captured, st["banks"][0].dispatcher.fused.engine
                          .quota_counts.clone())
        routing = srv.batcher.routing_stats()
        if routing["misrouted"] or routing["rows_total"] != served[0]:
            raise AssertionError(f"[16a] routing {routing}, served "
                                 f"{served[0]}")
        log(f"[16a] the {len(sample)} rows served at each B equal to "
            f"oracle_check_statuses in status and global deny_rule "
            f"({denied} denied; {oracle_s:.2f} s) and to each other in every "
            f"field; "
            f"{SHARD_LANE_ROWS} rows through both lanes from two threads "
            f"({lane_s * 1e3:.1f} ms; lane rows {[b - a for a, b in zip(r0, r1)]}"
            f") equal to check_many; routing {json.dumps(routing)} = the "
            f"{served[0]} rows served; one B=2048 batch: {n_trips} bank trips, "
            f"launches {counts}, each equal to its plain version, none from "
            "the parent plan")
        routing_audit_leg(srv, routing, served[0])
        # -- (b) the one-namespace constant edit of scripts/delta_smoke.py
        plan0 = st["plan"]
        banks0 = {b.shard_id: b for b in st["banks"]}
        probe_i = next(i for i in range(0, SHARD_RULES, 12)
                       if i % 3 == 0 and i % 4 < 2)
        ns_of = _fleet_ns_assignment(SHARD_RULES, SHARD_NAMESPACES,
                                     SHARD_SEED)
        probe_ns = f"ns{int(ns_of[probe_i])}"
        probe = bag_from_mapping({
            "destination.service":
                f"svc{probe_i}.{probe_ns}.svc.cluster.local",
            "source.namespace": "probe-team", "source.user": "sidecar-probe",
            "request.method": "GET", "connection.mtls": True,
            "request.path": "/probe"})
        if srv.check_many([probe])[0].status_code != 7:
            raise AssertionError("[16b] the probe is not denied before the "
                                 "edit")
        key = ("rule", probe_ns, f"fleet{probe_i}")
        spec = dict(store.get(key))
        locked = f'"locked{probe_i % 5}"'
        spec["match"] = spec["match"].replace(locked, '"probe-team"')
        store.apply_events([Event(key, spec)], notify=False)
        comp.walls.clear()
        t4 = time.perf_counter()
        srv.controller.rebuild()
        rebuild_s = time.perf_counter() - t4
        st = srv._sharded
        rs = srv._rebuild_status
        want_shard = plan0.shard_of(probe_ns)
        stab = {"mode": "delta", "kept": len(plan0.ns_to_shard), "new": 0,
                "removed": 0, "moved": [], "moved_kept": [],
                "rebalance_budget": 0}
        carried = {b.shard_id: b for b in st["banks"]}
        if st["delta"]["recompiled"] != [want_shard] or \
                (rs["banks_reused"], rs["banks_recompiled"]) != \
                (SHARD_COUNT - 1, 1) or rs["errors"] or \
                [k for k, _ in comp.walls] != [want_shard] or \
                json.dumps(st["plan"].stability, sort_keys=True) != \
                json.dumps(stab, sort_keys=True) or \
                st["plan"].ns_to_shard != plan0.ns_to_shard:
            raise AssertionError(f"[16b] delta {st['delta']}, ledger {rs}, "
                                 f"compiled {comp.walls}, want shard "
                                 f"{want_shard}")
        for k, b in carried.items():
            same = b.dispatcher is banks0[k].dispatcher and \
                b.checker is banks0[k].checker
            if same == (k == want_shard):
                raise AssertionError(f"[16b] bank {k} carried {same}")
        if srv.check_many([probe])[0].status_code != 0:
            raise AssertionError("[16b] the probe still denies after the "
                                 "edit")
        got = srv.check_many(sample)
        denied_b = oracle_parity("[16b] oracle after the delta", srv,
                                 sample, got)
        log(f"[16b] probe fleet{probe_i} ({probe_ns}, shard {want_shard}) "
            f"edited: rebuild {rebuild_s:.2f} s (sharded generation "
            f"{st['build_wall_s']:.2f} s, the one bank compile "
            f"{comp.walls[0][1]:.2f} s); 1 bank recompiled, "
            f"{SHARD_COUNT - 1} carried as the same objects; plan stability "
            f"{json.dumps(st['plan'].stability)}; the probe flipped 7 -> 0; "
            f"(a)'s {len(sample)} rows equal to the oracle again "
            f"({denied_b} denied)")
        return {"rules": SHARD_RULES, "store_s": store_s,
                "build_s": build_s, "parent_compile_s": parent_s,
                "bank_compile_s": [s for _, s in bank_s],
                "sharded_build_s": gen_s, "walls": walls,
                "oracle_rows": len(sample), "oracle_s": oracle_s,
                "lane_ms": lane_s * 1e3, "trips_2048": n_trips,
                "rebuild_s": rebuild_s, "balance": bal}
    finally:
        spy.close()
        comp.close()
        if srv is not None:
            srv.close()
        store.close()


def shards_replica_only() -> dict:
    """(c) make_store(10_000) with shards=0 and replicas=2, telemetry on,
    beside a card server without replicas: lane 0 serves on the
    published dispatcher, lane 1 on its own plan; every response and the
    rule counts equal."""
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    from istio_tpu_torch.testing import workloads

    store = workloads.make_store(HEADLINE_RULES)
    store2 = workloads.make_store(HEADLINE_RULES)
    rep = RuntimeServer(store, ServerArgs(replicas=2, rulestats_drain_s=0),
                        device="cuda")
    one = RuntimeServer(store2, ServerArgs(rulestats_drain_s=0),
                        device="cuda")
    try:
        st = rep._sharded
        lanes = st["banks"]
        if st["mode"] != "replica-only" or \
                lanes[0].dispatcher is not rep.controller.dispatcher or \
                lanes[1].dispatcher.fused is lanes[0].dispatcher.fused:
            raise AssertionError(f"[16c] replica-only lanes: {st['mode']}")
        bags = served_traffic("headline", HEADLINE_RULES, 256, seed=160) + \
            served_traffic("hit", HEADLINE_RULES, 256, seed=161)
        before, before1 = rule_counts(rep), rule_counts(one)
        r0 = [r.stats()["rows"] for r in rep.batcher.routers]
        got = [f.result(timeout=300)
               for f in [rep.batcher.submit(b) for b in bags]]
        want = one.check_many(bags)
        compare_responses("[16c] replica lanes", got, want)
        r1 = [r.stats()["rows"] for r in rep.batcher.routers]
        if min(b - a for a, b in zip(r0, r1)) == 0:
            raise AssertionError(f"[16c] a lane served nothing: {r0} {r1}")
        compare_counts("[16c] rule counts", counts_since(rep, before),
                       counts_since(one, before1))
        log(f"[16c] make_store({HEADLINE_RULES}), shards=0 replicas=2: "
            f"{len(bags)} rows through both lanes (lane rows "
            f"{[b - a for a, b in zip(r0, r1)]}; lane 0 on the published "
            "dispatcher, lane 1 on its own plan) equal to a card server "
            "without replicas, rule counts equal (attach_lanes)")
        return {"lane_rows": [b - a for a, b in zip(r0, r1)]}
    finally:
        rep.close()
        one.close()
        store.close()
        store2.close()


def pair_servers(make_store, args: dict):
    """A card server and a device="cpu" server over their own copies of
    one store."""
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    stores = [make_store(), make_store()]
    card = RuntimeServer(stores[0], ServerArgs(**args), device="cuda")
    cpu = RuntimeServer(stores[1], ServerArgs(**args), device="cpu")
    return card, cpu, stores


def close_all(servers, stores) -> None:
    for s in servers:
        s.close()
    for s in stores:
        s.close()


def shards_unit() -> dict:
    """(d) tests/test_sharding.py's worlds on the card beside the CPU
    port: the pair world, the global quota leg, the RBAC fallback, a
    CHAOS fault on one bank and a fault CHAOS did not inject."""
    from istio_tpu_torch.adapters.sdk import QuotaArgs
    from istio_tpu_torch.attribute.bag import bag_from_mapping
    from istio_tpu_torch.runtime.resilience import CHAOS
    from istio_tpu_torch.sharding import oracle_check_statuses
    from istio_tpu_torch.testing import workloads

    mesh = workloads.MESH_MANIFEST
    out = {}
    # the pair world: 240 rules with host-overlay lists, 3 shards, 2 lanes
    card, cpu, stores = pair_servers(
        lambda: workloads.make_store(PAIR_RULES, host_overlay_every=10,
                                     seed=5),
        dict(shards=3, replicas=2, default_manifest=mesh, **PAIR_ARGS))
    try:
        dicts = workloads.make_request_dicts(64, seed=6) + \
            workloads.make_hit_requests(PAIR_RULES, 64, seed=7)[0]
        bags = [bag_from_mapping(d) for d in dicts]
        compare_responses("[16d] pair world check_many",
                          card.check_many(bags), cpu.check_many(bags))
        got = [f.result(timeout=300)
               for f in [card.batcher.submit(b) for b in bags]]
        compare_responses("[16d] pair world lanes", got, cpu.check_many(bags))
        if card.batcher.routing_stats()["misrouted"]:
            raise AssertionError("[16d] misrouted rows")
        out["pair_rows"] = 2 * len(bags)
    finally:
        close_all((card, cpu), stores)
    # the global quota leg: one pool for every bank, grants as the CPU's
    card, cpu, stores = pair_servers(
        lambda: workloads.make_fleet_store(60, 6, seed=4, with_quota=True),
        dict(shards=3, replicas=2, default_manifest=mesh,
             batch_window_s=0.001, buckets=(16,), max_batch=16))
    try:
        grants = []
        for d in workloads.make_fleet_traffic(12, 60, 6, seed=4):
            row = []
            for srv in (card, cpu):
                bag = bag_from_mapping(d)
                r = srv.check_many([bag])[0]
                q = srv.quota_fused(bag, "rq.istio-system",
                                    QuotaArgs(quota_amount=3), r)
                q = q.result() if hasattr(q, "result") else q
                row.append((q.granted_amount, q.status_code))
            if row[0] != row[1]:
                raise AssertionError(f"[16d] quota grants {row}")
            grants.append(row[0])
        if len({id(p) for p in card.controller.device_quotas.values()}) != 1:
            raise AssertionError("[16d] more than one quota pool")
        out["quota_grants"] = grants
    finally:
        close_all((card, cpu), stores)
    # an RBAC snapshot: replica-only lanes, and why
    card, cpu, stores = pair_servers(
        lambda: workloads.make_rbac_store(40),
        dict(shards=2, replicas=2, batch_window_s=0.001, buckets=(16,),
             max_batch=16))
    try:
        st = card._sharded
        if st["mode"] != "replica-only" or \
                "pseudo-rule" not in st["fallback_reason"] or \
                st["fallback_reason"] != cpu._sharded["fallback_reason"]:
            raise AssertionError(f"[16d] RBAC fallback: {st['mode']} "
                                 f"({st['fallback_reason']})")
        bags = [bag_from_mapping(d)
                for d in workloads.make_rbac_request_dicts(24)]
        compare_responses("[16d] RBAC replica-only", card.check_many(bags),
                          cpu.check_many(bags))
        out["rbac_reason"] = st["fallback_reason"]
    finally:
        close_all((card, cpu), stores)
    resilience_gate("[16d] before its fault legs")
    # faults on one bank: CHAOS opens that bank's breaker alone; a fault
    # CHAOS did not inject raises (the bank checkers are strict)
    store = workloads.make_fleet_store(90, 6, seed=6)
    from istio_tpu_torch.runtime import RuntimeServer, ServerArgs
    srv = RuntimeServer(store, ServerArgs(
        shards=2, device_retry=False, breaker_failures=1,
        breaker_reset_s=60.0, default_manifest=mesh,
        batch_window_s=0.001, buckets=(16,), max_batch=16), device="cuda")
    try:
        banks = srv._sharded["banks"]
        if not all(b.checker.strict_device for b in banks):
            raise AssertionError("[16d] a card bank checker is not strict")
        plan = srv._sharded["plan"]
        bags = [bag_from_mapping(d) for d in
                workloads.make_fleet_traffic(32, 90, 6, seed=6)]
        from istio_tpu_torch.runtime.dispatcher import _namespace_of
        shard = [plan.shard_of(_namespace_of(b, srv.args.identity_attr))
                 for b in bags]
        one = [b for b, s in zip(bags, shard) if s == shard[0]]
        healthy = srv.check_many(bags)
        victim = next(b for b in banks if b.shard_id == shard[0])

        def faulty(bags, deadline=None):
            raise RuntimeError("device fault (raised by chip_smoke)")

        real = victim.checker.device
        victim.checker.device = faulty
        try:
            srv.check_many(one)
        except RuntimeError as exc:
            if "raised by chip_smoke" not in str(exc):
                raise
        else:
            raise AssertionError("[16d] a real bank fault was answered")
        finally:
            victim.checker.device = real
        if any(b.checker.breaker.state != "closed" for b in banks):
            raise AssertionError("[16d] a real fault moved a breaker")
        resilience_gate("[16d] after the real fault")
        CHAOS.device_failures = 1
        try:
            got = srv.check_many(one)
            injected = CHAOS.injected_device
        finally:
            CHAOS.reset()
        states = {b.shard_id: b.checker.breaker.state for b in banks}
        d = srv.controller.dispatcher
        want = oracle_check_statuses(d.snapshot, d.fused, one)
        if injected != 1 or states[shard[0]] != "open" or \
                sorted(s for k, s in states.items() if k != shard[0]) != \
                ["closed"] or [r.status_code for r in got] != \
                [w["status"] for w in want]:
            raise AssertionError(f"[16d] CHAOS on bank {shard[0]}: injected "
                                 f"{injected}, breakers {states}")
        again = srv.check_many(bags)
        if [r.status_code for r in again] != \
                [r.status_code for r in healthy]:
            raise AssertionError("[16d] the open bank's oracle answers "
                                 "differ")
        out["chaos_bank"] = shard[0]
    finally:
        srv.close()
        store.close()
    # the CHAOS leg moved the resilience counters on purpose
    _GATE["base"] = resilience_reading()
    log(f"[16d] pair world ({PAIR_RULES} rules, 3 shards, 2 lanes): "
        f"{out['pair_rows']} card responses equal to the CPU port's field "
        f"by field; global quota: grants {out['quota_grants']} equal to the "
        "CPU's from one pool; RBAC: replica-only "
        f"({out['rbac_reason'][:60]}...); a fault CHAOS did not inject "
        "raised out of check_many with every breaker closed; a CHAOS fault "
        f"on bank {out['chaos_bank']} opened its breaker alone and its "
        "oracle answered")
    return out


def shards_phase() -> dict:
    """Phase 16: the sharded serving plane on the card, counters zeroed
    just before its drive and read just after: (a) + (b) the fleet world
    at full size with a delta, (c) replica-only lanes, (d) the unit-size
    worlds beside the CPU port."""
    from istio_tpu_torch import kernels
    t_phase = time.perf_counter()
    kernels.launches.reset()
    full = shards_full()
    resilience_gate("[16ab] end")
    t_c = time.perf_counter()
    replica = shards_replica_only()
    resilience_gate("[16c] end")
    t_d = time.perf_counter()
    unit = shards_unit()
    out = path_counts("[16] shards path", SHARD_KERNELS,
                      kernels.launches["check_pack"])
    seconds = time.perf_counter() - t_phase
    log(f"[t] phase 16 took {seconds:.1f} s ((a)+(b) {t_c - t_phase:.1f} s, "
        f"(c) {t_d - t_c:.1f} s, (d) {time.perf_counter() - t_d:.1f} s)")
    return {**out, "rows": [], "full": full, "replica": replica,
            "unit": unit, "seconds": seconds}


# ---- phase 17: the tail-latency forensics plane

# the card server of phase 17: scripts/forensics_smoke.py's lane breaker
# (2 failures, a 0.4 s window) and the timed batch sizes as buckets
FORENSICS_ARGS = dict(host_breaker_failures=2, host_breaker_reset_s=0.4,
                      buckets=(64, 256))
FORENSICS_CLEAN = (64, 20)       # (a): batch size, batches
FORENSICS_QUIET_MS = 10_000.0    # (a), (e): a threshold no batch reaches
# (b): scripts/forensics_smoke.py:53-56
FORENSICS_WEDGE_MS = 250.0
FORENSICS_DEADLINE_S = 0.6
FORENSICS_WEDGE_ROWS = 8         # cilist rows a wedged batch
FORENSICS_SWAP_MS = 0.001        # (c): every batch captured
FORENSICS_AFTER_PUBLISH_S = 1.0  # (c): traffic kept up past the publish
FORENSICS_PROFILE_S = 1.0        # (d)
FORENSICS_B = 256                # (d), (e), (g)
FORENSICS_ROUNDS = 7             # (e): interleaved rounds of the 3 modes
FORENSICS_CALLS = 1              # (e): timed calls a mode a round
FORENSICS_PROFILED = ("rule_match", "verdict_fold", "check_pack")


def forensics_events(kind: str, since: float) -> list:
    """The event ring's `kind` events stamped after perf_counter
    `since`."""
    from istio_tpu_torch.runtime import forensics
    return [e for e in forensics.EVENTS.snapshot(kind, limit=0)
            if e["t"] >= since]


def stage_sum_ok(ex: dict) -> bool:
    """An exemplar's stages (each rounded to 1 µs) sum to at most its
    e2e, within their rounding."""
    return sum(ex["stages_ms"].values()) <= \
        ex["e2e_ms"] + 1e-3 * (len(ex["stages_ms"]) + 1)


def trace_kernels(path: str) -> dict:
    """Kernel events of a Chrome trace → {csrc/ source: count} of the
    hand-written ones, and the others under None."""
    with open(path) as f:
        trace = json.load(f)
    table = hand_written()
    out: dict = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("cat") != "kernel":
            continue
        src, _ = source_of_event(ev.get("name", ""), table)
        out[src] = out.get(src, 0) + 1
    return out


def forensics_overhead(srv, bags) -> dict:
    """(e): check_many(bags) walls with the recorder off, on at a 10 s
    threshold and on at the default one (the SLO target: every batch
    captured), FORENSICS_ROUNDS interleaved rounds of FORENSICS_CALLS
    calls a mode (the order reversed every other round) → per mode the
    median and p99 wall, each "on" mode's forensics_overhead_pct against
    "off", the exemplars captured, and the host time of the recorder's
    completion note a batch (note_direct: the threshold compare and, over
    it, the exemplar build and event-ring scan), timed around the call."""
    import numpy as np
    from istio_tpu_torch.runtime import forensics, monitor
    rec = forensics.RECORDER
    note = rec.note_direct
    note_s: list = []

    def timed_note(e2e_s, rows):
        t = time.perf_counter()
        note(e2e_s, rows)
        note_s.append(time.perf_counter() - t)

    modes = {"off": dict(enabled=False),
             "on_10s": dict(enabled=True, threshold_ms=FORENSICS_QUIET_MS),
             "on_default": dict(enabled=True, threshold_ms=0.0)}
    walls: dict = {m: [] for m in modes}
    notes: dict = {m: [] for m in modes}
    captured = {m: 0 for m in modes}
    for _ in range(2):
        srv.check_many(bags)
    rec.note_direct = timed_note
    try:
        for r in range(FORENSICS_ROUNDS):
            for m in (modes if r % 2 == 0 else list(reversed(modes))):
                rec.configure(**modes[m])
                c0 = monitor.forensics_counters()["slow_captured"]
                for _ in range(FORENSICS_CALLS):
                    t = time.perf_counter()
                    srv.check_many(bags)
                    walls[m].append((time.perf_counter() - t) * 1e3)
                captured[m] += \
                    monitor.forensics_counters()["slow_captured"] - c0
                notes[m] += note_s
                note_s.clear()
    finally:
        del rec.note_direct
    rec.configure(enabled=True, threshold_ms=0.0)
    out = {m: {"p50_ms": float(np.median(w)),
               "p99_ms": float(np.percentile(w, 99)),
               "exemplars": captured[m], "calls": len(w),
               "note_us": float(np.mean(notes[m])) * 1e6}
           for m, w in walls.items()}
    for m in ("on_10s", "on_default"):
        out[m]["forensics_overhead_pct"] = \
            (out[m]["p50_ms"] / out["off"]["p50_ms"] - 1.0) * 100.0
    return out


def forensics_phase() -> dict:
    """Phase 17: the tail-latency forensics plane on the card, the launch
    counters zeroed just before its drive and read just after: (a) clean
    traffic silent, (g) a recorded batch equal to the CPU server's with
    its launches held against their plain versions, (b) a wedged adapter
    attributed, (c) a config swap annotated, (d) a torch.profiler
    capture that sees the kernels, (e) the recorder's overhead, (f) the
    SLO scorecard."""
    import tempfile
    import threading
    import torch
    from istio_tpu_torch import kernels
    from istio_tpu_torch.runtime import (RuntimeServer, ServerArgs,
                                         forensics, monitor, slo)
    from istio_tpu_torch.runtime.resilience import CHAOS
    from istio_tpu_torch.testing import workloads

    t_phase = time.perf_counter()
    rec = forensics.RECORDER
    ci = HOST_HANDLERS[0]
    profile_dir = tempfile.mkdtemp(prefix="chip-smoke-profile-")
    store = workloads.make_store(HEADLINE_RULES, host_overlay_every=5)
    cpu_store = workloads.make_store(HEADLINE_RULES, host_overlay_every=5)
    srv = RuntimeServer(store, ServerArgs(
        slow_threshold_ms=FORENSICS_QUIET_MS, profile_dir=profile_dir,
        **FORENSICS_ARGS), device="cuda")
    cpu = RuntimeServer(cpu_store, ServerArgs(
        host_executor=False, **{**CPU_SERVER, "buckets": (64, 256)}),
        device="cpu")
    legs: dict = {}
    try:
        rs = srv.controller.dispatcher.snapshot.ruleset
        trip = served_trip(rs)
        required = tuple(k for k, v in trip.items() if v)
        clean = overlay_traffic(FORENSICS_CLEAN[0], HEADLINE_RULES)[0]
        big = workloads.make_bags(FORENSICS_B, seed=1)
        ci_bags = [b for b, h in zip(*overlay_traffic(
            3 * FORENSICS_WEDGE_ROWS, HEADLINE_RULES)) if h == ci]
        built_s = time.perf_counter() - t_phase
        log(f"[17] card server {FORENSICS_ARGS} and an inline CPU server "
            f"on make_store({HEADLINE_RULES}, host_overlay_every=5) built "
            f"in {built_s:.2f} s; recorder armed from ServerArgs at "
            f"{rec.snapshot()['threshold_ms']} ms")

        kernels.launches.reset()
        steps = 0
        # (a) clean traffic at a threshold no batch reaches: silent
        t_leg = time.perf_counter()
        rec.configure(enabled=True, threshold_ms=FORENSICS_QUIET_MS)
        rec.reset()
        base = monitor.forensics_counters()
        walls = []
        for _ in range(FORENSICS_CLEAN[1]):
            t = time.perf_counter()
            srv.check_many(clean)
            walls.append((time.perf_counter() - t) * 1e3)
            steps += 1
        now = monitor.forensics_counters()
        if now["slow_captured"] != base["slow_captured"] or \
                now["dropped"] != base["dropped"] or \
                rec.snapshot()["retained"]:
            raise AssertionError(f"[17a] clean traffic at "
                                 f"{FORENSICS_QUIET_MS} ms: counters "
                                 f"{base} -> {now}")
        legs["a"] = time.perf_counter() - t_leg
        log(f"[17a] {FORENSICS_CLEAN[1]} clean batches of B="
            f"{FORENSICS_CLEAN[0]} (walls {min(walls):.2f}-"
            f"{max(walls):.2f} ms) at a {FORENSICS_QUIET_MS:.0f} ms "
            f"threshold: 0 exemplars, drops {now['dropped']} unchanged")

        # (g) one recorded batch equal to the CPU server's, its launches
        # held against their plain versions
        t_leg = time.perf_counter()
        rec.configure(threshold_ms=0.0)
        rec.reset()
        plan = srv.controller.dispatcher.fused
        quota0 = plan.engine.quota_counts.clone()
        with kernels.launches.capture() as probe:
            got = srv.check_many(big)
        steps += 1
        torch.cuda.synchronize()
        ex = rec.snapshot()["slowest"]
        compare_responses(f"[17g] B={FORENSICS_B} recorder on", got,
                          cpu.check_many(big))
        if len(ex) != 1 or ex[0]["rows"] != FORENSICS_B:
            raise AssertionError(f"[17g] the recorded batch: {ex}")
        seen = sorted({n for n, _ in probe})
        if not set(FORENSICS_PROFILED) <= set(seen):
            raise AssertionError(f"[17g] the trip launched {seen}")
        with uncounted():
            check_kernels(probe, quota0)
        legs["g"] = time.perf_counter() - t_leg
        log(f"[17g] B={FORENSICS_B} with the recorder on at "
            f"{ex[0]['threshold_ms']} ms: every response equal to the CPU "
            f"server's; captured ({ex[0]['e2e_ms']} ms, top stage "
            f"{ex[0]['top_stage']}, stages {ex[0]['stages_ms']}); the "
            f"trip's {len(probe)} launches ({', '.join(seen)}) equal their "
            "plain versions")

        # (b) a wedged adapter: attributed to its lane's host wait
        t_leg = time.perf_counter()
        rec.configure(threshold_ms=FORENSICS_WEDGE_MS)
        rec.reset()
        t_wedge = time.perf_counter()
        CHAOS.wedge_adapter(ci)
        try:
            codes = []
            for _ in range(3):
                dl = time.perf_counter() + FORENSICS_DEADLINE_S
                futs = [srv.batcher.submit(b, deadline=dl)
                        for b in ci_bags]
                codes += [f.result().status_code for f in futs]
                steps += 1
        finally:
            CHAOS.unwedge_adapter(ci)
        slow = rec.snapshot(top_k=64)["slowest"]
        hosts = [x for x in slow if x["top_stage"] == "host:" + ci]
        attributed = [x for x in hosts
                      if x["e2e_ms"] >= FORENSICS_WEDGE_MS
                      and stage_sum_ok(x)
                      and {e["kind"] for e in x["events"]}
                      & {"chaos_wedge", "breaker"}]
        if not attributed:
            raise AssertionError(f"[17b] no exemplar attributed to the "
                                 f"wedge: {slow}")
        brk = [e["detail"] for e in forensics_events("breaker", t_wedge)]
        # the lane's half-open probe closes it again
        time.sleep(FORENSICS_ARGS["host_breaker_reset_s"] + 0.05)
        srv.check_many(ci_bags[:1])
        steps += 1
        lane = srv.executor.lane(ci).breaker.state
        if lane != "closed":
            raise AssertionError(f"[17b] the {ci} lane stayed {lane}")
        ex = attributed[0]
        legs["b"] = time.perf_counter() - t_leg
        log(f"[17b] {ci} wedged, 3 batches of {len(ci_bags)} rows under a "
            f"{FORENSICS_DEADLINE_S * 1e3:.0f} ms deadline (statuses "
            f"{sorted(set(codes))}): {len(hosts)} exemplar(s) with top "
            f"stage host:{ci} at {FORENSICS_WEDGE_MS:.0f} ms, e.g. e2e "
            f"{ex['e2e_ms']} ms, stages {ex['stages_ms']}, events "
            f"{sorted({e['kind'] for e in ex['events']})}; breaker events "
            f"{brk}; the lane closed again after its probe")
        # the wedge moved the host ledger on purpose (overruns, an open
        # lane): the gate counts from here
        _GATE["base"] = resilience_reading()

        # (c) a config swap under traffic: publish and prewarm annotated
        t_leg = time.perf_counter()
        rec.configure(threshold_ms=FORENSICS_SWAP_MS)
        rec.reset()
        rev0 = srv.controller.dispatcher.snapshot.revision
        stop = threading.Event()
        served_n = [0]
        errors: list = []

        def drive() -> None:
            try:
                while not stop.is_set():
                    srv.check_many(clean)
                    served_n[0] += 1
            except Exception as exc:
                errors.append(exc)

        t = threading.Thread(target=drive, name="forensics-drive")
        t.start()
        t_pub0 = time.perf_counter()
        try:
            store.set(("handler", "istio-system", "denyall"), {
                "adapter": "denier",
                "params": {"status_code": 14, "valid_duration_s": 1.5}})
            while srv.controller.dispatcher.snapshot.revision == rev0:
                if time.perf_counter() - t_pub0 > 120 or errors:
                    raise AssertionError(f"[17c] no publish: {errors}")
                time.sleep(0.005)
            t_pub = time.perf_counter()
            time.sleep(FORENSICS_AFTER_PUBLISH_S)
        finally:
            stop.set()
            t.join()
        if errors:
            raise errors[0]
        steps += served_n[0]
        rev1 = srv.controller.dispatcher.snapshot.revision
        pubs = [e["detail"] for e in forensics_events("config_publish",
                                                      t_pub0)]
        warms = forensics_events("prewarm", t_pub0)
        swap_ex = [x for x in rec.snapshot(top_k=256)["slowest"]
                   if {e["kind"] for e in x["events"]}
                   & {"config_publish", "prewarm"}]
        if not any(p["generation"] == rev1 for p in pubs) or not warms \
                or not swap_ex:
            raise AssertionError(
                f"[17c] publishes {pubs}, {len(warms)} prewarm events, "
                f"{len(swap_ex)} annotated exemplars (revision {rev1})")
        legs["c"] = time.perf_counter() - t_leg
        log(f"[17c] store change published as generation {rev1} "
            f"{t_pub - t_pub0:.2f} s after store.set (rebuild + warm "
            f"{srv.controller.last_publish_wall_s:.2f} s) under "
            f"check_many B={FORENSICS_CLEAN[0]} traffic ({served_n[0]} "
            f"batches, served {FORENSICS_AFTER_PUBLISH_S} s past the "
            f"publish): config_publish {pubs[-1]}, {len(warms)} prewarm "
            f"events, {len(swap_ex)} of "
            f"{rec.snapshot()['retained']} exemplars annotated with them")

        # (d) a torch.profiler capture while a thread serves B = 256
        t_leg = time.perf_counter()
        stop = threading.Event()
        served_n = [0]
        errors = []

        def serve_big() -> None:
            try:
                while not stop.is_set():
                    srv.check_many(big)
                    served_n[0] += 1
            except Exception as exc:
                errors.append(exc)

        t = threading.Thread(target=serve_big, name="forensics-serve")
        t.start()
        try:
            time.sleep(0.05)
            prof = srv.capture_profile(FORENSICS_PROFILE_S)
            stacks = forensics.thread_stacks()
        finally:
            stop.set()
            t.join()
        if errors:
            raise errors[0]
        steps += served_n[0]
        if not prof.get("available"):
            raise AssertionError(f"[17d] capture failed on the card: "
                                 f"{prof}")
        path = os.path.join(prof["dir"], forensics.TRACE_FILE)
        seen_k = trace_kernels(path)
        missing = [k for k in FORENSICS_PROFILED if not seen_k.get(k)]
        names = {x["name"] for x in stacks["threads"]}
        if missing or "check-batcher" not in names:
            raise AssertionError(f"[17d] trace kernels {seen_k}, missing "
                                 f"{missing}; threads {sorted(names)}")
        legs["d"] = time.perf_counter() - t_leg
        log(f"[17d] capture_profile({FORENSICS_PROFILE_S} s) while a "
            f"thread served {served_n[0]} batches of B={FORENSICS_B}: "
            f"wall {prof['wall_s']} s, {prof['n_files']} file(s), "
            f"{prof['bytes_total']:,} bytes; kernel events by source "
            f"{json.dumps({str(k): v for k, v in seen_k.items()})}; "
            f"{stacks['n_threads']} thread stacks, the batcher's among "
            "them")

        # (e) the recorder's cost on the headline B = 256 batch
        t_leg = time.perf_counter()
        over = forensics_overhead(srv, big)
        steps += 2 + 3 * FORENSICS_ROUNDS * FORENSICS_CALLS
        legs["e"] = time.perf_counter() - t_leg
        log(f"[17e] check_many B={FORENSICS_B}, {FORENSICS_ROUNDS} "
            f"interleaved rounds of {FORENSICS_CALLS} calls a mode: "
            + "; ".join(f"{m} p50 {r['p50_ms']:.4f} ms p99 "
                        f"{r['p99_ms']:.4f} ms, {r['exemplars']} exemplars, "
                        f"completion note {r['note_us']:.1f} µs a batch"
                        + (f", forensics_overhead_pct "
                           f"{r['forensics_overhead_pct']:.2f}"
                           if "forensics_overhead_pct" in r else "")
                        for m, r in over.items()))
        out = path_counts("[17] forensics path", required, steps)

        # (f) the SLO scorecard
        card = slo.scorecard(monitor, forensics)
        if card["planes"]["check_wire"]["verdict"] == "no_data":
            raise AssertionError(f"[17f] scorecard {card}")
        log("[17f] scorecard: overall " + card["overall"] + "; " + ", ".join(
            f"{k} {v['verdict']}" for k, v in card["planes"].items())
            + "; check_wire " + json.dumps(
                {k: v for k, v in card["planes"]["check_wire"].items()
                 if k != "verdict"}))
        t_leg = time.perf_counter()
        au = audit_phase(srv, cpu, big, ci_bags, required)
        legs["17b"] = time.perf_counter() - t_leg
    finally:
        CHAOS.reset()
        rec.configure(enabled=True, threshold_ms=0.0)
        for x in (srv, cpu, store, cpu_store):
            x.close()
        import shutil
        shutil.rmtree(profile_dir, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    log(f"[t] phase 17 took {seconds:.1f} s (build {built_s:.1f} s, "
        + ", ".join(f"({k}) {v:.1f} s" for k, v in legs.items()) + ")")
    return {**out, "rows": [], "overhead": over, "scorecard": card,
            "legs": legs, "seconds": seconds, "audit": au}



# ---- phase 17b: the mesh audit plane, on phase 17's servers

AUDIT_REPORT_ROWS = 64         # (a): report() rows drained before the read
AUDIT_WEDGE_CHECKS = 6         # (b): scripts/audit_smoke.py's wedged checks
AUDIT_DEVICE_FAULTS = 3        # (b): injected device-step failures
AUDIT_DEVICE_CHECKS = 6        # (b): checks sent under them
AUDIT_SEAM_SKEW = 7            # (c): report_accepted_skew
AUDIT_COST_CALLS = 30          # (h): check_many calls a mode
AUDIT_COST_INTERVAL_S = 0.2    # (h): the auditor's interval when on
# evidence fields that follow the evaluation history, not the served state
AUDIT_VOLATILE = ("frozen_s", "stuck_evaluations", "memoized", "sampled")


def audit_check(snap: dict, name: str) -> dict:
    return next(c for c in snap["checks"] if c["name"] == name)


def audit_view(snap: dict) -> dict:
    """Each invariant's status and evidence, less walls and the fields
    that follow the evaluation history (AUDIT_VOLATILE)."""
    return {c["name"]: (c["status"],
                        {k: v for k, v in c["evidence"].items()
                         if k not in AUDIT_VOLATILE})
            for c in snap["checks"]}


def fresh_quota_check(aud) -> dict:
    """quota_conservation from an evaluate() that reads the pools: the
    auditor reads them every quota_every-th evaluation, so with
    quota_every 1 every evaluation does."""
    every = aud.quota_every
    aud.quota_every = 1
    try:
        return audit_check(aud.evaluate(), "quota_conservation")
    finally:
        aud.quota_every = every


def audit_phase(srv, cpu, big: list, ci_bags: list, required: tuple) -> dict:
    """Phase 17b: the mesh audit plane on phase 17's overlay card server
    (and its CPU twin), the launch counters zeroed just before its drive
    and read just after: (a) clean traffic drained → six invariants ok,
    no violation counted, explainability vacuous, the audit plane of the
    scorecard ok, the card's snapshot equal to the CPU server's; (b) a
    wedged cilist lane and injected device faults, both explained by
    named evidence; (c) a skewed report counter caught as violated with
    its evidence and event, then recovered; (h) check_many walls with the
    auditor on at AUDIT_COST_INTERVAL_S and stopped (audit_overhead_pct)."""
    import numpy as np
    from istio_tpu_torch import kernels
    from istio_tpu_torch.runtime import forensics, monitor, slo
    from istio_tpu_torch.runtime.audit import INJECTIONS, SEAMS
    from istio_tpu_torch.runtime.resilience import CHAOS

    t_phase = time.perf_counter()
    ci = HOST_HANDLERS[0]
    aud = srv.audit
    legs: dict = {}
    if aud is None or cpu.audit is None or \
            not aud.snapshot()["running"]:
        raise AssertionError("[17b] the default servers run no auditor")
    earlier = INJECTIONS.evaluate(aud.explain_window_s)
    log(f"[17b] the injection ledger over phases 5-17 before its reset: "
        f"rate {earlier['rate']}, {earlier['matched']} matched, "
        f"{earlier['unexplained']} unexplained, {earlier['pending']} "
        "pending")
    INJECTIONS.reset()
    SEAMS.reset()
    kernels.launches.reset()
    steps = 0

    # (a) clean: phase 17's traffic and a report() drained, then read
    t_leg = time.perf_counter()
    base = monitor.audit_counters()
    srv.check_many(big)
    cpu.check_many(big)
    srv.report(big[:AUDIT_REPORT_ROWS])
    cpu.report(big[:AUDIT_REPORT_ROWS])
    steps += 2
    end = time.perf_counter() + 20.0
    while monitor.report_conservation()["in_flight"]:
        if time.perf_counter() > end:
            raise AssertionError(f"[17b a] reports never drained: "
                                 f"{monitor.report_conservation()}")
        time.sleep(0.02)
    t = time.perf_counter()
    snap = aud.evaluate()
    eval_ms = (time.perf_counter() - t) * 1e3
    cpu_snap = cpu.audit.evaluate()
    now = monitor.audit_counters()
    bad = {c["name"]: c for c in snap["checks"] if c["status"] != "ok"}
    ex = snap["explainability"]
    card = slo.scorecard(monitor, forensics, audit=snap)
    if bad or not snap["healthy"] or now["violations"] != base["violations"] \
            or (ex["rate"], ex["matched"], ex["unexplained"]) != (1.0, 0, 0) \
            or card["planes"]["audit"]["verdict"] != "ok":
        raise AssertionError(
            f"[17b a] clean: not ok {bad}; healthy {snap['healthy']}; "
            f"violations {base['violations']} -> {now['violations']}; "
            f"explainability {ex}; scorecard {card['planes']['audit']}")
    if audit_view(snap) != audit_view(cpu_snap):
        raise AssertionError(f"[17b a] card {audit_view(snap)} != CPU "
                             f"{audit_view(cpu_snap)}")
    cons = audit_check(snap, "report_conservation")["evidence"]
    quota = audit_check(snap, "quota_conservation")["evidence"]
    planes = audit_check(snap, "plane_agreement")["evidence"]
    legs["a"] = time.perf_counter() - t_leg
    log(f"[17b a] clean: {len(big)} checks and {AUDIT_REPORT_ROWS} report "
        f"rows a server, drained (accepted {cons['accepted']} = exported "
        f"{cons['exported']} + rejected {cons['rejected_total']}); "
        f"evaluate() {eval_ms:.2f} ms: six invariants ok, violations "
        "unmoved, explainability 1.0 with no injection, scorecard audit "
        f"ok (overall {card['overall']}); {planes['n_pairs']} plane pairs; "
        f"pools {json.dumps(quota['device_pools'])}; the card's snapshot "
        "equal to the CPU server's in every status and evidence")

    # (b) chaos: a wedged cilist lane, then injected device faults. The
    # gate first closes phase 17's legs and 17b (a)
    resilience_gate("[17b] before its chaos")
    t_leg = time.perf_counter()
    CHAOS.wedge_adapter(ci)
    codes = []
    try:
        for k in range(AUDIT_WEDGE_CHECKS):
            codes.append(srv.check(ci_bags[k % len(ci_bags)], deadline=(
                time.perf_counter() + FORENSICS_DEADLINE_S)).status_code)
            steps += 1
    finally:
        CHAOS.unwedge_adapter(ci)
    fb0 = monitor.resilience_counters()["fallback_total"]
    CHAOS.device_failures = AUDIT_DEVICE_FAULTS
    try:
        for b in big[:AUDIT_DEVICE_CHECKS]:
            codes.append(srv.check(b).status_code)
            steps += 1
    finally:
        CHAOS.reset()
    fallbacks = monitor.resilience_counters()["fallback_total"] - fb0
    time.sleep(0.3)
    snap = aud.evaluate()
    ex = snap["explainability"]
    matched = {r["kind"]: r["matched_by"] for r in ex["records"]
               if r["matched"]}
    if set(matched) != {"wedge", "device"} or not all(matched.values()) \
            or ex["rate"] != 1.0 or ex["unexplained"] or ex["pending"]:
        raise AssertionError(f"[17b b] chaos explainability {ex}")
    # the lane's half-open probe closes it again
    time.sleep(FORENSICS_ARGS["host_breaker_reset_s"] + 0.05)
    srv.check_many(ci_bags[:1])
    steps += 1
    lane = srv.executor.lane(ci).breaker.state
    if lane != "closed":
        raise AssertionError(f"[17b b] the {ci} lane stayed {lane}")
    legs["b"] = time.perf_counter() - t_leg
    log(f"[17b b] {ci} wedged for {AUDIT_WEDGE_CHECKS} checks at a "
        f"{FORENSICS_DEADLINE_S * 1e3:.0f} ms deadline, then "
        f"device_failures={AUDIT_DEVICE_FAULTS} over {AUDIT_DEVICE_CHECKS} "
        f"checks ({fallbacks} answered by the oracle; statuses "
        f"{sorted(set(codes))}): explained {json.dumps(matched)}, rate "
        f"{ex['rate']}, {ex['unexplained']} unexplained; the lane closed "
        "again after its probe")
    # the wedge and the faults moved the host ledger and the fallbacks on
    # purpose: the gate counts from here
    _GATE["base"] = resilience_reading()

    # (c) a skewed report counter: violated within the stuck window
    t_leg = time.perf_counter()
    t_seam = time.perf_counter()
    SEAMS.report_accepted_skew = AUDIT_SEAM_SKEW
    try:
        end = time.perf_counter() + aud.stuck_floor_s + 10.0
        rc = audit_check(aud.evaluate(), "report_conservation")
        while rc["status"] != "violated" and time.perf_counter() < end:
            time.sleep(0.2)
            rc = audit_check(aud.evaluate(), "report_conservation")
        caught_s = time.perf_counter() - t_seam
        snap = aud.snapshot()
        events = [e["detail"] for e in forensics_events("audit_violation",
                                                        t_seam)
                  if e["detail"].get("invariant") == "report_conservation"]
        card = slo.scorecard(monitor, forensics, audit=snap)
        if rc["status"] != "violated" or snap["healthy"] or \
                rc["evidence"]["in_flight"] != AUDIT_SEAM_SKEW or \
                not events or card["planes"]["audit"]["verdict"] != "miss":
            raise AssertionError(
                f"[17b c] skew {AUDIT_SEAM_SKEW}: {rc}; healthy "
                f"{snap['healthy']}; events {events}; scorecard "
                f"{card['planes']['audit']}")
    finally:
        SEAMS.reset()
    snap = aud.evaluate()
    if audit_check(snap, "report_conservation")["status"] != "ok" or \
            not snap["healthy"]:
        raise AssertionError(f"[17b c] no recovery: {audit_view(snap)}")
    legs["c"] = time.perf_counter() - t_leg
    log(f"[17b c] report_accepted_skew={AUDIT_SEAM_SKEW}: violated after "
        f"{caught_s:.2f} s (stuck_floor_s {aud.stuck_floor_s}, "
        f"{rc['evidence']['stuck_evaluations']} frozen evaluations), "
        f"in_flight {rc['evidence']['in_flight']}, healthy false, "
        f"audit_violation event {events[0]}, scorecard audit miss; ok and "
        "healthy again once the seam cleared")

    # (h) the auditor's cost on the served batch
    t_leg = time.perf_counter()
    cpu.audit.stop()
    aud.stop()
    interval = aud.interval_s
    aud.interval_s = AUDIT_COST_INTERVAL_S
    walls: dict = {"on": [], "off": []}
    evals_on = 0
    try:
        for _ in range(2):
            srv.check_many(big)
        for mode in ("on", "off", "off", "on"):
            if mode == "on":
                aud.start()
                e0 = aud.snapshot()["evaluations"]
                while aud.snapshot()["evaluations"] == e0:
                    time.sleep(0.005)   # the auditor is cycling
                e0 = aud.snapshot()["evaluations"]
            for _ in range(AUDIT_COST_CALLS // 2):
                t = time.perf_counter()
                srv.check_many(big)
                walls[mode].append((time.perf_counter() - t) * 1e3)
            if mode == "on":
                evals_on += aud.snapshot()["evaluations"] - e0
                aud.stop()
        steps += 2 + 2 * AUDIT_COST_CALLS
        eval_walls = []
        for _ in range(5):
            t = time.perf_counter()
            aud.evaluate()
            eval_walls.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        fresh_quota_check(aud)
        quota_ms = (time.perf_counter() - t) * 1e3
        # phase 17's servers attach no discovery service: attaching none
        # only makes the next evaluation recompute the plane check
        aud.attach_discovery(None)
        t = time.perf_counter()
        aud.evaluate()
        plane_ms = (time.perf_counter() - t) * 1e3
    finally:
        aud.interval_s = interval
        aud.start()
    p50 = {m: float(np.median(w)) for m, w in walls.items()}
    cost = {"p50_ms": p50,
            "p99_ms": {m: float(np.percentile(w, 99))
                       for m, w in walls.items()},
            "audit_overhead_pct": (p50["on"] / p50["off"] - 1.0) * 100.0,
            "evaluations_during_on": evals_on,
            "evaluate_ms": float(np.median(eval_walls)),
            "evaluate_quota_ms": quota_ms, "evaluate_plane_ms": plane_ms}
    legs["h"] = time.perf_counter() - t_leg
    log(f"[17b h] check_many B={len(big)}, {AUDIT_COST_CALLS} calls a mode "
        f"(on, off, off, on): auditor on at {AUDIT_COST_INTERVAL_S} s p50 "
        f"{p50['on']:.4f} ms p99 {cost['p99_ms']['on']:.4f} ms "
        f"({evals_on} evaluations inside the on windows), stopped p50 "
        f"{p50['off']:.4f} ms p99 {cost['p99_ms']['off']:.4f} ms: "
        f"audit_overhead_pct {cost['audit_overhead_pct']:.2f}; one "
        f"memoized evaluate() {cost['evaluate_ms']:.3f} ms, one that "
        f"reads the pool {quota_ms:.3f} ms, one that recomputes the "
        f"plane check {plane_ms:.3f} ms")
    out = path_counts("[17b] audit path", required, steps)
    seconds = time.perf_counter() - t_phase
    log(f"[t] phase 17b took {seconds:.1f} s ("
        + ", ".join(f"({k}) {v:.1f} s" for k, v in legs.items()) + ")")
    return {**out, "rows": [], "cost": cost, "legs": legs,
            "seconds": seconds}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    try:
        from istio_tpu_torch import kernels
        from istio_tpu_torch.testing import workloads
    except ImportError as exc:
        print(f"chip_smoke: the istio_tpu_torch package is not beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()

    # ---- phase 1: the card
    card = smi("name,power.limit")
    int_rate, int_how = int_ops_per_s()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"int32 peak {int_rate:.4g} op/s ({int_how})")

    track_lanes()
    log(f"[t] phase 2 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 2: build
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"[2] built {len(built)} kernels in "
        f"{time.perf_counter() - t0:.2f} s (parallel nvcc, sm_90a)")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    _GATE["base"] = resilience_reading()

    log(f"[t] phase 3 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 3: each kernel against its plain version, main-path inputs
    t0 = time.perf_counter()
    eng = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                device="cuda")
    log(f"[3] make_engine({HEADLINE_RULES}) host compile "
        f"{time.perf_counter() - t0:.2f} s; geometry "
        f"{json.dumps(eng.ruleset.geometry)}")
    table = None
    for traffic, (bags, req) in (
            ("headline", headline_batch(eng, HEADLINE_B)),
            ("hit", hit_batch(eng, HEADLINE_RULES, HEADLINE_B, seed=100))):
        batch = eng.tensorizer.tensorize(bags).to("cuda")
        eng.check(batch, req)                 # warm quota state
        quota_before = eng.quota_counts.clone()
        with kernels.launches.capture() as captured:
            eng.check(batch, req)
        torch.cuda.synchronize()
        names = sorted({n for n, _ in captured})
        if names != sorted(ENGINE_KERNELS):
            raise AssertionError(f"engine step launched {names}, want all "
                                 f"of {sorted(ENGINE_KERNELS)}")
        log(f"[3] {traffic} traffic, B={HEADLINE_B}: "
            f"{len(captured)} captured launches"
            + (", timed:" if table is None else ", parity only"))
        rows = check_kernels(captured, quota_before,
                             int_rate if table is None else None)
        table = table or rows
        eng.quota_counts.copy_(quota_before)
    log(f"[3b] {edge_checks()} edge cases: every kernel equal to its "
        "plain version")
    log(f"[3b] {lits_edge_checks()} byte_pred / byte_lits / dfa_scan / "
        "dfa_lits calls equal to their plain versions byte for byte "
        f"(L = {', '.join(map(str, LITS_EDGE_L))}, B = "
        f"{', '.join(map(str, LITS_EDGE_B + LITS_BIG_B))}; contiguous, "
        "lean, narrowed, non-zero padding, strided, odd-address and "
        "broadcast rows; k = 0, 1, 3, L-1, L, L+1 of every kind; small, "
        "C = 1, S = 1 and larger-than-shared-memory banks; scattered "
        "columns in pre-filled planes; rows of "
        f"{', '.join(str(l) for l, _ in LITS_LONG)} bytes in groups of one "
        "and two patterns; every byte_pred case on both byte_staged and "
        "byte_direct)")
    log(f"[3c] {rule_match_edge_worlds()} rule_match cases (atom-less, "
        "empty, all-EQ, host-fallback and rule_pad snapshots at B="
        f"{HEADLINE_B} and {', '.join(map(str, K1_EDGE_B))}, every plane "
        "subset) equal to rule_match_plain and rule_match_words_plain")
    edge_worlds = {HEADLINE_RULES: eng, **{
        n: workloads.make_engine(n, with_quota=True, device="cuda")
        for n in FOLD_EDGE_RULES if n != HEADLINE_RULES}}
    log(f"[3d] {fold_edge_checks(edge_worlds)} verdict_fold, mesh_partial "
        "and check_pack cases (R = "
        f"{', '.join(map(str, FOLD_EDGE_RULES))}, B = "
        f"{', '.join(map(str, FOLD_EDGE_B))}, namespaces -1, -7, default, "
        "largest id and one past it, int32 min and max; windows off a word "
        "boundary; 3 and 11 instance words) equal to their plain versions "
        "and the word plain versions; two grids a quota fold")
    t0 = time.perf_counter()
    log(f"[3d] {quota_fold_checks()} quota folds (make_engine("
        f"{QUOTA_FOLD_RULES}) at quota max 3, B = "
        f"{', '.join(map(str, QUOTA_FOLD_B))}: one block, a cluster of 2 "
        f"and of 4; {N_STEPS} batches carried) equal to verdict_fold_plain "
        "and quota_grant_plain, two grids each")
    log(f"[t] 3d quota folds took {time.perf_counter() - t0:.1f} s")
    eng.quota_counts.copy_(quota_before)
    resilience_gate("[3] end")

    log(f"[t] phase 4 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 4: end to end, counters zeroed just before
    kernels.launches.reset()
    cpu_eng = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                    device="cpu")
    steps = 0
    e2e = {}
    for b in E2E_BATCHES:
        for s in range(N_STEPS):
            bags, req = hit_batch(eng, HEADLINE_RULES, b, seed=1000 + 10 * b
                                  + s)
            vg = compare_step(eng, cpu_eng, bags, req,
                              f"e2e hit B={b} step {s}")
            steps += 1
        n_or = oracle_sample(eng, bags, vg, HEADLINE_RULES)
        bags, req = headline_batch(eng, b)
        for s in range(N_STEPS):           # bench.py repeats one batch
            vg = compare_step(eng, cpu_eng, bags, req,
                              f"e2e headline B={b} step {s}")
            steps += 1
        n_or += oracle_sample(eng, bags, vg, HEADLINE_RULES)
        staged = eng.tensorizer.tensorize(bags).to("cuda")
        req_d = torch.as_tensor(req).to("cuda")
        t0 = time.perf_counter()
        eng.tensorizer.tensorize(bags)
        host_ms = (time.perf_counter() - t0) * 1e3
        iters = 30
        ms = time_ms(lambda: eng.check(staged, req_d), iters)
        busy = device_ms(lambda: eng.check(staged, req_d), 10)
        steps += iters + 3 + 11
        if b == HEADLINE_B:
            e2e_stage = check_ext_stage(f"[4] headline step B={b}",
                                        lambda: eng.check(staged, req_d),
                                        eng.ruleset)
            steps += e2e_stage["calls"]
        e2e[b] = ms
        idle = "not measured" if busy is None else \
            f"busy {busy:.4f} ms, idle share {1 - busy / ms:.3f}"
        st = torch.bincount(vg.status.cpu(), minlength=14).tolist()
        log(f"[4] B={b:5d}: {N_STEPS} hit and {N_STEPS} headline steps "
            f"equal to the plain path; {n_or} oracle cells agree; headline "
            f"traffic: device step {ms:.4f} ms = {b / ms * 1e3:,.0f} "
            f"checks/s ({idle}); host tensorize {host_ms:.1f} ms; "
            f"statuses {dict((i, n) for i, n in enumerate(st) if n)}")
    small = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                  device="cuda", quota_max=2)
    small_cpu = workloads.make_engine(HEADLINE_RULES, with_quota=True,
                                      device="cpu", quota_max=2)
    exhausted = 0
    for s in range(N_STEPS):
        bags, req = hit_batch(small, HEADLINE_RULES, 256, seed=5000 + s)
        vg = compare_step(small, small_cpu, bags, req, f"small quota {s}")
        exhausted += int((vg.status == RESOURCE_EXHAUSTED).sum())
        steps += 1
    if exhausted == 0:
        raise AssertionError("small-quota engine never hit "
                             "RESOURCE_EXHAUSTED")
    log(f"[4] small quotas (max 2): {exhausted} RESOURCE_EXHAUSTED over "
        f"{N_STEPS} batches, equal to the plain path")
    counts = dict(kernels.launches)
    grids = dict(kernels.launches.grids)
    missing = [k for k in ENGINE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the engine "
                             f"path: {missing}")
    k1_grids_per_call("[4] engine path", counts, grids)
    one_lit_launch_per_group("[4] engine path", {
        "counts": counts, "grids": grids,
        "entries": dict(kernels.launches.entries)}, eng.ruleset)
    log(f"[4] wrapper calls on the engine path ({steps} steps): {counts}; "
        f"__global__ launches: {grids}")
    resilience_gate("[4] end")

    log(f"[t] phase 5 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 5: the served Check() path, counters zeroed just before
    sv = served_phase()
    swap_phase(*sv["servers"])
    log(f"[5b] served path, B={HEADLINE_B}: every kernel against its "
        "plain version on the served path's own inputs (timed):")
    table = check_kernels(sv["captured"], sv["quota0"], int_rate)
    log(f"[5b] {served_edge_checks()} edge cases: check_pack and "
        "rule_stats equal to their plain versions; a served host-overlay "
        "world on padded batches equal to the CPU server")
    log(f"[5b] {rule_stats_edge_checks()} rule_stats edge shapes equal to "
        "the plain version (ragged rule axis, rows off an 8-byte boundary, "
        "S = 1 and 80, one / alternating / unknown namespaces, all "
        "padding, B = 333)")
    resilience_gate("[5] end")

    log(f"[t] phase 6 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 6: the authz world, counters zeroed just before
    az = authz_phase(int_rate)
    az["atom_worlds"] = atom_edge_checks(int_rate)
    log(f"[6b] {len(az['atom_worlds'])} atom worlds: atom_eval equal to "
        "atom_eval_plain and to the op-table interpreter")
    log(f"[6b] {atom_seam_checks()} seam cases (A = "
        f"{', '.join(map(str, SEAM_A))} x B = {', '.join(map(str, SEAM_B))}, "
        "register-stack and general kernels, strided planes, narrowed "
        "bytes): atom_eval equal to both plain versions, "
        "every column outside the atoms' unchanged")
    resilience_gate("[6] end")
    log(f"[t] phase 7 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 7: the list world, counters zeroed just before
    ls = list_phase(int_rate)
    t0 = time.perf_counter()
    log(f"[7b] {list_banks_edge_checks()} edge cases at B={HEADLINE_B}: "
        "list_banks equal to its plain versions (random, CIDR edge and "
        "sized worlds)")
    log(f"[t] 7b list_banks edge cases took "
        f"{time.perf_counter() - t0:.1f} s")
    resilience_gate("[7] end")
    log(f"[t] phase 8 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 8: the report path, counters zeroed just before
    rp = report_phase(int_rate)
    log(f"[8b] {field_edge_checks()} edge cases: field_eval equal to "
        "field_eval_plain and to the op-table interpreter")
    log(f"[8b] {field_seam_checks()} seam cases (F = "
        f"{', '.join(map(str, SEAM_F))} x B = {', '.join(map(str, SEAM_B))}, "
        "register-stack and general kernels, strided planes, narrowed "
        "bytes): field_eval equal to both plain versions, "
        "the buffer's other rows unchanged")
    resilience_gate("[8] end")
    log(f"[t] phase 8c starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 8c: the host adapters, counters zeroed just before
    ac = adapters_phase()
    resilience_gate("[8c] end")
    log(f"[t] phase 9 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 9: the quota path, counters zeroed just before
    qt = quota_phase(int_rate)
    resilience_gate("[9] end")
    log(f"[t] phase 10 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 10: route selection, counters zeroed just before
    rt = route_phase(int_rate)
    resilience_gate("[10] end")
    log(f"[t] phase 11 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 11: the discovery service, counters zeroed just before
    dc = discovery_phase(int_rate)
    resilience_gate("[11] end")

    log(f"[t] phase 12 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 12: sequence-parallel DFA, counters zeroed just before
    sq = seq_phase(int_rate)
    resilience_gate("[12] end")
    log(f"[t] phase 13 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 13: mesh serving, counters zeroed just before
    mh = mesh_phase(int_rate)
    resilience_gate("[13] end")

    log(f"[t] phase 14 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 14: the Check() resilience plane, counters zeroed just
    # before its drive
    rz = resilience_phase()

    log(f"[t] phase 14b starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 14b: the adapter-executor plane, counters zeroed just
    # before its drive
    ex = executor_phase()

    log(f"[t] phase 15 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 15: the config canary, counters zeroed just before its
    # drive; its gate counts from here (14 and 14b move the counters on
    # purpose)
    _GATE["base"] = resilience_reading()
    cz = canary_phase()
    resilience_gate("[15] end")

    log(f"[t] phase 16 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 16: the sharded serving plane, counters zeroed just
    # before its drive; (d)'s CHAOS leg moves the counters on purpose and
    # re-bases the gate after it
    sh = shards_phase()
    resilience_gate("[16] end")

    log(f"[t] phase 17 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 17: the tail-latency forensics plane, counters zeroed
    # just before its drive; (b)'s wedge moves the host ledger on purpose
    # and re-bases the gate after it
    fz = forensics_phase()
    resilience_gate("[17] end")

    log(f"[t] phase 18 starts at {time.perf_counter() - t_start:.1f} s")
    # ---- phase 18: result lines. K1-K6 keep the headline served path's
    # row; list_banks reports the list path's, field_eval the report
    # path's, quota_alloc the quota path's (its in-step trip, with every
    # mode's row under "modes") and route_select the route path's (its
    # winner, with both entry points under "entries"). Each row carries
    # its kernel's rows on the other paths under "paths".
    paths = {"served": sv, "authz": az, "lists": ls, "report": rp,
             "adapters": ac, "quota": qt, "routes": rt, "discovery": dc,
             "seq": sq, "mesh": mh, "resilience": rz, "executor": ex,
             "canary": cz, "shards": sh, "forensics": fz,
             "audit": fz["audit"]}
    by_name = {r["name"]: r for r in table}
    for name, path, res in (("list_banks", "lists", ls),
                            ("atom_eval", "authz", az),
                            ("field_eval", "report", rp),
                            ("quota_alloc", "quota", qt),
                            ("route_select", "routes", rt),
                            ("seq_match", "seq", sq),
                            ("mesh_fold", "mesh", mh)):
        by_name[name] = next(r for r in res["rows"] if r["name"] == name)
        by_name[name]["path"] = path
    table = [by_name[k] for k in kernels.KERNELS]
    by_name["atom_eval"]["worlds"] = az["atom_worlds"]
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_call", "calls_per_step", "bytes", "ops")
    for row in table:
        name = row["name"]
        home = paths[row.setdefault("path", "served")]
        row["launches"] = home["counts"][name]
        row["grid_launches"] = home["grids"][name]
        row["calls_per_served_step"] = home["per_step"][name]
        row["engine_path_launches"] = counts[name]
        row["launches_by_path"] = {"engine": counts[name], **{
            p: r["counts"][name] for p, r in paths.items()}}
        row["paths"] = {p: {k: x[k] for k in keep + ("glue_ms", "calls")
                            if k in x}
                        for p in ("authz", "lists", "report", "quota",
                                  "routes", "discovery", "seq", "mesh")
                        for x in paths[p]["rows"] if x["name"] == name
                        and p != row["path"]}
        if name in ("byte_pred", "dfa_scan"):
            # the ext stage (first K2 / K3 launch to rule_match, glue
            # included) per step of each path that asserted it
            row["ext_stage"] = {"engine": e2e_stage, **{
                p: paths[p].get("ext_stage") for p in (
                    "served", "authz", "routes")}}
    log("kernels (launches by path): " + "; ".join(
        f"{p}: " + ", ".join(f"{k}={r['counts'][k]}" for k in kernels.KERNELS)
        for p, r in paths.items()))
    log("authz (check_many, make_rbac_store(1000), "
        f"{az['pseudo_rows']} pseudo-rule rows): " + ", ".join(
            f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
            f"{r['checks_per_s']:.0f} checks/s denied "
            f"{az['denied'][b]:.4f}" for b, r in az["results"].items()))
    log("report (report(), telemetry world): " + ", ".join(
        f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
        f"{r['records_per_s']:.0f} records/s {r['trips_per_call']:.2f} "
        "trips/call" for b, r in rp["results"].items()))
    log(f"adapters (phase 8c, {ac['seconds']:.1f} s): telemetry world "
        "report() " + ", ".join(
            f"B={b} {wall_line(r)}" for b, r in
            ac["results"]["telemetry"].items())
        + "; APA world check_many() " + ", ".join(
            f"B={b} {wall_line(r)}" for b, r in
            ac["results"]["apa_check"].items())
        + ", report() " + ", ".join(
            f"B={b} {wall_line(r)}" for b, r in
            ac["results"]["apa_report"].items())
        + f"; denied by cause {json.dumps(ac['causes'])}")
    log("quota (quota world, 100,000 live keys): " + ", ".join(
        f"B={b} in-step p50 {r['instep']['p50_ms']:.4f} ms p99 "
        f"{r['instep']['p99_ms']:.4f} ms, classic p50 "
        f"{r['classic']['p50_ms']:.4f} ms p99 {r['classic']['p99_ms']:.4f} "
        "ms" for b, r in qt["results"].items())
        + f"; {qt['flushes']} flushes and {qt['trips']} in-step trips, one "
        "quota_alloc launch each")
    log("quota (K9 above 8,192 rows; one cluster launch up to 65,536, "
        "scan on the multi-launch path): " + ", ".join(
        f"{m} {r['ms']:.4f} ms ({r['grids']} grids)"
        for m, r in qt["rows"][0]["modes"].items() if "grids" in r)
        + f"; in-step B={QUOTA_INSTEP_BIG} walls "
        + " / ".join(f"{w:.1f}" for w in qt["instep_16384"]["walls_ms"])
        + " ms")
    log("routes (RouteTable.select, make_route_world(10_000)): " + ", ".join(
        f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
        f"{r['selects_per_s']:.0f} requests/s idle share "
        f"{r['idle_share'] if r['idle_share'] is None else round(r['idle_share'], 4)}"
        f" H2D {r['h2d_dense']} / {r['h2d_compact']} B"
        for b, r in rt["results"].items()))
    log(f"discovery ({dc['sidecars']:,} sidecars): cold poll "
        f"{dc['cold_s']:.3f} s = {dc['sidecars'] / dc['cold_s']:.0f} "
        f"polls/s, warm {dc['warm_s']:.3f} s = "
        f"{dc['sidecars'] / dc['warm_s']:.0f} polls/s; route_eval "
        f"{dc['stages'].get('route_eval')}; rule_match "
        f"{dc['counts']['rule_match']} launches for "
        f"{dc['admits']['program']} batched generations")
    log(f"seq (sharded_dfa_match on {N_VIRTUAL} virtual devices, "
        f"{SEQ_LAYOUTS[0][0]} rows x {SEQ_LAYOUTS[0][1] * SEQ_LAYOUTS[0][2]:,}"
        f" bytes): {sq['rows'][0]['sharded_match_ms']:.4f} ms per match, "
        f"one dfa_scan {sq['rows'][0]['dfa_scan_ms']:.4f} ms; launches "
        f"{sq['entries']}")
    log(f"mesh (check_many, make_store(10_000), mesh {MESH_SHAPE}): "
        + ", ".join(f"B={b} p50 {r['p50_ms']:.4f} ms (mesh-less "
                    f"{r['plain_p50_ms']:.4f})"
                    for b, r in mh["results"].items())
        + f"; stage probe {json.dumps(mh['probe'])}")
    log("e2e (engine step): " + ", ".join(
        f"B={b} {ms:.4f} ms {b / ms * 1e3:.0f} checks/s"
        for b, ms in e2e.items()))
    log("served (check_many): " + ", ".join(
        f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
        f"{r['checks_per_s']:.0f} checks/s" for b, r in
        sv["results"].items()))
    log(f"resilience (phase 14, {rz['seconds']:.1f} s; check_many through "
        "the ResilientChecker of a breaker_failures=2 server, beside "
        "phase 5's walls): " + ", ".join(
            f"B={b} p50 {r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms "
            f"(phase 5: p50 {sv['results'][b]['p50_ms']:.4f} ms p99 "
            f"{sv['results'][b]['p99_ms']:.4f} ms)"
            for b, r in rz["walls"].items())
        + f"; brownout shed {rz['sheds']}; continuous "
        f"{json.dumps(rz['continuous'])}")
    log(f"executor (phase 14b, {ex['seconds']:.1f} s; check_many on the "
        "overlay world, make_store(10_000, host_overlay_every=5), executor "
        "on / off): " + ", ".join(
            f"B={b} p50 {r['on']['p50_ms']:.4f} / {r['off']['p50_ms']:.4f} "
            f"ms p99 {r['on']['p99_ms']:.4f} / {r['off']['p99_ms']:.4f} ms"
            for b, r in ex["walls"].items())
        + f"; quota() p50 {ex['quota']['p50_ms']:.4f} ms p99 "
        f"{ex['quota']['p99_ms']:.4f} ms")
    cf = cz["full"]
    log(f"canary (phase 15, {cz['seconds']:.1f} s; make_store("
        f"{HEADLINE_RULES}), canary=gate at the defaults): replay of "
        f"{cf['rows']} recorded rows {cf['replay_wall_s'] * 1e3:.2f} ms = "
        f"{cf['replay_rows_per_s']:,.0f} rows/s in {cf['chunks']} chunk(s), "
        f"launches a chunk {json.dumps(cf['launches_per_chunk'])}; publish "
        f"delay {cf['publish_delay_s'] * 1e3:.2f} ms; candidate host "
        f"compile {cf['host_compile_s']:.2f} s; {cf['divergent']} "
        f"divergent rows vetoed ({cf['victim']}); overlay world "
        f"{cz['overlay']['host_denied']} host-denied rows, identical swap "
        "published with 0 divergences")
    sf = sh["full"]
    log(f"shards (phase 16, {sh['seconds']:.1f} s; make_fleet_store("
        f"{SHARD_RULES:,}, {SHARD_NAMESPACES}), {SHARD_COUNT} shards x "
        f"{SHARD_REPLICAS} lanes, buckets {SHARD_ARGS['buckets']}): parent "
        f"host compile {sf['parent_compile_s']:.2f} s, bank compiles "
        + " / ".join(f"{x:.2f}" for x in sf["bank_compile_s"])
        + f" s, sharded build {sf['sharded_build_s']:.2f} s; check_many "
        + ", ".join(f"B={b} {wall_line(r)}" for b, r in sf["walls"].items())
        + f"; {sf['trips_2048']} bank trips a B=2048 batch; delta rebuild "
        f"{sf['rebuild_s']:.2f} s (1 bank)")
    log(f"forensics (phase 17, {fz['seconds']:.1f} s; check_many B="
        f"{FORENSICS_B}, make_store({HEADLINE_RULES}, host_overlay_every=5)"
        "): " + ", ".join(
            f"{m} p50 {r['p50_ms']:.4f} ms"
            + (f" (forensics_overhead_pct {r['forensics_overhead_pct']:.2f})"
               if "forensics_overhead_pct" in r else "")
            for m, r in fz["overhead"].items())
        + f"; scorecard {fz['scorecard']['overall']}")
    ac = fz["audit"]["cost"]
    log(f"audit (phase 17b, {fz['audit']['seconds']:.1f} s; check_many B="
        f"{FORENSICS_B} on phase 17's server): auditor on at "
        f"{AUDIT_COST_INTERVAL_S} s p50 {ac['p50_ms']['on']:.4f} ms, stopped "
        f"p50 {ac['p50_ms']['off']:.4f} ms (audit_overhead_pct "
        f"{ac['audit_overhead_pct']:.2f}); evaluate() {ac['evaluate_ms']:.3f} "
        f"ms memoized, {ac['evaluate_plane_ms']:.3f} ms recomputing the "
        f"plane check, {ac['evaluate_quota_ms']:.3f} ms reading the pool")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
