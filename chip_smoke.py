#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (go_libp2p_pubsub_tpu_torch) on one NVIDIA
GPU and check what comes out.

    python3 chip_smoke.py [--baseline DIR]

Every kernel time is a batch of back-to-back launches on prepared
arguments: one wrapper call records the arguments it hands its C function,
and the launches replay exactly those (no checks, uncounted). The plain
versions and library calls are timed as batches of calls. With
``--baseline DIR`` (a checkout of another commit, e.g. unpacked with
``git archive``), the kernels of DIR's csrc/ are built too and timed on
the same prepared arguments in turns (baseline, this tree, this tree,
baseline), after a check that both write the same outputs.

Phases, each printing its own lines; any failure exits non-zero before the
last line is printed:

1. environment — torch/CUDA versions, the card's name and power limit, the
   protobuf runtime's version and implementation (the trace sinks'), the
   cryptography package's version (the API's Ed25519 signing);
2. build — nvcc builds every kernel source of the port from csrc/ for
   sm_90a, one nvcc per source, all started together;
3. GossipSub kernels — at the bench's shapes (N=100k, K=16, W=2, C=4), on
   inputs captured from a real round and on random words, edge_exchange and
   fused_delivery must equal their plain PyTorch versions exactly, and both
   also on the hazard bands (tests/torch_parity.hazard_bands: rings with K
   = 2, 6, 16, N=17 under the staged window, a circulant with steps past
   the halo): edge_exchange at C = 1 to 7 (5 and 7, the PX widths, under
   a symmetric live mask, and every C under a churn round's mask: whole
   peers dead, rows and columns) with scores holding -0.0,
   subnormals and NaN, fused_delivery at W = 1, 2, 3, 10 under every
   retrans_cap, with the cohort planes and scores on and off, and F_LIVE
   with whole peers dead; times of the
   kernel, the plain version and (edge_exchange) the one-call library
   gather, beside the bytes bound;
4. GossipSub at full width — the bench's default config at N=100k,
   formation rounds then 64 rounds of the bench's publish schedule; both
   fused-kernel launch counters must equal the round count and select_topk
   must launch 8 times a heartbeat, mesh degrees lie in [Dlo, Dhi], fwd is
   a subset of have; rounds/s and peak device memory;
5. GossipSub card against CPU — the same step from the same seed on the
   card and on the CPU (plain versions) for 32 rounds at N=8192, every leaf
   equal after every round; then the same for 16 rounds on the lattice
   under each of the score parameters that make float32 subnormals
   (tests/torch_parity.SUBNORMAL_CELLS);
6. GossipSub CSR bench — the same config built with edge_layout="csr",
   fused=True (CSR-resident state, the XLA-path composites, E=1.6M) for
   the same 80 rounds: select_topk 8 launches a heartbeat and the fused
   kernels none, the same degree and subset checks, and the final state,
   densified, equal to phase 4's leaf for leaf; rounds/s, peak memory;
7. GossipSub on powerlaw(100k, 2.2, d_min=2, max_degree=64, seed=0),
   CSR-resident, fused=True: 16 + 32 rounds; host set-up seconds,
   rounds/s, peak memory, the launch and subset checks;
8. select_topk — on a heartbeat call captured from phase 6 (R=100k, K=16)
   and from phase 7 (K=64), on random rows with ties, signed zeros,
   all-masked rows and widths 0..K+1, and on hazard rows (masked +-inf and
   NaN, subnormals, equal rows; tests/torch_parity.hazard_rows) of the
   same shape: equal to its plain version bit for bit; times of the
   kernel, the pairwise and the sort form, beside the bound;
9. GossipSub CSR card against CPU — phases 6 and 7's builds at N=8192 for
   16 rounds, every leaf equal after every round;
10. FloodSub, banded dense — ring_lattice(100k, d=8): delivery_banded
   against its plain version (captured and random inputs, and the hazard
   bands with K up to 40; medians, bound),
   then 80 rounds with 4 publishes a round: host set-up seconds, rounds/s,
   peak memory, state bytes, launches equal to rounds, fwd a subset of
   have, every message older than 4 rounds past its origin;
11. FloodSub, CSR-resident — powerlaw(1M, 2.2, d_min=2, max_degree=64,
   seed=0): csr_delivery the same way, with the link-deny mask on and off,
   and on the hazard graph (tests/torch_parity.hazard_graph: empty rows,
   rows of 1-64 edges and one of 200, W = 1, 2, 3), then the same 80-round
   run;
12. FloodSub card against CPU — both layouts at N=8192 for 32 rounds, every
   leaf equal after every round;
13. GossipSub phase bench — the phase engine bench.py measures:
   build_bench(N=100k, rounds_per_phase=8) on the banded lattice, the mesh
   formed (driver.form_mesh), 2 formation phases, then 8 timed phases (64
   rounds) of the bench's schedule; edge_exchange launches (1 + r) times a
   phase (the control head at C = 6, the data at C = W = 2), the delivery
   kernels none, select_topk 8 times a heartbeat; the degree and subset
   checks; delivery-rounds/s, peak memory, state bytes;
14. the same phases CSR-resident (edge_layout="csr", fused=True): no
   edge_exchange, and the final state, densified, equal to phase 13's;
15. the phase engine card against CPU — both builds at N=8192, r=8, events
   counted, every leaf equal after every phase;
16. edge_exchange at the phase shapes — the C = 6 head call and a C = 2
   data call captured from a phase of phase 13: equal to the plain version
   bit for bit (and on random words), their times (in back-to-back
   batches, and one call at a time after the L2 is written over, so that
   the C = 2 call's 32 MB come from HBM), bounds and the one-call gather's
   time, as fields of the edge_exchange record;
17. windows on the card — at N=8192 each window (driver.make_window /
   make_scan: a captured CUDA graph a block) against the eager loop from
   the same seed and schedule, every leaf: the phase engine at r=8 dense
   banded and CSR-resident, the per-round step at static_heartbeat he=2,
   FloodSub on the lattice and on the power-law graph CSR-resident, each
   window in two calls (the second continuing from the state the first
   returned under donate=True); then each of the five kernels, on a call
   taken from those runs, captured alone in a graph and replayed against
   its eager launch;
18. windowed benches at N=100k — the phase bench and the per-round bench
   (the continuity shape) eager and through make_scan in turns (eager,
   window, window, eager): delivery-rounds/s (rounds/s), peak memory, the
   capture's seconds, the wrappers' launches a captured block (the host
   counters move while a block is captured, never in a replay) and the
   graph replays a window;
19. the bench CLI's measurement — perf/sweep.measure_rate through
   bench.bench_line (python -m go_libp2p_pubsub_tpu_torch.bench) at a
   segment of 160 rounds, its JSON line printed;
20. the bench's eth2 config (N=100k, 64 topics, 2 a peer, 2 fanout slots)
   and sybil config (N=50k, 20% no-forward sybils, the peer gater, a
   validation capacity of 8, deficit scoring), each in the per-round step
   and the phase engine (r=8), eager and through driver.make_scan: every
   launch count at 0 before a run and checked after it (per round: 1
   edge_exchange, 1 fused_delivery, 8 select_topk a heartbeat, with eth2 2
   more a heartbeat and 1 a round or a phase for the publishes' fanout
   peers; per phase: 1 + r edge_exchange), delivery-rounds/s, peak memory
   and hand-kernel
   launches a delivery round; every kernel call of one more eager round or
   phase against its plain version bit for bit;
21. both configs card against CPU at N=8192 in both engines (every leaf
   after each of 8 rounds; after form_mesh and each of 2 phases), and
   each engine's window against its eager loop on the card;
22. the bench CLI's line of each config (BENCH_CONFIG=eth2, sybil; the
   sybil line at the CLI's default N=50k);
23. RandomSub, BASELINE.json config #2 — random_connect(1000, 32, seed=0),
   one topic, no size estimate (target ceil(sqrt(1000)) = 32), 4 publishes
   a round for 80 rounds: one select_topk a round and no delivery kernel
   (a random net takes the composite), each draw against its plain
   version, card against CPU every leaf after every round;
24. RandomSub at full width — ring_lattice(100k, d=8) with size_estimate=36
   (the target RandomSubD = 6; select_topk and delivery_banded a round)
   and powerlaw(1M) CSR-resident with size_estimate=1000 (target 32 of up
   to 64; select_topk at K=64 and csr_delivery): every count at 0 before
   the main path and each checked after it, the first calls of each kernel
   against their plain versions, the draw's time and bound, rounds/s eager
   and through driver.make_window, peak memory; card against CPU at
   N=8192;
25. the delivery core's options on the bench default config —
   queue_cap=2, validation_delay_rounds=2 and both: card against CPU and
   windows against eager in both engines at N=8192; the per-round step
   launches neither edge_exchange nor fused_delivery, the phase engine
   1 + r edge_exchange a phase, delivery_banded and csr_delivery never;
   the both-options phase bench windowed at N=100k in turns with eager,
   beside phase 18's plain one;
26. FloodSub on the lattice with queue_cap=2 at N=100k (no kernel: the cap
   takes the composites; drops counted), card against CPU at N=8192;
27. PX with edge liveness, the exact-trace plane and the int16 counters
   on the bench default config at N=100k (sweep.build_bench(px=True): 30%
   of the lattice's edges dormant, AcceptPXThreshold 0): from every count
   at 0 a PX round launches 1 edge_exchange (C = 5: graft | prune |
   ihave(2) | px) and 1 fused_delivery, a PX phase 1 + r edge_exchange
   (the head at C = 7 with the window, the data at C = 2); those calls,
   whose live words and F_LIVE flags have the dormant edges dead, against
   their plain versions bit for bit (captured and random words), timed
   beside their bounds; then both engines eager and through
   driver.make_scan in turns: rates, peak memory, live edges (more than at
   the start: PX activated some) and the p50/p99 of state.hops over the
   delivered pairs;
28. the PX cell card against CPU at N=8192 in both engines, every leaf
   after every round or phase, and each window against its eager loop;
29. churn on the kernel route at N=100k: the bench default config with
   dynamic_peers (sweep.churn_up: 20,000 peers, default_rng(0).choice,
   down in rounds 16-47 and up from 48 of an 80-round run): from every
   count at 0 a churn round launches 1 edge_exchange (C = 4) and 1
   fused_delivery, a churn phase 1 + r edge_exchange (C = 6, 2); those
   calls, taken inside the kill window, whose live words and F_LIVE flags
   have 20,000 whole rows dead, against their plain versions bit for bit,
   timed beside their bounds; then both engines eager (events counted) and
   through driver.make_scan(..., up): rates over rounds 16-79, peak memory,
   mesh edges before the kill, after round 47 and at the end,
   EV.REMOVE_PEER and EV.ADD_PEER (20,000 each), the delivery ratio of the
   messages of rounds 56-71;
30. the mutating overlay at N=100k: the default config with dynamic_peers
   and dynamic_topo on powerlaw(100k, 2.2, d_min=2, max_degree=60) padded
   to K = 64, built dynamic, dense and full-capacity CSR (E = 6.4M), under
   churn_storm(n_dispatches=32, kill_frac=0.2, rewires=8, joins=2,
   join_links=2): the storm's compile seconds, batch width and hash; from
   every count at 0 no edge_exchange, fused_delivery or delivery kernel
   and 8 select_topk a heartbeat; rounds/s eager and through
   driver.make_window; peak memory; the overlay equal to the storm's host
   mirror;
31. card against CPU at N=8192, every leaf after every round or phase: the
   churn cell in both engines and the overlay (its own power-law net,
   dense and CSR); each window against its eager loop on the card;
32. the lifted score plane at N=100k (sweep.build_bench(lift_scores=True),
   planes from lift_planes: A the config's own values, B every lifted
   surface moved, C a CandidateParams of B with D = 8, Dlo = 6, Dhi = 12),
   both engines: from every count at 0 the formation under A launches the
   static build's route (1 edge_exchange and 1 fused_delivery a round,
   1 + r edge_exchange a phase, 8 select_topk a heartbeat); every
   edge_exchange, the first fused_delivery (its threshold row read from
   the plane on the card) and the first select_topk (the plane's widths)
   of one dispatch under C against their plain versions bit for bit; then
   eager, window, window, eager under A (rates beside phase 18's static
   ones, peak memory, capture seconds), the last window replaying a
   segment under B and one under C with ``captures`` still 1; mesh
   degrees in [Dlo, Dhi] of the plane in force;
33. the phase engine's count path (score_counts=True) and the per-plane
   wire form (wire_coalesced=False) of the phase and per-round benches at
   N=100k, eager and windowed, each captured block on the static build's
   kernel route, beside phase 18's plain rates; the bench CLI's line under
   BENCH_WIRE_COALESCED=0;
34. card against CPU at N=8192, every leaf after every round or phase, and
   windows against eager: the lifted step in both engines, dense banded
   and CSR-resident, under plane A then B (one window capture replaying
   both); the count path; the per-plane form in both engines; FloodSub and
   RandomSub given a plane (equal to the runs without it); forward_mask in
   the shared delivery round on the lattice (delivery_banded not launched)
   and CSR-resident (csr_delivery launched once, its fwd gated);
35. the trace drain (trace/drain.py, trace/sinks.py): five cells traced
   from the same seed on the card and on the CPU at N=8192 into a
   PBTracer, the files equal byte for byte — the per-round step
   (edge_exchange, fused_delivery), the phase engine at r=8, FloodSub on
   the lattice (delivery_banded) and CSR-resident on the power-law graph
   (csr_delivery, the flat first-arrival plane densified by the
   snapshot), exact mode on the PX build; then the default config at
   N=100k (events counted), formed untraced, traced for 12 rounds (the
   phase engine: one phase of 8) into a PBTracer beside the same run
   untraced: DELIVER +
   REJECT records equal the first receipts counted on the card, PUBLISH
   the publishes, SEND_RPC and RECV_RPC each DELIVER + REJECT, GRAFT and
   PRUNE the mesh diffs, the propagation latencies read from the file
   (deliver tick minus publish tick) equal first_round - birth on the
   card (p50, p99), DELIVER ticks keep sub-round resolution in the phase;
   the final state and the launch counts equal the untraced run's;
   records, bytes and host seconds (snapshot, emission) a round, and the
   traced and untraced rates;
36. the checkpoint (checkpoint.py, the v6 npz container) at N=100k: the
   per-round step saved after 16 rounds, the phase engine at a phase
   boundary (form_mesh + 2 phases), each compressed and not (sizes, save
   and restore seconds), each file restored into a fresh template equal
   to the saved state; 8 (the phase engine: 16) more rounds from the
   restore equal the uninterrupted eager run on every leaf, the per-round
   step eagerly and the phase engine through a captured window
   (driver.make_scan);
37. the application API (api.py, before the profiler phase): six scripted
   sessions through api.Network on the connect()ed ring lattice at N=8192
   (GossipSub at r = 1 and r = 8, FloodSub, RandomSub, max_message_size,
   a runtime Join and Leave), each on the card and on the CPU: the
   subscriptions' bytes, the event handler's events and the final state
   equal leaf for leaf, the card's launches recorded (connect() builds the
   lattice in _from_edge_lists' slot order, which is not banded, so these
   take the composites and select_topk); the transmit-block plane on the
   kernels' routes at N=8192 (the per-round step's edge_exchange and
   fused_delivery, the phase engine's edge_exchange, FloodSub's
   delivery_banded and csr_delivery), card against CPU every round or
   phase, each kernel launched on the block state and every blocked
   message at its origin only; then the API at N=100,000 at r = 8 (8
   phases) and r = 1 (8 rounds), 1,000 subscriptions, 4 signed publishes a
   dispatch: the host's seconds to build (identities, connect, join,
   start with its peer records), the subscriptions reconciled with
   first_round and verified, the final state and the launches equal to
   the direct build's (make_gossipsub_phase_step / make_gossipsub_step)
   driven with the API's calls, rounds/s through the API and direct, and
   the host's ms a round split into the step, the snapshots and the drain;
38. the link-fault plane (chaos/): at N=8192 every engine under the
   i.i.d. (loss 0.35) and the Gilbert–Elliott (0.15 down, 0.4 up) generator
   card against CPU every round or phase — the per-round step on the
   lattice (delivery_banded a round and 8 select_topk a heartbeat, neither
   edge_exchange nor fused_delivery: the reference's fused_eligible keeps
   chaos off the fused kernels), on random_connect(8192, 8) and CSR
   (select_topk only), the phase engine coalesced and per-plane (1 + r
   edge_exchange a phase: the head's link mask joins its live words, each
   sub-round's gates its crossing), FloodSub and
   RandomSub on the lattice (delivery_banded) and CSR-resident
   (csr_delivery), each route asserted from the host's launch counts; a
   scheduled two_group_partition in both GossipSub engines; a disabled
   ChaosConfig equal to chaos=None in leaves and launches; windows (deny
   rows as xs) against their eager loops. Then the default config at
   N=100k without chaos, under loss 0.1 and under GE 0.02/0.25 in both
   engines eager and windowed (LINK_DOWN, IWANT_RECOVER, the IWANT
   recovery share, the delivery ratio; each window block on its route),
   FloodSub under loss 0.1 at N=100k and on powerlaw(1M) CSR-resident
   beside itself without, and a scheduled partition (halves, ticks 24-55)
   of random_connect(100k, 8) under the sybil config's deficit scoring
   through one phase window with the device cross-group mesh observer: no
   message crosses the cut before the heal, the cross-group mesh edges a
   phase, the mesh repair and re-form latencies and the time to recover;
39. the kernel launches of a traced GossipSub bench round
   (perf/profile.py), with those of the score path's subnormal flush
   (hardshrink, copysign) apart (2,287.75 a bench round and 466.25 a
   phase-bench delivery round, or the script fails: the options off
   launch nothing more), of a traced phase-bench phase per
   delivery round, of a traced replay of a windowed phase (--window), and
   of a traced round and phase of each config. It comes last, after 40-41,
   so that the profiler's tracing cannot touch a rate timed in the same
   process;
40. the attack plane (chaos/adversary.py): at N=8192 all five behaviours
   (a fifth of the peers from a ramped onset; censoring every seventh
   peer's messages) in all four engines, each recording the telemetry
   panel, card against CPU every round or phase with its route from the
   host's launch counts — the per-round step on the lattice
   (delivery_banded a round and 8 select_topk a heartbeat, neither fused
   kernel: the reference's fused_eligible keeps an adversary off them),
   the phase engine (1 + r edge_exchange a phase: the IWANT service masked
   receiver-side after the head's crossing, the data sender-side before
   each sub-round's), FloodSub and RandomSub on the lattice
   (delivery_banded) and power-law CSR-resident (csr_delivery), and both
   without an attack — the ADV counters moving and the panel reconciled on
   the card; an unarmed population equal to none in leaves and launches;
   attacked windows against their eager loops. Then
   scripts/attack_report.py's sybil flood (20% sybils running
   drop_forward, lie_ihave, graft_spam and self_promo from tick 12, i.i.d.
   loss 0.1) on the default config at N=100k in both engines, eager and
   windowed (each window equal to its eager loop, its block on the attacked
   route), beside the attack-free run on the same streams: honest and
   attacker delivery of the messages born in ticks 16-35, the honest
   median score of attacker and of honest edges; and its eclipse (targets
   0-2, half of each one's lattice neighbourhood sybil, drop_forward and
   graft_spam from tick 20): the takeover peak and the recovery tick in
   both engines;
41. the telemetry panel on the windowed default phase and per-round step
   at N=100k (events counted), on and off in turns: the rate cost, each
   window block's launches (equal on and off) and reconcile empty on the
   card's panel;
42. the invariant oracle (oracle/, before the profiler phase): (a) the
   default config at N=100k through windows with the folded checker and
   without, in turns, in both engines (the phase engine at r = 8 checked
   every 2 phases, the per-round step every 8 rounds): every property
   holds, a checked block launches each kernel as often as its unchecked
   twin, one capture, the final state and the verdicts equal to an eager
   run with an InvariantHook; the rates on and off and the checker's own
   launches and device ms a check (perf/profile.check_cost); (b) at
   N=8192 every seeded violation of every property on every engine it
   applies to trips exactly its property, the card's verdicts equal to the
   CPU's; (c) the due contract at N=8192: a halves partition through a
   checked phase window (grace around the cut, recover after the heal) and
   a churn storm with MutationSchedule.due_fn, both all ok and re-checked
   on the CPU, each clause shown doing work; (d) the GossipSub step on the
   card within 2% sup-norm of the port's OracleGossipSub's
   propagation-latency CDF (tests/test_parity_cdf.py's N=192);
43. the router plane (routers/, before the profiler phase), on
   scripts/choke_smoke.py's cells: powerlaw(N, 2.2, d_min=3,
   max_degree=16) on 8 latency clusters (topo.link_delay_plane, ring
   depth 7), scores on, i.i.d. loss 0.05; A is v1.1, B IDONTWANT, D B with
   the latency ring, C D with lazy choking. (a) N=8192: B, D, C and the
   bench lattice under RouterConfig(idontwant, choke) card against CPU on
   every leaf after 24 rounds, each route from launch counts (neither
   fused kernel; delivery_banded once a round on the lattice; select_topk
   11 a round with the cells' 2 fanout slots, 8 on the lattice, one more
   with choking); the CSR-resident arms and the lattice through captured
   windows, each equal to its dense eager run; C's window saved between
   its two calls with the ring in flight and resumed from the file.
   (b) N=100k, A, B, D, C and C's CSR arm, one sim each, eager over the
   first half and windowed over the whole run (equal at the half): B's
   delivery plane (first_round, have, DELIVER_MESSAGE) equal to A's with
   fewer duplicates and the RPC drop equal to the duplicate drop; C's
   window with the checker folded in every 8 rounds holding every
   property at every check, choke-wf and no-choke-below-dlo among them,
   CHOKE > 0, its CSR arm's counters equal; D and C at >= 99% coverage;
   printed: the duplicate cut, C's and D's paired-support p95 latency,
   each cell's rates against A, peak memory, launches a round. (c) the
   bench default config at N=100k windowed with the router on and off in
   turns: the rate cost and both blocks' routes;
44. the ensemble plane (ensemble/: S sims a dispatch, every kernel with a
   sim axis, csrc/sims.cuh), before the profiler phase. (a) N=8192, S=3,
   16 rounds: FloodSub on the lattice and power-law CSR-resident, RandomSub
   on the lattice, the per-round bench step dense and CSR-resident and the
   phase engine at r=8 as lifted ensembles (ensemble.lift_step, vmap): the
   card's batched run equal on every leaf to the card's one-sim runs under
   with_sim_key, sim for sim, and to the CPU's batched run; an S=3
   dispatch launching each kernel as often as a one-sim dispatch; a lifted
   window (one capture) equal to its eager loop. (b) each kernel's S=8
   batched launch (*_sims) on the earlier phases' main-path calls against
   its one-sim launch in turns, each sim's outputs equal to the one-sim
   launch's, the bound S times the one-sim bytes; the bench default config
   at N=100k, phase engine r=8, 2 + 8 phases as an S=8 windowed ensemble
   beside the 8 sims one after another through the one-sim window:
   sim-delivery-rounds/s, peak memory, the same block launches, every
   sim's final state equal. (c) scripts/choke_smoke.py at its shape (N=256,
   4 sims, 84 rounds) as S=4 windowed ensembles of its C (the checker
   folded in every 12 rounds) and D cells with its per-sim gates (coverage
   >= 0.99, CHOKE > 0, tail_cut > 0), and phase 43's C and D cells at
   N=100k as S=4 ensembles over 64 rounds, their per-sim paired p95
   printed. Each kernel record gains ``ensemble``: its S=8 batched time
   and bound, its launches in (a), its launches in (b)'s block;
45. the supervised service loop (serve/, before the profiler phase). (a)
   the ``_child`` cell (GossipSub on random_connect(8192, 4), loss 0.1,
   scores and counters) supervised on the card and on the CPU, 32
   dispatches in segments of 8, the probes, the checker every 4 and a
   checkpoint every segment: equal digests, one capture, select_topk alone
   launched, 11 a counted dispatch (warm-up and capture; a replay counts
   nothing); the degradation ladder on the card (two failures past
   max_retries=1: the segment halves to 4 and the run completes in the
   same digest, one capture a window shape). (b) the bench default at
   N=100k (phase engine r=8, form_mesh, 32 phases in segments of 8), the
   probes and the checker every 2 phases (all but backoff-clears,
   SERVE_FULL_SKIPPED): the final digest equals a bare segmented
   WindowRunner's with the same checker folded in, one capture, a replay block launching what the bare
   window's does (edge_exchange 1 + r and select_topk 8 a phase); timed
   warm in turns (bare, supervised, supervised, bare, twice) with one
   checkpoint at the end, the overhead share of the medians (the
   supervision's own: both sides fold the checker in) printed beside the
   reference's 10% ceiling; the every-segment checkpoint cadence's rate and each save's
   bytes and seconds. (c) the (b) run with a NaN in ``scores`` after
   dispatch 3 of segment 1 and two transient failures of segment 2: the
   bundle names global dispatch 11, two retries, (b)'s digest. (d) a
   ``python -m go_libp2p_pubsub_tpu_torch.serve._child --device cuda`` at
   (a)'s arguments SIGKILLed mid-write of segment 1's checkpoint and run
   again: it resumes at dispatch 8 in (a)'s digest (two processes). Each
   kernel record gains ``serve_launches``: its launches in (a) and in
   (b)'s block.

It prints the ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. It imports neither JAX nor the JAX
package, and exits non-zero when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
NON_TENSOR_OPS_PER_S = 67e12  # H100 SXM outside the tensor cores
N_FULL, M_SLOTS = 100_000, 64
FORMATION_ROUNDS, MEASURED_ROUNDS = 16, 64
N_PARITY, PARITY_ROUNDS = 8192, 32
SUBNORMAL_PARITY_ROUNDS = 16  # each subnormal cell of phase 5, after the bench's 32
CSR_PARITY_ROUNDS = 16        # each build of phase 9 (32 before phase 44)
N_CSR, FLOOD_ROUNDS = 1_000_000, 80
POWERLAW_ROUNDS = 32          # timed rounds of phase 7, after the formation
PHASE_R = 8                   # rounds a phase: bench.py's BENCH_PHASE_R default
PHASE_FORMATION, PHASE_MEASURED = 2, 8   # phases after form_mesh; timed phases
PHASE_PARITY_PHASES = 4       # phases of phase 15, after form_mesh
WINDOW_ROUNDS = 48            # rounds of each window run of phase 17 (two calls)
BENCH_CLI_ROUNDS = 160        # the segment of phase 19's bench line
L2_SCRUB_BYTES = 128 << 20    # written before a cold-L2 timing (H100 L2: 50 MB)
#: traced kernel launches of a default bench round (over 4 rounds) and of
#: a phase-bench delivery round (over a phase of 8): the options off (PX,
#: edge liveness, the exact-trace plane, the int16 counters) launch
#: nothing more; the phase head takes its live words from the build's
#: constants, one conversion a phase fewer than before
DEFAULT_LAUNCHES = (2287.75, 466.25)
SELECTIONS_PER_HEARTBEAT = 8  # grafts, topscore, rest_rand, bring, drop,
                              # grafts2, oppo, chosen (models/gossipsub.py)
KERNEL_SOURCES = ("fused_round", "delivery", "select_topk")
KERNEL_SOURCE = "go_libp2p_pubsub_tpu_torch/csrc/fused_round.cu"
DELIVERY_SOURCE = "go_libp2p_pubsub_tpu_torch/csrc/delivery.cu"
SELECT_SOURCE = "go_libp2p_pubsub_tpu_torch/csrc/select_topk.cu"
REPLACES = {
    "edge_exchange": "go_libp2p_pubsub_tpu/ops/fused_round.py:197",
    "fused_delivery": "go_libp2p_pubsub_tpu/ops/fused_round.py:424",
    "delivery_banded": "go_libp2p_pubsub_tpu/ops/pallas_delivery.py:162",
    "csr_delivery": "go_libp2p_pubsub_tpu/ops/pallas_csr.py:229,244,260",
    "select_topk": "go_libp2p_pubsub_tpu/ops/pallas_csr.py:312",
}


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def batch_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Median over ``reps`` batches of ``calls`` back-to-back calls between
    one pair of CUDA events, divided by ``calls``: the device time of a
    call whose host dispatch is shorter than its kernels, which one call
    on an idle card cannot show."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def cold_ms(fn, reps: int = 20) -> float:
    """Median over ``reps`` single calls of the device time of one call
    with a cold L2: each call follows a write of ``L2_SCRUB_BYTES`` (more
    than the H100's 50 MB L2), so its inputs come from HBM, which
    back-to-back batches (``batch_ms``) of a call whose bytes fit in the
    L2 do not show."""
    import torch

    scrub = torch.empty(L2_SCRUB_BYTES // 4, dtype=torch.int32, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        scrub.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def prepared(lib, fn: str, call):
    """Run ``call`` (one wrapper call) once, recording the arguments it hands
    the C function ``fn`` of ``lib``. Returns ``launch(other=None)``, which
    launches ``fn`` again on exactly those arguments (the same output
    buffers, no checks, uncounted), or the same function of ``other`` (a
    library with the same C interface, e.g. the baseline's). ``launch.out``
    keeps the wrapper's outputs alive."""
    from go_libp2p_pubsub_tpu_torch.ops import kernels

    orig = getattr(lib, fn)
    seen = []

    def record(*args):
        seen.append(args)
        return orig(*args)

    setattr(lib, fn, record)
    try:
        out = call()
    finally:
        setattr(lib, fn, orig)
    args = seen[0]

    def launch(other=None):
        f = orig
        if other is not None:
            f = getattr(other, fn)
            f.argtypes, f.restype = orig.argtypes, orig.restype
        kernels.raise_on(f(*args), fn)

    launch.out = out
    return launch


def outputs_of(out) -> list:
    """The output tensors of a wrapper's result, in a fixed order."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for t in out if t is not None]
    return [out]


def build_baseline(tree: str) -> dict:
    """Build the kernel sources of another checkout (``tree``/
    go_libp2p_pubsub_tpu_torch/csrc/*.cu), one nvcc each, all started
    together, into build/torch_kernels/baseline/; returns {source: CDLL}."""
    from go_libp2p_pubsub_tpu_torch.ops import kernels

    csrc = pathlib.Path(tree) / "go_libp2p_pubsub_tpu_torch" / "csrc"
    out = kernels.BUILD_DIR / "baseline"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNEL_SOURCES:
        src = csrc / f"{name}.cu"
        lib = out / f"lib{name}-{kernels.source_tag(csrc, name)}.so"
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"baseline nvcc failed for {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def kernel_times(launch, baseline=None) -> dict:
    """``ms``: batches of back-to-back prepared launches. With a baseline
    library: first a check that it writes the same outputs on the same
    arguments, then both timed in turns (baseline, this tree, this tree,
    baseline) and ``ms``/``baseline_ms`` the means of each pair."""
    import torch

    if baseline is None:
        return {"ms": batch_ms(launch)}
    launch()
    torch.cuda.synchronize()
    mine = [t.clone() for t in outputs_of(launch.out)]
    launch(baseline)
    torch.cuda.synchronize()
    max_abs_err(mine, outputs_of(launch.out))
    b1 = batch_ms(lambda: launch(baseline))
    n1 = batch_ms(launch)
    n2 = batch_ms(launch)
    b2 = batch_ms(lambda: launch(baseline))
    return {"ms": (n1 + n2) / 2, "baseline_ms": (b1 + b2) / 2,
            "ab_ms": [b1, n1, n2, b2]}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_abs_err(ref, got) -> float:
    """Largest |ref - got| over matching tensors (words compared as
    integers, floats as floats)."""
    import torch

    worst = 0.0
    for a, b in zip(ref, got):
        if a is None:
            assert b is None
            continue
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype.is_floating_point:
            d = (a.double() - b.double()).abs().max()
        else:
            d = (a.long() - b.long()).abs().max().double()
        worst = max(worst, float(d))
        if not torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                           b.view(torch.int32) if b.dtype == torch.float32 else b):
            raise AssertionError("kernel output differs bitwise from its plain version")
    return worst


def capture_round(step, st, module, names=("edge_exchange", "fused_delivery")):
    """Run one round, recording each named kernel wrapper's call."""
    captured = {}
    originals = {name: getattr(module, name) for name in names}

    def recorder(name):
        def call(*args, **kwargs):
            captured[name] = (args, kwargs)
            return originals[name](*args, **kwargs)
        return call

    try:
        for name in originals:
            setattr(module, name, recorder(name))
        st = step(st)
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)
    return st, captured


def randomize_words(args, gen):
    """The same call with every 2-D int32 word plane and every f32 plane
    refilled at random (callers redraw planes that need a structure)."""
    import torch

    out = []
    for a in args:
        if isinstance(a, torch.Tensor) and a.dtype == torch.int32 and a.dim() == 2:
            r = torch.randint(-2**31, 2**31, a.shape, generator=gen, dtype=torch.int64,
                              device="cpu").to(torch.int32).to(a.device)
            out.append(r)
        elif isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            out.append((torch.randn(a.shape, generator=gen) * 20).to(a.device))
        else:
            out.append(a)
    return out


def check_kernels(fr, captured, gen, base):
    """Phase 3: each kernel against its plain version on the card, and its
    time (beside the baseline's when ``base`` holds the baseline's
    libraries). Returns the per-kernel records (launches filled in
    later)."""
    import torch

    records = []
    # --- edge_exchange -----------------------------------------------------
    args, kw = captured["edge_exchange"]
    wire, scores, live = args
    n, k, c = wire.shape[0], len(kw["offsets"]), kw["c"]
    err = 0.0
    for trial in ("captured", "random"):
        a = list(args) if trial == "captured" else randomize_words(args, gen)
        if trial == "random":
            a[2] = (torch.rand(live.shape, generator=gen) < 0.9).to(torch.int32).to(live.device)
        ref = fr.edge_exchange_plain(*a, **kw)
        got = fr.edge_exchange(*a, **kw)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(ref, got))
    err = max(err, check_band_hazards("edge_exchange", wire.device))
    out_w, out_s = fr.edge_exchange(*args, **kw)
    io = nbytes(wire, scores, live, out_w, out_s)
    ops = n * k * c + n * k            # one select per output element
    perm = (((torch.arange(n, device=wire.device)[:, None]
              + torch.tensor(kw["offsets"], device=wire.device)[None, :]) % n) * k
            + torch.tensor(kw["revs"], device=wire.device)[None, :]).reshape(-1)
    flat = wire.view(n * k, c)
    keep_call("edge_exchange", args, kw)
    launch = prepared(fr._lib(), "edge_exchange_sims",
                      lambda: fr.edge_exchange(*args, **kw))
    rec = {
        "name": "edge_exchange", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["edge_exchange"], "launches": 0,
        "max_abs_err": err,
        **kernel_times(launch, base and base["fused_round"]),
        "plain_ms": batch_ms(lambda: fr.edge_exchange_plain(*args, **kw)),
        **bound(io, ops),
        "library_ms": batch_ms(lambda: flat[perm]),
    }
    records.append(rec)
    say(f"kernel edge_exchange: N={n} K={k} C={c} exact (max_abs_err {err}) "
        f"kernel_ms={rec['ms']:.6f}{baseline_note(rec)} plain_ms={rec['plain_ms']:.6f} "
        f"bound_ms={rec['bound_ms']:.6f} library_ms={rec['library_ms']:.6f} "
        f"({io} bytes moved)")

    # --- fused_delivery ----------------------------------------------------
    args, kw = captured["fused_delivery"]
    n, k, w = args[2].shape[0], len(kw["offsets"]), kw["w"]
    err = 0.0
    for trial, cohorts in (("captured", kw["want_cohorts"]), ("random", True),
                           ("random", False)):
        a = list(args) if trial == "captured" else randomize_words(args, gen)
        if trial == "random":
            # flag words: random patterns of the five flag bits
            a[8] = torch.randint(0, 32, args[8].shape, generator=gen,
                                 dtype=torch.int32).to(args[8].device)
        kk = dict(kw, want_cohorts=cohorts)
        ref = fr.fused_delivery_plain(*a, **kk)
        got = fr.fused_delivery(*a, **kk)
        torch.cuda.synchronize()
        names = sorted(ref)
        assert names == sorted(got)
        err = max(err, max_abs_err([ref[x] for x in names], [got[x] for x in names]))
    err = max(err, check_band_hazards("fused_delivery", args[2].device))
    res = fr.fused_delivery(*args, **kw)
    io = nbytes(*[t for t in args if hasattr(t, "numel")], *res.values())
    ops = 40 * n * k * w               # word ops per (peer, edge, word)
    keep_call("fused_delivery", args, kw)
    launch = prepared(fr._lib(), "fused_delivery_sims",
                      lambda: fr.fused_delivery(*args, **kw))
    rec = {
        "name": "fused_delivery", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES["fused_delivery"], "launches": 0,
        "max_abs_err": err,
        **kernel_times(launch, base and base["fused_round"]),
        "plain_ms": batch_ms(lambda: fr.fused_delivery_plain(*args, **kw)),
        **bound(io, ops),
        "library_ms": None,
    }
    records.append(rec)
    say(f"kernel fused_delivery: N={n} K={k} W={w} want_cohorts={kw['want_cohorts']} "
        f"exact (max_abs_err {err}) kernel_ms={rec['ms']:.6f}{baseline_note(rec)} "
        f"plain_ms={rec['plain_ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"library_ms=null ({io} bytes moved)")
    say("kernels: " + ", ".join(r["name"] for r in records))
    return records


def baseline_note(rec: dict) -> str:
    if "baseline_ms" not in rec:
        return ""
    return (f" baseline_ms={rec['baseline_ms']:.6f} (in turns: "
            f"{', '.join(f'{t:.6f}' for t in rec['ab_ms'])})")


def bound(io: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the integer operations over the non-tensor-core rate,
    and which of the two it is."""
    t_io, t_ops = io / HBM_BYTES_PER_S, ops / NON_TENSOR_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_io, t_ops),
            "bound_by": "bytes" if t_io >= t_ops else "operations"}


def check_band_hazards(name: str, dev) -> float:
    """fused_delivery (under every config of FUSED_CONFIGS) or
    delivery_banded against its plain version on the hazard bands of the
    tests (tests/torch_parity.hazard_bands: rings with K = 2 to 40, N not a
    multiple of the block, N=17 under the staged window, a circulant with
    steps beyond the halo) at W = 1, 2, 3 and 10 (fused_delivery also at
    thresholds of 0.0 and -0.0), or edge_exchange on
    those with K <= 16 at C = 1, 2, 3, 4 and 6, scores on and off. Returns
    max_abs_err."""
    import numpy as np
    import torch
    from torch_parity import (
        FUSED_CONFIGS,
        HAZARD_BAND_M,
        HAZARD_C,
        dead_peers_live,
        hazard_banded_args,
        hazard_bands,
        hazard_exchange_args,
        hazard_fused_args,
        with_dead_peers,
    )

    from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db
    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a)).to(dev)

    err, cases = 0.0, 0
    if name == "edge_exchange":
        for band in hazard_bands():
            if len(band["offsets"]) > fr.MAX_K:
                continue
            for c in HAZARD_C:
                a = [t(x) for x in hazard_exchange_args(band["n"] + c, band, c)]
                # and a churn round's mask: whole peers dead, rows and columns
                dead = [a[0], a[1], t(dead_peers_live(band["n"], band))]
                for args, score in ((a, True), (a, False), (dead, True)):
                    kw = dict(offsets=band["offsets"], revs=band["revs"], c=c,
                              score_enabled=score)
                    ref, got = fr.edge_exchange_plain(*args, **kw), fr.edge_exchange(*args, **kw)
                    torch.cuda.synchronize()
                    err = max(err, max_abs_err(ref, got))
                    cases += 1
        say(f"kernel edge_exchange: hazard bands ({cases} calls: rings with K = 2-16, N=17, "
            f"a circulant past the halo; C in {list(HAZARD_C)}, scores with -0.0, "
            f"subnormals and NaN; whole peers dead) exact (max_abs_err {err})")
        return err
    for band in hazard_bands():
        k = len(band["offsets"])
        for m in HAZARD_BAND_M:
            static = dict(offsets=band["offsets"], revs=band["revs"], w=(m + 31) // 32)
            calls = []
            if name == "delivery_banded":
                calls.append((db.delivery_banded_plain, db.delivery_banded,
                              [t(a) for a in hazard_banded_args(m, band, m)], static, ()))
            elif k <= fr.MAX_K:
                for i, (score, cohorts, cap) in enumerate(FUSED_CONFIGS):
                    for dead in (False, True):
                        raw = hazard_fused_args(m + i, band, m)
                        if dead:
                            # a churn round's F_LIVE: whole peers dead
                            raw[8] = with_dead_peers(band["n"], band, raw[8])
                        a = [t(x) for x in raw]
                        if not score:
                            a[4] = None
                        calls.append((fr.fused_delivery_plain, fr.fused_delivery, a,
                                      dict(static, score_enabled=score, want_cohorts=cohorts,
                                           retrans_cap=cap), (-10.0, -50.0)))
                # the score gates at thresholds of 0.0 and -0.0, which the
                # hazard scores' subnormals of both signs pass as zeros
                calls.append((fr.fused_delivery_plain, fr.fused_delivery,
                              [t(x) for x in hazard_fused_args(m, band, m)],
                              dict(static, score_enabled=True, want_cohorts=True,
                                   retrans_cap=3), (0.0, -0.0)))
            for plain, kernel, a, kw, thr in calls:
                ref, got = plain(*a, *thr, **kw), kernel(*a, *thr, **kw)
                torch.cuda.synchronize()
                names = sorted(ref)
                assert names == sorted(got)
                err = max(err, max_abs_err([ref[x] for x in names], [got[x] for x in names]))
                cases += 1
    say(f"kernel {name}: hazard bands ({cases} calls: rings with K = 2-40, N=17 under the "
        f"staged window, a circulant past the halo; M in {list(HAZARD_BAND_M)}) exact "
        f"(max_abs_err {err})")
    return err


def check_flood_kernel(module, name, args, kw, gen):
    """A FloodSub delivery kernel against its plain version on the card, on
    the captured call and on random words (the CSR kernel with its
    link-deny mask off and on). Returns (max_abs_err, io bytes, ops)."""
    import torch

    plain = getattr(module, name + "_plain")
    kernel = getattr(module, name)
    trials = [("captured", None), ("random", None)]
    if name == "csr_delivery":
        trials += [("captured", 0.7), ("random", 0.7)]
    err = 0.0
    for trial, deny in trials:
        a = list(args) if trial == "captured" else randomize_words(args, gen)
        k2 = dict(kw)
        if deny is not None:
            e = args[1].shape[0]
            k2["link_ok_e"] = (torch.rand(e, generator=gen) < deny).to(args[0].device)
        ref, got = plain(*a, **k2), kernel(*a, **k2)
        torch.cuda.synchronize()
        names = sorted(ref)
        assert names == sorted(got)
        err = max(err, max_abs_err([ref[x] for x in names], [got[x] for x in names]))
    if name == "csr_delivery":
        err = max(err, check_csr_hazards(module, args[0].device))
    else:
        err = max(err, check_band_hazards(name, args[0].device))
    res = kernel(*args, **kw)
    if name == "csr_delivery":
        e, w = args[1].shape
        ops = 12 * e * w
    else:
        n, w = args[0].shape
        ops = 12 * n * len(kw["offsets"]) * w
    io = nbytes(*kernel_reads(name, args), *res.values())
    return err, io, ops


def kernel_reads(name, args) -> list:
    """The tensor arguments a kernel call reads, for its bound: all of them,
    but csr_delivery reads the peer and edge planes, col, eperm and row_ptr
    only (not row, seg_start, row_last or row_nonempty)."""
    import torch

    if name == "csr_delivery":
        return [*args[:9], args[10], args[14]]
    return [a for a in args if isinstance(a, torch.Tensor)]


def check_csr_hazards(cd, dev) -> float:
    """csr_delivery against its plain version on the hazard graph of the
    tests (tests/torch_parity.py): M = 20, 64, 96 (W = 1, 2, 3), a row of
    200 edges at M=64, the deny mask off and on. Returns max_abs_err."""
    import numpy as np
    import torch
    from torch_parity import HAZARD_M, hazard_graph, hazard_planes

    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a.view(np.int32) if a.dtype == np.uint32 else a)).to(dev)
    err = 0.0
    for m, long_row in [(m, 0) for m in HAZARD_M] + [(64, 200)]:
        g = hazard_graph(long_row=long_row)
        for deny in (False, True):
            p = hazard_planes(m + deny, g["n"], g["e"], m)
            args = [t(p[f]) for f in ("fwd", "fe_e", "mask_e", "not_mine", "have",
                                      "first_round", "valid_row")]
            args.append(torch.tensor(int(p["tick"]), dtype=torch.int32, device=dev))
            args += [t(g[f]) for f in ("col", "row", "eperm", "seg_start", "row_last",
                                       "row_nonempty", "row_ptr")]
            link = t(p["link_ok_e"]) if deny else None
            ref = cd.csr_delivery_plain(*args, cap=g["cap"], link_ok_e=link)
            got = cd.csr_delivery(*args, cap=g["cap"], link_ok_e=link)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([ref[x] for x in sorted(ref)],
                                       [got[x] for x in sorted(ref)]))
    say(f"kernel csr_delivery: hazard graph (N={g['n']}, M in {list(HAZARD_M)}, a "
        f"200-edge row, deny off and on) exact (max_abs_err {err})")
    return err


def flood_run(sweep, convert, module, name, spec, card, gen, dev, base):
    """Phases 10 and 11: one FloodSub configuration at full size. Its kernel
    against the plain version on a real round's inputs, then the main path:
    80 rounds from a fresh state with the launch counter set to 0 just
    before and read just after. Returns the kernel's record."""
    import torch

    from go_libp2p_pubsub_tpu_torch.state import SimState

    n = spec["n"]
    st, step = sweep.build_floodsub(n, M_SLOTS, graph=spec["graph"], layout=spec["layout"],
                                    device=dev)
    net = step.net
    say(f"floodsub {spec['graph']}/{spec['layout']} N={n} K={net.max_degree} "
        f"E={net.n_edges if net.n_edges is not None else n * net.max_degree}: "
        f"host set-up {step.setup_seconds:.3f} s")
    po, pt, pv = sweep.publish_schedule(FLOOD_ROUNDS, n, 1, None)
    st = sweep.run_rounds(st, step, po[:8], pt[:8], pv[:8])
    sched = [torch.as_tensor(a[8], device=dev) for a in (po, pt, pv)]
    st, captured = capture_round(lambda s: step(s, *sched), st, module, (name,))
    args, kw = captured[name]
    err, io, ops = check_flood_kernel(module, name, args, kw, gen)
    keep_call(name, args, kw)
    launch = prepared(module._lib(), f"{name}_sims",
                      lambda: getattr(module, name)(*args, **kw))
    rec = {
        "name": name, "route": "cuda", "source": DELIVERY_SOURCE,
        "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
        **kernel_times(launch, base and base["delivery"]),
        "plain_ms": batch_ms(lambda: getattr(module, name + "_plain")(*args, **kw)),
        **bound(io, ops), "library_ms": None,
    }
    del launch
    say(f"kernel {name}: exact (max_abs_err {err}) kernel_ms={rec['ms']:.6f}"
        f"{baseline_note(rec)} "
        f"plain_ms={rec['plain_ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}, {io} bytes moved) library_ms=null")
    del st, captured, args

    # the main path: 80 rounds from a fresh state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = SimState.init(n, M_SLOTS, k=net.max_degree, device=dev, n_edges=net.n_edges)
    module.reset_launch_counts()
    t0 = time.perf_counter()
    st = sweep.run_rounds(st, step, po, pt, pv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec["launches"] = module.LAUNCHES[name]
    if rec["launches"] != FLOOD_ROUNDS or int(st.tick) != FLOOD_ROUNDS:
        raise AssertionError(f"{name} launched {rec['launches']} times in {FLOOD_ROUNDS} rounds")
    if bool(((st.dlv.fwd & ~st.dlv.have) != 0).any()):
        raise AssertionError("fwd is not a subset of have")
    reach = (st.dlv.first_round >= 0).sum(0)
    born = st.msgs.birth
    old = (born >= 0) & (born <= FLOOD_ROUNDS - 4)
    if not bool(old.any()) or not bool((reach[old] > 1).all()):
        raise AssertionError("a message published 4+ rounds ago reached only its origin")
    peak = torch.cuda.max_memory_allocated()
    leaves = convert.state_leaves(st)
    state_bytes = sum(a.nbytes for a in leaves.values())
    say(f"floodsub {spec['graph']}/{spec['layout']} N={n}: {FLOOD_ROUNDS} rounds, "
        f"{name} launches {rec['launches']}, fwd subset of have, old messages past "
        f"their origin (median reach {int(reach[old].median())} peers); events "
        f"{leaves['.events'][:9].tolist()}")
    say(f"floodsub {spec['graph']}/{spec['layout']} rate: {FLOOD_ROUNDS / dt:.3f} rounds/s "
        f"({1e3 * dt / FLOOD_ROUNDS:.3f} ms/round), peak memory {peak} bytes "
        f"({peak / 2**20:.1f} MiB), state {state_bytes} bytes, on {card}")
    return rec


def flood_parity(sweep, convert, spec):
    """Phase 12: FloodSub from the same seed on the card and on the CPU
    (plain versions) at N=8192, every leaf equal after every round."""
    po, pt, pv = sweep.publish_schedule(PARITY_ROUNDS, N_PARITY, 1, None, seed=5)
    sides = {d: sweep.build_floodsub(N_PARITY, M_SLOTS, device=d, **spec)
             for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    for r in range(PARITY_ROUNDS):
        for d, (s, stp) in list(sides.items()):
            sides[d] = (sweep.run_rounds(s, stp, po[r:r + 1], pt[r:r + 1], pv[r:r + 1]), stp)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"round {r}")
    ev = convert.state_leaves(sides["cuda"][0])[".events"]
    say(f"floodsub {spec['graph']}/{spec['layout']} card == CPU: every leaf equal after "
        f"each of {PARITY_ROUNDS} rounds at N={N_PARITY} "
        f"({time.perf_counter() - t0:.1f} s; events {ev[:9].tolist()})")


def random_rows(r: int, k: int, device, gen):
    """select_topk arguments that hold the hazards of its order: quantized
    values and noise (ties), -0.0 beside +0.0, all-masked rows and widths
    from 0 to K + 1."""
    import torch

    vals = torch.tensor([-1.5, -0.0, 0.0, 0.5, 2.0])[torch.randint(0, 5, (r, k), generator=gen)]
    noise = torch.tensor([-0.0, 0.0, 0.25, 0.5])[torch.randint(0, 4, (r, k), generator=gen)]
    mask = torch.rand((r, k), generator=gen) < 0.7
    mask[: max(1, r // 100)] = False
    k_rows = torch.randint(0, k + 2, (r,), generator=gen, dtype=torch.int32)
    return [t.to(device) for t in (vals, mask, k_rows, noise)]


def sort_form(values, mask, k_rows, noise):
    """The selection through the JAX package's fused=True rank form, on
    select_topk's arguments, timed beside the kernel: a stable sort on
    (-value, -noise) in two stable passes (secondary key first; + 0.0
    turns -0.0 into +0.0), then the inverse permutation."""
    import torch

    primary = torch.where(mask, values, float("-inf"))
    by_noise = torch.sort(-noise + 0.0, dim=-1, stable=True).indices
    by_value = torch.sort(torch.gather(-primary + 0.0, -1, by_noise), dim=-1,
                          stable=True).indices
    perm = torch.gather(by_noise, -1, by_value)
    iota = torch.arange(values.shape[-1], dtype=torch.int32,
                        device=values.device).expand(perm.shape)
    rank = torch.empty_like(iota).scatter_(-1, perm, iota)
    return (rank < k_rows[:, None]) & mask


def hazard_rows_on(r: int, k: int, device, seed: int):
    """tests/torch_parity.hazard_rows of shape [R, K] on ``device``."""
    import numpy as np
    import torch
    from torch_parity import hazard_rows

    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in hazard_rows(seed, r, k)]


def row_paths(values, mask, k_rows) -> dict:
    """How many rows of a call the kernel decides by its ballot alone
    (k <= 0, or k at or above the masked count), ranks among the masked
    slots, or ranks over all K (a masked -inf value)."""
    import torch

    c = mask.sum(1, dtype=torch.int32)
    hazard = (mask & (values == float("-inf"))).any(1)
    ballot = (k_rows <= 0) | (~hazard & (k_rows >= c))
    return {"ballot": int(ballot.sum()), "ranked": int((~ballot & ~hazard).sum()),
            "all_k": int((~ballot & hazard).sum())}


def check_select_topk(sk, captured, gen, base):
    """Phase 8: select_topk against its plain version (and, on NaN-free
    rows, the sort form) on each captured heartbeat call, on random rows of
    its shape and on hazard rows, and its times: batches of back-to-back
    launches on prepared arguments (beside the baseline's when ``base`` is
    given). Returns {tag: numbers}."""
    import torch

    out = {}
    for tag, args in captured.items():
        values, mask, k_rows, noise = args
        r, k = values.shape
        err = 0.0
        trials = [list(args)] + [random_rows(r, k, values.device, gen) for _ in range(3)]
        trials += [hazard_rows_on(r, k, values.device, seed) for seed in (1, 2)]
        for a in trials:
            ref = sk.select_topk_plain(*a)
            got = sk.select_topk(*a)
            srt = sort_form(*a)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([ref], [got]))
            nan_free = not bool(a[0].isnan().any() or a[3].isnan().any())
            if nan_free and not torch.equal(ref, srt):
                raise AssertionError("the sort form differs from the pairwise form")
        io = r * k * 10 + 4 * r        # value, noise f32 + mask, out bytes; k_rows
        # the least work ranks each row by sorting: K log2 K compares
        ops = r * k * max(1, (k - 1).bit_length())
        launch = prepared(sk._lib(), "select_topk_sims", lambda: sk.select_topk(*args))
        rec = {
            "max_abs_err": err,
            **kernel_times(launch, base and base["select_topk"]),
            "plain_ms": batch_ms(lambda: sk.select_topk_plain(*args)),
            "sort_ms": batch_ms(lambda: sort_form(*args)),
            **bound(io, ops), "rows": r, "k": k,
            "selected": int(sk.select_topk(*args).sum()),
            "row_paths": row_paths(values, mask, k_rows),
        }
        del launch
        out[tag] = rec
        say(f"kernel select_topk {tag}: R={r} K={k} exact (max_abs_err {err}, captured, "
            f"random and hazard rows) rows by path {rec['row_paths']}")
        say(f"kernel select_topk {tag}: kernel_ms={rec['ms']:.6f}{baseline_note(rec)} "
            f"plain_ms={rec['plain_ms']:.6f} "
            f"sort_ms={rec['sort_ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}, {io} bytes, {ops} operations) library_ms=null")
    return out


def build_powerlaw_gossipsub(sweep, n: int, device, count_events: bool = False):
    """The bench's default GossipSub params on topo.powerlaw(n, 2.2,
    d_min=2, max_degree=64, seed=0), CSR-resident with fused=True, from the
    port's public pieces. Returns (state, step, net, host set-up seconds)."""
    import torch

    from go_libp2p_pubsub_tpu_torch import graph, topo
    from go_libp2p_pubsub_tpu_torch.config import GossipSubParams, PeerScoreThresholds
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
        GossipSubConfig,
        GossipSubState,
        make_gossipsub_step,
    )
    from go_libp2p_pubsub_tpu_torch.state import Net

    t0 = time.perf_counter()
    tp = topo.to_topology(topo.powerlaw(n, seed=0, **sweep.POWERLAW),
                          max_degree=sweep.POWERLAW["max_degree"])
    net = Net.build(tp, graph.subscribe_all(n, 1), edge_layout="csr", fused=True,
                    device=device)
    _tp, sp = sweep.bench_score_params("default", 1)
    cfg = GossipSubConfig.build(dataclasses.replace(GossipSubParams(), flood_publish=False),
                                PeerScoreThresholds(), score_enabled=True,
                                edge_layout="csr", fused=True)
    cfg = dataclasses.replace(cfg, count_events=count_events, fanout_slots=0)
    st = GossipSubState.init(net, M_SLOTS, cfg, score_params=sp, seed=0)
    step = make_gossipsub_step(cfg, net, score_params=sp)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return st, step, net, time.perf_counter() - t0


def build_subnormal_gossipsub(sweep, n: int, device, cell: str):
    """The bench's GossipSub build on ring_lattice(n, d=8) under one of
    tests/torch_parity.SUBNORMAL_CELLS (score parameters that make float32
    subnormals), events counted. Returns (state, step)."""
    from torch_parity import subnormal_overrides

    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.config import GossipSubParams, PeerScoreThresholds
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
        GossipSubConfig,
        GossipSubState,
        make_gossipsub_step,
    )
    from go_libp2p_pubsub_tpu_torch.state import Net

    ov = subnormal_overrides(cell, n)
    net = Net.build(graph.ring_lattice(n, d=8), graph.subscribe_all(n, 1),
                    ip_group=ov["ip_group"], device=device)
    _tp, sp = sweep.bench_score_params("default", 1)
    sp = dataclasses.replace(sp, topics={t: dataclasses.replace(p, **ov.get("topic", {}))
                                         for t, p in sp.topics.items()}, **ov.get("peer", {}))
    cfg = GossipSubConfig.build(dataclasses.replace(GossipSubParams(), flood_publish=False),
                                PeerScoreThresholds(**ov.get("thresholds", {})),
                                score_enabled=True)
    cfg = dataclasses.replace(cfg, count_events=True, fanout_slots=0)
    st = GossipSubState.init(net, M_SLOTS, cfg, score_params=sp, seed=0)
    return st, make_gossipsub_step(cfg, net, score_params=sp)


PX_GATE_ROUNDS = 16            # per-round rounds before the recorded PX round


def px_observe(st) -> dict:
    """The PX cell's end state: live edges, activated edges over the
    dormant start, and the p50/p99 of ``state.hops`` over the delivered
    (peer, message) pairs (hops >= 0, the origins' 0 included, as
    scripts/parity_report.py reads them)."""
    import torch

    from go_libp2p_pubsub_tpu_torch.state import hops

    h = hops(st.core.msgs, st.core.dlv)
    got = h[h >= 0].to(torch.float32)
    q = torch.quantile(got, torch.tensor([0.5, 0.99], device=got.device)).tolist()
    return {"live_edges": int(st.edge_live.sum()), "hops_p50": q[0], "hops_p99": q[1],
            "delivered_pairs": int(got.numel())}


def px_gates(sweep, driver, dev, counters) -> dict:
    """Phase 27's launch gates at N=100k: from every count at 0, a PX
    per-round run (``PX_GATE_ROUNDS`` rounds, then one recorded round)
    launches 1 edge_exchange and 1 fused_delivery a round, a PX phase run
    (form_mesh, 2 phases, then one recorded phase) 1 + r edge_exchange a
    phase; the recorded calls (edge_exchange at C = 5, 7 and 2, one
    fused_delivery) carry the live view, dormant edges dead in it. Returns
    {"calls": {tag: (args, kw)}, "delivery": (args, kw), "live_start": n,
    "launches": {...}}."""
    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr

    r = PHASE_R
    out = {"calls": {}, "launches": {}}
    po, pt, pv = sweep.publish_schedule(PX_GATE_ROUNDS + 3 * r, N_FULL, 1, None, seed=7)
    for engine, rr in (("per-round", 1), ("phase", r)):
        st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=rr, device=dev,
                                             px=True)
        out["live_start"] = int(st.edge_live.sum())
        for mod in counters:
            mod.reset_launch_counts()
        if rr > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=rr)
            run = lambda st, sl: sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                                  rounds_per_phase=rr, heartbeat_every=rr)
            n_disp, pre = 4, slice(0, 2 * rr)
            last = slice(2 * rr, 3 * rr)
            want = {"edge_exchange": n_disp * (1 + rr), "fused_delivery": 0}
        else:
            run = lambda st, sl: sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
            n_disp, pre = PX_GATE_ROUNDS + 1, slice(0, PX_GATE_ROUNDS)
            last = slice(PX_GATE_ROUNDS, PX_GATE_ROUNDS + 1)
            want = {"edge_exchange": n_disp, "fused_delivery": n_disp}
        st = run(st, pre)
        st, got = record_calls(lambda: run(st, last),
                               [(fr, "edge_exchange"), (fr, "fused_delivery")])
        launched = counts(counters)
        want.update(delivery_banded=0, csr_delivery=0, select_topk=launched["select_topk"])
        if launched != want or launched["select_topk"] == 0:
            raise AssertionError(f"PX {engine} launches {launched} in {n_disp} dispatches, "
                                 f"expected {want}")
        out["launches"][engine] = dict(launched, dispatches=n_disp)
        for args, kw in got[(fr, "edge_exchange")]:
            out["calls"].setdefault(f"C={kw['c']}", (args, kw))
        if rr == 1:
            out["delivery"] = got[(fr, "fused_delivery")][0]
        del st, step, got
    for tag, (args, kw) in out["calls"].items():
        dead = int((args[2] == 0).sum())
        if dead == 0:
            raise AssertionError(f"PX edge_exchange {tag}: no dead edge in its live words")
    flags = out["delivery"][0][8]
    if int((((flags >> fr.F_LIVE) & 1) == 0).sum()) == 0:
        raise AssertionError("PX fused_delivery: no edge without F_LIVE")
    if sorted(out["calls"]) != ["C=2", "C=5", "C=7"]:
        raise AssertionError(f"PX edge_exchange widths {sorted(out['calls'])}")
    return out


def check_px_delivery(fr, call, gen, base, label: str = "PX") -> dict:
    """fused_delivery on the PX (or churn) round's call (F_LIVE from the
    live view), captured and on random words under the same flags: bit for
    bit against its plain version; its times beside the bound."""
    import torch

    args, kw = call
    n, k, w = args[2].shape[0], len(kw["offsets"]), kw["w"]
    err = 0.0
    for trial in ("captured", "random"):
        a = list(args) if trial == "captured" else randomize_words(args, gen)
        if trial == "random":
            a[8] = args[8]
        ref = fr.fused_delivery_plain(*a, **kw)
        got = fr.fused_delivery(*a, **kw)
        torch.cuda.synchronize()
        names = sorted(ref)
        err = max(err, max_abs_err([ref[x] for x in names], [got[x] for x in names]))
    res = fr.fused_delivery(*args, **kw)
    io = nbytes(*[t for t in args if hasattr(t, "numel")], *res.values())
    launch = prepared(fr._lib(), "fused_delivery_sims", lambda: fr.fused_delivery(*args, **kw))
    rec = {"max_abs_err": err, **kernel_times(launch, base and base["fused_round"]),
           "plain_ms": batch_ms(lambda: fr.fused_delivery_plain(*args, **kw)),
           **bound(io, 40 * n * k * w), "library_ms": None}
    del launch
    say(f"kernel fused_delivery {label} round: N={n} K={k} W={w} exact (max_abs_err {err}, "
        f"captured and random words under the live flags) kernel_ms={rec['ms']:.6f}"
        f"{baseline_note(rec)} plain_ms={rec['plain_ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"({100 * rec['bound_ms'] / rec['ms']:.1f}% of bound)")
    return rec


CHURN_RECORD_ROUND = 20         # a churn round inside the kill window (16-47)


def churn_gates(sweep, driver, dev, counters) -> dict:
    """Phase 29's launch gates at N=100k under churn (``sweep.churn_up``: a
    fifth of the peers down in rounds 16-47): from every count at 0 the
    per-round step runs rounds 0-19 and a recorded round 20, 1
    edge_exchange (C = 4) and 1 fused_delivery a round; the phase engine
    form_mesh, two phases and a recorded third (rounds 16-23), 1 + r
    edge_exchange a phase (head C = 6, data C = 2). The recorded calls'
    live words and F_LIVE flags must have whole peers dead: rows and their
    mirrored columns. Returns {"calls": {tag: (args, kw)}, "delivery":
    (args, kw), "launches": {...}, "dead_rows": n}."""
    import torch

    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr

    r = PHASE_R
    up = sweep.churn_up(N_FULL)
    down = int((~up[CHURN_RECORD_ROUND]).sum())
    po, pt, pv = sweep.publish_schedule(3 * r, N_FULL, 1, None, seed=7)
    out = {"calls": {}, "launches": {}}
    for engine, rr in (("per-round", 1), ("phase", r)):
        st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=rr, device=dev,
                                             dynamic_peers=True)
        for mod in counters:
            mod.reset_launch_counts()
        if rr > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=rr, up=torch.ones(N_FULL, dtype=bool))
            run = lambda st, sl: sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                                  rounds_per_phase=rr, heartbeat_every=rr,
                                                  up=up[sl])
            n_disp, pre, last = 4, slice(0, 2 * rr), slice(2 * rr, 3 * rr)
            want = {"edge_exchange": n_disp * (1 + rr), "fused_delivery": 0}
        else:
            run = lambda st, sl: sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl], up[sl])
            n_disp = CHURN_RECORD_ROUND + 1
            pre, last = slice(0, CHURN_RECORD_ROUND), slice(CHURN_RECORD_ROUND, n_disp)
            want = {"edge_exchange": n_disp, "fused_delivery": n_disp}
        st = run(st, pre)
        st, got = record_calls(lambda: run(st, last),
                               [(fr, "edge_exchange"), (fr, "fused_delivery")])
        launched = counts(counters)
        want.update(delivery_banded=0, csr_delivery=0, select_topk=launched["select_topk"])
        if launched != want or launched["select_topk"] == 0:
            raise AssertionError(f"churn {engine} launches {launched} in {n_disp} dispatches, "
                                 f"expected {want}")
        out["launches"][engine] = dict(launched, dispatches=n_disp)
        for args, kw in got[(fr, "edge_exchange")]:
            out["calls"].setdefault(f"C={kw['c']}", (args, kw))
        if rr == 1:
            out["delivery"] = got[(fr, "fused_delivery")][0]
        del st, step, got
    for tag, (args, kw) in out["calls"].items():
        dead_rows = int((args[2] == 0).all(1).sum())
        if dead_rows != down:
            raise AssertionError(f"churn edge_exchange {tag}: {dead_rows} dead rows in its live "
                                 f"words, {down} peers down")
    flags = out["delivery"][0][8]
    dead = ((flags >> fr.F_LIVE) & 1) == 0
    if int(dead.all(1).sum()) != down:
        raise AssertionError(f"churn fused_delivery: {int(dead.all(1).sum())} rows without "
                             f"F_LIVE, {down} peers down")
    if sorted(out["calls"]) != ["C=2", "C=4", "C=6"]:
        raise AssertionError(f"churn edge_exchange widths {sorted(out['calls'])}")
    out["dead_rows"] = down
    return out


def churn_observe(st, tick0: int) -> dict:
    """The churn cell's delivery ratio: of the messages published in rounds
    56-71 (the run publishes nothing in rounds 72-79, so their slots
    survive), the share of (peer, message) pairs delivered by round 80,
    every peer up by then (on the ring lattice a message reaches about 16
    peers more a round, so the share is small at N=100k and is held against
    the same schedule run without churn)."""
    import torch

    born = st.core.msgs.birth - tick0
    cols = (born >= 56) & (born <= 71) & (st.core.msgs.origin >= 0)
    got = (st.core.dlv.first_round[:, cols] >= 0)
    return {"ratio_56_71": float(got.to(torch.float64).mean()), "messages": int(cols.sum())}


def churn_runs(sweep, driver, dev, card, counters) -> dict:
    """Phase 29's runs at N=100k: both engines (the phase engine at r=8
    after form_mesh) over the 80-round churn schedule with the bench's
    publishes (none in rounds 72-79), eager with the event counters on and
    through driver.make_scan without them (a window first captures its
    32-round block on an untimed call, so no capture lands in the timing),
    each also without churn (every peer up) as its reference: rounds 16-79
    timed; mesh edges before the kill, after round 47 and at the end;
    EV.REMOVE_PEER and EV.ADD_PEER (20,000 each, eager); the delivery ratio
    of the messages of rounds 56-71, which must be the run without churn's
    within 5%; peak memory."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    up = sweep.churn_up(N_FULL)
    rounds = up.shape[0]
    po, pt, pv = sweep.publish_schedule(rounds, N_FULL, 1, None, seed=11)
    po[72:] = -1
    victims = int((~up[16]).sum())
    out = {}
    for engine, rr in (("per-round", 1), ("phase", PHASE_R)):
        for mode in ("eager", "eager, no churn", "window", "window, no churn"):
            rows = np.ones_like(up) if mode.endswith("no churn") else up
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eager_mode = mode.startswith("eager")
            st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=rr,
                                                 device=dev, dynamic_peers=True,
                                                 count_events=eager_mode)
            if rr > 1:
                st = driver.form_mesh(step, st, rounds_per_phase=rr,
                                      up=torch.ones(N_FULL, dtype=bool))
            tick0 = int(st.core.tick)
            if eager_mode:
                if rr > 1:
                    run = lambda st, sl: sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                                          rounds_per_phase=rr,
                                                          heartbeat_every=rr, up=rows[sl])
                else:
                    run = lambda st, sl: sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl],
                                                          rows[sl])
            else:
                scan = (driver.make_scan(step, heartbeat_every=rr, rounds_per_phase=rr, unroll=2)
                        if rr > 1 else driver.make_scan(step, static_heartbeat=False, unroll=4))
                run = lambda st, sl: scan(st, po[sl], pt[sl], pv[sl], rows[sl])
                for mod in counters:
                    mod.reset_launch_counts()
                # capture the block at the widest call's row capacity on an
                # untimed call from the same state (which the window copies
                # into its buffers and leaves as it is)
                run(st, slice(16, 48))
            st = run(st, slice(0, 16))
            mesh = [int(st.mesh.sum())]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = run(st, slice(16, 48))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            mesh.append(int(st.mesh.sum()))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = run(st, slice(48, rounds))
            torch.cuda.synchronize()
            dt += time.perf_counter() - t0
            rec = {"rate": (rounds - 16) / dt, "peak": torch.cuda.max_memory_allocated(),
                   "mesh_edges": mesh + [int(st.mesh.sum())],
                   **churn_observe(st, tick0)}
            if mode == "eager":
                rec["remove_peer"] = int(st.core.events[EV.REMOVE_PEER])
                rec["add_peer"] = int(st.core.events[EV.ADD_PEER])
                if rec["remove_peer"] != victims or rec["add_peer"] != victims:
                    raise AssertionError(f"churn {engine}: REMOVE_PEER {rec['remove_peer']}, "
                                         f"ADD_PEER {rec['add_peer']}, {victims} victims")
            elif not eager_mode:
                win = scan.window
                rec.update(capture_seconds=win.capture_seconds, replays=win.replays,
                           block_launches={k: v for k, v in win.block_launches.items() if v},
                           block_dispatches=win.block_dispatches)
                del scan, win
            if rec["messages"] != 64:
                raise AssertionError(f"churn {engine} {mode}: {rec['messages']} messages of "
                                     "rounds 56-71")
            if not mode.endswith("no churn") and not rec["mesh_edges"][1] < rec["mesh_edges"][0]:
                raise AssertionError(f"churn {engine} {mode}: mesh edges {rec['mesh_edges']}")
            unit = "delivery-rounds/s" if rr > 1 else "rounds/s"
            say(f"churn {engine} {mode} N={N_FULL}: {rec['rate']:.3f} {unit} over rounds "
                f"16-79, peak memory {rec['peak']} bytes, "
                + ", ".join(f"{k} {v}" for k, v in rec.items() if k not in ("rate", "peak"))
                + f", on {card}")
            out[f"{engine} {mode}"] = rec
            del st, step
        # the churned runs deliver the messages of rounds 56-71 as the run
        # without churn does (the victims have re-meshed by round 56)
        for mode in ("eager", "window"):
            ref = out[f"{engine} {mode}, no churn"]["ratio_56_71"]
            got = out[f"{engine} {mode}"]["ratio_56_71"]
            if got < 0.95 * ref:
                raise AssertionError(f"churn {engine} {mode}: delivery ratio {got} of rounds "
                                     f"56-71 against {ref} without churn")
    return out


OVERLAY_DISPATCHES = 32          # phase 30's storm: 32 rounds, a dispatch a round


def overlay_runs(sweep, driver, dev, card, counters) -> dict:
    """Phase 30: the mutating overlay at N=100k (``sweep.build_overlay``:
    powerlaw(100k, 2.2, d_min=2, max_degree=60) padded to K = 64, built
    dynamic, dense and full-capacity CSR, E = 6.4M) under one churn_storm
    of OVERLAY_DISPATCHES dispatches: the storm's compile seconds, batch
    width and hash; from every count at 0 an eager run launches no
    edge_exchange, fused_delivery, delivery_banded or csr_delivery and 8
    select_topk a heartbeat; rounds/s eager (all the dispatches) and
    through driver.make_window (the second half, after a first call of
    the first half that captures); peak memory; the
    storm's kills, joins and rewires; the device overlay equal to the
    storm's host mirror at the end."""
    import torch

    from go_libp2p_pubsub_tpu_torch.topo.dynamics import PAD_SLOT

    storm, out = None, {}
    for layout in ("dense", "csr"):
        for mode in ("eager", "window"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            st, step, storm, secs = sweep.build_overlay(N_FULL, M_SLOTS, OVERLAY_DISPATCHES,
                                                        edge_layout=layout, device=dev,
                                                        storm=storm)
            if "storm" not in out:
                writes, up = storm.build()
                out["storm"] = {"seconds": secs, "batch": int(writes.shape[1]),
                                "hash": storm.schedule_hash(), "kills": storm.n_kills,
                                "joins": storm.n_joins, "rewires": storm.n_rewires,
                                "write_rows": int((writes[:, :, 0] != PAD_SLOT).sum())}
                say(f"overlay storm N={N_FULL}: compiled in {secs:.3f} s on the host, "
                    + json.dumps(out["storm"]) + f", the run on {card}")
            d = OVERLAY_DISPATCHES
            po, pt, pv = sweep.publish_schedule(d, N_FULL, 1, None, seed=13)
            xs = [torch.as_tensor(a, device=dev) for a in (po, pt, pv, up, writes)]
            for mod in counters:
                mod.reset_launch_counts()
            if mode == "eager":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for t in range(d):
                    st = step(st, *(a[t] for a in xs))
                torch.cuda.synchronize()
                rate = d / (time.perf_counter() - t0)
                launched = counts(counters)
                want = {"edge_exchange": 0, "fused_delivery": 0, "delivery_banded": 0,
                        "csr_delivery": 0, "select_topk": SELECTIONS_PER_HEARTBEAT * d}
                if launched != want:
                    raise AssertionError(f"overlay {layout} launches {launched} in {d} rounds, "
                                         f"expected {want}")
                rec = {"rate": rate, "launches": launched}
            else:
                win = driver.make_window(step, unroll=4)
                half = d // 2
                st, _ = win(st, [a[:half] for a in xs])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, _ = win(st, [a[half:] for a in xs])
                torch.cuda.synchronize()
                rate = half / (time.perf_counter() - t0)
                rec = {"rate": rate, "capture_seconds": win.capture_seconds,
                       "replays": win.replays,
                       "block_launches": {k: v for k, v in win.block_launches.items() if v}}
                del win
            if not torch.equal(st.core.topo.nbr.cpu(), torch.from_numpy(storm.nbr)):
                raise AssertionError(f"overlay {layout} {mode}: the device overlay differs "
                                     "from the storm's host mirror")
            rec.update(peak=torch.cuda.max_memory_allocated(), mesh_edges=int(st.mesh.sum()),
                       n_edges=N_FULL * 64 if layout == "csr" else None)
            say(f"overlay {layout} {mode} N={N_FULL}: {rec['rate']:.3f} rounds/s, "
                + ", ".join(f"{k} {v}" for k, v in rec.items() if k != "rate")
                + f", on {card}")
            out[f"{layout} {mode}"] = rec
            del st, step
    return out


def dynamic_parity(sweep, driver, convert, dev) -> None:
    """Phase 31: card against CPU at N=8192, every leaf after every round or
    phase: the churn cell in both engines (the per-round step 24 rounds, a
    fifth down in rounds 8-15; the phase engine form_mesh and 3 phases,
    down for phase 1) and the mutating overlay dense and CSR (its own
    power-law net at N=8192, a storm of 8 dispatches); then each window
    (make_scan with the liveness rows; make_window with the rows and the
    write batches) against its eager loop on the card."""
    import torch

    t0 = time.perf_counter()
    n, r = N_PARITY, PHASE_R
    up = sweep.churn_up(n, rounds=3 * r, down_at=8, up_at=16)
    po, pt, pv = sweep.publish_schedule(3 * r, n, 1, None, seed=5)
    for engine, rr in (("per-round", 1), ("phase", r)):
        sides = {}
        for d in ("cuda", "cpu"):
            st, step, _t, _h = sweep.build_bench(n, M_SLOTS, rounds_per_phase=rr, device=d,
                                                 count_events=True, dynamic_peers=True)
            if rr > 1:
                st = driver.form_mesh(step, st, rounds_per_phase=rr,
                                      up=torch.ones(n, dtype=bool))
            sides[d] = [st, step]
        for i in range(3 * r // rr):
            sl = slice(i * rr, (i + 1) * rr)
            for d, (st, step) in sides.items():
                sides[d][0] = (sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                                rounds_per_phase=rr, heartbeat_every=rr,
                                                up=up[sl]) if rr > 1
                               else sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl], up[sl]))
            leaves_equal(convert.state_leaves(sides["cpu"][0]),
                         convert.state_leaves(sides["cuda"][0]),
                         f"churn {engine} card against CPU, dispatch {i}")
        say(f"churn {engine} card == CPU: every leaf equal after each of {3 * r // rr} "
            f"dispatches at N={n} (a fifth of the peers down and back)")
        leaves = []
        for mode in ("eager", "window"):
            st, step, _t, _h = sweep.build_bench(n, M_SLOTS, rounds_per_phase=rr, device=dev,
                                                 count_events=True, dynamic_peers=True)
            if rr > 1:
                st = driver.form_mesh(step, st, rounds_per_phase=rr,
                                      up=torch.ones(n, dtype=bool))
            if mode == "eager":
                st = (sweep.run_phases(st, step, po, pt, pv, rounds_per_phase=rr,
                                       heartbeat_every=rr, up=up) if rr > 1
                      else sweep.run_rounds(st, step, po, pt, pv, up))
            else:
                scan = (driver.make_scan(step, heartbeat_every=rr, rounds_per_phase=rr, unroll=2)
                        if rr > 1 else driver.make_scan(step, static_heartbeat=False, unroll=4))
                half = 2 * r
                st = scan(st, po[:half], pt[:half], pv[:half], up[:half])
                st = scan(st, po[half:], pt[half:], pv[half:], up[half:])
                torch.cuda.synchronize()
            leaves.append(convert.state_leaves(st))
            del st, step
        leaves_equal(leaves[0], leaves[1], f"churn {engine} window against eager")
        say(f"churn {engine} window N={n}: equal to the eager loop leaf for leaf in two calls")
    storm = None
    d_disp = 8
    for layout in ("dense", "csr"):
        sides = {}
        for d in ("cuda", "cpu"):
            st, step, storm, _s = sweep.build_overlay(n, M_SLOTS, d_disp, edge_layout=layout,
                                                      device=d, count_events=True, storm=storm)
            sides[d] = [st, step]
        writes, upw = storm.build()
        po2, pt2, pv2 = sweep.publish_schedule(d_disp, n, 1, None, seed=9)
        for t in range(d_disp):
            for d, (st, step) in sides.items():
                sides[d][0] = sweep.run_rounds(st, step, po2[t:t + 1], pt2[t:t + 1],
                                               pv2[t:t + 1], upw[t:t + 1], writes[t:t + 1])
            leaves_equal(convert.state_leaves(sides["cpu"][0]),
                         convert.state_leaves(sides["cuda"][0]),
                         f"overlay {layout} card against CPU, round {t}")
        eager = sides["cuda"][0]
        del sides
        st, step, _st, _s = sweep.build_overlay(n, M_SLOTS, d_disp, edge_layout=layout,
                                                device=dev, count_events=True, storm=storm)
        win = driver.make_window(step, unroll=2)
        xs = [torch.as_tensor(a, device=dev) for a in (po2, pt2, pv2, upw, writes)]
        st, _ = win(st, [a[:d_disp // 2] for a in xs])
        st, _ = win(st, [a[d_disp // 2:] for a in xs])
        leaves_equal(convert.state_leaves(eager), convert.state_leaves(st),
                     f"overlay {layout} window against eager")
        say(f"overlay {layout} card == CPU: every leaf equal after each of {d_disp} rounds at "
            f"N={n} (B={writes.shape[1]}); the window equal to the eager loop in two calls")
        del st, step, eager, win
    say(f"dynamic parity phases: {time.perf_counter() - t0:.1f} s")


def bench_launches(card: str) -> dict:
    """Kernel launches of a traced GossipSub bench round (perf/profile.py,
    4 warm rounds, 4 traced), and those of the score path's subnormal flush
    (the host ops hardshrink and copysign, which nothing else on the path
    calls); then those of a traced phase-bench phase (r=8: 2 warm phases, 1
    traced) per delivery round."""
    from go_libp2p_pubsub_tpu_torch.perf import profile

    rep = profile.profile_rounds(N_FULL, warm=4, rounds=4)
    flush = sum(v for op, v in rep["launches_by_op_per_round"].items()
                if "hardshrink" in op or "copysign" in op)
    total = rep["kernel_launches_per_round"]
    if total != DEFAULT_LAUNCHES[0]:
        raise AssertionError(f"{total} kernel launches a bench round, expected "
                             f"{DEFAULT_LAUNCHES[0]}")
    say(f"slice launches: {total:.1f} kernel launches a bench round, {flush:.1f} of them the "
        f"subnormal flush of the score path ({total - flush:.1f} without it); device busy "
        f"{rep['device_busy_share_untraced']:.4f} of an untraced round "
        f"({rep['untraced_ms_per_round']:.3f} ms), on {card}")
    ph = profile.profile_rounds(N_FULL, warm=2 * PHASE_R, rounds=PHASE_R,
                                rounds_per_phase=PHASE_R)
    if ph["kernel_launches_per_round"] != DEFAULT_LAUNCHES[1]:
        raise AssertionError(f"{ph['kernel_launches_per_round']} kernel launches a phase "
                             f"bench delivery round, expected {DEFAULT_LAUNCHES[1]}")
    say(f"phase launches: {ph['kernel_launches_per_round']:.1f} kernel launches a delivery "
        f"round of the phase bench (r={PHASE_R}; {PHASE_R * ph['kernel_launches_per_round']:.0f}"
        f" a phase) against {total:.1f} a per-round bench round; device busy "
        f"{ph['device_busy_share_untraced']:.4f} of an untraced phase "
        f"({ph['untraced_ms_per_round']:.3f} ms a round), on {card}")
    win = profile.profile_rounds(N_FULL, warm=2 * PHASE_R, rounds=4 * PHASE_R,
                                 rounds_per_phase=PHASE_R, window=True)
    top = "; ".join(f"{k['name'][:90]} {k['us_per_round']:.1f} us"
                    for k in win["kernels"][:5])
    say(f"windowed phase: {win['untraced_ms_per_round']:.3f} ms a delivery round untraced "
        f"({1e3 / win['untraced_ms_per_round']:.3f} delivery-rounds/s), device busy "
        f"{win['device_busy_share_untraced']:.4f} of it, "
        f"{win['kernel_launches_per_round']:.1f} kernels a delivery round in a traced "
        f"replay, {win['graph_replays_per_window']} graph replays a window of "
        f"{4 * PHASE_R} rounds; by device time a round: {top}; on {card}")
    return {"launches_per_round": total, "flush_launches_per_round": flush,
            "phase_launches_per_round": ph["kernel_launches_per_round"]}


def config_traced_launches(card: str) -> dict:
    """Phase 29 (after bench_launches): every kernel launch of a traced
    round of each config's per-round step and of a traced phase of its
    phase engine, per delivery round (perf/profile.py), at the configs'
    full sizes."""
    from go_libp2p_pubsub_tpu_torch.perf import profile

    out = {}
    for config in ("eth2", "sybil"):
        n = CONFIG_N[config]
        pr = profile.profile_rounds(n, warm=4, rounds=4, config=config)
        ph = profile.profile_rounds(n, warm=2 * PHASE_R, rounds=PHASE_R,
                                    rounds_per_phase=PHASE_R, config=config)
        out[config] = (pr["kernel_launches_per_round"], ph["kernel_launches_per_round"])
        say(f"{config} launches N={n}: {pr['kernel_launches_per_round']:.1f} kernel launches a "
            f"per-round step round (device busy {pr['device_busy_share_untraced']:.4f} of an "
            f"untraced round, {pr['untraced_ms_per_round']:.3f} ms), "
            f"{ph['kernel_launches_per_round']:.1f} a delivery round of the phase engine "
            f"(r={PHASE_R}; device busy {ph['device_busy_share_untraced']:.4f}, "
            f"{ph['untraced_ms_per_round']:.3f} ms a round), on {card}")
    return out


def gossip_state_checks(st, net, total: int, where: str, degree_range=None,
                        every_message: bool = True):
    """tick == total, mesh only on present edges (and, given a range, every
    mesh degree in it), fwd a subset of have, every message 4+ rounds old
    past its origin (with ``every_message`` False, some of them: a topic
    of eth2's 64 meets few subscribers on the lattice, and a publish with
    none among the origin's neighbours stays with the origin). Returns
    (min, mean, max) mesh degree."""
    assert int(st.core.tick) == total, where
    if bool((st.mesh & ~net.nbr_ok[:, None, :]).any()):
        raise AssertionError(f"{where}: a mesh link on an absent edge")
    deg = st.mesh.sum(-1)
    dmin, dmax = int(deg.min()), int(deg.max())
    if degree_range is not None and not (degree_range[0] <= dmin and dmax <= degree_range[1]):
        raise AssertionError(f"{where}: mesh degrees [{dmin}, {dmax}] outside "
                             f"[Dlo, Dhi] = {list(degree_range)}")
    if bool(((st.core.dlv.fwd & ~st.core.dlv.have) != 0).any()):
        raise AssertionError(f"{where}: fwd is not a subset of have")
    reach = (st.core.dlv.first_round >= 0).sum(0)
    born = st.core.msgs.birth
    old = (born >= 0) & (born <= total - 4)
    spread = (reach[old] > 1).all() if every_message else (reach[old] > 1).any()
    if not bool(old.any()) or not bool(spread):
        raise AssertionError(f"{where}: a message published 4+ rounds ago reached "
                             "only its origin")
    return dmin, float(deg.float().mean()), dmax


def gossip_parity(sweep, convert, name, build, rounds: int = PARITY_ROUNDS):
    """Phases 5 and 9: one GossipSub build from the same seed on the card
    and on the CPU (plain versions) at N=8192, every leaf equal after each
    of ``rounds`` rounds (32; the subnormal cells and phase 9 16); ``build(device)``
    returns (state, step)."""
    po, pt, pv = sweep.publish_schedule(rounds, N_PARITY, 1, None, seed=5)
    sides = {d: build(d) for d in ("cuda", "cpu")}
    t0 = time.perf_counter()
    for r in range(rounds):
        for d, (s, stp) in list(sides.items()):
            sides[d] = (sweep.run_rounds(s, stp, po[r:r + 1], pt[r:r + 1], pv[r:r + 1]), stp)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"{name} round {r}")
    ev = convert.state_leaves(sides["cuda"][0])[".core.events"]
    say(f"{name} card == CPU: every leaf equal after each of {rounds} rounds at "
        f"N={N_PARITY} ({time.perf_counter() - t0:.1f} s; events {ev.tolist()})")


def capture_calls(run, module, name: str):
    """Run ``run()``, recording every call of ``module.name`` (args, kwargs)
    in order. Returns (its result, the calls)."""
    out, calls = record_calls(run, [(module, name)])
    return out, calls[(module, name)]


def phase_bench(sweep, driver, convert, layout, card, dev, counters, csr_net,
                dense_final=None):
    """Phases 13 and 14: the phase engine at full width. From a fresh
    state with every launch count at 0: form_mesh, the formation phases,
    then the timed phases; the launch, degree and subset checks; on CSR,
    the final state densified against the dense run's leaves. Returns
    (final leaves, edge_exchange launches, the edge_exchange calls of one
    more phase, tagged by C)."""
    import torch

    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk
    from go_libp2p_pubsub_tpu_torch.state import densify_edge_planes

    r = PHASE_R
    n_phases = 1 + PHASE_FORMATION + PHASE_MEASURED
    total = n_phases * r
    f, m = PHASE_FORMATION * r, PHASE_MEASURED * r
    po, pt, pv = sweep.publish_schedule(f + m + r, N_FULL, 1, None)
    tag = "phase bench" if layout == "dense" else "CSR phase bench"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, edge_layout=layout,
                                         fused=layout == "csr", rounds_per_phase=r,
                                         device=dev)
    run = lambda st, sl: sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                          rounds_per_phase=r, heartbeat_every=r)
    for mod in counters:
        mod.reset_launch_counts()
    st = driver.form_mesh(step, st, rounds_per_phase=r)
    st = run(st, slice(0, f))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st, slice(f, f + m))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {}
    for mod in counters:
        launches.update(mod.LAUNCHES)
    want = {"edge_exchange": n_phases * (1 + r) if layout == "dense" else 0,
            "fused_delivery": 0, "csr_delivery": 0, "delivery_banded": 0,
            "select_topk": SELECTIONS_PER_HEARTBEAT * n_phases}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    dmin, _mean, dmax = gossip_state_checks(st, csr_net, total, tag, (5, 12))
    peak = torch.cuda.max_memory_allocated()
    leaves = convert.state_leaves(densify_edge_planes(csr_net, st) if layout == "csr" else st)
    state_bytes = sum(a.nbytes for a in convert.state_leaves(st).values())
    note = ""
    if dense_final is not None:
        leaves_equal(dense_final, leaves, f"{tag} final state against the dense phase bench's")
        note = ", final state densified equal to phase 13's leaf for leaf"
    say(f"{tag} N={N_FULL} M={M_SLOTS} K=16 r={r}: form_mesh + {PHASE_FORMATION} + "
        f"{PHASE_MEASURED} phases ({total} rounds), launches {launches}, mesh degree "
        f"[{dmin}, {dmax}], fwd subset of have{note}")
    say(f"{tag} rate: {m / dt:.3f} delivery-rounds/s over {m} rounds ({PHASE_MEASURED} "
        f"phases; {1e3 * dt / m:.3f} ms/round), peak memory {peak} bytes "
        f"({peak / 2**20:.1f} MiB), state {state_bytes} bytes, on {card}")
    calls = {}
    if layout == "dense":
        _st, got = capture_calls(lambda: run(st, slice(f + m, f + m + r)), fr, "edge_exchange")
        for args, kw in got:
            calls.setdefault(f"C={kw['c']}", (args, kw))
        del _st
    del st
    return leaves, launches["edge_exchange"], calls


def phase_parity(sweep, driver, convert, layout):
    """Phase 15: the phase engine from the same seed on the card and on the
    CPU (plain versions) at N=8192, r=8, events counted, every leaf equal
    after form_mesh and after every phase."""
    r = PHASE_R
    po, pt, pv = sweep.publish_schedule(PHASE_PARITY_PHASES * r, N_PARITY, 1, None, seed=5)
    sides = {}
    for d in ("cuda", "cpu"):
        st, step, _t, _h = sweep.build_bench(N_PARITY, M_SLOTS, count_events=True,
                                             edge_layout=layout, fused=layout == "csr",
                                             rounds_per_phase=r, device=d)
        sides[d] = (driver.form_mesh(step, st, rounds_per_phase=r), step)
    leaves_equal(convert.state_leaves(sides["cpu"][0]), convert.state_leaves(sides["cuda"][0]),
                 f"phase engine {layout} form_mesh")
    t0 = time.perf_counter()
    for p in range(PHASE_PARITY_PHASES):
        sl = slice(p * r, (p + 1) * r)
        for d, (st, step) in list(sides.items()):
            sides[d] = (sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=r,
                                         heartbeat_every=r), step)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"phase engine {layout} phase {p}")
    ev = convert.state_leaves(sides["cuda"][0])[".core.events"]
    say(f"phase engine {layout} card == CPU: every leaf equal after form_mesh and each of "
        f"{PHASE_PARITY_PHASES} phases of r={r} at N={N_PARITY} "
        f"({time.perf_counter() - t0:.1f} s; events {ev.tolist()})")


def check_phase_exchange(fr, calls, gen, base, label: str = "phase") -> dict:
    """Phase 16: edge_exchange on the phase engine's calls (the control
    head at C = 6 with scores, a data sub-round at C = 2 without), captured
    and on random words: bit for bit against the plain version; times of
    the kernel (prepared launches), the plain version and the one-call
    gather, beside the bound (and the baseline's kernel on the same
    arguments when ``base`` holds the baseline's libraries). Returns
    {tag: numbers}."""
    import torch

    out = {}
    for tag, (args, kw) in sorted(calls.items(), key=lambda kv: -kv[1][1]["c"]):
        wire, scores, live = args
        n, k, c = wire.shape[0], len(kw["offsets"]), kw["c"]
        err = 0.0
        for trial in ("captured", "random"):
            a = list(args) if trial == "captured" else randomize_words(args, gen)
            if trial == "random":
                a[2] = (torch.rand(live.shape, generator=gen) < 0.9).to(torch.int32).to(
                    live.device)
            ref = fr.edge_exchange_plain(*a, **kw)
            got = fr.edge_exchange(*a, **kw)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(ref, got))
        out_w, out_s = fr.edge_exchange(*args, **kw)
        io = nbytes(wire, scores if kw["score_enabled"] else None, live, out_w, out_s)
        ops = n * k * c + (n * k if kw["score_enabled"] else 0)
        perm = (((torch.arange(n, device=wire.device)[:, None]
                  + torch.tensor(kw["offsets"], device=wire.device)[None, :]) % n) * k
                + torch.tensor(kw["revs"], device=wire.device)[None, :]).reshape(-1)
        flat = wire.view(n * k, c)
        launch = prepared(fr._lib(), "edge_exchange_sims",
                          lambda: fr.edge_exchange(*args, **kw))
        rec = {"c": c, "scores": bool(kw["score_enabled"]), "max_abs_err": err,
               **kernel_times(launch, base and base["fused_round"]),
               "cold_ms": cold_ms(launch),
               "plain_ms": batch_ms(lambda: fr.edge_exchange_plain(*args, **kw)),
               **bound(io, ops), "library_ms": batch_ms(lambda: flat[perm])}
        del launch
        out[tag] = rec
        say(f"kernel edge_exchange {label} {tag}: N={n} K={k} scores={rec['scores']} exact "
            f"(max_abs_err {err}, captured and random) kernel_ms={rec['ms']:.6f}"
            f"{baseline_note(rec)} "
            f"plain_ms={rec['plain_ms']:.6f} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}, {io} bytes moved; {100 * rec['bound_ms'] / rec['ms']:.1f}% of "
            f"bound) cold_ms={rec['cold_ms']:.6f} (L2 written over before each call: "
            f"{100 * rec['bound_ms'] / rec['cold_ms']:.1f}% of bound) "
            f"library_ms={rec['library_ms']:.6f}")
    return out


def window_cells(sweep, dev):
    """Phase 17's cells at N=8192: name -> (build() -> (state, step),
    eager(state, step, po, pt, pv) -> state, window(step) -> run(state, po,
    pt, pv) -> state)."""
    from go_libp2p_pubsub_tpu_torch import driver

    r = PHASE_R

    def phase(layout):
        def build():
            st, step, _t, _h = sweep.build_bench(N_PARITY, M_SLOTS, count_events=True,
                                                 edge_layout=layout, fused=layout == "csr",
                                                 rounds_per_phase=r, device=dev)
            return driver.form_mesh(step, st, rounds_per_phase=r), step
        eager = lambda st, step, *x: sweep.run_phases(st, step, *x, rounds_per_phase=r,
                                                     heartbeat_every=r)
        window = lambda step: driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r,
                                               unroll=2)
        return build, eager, window

    def static_hb():
        he = 2

        def eager(st, step, po, pt, pv):
            for i in range(len(po)):
                st = step(st, *(torch_row(a, i, dev) for a in (po, pt, pv)),
                          do_heartbeat=i % he == 0)
            return st
        build = lambda: sweep.build_bench(N_PARITY, M_SLOTS, count_events=True,
                                          heartbeat_every=he, device=dev)[:2]
        window = lambda step: driver.make_scan(step, heartbeat_every=he,
                                               static_heartbeat=True, unroll=2)
        return build, eager, window

    def flood(graph, layout):
        build = lambda: sweep.build_floodsub(N_PARITY, M_SLOTS, graph=graph, layout=layout,
                                             device=dev)
        eager = lambda st, step, *x: sweep.run_rounds(st, step, *x)

        def window(step):
            win = driver.make_window(step, unroll=4)
            run = lambda st, *x: win(st, x)[0]
            run.window = win
            return run
        return build, eager, window

    return {"phase engine dense": phase("dense"), "phase engine csr": phase("csr"),
            "per-round step he=2": static_hb(), "floodsub lattice": flood("lattice", "dense"),
            "floodsub power-law csr": flood("powerlaw", "csr")}


def record_calls(run, targets, keep: int | None = None):
    """Run ``run()`` with every ``module.name`` of ``targets`` recording its
    calls (the first ``keep`` of each when given: a RandomSub draw at N=1M
    holds 576 MB of arguments). Returns (the result, {(module, name):
    [(args, kwargs), ...]})."""
    calls = {t: [] for t in targets}
    origs = {t: getattr(*t) for t in targets}

    def recorder(t):
        def call(*args, **kwargs):
            if keep is None or len(calls[t]) < keep:
                calls[t].append((args, kwargs))
            return origs[t](*args, **kwargs)
        return call

    for t in targets:
        setattr(t[0], t[1], recorder(t))
    try:
        out = run()
    finally:
        for t in targets:
            setattr(t[0], t[1], origs[t])
    return out, calls


def torch_row(a, i, dev):
    import torch

    return torch.as_tensor(a[i], device=dev)


def window_parity(sweep, convert, dev, counters) -> dict:
    """Phase 17: every window equals its eager loop on the card, leaf for
    leaf, in two calls; then every kernel captured alone. Returns the
    wrappers' launches a captured block of each window."""
    import torch
    from torch_parity import graph_replay_equals_eager

    from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as cd
    from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db
    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk

    po, pt, pv = sweep.publish_schedule(WINDOW_ROUNDS, N_PARITY, 1, None, seed=6)
    half = WINDOW_ROUNDS * 2 // 3
    blocks, calls = {}, {}
    for name, (build, eager, window) in window_cells(sweep, dev).items():
        st, step = build()
        # the eager run, every kernel call recorded
        out, got = record_calls(lambda: eager(st, step, po, pt, pv),
                                [(fr, "edge_exchange"), (fr, "fused_delivery"),
                                 (sk, "select_topk"), (db, "delivery_banded"),
                                 (cd, "csr_delivery")])
        for (mod, fn), recorded in got.items():
            for args, kw in recorded:
                key = fn if fn != "edge_exchange" else f"edge_exchange C={kw['c']}"
                calls.setdefault(key, (getattr(mod, fn), args, kw))
        want_leaves = convert.state_leaves(out)
        del out
        st, step = build()
        run = window(step)
        for m in counters:
            m.reset_launch_counts()
        st = run(st, po[:half], pt[:half], pv[:half])
        st = run(st, po[half:], pt[half:], pv[half:])
        torch.cuda.synchronize()
        win = run.window
        leaves_equal(want_leaves, convert.state_leaves(st), f"{name} window against eager")
        launched = {k: v for k, v in win.block_launches.items() if v}
        if win.replays < 2 or not launched:
            raise AssertionError(f"{name}: the window replayed {win.replays} graphs with "
                                 f"block launches {win.block_launches}")
        blocks[name] = {"block_dispatches": win.block_dispatches, "launches": launched,
                        "replays": win.replays, "capture_seconds": win.capture_seconds}
        say(f"window {name} N={N_PARITY}: equal to the eager loop leaf for leaf after "
            f"{WINDOW_ROUNDS} rounds in two calls ({half} + {WINDOW_ROUNDS - half}); "
            f"{win.replays} graph replays, {win.captures} capture "
            f"({win.capture_seconds:.3f} s), a block of {win.block_dispatches} dispatches "
            f"launches {launched}")
        del st, step, run, win
    for key in sorted(calls):
        fn, args, kw = calls[key]
        n = graph_replay_equals_eager(lambda: fn(*args, **kw))
        if n != 1:
            raise AssertionError(f"{key}: {n} wrapper launches captured, expected 1")
        say(f"kernel {key} captured alone in a graph: the replay equals the eager launch "
            f"bit for bit")
    missing = {"edge_exchange C=2", "edge_exchange C=4", "edge_exchange C=6",
               "fused_delivery", "select_topk", "delivery_banded", "csr_delivery"} - set(calls)
    if missing:
        raise AssertionError(f"no call of {sorted(missing)} in the window cells")
    return blocks


def window_bench(sweep, driver, dev, card, counters, engine: str, observe=None,
                 modes=("eager", "window", "window", "eager"), measured: int | None = None,
                 **bench_kw) -> dict:
    """Phases 18, 25 and 27: the phase bench (``engine="phase"``) or the
    per-round bench at N=100k (with ``bench_kw``, the delivery core's
    options or the PX cell's), eager and windowed in turns (eager, window,
    window, eager). Each turn builds afresh, forms the mesh, runs the
    formation and one untimed segment, then times one segment; a window
    turn's untimed segment captures its block. ``observe(state) -> dict``
    reads each turn's final state into its record; ``modes`` are the turns
    (phase 33 takes one of each); ``measured`` the rounds of a segment
    (default: the bench's). Returns the turns."""
    import torch

    r = PHASE_R if engine == "phase" else 1
    m = PHASE_MEASURED * r if engine == "phase" else MEASURED_ROUNDS
    m = measured or m
    f = PHASE_FORMATION * r if engine == "phase" else FORMATION_ROUNDS
    po, pt, pv = sweep.publish_schedule(f + 2 * m, N_FULL, 1, None)
    turns = []
    for mode in modes:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=r, device=dev,
                                             **bench_kw)
        if r > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=r)
            eager = lambda st, sl: sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                                    rounds_per_phase=r, heartbeat_every=r)
        else:
            eager = lambda st, sl: sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
        st = eager(st, slice(0, f))
        run, rec = eager, {"mode": mode}
        if mode == "window":
            scan = (driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r, unroll=2)
                    if r > 1 else driver.make_scan(step, static_heartbeat=False, unroll=4))
            run = lambda st, sl: scan(st, po[sl], pt[sl], pv[sl])
            for mod in counters:
                mod.reset_launch_counts()
        st = run(st, slice(f, f + m))
        torch.cuda.synchronize()
        if mode == "window":
            replays0 = scan.window.replays
        t0 = time.perf_counter()
        st = run(st, slice(f + m, f + 2 * m))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec.update(rate=m / dt, peak=torch.cuda.max_memory_allocated())
        if mode == "window":
            win = scan.window
            counted = {}
            for mod in counters:
                counted.update(mod.LAUNCHES)
            if not any(counted.values()):
                raise AssertionError(f"{engine} bench window: no kernel launched")
            rec.update(capture_seconds=win.capture_seconds, replays=win.replays - replays0,
                       block_launches={k: v for k, v in win.block_launches.items() if v},
                       block_dispatches=win.block_dispatches)
            del scan, run, win
        if int(st.core.tick) != (f + 2 * m + (r if r > 1 else 0)):
            raise AssertionError(f"{engine} bench {mode}: tick {int(st.core.tick)}")
        unit = "delivery-rounds/s" if r > 1 else "rounds/s"
        extra = ""
        if observe is not None:
            seen = observe(st)
            rec.update(seen)
            extra = "".join(f", {k} {v}" for k, v in seen.items())
        if mode == "window":
            extra = (f", capture {rec['capture_seconds']:.3f} s, {rec['replays']} graph "
                     f"replays a window of {m} rounds, a block of {rec['block_dispatches']} "
                     f"dispatches launches {rec['block_launches']}")
        opts = "".join(f" {k}={v}" for k, v in bench_kw.items())
        say(f"{engine} bench{opts} {mode} N={N_FULL}: {rec['rate']:.3f} {unit} over {m} "
            f"rounds, peak memory {rec['peak']} bytes{extra}, on {card}")
        turns.append(rec)
        del st, step
    return turns


def bench_cli(card: str, config: str = "default", coalesced: bool = True) -> dict:
    """Phases 19, 22 and 33: the bench CLI's measurement of ``config`` at a
    segment of ``BENCH_CLI_ROUNDS`` rounds (the CLI's default is 1600), its
    line printed (the continuity rate with the default config only; with
    ``coalesced`` False under ``BENCH_WIRE_COALESCED=0``)."""
    from go_libp2p_pubsub_tpu_torch import bench

    t0 = time.perf_counter()
    cont = "1" if config == "default" else "0"
    env = {"BENCH_CONFIG": config, "BENCH_ROUNDS": str(BENCH_CLI_ROUNDS),
           "BENCH_CONTINUITY": cont}
    if not coalesced:
        env["BENCH_WIRE_COALESCED"] = "0"
    line = bench.bench_line(env)
    if line.get("schema") != 3 or line.get("unit") != "delivery-rounds/s":
        raise AssertionError(f"bench line: {line}")
    if not (line["value"] > 0 and (cont == "0" or line["continuity_r1_ticks_per_sec"] > 0)):
        raise AssertionError(f"bench line without rates: {line}")
    want_n = 50_000 if config == "sybil" else N_FULL
    if line["fingerprint"]["config"] != config or line["fingerprint"]["n_peers"] != want_n:
        raise AssertionError(f"bench line of {config}: {line['fingerprint']}")
    if line["fingerprint"]["engine"]["wire_coalesced"] != coalesced:
        raise AssertionError(f"bench line of {config}: wire form {line['fingerprint']['engine']}")
    wire = "" if coalesced else " BENCH_WIRE_COALESCED=0"
    say(f"bench CLI BENCH_CONFIG={config}{wire} at BENCH_ROUNDS={BENCH_CLI_ROUNDS} (the CLI's "
        f"default segment is 1600 rounds) in {time.perf_counter() - t0:.1f} s, on {card}:")
    say(json.dumps(line))
    return line


#: the eth2 and sybil bench configs at the JAX bench's sizes (phases 20-22)
CONFIG_N = {"eth2": 100_000, "sybil": 50_000}
CONFIG_FORMATION, CONFIG_MEASURED = 8, 16     # per-round: formation, timed rounds
CONFIG_PHASES = 4                             # phase engine: timed phases
CONFIG_PARITY_ROUNDS, CONFIG_PARITY_PHASES = 8, 2    # 12, 3 before phase 44
CONFIG_WINDOW_ROUNDS = 32                     # rounds of each window check (two calls)


def config_launches(config: str, engine: str, dispatches: int) -> dict:
    """The wrapper launches a run of ``dispatches`` rounds (per-round) or
    phases (phase engine, form_mesh included) of a config must make: per
    heartbeat 8 selections, 2 more with eth2's fanout (maintenance and
    gossip), and with eth2 the selection of the publishes' fanout peers,
    one a round, or one a phase for all its sub-rounds (drawn at the
    phase head)."""
    eth2 = config == "eth2"
    if engine == "per-round":
        return {"edge_exchange": dispatches, "fused_delivery": dispatches,
                "csr_delivery": 0, "delivery_banded": 0,
                "select_topk": dispatches * (SELECTIONS_PER_HEARTBEAT + 3 * eth2)}
    return {"edge_exchange": dispatches * (1 + PHASE_R), "fused_delivery": 0,
            "csr_delivery": 0, "delivery_banded": 0,
            "select_topk": dispatches * (SELECTIONS_PER_HEARTBEAT + 3 * eth2)}


def check_config_calls(calls, where: str) -> dict:
    """Every recorded kernel call against its plain version (the wrapper's
    ``<name>_plain`` beside it) on the same arguments, bit for bit, after
    the run's counts were read. Returns {kernel: calls checked}."""
    import torch

    done = {}
    for (mod, name), recorded in calls.items():
        plain, kernel = getattr(mod, name + "_plain"), getattr(mod, name)
        for args, kw in recorded:
            ref, got = plain(*args, **kw), kernel(*args, **kw)
            torch.cuda.synchronize()
            if isinstance(ref, dict):
                keys = sorted(ref)
                ref, got = [ref[x] for x in keys], [got[x] for x in keys]
            elif isinstance(ref, tuple):
                ref, got = list(ref), list(got)
            else:
                ref, got = [ref], [got]
            try:
                max_abs_err(ref, got)
            except AssertionError as e:
                raise AssertionError(f"{where}: {name} {e}") from None
            done[name] = done.get(name, 0) + 1
    return done


def config_bench(sweep, driver, config: str, engine: str, card, dev, counters) -> dict:
    """Phase 20: a config at full size in one engine, eager then windowed.
    Eager: from a fresh state with every launch count at 0, the formation
    and the timed rounds; the launch, degree and subset checks; then every
    kernel call of one more round (phase) against its plain version.
    Windowed: the same build through driver.make_scan, a window that
    captures, then a timed one. Returns the numbers of both."""
    import torch

    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk

    n = CONFIG_N[config]
    phase = engine == "phase"
    r = PHASE_R if phase else 1
    f = PHASE_FORMATION * r if phase else CONFIG_FORMATION
    m = CONFIG_PHASES * r if phase else CONFIG_MEASURED
    out = {}
    for mode in ("eager", "window"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st, step, n_topics, honest = sweep.build_bench(n, M_SLOTS, config=config,
                                                       rounds_per_phase=r, device=dev)
        setup = time.perf_counter() - t0
        po, pt, pv = sweep.publish_schedule(f + 2 * m + r, n, n_topics, honest)
        if phase:
            eager = lambda st, sl: sweep.run_phases(st, step, po[sl], pt[sl], pv[sl],
                                                    rounds_per_phase=r, heartbeat_every=r)
        else:
            eager = lambda st, sl: sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
        for mod in counters:
            mod.reset_launch_counts()
        if phase:
            st = driver.form_mesh(step, st, rounds_per_phase=r)
        st = eager(st, slice(0, f))
        run = eager
        if mode == "window":
            scan = (driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r, unroll=2)
                    if phase else driver.make_scan(step, static_heartbeat=False, unroll=4))
            run = lambda st, sl: scan(st, po[sl], pt[sl], pv[sl])
            st = run(st, slice(f, f + m))              # captures the block
            torch.cuda.synchronize()
            replays0 = scan.window.replays
            timed = slice(f + m, f + 2 * m)
        else:
            timed = slice(f, f + m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = run(st, timed)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = {}
        for mod in counters:
            launched.update(mod.LAUNCHES)
        rounds = timed.stop + (r if phase else 0)
        tag = f"{config} {engine} {mode}"
        rec = {"rate": m / dt, "peak": torch.cuda.max_memory_allocated(), "launches": launched,
               "setup_seconds": setup, "rounds": rounds}
        if mode == "eager":
            want = config_launches(config, engine, rounds // r)
            if launched != want:
                raise AssertionError(f"{tag} launches {launched}, expected {want}")
            rec["kernel_launches_per_round"] = sum(launched.values()) / rounds
        else:
            win = scan.window
            rec.update(capture_seconds=win.capture_seconds, replays=win.replays - replays0,
                       block_dispatches=win.block_dispatches,
                       block_launches={k: v for k, v in win.block_launches.items() if v})
            # the host counts move only while a block is captured
            want = config_launches(config, engine, win.block_dispatches)
            if rec["block_launches"] != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"{tag}: a captured block launches "
                                     f"{rec['block_launches']}, expected {want}")
            rec["kernel_launches_per_round"] = (sum(rec["block_launches"].values())
                                                / (win.block_dispatches * r))
        # ring_lattice(n, d=8) has no absent slot: every edge is present
        lattice = types.SimpleNamespace(nbr_ok=torch.ones_like(st.mesh[:, 0]))
        dmin, _mean, dmax = gossip_state_checks(st, lattice, rounds, tag,
                                                every_message=config != "eth2")
        extra = ""
        if config == "eth2":
            live = int((st.fanout_topic >= 0).sum())
            if live == 0 or int(st.fanout_peers.sum()) == 0:
                raise AssertionError(f"{tag}: no fanout slot holds peers")
            extra = f", {live} live fanout slots"
        else:
            g = st.gater
            extra = (f", gater validate {float(g.validate.sum()):.1f} throttle "
                     f"{float(g.throttle.sum()):.1f}")
        unit = "delivery-rounds/s" if phase else "rounds/s (a delivery round each)"
        say(f"{tag} N={n} K=16 T={n_topics}: {rec['rate']:.3f} {unit} over {m} rounds, peak "
            f"memory {rec['peak']} bytes ({rec['peak'] / 2**20:.1f} MiB), "
            f"{rec['kernel_launches_per_round']:.3f} hand-kernel launches a delivery round "
            f"({'in a captured block' if mode == 'window' else 'counted'}: "
            f"{rec.get('block_launches', launched)}), mesh degree [{dmin}, {dmax}]{extra}, "
            f"host set-up {setup:.3f} s, on {card}")
        if mode == "eager":
            nxt = slice(timed.stop, timed.stop + r)
            _st, calls = record_calls(lambda: eager(st, nxt), [
                (fr, "edge_exchange"), (fr, "fused_delivery"), (sk, "select_topk")])
            done = check_config_calls(calls, tag)
            say(f"{tag}: every kernel call of one more {'phase' if phase else 'round'} equal "
                f"to its plain version bit for bit: {done}")
            rec["checked_calls"] = done
            del _st, calls
        else:
            del scan, run
        out[mode] = rec
        del st, step
    return out


def config_parity(sweep, driver, convert, config: str, dev, label: str | None = None,
                  plane=None, **bench_kw) -> None:
    """Phases 21, 25 and 34: a config (with ``bench_kw``, the delivery
    core's options or the build's forms, under ``label``) on the card
    against the CPU (plain versions) at N=8192 from the same seed, events
    counted — the per-round step every leaf after each round, the phase
    engine after form_mesh and each phase — then each engine's window
    against its eager loop on the card, every leaf, in two calls. A lifted
    build takes ``plane(device)``, a pair of planes: the first for the
    first half of the dispatches (and form_mesh), the second after, one
    window replaying both without a second capture."""
    import torch

    def consts(planes, i, n):
        return () if planes is None else (planes[0] if i < n // 2 else planes[1],)

    r = PHASE_R
    config_name = config
    config = label or config
    t0 = time.perf_counter()
    for engine in ("per-round", "phase"):
        rr = r if engine == "phase" else 1
        sides, sched = {}, None
        for d in ("cuda", "cpu"):
            st, step, n_topics, honest = sweep.build_bench(
                N_PARITY, M_SLOTS, config=config_name, count_events=True, rounds_per_phase=rr,
                device=d, **bench_kw)
            planes = None if plane is None else plane(torch.device(d))
            if rr > 1:
                st = driver.form_mesh(step, st, rounds_per_phase=rr, consts=consts(planes, 0, 2))
            sides[d] = (st, step, planes)
            sched = sweep.publish_schedule(
                max(CONFIG_PARITY_ROUNDS, CONFIG_PARITY_PHASES * r), N_PARITY, n_topics,
                honest, seed=5)
        po, pt, pv = sched
        n_disp = CONFIG_PARITY_PHASES if rr > 1 else CONFIG_PARITY_ROUNDS
        for i in range(n_disp):
            sl = slice(i * rr, (i + 1) * rr)
            for d, (st, step, planes) in list(sides.items()):
                c = consts(planes, i, n_disp)
                if rr > 1:
                    st = sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=rr,
                                          heartbeat_every=rr, consts=c)
                else:
                    st = sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl], consts=c)
                sides[d] = (st, step, planes)
            leaves_equal(convert.state_leaves(sides["cpu"][0]),
                         convert.state_leaves(sides["cuda"][0]),
                         f"{config} {engine} card against CPU, dispatch {i}")
        del sides
        say(f"{config} {engine} card == CPU: every leaf equal after each of {n_disp} "
            f"{'phases of r=8 (after form_mesh)' if rr > 1 else 'rounds'} at N={N_PARITY}")
        # the window against its eager loop, on the card
        wr = CONFIG_WINDOW_ROUNDS
        leaves = []
        for mode in ("eager", "window"):
            st, step, n_topics, honest = sweep.build_bench(
                N_PARITY, M_SLOTS, config=config_name, count_events=True, rounds_per_phase=rr,
                device=dev, **bench_kw)
            po, pt, pv = sweep.publish_schedule(wr, N_PARITY, n_topics, honest, seed=6)
            planes = None if plane is None else plane(dev)
            if rr > 1:
                st = driver.form_mesh(step, st, rounds_per_phase=rr, consts=consts(planes, 0, 2))
            half = wr // 2
            if mode == "eager":
                for sl, c in ((slice(0, half), consts(planes, 0, 2)),
                              (slice(half, wr), consts(planes, 1, 2))):
                    st = (sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=rr,
                                           heartbeat_every=rr, consts=c) if rr > 1
                          else sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl], consts=c))
            else:
                scan = (driver.make_scan(step, heartbeat_every=rr, rounds_per_phase=rr, unroll=2)
                        if rr > 1 else driver.make_scan(step, static_heartbeat=False, unroll=4))
                st = scan(st, po[:half], pt[:half], pv[:half], consts=consts(planes, 0, 2))
                st = scan(st, po[half:], pt[half:], pv[half:], consts=consts(planes, 1, 2))
                torch.cuda.synchronize()
                if scan.window.replays < 2 or scan.window.captures != 1:
                    raise AssertionError(f"{config} {engine} window: {scan.window.replays} "
                                         f"graph replays, {scan.window.captures} captures")
            leaves.append(convert.state_leaves(st))
            del st, step
        leaves_equal(leaves[0], leaves[1], f"{config} {engine} window against eager")
        say(f"{config} {engine} window N={N_PARITY}: equal to the eager loop leaf for leaf "
            f"after {wr} rounds in two calls"
            + (", one capture replaying both planes" if plane is not None else ""))
    say(f"{config} parity phases: {time.perf_counter() - t0:.1f} s")


RANDOMSUB_N, RANDOMSUB_ROUNDS = 1000, 80         # BASELINE.json config #2: 1k peers
SCALE_FORMATION, SCALE_ROUNDS = 8, 16             # RandomSub at scale: untimed, timed
SCALE_PARITY_ROUNDS = 8                           # card against CPU at N_PARITY (16 before phase 44)
#: RandomSub at scale: the lattice with a size estimate whose target is
#: RandomSubD = 6, and the 1M-peer power-law graph CSR-resident (target 32)
RANDOMSUB_SCALE = {
    "lattice": dict(n=N_FULL, graph="lattice", layout="dense", size_estimate=36,
                    kernel="delivery_banded"),
    "power-law csr": dict(n=N_CSR, graph="powerlaw", layout="csr", size_estimate=1000,
                          kernel="csr_delivery"),
}
#: the delivery core's options on the bench default config (phase 25)
CORE_OPTIONS = {"queue_cap=2": dict(queue_cap=2),
                "validation_delay_rounds=2": dict(validation_delay_rounds=2),
                "both": dict(queue_cap=2, validation_delay_rounds=2)}


def counts(counters) -> dict:
    out = {}
    for mod in counters:
        out.update(mod.LAUNCHES)
    return out


def randomsub_baseline(sweep, convert, counters, dev, card) -> dict:
    """Phase 23: RandomSub as BASELINE.json config #2 — random_connect(1000,
    32, seed=0), one topic every peer joins, no size estimate (target
    ceil(sqrt(1000)) = 32), 4 publishes a round for 80 rounds: the main path
    with every count at 0 (one select_topk a round; a random net takes the
    delivery composite), each draw against its plain version, then card
    against CPU every leaf after every round."""
    import torch

    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk

    n, rounds = RANDOMSUB_N, RANDOMSUB_ROUNDS
    po, pt, pv = sweep.publish_schedule(rounds, n, 1, None, seed=7)
    st, run = sweep.build_randomsub(n, M_SLOTS, graph="random", device=dev)
    k = run.net.max_degree
    for mod in counters:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, calls = record_calls(lambda: sweep.run_rounds(st, run, po, pt, pv),
                             [(sk, "select_topk")])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts(counters)
    want = {"edge_exchange": 0, "fused_delivery": 0, "delivery_banded": 0,
            "csr_delivery": 0, "select_topk": rounds}
    if got != want:
        raise AssertionError(f"RandomSub #2 launches {got}, expected {want}")
    checked = check_config_calls(calls, "RandomSub #2")
    leaves = convert.state_leaves(st)
    reach = (st.dlv.first_round >= 0).sum(0)
    old = (st.msgs.birth >= 0) & (st.msgs.birth <= rounds - 4)
    if not bool((reach[old] > 1).all()):
        raise AssertionError("RandomSub #2: a message 4+ rounds old reached only its origin")
    say(f"randomsub #2 N={n} K={k} target 32: {rounds} rounds, launches {got}, each draw "
        f"equal to its plain version ({checked}); median reach {int(reach[old].median())} "
        f"peers; events {leaves['.events'][:9].tolist()}; {rounds / dt:.3f} rounds/s, on {card}")
    sides = {d: sweep.build_randomsub(n, M_SLOTS, graph="random", device=d)
             for d in ("cuda", "cpu")}
    for r in range(rounds):
        for d, (s, stp) in list(sides.items()):
            sides[d] = (sweep.run_rounds(s, stp, po[r:r + 1], pt[r:r + 1], pv[r:r + 1]), stp)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"RandomSub #2 round {r}")
    say(f"randomsub #2 card == CPU: every leaf equal after each of {rounds} rounds at N={n}")
    return {"RandomSub #2 (N=1000)": got}


def randomsub_scale(sweep, driver, convert, counters, dev, card, name: str, spec: dict) -> dict:
    """Phase 24: RandomSub at full width. The main path from a fresh state
    with every count at 0 (formation, then timed rounds: one select_topk
    and one delivery kernel a round), its first draws and deliveries held
    against their plain versions, the draw's time; then the same rounds
    through driver.make_window (a captured CUDA graph a block) and card
    against CPU at N=8192. Returns the cell's numbers."""
    import torch

    from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as cd
    from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk
    from go_libp2p_pubsub_tpu_torch.state import SimState

    n, kernel = spec["n"], spec["kernel"]
    kmod = db if kernel == "delivery_banded" else cd
    kw = dict(graph=spec["graph"], layout=spec["layout"], size_estimate=spec["size_estimate"])
    total = SCALE_FORMATION + 2 * SCALE_ROUNDS
    po, pt, pv = sweep.publish_schedule(total, n, 1, None, seed=8)
    f, m = SCALE_FORMATION, SCALE_ROUNDS
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    st, run = sweep.build_randomsub(n, M_SLOTS, device=dev, **kw)
    net = run.net
    fresh = lambda: SimState.init(n, M_SLOTS, k=net.max_degree, device=dev,
                                  n_edges=net.n_edges)
    for mod in counters:
        mod.reset_launch_counts()
    st = sweep.run_rounds(st, run, po[:f], pt[:f], pv[:f])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, calls = record_calls(lambda: sweep.run_rounds(st, run, po[f:f + m], pt[f:f + m],
                                                      pv[f:f + m]),
                             [(sk, "select_topk"), (kmod, kernel)], keep=2)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = counts(counters)
    want = {"edge_exchange": 0, "fused_delivery": 0, "delivery_banded": 0,
            "csr_delivery": 0, "select_topk": f + m, kernel: f + m}
    if got != want:
        raise AssertionError(f"RandomSub {name} launches {got}, expected {want}")
    checked = check_config_calls(calls, f"RandomSub {name}")
    if bool(((st.dlv.fwd & ~st.dlv.have) != 0).any()):
        raise AssertionError(f"RandomSub {name}: fwd is not a subset of have")
    reach = (st.dlv.first_round >= 0).sum(0)
    old = (st.msgs.birth >= 0) & (st.msgs.birth <= f + m - 4)
    if not bool((reach[old] > 1).all()):
        raise AssertionError(f"RandomSub {name}: a message 4+ rounds old reached only its origin")
    args, skw = calls[(sk, "select_topk")][0]
    r_rows, k = args[0].shape
    launch = prepared(sk._lib(), "select_topk_sims", lambda: sk.select_topk(*args, **skw))
    draw = {"rows": r_rows, "k": k, "target": int(args[2].max()),
            **kernel_times(launch), "plain_ms": batch_ms(lambda: sk.select_topk_plain(*args)),
            **bound(r_rows * k * 10 + 4 * r_rows, r_rows * k * max(1, (k - 1).bit_length())),
            "row_paths": row_paths(*args[:3])}
    del launch, calls, args
    rec = {"eager_rate": m / dt, "peak": peak,
           "launches_a_round": {k_: v / (f + m) for k_, v in got.items() if v},
           "select_topk": draw}
    say(f"randomsub {name} N={n} K={net.max_degree} target {draw['target']}: {f + m} rounds, "
        f"launches {got}, first calls equal to their plain versions ({checked}), median "
        f"reach {int(reach[old].median())} peers; eager {rec['eager_rate']:.3f} rounds/s "
        f"over {m} rounds, peak memory {peak} bytes ({peak / 2**20:.1f} MiB), on {card}")
    say(f"kernel select_topk randomsub {name}: R={r_rows} K={k} kernel_ms={draw['ms']:.6f} "
        f"plain_ms={draw['plain_ms']:.6f} bound_ms={draw['bound_ms']:.6f} "
        f"({draw['bound_by']}) rows by path {draw['row_paths']}")
    del st
    # the same rounds through a window: the first call captures, the
    # second is timed
    st = sweep.run_rounds(fresh(), run, po[:f], pt[:f], pv[:f])
    win = driver.make_window(run, unroll=4)
    for mod in counters:
        mod.reset_launch_counts()
    st, _ = win(st, (po[f:f + m], pt[f:f + m], pv[f:f + m]))
    torch.cuda.synchronize()
    replays0 = win.replays
    t0 = time.perf_counter()
    st, _ = win(st, (po[f + m:], pt[f + m:], pv[f + m:]))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if int(st.tick) != total or win.replays - replays0 != m // win.block_dispatches:
        raise AssertionError(f"RandomSub {name} window: tick {int(st.tick)}, "
                             f"{win.replays - replays0} replays")
    rec.update(window_rate=m / dt, block_dispatches=win.block_dispatches,
               block_launches={k_: v for k_, v in win.block_launches.items() if v},
               capture_seconds=win.capture_seconds)
    say(f"randomsub {name} window N={n}: {rec['window_rate']:.3f} rounds/s over {m} rounds "
        f"(eager {rec['eager_rate']:.3f}), capture {win.capture_seconds:.3f} s, a block of "
        f"{win.block_dispatches} dispatches launches {rec['block_launches']}, on {card}")
    del st, win, run, net
    # card against CPU at the parity size
    pp = sweep.publish_schedule(SCALE_PARITY_ROUNDS, N_PARITY, 1, None, seed=5)
    sides = {d: sweep.build_randomsub(N_PARITY, M_SLOTS, device=d, **kw)
             for d in ("cuda", "cpu")}
    for r in range(SCALE_PARITY_ROUNDS):
        for d, (s, stp) in list(sides.items()):
            sides[d] = (sweep.run_rounds(s, stp, *(a[r:r + 1] for a in pp)), stp)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"RandomSub {name} round {r}")
    say(f"randomsub {name} card == CPU: every leaf equal after each of "
        f"{SCALE_PARITY_ROUNDS} rounds at N={N_PARITY}")
    return rec


def option_launches(sweep, driver, dev, counters, kw: dict) -> dict:
    """Phase 25's launch check: the default config with ``kw`` on the card
    at N=8192 from every count at 0 — 8 per-round rounds (no edge_exchange,
    no fused_delivery: the composites) and form_mesh plus 2 phases of r=8
    (edge_exchange 1 + r a phase); delivery_banded and csr_delivery never."""
    out = {}
    for engine, rr in (("per-round", 1), ("phase", PHASE_R)):
        st, step, _t, _h = sweep.build_bench(N_PARITY, M_SLOTS, rounds_per_phase=rr,
                                             device=dev, **kw)
        po, pt, pv = sweep.publish_schedule(2 * PHASE_R, N_PARITY, 1, None, seed=9)
        for mod in counters:
            mod.reset_launch_counts()
        if rr > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=rr)
            st = sweep.run_phases(st, step, po, pt, pv, rounds_per_phase=rr, heartbeat_every=rr)
            want = {"edge_exchange": 3 * (1 + rr), "fused_delivery": 0}
        else:
            st = sweep.run_rounds(st, step, po[:8], pt[:8], pv[:8])
            want = {"edge_exchange": 0, "fused_delivery": 0}
        got = counts(counters)
        want.update(delivery_banded=0, csr_delivery=0, select_topk=got["select_topk"])
        if got != want or got["select_topk"] == 0:
            raise AssertionError(f"options {kw} {engine}: launches {got}, expected {want}")
        out[engine] = got
        del st, step
    return out


def flood_capped(sweep, convert, counters, dev, card) -> dict:
    """Phase 26: FloodSub on the lattice with queue_cap=2 at N=100k: the
    composites (no delivery_banded), drops counted (DROP_RPC); card against
    CPU at N=8192."""
    import torch

    n, f, m = N_FULL, SCALE_FORMATION, SCALE_ROUNDS
    po, pt, pv = sweep.publish_schedule(f + m, n, 1, None, seed=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, step = sweep.build_floodsub(n, M_SLOTS, device=dev, queue_cap=2)
    for mod in counters:
        mod.reset_launch_counts()
    st = sweep.run_rounds(st, step, po[:f], pt[:f], pv[:f])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sweep.run_rounds(st, step, po[f:], pt[f:], pv[f:])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = counts(counters)
    if any(got.values()):
        raise AssertionError(f"capped FloodSub launched {got}; the cap takes the composites")
    # a link of the sparse lattice rarely meets three messages in a round:
    # the drops are data, not a check (the parity run below holds them)
    ev = convert.state_leaves(st)[".events"]
    peak = torch.cuda.max_memory_allocated()
    say(f"floodsub lattice queue_cap=2 N={n}: {f + m} rounds, launches {got}, "
        f"events {ev[:9].tolist()}; {m / dt:.3f} rounds/s, peak memory {peak} bytes, "
        f"on {card}")
    del st, step
    flood_parity(sweep, convert, dict(graph="lattice", layout="dense", queue_cap=2))
    return {"rate": m / dt, "peak": peak}


#: the candidate plane's mesh degrees (phases 32-34)
CANDIDATE_DEGREES = dict(D=8, Dlo=6, Dhi=12)
#: the bench default config's degrees: every mesh degree lies in [Dlo, Dhi]
DEFAULT_DEGREES = (5, 12)


def lift_planes(sweep, dev) -> dict:
    """The lifted planes of phases 32-34 on ``dev``: ``A`` the bench default
    config's own values (``sweep.bench_plane``: what the static build
    computes); ``B`` moves every lifted surface (thresholds -4 / -20 / -40
    / 5 / 10, P1's weight halved, P2's weight 2.0); ``A+`` and ``B+`` the
    same as CandidateParams with the config's degrees, and ``C`` a
    CandidateParams of B's scores and ``CANDIDATE_DEGREES``: the three
    candidate planes share one structure, so one captured window replays
    them all."""
    import torch

    a = sweep.bench_plane(device=dev)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    b = dataclasses.replace(
        a, w1=a.w1 * 0.5, w2=torch.full_like(a.w2, 2.0), gossip_threshold=f32(-4.0),
        publish_threshold=f32(-20.0), graylist_threshold=f32(-40.0),
        accept_px_threshold=f32(5.0), opportunistic_graft_threshold=f32(10.0))
    from go_libp2p_pubsub_tpu_torch.score.params import CandidateParams

    own = sweep.bench_plane(device=dev, mesh=True).mesh
    moved = dataclasses.replace(own, **{k: torch.tensor(v, dtype=torch.int32, device=dev)
                                        for k, v in CANDIDATE_DEGREES.items()})
    return {"A": a, "B": b, "A+": CandidateParams(score=a, mesh=own),
            "B+": CandidateParams(score=b, mesh=own), "C": CandidateParams(score=b, mesh=moved)}


def lift_launches(engine: str, dispatches: int) -> dict:
    """The launches a lifted run of the bench default config must make: the
    kernel route of the static build (a lifted round 1 edge_exchange and 1
    fused_delivery, a lifted phase 1 + r edge_exchange, 8 select_topk a
    heartbeat)."""
    if engine == "per-round":
        return {"edge_exchange": dispatches, "fused_delivery": dispatches, "csr_delivery": 0,
                "delivery_banded": 0, "select_topk": dispatches * SELECTIONS_PER_HEARTBEAT}
    return {"edge_exchange": dispatches * (1 + PHASE_R), "fused_delivery": 0,
            "csr_delivery": 0, "delivery_banded": 0,
            "select_topk": dispatches * SELECTIONS_PER_HEARTBEAT}


def lift_cell(sweep, driver, dev, card, counters, engine: str, static_turns) -> dict:
    """Phase 32: the lifted bench default config at N=100k in one engine.

    The planes are ``lift_planes``' candidate forms (A+, B+, C: one
    structure). Gates: from every count at 0, form_mesh (phase) and the
    formation under A+ must launch ``lift_launches``; then one more
    dispatch under C records its kernel calls, and the first
    fused_delivery (its threshold row read from the plane on the device)
    and the first select_topk (the plane's widths) must equal their plain
    versions bit for bit, every edge_exchange too. Turns: eager, window,
    window, eager under A+, each timed over one segment after the
    formation and an untimed one (the window's capture); each window then
    replays one segment under B+ and one under C, and its ``captures``
    must stay 1. Mesh degrees lie in [Dlo, Dhi] of the plane in force.
    Returns the rates, peaks, captures and launches."""
    import torch

    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk

    r = PHASE_R if engine == "phase" else 1
    m = PHASE_MEASURED * r if engine == "phase" else MEASURED_ROUNDS
    f = PHASE_FORMATION * r if engine == "phase" else FORMATION_ROUNDS
    po, pt, pv = sweep.publish_schedule(f + 4 * m + r, N_FULL, 1, None)
    planes = {k[0]: v for k, v in lift_planes(sweep, dev).items() if k in ("A+", "B+", "C")}
    out = {"turns": []}

    def degrees(st, rng, where):
        deg = st.mesh.sum(-1)
        lo, hi = int(deg.min()), int(deg.max())
        if not (rng[0] <= lo and hi <= rng[1]):
            raise AssertionError(f"lifted {engine} {where}: mesh degrees [{lo}, {hi}] outside "
                                 f"[Dlo, Dhi] = {list(rng)}")
        return [lo, hi]

    for mode in ("eager", "window", "window", "eager"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=r, device=dev,
                                             lift_scores=True)
        first = not out["turns"]
        if first:
            for mod in counters:
                mod.reset_launch_counts()
        eager = {}
        for key, plane in planes.items():
            if r > 1:
                eager[key] = (lambda st, sl, plane=plane: sweep.run_phases(
                    st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=r, heartbeat_every=r,
                    consts=(plane,)))
            else:
                eager[key] = (lambda st, sl, plane=plane: sweep.run_rounds(
                    st, step, po[sl], pt[sl], pv[sl], consts=(plane,)))
        if r > 1:
            st = driver.form_mesh(step, st, rounds_per_phase=r, consts=(planes["A"],))
        st = eager["A"](st, slice(0, f))
        rec = {"mode": mode}
        if first:
            want = lift_launches(engine, f // r + (r > 1))
            launched = counts(counters)
            if launched != want:
                raise AssertionError(f"lifted {engine} launches {launched} in the formation, "
                                     f"expected {want}")
            out["launches"] = dict(launched, dispatches=f // r + (r > 1))
            nxt = slice(f, f + r)
            st, calls = record_calls(lambda: eager["C"](st, nxt),
                                     [(fr, "edge_exchange"), (fr, "fused_delivery"),
                                      (sk, "select_topk")], keep=1)
            if r == 1 and "thr_row" not in calls[(fr, "fused_delivery")][0][1]:
                raise AssertionError("lifted fused_delivery: no device threshold row")
            if not calls[(sk, "select_topk")]:
                raise AssertionError(f"lifted {engine}: no select_topk call under the plane")
            out["checked_calls"] = check_config_calls(calls, f"lifted {engine}")
            widths = calls[(sk, "select_topk")][0][0][2]
            out["first_select_widths"] = sorted(set(widths.tolist()))
            del calls
            start = f + r
        else:
            start = f
        run = lambda st, sl: eager["A"](st, sl)
        if mode == "window":
            scan = driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r,
                                    static_heartbeat=r > 1, unroll=2 if r > 1 else 4)
            run = lambda st, sl, plane=planes["A"]: scan(st, po[sl], pt[sl], pv[sl],
                                                         consts=(plane,))
        st = run(st, slice(start, start + m))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = run(st, slice(start + m, start + 2 * m))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rec.update(rate=m / dt, peak=torch.cuda.max_memory_allocated(),
                   degrees_A=degrees(st, DEFAULT_DEGREES, f"{mode} under A"))
        if mode == "window":
            win = scan.window
            rec.update(capture_seconds=win.capture_seconds, captures=win.captures,
                       block_launches={k: v for k, v in win.block_launches.items() if v},
                       block_dispatches=win.block_dispatches)
            want = lift_launches(engine, win.block_dispatches)
            if rec["block_launches"] != {k: v for k, v in want.items() if v}:
                raise AssertionError(f"lifted {engine} window: a captured block launches "
                                     f"{rec['block_launches']}, expected {want}")
            for key, rng in (("B", DEFAULT_DEGREES),
                             ("C", (CANDIDATE_DEGREES["Dlo"], CANDIDATE_DEGREES["Dhi"]))):
                sl = slice(start + 2 * m if key == "B" else start + 3 * m,
                           start + 3 * m if key == "B" else start + 4 * m)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st = run(st, sl, planes[key])
                torch.cuda.synchronize()
                rec[f"rate_{key}"] = m / (time.perf_counter() - t0)
                rec[f"degrees_{key}"] = degrees(st, rng, f"window under {key}")
            if win.captures != 1:
                raise AssertionError(f"lifted {engine} window: {win.captures} captures over "
                                     "planes A+, B+ and C")
            del scan, run, win
        out["turns"].append(rec)
        unit = "delivery-rounds/s" if r > 1 else "rounds/s"
        extra = ""
        if mode == "window":
            extra = (f", then a replay under B {rec['rate_B']:.3f} and under the candidate C "
                     f"{rec['rate_C']:.3f} with captures {rec['captures']} "
                     f"(capture {rec['capture_seconds']:.3f} s; a block of "
                     f"{rec['block_dispatches']} dispatches launches {rec['block_launches']}; "
                     f"degrees under C {rec['degrees_C']})")
        say(f"lifted {engine} bench {mode} N={N_FULL}: {rec['rate']:.3f} {unit} under A over "
            f"{m} rounds, peak memory {rec['peak']} bytes, degrees {rec['degrees_A']}{extra}, "
            f"on {card}")
        del st, step
    static = [round(t["rate"], 3) for t in static_turns if t["mode"] == "window"]
    lifted = [round(t["rate"], 3) for t in out["turns"] if t["mode"] == "window"]
    say(f"lifted {engine} bench windowed {lifted} against the static build's {static} "
        f"(phase 18, this process); launches {out['launches']}; calls checked "
        f"{out['checked_calls']}; the first select_topk's widths {out['first_select_widths']}")
    out["static_window_rates"] = static
    return out


def window_gates(engine: str, turns, **bench_kw) -> None:
    """The kernel route of a captured block of phase 33's windowed runs:
    1 edge_exchange and 1 fused_delivery a round, 1 + r edge_exchange a
    phase, 8 select_topk a heartbeat."""
    for t in turns:
        if t["mode"] != "window":
            continue
        want = lift_launches(engine, t["block_dispatches"])
        if t["block_launches"] != {k: v for k, v in want.items() if v}:
            raise AssertionError(f"{engine} {bench_kw}: a captured block launches "
                                 f"{t['block_launches']}, expected {want}")


def forward_mask_parity(dev, counters) -> dict:
    """Phase 34's forward_mask cells: ``common.delivery_round`` with a
    random [N, W] forward mask at N=8192 on the banded lattice (which
    leaves delivery_banded for the composite) and CSR-resident (where
    csr_delivery still runs and the mask gates its fwd), card against CPU
    bit for bit, with the launches of each route."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.models import common
    from go_libp2p_pubsub_tpu_torch.ops import bitset
    from go_libp2p_pubsub_tpu_torch.state import Delivery, MsgTable, Net

    n, m = N_PARITY, M_SLOTS
    w = bitset.n_words(m)
    rng = np.random.default_rng(11)
    u32 = lambda *shape: torch.from_numpy(rng.integers(0, 1 << 32, size=shape, dtype=np.uint64)
                                          .astype(np.uint32).view(np.int32))
    out = {}
    for layout in ("dense", "csr"):
        sides = {}
        base = None
        for d in ("cpu", dev):
            net = Net.build(graph.ring_lattice(n, d=8), graph.subscribe_all(n, 1),
                            edge_layout=layout, fused=layout == "csr", device=d)
            if base is None:
                k = net.max_degree
                fe_rows = n * k if layout == "dense" else net.n_edges
                base = dict(have=u32(n, w), fwd=u32(n, w), fe=u32(fe_rows, w) & u32(fe_rows, w),
                            fr=torch.from_numpy(rng.integers(-1, 5, size=(n, m)).astype(np.int32)),
                            mask=u32(n, k, w), fm=u32(n, w),
                            origin=torch.from_numpy(rng.integers(-1, n, size=m).astype(np.int32)),
                            valid=torch.from_numpy(rng.random(m) < 0.8))
            fe = base["fe"].reshape(n, k, w) if layout == "dense" else base["fe"]
            dlv = Delivery(have=base["have"].to(d), fwd=base["fwd"].to(d),
                           first_round=base["fr"].to(d), fe_words=fe.to(d))
            msgs = MsgTable(topic=torch.zeros(m, dtype=torch.int32, device=d),
                            origin=base["origin"].to(d),
                            birth=torch.zeros(m, dtype=torch.int32, device=d),
                            valid=base["valid"].to(d),
                            ignored=torch.zeros(m, dtype=torch.bool, device=d),
                            cursor=torch.tensor(0, dtype=torch.int32, device=d))
            for mod in counters:
                mod.reset_launch_counts()
            got, info = common.delivery_round(net, msgs, dlv, base["mask"].to(d),
                                              torch.tensor(3, dtype=torch.int32, device=d),
                                              forward_mask=base["fm"].to(d))
            torch.cuda.synchronize()
            sides[str(d)] = ([getattr(got, x).cpu() for x in ("have", "fwd", "first_round",
                                                              "fe_words")]
                             + [info.trans.cpu(), info.new_words.cpu()], counts(counters))
        (ref, _), (card_out, launched) = sides["cpu"], sides[str(dev)]
        for i, (a, b) in enumerate(zip(ref, card_out)):
            if not torch.equal(a, b):
                raise AssertionError(f"forward_mask {layout}: output {i} differs card and CPU")
        if bool(((card_out[1] & ~base["fm"]) != 0).any()):
            raise AssertionError(f"forward_mask {layout}: fwd outside the mask")
        want = ({"delivery_banded": 0, "csr_delivery": 0} if layout == "dense"
                else {"delivery_banded": 0, "csr_delivery": 1})
        if {k: launched[k] for k in want} != want:
            raise AssertionError(f"forward_mask {layout}: launches {launched}, expected {want}")
        out[layout] = {k: launched[k] for k in want}
        say(f"forward_mask {layout} N={n}: card == CPU bit for bit, fwd within the mask, "
            f"launches {out[layout]}")
    return out


def plane_engines_parity(sweep, convert, dev) -> None:
    """Phase 34's FloodSub and RandomSub cells: each takes a lifted plane
    (FloodSub's ``score_plane``, a lifted RandomSub step's last positional)
    and ignores it, card against CPU every leaf after each of 12 rounds at
    N=8192 on the lattice, and equal to the same engine run without it."""
    import torch

    from go_libp2p_pubsub_tpu_torch.models import floodsub as fs
    from go_libp2p_pubsub_tpu_torch.models import randomsub as rs

    po, pt, pv = sweep.publish_schedule(12, N_PARITY, 1, None, seed=5)
    finals = {}
    for d in ("cpu", dev):
        plane = lift_planes(sweep, d)["B"]
        st_f, flood = sweep.build_floodsub(N_PARITY, M_SLOTS, device=d)
        st_r, rsr = sweep.build_randomsub(N_PARITY, M_SLOTS, size_estimate=36, device=d)
        lifted = rs.make_randomsub_step(rsr.net, size_estimate=36, lift_scores=True)
        st_f0, st_r0 = st_f, st_r
        for t in range(12):
            args = [torch.as_tensor(a[t], device=d) for a in (po, pt, pv)]
            st_f = fs.floodsub_step(flood.net, st_f, *args, score_plane=plane)
            st_r = lifted(st_r, *args, plane)
            st_f0, st_r0 = flood(st_f0, *args), rsr(st_r0, *args)
        for name, a, b in (("floodsub", st_f, st_f0), ("randomsub", st_r, st_r0)):
            leaves_equal(convert.state_leaves(b), convert.state_leaves(a),
                         f"{name} with the plane against without it on {d}")
        finals[str(d)] = (convert.state_leaves(st_f), convert.state_leaves(st_r))
    for i, name in enumerate(("floodsub", "randomsub")):
        leaves_equal(finals["cpu"][i], finals[str(dev)][i], f"{name} with the plane")
    say(f"floodsub and randomsub with a lifted plane N={N_PARITY}: card == CPU every leaf "
        "after 12 rounds, equal to the runs without it")



#: under the checkout (git-ignored), wherever the script is run from
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
TRACE_BUFFER = 1 << 21          # records a sink holds: a full-width emit_init is 2N
TRACE_PARITY_ROUNDS = 8         # rounds of a card-against-CPU trace cell (the phase
                                # engine: one phase; the flood cells fewer, below)
TRACED_ROUNDS = 12              # traced rounds of phase 35's full-width per-round run
                                # (at most M / 4: no slot published in the window recycles)
CKPT_ROUNDS = (16, 8)           # phase 36: rounds before the save, rounds after it


def fresh_path(*parts) -> str:
    """A path under TRACE_DIR with no file at it (the file sinks append)."""
    path = os.path.join(TRACE_DIR, *parts)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        os.remove(path)
    return path


def bench_net(n: int, device):
    """The bench lattice's Net (``sweep.build_bench``'s one topic on
    ``ring_lattice(n, d=8)``): what a TraceSession reads."""
    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.state import Net

    return Net.build(graph.ring_lattice(n, d=8), graph.subscribe_all(n, 1), device=device)


class Traced:
    """A TraceSession over eager dispatches, as a user drives one: a
    snapshot before and after each dispatch, the diff emitted and the
    sinks flushed. Host seconds are split into the snapshots (the copies
    to the host, timed after the dispatch's device work has finished)
    and the emission (the diff, the protos, the writes)."""

    def __init__(self, drain, net, sinks, exact: bool = False, resident: bool = False):
        self.drain, self.sinks = drain, sinks
        self.sess = drain.TraceSession(net, sinks, exact=exact)
        self.net = net if resident else None
        self.snap_s = self.emit_s = 0.0

    def _snapshot(self, st):
        t0 = time.perf_counter()
        snap = self.drain.snapshot(st, self.net)
        self.snap_s += time.perf_counter() - t0
        return snap

    def _emit(self, fn, *args):
        t0 = time.perf_counter()
        fn(*args)
        for s in self.sinks:
            s.flush()
        self.emit_s += time.perf_counter() - t0

    def start(self, st):
        self.prev = self._snapshot(st)
        self._emit(self.sess.emit_init, self.prev)

    def step(self, st, dispatch, pubs):
        import torch

        st = dispatch(st)
        if getattr(st, "core", st).tick.is_cuda:
            torch.cuda.synchronize()   # the snapshot's seconds are its copies alone
        new = self._snapshot(st)
        self._emit(self.sess.observe, self.prev, new, *pubs)
        self.prev = new
        return st

    def close(self):
        self._emit(self.sess.close, self.prev)
        dropped = sum(s.dropped for s in self.sinks)
        if dropped:
            raise AssertionError(f"the trace sinks dropped {dropped} records")


def event_counts(trace_pb2, evs) -> dict:
    out = {}
    for e in evs:
        name = trace_pb2.TraceEvent.Type.Name(e.type)
        out[name] = out.get(name, 0) + 1
    return out


def trace_parity_cells(sweep, driver) -> dict:
    """Phase 35's card-against-CPU cells at N=8192: name -> (build(device)
    -> (state, dispatch(st, i), publishes(i), net, CSR-resident), dispatches,
    exact, the kernel the card run must launch)."""
    n, r, rounds_of = N_PARITY, PHASE_R, TRACE_PARITY_ROUNDS
    po, pt, pv = sweep.publish_schedule(rounds_of, n, 1, None, seed=5)
    rounds = lambda st, step, i: sweep.run_rounds(st, step, po[i:i + 1], pt[i:i + 1],
                                                  pv[i:i + 1])
    per_round = lambda i: (po[i], pt[i], pv[i])

    def gossip(d, **kw):
        st, step, _t, _h = sweep.build_bench(n, M_SLOTS, count_events=True, device=d, **kw)
        return st, lambda s, i: rounds(s, step, i), per_round, bench_net(n, d), False

    def phase(d):
        st, step, _t, _h = sweep.build_bench(n, M_SLOTS, count_events=True,
                                             rounds_per_phase=r, device=d)
        st = driver.form_mesh(step, st, rounds_per_phase=r)
        sl = lambda i: slice(i * r, (i + 1) * r)
        run = lambda s, i: sweep.run_phases(s, step, po[sl(i)], pt[sl(i)], pv[sl(i)],
                                            rounds_per_phase=r, heartbeat_every=r)
        return st, run, lambda i: (po[sl(i)], pt[sl(i)], pv[sl(i)]), bench_net(n, d), False

    def flood(d, graph, layout):
        st, run = sweep.build_floodsub(n, M_SLOTS, graph, layout=layout, device=d)
        return st, lambda s, i: rounds(s, run, i), per_round, run.net, layout == "csr"

    # the power-law flood writes about 64,000 records a round at N=8192
    # and exact mode about 26,000: fewer rounds keep the host's emission
    # on both sides to seconds
    return {
        "GossipSub per-round": (gossip, rounds_of, False, "fused_delivery"),
        "GossipSub phase r=8": (phase, rounds_of // r, False, "edge_exchange"),
        "FloodSub lattice": (lambda d: flood(d, "lattice", "dense"), rounds_of, False,
                             "delivery_banded"),
        "FloodSub power-law CSR-resident": (lambda d: flood(d, "powerlaw", "csr"), 4, False,
                                            "csr_delivery"),
        "GossipSub exact (PX build)": (lambda d: gossip(d, px=True), 6, True,
                                       "fused_delivery"),
    }


def trace_parity(sweep, driver, drain, sinks, counters, card) -> dict:
    """Phase 35, part 1: each cell traced from the same seed on the card
    and on the CPU (plain versions) into a PBTracer; the files equal byte
    for byte (the JSON and collector forms of the same records are held
    to the JAX package's on the CPU, tests/test_torch_trace.py), and the
    card run launched its kernel."""
    out = {}
    for name, (build, dispatches, exact, kernel) in trace_parity_cells(sweep, driver).items():
        files = {}
        t0 = time.perf_counter()
        for d in ("cuda", "cpu"):
            st, dispatch, pubs, net, resident = build(d)
            tag = name.replace(" ", "_").replace("=", "")
            path = fresh_path(f"{tag}-{d}.pb")
            tr = Traced(drain, net, [sinks.PBTracer(path, use_native=False,
                                                    buffer_cap=TRACE_BUFFER)],
                        exact=exact, resident=resident)
            for mod in counters:
                mod.reset_launch_counts()
            tr.start(st)
            for i in range(dispatches):
                st = tr.step(st, lambda s, i=i: dispatch(s, i), pubs(i))
            tr.close()
            if d == "cuda" and not counts(counters)[kernel]:
                raise AssertionError(f"trace {name}: {kernel} never launched on the card")
            files[d] = open(path, "rb").read()
        if files["cuda"] != files["cpu"]:
            raise AssertionError(f"trace {name}: the card's file differs from the CPU's "
                                 f"({len(files['cuda'])} and {len(files['cpu'])} bytes)")
        evs = list(sinks.read_pb_trace(path))
        out[name] = {"records": len(evs), "pb_bytes": len(files["cuda"]),
                     "types": len(set(e.type for e in evs))}
        say(f"trace {name} card == CPU at N={N_PARITY}: the files ({len(files['cuda'])} "
            f"bytes) equal byte for byte, {len(evs)} records of {out[name]['types']} types "
            f"over {dispatches} dispatches ({time.perf_counter() - t0:.1f} s)")
    return out


def traced_full(sweep, driver, convert, drain, sinks, trace_pb2, dev, card, counters,
                engine: str) -> dict:
    """Phase 35, part 2: the default config at N=100k (events counted),
    formed and run untraced, then ``TRACED_ROUNDS`` rounds (the phase
    engine: one phase of r) traced into a PBTracer, beside the same run
    untraced. The file's records reconcile with the device state: DELIVER
    + REJECT equal the first receipts stamped in the traced dispatches
    (counted on the card from each dispatch's state), PUBLISH the
    publishes, SEND_RPC and RECV_RPC each DELIVER + REJECT, GRAFT and
    PRUNE the mesh diffs; the latencies (deliver tick minus publish tick)
    of the messages published in the window equal first_round - birth on
    the card; the final state and the launch counts equal the untraced
    run's."""
    import numpy as np
    import torch

    phase = engine == "phase"
    r = PHASE_R if phase else 1
    pre = PHASE_FORMATION * r if phase else FORMATION_ROUNDS
    traced = r if phase else TRACED_ROUNDS
    po, pt, pv = sweep.publish_schedule(pre + traced, N_FULL, 1, None)

    def run(st, step, a, b):
        if phase:
            return sweep.run_phases(st, step, po[a:b], pt[a:b], pv[a:b], rounds_per_phase=r,
                                    heartbeat_every=r)
        return sweep.run_rounds(st, step, po[a:b], pt[a:b], pv[a:b])

    def fresh():
        st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, count_events=True,
                                             rounds_per_phase=r, device=dev)
        for mod in counters:
            mod.reset_launch_counts()
        if phase:
            st = driver.form_mesh(step, st, rounds_per_phase=r)
        return run(st, step, 0, pre), step

    st, step = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st, step, pre, pre + traced)
    torch.cuda.synchronize()
    untraced_rate = traced / (time.perf_counter() - t0)
    want, want_counts = convert.state_leaves(st), counts(counters)
    del st, step

    st, step = fresh()
    net = bench_net(N_FULL, dev)
    path = fresh_path(f"traced-{engine}.pb")
    tr = Traced(drain, net, [sinks.PBTracer(path, use_native=False, buffer_cap=TRACE_BUFFER)])
    tr.start(st)
    init_s, init_bytes = tr.snap_s + tr.emit_s, os.path.getsize(path)
    tr.snap_s = tr.emit_s = 0.0
    t_lo = int(st.core.tick)
    on_card = dict(first=0, graft=0, prune=0)
    lat_state = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_s = 0.0
    for i in range(traced // r):
        a = pre + i * r
        prev_mesh, tick0 = st.mesh.clone(), int(st.core.tick)
        st = tr.step(st, lambda s: run(s, step, a, a + r), (po[a:a + r], pt[a:a + r],
                                                             pv[a:a + r]) if phase else
                     (po[a], pt[a], pv[a]))
        c0 = time.perf_counter()
        fr_, birth = st.core.dlv.first_round, st.core.msgs.birth
        got = (fr_ >= tick0) & (fr_ < int(st.core.tick)) & (st.core.dlv.first_edge >= 0)
        on_card["first"] += int(got.sum())
        on_card["graft"] += int((st.mesh & ~prev_mesh).sum())
        on_card["prune"] += int((prev_mesh & ~st.mesh).sum())
        lat_state.append((fr_ - birth[None, :])[got & (birth >= t_lo)[None, :]].cpu())
        card_s += time.perf_counter() - c0
    wall = time.perf_counter() - t0 - card_s
    loop_snap, loop_emit = tr.snap_s, tr.emit_s
    loop_bytes = os.path.getsize(path) - init_bytes
    tr.close()
    close_s = tr.snap_s + tr.emit_s - loop_snap - loop_emit
    leaves_equal(want, convert.state_leaves(st), f"traced {engine}: final state against the "
                 "untraced run's")
    got_counts = counts(counters)
    if got_counts != want_counts:
        raise AssertionError(f"traced {engine}: launches {got_counts}, untraced {want_counts}")

    evs = list(sinks.read_pb_trace(path))
    n = event_counts(trace_pb2, evs)
    pubs_in = int((po[pre:pre + traced] >= 0).sum())
    first = n.get("DELIVER_MESSAGE", 0) + n.get("REJECT_MESSAGE", 0)
    checks = {"DELIVER + REJECT": (first, on_card["first"]), "PUBLISH": (
        n.get("PUBLISH_MESSAGE", 0), pubs_in), "SEND_RPC": (n.get("SEND_RPC", 0), first),
        "RECV_RPC": (n.get("RECV_RPC", 0), first),
        "GRAFT": (n.get("GRAFT", 0), on_card["graft"]),
        "PRUNE": (n.get("PRUNE", 0), on_card["prune"]), "ADD_PEER": (n.get("ADD_PEER", 0), N_FULL),
        "LEAVE": (n.get("LEAVE", 0), N_FULL)}
    for what, (a, b) in checks.items():
        if a != b:
            raise AssertionError(f"traced {engine}: {what} {a} in the file, {b} expected")
    ns = trace_pb2.TraceEvent
    pub_tick = {e.publishMessage.messageID: e.timestamp for e in evs
                if e.type == ns.PUBLISH_MESSAGE}
    lat_file = np.sort(np.array([(e.timestamp - pub_tick[e.deliverMessage.messageID]) // 10**9
                                 for e in evs if e.type == ns.DELIVER_MESSAGE
                                 and e.deliverMessage.messageID in pub_tick], np.int64))
    lat_card = np.sort(torch.cat(lat_state).numpy().astype(np.int64))
    if not np.array_equal(lat_file, lat_card) or not len(lat_file):
        raise AssertionError(f"traced {engine}: {len(lat_file)} latencies in the file differ "
                             f"from the {len(lat_card)} on the card")
    ticks = {e.timestamp // 10**9 for e in evs if e.type == ns.DELIVER_MESSAGE}
    if phase and len(ticks) < 2:
        raise AssertionError(f"traced phase: DELIVER ticks {sorted(ticks)}: no sub-round "
                             "resolution")
    step_records = len(evs) - n.get("ADD_PEER", 0) - n.get("JOIN", 0) - n.get("LEAVE", 0)
    size = os.path.getsize(path)
    rec = {
        "rounds": traced, "records": len(evs), "counts": n,
        "records_a_round": step_records / traced,
        "bytes_a_round": loop_bytes / traced,
        "init_bytes": init_bytes, "file_bytes": size,
        "snapshot_s_a_round": loop_snap / traced, "emit_s_a_round": loop_emit / traced,
        "traced_rate": traced / wall, "untraced_rate": untraced_rate,
        "init_s": init_s, "close_s": close_s, "deliver_ticks": len(ticks),
        "latency_p50": float(np.percentile(lat_file, 50)),
        "latency_p99": float(np.percentile(lat_file, 99)), "latencies": len(lat_file),
        "launches": got_counts,
    }
    unit = "delivery-rounds/s" if phase else "rounds/s"
    say(f"traced {engine} N={N_FULL}: {traced} rounds traced after {pre} untraced, "
        f"{len(evs)} records {n}; DELIVER + REJECT {first} == first receipts on the card, "
        f"SEND_RPC == RECV_RPC == {first}, GRAFT {on_card['graft']} / PRUNE {on_card['prune']} == "
        f"the mesh diffs, {len(lat_file)} latencies == first_round - birth (p50 "
        f"{rec['latency_p50']}, p99 {rec['latency_p99']} rounds); final state and launches "
        f"{got_counts} equal the untraced run's")
    say(f"traced {engine} host: {rec['records_a_round']:.1f} records and "
        f"{rec['bytes_a_round']:.0f} bytes a round, snapshot {rec['snapshot_s_a_round']:.4f} s "
        f"+ emission {rec['emit_s_a_round']:.4f} s a round, {rec['traced_rate']:.3f} {unit} "
        f"traced against {untraced_rate:.3f} untraced; emit_init {init_s:.3f} s "
        f"({init_bytes} bytes), close {close_s:.3f} s; on {card}")
    return rec


def checkpoint_cell(sweep, driver, convert, checkpoint, dev, engine: str) -> dict:
    """Phase 36: the default config at N=100k saved mid-run (compressed,
    then not), each file restored into a fresh template equal to the
    saved state; the run continued from the restore equals the
    uninterrupted eager run on every leaf: eagerly (per-round), or
    through a captured window (``driver.make_scan``, the phase engine
    saved at a phase boundary)."""
    import torch

    phase = engine == "phase"
    r = PHASE_R if phase else 1
    pre, more = (PHASE_FORMATION * r, 2 * r) if phase else CKPT_ROUNDS
    po, pt, pv = sweep.publish_schedule(pre + more, N_FULL, 1, None)

    def run(st, step, a, b):
        if phase:
            return sweep.run_phases(st, step, po[a:b], pt[a:b], pv[a:b], rounds_per_phase=r,
                                    heartbeat_every=r)
        return sweep.run_rounds(st, step, po[a:b], pt[a:b], pv[a:b])

    build = lambda: sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=r, device=dev)[:2]
    st, step = build()
    if phase:
        st = driver.form_mesh(step, st, rounds_per_phase=r)
    st = run(st, step, 0, pre)
    mid = convert.state_leaves(st)
    rec = {"engine": engine, "tick": int(st.core.tick)}
    paths = {}
    for compress in (True, False):
        kind = "compressed" if compress else "uncompressed"
        paths[kind] = fresh_path(f"ckpt-{engine}-{kind}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(paths[kind], st, compress=compress)
        rec[f"save_s_{kind}"] = time.perf_counter() - t0
        rec[f"bytes_{kind}"] = os.path.getsize(paths[kind])
    want = convert.state_leaves(run(st, step, pre, pre + more))
    del st
    template = build()[0]
    restored = {}
    for kind, path in paths.items():
        t0 = time.perf_counter()
        restored[kind] = checkpoint.restore(path, template)
        torch.cuda.synchronize()
        rec[f"restore_s_{kind}"] = time.perf_counter() - t0
        leaves_equal(mid, convert.state_leaves(restored[kind]),
                     f"checkpoint {engine} {kind}: restored against saved")
    st = restored["compressed"]
    del restored, template
    if phase:
        scan = driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r)
        st = scan(st, po[pre:pre + more], pt[pre:pre + more], pv[pre:pre + more])
        how = f"through a captured window (make_scan, {scan.window.captures} capture)"
    else:
        st = run(st, step, pre, pre + more)
        how = "eagerly"
    leaves_equal(want, convert.state_leaves(st), f"checkpoint {engine}: resumed run against "
                 "the uninterrupted one")
    say(f"checkpoint {engine} N={N_FULL}: saved at tick {rec['tick']} "
        f"({rec['bytes_compressed']} bytes compressed in {rec['save_s_compressed']:.3f} s, "
        f"{rec['bytes_uncompressed']} uncompressed in {rec['save_s_uncompressed']:.3f} s), "
        f"restored in {rec['restore_s_compressed']:.3f} / {rec['restore_s_uncompressed']:.3f} "
        f"s, equal to the saved state; {more} rounds resumed {how} equal the uninterrupted "
        f"run on every leaf; on {card_line()}")
    return rec


# ---------------------------------------------------------------------------
# phase 37: the application API (api.py) on the card

API_SUB_EVERY = 100             # 1,000 of the 100k nodes hold a Subscription
API_PHASES, API_ROUNDS = 8, 8   # driven phases at r = 8, rounds at r = 1
API_PUBS = 4                    # signed publishes a phase (a round at r = 1)
API_PARITY_BATCHES = 2          # publish batches of each card == CPU session
API_CELLS = ("gossipsub r=1", "gossipsub r=8", "floodsub", "randomsub",
             "max_message_size", "join/leave")
WIRE_BLOCK_CELLS = {             # cell: (kernels that must launch on a block state)
    "per-round": ("edge_exchange", "fused_delivery"),
    "phase": ("edge_exchange",),
    "floodsub lattice": ("delivery_banded",),
    "floodsub csr": ("csr_delivery",),
}


def api_lattice(api, n: int, device, **kw):
    """An ``api.Network`` of n nodes, each ``connect()``ed to its 8
    successors on the ring (``graph.ring_lattice(n, d=8)``'s edges, K = 16)
    and joined to topic "t"; returns (net, nodes, host seconds by step)."""
    secs = {}
    t0 = time.perf_counter()
    net = api.Network(device=device, **kw)
    nodes = net.add_nodes(n)
    secs["identities"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i, a in enumerate(nodes):
        for j in range(1, 9):
            net.connect(a, nodes[(i + j) % n])
    secs["connect"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for nd in nodes:
        nd.join("t")
    secs["join"] = time.perf_counter() - t0
    return net, nodes, secs


def api_session(api, sweep, device, cell: str) -> dict:
    """One scripted API session at N=8192 on ``device``: 3 batches of 4
    signed publishes from seeded origins, one run of 8 rounds (one phase at
    r = 8) after each, 1 in 64 nodes subscribed and node 0's event
    handler; the cell's own event (an oversized publish; a runtime Join
    and Leave of a second topic; a node going down). Returns what the card
    and the CPU must agree on."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch import convert

    if cell in ("floodsub", "randomsub"):
        kw = dict(router=cell)
    else:
        kw = dict(score_params=sweep.bench_score_params("default", 1)[1],
                  rounds_per_phase=8 if cell == "gossipsub r=8" else 1,
                  max_message_size=256 if cell == "max_message_size" else None)
    net, nodes, _secs = api_lattice(api, N_PARITY, device, seed=11, **kw)
    if cell == "join/leave":
        for nd in nodes[::4]:
            nd.join("u")
    subs = [nodes[i].topics["t"].subscribe() for i in range(0, N_PARITY, 64)]
    net.start()
    handlers = [nodes[0].topics["t"].event_handler()]
    rng = np.random.default_rng(3)
    for k in range(API_PARITY_BATCHES):
        for o in rng.integers(0, N_PARITY, API_PUBS).tolist():
            nodes[o].topics["t"].publish(b"api-%d-%d" % (k, o))
        if k == 1 and cell == "max_message_size":
            nodes[5].topics["t"].publish(b"L" * 1024)
        if k == 1 and cell == "join/leave":
            subs.append(nodes[1].join("u").subscribe())
            nodes[4].leave("u")
            nodes[8].topics["u"].publish(b"on-u")
        if k == 2 and cell != "floodsub" and cell != "randomsub":
            nodes[7].disconnect()
        net.run(8)
    events = []
    while (ev := handlers[0].next_event()) is not None:
        events.append(ev)
    return dict(subs=[[m.SerializeToString() for m in s] for s in subs], events=events,
                oversized=net.oversized_publishes, leaves=convert.state_leaves(net.state))


def api_parity(api, sweep, counters) -> dict:
    """Phase 37a: every API cell on the card and on the CPU from the same
    script: the subscriptions' bytes, the events and the final state equal
    leaf for leaf. Returns each cell's kernel launches on the card."""
    out = {}
    for cell in API_CELLS:
        t0 = time.perf_counter()
        for m in counters:
            m.reset_launch_counts()
        card = api_session(api, sweep, "cuda", cell)
        launched = counts(counters)
        cpu = api_session(api, sweep, "cpu", cell)
        for key in ("subs", "events", "oversized"):
            if card[key] != cpu[key]:
                raise AssertionError(f"API {cell}: {key} differ between card and CPU")
        leaves_equal(cpu["leaves"], card["leaves"], f"API {cell} final state")
        delivered = sum(len(s) for s in card["subs"])
        if not delivered:
            raise AssertionError(f"API {cell}: no subscription received a message")
        out[cell] = launched
        say(f"API {cell} card == CPU at N={N_PARITY}: {delivered} subscription messages, "
            f"{len(card['events'])} events and the final state equal leaf for leaf "
            f"({time.perf_counter() - t0:.1f} s; card launches {launched})")
    return out


def with_wire_block(st):
    """``st`` with an empty transmit-block plane (``MsgTable.wire_block``)."""
    import torch

    core = getattr(st, "core", st)
    msgs = dataclasses.replace(core.msgs, wire_block=torch.zeros(
        core.msgs.capacity, dtype=torch.bool, device=core.tick.device))
    core = dataclasses.replace(core, msgs=msgs)
    return dataclasses.replace(st, core=core) if hasattr(st, "core") else core


def wire_block_parity(sweep, driver, convert, dev, counters) -> dict:
    """Phase 37b: the block plane on the kernels' routes at N=8192, card
    against CPU every round or phase. Every third publish carries
    VERDICT_WIRE_BLOCK; the kernels take the block through their receiver
    exclusion, so each cell launches its route's kernels (the returned
    counts) and a blocked message is stamped at its origin only."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch.state import VERDICT_WIRE_BLOCK

    r8 = PHASE_R
    po, pt, pv = sweep.publish_schedule(2 * r8, N_PARITY, 1, None, seed=7)
    codes = np.where(pv, 0, 1).astype(np.int8)
    codes.reshape(-1)[::3] |= VERDICT_WIRE_BLOCK
    builds = {
        "per-round": lambda d: sweep.build_bench(N_PARITY, M_SLOTS, count_events=True,
                                                 device=d)[:2],
        "phase": lambda d: sweep.build_bench(N_PARITY, M_SLOTS, count_events=True,
                                             rounds_per_phase=r8, device=d)[:2],
        "floodsub lattice": lambda d: sweep.build_floodsub(N_PARITY, M_SLOTS, device=d),
        "floodsub csr": lambda d: sweep.build_floodsub(N_PARITY, M_SLOTS, graph="powerlaw",
                                                       layout="csr", device=d),
    }
    out = {}
    for cell, kernels_of in WIRE_BLOCK_CELLS.items():
        t0 = time.perf_counter()
        phase = cell == "phase"
        sides = {}
        for d in ("cuda", "cpu"):
            st, step = builds[cell](d)
            if phase:
                st = driver.form_mesh(step, st, rounds_per_phase=r8)
            sides[d] = (with_wire_block(st), step)
        for m in counters:
            m.reset_launch_counts()
        n_disp = 2 if phase else 2 * r8
        for i in range(n_disp):
            for d, (st, step) in list(sides.items()):
                if phase:
                    sl = slice(i * r8, (i + 1) * r8)
                    st = sweep.run_phases(st, step, po[sl], pt[sl], codes[sl],
                                          rounds_per_phase=r8, heartbeat_every=r8)
                else:
                    st = sweep.run_rounds(st, step, po[i:i + 1], pt[i:i + 1], codes[i:i + 1])
                sides[d] = (st, step)
                if d == "cuda":
                    launched = counts(counters)
            leaves_equal(convert.state_leaves(sides["cpu"][0]),
                         convert.state_leaves(sides["cuda"][0]), f"wire_block {cell} {i}")
        missing = [k for k in kernels_of if not launched[k]]
        if missing:
            raise AssertionError(f"wire_block {cell}: {missing} never launched on the block "
                                 f"state ({launched})")
        core = getattr(sides["cuda"][0], "core", sides["cuda"][0])
        block = core.msgs.wire_block.cpu().numpy()
        reach = (core.dlv.first_round >= 0).sum(0).cpu().numpy()
        if not block.any() or (reach[block] != 1).any():
            raise AssertionError(f"wire_block {cell}: a blocked message left its origin "
                                 f"(reach {reach[block].tolist()})")
        out[cell] = launched
        say(f"wire_block {cell} card == CPU at N={N_PARITY}: every leaf after each of {n_disp} "
            f"{'phases' if phase else 'rounds'}, {int(block.sum())} blocked messages at their "
            f"origins only, launches {launched} ({time.perf_counter() - t0:.1f} s)")
    return out


def api_full(api, sign, sweep, convert, dev, card, counters, r: int) -> dict:
    """Phase 37c: the API at full width: 100,000 nodes on the connect()ed
    lattice, the bench default's score parameters, 1,000 subscriptions,
    4 signed publishes a phase (r = 8) or a round (r = 1). The host's
    seconds to build, the API's rounds/s against the same step driven
    directly (make_gossipsub_phase_step / make_gossipsub_step with the
    API's options) on the calls the API made, the host's ms a round split
    into the step (to a sync), the two snapshots and the drain; the
    subscriptions reconciled with first_round (each message verifying),
    the final state equal to the direct build's, and the launches equal."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
        GossipSubState,
        make_gossipsub_step,
    )
    from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step

    sp = sweep.bench_score_params("default", 1)[1]
    net, nodes, secs = api_lattice(api, N_FULL, dev, score_params=sp, rounds_per_phase=r,
                                   seed=21)
    subs = {i: nodes[i].topics["t"].subscribe() for i in range(0, N_FULL, API_SUB_EVERY)}
    t0 = time.perf_counter()
    net.start()
    torch.cuda.synchronize()
    secs["start"] = time.perf_counter() - t0
    banded = net.net.band_off is not None
    # the host split: the step to a sync, the snapshots, the drain
    host = {"step": 0.0, "snapshot": 0.0, "drain": 0.0}
    calls = []
    step0, snap0, drain0 = net._step, api.snapshot, net._drain_deliveries

    def timed_step(st, *args, **kw):
        calls.append((tuple(a.clone() for a in args), kw))
        t = time.perf_counter()
        out = step0(st, *args, **kw)
        torch.cuda.synchronize()
        host["step"] += time.perf_counter() - t
        return out

    def timed_snapshot(st, *a, **kw):
        t = time.perf_counter()
        out = snap0(st, *a, **kw)
        host["snapshot"] += time.perf_counter() - t
        return out

    def timed_drain(prev, new):
        t = time.perf_counter()
        drain0(prev, new)
        host["drain"] += time.perf_counter() - t

    net._step, api.snapshot, net._drain_deliveries = timed_step, timed_snapshot, timed_drain
    rng = np.random.default_rng(9)
    dispatches = API_PHASES if r > 1 else API_ROUNDS
    for m in counters:
        m.reset_launch_counts()
    publish_s = run_s = 0.0
    try:
        for _ in range(dispatches):
            t = time.perf_counter()
            for o in rng.integers(0, N_FULL, API_PUBS).tolist():
                nodes[o].topics["t"].publish(b"api-%d" % o)
            publish_s += time.perf_counter() - t
            t = time.perf_counter()
            net.run(r)
            run_s += time.perf_counter() - t
    finally:
        api.snapshot = snap0
    launched = counts(counters)
    rounds = dispatches * r

    # the subscriptions against the device's first receipts
    fr = net.state.core.dlv.first_round.cpu().numpy()
    n_msgs = 0
    for i, sub in subs.items():
        got = list(sub)
        want = sorted(api.default_msg_id(net._slot_msg[s]) for s in np.flatnonzero(fr[i] >= 0))
        if sorted(api.default_msg_id(m) for m in got) != want:
            raise AssertionError(f"API N={N_FULL} r={r}: node {i}'s subscription holds "
                                 f"{len(got)} messages, first_round says {len(want)}")
        for m in got:
            sign.verify_message(m)
        n_msgs += len(got)

    # the same step built directly, driven with the API's calls
    cfg = net._cfg
    if r > 1:
        dstep = make_gossipsub_phase_step(cfg, net.net, r, score_params=sp,
                                          dynamic_peers=True, exact_counters=True,
                                          admission_capped=True)
    else:
        dstep = make_gossipsub_step(cfg, net.net, score_params=sp, dynamic_peers=True)
    dst = GossipSubState.init(net.net, net.msg_slots, cfg, score_params=sp, seed=21)
    if r > 1:   # the API's formation prelude: one publish-free phase
        w = net.pub_width
        dst = dstep(dst, torch.full((r, w), -1, dtype=torch.int32, device=dev),
                    torch.zeros((r, w), dtype=torch.int32, device=dev),
                    torch.zeros((r, w), dtype=torch.int8, device=dev),
                    torch.ones(N_FULL, dtype=torch.bool, device=dev), do_heartbeat=True)
    torch.cuda.synchronize()
    for m in counters:
        m.reset_launch_counts()
    t = time.perf_counter()
    for args, kw in calls:
        dst = dstep(dst, *args, **kw)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t
    direct_launched = counts(counters)
    if direct_launched != launched:
        raise AssertionError(f"API r={r} launches {launched}, the direct build's "
                             f"{direct_launched}")
    if banded:
        route = ({"edge_exchange": (1 + r) * dispatches} if r > 1 else
                 {"edge_exchange": rounds, "fused_delivery": rounds})
    else:
        route = {}
    # the API's config keeps GossipSubConfig's 2 fanout slots: 2 more
    # selections a heartbeat and 1 a dispatch for the publishes' fanout peers
    sel_per = SELECTIONS_PER_HEARTBEAT + (3 if cfg.fanout_slots else 0)
    want = {k: 0 for k in launched}
    want.update(route, select_topk=sel_per * dispatches)
    if launched != want:
        raise AssertionError(f"API r={r} launches {launched}, expected {want}")
    leaves_equal(convert.state_leaves(dst), convert.state_leaves(net.state),
                 f"API r={r} final state against the direct build")
    per = {k: 1e3 * v / rounds for k, v in host.items()}
    per["other"] = 1e3 * run_s / rounds - sum(per.values())
    rec = {"r": r, "n": N_FULL, "banded": banded, "build_s": secs, "subscriptions": len(subs),
           "subscription_messages": n_msgs, "api_rounds_per_s": rounds / run_s,
           "direct_rounds_per_s": rounds / direct_s, "publish_ms": 1e3 * publish_s /
           (dispatches * API_PUBS), "host_ms_a_round": per, "launches": launched}
    say(f"API N={N_FULL} r={r} on {card}: band_off {'set' if banded else 'None'} "
        f"(connect()'s slot order), build {json.dumps({k: round(v, 3) for k, v in secs.items()})}"
        f" s, {n_msgs} subscription messages reconciled with first_round and verified, final "
        f"state equal to the direct build's, launches {launched} equal to its route; "
        f"{rounds / run_s:.3f} rounds/s through the API against {rounds / direct_s:.3f} "
        f"direct; host ms a round {json.dumps({k: round(v, 3) for k, v in per.items()})}")
    return rec


# ---------------------------------------------------------------------------
# phase 38: the link-fault plane

#: the parity cells' generators (the JAX package's tests/test_chaos.py:50-51)
CHAOS_PARITY = {"iid": dict(loss_rate=0.35),
                "ge": dict(generator="ge", ge_p_down=0.15, ge_p_up=0.4)}
#: the full-width generators: the loss of the JAX package's
#: scripts/topo_smoke.py:72 and a bursty Gilbert–Elliott process (mean burst
#: 4 rounds, about 7% of the links bad)
CHAOS_FULL = {"iid": dict(loss_rate=0.1),
              "ge": dict(generator="ge", ge_p_down=0.02, ge_p_up=0.25)}
CHAOS_PARITY_ROUNDS = 4       # per-round dispatches of a parity cell (phases: 2; 8 before phase 45)
CHAOS_PARTITION_ROUNDS = 8    # the per-round partition cell: 4 rounds before the cut, 4 inside
CHAOS_FULL_ROUNDS = 16        # rounds of a timed full-width segment (2 phases)
#: the full-width partition: ticks of the cut (the phases at ticks 24-48
#: after form_mesh), then the heal and enough phases for a pruned
#: cross-group mesh link to re-form after the prune backoff (60 ticks); one
#: publish a round throughout into a table that recycles no slot in the run
#: (IHAVE ingest holds an [N, K, M] plane: M = 256 keeps it at 6.6 GB at
#: N=100k, K=32); the time to recover is read for the messages of the
#: cut's last phase (older ones may have left the 3 heartbeats IHAVE
#: advertises)
CHAOS_CUT = dict(start=24, rounds=32)
CHAOS_CUT_LAST = (48, 56)
CHAOS_CUT_PHASES = 20
CHAOS_CUT_SLOTS = 256


def _dispatch_counts(counters) -> dict:
    got = counts(counters)
    return {k: got.get(k, 0) for k in REPLACES}


def _route(n: int, **launched) -> dict:
    """A route's launch counts over ``n`` dispatches: every kernel 0 but
    the named ones, given per dispatch."""
    return {k: n * launched.get(k, 0) for k in REPLACES}


def plane_card_cpu(convert, counters, label: str, build, drive, n_disp: int, want: dict,
                   check):
    """One cell on the card and on the CPU (plain versions) from the same
    seed: ``build(device) -> (state, step)``, ``drive(state, step, i)``
    dispatch i; every leaf equal after every dispatch, the card's launches
    over the dispatches (every count at 0 just before) equal to ``want``,
    and ``check(leaves)`` passing on the card's final leaves. Returns the
    launches."""
    import torch

    sides = {d: build(torch.device(d)) for d in ("cuda", "cpu")}
    for mod in counters:
        mod.reset_launch_counts()
    for i in range(n_disp):
        for d, (st, step) in list(sides.items()):
            sides[d] = (drive(st, step, i), step)
        leaves_equal(convert.state_leaves(sides["cpu"][0]),
                     convert.state_leaves(sides["cuda"][0]), f"{label} dispatch {i}")
    got = _dispatch_counts(counters)
    if got != want:
        raise AssertionError(f"{label}: launches {got}, the route wants {want}")
    seen = check(convert.state_leaves(sides["cuda"][0]))
    say(f"{label} card == CPU: every leaf after each of {n_disp} dispatches at "
        f"N={N_PARITY}, {seen}, launches {got}")
    return got


def links_went_down(leaves) -> str:
    """A chaos cell's check: some link went down."""
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    ev = leaves[".core.events" if ".core.events" in leaves else ".events"]
    if ev[EV.LINK_DOWN] <= 0:
        raise AssertionError("no link went down")
    return f"LINK_DOWN {int(ev[EV.LINK_DOWN])} IWANT_RECOVER {int(ev[EV.IWANT_RECOVER])}"


def chaos_parity(sweep, driver, convert, dev, counters) -> dict:
    """Phase 38's checks at N=8192: every engine under the i.i.d. and the GE
    generator card against CPU with its route asserted from launch counts;
    scheduled partitions in both GossipSub engines; the elision; windows
    against their eager loops on the card. Returns the launches by cell."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig, two_group_partition

    n, r, nr, wr = N_PARITY, PHASE_R, CHAOS_PARITY_ROUNDS, CONFIG_WINDOW_ROUNDS
    po, pt, pv = sweep.publish_schedule(wr + r, n, 1, None, seed=11)
    rounds = lambda st, step, i: sweep.run_rounds(st, step, po[i:i + 1], pt[i:i + 1],
                                                  pv[i:i + 1])
    phases = lambda st, step, i: sweep.run_phases(
        st, step, po[i * r:(i + 1) * r], pt[i * r:(i + 1) * r], pv[i * r:(i + 1) * r],
        rounds_per_phase=r, heartbeat_every=r)

    def bench(chaos, rr=1, **kw):
        def build(d):
            st, step, _t, _h = sweep.build_bench(n, M_SLOTS, count_events=True,
                                                 rounds_per_phase=rr, device=d, chaos=chaos,
                                                 **kw)
            if rr > 1:
                st = driver.form_mesh(step, st, rounds_per_phase=rr)
            return st, step
        return build

    def sim(router, graph_kind, layout, chaos):
        def build(d):
            make = sweep.build_floodsub if router == "floodsub" else sweep.build_randomsub
            kw = {} if router == "floodsub" else dict(size_estimate=36)
            return make(n, M_SLOTS, graph=graph_kind, layout=layout, device=d, chaos=chaos,
                        **kw)
        return build

    out = {}
    sel = SELECTIONS_PER_HEARTBEAT
    for gen, kw in CHAOS_PARITY.items():
        chaos = ChaosConfig(**kw)
        cells = {
            # the reference's fused_eligible keeps a chaos round off both fused
            # kernels; the shared delivery round keeps delivery_banded
            "per-round lattice": (bench(chaos), rounds, nr,
                                  _route(nr, delivery_banded=1, select_topk=sel)),
            "phase lattice": (bench(chaos, r), phases, 2,
                              _route(2, edge_exchange=1 + r, select_topk=sel)),
            # the per-plane head: graft | prune | ihave in one exchange, the
            # IWANT window a gather of its own
            "phase per-plane lattice": (bench(chaos, r, wire_coalesced=False), phases, 2,
                                        _route(2, edge_exchange=1 + r, select_topk=sel)),
            "per-round random": (lambda d, c=chaos: random_gossip_build(n, d, c)[:2], rounds,
                                 nr, _route(nr, select_topk=sel)),
            "per-round csr": (bench(chaos, edge_layout="csr", fused=True), rounds, nr,
                              _route(nr, select_topk=sel)),
            "floodsub lattice": (sim("floodsub", "lattice", "dense", chaos), rounds, nr,
                                 _route(nr, delivery_banded=1)),
            "floodsub power-law csr": (sim("floodsub", "powerlaw", "csr", chaos), rounds, nr,
                                       _route(nr, csr_delivery=1)),
            "randomsub lattice": (sim("randomsub", "lattice", "dense", chaos), rounds, nr,
                                  _route(nr, delivery_banded=1, select_topk=1)),
            "randomsub power-law csr": (sim("randomsub", "powerlaw", "csr", chaos), rounds,
                                        nr, _route(nr, csr_delivery=1, select_topk=1)),
        }
        for cell, (build, drive, n_disp, want) in cells.items():
            out[f"{cell} {gen}"] = plane_card_cpu(convert, counters, f"chaos {cell} {gen}",
                                                  build, drive, n_disp, want, links_went_down)

    # scheduled partitions: the per-round step (i.i.d. beside the cut) and the
    # phase engine (GE beside it; one deny row a phase, its head's)
    nbr = graph.ring_lattice(n, d=8).nbr
    sc = two_group_partition(n, start=4, rounds=16)
    deny = np.stack([sc.link_deny_at(t, nbr) if sc.link_deny_at(t, nbr) is not None
                     else np.zeros(nbr.shape, bool) for t in range(wr + 2 * r)])
    sched_round = lambda st, step, i: sweep.run_rounds(
        st, step, po[i:i + 1], pt[i:i + 1], pv[i:i + 1], deny[i:i + 1])
    sched_phase = lambda st, step, i: sweep.run_phases(
        st, step, po[i * r:(i + 1) * r], pt[i * r:(i + 1) * r], pv[i * r:(i + 1) * r],
        rounds_per_phase=r, heartbeat_every=r, link_deny=deny[r + i * r:r + (i + 1) * r])
    out["per-round partition"] = plane_card_cpu(
        convert, counters, "chaos per-round partition", bench(ChaosConfig(
            **CHAOS_PARITY["iid"], scheduled=True)), sched_round, CHAOS_PARTITION_ROUNDS,
        _route(CHAOS_PARTITION_ROUNDS, delivery_banded=1, select_topk=sel), links_went_down)
    out["phase partition"] = plane_card_cpu(
        convert, counters, "chaos phase partition", bench(ChaosConfig(
            **CHAOS_PARITY["ge"], scheduled=True), r), sched_phase, 2,
        _route(2, edge_exchange=1 + r, select_topk=sel), links_went_down)

    # the elision: a disabled config is the chaos-off build, leaves and launches
    for engine, rr, drive, n_disp in (("per-round", 1, rounds, nr), ("phase", r, phases, 2)):
        runs = []
        for chaos in (None, ChaosConfig(), ChaosConfig(generator="ge")):
            st, step = bench(chaos, rr)(dev)
            for mod in counters:
                mod.reset_launch_counts()
            for i in range(n_disp):
                st = drive(st, step, i)
            runs.append((convert.state_leaves(st), _dispatch_counts(counters)))
        for leaves, got in runs[1:]:
            leaves_equal(runs[0][0], leaves, f"chaos off {engine}")
            if got != runs[0][1]:
                raise AssertionError(f"chaos off {engine}: launches {got} against the "
                                     f"chaos-off build's {runs[0][1]}")
        out[f"{engine} disabled"] = runs[0][1]
        say(f"chaos off {engine}: ChaosConfig() and ChaosConfig(generator='ge') equal the "
            f"chaos=None build leaf for leaf, launches {runs[0][1]} alike")

    # windows against their eager loops on the card: the per-round step under
    # i.i.d. flaps, the scheduled GE phase engine with deny rows as xs
    for engine, rr, chaos in (("per-round", 1, ChaosConfig(**CHAOS_PARITY["iid"])),
                              ("phase", r, ChaosConfig(**CHAOS_PARITY["ge"], scheduled=True))):
        leaves = []
        wdeny = deny[r:r + wr] if rr > 1 else None
        for mode in ("eager", "window"):
            st, step = bench(chaos, rr)(dev)
            sl = slice(0, wr)
            if mode == "eager":
                st = (sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=rr,
                                       heartbeat_every=rr, link_deny=wdeny) if rr > 1
                      else sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl]))
            else:
                scan = (driver.make_scan(step, heartbeat_every=rr, rounds_per_phase=rr)
                        if rr > 1 else driver.make_scan(step, static_heartbeat=False, unroll=4))
                rows = lambda sl: ({} if wdeny is None else
                                   dict(link_deny=torch.as_tensor(wdeny[sl], device=dev)))
                half = wr // 2
                st = scan(st, po[:half], pt[:half], pv[:half], **rows(slice(0, half)))
                st = scan(st, po[half:wr], pt[half:wr], pv[half:wr], **rows(slice(half, wr)))
                torch.cuda.synchronize()
                if scan.window.captures != 1 or scan.window.replays < 2:
                    raise AssertionError(f"chaos {engine} window: {scan.window.captures} "
                                         f"captures, {scan.window.replays} replays")
                out[f"{engine} window block"] = {k: v for k, v in
                                                 scan.window.block_launches.items() if v}
            leaves.append(convert.state_leaves(st))
            del st, step
        leaves_equal(leaves[0], leaves[1], f"chaos {engine} window against eager")
        say(f"chaos {engine} window N={n}: equal to the eager loop leaf for leaf after {wr} "
            f"rounds in two calls; a block launches {out[f'{engine} window block']}")
    return out


def chaos_observe(n: int):
    """A full-width chaos turn's readings: the chaos counters, the IWANT
    recovery share and the delivery ratio over the resident messages
    (``chaos.metrics``, every peer subscribed to the one topic)."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch.chaos import (
        delivery_stats,
        iwant_recovery_share,
        links_down_total,
    )
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    def observe(st) -> dict:
        ev = st.core.events.cpu().numpy()
        msgs = st.core.msgs
        stats = delivery_stats(st.core.dlv.first_round.cpu().numpy(), msgs.birth.cpu().numpy(),
                               msgs.topic.cpu().numpy(), msgs.origin.cpu().numpy(),
                               np.ones((n, 1), bool))
        return {"link_down": links_down_total(ev), "iwant_recover": int(ev[EV.IWANT_RECOVER]),
                "iwant_share": iwant_recovery_share(ev), "delivered": stats.delivered,
                "expected": stats.expected, "delivery_ratio": stats.ratio}

    return observe


def chaos_full(sweep, driver, dev, card, counters) -> dict:
    """Phase 38 at full width: the bench default config at N=100k (events
    counted) without chaos, under CHAOS_FULL's i.i.d. and GE generators, in
    both engines, eager and windowed (off, iid, ge in turns), each window's
    block on the route of its engine under chaos; FloodSub under the i.i.d.
    flaps on the lattice and on powerlaw(1M) CSR-resident beside itself
    without them. Returns the turns."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig, delivery_stats
    from go_libp2p_pubsub_tpu_torch.state import SimState
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    out = {}
    sel = SELECTIONS_PER_HEARTBEAT
    for engine in ("per-round", "phase"):
        r = PHASE_R if engine == "phase" else 1
        for label in ("off", "iid", "ge"):
            chaos = None if label == "off" else ChaosConfig(**CHAOS_FULL[label])
            turns = window_bench(sweep, driver, dev, card, counters, engine,
                                 observe=chaos_observe(N_FULL), modes=("eager", "window"),
                                 measured=CHAOS_FULL_ROUNDS, count_events=True, chaos=chaos)
            block = turns[1]["block_launches"]
            d = turns[1]["block_dispatches"]
            if chaos is not None:
                want = (_route(d, edge_exchange=1 + r, select_topk=sel) if r > 1
                        else _route(d, delivery_banded=1, select_topk=sel))
                want = {k: v for k, v in want.items() if v}
                if block != want:
                    raise AssertionError(f"chaos {label} {engine} window block launches "
                                         f"{block}, the route wants {want}")
            out[f"{engine} {label}"] = turns

    # FloodSub under the i.i.d. flaps at full width, beside itself without
    f, m = SCALE_FORMATION, SCALE_ROUNDS
    for graph_kind, layout, n, kernel in (("lattice", "dense", N_FULL, "delivery_banded"),
                                         ("powerlaw", "csr", N_CSR, "csr_delivery")):
        _st, base = sweep.build_floodsub(n, M_SLOTS, graph=graph_kind, layout=layout, device=dev)
        del _st
        po, pt, pv = sweep.publish_schedule(f + m, n, 1, None, seed=12)
        for label in ("off", "iid", "iid", "off"):
            chaos = None if label == "off" else ChaosConfig(**CHAOS_FULL["iid"])
            step = sweep.FloodSubRun(base.net, base.setup_seconds, 0, chaos)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            st = SimState.init(n, M_SLOTS, k=base.net.max_degree, device=dev,
                               n_edges=base.net.n_edges)
            st = sweep.run_rounds(st, step, po[:f], pt[:f], pv[:f])
            for mod in counters:
                mod.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = sweep.run_rounds(st, step, po[f:], pt[f:], pv[f:])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {k: v for k, v in _dispatch_counts(counters).items() if v}
            if got != {kernel: m}:
                raise AssertionError(f"floodsub {graph_kind} {label}: launches {got}, the "
                                     f"route wants {{{kernel!r}: {m}}}")
            stats = delivery_stats(st.dlv.first_round.cpu().numpy(), st.msgs.birth.cpu().numpy(),
                                   st.msgs.topic.cpu().numpy(), st.msgs.origin.cpu().numpy(),
                                   np.ones((n, 1), bool))
            rec = {"rate": m / dt, "peak": torch.cuda.max_memory_allocated(),
                   "link_down": int(st.events[EV.LINK_DOWN]),
                   "delivery_ratio": stats.ratio, "launches": got}
            out.setdefault(f"floodsub {graph_kind} {layout}", []).append({label: rec})
            say(f"chaos floodsub {graph_kind}/{layout} {label} N={n}: {rec['rate']:.3f} rounds/s "
                f"over {m} rounds, launches {got}, LINK_DOWN {rec['link_down']}, delivery "
                f"ratio {stats.ratio:.6f} ({stats.delivered}/{stats.expected}), peak memory "
                f"{rec['peak']} bytes, on {card}")
            del st, step
        del base
    return out


def random_gossip_build(n: int, device, chaos, r: int = 1, msg_slots: int = M_SLOTS):
    """GossipSub on ``random_connect(n, 8, seed=0)`` (a small-world net a
    message crosses in a few hops, so a run can watch every message
    recover; K = 32 at N=100k, unbanded: the composites and
    ``select_topk``): the bench's parameters with the sybil config's
    delivery-deficit scoring (P3: a mesh link that carries nothing loses
    score), events counted, under ``chaos``; the per-round step, or at r > 1
    the phase engine with the mesh formed. Returns (state, step,
    topology, net, config)."""
    import dataclasses

    from go_libp2p_pubsub_tpu_torch import driver, graph
    from go_libp2p_pubsub_tpu_torch.config import GossipSubParams
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
        GossipSubConfig,
        GossipSubState,
        make_gossipsub_step,
    )
    from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from go_libp2p_pubsub_tpu_torch.state import Net

    tp = graph.random_connect(n, 8, seed=0)
    net = Net.build(tp, graph.subscribe_all(n, 1), device=device)
    _tp, sp = sweep.bench_score_params("sybil", 1)
    params = dataclasses.replace(GossipSubParams(), flood_publish=False)
    cfg = GossipSubConfig.build(params, sweep.bench_thresholds(), score_enabled=True,
                                heartbeat_every=r, chaos=chaos)
    cfg = dataclasses.replace(cfg, count_events=True, fanout_slots=0)
    st = GossipSubState.init(net, msg_slots, cfg, score_params=sp, seed=0)
    if r == 1:
        return st, make_gossipsub_step(cfg, net, score_params=sp), tp, net, cfg
    step = make_gossipsub_phase_step(cfg, net, r, score_params=sp)
    return driver.form_mesh(step, st, rounds_per_phase=r), step, tp, net, cfg


def chaos_partition(driver, dev, card, counters) -> dict:
    """Phase 38's scheduled partition at N=100k (``random_gossip_build``):
    CHAOS_CUT_PHASES phases of r=8 through one ``driver.make_window`` with
    the deny rows of ``two_group_partition`` (halves: about half of the
    links cross; cut over CHAOS_CUT) as xs and the device cross-group mesh
    observer: no message born in the cut crosses it before the heal; the
    cross-group mesh edges before, during and after it; the mesh repair and
    re-form latencies, the delivery ratio of the cut's messages and the time
    to recover those of its last phase (``chaos.metrics``); every block
    launches 8 ``select_topk`` a phase and nothing else (an unbanded net)."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch.chaos import (
        ChaosConfig,
        delivery_stats,
        halves,
        make_cross_mesh_observer,
        mesh_reform_latency,
        mesh_repair_latency,
        time_to_recover,
        two_group_partition,
    )
    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    n, r, d = N_FULL, PHASE_R, CHAOS_CUT_PHASES
    t0 = time.perf_counter()
    st, step, tp, _net, _cfg = random_gossip_build(n, dev, ChaosConfig(scheduled=True), r,
                                                   CHAOS_CUT_SLOTS)
    build_s = time.perf_counter() - t0
    groups = np.asarray(halves(n))
    sc = two_group_partition(n, **CHAOS_CUT)
    tick0 = int(st.core.tick)
    ticks = tick0 + r * np.arange(d)
    zeros = np.zeros(tp.nbr.shape, bool)
    deny = np.stack([zeros if sc.link_deny_at(int(t), tp.nbr) is None
                     else sc.link_deny_at(int(t), tp.nbr) for t in ticks])
    po, pt, pv = sweep.publish_schedule(d * r, n, 1, None, seed=13)
    po[:, 1:] = -1
    obs = make_cross_mesh_observer(tp.nbr, tp.nbr_ok, groups, device=dev)
    before = int(obs(st))
    win = driver.make_window(step, heartbeat=[True], observe=obs)
    xs = tuple(torch.as_tensor(a, device=dev) for a in (
        po.reshape(d, r, -1), pt.reshape(d, r, -1), pv.reshape(d, r, -1), deny))
    for mod in counters:
        mod.reset_launch_counts()
    t1 = time.perf_counter()
    st, ys = win(st, xs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t1
    block = {k: v for k, v in win.block_launches.items() if v}
    if block != {"select_topk": SELECTIONS_PER_HEARTBEAT}:
        raise AssertionError(f"partition window block launches {block}, the route wants "
                             f"{{'select_topk': {SELECTIONS_PER_HEARTBEAT}}}")
    series = [(tick0, before)] + [(int(t) + r, int(c))
                                  for t, c in zip(ticks, ys["obs"].cpu().numpy())]
    heal = sc.partitions[0].end
    fr = st.core.dlv.first_round.cpu().numpy()
    birth = st.core.msgs.birth.cpu().numpy()
    origin = st.core.msgs.origin.cpu().numpy()
    topic = st.core.msgs.topic.cpu().numpy()
    cut_era = (CHAOS_CUT["start"], heal)
    cut = (birth >= cut_era[0]) & (birth < cut_era[1])
    for m in np.nonzero(cut)[0]:
        other = groups != groups[origin[m]]
        if ((fr[other, m] >= 0) & (fr[other, m] < heal)).any():
            raise AssertionError(f"partition: message {m} crossed the cut before the heal")
    subscribed = np.ones((n, 1), bool)
    stats = delivery_stats(fr, birth, topic, origin, subscribed, born_in=cut_era)
    last = delivery_stats(fr, birth, topic, origin, subscribed, born_in=CHAOS_CUT_LAST)
    ev = st.core.events.cpu().numpy()
    rec = {"card": card, "graph": f"random_connect({n}, 8, seed=0), K={tp.nbr.shape[1]}",
           "cut": CHAOS_CUT, "heal_tick": heal, "series": series,
           "mesh_repair_latency": mesh_repair_latency(series, heal),
           "mesh_reform_latency": mesh_reform_latency(series, heal),
           "time_to_recover": time_to_recover(fr, birth, topic, origin, subscribed, heal,
                                              born_in=CHAOS_CUT_LAST),
           "cut_messages": int(cut.sum()), "delivery_ratio": stats.ratio,
           "last_phase_delivery_ratio": last.ratio,
           "link_down": int(ev[EV.LINK_DOWN]), "iwant_recover": int(ev[EV.IWANT_RECOVER]),
           "prune": int(ev[EV.PRUNE]), "graft": int(ev[EV.GRAFT]),
           "block_launches": block, "build_seconds": build_s,
           "delivery_rounds_per_s": d * r / run_s}
    say(f"chaos partition N={n} r={r} on {rec['graph']}: cross-group mesh edges "
        f"{series} (cut ticks {CHAOS_CUT['start']}-{heal - 1}); no cut message crossed "
        f"before the heal; mesh repair latency {rec['mesh_repair_latency']}, re-form latency "
        f"{rec['mesh_reform_latency']}, time to recover the last cut phase's messages "
        f"{rec['time_to_recover']} rounds (their delivery ratio {last.ratio:.6f}), delivery "
        f"ratio of the cut's {rec['cut_messages']} messages {stats.ratio:.6f}; "
        f"LINK_DOWN {rec['link_down']} IWANT_RECOVER {rec['iwant_recover']} PRUNE "
        f"{rec['prune']} GRAFT {rec['graft']}; a block launches {block}; build "
        f"{build_s:.1f} s, {rec['delivery_rounds_per_s']:.3f} delivery-rounds/s windowed, "
        f"on {card}")
    return rec


# ---------------------------------------------------------------------------
# phase 40: the attack plane

#: the parity cells' population: every behaviour, a fifth of the peers
#: from a ramped onset, censoring every seventh peer's messages
ATTACK_PARITY_ROUNDS = 8       # per-round dispatches of an attack parity cell (phases: 2)
ATTACK_PARITY = dict(sybil_fraction=0.2, onset=2, ramp_rounds=2, seed=3)
#: scripts/attack_report.py's sybil-flood cell (its fraction, behaviours,
#: onset and loss) on the bench default config; 2 honest publishes a round
#: at ticks ATTACK_PUBS into 64 slots (none recycled), delivery read for
#: the messages born in ATTACK_BORN (its SYBIL_BORN) at the run's end
ATTACK_FLOOD = dict(sybil_fraction=0.2, onset=12, seed=0,
                    behaviors=("drop_forward", "lie_ihave", "graft_spam", "self_promo"))
ATTACK_LOSS = 0.1
ATTACK_ROUNDS = 56
ATTACK_PUBS = (4, 36)
ATTACK_BORN = (16, 36)
#: the most honest delivery an attack may cost over the pairs its
#: attack-free twin reached (the JAX smoke's tolerance)
ATTACK_HONEST_TOL = 0.05
#: its eclipse cell: half of each target's neighbourhood sybil, graft spam
#: toward the targets and drop-on-forward, from tick 20, no link faults
ATTACK_ECLIPSE = dict(targets=(0, 1, 2), surround_targets=True, surround_fraction=0.5,
                      behaviors=("drop_forward", "graft_spam"), onset=20, seed=1)
ECLIPSE_ROUNDS = 88


def attack_parity(sweep, driver, convert, dev, counters) -> dict:
    """Phase 40's checks at N=8192: all five behaviours in all four engines,
    card against CPU with the route asserted from launch counts (the
    per-round step off both fused kernels, as the reference's
    fused_eligible keeps an adversary build, with delivery_banded a round
    and 8 select_topk a heartbeat; the phase engine 1 + r edge_exchange a
    phase; FloodSub and RandomSub their delivery kernel a round), each
    recording the telemetry panel, which must reconcile on the card, also in
    FloodSub and RandomSub cells without an attack; an unarmed population
    equal to none in leaves and launches, and attacked windows against
    their eager loops. Returns the launches by cell."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch.chaos import BEHAVIORS, Adversary, AttackScenario
    from go_libp2p_pubsub_tpu_torch.telemetry import TelemetryConfig, reconcile
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    n, r, nr, wr = N_PARITY, PHASE_R, ATTACK_PARITY_ROUNDS, CONFIG_WINDOW_ROUNDS
    tel = TelemetryConfig(rows=nr, tracked=(0, n // 2))
    scenario = AttackScenario(n_peers=n, behaviors=BEHAVIORS,
                              censor_origins=tuple(range(0, n, 7)), **ATTACK_PARITY)
    po, pt, pv = sweep.publish_schedule(wr + r, n, 1, None, seed=14)
    rounds = lambda st, step, i: sweep.run_rounds(st, step, po[i:i + 1], pt[i:i + 1],
                                                  pv[i:i + 1])
    phases = lambda st, step, i: sweep.run_phases(
        st, step, po[i * r:(i + 1) * r], pt[i * r:(i + 1) * r], pv[i * r:(i + 1) * r],
        rounds_per_phase=r, heartbeat_every=r)

    def bench(adversary, rr=1):
        def build(d):
            st, step, _t, _h = sweep.build_bench(n, M_SLOTS, count_events=True,
                                                 rounds_per_phase=rr, device=d,
                                                 adversary=adversary, telemetry=tel)
            if rr > 1:
                st = driver.form_mesh(step, st, rounds_per_phase=rr)
            return st, step
        return build

    def sim(router, graph_kind, layout, adversary=scenario):
        def build(d):
            make = sweep.build_floodsub if router == "floodsub" else sweep.build_randomsub
            kw = {} if router == "floodsub" else dict(size_estimate=36)
            return make(n, M_SLOTS, graph=graph_kind, layout=layout, device=d,
                        adversary=adversary, telemetry=tel, **kw)
        return build

    def counters_of(gossip: bool, armed: bool = True):
        def check(leaves):
            pre = ".core" if gossip else ""
            ev = leaves[f"{pre}.events"]
            bad = reconcile(leaves[f"{pre}.telem.panel"], ev)
            if bad:
                raise AssertionError(f"telemetry reconcile on the card: {bad}")
            names = (("ADV_DROP", "ADV_IHAVE_LIE", "ADV_GRAFT_SPAM") if gossip
                     else ("ADV_DROP",))
            got = {k: int(ev[EV[k]]) for k in names}
            if armed and min(got.values()) <= 0:
                raise AssertionError(f"attack counters {got}: a behaviour never acted")
            return f"counters {got}, the panel reconciled"
        return check

    sel = SELECTIONS_PER_HEARTBEAT
    cells = {
        "per-round lattice": (bench(scenario), rounds, nr,
                              _route(nr, delivery_banded=1, select_topk=sel), True),
        "phase lattice": (bench(scenario, r), phases, 2,
                          _route(2, edge_exchange=1 + r, select_topk=sel), True),
        "floodsub lattice": (sim("floodsub", "lattice", "dense"), rounds, nr,
                             _route(nr, delivery_banded=1), False),
        "floodsub power-law csr": (sim("floodsub", "powerlaw", "csr"), rounds, nr,
                                   _route(nr, csr_delivery=1), False),
        "randomsub lattice": (sim("randomsub", "lattice", "dense"), rounds, nr,
                              _route(nr, delivery_banded=1, select_topk=1), False),
        "randomsub power-law csr": (sim("randomsub", "powerlaw", "csr"), rounds, nr,
                                    _route(nr, csr_delivery=1, select_topk=1), False),
        "floodsub power-law csr, no attack": (sim("floodsub", "powerlaw", "csr", None), rounds,
                                              nr, _route(nr, csr_delivery=1), False),
        "randomsub lattice, no attack": (sim("randomsub", "lattice", "dense", None), rounds, nr,
                                         _route(nr, delivery_banded=1, select_topk=1), False),
    }
    out = {}
    for cell, (build, drive, n_disp, want, gossip) in cells.items():
        out[cell] = plane_card_cpu(convert, counters, f"attack {cell}", build, drive, n_disp,
                                   want, counters_of(gossip, "no attack" not in cell))

    # an unarmed population is no population: leaves and launches
    unarmed = Adversary(n, np.zeros(n, bool), behaviors=("drop_forward", "lie_ihave"))
    for engine, rr, drive, n_disp in (("per-round", 1, rounds, nr), ("phase", r, phases, 2)):
        runs = []
        for adversary in (None, unarmed):
            st, step = bench(adversary, rr)(dev)
            for mod in counters:
                mod.reset_launch_counts()
            for i in range(n_disp):
                st = drive(st, step, i)
            runs.append((convert.state_leaves(st), _dispatch_counts(counters)))
        leaves_equal(runs[0][0], runs[1][0], f"attack unarmed {engine}")
        if runs[1][1] != runs[0][1]:
            raise AssertionError(f"attack unarmed {engine}: launches {runs[1][1]} against "
                                 f"{runs[0][1]}")
        out[f"{engine} unarmed"] = runs[0][1]
        say(f"attack unarmed {engine}: a population with no sybil equals adversary=None "
            f"leaf for leaf, launches {runs[0][1]} alike")

    # attacked windows against their eager loops on the card
    for engine, rr in (("per-round", 1), ("phase", r)):
        leaves = []
        for mode in ("eager", "window"):
            st, step = bench(scenario, rr)(dev)
            sl = slice(0, wr)
            if mode == "eager":
                st = (sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=rr,
                                       heartbeat_every=rr) if rr > 1
                      else sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl]))
            else:
                scan = (driver.make_scan(step, heartbeat_every=rr, rounds_per_phase=rr)
                        if rr > 1 else driver.make_scan(step, static_heartbeat=False, unroll=4))
                half = wr // 2
                st = scan(st, po[:half], pt[:half], pv[:half])
                st = scan(st, po[half:wr], pt[half:wr], pv[half:wr])
                torch.cuda.synchronize()
                if scan.window.captures != 1 or scan.window.replays < 2:
                    raise AssertionError(f"attack {engine} window: {scan.window.captures} "
                                         f"captures, {scan.window.replays} replays")
                out[f"{engine} window block"] = {k: v for k, v in
                                                 scan.window.block_launches.items() if v}
            leaves.append(convert.state_leaves(st))
            del st, step
        leaves_equal(leaves[0], leaves[1], f"attack {engine} window against eager")
        say(f"attack {engine} window N={n}: equal to the eager loop leaf for leaf after {wr} "
            f"rounds in two calls; a block launches {out[f'{engine} window block']}")
    return out


def attack_schedule(is_sybil, rounds: int, seed: int = 0):
    """[T, 2] publishes by absolute tick: 2 honest origins a round at ticks
    ATTACK_PUBS, none elsewhere (T = rounds + r covers the phase engine's
    form_mesh)."""
    import numpy as np

    t = rounds + PHASE_R
    rng = np.random.default_rng(seed)
    po = np.full((t, 2), -1, np.int32)
    po[ATTACK_PUBS[0]:ATTACK_PUBS[1]] = rng.choice(
        np.flatnonzero(~is_sybil), size=(ATTACK_PUBS[1] - ATTACK_PUBS[0], 2))
    return po, np.zeros((t, 2), np.int32), po >= 0


def attack_run(sweep, driver, dev, engine: str, mode: str, po, pt, pv, counters, observe=None,
               rounds: int | None = None, **bench_kw):
    """One full-width run of the bench default config (events counted):
    the per-round step over ticks [0, rounds), or form_mesh and the phase
    engine over [r, r + rounds) (``rounds`` default ATTACK_ROUNDS), eager
    or through make_scan.
    ``observe(state, tick)`` reads the state after every dispatch of an
    eager run. Returns (state, record)."""
    import torch

    r = PHASE_R if engine == "phase" else 1
    rounds = ATTACK_ROUNDS if rounds is None else rounds
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=r, device=dev,
                                         count_events=True, **bench_kw)
    t0 = 0
    if r > 1:
        st = driver.form_mesh(step, st, rounds_per_phase=r, pub_width=2)
        t0 = r
    sl = slice(t0, t0 + rounds)
    rec = {"mode": mode}
    for mod in counters:
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if mode == "window":
        scan = (driver.make_scan(step, heartbeat_every=r, rounds_per_phase=r, unroll=2)
                if r > 1 else driver.make_scan(step, static_heartbeat=False, unroll=4))
        st = scan(st, po[sl], pt[sl], pv[sl])
    elif observe is None:
        st = (sweep.run_phases(st, step, po[sl], pt[sl], pv[sl], rounds_per_phase=r,
                               heartbeat_every=r) if r > 1
              else sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl]))
    else:
        for i in range(0, rounds, r):
            a = slice(t0 + i, t0 + i + r)
            st = (sweep.run_phases(st, step, po[a], pt[a], pv[a], rounds_per_phase=r,
                                   heartbeat_every=r) if r > 1
                  else sweep.run_rounds(st, step, po[a], pt[a], pv[a]))
            observe(st, t0 + i + r)
    torch.cuda.synchronize()
    rec["seconds"] = time.perf_counter() - t1
    if mode == "window":
        win = scan.window
        rec.update(capture_seconds=win.capture_seconds,
                   block_launches={k: v for k, v in win.block_launches.items() if v},
                   block_dispatches=win.block_dispatches)
        rec["rate"] = rounds / max(rec["seconds"] - win.capture_seconds, 1e-9)
    else:
        rec["launches"] = {k: v for k, v in _dispatch_counts(counters).items() if v}
        rec["rate"] = rounds / rec["seconds"]
    if int(st.core.tick) != t0 + rounds:
        raise AssertionError(f"attack {engine} {mode}: tick {int(st.core.tick)}")
    return st, rec


def attack_readings(st, is_sybil, att_edges, hon_edges, reach=None) -> dict:
    """The sybil-flood cell's readings (scripts/attack_report.py's): the
    delivery ratio of the messages born in ATTACK_BORN to honest and to
    sybil receivers, the median score honest peers hold of attacker edges
    and of honest edges, and the attack and fault counters. ``reach`` (the
    attack-free twin's [N, M] delivered plane, on the same publish and
    fault streams) adds each side's delivery over the pairs the twin
    reached (None where the twin reached none), and the run's own plane
    comes back under ``"reached"``."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch.chaos import expected_receivers
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    n = is_sybil.shape[0]
    msgs = st.core.msgs
    birth, topic, origin = (msgs.birth.cpu().numpy(), msgs.topic.cpu().numpy(),
                            msgs.origin.cpu().numpy())
    got = st.core.dlv.first_round.cpu().numpy() >= 0
    exp = expected_receivers(birth, topic, origin, np.ones((n, 1), bool), born_in=ATTACK_BORN)
    out = {"reached": got, "msgs": (birth, topic, origin)}
    for side, rows in (("honest", ~is_sybil), ("sybil", is_sybil)):
        e = exp & rows[:, None]
        out[f"{side}_delivery"] = float((got & e).sum() / max(int(e.sum()), 1))
        out[f"{side}_expected"] = int(e.sum())
        if reach is not None:
            twin = e & reach
            out[f"{side}_twin_reached"] = int(twin.sum())
            out[f"{side}_delivery_of_twin"] = (float((got & twin).sum() / twin.sum())
                                               if twin.any() else None)
    scores = st.scores.cpu().numpy()
    ev = st.core.events.cpu().numpy()
    out.update(attacker_edge_score_median=float(np.median(scores[att_edges])),
               honest_edge_score_median=float(np.median(scores[hon_edges])),
               **{k.lower(): int(ev[EV[k]]) for k in ("ADV_DROP", "ADV_IHAVE_LIE",
                                                       "ADV_GRAFT_SPAM", "LINK_DOWN")})
    return out


def attack_flood(sweep, driver, convert, dev, card, counters) -> dict:
    """Phase 40's sybil flood at N=100k: both engines, eager and windowed,
    each after the attack-free run on the same fault and publish streams
    (i.i.d. loss ATTACK_LOSS); windows equal their eager loops leaf for
    leaf and launch, a block, the route of an attacked build. The sybils
    are the last fifth of the ids, one arc of the bench ring, so a message
    meets them only near the arc's two ends: delivery is read over the
    pairs the attack-free twin reached, where the attack must keep
    honest delivery within ATTACK_HONEST_TOL and the honest peers must
    score attacker edges below honest ones. Returns the runs."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.chaos import AttackScenario, ChaosConfig

    scenario = AttackScenario(n_peers=N_FULL, **ATTACK_FLOOD)
    is_sybil = scenario.build().is_sybil
    tp = graph.ring_lattice(N_FULL, d=8)
    nbr = np.clip(tp.nbr, 0, None)
    att = tp.nbr_ok & is_sybil[nbr] & ~is_sybil[:, None]
    hon = tp.nbr_ok & ~is_sybil[nbr] & ~is_sybil[:, None]
    po, pt, pv = attack_schedule(is_sybil, ATTACK_ROUNDS)
    chaos = ChaosConfig(loss_rate=ATTACK_LOSS)
    sel = SELECTIONS_PER_HEARTBEAT
    adv_keys = ("adv_drop", "adv_ihave_lie", "adv_graft_spam")
    out = {}
    for engine in ("per-round", "phase"):
        r = PHASE_R if engine == "phase" else 1
        twin = None
        for armed in (False, True):
            label = f"{engine} {'attack' if armed else 'ablation'}"
            leaves = []
            for mode in ("eager", "window"):
                st, rec = attack_run(sweep, driver, dev, engine, mode, po, pt, pv, counters,
                                     chaos=chaos, adversary=scenario if armed else None)
                rec.update(attack_readings(st, is_sybil, att, hon,
                                           reach=twin["reached"] if armed else None))
                leaves.append(convert.state_leaves(st))
                del st
                if mode == "eager" and not armed:
                    twin = {"reached": rec["reached"], "msgs": rec["msgs"]}
                elif armed and any(not np.array_equal(a, b)
                                   for a, b in zip(rec["msgs"], twin["msgs"])):
                    raise AssertionError(f"attack {label} {mode}: the message table differs "
                                         "from the twin's")
                del rec["reached"], rec["msgs"]
                if mode == "window" and armed:
                    d = rec["block_dispatches"]
                    want = (_route(d, edge_exchange=1 + r, select_topk=sel) if r > 1
                            else _route(d, delivery_banded=1, select_topk=sel))
                    want = {k: v for k, v in want.items() if v}
                    if rec["block_launches"] != want:
                        raise AssertionError(f"attack {label} window block launches "
                                             f"{rec['block_launches']}, the route wants {want}")
                unit = "delivery-rounds/s" if r > 1 else "rounds/s"
                of_twin = ""
                if armed:
                    of_twin = (f" ({rec['honest_delivery_of_twin']} of the "
                               f"{rec['honest_twin_reached']} pairs the twin reached), "
                               f"attacker {rec['sybil_delivery_of_twin']} of the twin's "
                               f"{rec['sybil_twin_reached']}")
                say(f"attack sybil flood {label} {mode} N={N_FULL}: {rec['rate']:.3f} {unit} "
                    f"over {ATTACK_ROUNDS} rounds ({rec.get('capture_seconds', 0.0):.3f} s "
                    f"capture), honest delivery {rec['honest_delivery']:.6f} "
                    f"({rec['honest_expected']} expected){of_twin}, attacker delivery "
                    f"{rec['sybil_delivery']:.6f}, median score of attacker edges "
                    f"{rec['attacker_edge_score_median']:.6f} (honest edges "
                    f"{rec['honest_edge_score_median']:.6f}), ADV_DROP {rec['adv_drop']} "
                    f"ADV_IHAVE_LIE {rec['adv_ihave_lie']} ADV_GRAFT_SPAM "
                    f"{rec['adv_graft_spam']} LINK_DOWN {rec['link_down']}, launches "
                    f"{rec.get('launches', rec.get('block_launches'))}, on {card}")
                if not armed and any(rec[k] for k in adv_keys):
                    raise AssertionError(f"attack {label} {mode}: attack counters "
                                         f"{[rec[k] for k in adv_keys]} with no attack")
                if armed:
                    if not (rec["adv_ihave_lie"] and rec["adv_graft_spam"]):
                        raise AssertionError(f"attack {label} {mode}: no lying IHAVE or "
                                             f"GRAFT flood counted ({rec['adv_ihave_lie']}, "
                                             f"{rec['adv_graft_spam']})")
                    if not (rec["attacker_edge_score_median"]
                            < rec["honest_edge_score_median"]):
                        raise AssertionError(
                            f"attack {label} {mode}: honest peers score attacker edges at "
                            f"{rec['attacker_edge_score_median']}, not below honest edges "
                            f"({rec['honest_edge_score_median']})")
                    if not rec["honest_twin_reached"]:
                        raise AssertionError(f"attack {label}: the twin reached no honest pair")
                    if rec["honest_delivery_of_twin"] < 1.0 - ATTACK_HONEST_TOL:
                        raise AssertionError(
                            f"attack {label} {mode}: honest delivery "
                            f"{rec['honest_delivery_of_twin']} of the twin's reach, below "
                            f"1 - {ATTACK_HONEST_TOL}")
                out.setdefault(label, []).append(rec)
            leaves_equal(leaves[0], leaves[1], f"attack {label} window against eager")
            del leaves
    return out


def attack_eclipse(sweep, driver, dev, card, counters) -> dict:
    """Phase 40's eclipse at N=100k on the bench lattice: the targets'
    mesh edges to sybils and to honest peers after every dispatch, in both
    engines eagerly, with the scores the targets hold of their sybil
    edges in and out of the mesh and of their honest mesh edges; the
    takeover (the peak sybil share of the targets' mesh edges after the
    onset, which must rise above the share before it: the sybils are the
    targets' lattice neighbours, honest until then) and the recovery tick (the first tick from the peak on with no sybil and some
    honest mesh edge), as scripts/attack_report.py reads them."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.chaos import AttackScenario

    tp = graph.ring_lattice(N_FULL, d=8)
    adv = AttackScenario(n_peers=N_FULL, **ATTACK_ECLIPSE).build(tp)
    tgt = list(ATTACK_ECLIPSE["targets"])
    nbr = np.clip(tp.nbr, 0, None)
    syb_edge = torch.as_tensor(tp.nbr_ok[tgt] & adv.is_sybil[nbr[tgt]], device=dev)
    hon_edge = torch.as_tensor(tp.nbr_ok[tgt] & ~adv.is_sybil[nbr[tgt]], device=dev)
    po, pt, pv = attack_schedule(adv.is_sybil, ECLIPSE_ROUNDS, seed=1)
    onset = ATTACK_ECLIPSE["onset"]
    out = {}
    for engine in ("per-round", "phase"):
        series, scores = [], []

        def observe(st, tick):
            mesh_t = st.mesh[tgt, 0, :]
            series.append((tick, int((mesh_t & syb_edge).sum()), int((mesh_t & hon_edge).sum())))
            sc = st.scores[tgt]
            scores.append((tick, sc[syb_edge & mesh_t].tolist(), sc[syb_edge & ~mesh_t].tolist(),
                           sc[hon_edge & mesh_t].tolist()))

        st, rec = attack_run(sweep, driver, dev, engine, "eager", po, pt, pv, counters,
                             observe=observe, rounds=ECLIPSE_ROUNDS, adversary=adv)
        del st
        before = [syb / (syb + hon) for t, syb, hon in series if t < onset and syb + hon]
        peak, peak_t = 0.0, onset
        for t, syb, hon in series:
            share = syb / (syb + hon) if t >= onset and syb + hon else 0.0
            if share > peak:
                peak, peak_t = share, t
        recover = next((t for t, syb, hon in series if t >= peak_t and syb == 0 and hon), None)
        spread = lambda v: [min(v), float(np.median(v)), max(v)] if v else None
        last_t, *last = scores[-1]
        kinds = ("sybil_mesh_edges", "sybil_edges_out_of_mesh", "honest_mesh_edges")
        rec.update(peak_sybil_share=peak, peak_tick=peak_t, recover_tick=recover,
                   share_before=before[-1] if before else None, series=series,
                   sybils=int(adv.is_sybil.sum()),
                   target_scores={"tick": last_t, **{k: spread(v) for k, v in zip(kinds, last)}},
                   target_score_series=[(t, *(float(np.median(v)) if v else None for v in vs))
                                        for t, *vs in scores])
        say(f"attack eclipse {engine} N={N_FULL}: targets {tgt}, {rec['sybils']} sybils "
            f"around them, {rec['share_before']} of the targets' mesh edges theirs before "
            f"the onset; takeover peak {peak:.3f} of the targets' mesh edges at tick "
            f"{peak_t}, recovered (no sybil, some honest mesh edge) at tick {recover} (onset "
            f"{onset}); the targets' scores (min, median, max) at tick {last_t} of their "
            f"sybil mesh edges {rec['target_scores'][kinds[0]]}, of their sybil edges out "
            f"of the mesh {rec['target_scores'][kinds[1]]}, of their honest mesh edges "
            f"{rec['target_scores'][kinds[2]]}; "
            f"{rec['rate']:.3f} {'delivery-rounds' if engine == 'phase' else 'rounds'}"
            f"/s eager, launches {rec['launches']}, on {card}")
        if rec["share_before"] is None or not peak > rec["share_before"]:
            raise AssertionError(f"attack eclipse {engine}: takeover peak {peak} does not "
                                 f"rise above the share before the onset "
                                 f"{rec['share_before']}")
        out[engine] = rec
    return out


# ---------------------------------------------------------------------------
# phase 41: the telemetry panel


def telemetry_cost(sweep, driver, dev, card, counters) -> dict:
    """Phase 41: the windowed default phase and per-round step at N=100k
    (events counted) with the panel on and off in turns (off, on, on, off);
    the rate cost, each window block's launches (the panel's row is plain
    ops: equal on and off), and ``reconcile`` on the card's panel, which
    must come back empty. Returns the turns by engine."""
    from go_libp2p_pubsub_tpu_torch.telemetry import TelemetryConfig, metric_index, reconcile

    tel = TelemetryConfig(rows=256, tracked=(0, N_FULL // 2))

    def observe(st):
        bad = reconcile(st.core.telem.panel, st.core.events)
        if bad:
            raise AssertionError(f"telemetry reconcile on the card: {bad}")
        panel = st.core.telem.panel
        rows = int((panel != 0).any(1).sum())
        return {"reconcile": "empty", "rows_written": rows,
                "last_delivery_ratio": float(panel[rows - 1, metric_index("delivery_ratio")]),
                "last_mesh_deg_mean": float(panel[rows - 1, metric_index("mesh_deg_mean")]),
                "last_score_p50": float(panel[rows - 1, metric_index("score_p50")])}

    out = {}
    for engine in ("phase", "per-round"):
        turns = []
        for on in (False, True, True, False):
            kw = dict(telemetry=tel, observe=observe) if on else {}
            t = window_bench(sweep, driver, dev, card, counters, engine, modes=("window",),
                             count_events=True, **kw)[0]
            t["telemetry"] = on
            turns.append(t)
        blocks = {str(t["block_launches"]) for t in turns}
        if len(blocks) != 1:
            raise AssertionError(f"telemetry {engine}: window blocks launch {blocks} on and off")
        off = [t["rate"] for t in turns if not t["telemetry"]]
        on_ = [t["rate"] for t in turns if t["telemetry"]]
        cost = 1.0 - (sum(on_) / len(on_)) / (sum(off) / len(off))
        say(f"telemetry {engine} windowed N={N_FULL}: on {[round(x, 3) for x in on_]} against "
            f"off {[round(x, 3) for x in off]} ({cost:.4f} of the rate), a block launches "
            f"{turns[0]['block_launches']} on and off, reconcile empty on the card, on {card}")
        out[engine] = {"turns": turns, "cost": cost}
    return out


# ---------------------------------------------------------------------------
# phase 42: the invariant oracle

#: the checked full-width windows: engine, rounds a phase, the check cadence
#: in dispatches, dispatches a window (the phase engine one check a two-phase
#: block, the per-round step the reference's default cadence of 8)
ORACLE_FULL = (("phase", PHASE_R, 2, 8), ("per-round", 1, 8, 32))
#: the full-width checks' delivery window W. On the bench lattice a message
#: slot lives 16 rounds (64 slots, 4 publishes a round) and the ring's
#: diameter is N/16 hops, so no slot lives to be due: the clause is
#: evaluated in every check and holds vacuously there; (b) and (c) hold it
#: to due messages on random_connect(8192, 8)
ORACLE_W = 24
ORACLE_QUIET = (0, 1 << 30)
#: the reference oracle smoke's cost budget (its scripts/invariant_report.py
#: DEFAULT_OVERHEAD), printed beside the port's share, not asserted
REFERENCE_OVERHEAD = 0.10
#: the timed turns of (a), after a first call of each window that captures;
#: the share is read off each mode's best rate (a host stall can slow one
#: turn several-fold, run 3)
ORACLE_TURNS = ("off", "on", "on", "off", "off", "on")
#: (b)'s lived-in states on random_connect(N_PARITY, 8): the per-round
#: engines' rounds, publish rounds and W, and the phase engine's (r = 8)
ORACLE_ROUNDS, ORACLE_PUBS, ORACLE_SEEDED_W = 24, (2, 5), 12
ORACLE_PHASE_ROUNDS, ORACLE_PHASE_PUBS, ORACLE_PHASE_W = 40, (8, 11), 24
#: (c)'s partition: the halves cut from tick 16 for 16 rounds; grace and the
#: recovery deadline 44 rounds after the heal (the reference partition
#: cell's PARTITION_GRACE_AFTER_HEAL); phases of r = 8 past the deadline,
#: one check a phase
ORACLE_CUT = dict(start=16, rounds=16)
ORACLE_GRACE_AFTER_HEAL = 44
ORACLE_CUT_PHASES = 10
#: (c)'s churn storm: dispatches (rounds), the check cadence, and the
#: power-law overlay's tail degree and capacity
ORACLE_STORM_ROUNDS, ORACLE_STORM_CE = 16, 2
ORACLE_STORM_DEGREE = (12, 16)
#: (d): tests/test_parity_cdf.py's cell
CDF_N, CDF_DEG, CDF_WARMUP, CDF_PUB_ROUNDS, CDF_PUBS, CDF_DRAIN, CDF_MAX_H = (
    192, 8, 20, 18, 2, 12, 14)


def oracle_full(sweep, driver, dev, card) -> dict:
    """Phase 42 (a): the default config at N=100k in both engines through
    windows with and without the folded checker, in turns (ORACLE_TURNS,
    after a first call of each): every
    property holds at every check; a checked block launches each kernel as
    often as its unchecked twin (whose block spans the same dispatches);
    one capture each; the checked window's final state equals the
    unchecked one's and an eager run's on the card, and ``ys["ok"]`` an
    eager ``InvariantHook`` over that run (but at the first check's
    events-monotone, which the window holds to the entry counters). Prints
    the rates on and off, the port's share (of each mode's best rate)
    beside the reference's budget,
    and the checker's own launches and device ms a check
    (``perf/profile.check_cost``, the ``--window --check-every`` report)."""
    import torch

    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
    from go_libp2p_pubsub_tpu_torch.perf import profile

    out = {}
    due_fn = lambda tick: inv.due_vector(quiet=ORACLE_QUIET)   # noqa: E731
    for engine, r, ce, d in ORACLE_FULL:
        bench = dict(rounds_per_phase=r, count_events=True)
        st0, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, device=dev, **bench)
        if r > 1:
            st0 = driver.form_mesh(step, st0, rounds_per_phase=r)
        spec = sweep.bench_invariants(N_FULL, check_every=ce, due_fn=due_fn,
                                      delivery_window=ORACLE_W, device=dev, **bench)
        due = spec.precompute(d)
        po, pt, pv = sweep.publish_schedule(d * r, N_FULL, 1, None, seed=21)
        xs = tuple(torch.as_tensor(a, device=dev).reshape((d, r, -1) if r > 1 else (d, -1))
                   for a in (po, pt, pv))
        hb = driver.heartbeat_schedule(r, r) if r > 1 else None
        wins = {"off": driver.make_window(step, heartbeat=hb, unroll=ce, donate=False),
                "on": driver.make_window(step, heartbeat=hb, check=spec.check, check_every=ce,
                                         donate=False)}
        ends, oks, secs = {}, [], {"off": [], "on": []}
        for mode in ("off", "on") + ORACLE_TURNS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            end, ys = wins[mode](st0, xs, due if mode == "on" else None)
            torch.cuda.synchronize()
            secs[mode].append(time.perf_counter() - t0)
            ends[mode] = end
            if mode == "on":
                oks.append(ys["ok"])
        # the first call of each window captures; the turns are the rest
        rates = {m: [d * r / s for s in v[1:]] for m, v in secs.items()}
        best = {m: max(v) for m, v in rates.items()}
        if not all(bool(o.all()) and torch.equal(o, oks[0]) for o in oks):
            bad = [(c, spec.names[p]) for c, p in zip(*torch.nonzero(~oks[0]).T.tolist())]
            raise AssertionError(f"oracle {engine} N={N_FULL}: violations {bad[:8]}")
        for w in wins.values():
            if w.captures != 1:
                raise AssertionError(f"oracle {engine}: {w.captures} captures, expected 1")
        if wins["on"].block_launches != wins["off"].block_launches or not any(
                wins["on"].block_launches.values()):
            raise AssertionError(f"oracle {engine}: checked block launches "
                                 f"{wins['on'].block_launches}, unchecked "
                                 f"{wins['off'].block_launches}")
        hook = inv.InvariantHook(spec.engine, *sweep.bench_parts(N_FULL, device=dev,
                                                                 **bench)[:2],
                                 inv.InvariantConfig(delivery_window=ORACLE_W, check_every=ce),
                                 batched=False, due_fn=due_fn, rounds_per_step=r)
        hook.precompute(d)
        eager = st0
        for i in range(d):
            eager = step(eager, *(a[i] for a in xs), **({"do_heartbeat": True} if r > 1 else {}))
            hook.on_step(i, eager)
        for name, a, b in zip(("unchecked", "eager"), (ends["off"], eager),
                              (ends["on"], ends["on"])):
            if not all(torch.equal(x, y) for x, y in zip(driver._leaves(a), driver._leaves(b))):
                raise AssertionError(f"oracle {engine}: the checked window's final state "
                                     f"differs from the {name} run's")
        got = torch.from_numpy(hook.report().ok[:, 0])
        mono = spec.names.index("events-monotone")
        got[0, mono] = oks[0][0, mono].cpu()
        if not torch.equal(got, oks[0].cpu()):
            raise AssertionError(f"oracle {engine}: the eager hook's verdicts differ")
        cost = profile.check_cost(spec.check, ends["on"], ends["on"].core.events, due[0])
        on, off = best["on"], best["off"]
        out[engine] = {
            "r": r, "check_every": ce, "dispatches": d, "checks": int(due.shape[0]),
            "properties": len(spec.names), "rates_on": rates["on"], "rates_off": rates["off"],
            "share": (off - on) / off, "block_dispatches": wins["on"].block_dispatches,
            "block_launches": dict(wins["on"].block_launches),
            "capture_seconds": wins["on"].capture_seconds, **cost}
        say(f"oracle (a) {engine} N={N_FULL} r={r}: {len(spec.names)} properties hold at all "
            f"{due.shape[0]} checks (every {ce} dispatches, W={ORACLE_W}); checked block of "
            f"{wins['on'].block_dispatches} dispatches launches {wins['on'].block_launches}, "
            f"as the unchecked one; one capture each; final state equal to the unchecked and "
            f"the eager run's, verdicts equal to the eager hook's; delivery-rounds/s on "
            f"{[round(x, 3) for x in rates['on']]} off {[round(x, 3) for x in rates['off']]} "
            f"(share of the best rates {out[engine]['share']:.4f}, the reference's budget "
            f"{REFERENCE_OVERHEAD}); "
            f"the checker: {cost['launches_per_check']:.1f} launches a check, device kernels "
            f"{cost['device_kernel_ms_per_check']:.4f} ms a check, "
            f"{cost['graph_ms_per_check']:.4f} ms replayed from a graph; on {card}")
    return out


def oracle_builds(n: int, device, dynamic: bool = False):
    """(b)'s and (c)'s GossipSub build on random_connect(n, 8, seed=0): the
    bench's parameters and default score plane, events counted; with
    ``dynamic`` the mutable overlay on the power-law net of
    ORACLE_STORM_DEGREE instead. Returns (net, cfg, score params,
    topology)."""
    import dataclasses

    from go_libp2p_pubsub_tpu_torch import graph, topo
    from go_libp2p_pubsub_tpu_torch.config import GossipSubParams
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubConfig
    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from go_libp2p_pubsub_tpu_torch.state import Net

    if dynamic:
        tail, cap = ORACLE_STORM_DEGREE
        tp = topo.to_topology(topo.powerlaw(n, max_degree=tail, seed=0), max_degree=cap)
    else:
        tp = graph.random_connect(n, 8, seed=0)
    net = Net.build(tp, graph.subscribe_all(n, 1), device=device, dynamic=dynamic)
    _tp, sp = sweep.bench_score_params("default", 1)
    params = dataclasses.replace(GossipSubParams(), flood_publish=False)
    cfg = GossipSubConfig.build(params, sweep.bench_thresholds(), score_enabled=True)
    cfg = dataclasses.replace(cfg, count_events=True, fanout_slots=0)
    return net, cfg, sp, tp


def oracle_lived(engine: str, n: int, device):
    """(b)'s lived-in state of ``engine`` on the card: (state, net, cfg,
    W, quiet due row)."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch.models.floodsub import floodsub_step
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState, make_gossipsub_step
    from go_libp2p_pubsub_tpu_torch.models.gossipsub_phase import make_gossipsub_phase_step
    from go_libp2p_pubsub_tpu_torch.models.randomsub import make_randomsub_step
    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
    from go_libp2p_pubsub_tpu_torch.state import SimState

    net, cfg, sp, _tp = oracle_builds(n, device)
    phase = engine == "phase"
    rounds, pubs, w = ((ORACLE_PHASE_ROUNDS, ORACLE_PHASE_PUBS, ORACLE_PHASE_W) if phase
                       else (ORACLE_ROUNDS, ORACLE_PUBS, ORACLE_SEEDED_W))
    rng = np.random.default_rng(0)
    po = np.full((rounds, 4), -1, np.int32)
    po[pubs[0]:pubs[1]] = rng.integers(0, n, size=(pubs[1] - pubs[0], 4))
    po = torch.as_tensor(po, device=device)
    pt = torch.zeros((rounds, 4), dtype=torch.int32, device=device)
    pv = torch.ones((rounds, 4), dtype=torch.bool, device=device)
    if engine in ("gossipsub", "phase"):
        st = GossipSubState.init(net, M_SLOTS, cfg, score_params=sp, seed=0)
    else:
        st = SimState.init(n, M_SLOTS, seed=0, k=net.max_degree, device=device)
        cfg = None
    if phase:
        step = make_gossipsub_phase_step(cfg, net, PHASE_R, score_params=sp)
        for p in range(rounds // PHASE_R):
            sl = slice(p * PHASE_R, (p + 1) * PHASE_R)
            st = step(st, po[sl], pt[sl], pv[sl], do_heartbeat=True)
    else:
        step = {"gossipsub": lambda: make_gossipsub_step(cfg, net, score_params=sp),
                "randomsub": lambda: make_randomsub_step(net),
                "floodsub": lambda: (lambda s, a, b, c: floodsub_step(net, s, a, b, c))}[engine]()
        for t in range(rounds):
            st = step(st, po[t], pt[t], pv[t])
    return st, net, cfg, w, inv.due_vector(quiet=(0, rounds))


def oracle_verdicts(engine, leaves, sides, w, over=None, **kw) -> dict:
    """The checker on the state of ``leaves`` on each side of ``sides``
    ({"card": (device, net, cfg), "cpu": ...}; ``over`` net field
    overrides): equal verdicts, returned by name."""
    import torch
    from torch_parity import oracle_net, oracle_state

    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv

    got = {side: inv.check_state(engine, oracle_net(net, **(over or {})),
                                 oracle_state(leaves, dev), cfg,
                                 inv.InvariantConfig(delivery_window=w), **kw).cpu()
           for side, (dev, net, cfg) in sides.items()}
    if not torch.equal(got["card"], got["cpu"]):
        raise AssertionError(f"oracle {engine}: card verdicts {got['card'].tolist()} != CPU "
                             f"{got['cpu'].tolist()}")
    return dict(zip(inv.invariant_names(engine), got["cpu"].tolist()))


def failed_of(res: dict) -> set:
    return {k for k, v in res.items() if not v}


def oracle_seeded(convert, dev) -> dict:
    """Phase 42 (b): lived-in states of all four engines at N=8192 on the
    card (the per-round step, the phase engine at r = 8, FloodSub,
    RandomSub on random_connect(8192, 8)) pass every property under their
    quiet due row; every seeded violation of tests/test_invariants.py
    (``torch_parity.seeded_violation``) of every property on every engine
    it applies to, and a padding bit at M = 48, trips exactly its property,
    with the card's verdict vector equal to the CPU's. (The overlay's
    ``edge-involution-wf`` is seeded in (c).)"""
    import types

    from torch_parity import SEEDED, corrupt_word_padding, seeded_violation

    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState
    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
    from go_libp2p_pubsub_tpu_torch.state import SimState

    t0 = time.perf_counter()
    n, lived, cases = N_PARITY, {}, 0
    cpu_net, cpu_cfg, _sp, _tp = oracle_builds(n, "cpu")
    for engine in ("gossipsub", "phase", "floodsub", "randomsub"):
        st, net, cfg, w, quiet = oracle_lived(engine, n, dev)
        sides = {"card": (dev, net, cfg), "cpu": ("cpu", cpu_net, cfg and cpu_cfg)}
        leaves = convert.state_leaves(st)
        bad = failed_of(oracle_verdicts(engine, leaves, sides, w, due=quiet))
        if bad:
            raise AssertionError(f"oracle (b) {engine}: the clean state fails {sorted(bad)}")
        lived[engine] = (leaves, sides, w, quiet)
    ctx = types.SimpleNamespace(nbr=cpu_net.nbr.numpy(), protocol=cpu_net.protocol.numpy(),
                                dlo=cpu_cfg.Dlo)
    for name, engine in SEEDED:
        leaves, sides, w, quiet = lived[engine]
        ctx.quiet = quiet
        bad, over, kw = seeded_violation(name, ctx, leaves)
        failed = failed_of(oracle_verdicts(engine, bad, sides, w, over, **kw))
        if failed != {name}:
            raise AssertionError(f"oracle (b) {name} on {engine}: tripped {sorted(failed)}")
        cases += 1
    grace = inv.due_vector(grace=True)
    for engine, (_l, sides, w, _q) in lived.items():
        if engine in ("gossipsub", "phase"):
            fresh = GossipSubState.init(cpu_net, 48, cpu_cfg, seed=0)
        else:
            fresh = SimState.init(n, 48, seed=0, k=cpu_net.max_degree, device="cpu")
        leaves = convert.state_leaves(fresh)
        clean = failed_of(oracle_verdicts(engine, leaves, sides, w, due=grace))
        failed = failed_of(oracle_verdicts(engine, corrupt_word_padding(leaves), sides, w,
                                           due=grace))
        if clean or failed != {"word-padding-wf"}:
            raise AssertionError(f"oracle (b) word-padding-wf on {engine}: clean {clean}, "
                                 f"seeded {sorted(failed)}")
        cases += 1
    secs = time.perf_counter() - t0
    say(f"oracle (b) N={n}: clean lived-in states of all four engines pass every property; "
        f"{cases} seeded violations (property x engine) each trip exactly their property, "
        f"the card's verdicts equal to the CPU's ({secs:.1f} s)")
    return {"cases": cases, "seconds": secs}


def moved(driver, tree, device):
    """A copy of a tree of tensors (a state, a net) on ``device``."""
    return driver._rebuild(tree, iter([t.to(device) for t in driver._leaves(tree)]))


def recheck_on_cpu(driver, spec, obs, ok, entry_events, due, ce: int, where: str) -> None:
    """Hold a window's verdicts to the CPU checker (``spec``, built on the
    CPU) on the same states: the window's per-dispatch states (``obs``,
    observed whole), the counters at its entry and its due rows."""
    import torch

    from go_libp2p_pubsub_tpu_torch.oracle.invariants import sim_state

    prev = entry_events.cpu()
    for c in range(ok.shape[0]):
        st = moved(driver, sim_state(obs, (c + 1) * ce - 1), "cpu")
        got = spec.check(st, prev, due[c].cpu())
        if not torch.equal(got, ok[c].cpu()):
            raise AssertionError(f"{where}: check {c} on the CPU {got.tolist()} differs from "
                                 f"the card's {ok[c].tolist()}")
        prev = st.core.events


def whole(st):
    """An observation of the whole state (a window's per-dispatch states)."""
    return st


def oracle_partition(driver, convert, dev) -> dict:
    """Phase 42 (c), the partition: the halves cut (ORACLE_CUT) of
    random_connect(8192, 8) through a checked phase window (r = 8, a check a
    phase) on the card, under the reference partition cell's due rows:
    quiet before the cut, ``grace`` from the cut to 44 rounds past the
    heal, ``recover`` by then (the messages of the last 4 rounds before the
    heal delivered, the mesh re-formed). The window runs in two calls split
    inside the cut and observes its states, which the CPU's checker
    re-checks (phase 38 holds the engine's partitioned run on the card to
    the CPU's): every check holds, the card's verdicts equal the CPU's.
    Each clause does work: the state inside the cut with one peer's mesh
    stripped trips exactly mesh-degree-bounds with grace cleared and not
    under the cell's row; and the same window with the recovery deadline at
    the heal trips eventual-delivery (the cut's messages have not crossed
    yet)."""
    import numpy as np
    import torch
    from torch_parity import corrupt_degree

    from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig, two_group_partition
    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv

    t0 = time.perf_counter()
    n, r, d = N_PARITY, PHASE_R, ORACLE_CUT_PHASES
    start, heal = ORACLE_CUT["start"], ORACLE_CUT["start"] + ORACLE_CUT["rounds"]
    deadline = heal + ORACLE_GRACE_AFTER_HEAL
    sc = two_group_partition(n, **ORACLE_CUT)
    icfg = inv.InvariantConfig(delivery_window=8, check_every=1)
    st, step, tp, net, cfg = random_gossip_build(n, dev, ChaosConfig(scheduled=True), r,
                                                 CHAOS_CUT_SLOTS)
    cpu_net = moved(driver, net, "cpu")
    sides = {"card": (dev, net, cfg), "cpu": ("cpu", cpu_net, cfg)}
    tick0 = int(st.core.tick)
    ticks = tick0 + r * np.arange(d)
    zeros = np.zeros(tp.nbr.shape, bool)
    deny = np.stack([zeros if sc.link_deny_at(int(t), tp.nbr) is None
                     else sc.link_deny_at(int(t), tp.nbr) for t in ticks])
    po, pt, pv = sweep_schedule(n, d * r, seed=17)
    # one publish a round, none from the round before the heal on (the
    # reference cell's traffic)
    po[:, 1:] = -1
    po[tick0 + np.arange(d * r) >= heal - 1] = -1
    xs = tuple(torch.as_tensor(a, device=dev) for a in (
        po.reshape(d, r, -1), pt.reshape(d, r, -1), pv.reshape(d, r, -1), deny))

    def row(label, deadline=deadline):
        tick = tick0 + label
        return inv.due_vector(quiet=(0, start), recover=(heal - 4, heal - 1, deadline),
                              grace=start <= tick < deadline)

    mid = (start - tick0) // r + 1           # the window's split: a phase into the cut
    out = {}
    for name, due_fn in (("cell", row), ("early", lambda t: row(t, deadline=heal))):
        specs = [inv.ScanInvariants("phase", nt, cfg, icfg, batched=False, due_fn=due_fn,
                                    rounds_per_step=r)
                 for nt in (net, cpu_net)]
        due = specs[0].precompute(d)
        win = driver.make_window(step, heartbeat=[True], check=specs[0].check, check_every=1,
                                 observe=whole, donate=False)
        split = (0, mid, d) if name == "cell" else (0, d)
        end, oks = st, []
        for lo, hi in zip(split, split[1:]):
            entry = end.core.events.clone()
            end, ys = win(end, tuple(a[lo:hi] for a in xs), due[lo:hi])
            recheck_on_cpu(driver, specs[1], ys["obs"], ys["ok"], entry, due[lo:hi], 1,
                           f"oracle (c) partition {name}")
            oks.append(ys["ok"].cpu())
            if hi == mid:
                inside = convert.state_leaves(end)
        out[name] = torch.cat(oks)
    check_ticks = [tick0 + (c + 1) * r for c in range(d)]
    names = inv.invariant_names("phase")
    ok, early = out["cell"], out["early"]
    if not bool(ok.all()) or check_ticks[-1] < deadline:
        bad = [(check_ticks[c], names[p]) for c, p in torch.nonzero(~ok).tolist()]
        raise AssertionError(f"oracle (c) partition: violations {bad}, last check "
                             f"{check_ticks[-1]}, deadline {deadline}")
    delivery = names.index("eventual-delivery")
    late = [check_ticks[c] for c in torch.nonzero(~early[:, delivery]).flatten().tolist()]
    if not late:
        raise AssertionError("oracle (c) partition: a recovery deadline at the heal trips "
                             "nothing")
    grace_row = row(mid * r)
    bare_row = np.array(grace_row)
    bare_row[inv.DUE_GRACE] = 0
    stripped = corrupt_degree(None, inside)[0]
    graced = failed_of(oracle_verdicts("phase", stripped, sides, 8, due=grace_row))
    bare = failed_of(oracle_verdicts("phase", stripped, sides, 8, due=bare_row))
    if not grace_row[inv.DUE_GRACE] or graced or bare != {"mesh-degree-bounds"}:
        raise AssertionError(f"oracle (c) partition, a stripped mesh inside the cut: under "
                             f"the cell's row {sorted(graced)}, grace cleared {sorted(bare)}")
    secs = time.perf_counter() - t0
    say(f"oracle (c) partition N={n} r={r}: cut ticks {start}-{heal - 1}, grace to {deadline}, "
        f"checks at ticks {check_ticks}: every property holds, the card's verdicts equal to "
        f"the CPU checker's on the same states; a mesh stripped at tick "
        f"{check_ticks[mid - 1]} trips mesh-degree-bounds alone with grace cleared, nothing "
        f"under the cell's row; a recovery deadline at the heal trips eventual-delivery at "
        f"ticks {late} ({secs:.1f} s)")
    return {"check_ticks": check_ticks, "early_deadline_trips": late, "seconds": secs}


def sweep_schedule(n: int, rounds: int, seed: int):
    from go_libp2p_pubsub_tpu_torch.perf import sweep

    return sweep.publish_schedule(rounds, n, 1, None, seed=seed)


def oracle_storm(driver, convert, dev) -> dict:
    """Phase 42 (c), the overlay: a churn storm (``topo/dynamics.churn_storm``
    over a power-law net of capacity 16 at N=8192: a fifth of the peers
    killed and replaced, two rewires and a join) through one checked window of
    the dynamic per-round step on the card, with the due rows of
    ``MutationSchedule.due_fn``, its states re-checked by the CPU's checker:
    every check holds, the verdicts equal. The storm's kill row applied to
    the state before it without the step's same-round cleanup trips
    exactly mesh-in-topology under a bare due row and not under a
    mutation-grace row of ``due_fn`` (a check whose window saw one of the
    storm's edge writes); and on the storm's final overlay a
    self-pointing edge_perm slot and a negative epoch each trip exactly
    edge-involution-wf in all four engines (the mesh engines on the state,
    FloodSub and RandomSub on its core)."""
    import torch
    from torch_parity import corrupt_negative_epoch, corrupt_perm_self_point

    from go_libp2p_pubsub_tpu_torch.models.gossipsub import GossipSubState, make_gossipsub_step
    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
    from go_libp2p_pubsub_tpu_torch.topo import dynamics

    t0 = time.perf_counter()
    n, d, ce = N_PARITY, ORACLE_STORM_ROUNDS, ORACLE_STORM_CE
    kill = d // 4                        # churn_storm's default kill dispatch
    net, cfg, sp, tp = oracle_builds(n, dev, dynamic=True)
    cpu_net = moved(driver, net, "cpu")
    sides = {"card": (dev, net, cfg), "cpu": ("cpu", cpu_net, cfg)}
    sched = dynamics.churn_storm(tp, n_dispatches=d, kill_frac=0.2, rewires=2, joins=1,
                                 join_links=2, seed=0)
    writes, up = sched.build()
    st0 = GossipSubState.init(net, M_SLOTS, cfg, score_params=sp, seed=0, dynamic_topo=True)
    step = make_gossipsub_step(cfg, net, score_params=sp, dynamic_peers=True, dynamic_topo=True)
    po, pt, pv = sweep_schedule(n, d, seed=19)
    po[kill:] = -1
    xs = tuple(torch.as_tensor(a, device=dev) for a in (po, pt, pv, up, writes))
    specs = [inv.ScanInvariants("gossipsub", nt, cfg,
                                inv.InvariantConfig(delivery_window=12, check_every=ce),
                                batched=False, due_fn=sched.due_fn(ce))
             for nt in (net, cpu_net)]
    due = specs[0].precompute(d)
    end, ys = driver.make_window(step, check=specs[0].check, check_every=ce, observe=whole)(
        st0, xs, due)
    ok = ys["ok"].cpu()
    recheck_on_cpu(driver, specs[1], ys["obs"], ok, st0.core.events, due, ce,
                   "oracle (c) storm")
    if not bool(ok.all()):
        bad = [((c + 1) * ce, specs[0].names[p]) for c, p in torch.nonzero(~ok).tolist()]
        raise AssertionError(f"oracle (c) storm: violations {bad}")
    from go_libp2p_pubsub_tpu_torch.oracle.invariants import sim_state

    before = convert.state_leaves(sim_state(ys["obs"], kill - 1))
    killed = dict(before, **{".up": up[kill]})
    bare = failed_of(oracle_verdicts("gossipsub", killed, sides, 12))
    # a kill writes no edge (the up row masks them), so due_fn graces the
    # checks around the storm's write dispatches: the first of those rows
    rows = due.cpu().numpy()
    row = rows[int(rows[:, inv.DUE_MUT_GRACE].argmax())]
    graced = failed_of(oracle_verdicts("gossipsub", killed, sides, 12, due=row))
    if bare != {"mesh-in-topology"} or graced or not row[inv.DUE_MUT_GRACE]:
        raise AssertionError(f"oracle (c) storm kill row: bare {sorted(bare)}, under a "
                             f"due_fn row {row.tolist()} {sorted(graced)}")
    final = convert.state_leaves(end)
    involution = 0
    for corrupt in (corrupt_perm_self_point, corrupt_negative_epoch):
        bad = corrupt(final)
        for engine in ("gossipsub", "phase", "floodsub", "randomsub"):
            leaves, eng_sides = bad, sides
            if engine in ("floodsub", "randomsub"):
                leaves = {k[len(".core"):]: v for k, v in bad.items() if k.startswith(".core.")}
                eng_sides = {k: (dv, nt, None) for k, (dv, nt, _c) in sides.items()}
            failed = failed_of(oracle_verdicts(engine, leaves, eng_sides, 12))
            if failed != {"edge-involution-wf"}:
                raise AssertionError(f"oracle (c) {corrupt.__name__} on {engine}: tripped "
                                     f"{sorted(failed)}")
            involution += 1
    graced_checks = int(due[:, inv.DUE_MUT_GRACE].sum())
    secs = time.perf_counter() - t0
    say(f"oracle (c) storm N={n} K={tp.nbr.shape[1]}: {sched.n_kills} kills, {sched.n_joins} "
        f"joins, {sched.n_rewires} rewires over {d} rounds, checks every {ce} with due_fn's "
        f"rows (mutation grace at {graced_checks} of {d // ce}): every property holds, the "
        f"card's verdicts equal to the CPU checker's on the same states; the kill row without "
        f"the cleanup trips mesh-in-topology alone, nothing under a mutation-grace row of "
        f"due_fn; {involution} "
        f"involution corruptions trip edge-involution-wf alone ({secs:.1f} s)")
    return {"kills": sched.n_kills, "involution_cases": involution, "seconds": secs}


def oracle_cdf(dev, card) -> dict:
    """Phase 42 (d): tests/test_parity_cdf.py's cell (N=192,
    random_connect(192, 8, seed=5), 20 warm-up rounds, 18 rounds of 2
    publishes, 12 to drain): the port's GossipSub step on the card against
    the port's OracleGossipSub on the host: the propagation-latency CDF
    within 2% sup-norm, both covering every pair."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.config import GossipSubParams
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
        GossipSubConfig,
        GossipSubState,
        make_gossipsub_step,
    )
    from go_libp2p_pubsub_tpu_torch.oracle.gossipsub import OracleGossipSub
    from go_libp2p_pubsub_tpu_torch.state import Net, hops

    t0 = time.perf_counter()
    n = CDF_N
    tp, subs = graph.random_connect(n, d=CDF_DEG, seed=5), graph.subscribe_all(n, 1)
    cfg = GossipSubConfig.build(GossipSubParams())
    sched = np.random.default_rng(7).integers(0, n, size=(CDF_PUB_ROUNDS, CDF_PUBS))
    net = Net.build(tp, subs, device=dev)
    st = GossipSubState.init(net, M_SLOTS, cfg, seed=3)
    step = make_gossipsub_step(cfg, net)
    none = torch.full((CDF_PUBS,), -1, dtype=torch.int32, device=dev)
    empty = (none, none, torch.zeros((CDF_PUBS,), dtype=torch.bool, device=dev))
    pt = torch.zeros((CDF_PUBS,), dtype=torch.int32, device=dev)
    pv = torch.ones((CDF_PUBS,), dtype=torch.bool, device=dev)
    for _ in range(CDF_WARMUP):
        st = step(st, *empty)
    for r in range(CDF_PUB_ROUNDS):
        st = step(st, torch.as_tensor(sched[r], dtype=torch.int32, device=dev), pt, pv)
    for _ in range(CDF_DRAIN):
        st = step(st, *empty)
    h = hops(st.core.msgs, st.core.dlv).cpu().numpy()
    o = OracleGossipSub(tp, subs, cfg, msg_slots=M_SLOTS, seed=11)
    for _ in range(CDF_WARMUP):
        o.step()
    for r in range(CDF_PUB_ROUNDS):
        o.step([(int(p), 0, True) for p in sched[r]])
    for _ in range(CDF_DRAIN):
        o.step()

    def cdf(hop_counts):
        hist = np.bincount(np.minimum(np.asarray(hop_counts, np.int64), CDF_MAX_H),
                           minlength=CDF_MAX_H + 1)
        return np.cumsum(hist) / (CDF_PUB_ROUNDS * CDF_PUBS * n)

    cv, co = cdf(h[h >= 0]), cdf(list(o.hops().values()))
    sup = float(np.max(np.abs(cv - co)))
    if sup > 0.02 or cv[-1] < 0.999 or co[-1] < 0.999:
        raise AssertionError(f"oracle (d): CDF sup-distance {sup:.4f}, coverage {cv[-1]:.4f} "
                             f"(card) {co[-1]:.4f} (oracle)")
    secs = time.perf_counter() - t0
    say(f"oracle (d) N={n}: the card's propagation-latency CDF within {sup:.4f} sup-norm of "
        f"the port's OracleGossipSub (limit 0.02), coverage {cv[-1]:.4f} and {co[-1]:.4f}, "
        f"mean hops {float(np.mean(h[h >= 0])):.4f} against "
        f"{float(np.mean(list(o.hops().values()))):.4f} ({secs:.1f} s, on {card})")
    return {"sup": sup, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 43: the router plane (routers/: IDONTWANT, lazy choking, the ring)

#: scripts/choke_smoke.py's cells: powerlaw(N, 2.2, d_min=3, max_degree=16)
#: on 8 latency clusters (the ring's depth L = 7: classes of 1, 2 and 8
#: rounds), the v1.1 score config without P3, i.i.d. loss 0.05, mcache
#: history 12 with 8 gossiped, 12 single publishes every 2 rounds from
#: round 3, the choke knobs below, the checker every 8 rounds with W = 48.
#: The checker's due row has no quiet window: under i.i.d. loss no
#: propagation window is fault-quiet (the delivery clause's own scope), and
#: a large net keeps a few protocol-faithful (peer, message) holes for
#: good (the coverage phase 43 prints stays below 1), which the smoke's
#: quiet row, sound at its N=256, would report; coverage is gated instead
#: (>= 0.99, the smoke's floor)
ROUTER_D_MIN, ROUTER_K, ROUTER_CLUSTERS = 3, 16, 8
ROUTER_LOSS = 0.05
ROUTER_KNOBS = dict(choke_ema_alpha=0.4, choke_threshold=0.35, unchoke_threshold=0.1,
                    choke_max_per_hb=2)
ROUTER_MSGS = 12
ROUTER_PARITY_ROUNDS = 24      # card against CPU at N_PARITY (32 before phase 44)
ROUTER_ROUNDS = 64             # full width: both latency cells drain to >= 99% (two halves)
ROUTER_CHECK_EVERY, ROUTER_W = 8, 48
ROUTER_LATTICE_ROUNDS = 32     # the bench lattice's timed window segment
ROUTER_ARMS = ("A", "B", "D", "C")
#: select_topk launches a round with a heartbeat a round: the heartbeat's
#: 8, 3 more with fanout slots (GossipSubConfig.build's 2; the bench's
#: configs have none): the heartbeat's fanout maintenance and gossip, and
#: the publishes' fanout peers (phase 37's 11 a dispatch), and the choke
#: decision's one in a choke arm
FANOUT_SELECTIONS = 3
SELECTIONS_WITH_CHOKE = SELECTIONS_PER_HEARTBEAT + 1


def router_graph(n: int):
    """(topology, delay plane, L) of the router cells' graph at N = n."""
    from go_libp2p_pubsub_tpu_torch import topo

    el = topo.attach_latency_classes(
        topo.powerlaw(n, 2.2, d_min=ROUTER_D_MIN, max_degree=ROUTER_K, seed=0),
        n_clusters=ROUTER_CLUSTERS)
    tp = topo.to_topology(el)
    delay, depth = topo.link_delay_plane(el, tp)
    return tp, delay, depth


def router_config(arm: str, depth: int):
    """The RouterConfig of an arm: A v1.1 (None), B IDONTWANT, D B with the
    ring, C D with choking."""
    from go_libp2p_pubsub_tpu_torch.routers import RouterConfig

    return {"A": None, "B": RouterConfig(idontwant=True),
            "D": RouterConfig(idontwant=True, latency_rounds=depth),
            "C": RouterConfig(idontwant=True, latency_rounds=depth, choke=True,
                              **ROUTER_KNOBS)}[arm]


def router_build(arm: str, graph_parts, device, layout: str = "dense", nets=None):
    """(net, cfg, state, step) of a router cell on ``graph_parts``
    (``router_graph``'s), the choke smoke's config. ``nets`` (a dict) keeps
    each (layout, device)'s Net across builds: a Net is never written."""
    from go_libp2p_pubsub_tpu_torch import graph
    from go_libp2p_pubsub_tpu_torch.chaos import ChaosConfig
    from go_libp2p_pubsub_tpu_torch.config import (
        GossipSubParams,
        PeerScoreParams,
        PeerScoreThresholds,
        TopicScoreParams,
    )
    from go_libp2p_pubsub_tpu_torch.models.gossipsub import (
        GossipSubConfig,
        GossipSubState,
        make_gossipsub_step,
    )
    from go_libp2p_pubsub_tpu_torch.state import Net

    tp, delay, depth = graph_parts
    n = tp.nbr.shape[0]
    rc = router_config(arm, depth)
    sp = PeerScoreParams(topics={0: TopicScoreParams(mesh_message_deliveries_weight=0.0,
                                                     mesh_failure_penalty_weight=0.0)},
                         skip_app_specific=True)
    cfg = GossipSubConfig.build(GossipSubParams(history_length=12, history_gossip=8),
                                PeerScoreThresholds(), score_enabled=True,
                                chaos=ChaosConfig(loss_rate=ROUTER_LOSS), router=rc,
                                edge_layout=layout)
    nets = {} if nets is None else nets
    key = (layout, str(device))
    if key not in nets:
        nets[key] = Net.build(tp, graph.subscribe_all(n, 1), edge_layout=layout,
                              device=device)
    net = nets[key]
    st = GossipSubState.init(net, M_SLOTS, cfg, score_params=sp, seed=0)
    ring = rc is not None and rc.latency_rounds > 0
    step = make_gossipsub_step(cfg, net, score_params=sp, link_delay=delay if ring else None)
    return net, cfg, st, step


def router_schedule(rounds: int, n: int):
    """The choke smoke's publishes: ROUTER_MSGS single publishes every 2
    rounds from round 3 (those inside ``rounds``), origins from
    default_rng(1)."""
    import numpy as np

    rng = np.random.default_rng(1)
    po = np.full((rounds, 4), -1, np.int32)
    pt = np.zeros((rounds, 4), np.int32)
    pv = np.zeros((rounds, 4), bool)
    for i in range(ROUTER_MSGS):
        origin = rng.integers(0, n)
        if 3 + 2 * i < rounds:
            po[3 + 2 * i, 0], pv[3 + 2 * i, 0] = origin, True
    return po, pt, pv


def router_route(arm: str, rounds: int) -> dict:
    """The launches a router run of ``rounds`` rounds (a heartbeat a round)
    must make: neither fused kernel; on the bench lattice (``arm`` "lattice",
    no fanout slots) ``delivery_banded`` once a round and select_topk 8 a
    heartbeat; on the router cells' power-law graph (2 fanout slots) 11;
    one more with choking (C and the lattice)."""
    lattice = arm == "lattice"
    sel = (SELECTIONS_PER_HEARTBEAT + (0 if lattice else FANOUT_SELECTIONS)
           + (1 if arm in ("C", "lattice") else 0))
    return _route(rounds, select_topk=sel, **({"delivery_banded": 1} if lattice else {}))


def router_parity(sweep, driver, convert, checkpoint, dev, counters) -> dict:
    """Phase 43 (a) at N=8192: arms B, D and C and the bench lattice under
    RouterConfig(idontwant, choke) card against CPU on every leaf after
    ROUTER_PARITY_ROUNDS rounds, each with its route from launch counts;
    B, D and C CSR-resident and the lattice through captured windows on the
    card, each equal to its dense eager run (the CSR state densified), each
    block on its route; C's dense window saved between its two calls with
    the ring in flight and resumed from the file, equal to the eager run
    bit for bit. Returns the launches by cell."""
    import torch

    from go_libp2p_pubsub_tpu_torch.routers import RouterConfig
    from go_libp2p_pubsub_tpu_torch.state import densify_edge_planes
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    n, rounds = N_PARITY, ROUTER_PARITY_ROUNDS
    parts = router_graph(n)
    po, pt, pv = router_schedule(rounds, n)
    lpo, lpt, lpv = sweep.publish_schedule(rounds, n, 1, None, seed=13)
    out = {}

    def lattice(d):
        st, step, _t, _h = sweep.build_bench(n, M_SLOTS, count_events=True, device=d,
                                             router=RouterConfig(idontwant=True, choke=True))
        return st, step

    nets = {}
    cells = {arm: (lambda d, a=arm: router_build(a, parts, d, nets=nets)[2:], (po, pt, pv))
             for arm in ("B", "D", "C")}
    cells["lattice"] = (lattice, (lpo, lpt, lpv))

    def run_cell(cell, d):
        build, sched = cells[cell]
        st, step = build(torch.device(d))
        return sweep.run_rounds(st, step, *sched)

    finals = {}
    for cell in cells:
        for mod in counters:
            mod.reset_launch_counts()
        card_end = run_cell(cell, "cuda")
        got = _dispatch_counts(counters)
        want = router_route(cell, rounds)
        if got != want:
            raise AssertionError(f"router {cell}: launches {got}, the route wants {want}")
        leaves = convert.state_leaves(card_end)
        leaves_equal(convert.state_leaves(run_cell(cell, "cpu")), leaves,
                     f"router {cell} after {rounds} rounds")
        ev = leaves[".core.events"]
        if ev[EV.IDONTWANT_SENT] <= 0 or ev[EV.DUP_SUPPRESSED] <= 0:
            raise AssertionError(f"router {cell}: IDONTWANT moved nothing")
        if cell in ("C", "lattice") and ev[EV.CHOKE] <= 0:
            raise AssertionError(f"router {cell}: no link choked")
        finals[cell] = leaves
        out[cell] = got
        say(f"router {cell} card == CPU: every leaf after {rounds} rounds at N={n}, "
            f"IDONTWANT_SENT {int(ev[EV.IDONTWANT_SENT])} DUP_SUPPRESSED "
            f"{int(ev[EV.DUP_SUPPRESSED])} CHOKE {int(ev[EV.CHOKE])} UNCHOKE "
            f"{int(ev[EV.UNCHOKE])}, launches {got}")

    # the CSR-resident arms through captured windows (two calls, one
    # capture), densified, equal to the dense arms' eager runs; the dense
    # lattice's window likewise; C's dense window saved between its two
    # calls with the ring in flight and resumed from the file
    half = rounds // 2
    runs = [(arm, "csr") for arm in ("B", "D", "C")] + [("lattice", "dense"), ("C", "dense")]
    for cell, layout in runs:
        if cell == "lattice":
            net = None
            st, step = cells[cell][0](dev)
            sched = cells[cell][1]
        else:
            net, _cfg, st, step = router_build(cell, parts, dev, layout, nets)
            sched = (po, pt, pv)
        scan = driver.make_scan(step, static_heartbeat=False, unroll=4)
        st = scan(st, *(a[:half] for a in sched))
        note = ""
        if cell == "C" and layout == "dense":
            if not bool(st.inflight.any()):
                raise AssertionError("router checkpoint: the ring is empty at the save")
            words = int(st.inflight.count_nonzero())
            path = fresh_path("ckpt-router-C.npz")
            checkpoint.save(path, st)
            back = checkpoint.restore(path, router_build("C", parts, dev, nets=nets)[2])
            leaves_equal(convert.state_leaves(st), convert.state_leaves(back),
                         "router restored")
            st = back
            note = (f"; saved between the calls with {words} ring words in flight, "
                    f"restored equal and resumed from the file")
        st = scan(st, *(a[half:] for a in sched))
        torch.cuda.synchronize()
        win = scan.window
        if win.captures != 1 or win.replays < 2:
            raise AssertionError(f"router {cell} {layout} window: {win.captures} captures")
        block = {k: v for k, v in win.block_launches.items() if v}
        want = {k: v for k, v in router_route(cell, win.block_dispatches).items() if v}
        if block != want:
            raise AssertionError(f"router {cell} {layout} window block launches {block}, "
                                 f"the route wants {want}")
        if layout == "csr" and cell != "B" and st.inflight.dim() != 3:
            raise AssertionError(f"router {cell} CSR: the ring is not flat")
        got = st if net is None or layout == "dense" else densify_edge_planes(net, st)
        leaves_equal(finals[cell], convert.state_leaves(got),
                     f"router {cell} {layout} window against the dense eager run")
        out[f"{cell} {layout} window block"] = block
        say(f"router {cell} {layout} window N={n}: equal to the dense eager run leaf for leaf "
            f"after {rounds} rounds in two calls, one capture; a block of "
            f"{win.block_dispatches} dispatches launches {block}{note}")
        del st, step, scan, win
    return out


def router_readings(st, n: int) -> dict:
    """A full-width router run's readings: the counters, the coverage of the
    published (peer, message) plane and the first_round stamps."""
    import numpy as np

    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    ev = st.core.events.cpu().numpy()
    fr = st.core.dlv.first_round.cpu().numpy()
    birth = st.core.msgs.birth.cpu().numpy()
    mask = (fr >= 0) & (birth >= 0)[None, :]
    return {"events": {name: int(ev[getattr(EV, name)]) for name in (
                "DELIVER_MESSAGE", "DUPLICATE_MESSAGE", "SEND_RPC", "IDONTWANT_SENT",
                "DUP_SUPPRESSED", "CHOKE", "UNCHOKE", "LINK_DOWN")},
            "coverage": float(mask.sum()) / (ROUTER_MSGS * n),
            "lat": fr - birth[None, :], "mask": mask, "fr": fr,
            "have": st.core.dlv.have.cpu().numpy()}


def router_full(sweep, driver, dev, card, counters) -> dict:
    """Phase 43 (b): the choke smoke's four cells at N=100k, one sim each,
    and C's CSR arm, eager over the run's first half (its second quarter
    timed) and windowed over the whole run in two calls (the first equal
    to the eager half on every leaf, the second timed). B against A:
    first_round, have and DELIVER_MESSAGE identical, fewer duplicates, the
    RPC drop equal to the duplicate drop. C: the checker folded into its
    window every 8 rounds, every property at every check, CHOKE > 0, its
    CSR arm's counters equal to the dense arm's. Returns the cells."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
    from go_libp2p_pubsub_tpu_torch.state import densify_edge_planes

    n, rounds = N_FULL, ROUTER_ROUNDS
    parts = router_graph(n)
    half = rounds // 2
    po, pt, pv = router_schedule(rounds, n)
    xs = tuple(torch.as_tensor(a, device=dev) for a in (po, pt, pv))
    out, reads, nets = {}, {}, {}
    quarter = half // 2
    for cell in ROUTER_ARMS + ("C csr",):
        arm, layout = cell[0], "csr" if cell.endswith("csr") else "dense"
        rec = {"cell": cell}
        # eager: the first half of the run, its second quarter timed
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        net, cfg, st, step = router_build(arm, parts, dev, layout, nets)
        for mod in counters:
            mod.reset_launch_counts()
        st = sweep.run_rounds(st, step, po[:quarter], pt[:quarter], pv[:quarter])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = sweep.run_rounds(st, step, po[quarter:half], pt[quarter:half], pv[quarter:half])
        torch.cuda.synchronize()
        rec["eager_rate"] = (half - quarter) / (time.perf_counter() - t0)
        rec["eager_peak"] = torch.cuda.max_memory_allocated()
        got = _dispatch_counts(counters)
        if got != router_route(arm, half):
            raise AssertionError(f"router {cell} N={n}: launches {got}")
        rec["launches_per_round"] = {k: v / half for k, v in got.items() if v}
        eager_half = [t.clone() for t in driver._leaves(st)]
        del st
        # windowed: the whole run in two calls, the first equal to the eager
        # half, the second timed; C's with the checker folded in
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _net, _cfg, st, step = router_build(arm, parts, dev, layout, nets)
        check = due = None
        if arm == "C":
            spec = inv.ScanInvariants(
                "gossipsub", net, cfg,
                inv.InvariantConfig(check_every=ROUTER_CHECK_EVERY, delivery_window=ROUTER_W),
                batched=False, due_fn=lambda tick: inv.due_vector())
            due = spec.precompute(rounds)
            check = spec.check
        # a block of 8 dispatches either way (a checked unit spans the
        # check cadence)
        win = driver.make_window(step, check=check, unroll=1 if check else ROUTER_CHECK_EVERY,
                                 check_every=ROUTER_CHECK_EVERY if check else 1)
        oks = []
        for i, sl in enumerate((slice(0, half), slice(half, rounds))):
            dl = None if due is None else due[i * (len(due) // 2):(i + 1) * (len(due) // 2)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, ys = win(st, tuple(x[sl] for x in xs), dl)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if check is not None:
                oks.append(ys["ok"])
            if i == 0 and not all(torch.equal(x, y) for x, y in
                                  zip(eager_half, driver._leaves(st))):
                raise AssertionError(f"router {cell} N={n}: the window's state after "
                                     f"{half} rounds differs from the eager run's")
        rec.update(window_rate=half / dt, window_peak=torch.cuda.max_memory_allocated())
        if win.captures != 1:
            raise AssertionError(f"router {cell} window: {win.captures} captures")
        block = {k: v for k, v in win.block_launches.items() if v}
        want = {k: v for k, v in router_route(arm, win.block_dispatches).items() if v}
        if block != want:
            raise AssertionError(f"router {cell} window block launches {block}, the route "
                                 f"wants {want}")
        rec.update(block_launches=block, block_dispatches=win.block_dispatches,
                   capture_seconds=win.capture_seconds)
        if check is not None:
            ok = torch.cat(oks)
            if not bool(ok.all()):
                bad = [(c, spec.names[p]) for c, p in zip(*torch.nonzero(~ok).T.tolist())]
                raise AssertionError(f"router C N={n}: violations {bad[:8]}")
            for name in ("choke-wf", "no-choke-below-dlo"):
                if name not in spec.names:
                    raise AssertionError(f"router C: {name} not checked")
            rec.update(checks=int(ok.shape[0]), properties=len(spec.names))
        reads[cell] = router_readings(densify_edge_planes(net, st) if layout == "csr" else st,
                                      n)
        rec.update(events=reads[cell]["events"], coverage=reads[cell]["coverage"])
        out[cell] = rec
        say(f"router {cell} N={n} (ring depth {parts[2]}): eager {rec['eager_rate']:.3f} "
            f"rounds/s over rounds {quarter}-{half}, windowed {rec['window_rate']:.3f} over "
            f"{half}-{rounds} (peak {rec['eager_peak']} / {rec['window_peak']} bytes), the "
            f"window equal to the eager run at round {half}, coverage {rec['coverage']:.6f} "
            f"after {rounds} rounds, counters {rec['events']}, launches a round "
            f"{rec['launches_per_round']}, a window block of {rec['block_dispatches']} "
            f"dispatches {rec['block_launches']}"
            + (f", {rec['checks']} checks of {rec['properties']} properties all held"
               if "checks" in rec else "") + f", on {card}")
        del st, step, win, eager_half

    a, b, c, d = (reads[k] for k in ("A", "B", "C", "D"))
    ea, eb = a["events"], b["events"]
    if not (np.array_equal(a["fr"], b["fr"]) and np.array_equal(a["have"], b["have"])
            and ea["DELIVER_MESSAGE"] == eb["DELIVER_MESSAGE"]):
        raise AssertionError("router B: the delivery plane moved against A")
    if not eb["DUPLICATE_MESSAGE"] < ea["DUPLICATE_MESSAGE"]:
        raise AssertionError("router B: no duplicate cut")
    if ea["SEND_RPC"] - eb["SEND_RPC"] != ea["DUPLICATE_MESSAGE"] - eb["DUPLICATE_MESSAGE"]:
        raise AssertionError("router B: the RPC drop is not the duplicate drop")
    if out["C"]["events"]["CHOKE"] <= 0:
        raise AssertionError("router C: no link choked")
    if out["C csr"]["events"] != out["C"]["events"]:
        raise AssertionError("router C CSR: counters differ from the dense arm's")
    for cell in ("C", "D"):
        if out[cell]["coverage"] < 0.99:
            raise AssertionError(f"router {cell}: coverage {out[cell]['coverage']} < 0.99 "
                                 f"after {rounds} rounds")
    common = c["mask"] & d["mask"]
    p95 = {k: float(np.percentile(v["lat"][common], 95)) for k, v in (("C", c), ("D", d))}
    summary = {
        "rounds": rounds, "ring_depth": parts[2],
        "dup_cut": 1.0 - eb["DUPLICATE_MESSAGE"] / max(ea["DUPLICATE_MESSAGE"], 1),
        "p95_latency_paired": p95, "common_support": float(common.sum()) / (ROUTER_MSGS * n),
        "rate_vs_A": {k: {m: out[k][f"{m}_rate"] / out["A"][f"{m}_rate"]
                          for m in ("eager", "window")} for k in out}}
    say(f"router (b) N={n}: B's delivery plane equals A's (first_round, have, "
        f"DELIVER_MESSAGE {eb['DELIVER_MESSAGE']}), duplicates {ea['DUPLICATE_MESSAGE']} -> "
        f"{eb['DUPLICATE_MESSAGE']} (cut {summary['dup_cut']:.4f}), the RPC drop equals the "
        f"duplicate drop; C choked {out['C']['events']['CHOKE']} links, its CSR arm's counters "
        f"equal; paired-support p95 latency C {p95['C']} against D {p95['D']} rounds "
        f"(support {summary['common_support']:.6f}); rates against A {summary['rate_vs_A']}; "
        f"on {card}")
    out["summary"] = summary
    return out


def router_lattice(sweep, driver, dev, card, counters) -> dict:
    """Phase 43 (c): the bench default config at N=100k on the lattice under
    RouterConfig(idontwant, choke) against router=None, windowed, in turns
    (off, on, on, off): the router block launches delivery_banded once a
    round and select_topk 9 a heartbeat, neither fused kernel; the v1.1
    block its fused route. Returns the turns and the rate cost."""
    from go_libp2p_pubsub_tpu_torch.routers import RouterConfig

    turns = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        router = RouterConfig(idontwant=True, choke=True) if label == "on" else None
        rec = window_bench(sweep, driver, dev, card, counters, "per-round", modes=("window",),
                           measured=ROUTER_LATTICE_ROUNDS, count_events=True,
                           router=router)[0]
        d = rec["block_dispatches"]
        want = (router_route("lattice", d) if router is not None
                else _route(d, edge_exchange=1, fused_delivery=1,
                            select_topk=SELECTIONS_PER_HEARTBEAT))
        want = {k: v for k, v in want.items() if v}
        if rec["block_launches"] != want:
            raise AssertionError(f"router lattice {label}: block launches "
                                 f"{rec['block_launches']}, the route wants {want}")
        turns[label].append(rec)
    on = max(t["rate"] for t in turns["on"])
    off = max(t["rate"] for t in turns["off"])
    say(f"router lattice N={N_FULL}: windowed rounds/s on {[t['rate'] for t in turns['on']]} "
        f"off {[t['rate'] for t in turns['off']]}, cost of the best {(off - on) / off:.4f}; "
        f"blocks on the router route (delivery_banded 1 a round, select_topk "
        f"{SELECTIONS_WITH_CHOKE} a heartbeat, no fused kernel); on {card}")
    return {"turns": turns, "cost": (off - on) / off}


# ---------------------------------------------------------------------------
# phase 44: the ensemble plane (ensemble/: S sims a dispatch, a sim axis in
# every kernel)

ENSEMBLE_SIMS = 3              # (a): card parity, sims a build
ENSEMBLE_ROUNDS = 16           # (a): rounds a build (2 phases of the phase engine)
ENSEMBLE_FULL_SIMS = 8         # (b): the full-width ensemble
ENSEMBLE_FULL_PHASES = (2, 8)  # (b): formation phases, timed phases
CHOKE_N, CHOKE_SIMS, CHOKE_ROUNDS = 256, 4, 84   # scripts/choke_smoke.py:62-77
CHOKE_CHECK_EVERY = 12         # (c): the checker's cadence in the choked cell's window
ENSEMBLE_LATENCY_SIMS = 4      # (c): phase 43's latency cells at full width
#: positions of a kernel call's arguments that every sim of the main path
#: shares (the CSR topology: col, row, eperm, seg_start, row_last,
#: row_nonempty, row_ptr); every other tensor is a sim's own
ENSEMBLE_SHARED = {"csr_delivery": {8, 9, 10, 11, 12, 13, 14}}
#: one-sim calls of each kernel at the main path's shapes, kept on the host
#: by the earlier phases for phase 44's batched timings
ENSEMBLE_CALLS: dict = {}


def keep_call(name: str, args, kw=None) -> None:
    """Keep a host copy of one kernel wrapper call (phase 44 replays it
    batched)."""
    import torch

    host = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x   # noqa: E731
    ENSEMBLE_CALLS[name] = ([host(a) for a in args], {k: host(v) for k, v in (kw or {}).items()})


def ensemble_builds(sweep, n: int):
    """(label, build(device) -> (state, step), rounds a dispatch) of phase
    44 (a)'s six builds."""
    return (
        ("floodsub lattice", lambda d: sweep.build_floodsub(n, M_SLOTS, device=d), 1),
        ("floodsub powerlaw csr", lambda d: sweep.build_floodsub(
            n, M_SLOTS, graph="powerlaw", layout="csr", device=d), 1),
        ("randomsub lattice", lambda d: sweep.build_randomsub(n, M_SLOTS, device=d), 1),
        ("per-round lattice", lambda d: sweep.build_bench(
            n, M_SLOTS, count_events=True, device=d)[:2], 1),
        ("per-round csr", lambda d: sweep.build_bench(
            n, M_SLOTS, count_events=True, edge_layout="csr", fused=True, device=d)[:2], 1),
        ("phase r=8", lambda d: sweep.build_bench(
            n, M_SLOTS, count_events=True, rounds_per_phase=PHASE_R, device=d)[:2], PHASE_R),
    )


def ensemble_rows(po, pt, pv, r: int, device, s=None):
    """The dispatches' rows of a schedule: ``[P]`` (``[r, P]`` a phase), each
    tiled to ``[S, ...]`` when ``s`` is given."""
    import torch

    from go_libp2p_pubsub_tpu_torch import ensemble

    d = po.shape[0] // r
    out = []
    for i in range(d):
        row = [torch.as_tensor(a[i * r:(i + 1) * r] if r > 1 else a[i], device=device)
               for a in (po, pt, pv)]
        out.append(tuple(ensemble.tile(x, s) if s else x for x in row))
    return out


def ensemble_drive(st, step, rows, r: int):
    kw = {"do_heartbeat": True} if r > 1 else {}
    for row in rows:
        st = step(st, *row, **kw)
    return st


def ensemble_parity(sweep, driver, convert, dev, counters) -> dict:
    """Phase 44 (a): six builds at N=8192 as S=3 ensembles over 16 rounds:
    the card's batched run equal, sim for sim, to the card's one-sim runs
    under ``with_sim_key`` and to the CPU's batched run; an S-sim dispatch
    launching each kernel as often as a one-sim dispatch; a lifted window
    (one capture) equal to its eager loop. Returns each build's launches."""
    import torch

    from go_libp2p_pubsub_tpu_torch import ensemble

    s, n = ENSEMBLE_SIMS, N_PARITY
    po, pt, pv = sweep.publish_schedule(ENSEMBLE_ROUNDS, n, 1, None, seed=6)
    out = {}
    for label, build, r in ensemble_builds(sweep, n):
        t0 = time.perf_counter()
        st, step = build(dev)
        key = st.core.key if hasattr(st, "core") else st.key
        ens = ensemble.lift_step(step)
        for mod in counters:
            mod.reset_launch_counts()
        batched = ensemble_drive(ensemble.batch_states(st, s), ens,
                                 ensemble_rows(po, pt, pv, r, dev, s), r)
        torch.cuda.synchronize()
        launched = _dispatch_counts(counters)
        leaves = convert.state_leaves(batched)
        for i in range(s):
            for mod in counters:
                mod.reset_launch_counts()
            one = ensemble_drive(ensemble.with_sim_key(st, key, i), step,
                                 ensemble_rows(po, pt, pv, r, dev), r)
            one_launched = _dispatch_counts(counters)
            leaves_equal(convert.state_leaves(one),
                         convert.state_leaves(ensemble.unbatch(batched, i)),
                         f"ensemble {label} sim {i}: card batched against card one-sim")
            if one_launched != launched:
                raise AssertionError(f"ensemble {label}: S={s} launches {launched}, one "
                                     f"sim's {one_launched}")
        if not any(launched.values()):
            raise AssertionError(f"ensemble {label}: no kernel launched")
        cst, cstep = build("cpu")
        cpu = ensemble_drive(ensemble.batch_states(cst, s), ensemble.lift_step(cstep),
                             ensemble_rows(po, pt, pv, r, "cpu", s), r)
        leaves_equal(convert.state_leaves(cpu), leaves,
                     f"ensemble {label}: card batched against CPU batched")
        win = driver.make_window(ens, heartbeat=[True] if r > 1 else None)
        rows = ensemble_rows(po, pt, pv, r, dev, s)
        xs = tuple(torch.stack([row[j] for row in rows]) for j in range(3))
        end, _ = win(ensemble.batch_states(st, s), xs)
        leaves_equal(convert.state_leaves(end), leaves,
                     f"ensemble {label}: lifted window against its eager loop")
        if win.captures != 1:
            raise AssertionError(f"ensemble {label} window: {win.captures} captures")
        out[label] = {"launches": {k: v for k, v in launched.items() if v},
                      "block_launches": {k: v for k, v in win.block_launches.items() if v},
                      "dispatches": ENSEMBLE_ROUNDS // r}
        say(f"ensemble {label} N={n} S={s}: {ENSEMBLE_ROUNDS} rounds, card batched == card "
            f"one-sim (with_sim_key) for every sim == CPU batched, leaf for leaf; launches "
            f"{out[label]['launches']} (each one sim's alone); the lifted window (1 capture, "
            f"a block launching {out[label]['block_launches']}) == its eager loop "
            f"({time.perf_counter() - t0:.1f} s)")
        del st, step, ens, batched, one, cst, cstep, cpu, win, end
    return out


def ensemble_kernel_times(dev, card) -> dict:
    """Phase 44 (b): each kernel's S=8 batched launch on the earlier phases'
    main-path calls (each sim a copy of the call but the shared topology),
    against its one-sim launch, in turns (one, batched, batched, one); the
    batched outputs equal the one-sim outputs sim for sim; the bound is S
    times the one-sim bytes."""
    import torch

    from go_libp2p_pubsub_tpu_torch import ensemble
    from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as cd
    from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db
    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk

    s = ENSEMBLE_FULL_SIMS
    mods = {"edge_exchange": fr, "fused_delivery": fr, "delivery_banded": db,
            "csr_delivery": cd, "select_topk": sk}
    out = {}
    for name, mod in mods.items():
        host_args, host_kw = ENSEMBLE_CALLS[name]
        args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in host_args]
        kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v for k, v in host_kw.items()}
        shared = ENSEMBLE_SHARED.get(name, set())
        fn = getattr(mod, name)
        tensor_pos = [i for i, a in enumerate(args)
                      if isinstance(a, torch.Tensor) and i not in shared]
        bargs = [ensemble.tile(a, s) if i in tensor_pos else a for i, a in enumerate(args)]
        in_dims = tuple(0 if i in tensor_pos else None for i in range(len(args)))
        one = lambda: fn(*args, **kw)   # noqa: E731
        many = lambda: torch.func.vmap(lambda *a: fn(*a, **kw), in_dims=in_dims)(*bargs)  # noqa: E731
        want, got = outputs_of(one()), outputs_of(many())
        torch.cuda.synchronize()
        err = max(max_abs_err(want, [g[z] for g in got]) for z in range(s))
        launch1 = prepared(mod._lib(), f"{name}_sims", one)
        launch_s = prepared(mod._lib(), f"{name}_sims", many)
        t = [batch_ms(launch1), batch_ms(launch_s), batch_ms(launch_s), batch_ms(launch1)]
        one_ms, s_ms = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        one_bytes = nbytes(*kernel_reads(name, args), *want)
        s_bytes = s * one_bytes
        rec = {"s": s, "ms": s_ms, "one_ms": one_ms, "turns_ms": t,
               "ratio_to_s_one": s_ms / (s * one_ms), "bound_ms": 1e3 * s_bytes / HBM_BYTES_PER_S,
               "bound_by": "bytes", "max_abs_err": err,
               "shape": {k: list(v.shape) for k, v in zip(("arg0", "arg1"), args[:2])}}
        rec["bound_share"] = rec["bound_ms"] / s_ms
        out[name] = rec
        say(f"ensemble kernel {name} S={s}: {s_ms:.6f} ms batched against {s} x "
            f"{one_ms:.6f} ms one-sim (ratio {rec['ratio_to_s_one']:.4f}; turns "
            f"{', '.join(f'{x:.6f}' for x in t)}), bound {rec['bound_ms']:.6f} ms "
            f"({s_bytes} bytes; share {rec['bound_share']:.4f}), each sim equal to the "
            f"one-sim launch (max_abs_err {err}), on {card}")
        if name == "select_topk":
            rec["rows"] = select_rows_against_grid(bargs, got[0], launch_s, card)
        del launch1, launch_s, want, got, args, bargs, kw
    return out


def select_rows_against_grid(bargs, got, launch_s, card) -> dict:
    """select_topk at S sims: the wrapper's batched launch (every argument
    batched, so S folded into R: one launch over the S*R rows) against the
    same sims with sim z on grid.y, the route a shared argument takes,
    forced here by sim strides padded past each sim's elements; in turns
    (grid, rows, rows, grid), both outputs equal."""
    import torch

    from go_libp2p_pubsub_tpu_torch.ops import kernels
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk

    s, r, k = got.shape
    pad = 64    # elements: keeps every sim's base 16-byte aligned

    def padded(x, dtype):
        buf = torch.zeros(s, x[0].numel() + pad, dtype=dtype, device=x.device)
        buf[:, :x[0].numel()] = x.reshape(s, -1)
        return buf

    values, mask, k_rows, noise = (padded(b, d) for b, d in zip(
        bargs, (torch.float32, torch.bool, torch.int32, torch.float32)))
    out = torch.zeros(s, r * k + pad, dtype=torch.bool, device=got.device)
    held = (values, mask, k_rows, noise, out)
    strides = kernels.strides_arg([t.shape[1] for t in held])
    lib, stream = sk._lib(), kernels.stream(got.device)

    def grid():
        kernels.raise_on(lib.select_topk_sims(*[kernels.ptr(t) for t in held], r, k, s,
                                              strides, stream), "select_topk")

    grid()
    torch.cuda.synchronize()
    if not torch.equal(out[:, :r * k].view(s, r, k), got):
        raise AssertionError("select_topk: the grid.y launch differs from the S*R rows")
    t = [batch_ms(grid), batch_ms(launch_s), batch_ms(launch_s), batch_ms(grid)]
    rec = {"grid_ms": (t[0] + t[3]) / 2, "rows_ms": (t[1] + t[2]) / 2, "turns_ms": t}
    rec["grid_over_rows"] = rec["grid_ms"] / rec["rows_ms"]
    say(f"ensemble kernel select_topk S={s}: S*R rows in one launch {rec['rows_ms']:.6f} ms "
        f"against sim z on grid.y {rec['grid_ms']:.6f} ms (grid/rows "
        f"{rec['grid_over_rows']:.4f}; turns {', '.join(f'{x:.6f}' for x in t)}), outputs "
        f"equal, on {card}")
    return rec


def ensemble_full(sweep, driver, convert, dev, card, counters) -> dict:
    """Phase 44 (b): the default config at N=100k, phase engine r=8, as an
    S=8 windowed ensemble beside the same 8 sims run one after another
    through the one-sim window: after ``form_mesh``, 2 formation phases
    eager, then 8 phases a window call (the capture made by an untimed
    call on the same rows); aggregate sim-delivery-rounds/s, peak memory,
    the windows' block launches, every sim's final state equal."""
    import torch

    from go_libp2p_pubsub_tpu_torch import ensemble

    s, r = ENSEMBLE_FULL_SIMS, PHASE_R
    f, m = ENSEMBLE_FULL_PHASES
    po, pt, pv = sweep.publish_schedule((f + m) * r, N_FULL, 1, None, seed=8)
    hb = driver.heartbeat_schedule(r, r)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, rounds_per_phase=r, device=dev)
    st = driver.form_mesh(step, st, rounds_per_phase=r)
    key = st.core.key
    rows = [tuple(torch.as_tensor(a[p * r:(p + 1) * r], device=dev) for a in (po, pt, pv))
            for p in range(f + m)]
    tiled = [tuple(ensemble.tile(x, s) for x in row) for row in rows]
    timed = lambda rs: tuple(torch.stack([row[j] for row in rs[f:]]) for j in range(3))  # noqa: E731

    def run(step_, first, rs, state):
        """Formation eager, an untimed window call (the capture), the timed
        call; returns (final state, seconds, window)."""
        state = ensemble_drive(state, step_, rs[:f], r)
        win = driver.make_window(step_, heartbeat=hb, donate=False)
        xs = timed(rs)
        if first is not None:
            win = first
        else:
            win(state, xs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = win(state, xs)
        torch.cuda.synchronize()
        return state, time.perf_counter() - t0, win

    out = {}
    torch.cuda.reset_peak_memory_stats()
    finals, dt1, win1 = [], 0.0, None
    for i in range(s):
        one, dt, win1 = run(step, win1, rows, ensemble.with_sim_key(st, key, i))
        dt1 += dt
        finals.append(convert.state_leaves(one))
    out["one_sim"] = {"seconds": dt1, "sim_rounds_per_s": s * m * r / dt1,
                      "peak": torch.cuda.max_memory_allocated(), "captures": win1.captures,
                      "block_launches": {k: v for k, v in win1.block_launches.items() if v}}
    del win1, one
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bs, dtb, winb = run(ensemble.lift_step(step), None, tiled, ensemble.batch_states(st, s))
    out["batched"] = {"seconds": dtb, "sim_rounds_per_s": s * m * r / dtb,
                      "peak": torch.cuda.max_memory_allocated(), "captures": winb.captures,
                      "block_launches": {k: v for k, v in winb.block_launches.items() if v}}
    if (out["batched"]["captures"], out["one_sim"]["captures"]) != (1, 1) or \
            out["batched"]["block_launches"] != out["one_sim"]["block_launches"]:
        raise AssertionError(f"ensemble full: batched window {out['batched']}, one-sim "
                             f"{out['one_sim']}")
    for i in range(s):
        leaves_equal(finals[i], convert.state_leaves(ensemble.unbatch(bs, i)),
                     f"ensemble full sim {i}: S={s} window against the one-sim window")
    out["speedup"] = dt1 / dtb
    say(f"ensemble full N={N_FULL} r={r} S={s}: {f} + {m} phases; batched window "
        f"{out['batched']['sim_rounds_per_s']:.3f} sim-delivery-rounds/s ({dtb:.3f} s, peak "
        f"{out['batched']['peak']} bytes) against {s} one-sim windows in turn "
        f"{out['one_sim']['sim_rounds_per_s']:.3f} ({dt1:.3f} s, peak "
        f"{out['one_sim']['peak']} bytes): x{out['speedup']:.3f}; block launches "
        f"{out['batched']['block_launches']} both (one capture each); every sim's final "
        f"state equal, on {card}")
    del st, step, winb, bs, finals
    return out


def ensemble_choke(sweep, driver, dev, card, counters) -> dict:
    """Phase 44 (c): the choke smoke at its own shape (N=256, 4 sims, 84
    rounds) as S=4 windowed ensembles of its C (ring + choking, the
    checker folded in) and D (ring) cells, with its per-sim gates:
    coverage >= 0.99, CHOKE > 0 in every sim, the paired p95 of C below
    D's on average (tail_cut > 0); then phase 43's C and D cells at
    N=100k as S=4 ensembles over 64 rounds, their per-sim paired p95
    reported."""
    import numpy as np
    import torch

    from go_libp2p_pubsub_tpu_torch import ensemble
    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv
    from go_libp2p_pubsub_tpu_torch.trace.events import EV

    nets = {}     # one Net a graph, shared by its C and D cells

    def cell(arm, parts, n, rounds, sims, checked):
        net, cfg, st, step = router_build(arm, parts, dev, nets=nets)
        po, pt, pv = router_schedule(rounds, n)
        ens = ensemble.lift_step(step)
        spec = None
        if checked:
            spec = inv.ScanInvariants(
                "gossipsub", net, cfg,
                inv.InvariantConfig(check_every=CHOKE_CHECK_EVERY, delivery_window=48),
                batched=True, due_fn=lambda tick: inv.due_vector(quiet=(0, rounds)))
        margs = lambda i: tuple(ensemble.tile(torch.as_tensor(a[i], device=dev), sims)  # noqa: E731
                                for a in (po, pt, pv))
        for mod in counters:
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        run = ensemble.run_window(ens, ensemble.batch_states(st, sims), margs, rounds,
                                  invariants=spec, unroll=1 if checked else 4)
        core = run.states.core
        fr = core.dlv.first_round.cpu().numpy()
        birth = core.msgs.birth.cpu().numpy()
        rep = run.invariant_report
        if rep is not None and not rep.all_ok:
            raise AssertionError(f"choke {arm} N={n}: violations {rep.violations()[:8]}")
        return {"lat": fr - birth[:, None, :], "mask": (fr >= 0) & (birth[:, None, :] >= 0),
                "events": core.events.cpu().numpy(), "seconds": run.seconds,
                "compiles": run.compiles, "checked": 0 if rep is None else rep.checked}

    def p95(c, common):
        return [float(np.percentile(c["lat"][z][common[z]], 95)) if common[z].any() else -1.0
                for z in range(common.shape[0])]

    out = {}
    t0 = time.perf_counter()
    parts = router_graph(CHOKE_N)
    c = cell("C", parts, CHOKE_N, CHOKE_ROUNDS, CHOKE_SIMS, True)
    d = cell("D", parts, CHOKE_N, CHOKE_ROUNDS, CHOKE_SIMS, False)
    common = c["mask"] & d["mask"]
    p95_c, p95_d = p95(c, common), p95(d, common)
    chokes = [int(x) for x in c["events"][:, EV.CHOKE]]
    tail_cut = 1.0 - float(np.mean(p95_c)) / max(float(np.mean(p95_d)), 1e-9)
    smoke = {"coverage_choke": coverage(c, CHOKE_N), "coverage_nochoke": coverage(d, CHOKE_N),
             "chokes": chokes,
             "p95_choke": p95_c, "p95_nochoke": p95_d, "tail_cut": tail_cut,
             "checked": c["checked"], "captures": [c["compiles"], d["compiles"]]}
    bad = [x for x in smoke["coverage_choke"] + smoke["coverage_nochoke"] if x < 0.99]
    if bad or min(chokes) <= 0 or not tail_cut > 0 or smoke["captures"] != [1, 1]:
        raise AssertionError(f"choke smoke as S={CHOKE_SIMS} ensembles failed its gates: {smoke}")
    out["smoke"] = smoke
    say(f"ensemble choke smoke N={CHOKE_N} S={CHOKE_SIMS} {CHOKE_ROUNDS} rounds (ring depth "
        f"{parts[2]}): coverage C {smoke['coverage_choke']} D {smoke['coverage_nochoke']} "
        f"(>= 0.99), chokes {chokes} (> 0), paired p95 C {p95_c} D {p95_d}, tail_cut "
        f"{tail_cut:.4f} (> 0), {c['checked']} property checks in C's window all held, one "
        f"capture a cell ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    nets.clear()
    parts = router_graph(N_FULL)
    sims = ENSEMBLE_LATENCY_SIMS
    c = cell("C", parts, N_FULL, ROUTER_ROUNDS, sims, False)
    d = cell("D", parts, N_FULL, ROUTER_ROUNDS, sims, False)
    common = c["mask"] & d["mask"]
    full = {"p95_choke": p95(c, common), "p95_nochoke": p95(d, common),
            "coverage_choke": coverage(c, N_FULL), "coverage_nochoke": coverage(d, N_FULL),
            "chokes": [int(x) for x in c["events"][:, EV.CHOKE]],
            "seconds": [c["seconds"], d["seconds"]]}
    full["tail_cut"] = 1.0 - float(np.mean(full["p95_choke"])) / max(
        float(np.mean(full["p95_nochoke"])), 1e-9)
    out["full"] = full
    say(f"ensemble router latency N={N_FULL} S={sims} {ROUTER_ROUNDS} rounds: paired p95 C "
        f"{full['p95_choke']} D {full['p95_nochoke']} (tail_cut {full['tail_cut']:.4f}, "
        f"reported), coverage C {full['coverage_choke']} D {full['coverage_nochoke']}, chokes "
        f"{full['chokes']}, windows {full['seconds'][0]:.3f} s and {full['seconds'][1]:.3f} s, "
        f"on {card} ({time.perf_counter() - t0:.1f} s)")
    return out


def coverage(c, n: int) -> list:
    """Each sim's share of the published (peer, message) pairs delivered."""
    return [float(m.sum()) / (ROUTER_MSGS * n) for m in c["mask"]]


def leaves_equal(a: dict, b: dict, where: str):
    import numpy as np

    assert sorted(a) == sorted(b), where
    for p in a:
        x, y = a[p], b[p]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{where}: leaf {p} dtype/shape differ")
        if x.dtype.kind == "f":
            x, y = x.view(np.uint32), y.view(np.uint32)
        if not np.array_equal(x, y):
            raise AssertionError(f"{where}: leaf {p} differs between card and CPU")


# ---------------------------------------------------------------------------
# phase 45: the supervised service loop

SERVE_ARGS = dict(rounds=32, segment=8, seed=7, loss=0.1, check_every=4)  # the _child cell
SERVE_PHASES, SERVE_SEGMENT = 32, 8   # (b)-(c): phases at full width, a segment's phases
SERVE_FULL_CHECK_EVERY = 2            # (b)-(c): the folded checker's cadence (phase 42's)
#: (b)-(c) leave out backoff-clears: the phase engine clears backoff at a
#: heartbeat whose tick is a multiple of backoff_clear_ticks (15), which at
#: r = 8 is every 120 ticks, so an expired entry outlives the property's
#: bound (expiry + 26 ticks) past tick ~100 in both packages
#: (models/gossipsub.py:903; the JAX package's :1174)
SERVE_FULL_SKIPPED = ("backoff-clears",)
#: the reference's ceiling on the supervision's overhead against a bare
#: segmented window (SERVICE_SMOKE_OVERHEAD, scripts/service_smoke.py)
SERVICE_OVERHEAD_CEILING = 0.10
SERVE_DIR = os.path.join(TRACE_DIR, "serve")
SERVE_TURNS = ("bare", "supervised", "supervised", "bare") * 2   # (b): the median of each


def serve_supervisor(root: str, cell, n_dispatches: int, segment: int, *, check_every: int,
                     rounds_per_dispatch: int = 1, heartbeat_fn=None, faults=None,
                     max_retries: int = 3, checkpoint_every: int = 1, due_fn=None,
                     delivery_window: int = 16, invariants=None):
    """A Supervisor over ``cell`` (``(step, make_args, template_fn, net,
    cfg)``) with the health probes and the invariant checker folded in,
    its store under ``root`` (emptied first)."""
    import shutil

    from go_libp2p_pubsub_tpu_torch import serve
    from go_libp2p_pubsub_tpu_torch.oracle import HealthConfig, InvariantConfig, ScanInvariants

    step, make_args, template_fn, net, cfg = cell
    shutil.rmtree(root, ignore_errors=True)
    if invariants is None:
        invariants = ScanInvariants(
            "phase" if rounds_per_dispatch > 1 else "gossipsub", net, cfg,
            InvariantConfig(check_every=check_every, delivery_window=delivery_window),
            batched=False, due_fn=due_fn, rounds_per_step=rounds_per_dispatch)
    svc = serve.ServiceConfig(n_dispatches=n_dispatches, segment_len=segment,
                              rounds_per_dispatch=rounds_per_dispatch, health=HealthConfig(),
                              checkpoint_every_segments=checkpoint_every,
                              max_retries=max_retries, backoff_base_s=0.001, report_name=None)
    return serve.Supervisor(step, make_args, template_fn, root, svc,
                            heartbeat_fn=heartbeat_fn, invariants=invariants,
                            faults=faults)


def window_eager_dispatches(win) -> int:
    """The dispatches a captured window ran where the wrappers count
    launches: each capture's warm-up block and the blocks it captured (a
    replay counts nothing)."""
    return win.captures * win.block_dispatches + sum(
        n for entry in win._entries.values() for n in entry.graphs)


def serve_parity(dev, counters) -> dict:
    """Phase 45 (a): the ``_child`` cell (GossipSub on random_connect(8192,
    4) under 10% i.i.d. loss, scores and counters, 32 dispatches in
    segments of 8, probes, the checker every 4, a checkpoint every
    segment) supervised on the card and on the CPU: equal digests, one
    capture, select_topk alone launched (the net is unbanded), 11 a
    counted dispatch (the heartbeat's 8 and FANOUT_SELECTIONS). Then the
    ladder on the card: segment 1's dispatch fails past ``max_retries``,
    the segment halves to 4 and the run completes, in the control's digest,
    with one capture per window shape. Returns the control's digest and the
    card run's launches."""
    from go_libp2p_pubsub_tpu_torch import serve
    from go_libp2p_pubsub_tpu_torch.serve import _child

    a = SERVE_ARGS
    digests, out = {}, {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        cell = _child.build_cell(N_PARITY, a["rounds"], a["seed"], a["loss"], device=device)
        sup = serve_supervisor(os.path.join(SERVE_DIR, f"parity-{side}"), cell, a["rounds"],
                               a["segment"], check_every=a["check_every"])
        for m in counters:
            m.reset_launch_counts()
        rep = sup.run(fresh=True)
        if side == "card":
            out["launches"] = _dispatch_counts(counters)
            if rep.window_compiles != {f"L{a['segment']}": 1}:
                raise AssertionError(f"serve (a): captures {rep.window_compiles}, expected one")
            win = sup._runner_for(a["segment"]).window
            counted = window_eager_dispatches(win)
            want = _route(counted, select_topk=SELECTIONS_PER_HEARTBEAT + FANOUT_SELECTIONS)
            if out["launches"] != want:
                raise AssertionError(f"serve (a): launches {out['launches']} over {counted} "
                                     f"counted dispatches, expected {want} (select_topk "
                                     "alone: random_connect is unbanded)")
            out.update(counted_dispatches=counted, block_dispatches=win.block_dispatches,
                       block_launches={k: v for k, v in win.block_launches.items() if v})
        if rep.recoveries or rep.invariant_checks != a["rounds"] // a["check_every"]:
            raise AssertionError(f"serve (a) {side}: {rep.recoveries} recoveries, "
                                 f"{rep.invariant_checks} checks")
        digests[side] = serve.state_digest(rep.states)
        out[f"{side}_seconds"] = time.perf_counter() - t0
        del sup, rep, cell
    if digests["card"] != digests["cpu"]:
        raise AssertionError("serve (a): the card's digest differs from the CPU's")
    cell = _child.build_cell(N_PARITY, a["rounds"], a["seed"], a["loss"], device=dev)
    ladder = serve_supervisor(os.path.join(SERVE_DIR, "ladder"), cell, a["rounds"],
                              a["segment"], check_every=a["check_every"], max_retries=1,
                              faults=serve.FaultPlan(fail_dispatches={1: 2}))
    rep = ladder.run(fresh=True)
    half = a["segment"] // 2
    if (rep.degradations != [f"shrink-segment:{half}"] or rep.retries != 2
            or serve.state_digest(rep.states) != digests["card"]
            or rep.window_compiles != {f"L{a['segment']}": 1, f"L{half}": 1}):
        raise AssertionError(f"serve (a) ladder: {rep.degradations}, {rep.retries} retries, "
                             f"captures {rep.window_compiles}, or its digest differs")
    out.update(digest=digests["card"], ladder={"degradations": rep.degradations,
                                               "retries": rep.retries,
                                               "captures": rep.window_compiles})
    say(f"serve (a) the _child cell at N={N_PARITY}, {a['rounds']} dispatches in segments of "
        f"{a['segment']}, probes and the checker every {a['check_every']}: card digest == CPU "
        f"digest {digests['card'][:16]} (card {out['card_seconds']:.1f} s, CPU "
        f"{out['cpu_seconds']:.1f} s), one capture; launches {out['launches']} over "
        f"{out['counted_dispatches']} counted dispatches (warm-up and capture), a replay "
        f"block of {out['block_dispatches']} launching {out['block_launches']}; the ladder "
        f"on the card (2 failures past max_retries=1): {rep.degradations}, captures "
        f"{rep.window_compiles}, the same digest")
    return out


def serve_full_cell(sweep, driver, dev):
    """(cell, invariants) of the bench default at full width for the
    supervisor: the phase engine r=8 formed (``driver.form_mesh``) once,
    each template a clone of that state, the publish rows of 32 phases on
    the card, the checker every 2 phases on every property but
    ``SERVE_FULL_SKIPPED``."""
    import torch

    from go_libp2p_pubsub_tpu_torch.oracle import invariants as inv

    r = PHASE_R
    bench = dict(rounds_per_phase=r, count_events=True)
    st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, device=dev, **bench)
    st0 = driver.form_mesh(step, st, rounds_per_phase=r)
    po, pt, pv = sweep.publish_schedule(SERVE_PHASES * r, N_FULL, 1, None, seed=23)
    rows = [torch.as_tensor(a, device=dev).reshape(SERVE_PHASES, r, -1) for a in (po, pt, pv)]
    net, cfg = sweep.bench_parts(N_FULL, device=dev, **bench)[:2]
    names = tuple(n for n in inv.invariant_names("phase") if n not in SERVE_FULL_SKIPPED)
    spec = inv.ScanInvariants(
        "phase", net, cfg, inv.InvariantConfig(delivery_window=ORACLE_W,
                                               check_every=SERVE_FULL_CHECK_EVERY,
                                               names=names),
        batched=False, due_fn=lambda tick: inv.due_vector(quiet=ORACLE_QUIET),
        rounds_per_step=r)
    cell = (step, lambda i: tuple(a[i] for a in rows),
            lambda: driver._rebuild(st0, iter([t.clone() for t in driver._leaves(st0)])),
            None, None)
    return cell, spec


def timed_save(store, log: list):
    """``store.save`` that appends each save's seconds and file bytes to
    ``log`` (phase 45's instrumentation)."""
    save = store.save

    def timed(state, tick, meta=None):
        t0 = time.perf_counter()
        entry = save(state, tick, meta)
        log.append({"seconds": time.perf_counter() - t0,
                    "bytes": os.path.getsize(os.path.join(store.root, entry["file"]))})
        return entry

    return timed


def timed_run(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_full(sweep, driver, dev, card) -> dict:
    """Phase 45 (b): the bench default at N=100k (phase engine r=8), 32
    phases in segments of 8, supervised with the probes and the checker
    every 2 phases: its final digest equals a bare segmented WindowRunner's
    with the same checker folded in;
    one capture; a replay block launches, per phase, what the bare window's
    does (edge_exchange 1 + r, select_topk 8). Timed warm in turns (bare,
    supervised, supervised, bare, twice) with one checkpoint at the end:
    the supervision's overhead share from the medians, with and without
    the save's seconds; then the every-segment checkpoint cadence's rate
    and each save's bytes and seconds."""
    import torch

    from go_libp2p_pubsub_tpu_torch import ensemble, serve

    r = PHASE_R
    cell, spec = serve_full_cell(sweep, driver, dev)
    step, make_args, template_fn = cell[:3]
    hb = lambda i: True   # noqa: E731  (a heartbeat every phase, as the bench)
    # the checker folded into the bare window too, as the reference's
    # service_smoke does: the overhead share is the supervision's own
    bare = ensemble.WindowRunner(step, SERVE_PHASES, rounds_per_phase=r, heartbeat_fn=hb,
                                 invariants=spec, segment_len=SERVE_SEGMENT)
    sups = {cadence: serve_supervisor(
        os.path.join(SERVE_DIR, f"full-{cadence}"), cell, SERVE_PHASES, SERVE_SEGMENT,
        check_every=SERVE_FULL_CHECK_EVERY, rounds_per_dispatch=r, heartbeat_fn=hb,
        checkpoint_every=k, invariants=spec)
        for cadence, k in (("end", SERVE_PHASES // SERVE_SEGMENT), ("segment", 1))}
    saves = {cadence: [] for cadence in sups}
    for cadence, sup in sups.items():
        sup.store.save = timed_save(sup.store, saves[cadence])
    runs = {"bare": lambda: bare.run(template_fn(), make_args).states,
            "supervised": lambda: sups["end"].run(fresh=True).states}
    # the first call of each captures; every timed call is warm
    ends = {mode: fn() for mode, fn in runs.items()}
    digest = serve.state_digest(ends["bare"])
    if serve.state_digest(ends["supervised"]) != digest:
        raise AssertionError("serve (b): the supervised run's digest differs from the bare "
                             "window's")
    del ends
    secs = {"bare": [], "supervised": [], "supervised_less_save": []}
    for mode in SERVE_TURNS:
        saves["end"].clear()
        dt = timed_run(runs[mode])[1]
        secs[mode].append(dt)
        if mode == "supervised":
            secs["supervised_less_save"].append(dt - sum(x["seconds"] for x in saves["end"]))
    rates = {m: [SERVE_PHASES * r / s for s in v] for m, v in secs.items()}
    med = {m: statistics.median(v) for m, v in rates.items()}
    share = (med["bare"] - med["supervised"]) / med["bare"]
    share_less_save = (med["bare"] - med["supervised_less_save"]) / med["bare"]
    seg_sup = sups["segment"]
    seg_sup.run(fresh=True)                      # captures
    saves["segment"].clear()
    rep, seg_secs = timed_run(lambda: seg_sup.run(fresh=True))
    saves = saves["segment"]
    if serve.state_digest(rep.states) != digest:
        raise AssertionError("serve (b): the every-segment run's digest differs")
    sup_runner = sups["end"]._runner_for(SERVE_SEGMENT)
    per = lambda w: {k: v / w.block_dispatches for k, v in w.block_launches.items()}  # noqa
    sup_per, bare_per = per(sup_runner.window), per(bare.window)
    want = {k: 0.0 for k in REPLACES}
    want.update(edge_exchange=1.0 + r, select_topk=float(SELECTIONS_PER_HEARTBEAT))
    if sup_per != bare_per or {k: sup_per.get(k, 0.0) for k in REPLACES} != want:
        raise AssertionError(f"serve (b): launches a phase {sup_per}, bare {bare_per}, "
                             f"expected {want}")
    for name, s in sups.items():
        if s.window_compiles() != {f"L{SERVE_SEGMENT}": 1}:
            raise AssertionError(f"serve (b) {name}: captures {s.window_compiles()}")
    out = {
        "n": N_FULL, "r": r, "phases": SERVE_PHASES, "segment": SERVE_SEGMENT,
        "check_every": SERVE_FULL_CHECK_EVERY, "digest": digest, "turns": list(SERVE_TURNS),
        "turn_seconds": secs, "rates": rates, "overhead_share": share,
        "overhead_share_less_save": share_less_save,
        "overhead_ceiling": SERVICE_OVERHEAD_CEILING,
        "every_segment_rate": SERVE_PHASES * r / seg_secs, "saves": saves,
        "block_dispatches": sup_runner.window.block_dispatches,
        "block_launches": dict(sup_runner.window.block_launches),
        "bare_block_launches": dict(bare.window.block_launches),
        "captures": sups["end"].window_compiles(),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    say(f"serve (b) the bench default N={N_FULL} r={r}, {SERVE_PHASES} phases in segments of "
        f"{SERVE_SEGMENT}, probes and the checker every {SERVE_FULL_CHECK_EVERY} phases: "
        f"supervised digest == bare window's {digest[:16]}; one capture; a phase launches "
        f"{want}, as the bare window; delivery-rounds/s bare {rates['bare']} supervised "
        f"{rates['supervised']} (turns {', '.join(SERVE_TURNS)}; one checkpoint at the end; "
        f"medians): "
        f"overhead share {share:.4f}, {share_less_save:.4f} less the save's seconds (the "
        f"reference's ceiling {SERVICE_OVERHEAD_CEILING}); "
        f"a checkpoint every segment: {out['every_segment_rate']:.1f} delivery-rounds/s, "
        f"saves {saves}; on {card}")
    del sups, bare, seg_sup, rep
    torch.cuda.empty_cache()
    return out


def serve_recovery(sweep, driver, dev, full: dict) -> dict:
    """Phase 45 (c): the (b) run with a NaN in ``scores`` after dispatch 3
    of segment 1 and two transient failures of segment 2's dispatch: one
    recovery whose bundle names global dispatch 11 and the ``.scores``
    leaf, two retries, and (b)'s final digest."""
    from go_libp2p_pubsub_tpu_torch import serve

    cell, spec = serve_full_cell(sweep, driver, dev)
    plan = serve.FaultPlan(corrupt_segment=1, corrupt_dispatch=3, corrupt_leaf="scores",
                           fail_dispatches={2: 2})
    sup = serve_supervisor(os.path.join(SERVE_DIR, "recovery"), cell, SERVE_PHASES,
                           SERVE_SEGMENT, check_every=SERVE_FULL_CHECK_EVERY,
                           rounds_per_dispatch=PHASE_R, heartbeat_fn=lambda i: True,
                           faults=plan, invariants=spec)
    rep, secs = timed_run(lambda: sup.run(fresh=True))
    b = rep.bundles[0] if rep.bundles else {}
    got = serve.state_digest(rep.states)
    if (rep.recoveries != 1 or rep.retries != 2 or b.get("first_bad_dispatch") != 11
            or b.get("nan_census") != {".scores": 1} or got != full["digest"]):
        raise AssertionError(f"serve (c): {rep.recoveries} recoveries, {rep.retries} retries, "
                             f"bundle {b}, digest equal {got == full['digest']}")
    out = {"first_bad_dispatch": b["first_bad_dispatch"], "replay_failures":
           b["replay_failures"], "window_probe_failures": b["window_probe_failures"],
           "nan_census": b["nan_census"], "retries": rep.retries, "seconds": secs,
           "captures": rep.window_compiles}
    say(f"serve (c) N={N_FULL}: a NaN in .scores at segment 1 dispatch 3 rolled back and "
        f"localised to global dispatch {b['first_bad_dispatch']} ({b['replay_failures']}); "
        f"two transient failures of segment 2 retried; the final digest equals (b)'s "
        f"({secs:.1f} s, captures {rep.window_compiles})")
    del sup, rep
    return out


def serve_kill(digest: str) -> dict:
    """Phase 45 (d): ``python -m go_libp2p_pubsub_tpu_torch.serve._child
    --device cuda`` at (a)'s arguments, SIGKILLed mid-write of segment 1's
    checkpoint, then run again: it resumes at dispatch 8 and its FINAL.json
    digest equals (a)'s in-process control. Two child processes."""
    import signal
    import shutil

    a = SERVE_ARGS
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(SERVE_DIR, "kill")
    shutil.rmtree(root, ignore_errors=True)
    cmd = [sys.executable, "-m", "go_libp2p_pubsub_tpu_torch.serve._child", "--root", root,
           "--device", "cuda", "--n", str(N_PARITY), "--rounds", str(a["rounds"]),
           "--segment", str(a["segment"]), "--seed", str(a["seed"]), "--loss", str(a["loss"]),
           "--probes", "--invariants", "--check-every", str(a["check_every"])]
    t0 = time.perf_counter()
    killed = subprocess.run(cmd + ["--fresh", "--kill-segment", "1", "--kill-site",
                                   "mid-write"], cwd=here, capture_output=True, text=True,
                            timeout=300)
    if killed.returncode not in (-signal.SIGKILL, 128 + signal.SIGKILL):
        raise AssertionError(f"serve (d): the child exited {killed.returncode}, not killed: "
                             f"{killed.stderr[-800:]}")
    t1 = time.perf_counter()
    resumed = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=300)
    if resumed.returncode != 0:
        raise AssertionError(f"serve (d): the resumed child failed: {resumed.stderr[-800:]}")
    with open(os.path.join(root, "FINAL.json")) as f:
        final = json.load(f)
    if final["digest"] != digest or final["resumed_from"] != a["segment"]:
        raise AssertionError(f"serve (d): resumed from {final['resumed_from']}, digest equal "
                             f"{final['digest'] == digest}")
    out = {"resumed_from": final["resumed_from"], "killed_seconds": t1 - t0,
           "resumed_seconds": time.perf_counter() - t1, "captures": final["window_compiles"]}
    say(f"serve (d) a _child --device cuda killed mid-write of segment 1 "
        f"({out['killed_seconds']:.1f} s) resumed from dispatch {final['resumed_from']} "
        f"({out['resumed_seconds']:.1f} s) to (a)'s digest")
    return out


def main() -> int:
    import torch

    # nothing here takes a gradient: autograd's bookkeeping off makes every
    # eager op's dispatch cheaper, on the CPU and the card
    torch.set_grad_enabled(False)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="a checkout of another commit whose kernels are timed beside "
                         "this tree's on the same prepared arguments")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(root, "tests"))   # torch_parity: the hazard inputs
    from torch_parity import SUBNORMAL_CELLS
    from go_libp2p_pubsub_tpu_torch import convert, graph
    from go_libp2p_pubsub_tpu_torch.ops import csr_delivery as cd
    from go_libp2p_pubsub_tpu_torch.ops import delivery_banded as db
    from go_libp2p_pubsub_tpu_torch.ops import fused_round as fr
    from go_libp2p_pubsub_tpu_torch.ops import kernels
    from go_libp2p_pubsub_tpu_torch.ops import select_topk as sk
    from go_libp2p_pubsub_tpu_torch.perf import sweep
    from go_libp2p_pubsub_tpu_torch.state import Net, densify_edge_planes

    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(phases: str) -> None:
        """Print the seconds since the last lap: the time of ``phases``."""
        now = time.perf_counter()
        say(f"time of phase(s) {phases}: {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    counters = (fr, sk, cd, db)
    # 1. environment
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {name} count {torch.cuda.device_count()}")
    say(card)
    import google.protobuf
    from google.protobuf.internal import api_implementation

    say(f"protobuf {google.protobuf.__version__} ({api_implementation.Type()}), the trace "
        "sinks' runtime")
    import cryptography

    say(f"cryptography {cryptography.__version__}, the API's Ed25519 signing")

    lap("1")
    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = dict(zip(KERNEL_SOURCES, pool.map(kernels.build, KERNEL_SOURCES)))
    for src, built in builds.items():
        kernels.load(src)
        say(f"build: {src}.cu nvcc {built['seconds']:.2f} s -> {kernels.library_path(src)}")
        for line in built["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("  " + line.strip())
    say(f"build phase {time.perf_counter() - t0:.2f} s")
    base = None
    if opts.baseline:
        t0 = time.perf_counter()
        base = build_baseline(opts.baseline)
        say(f"baseline kernels of {opts.baseline} built in {time.perf_counter() - t0:.2f} s")

    lap("2")
    # 3. kernels at the main path's shapes, inputs from a real round
    st, step, n_topics, honest = sweep.build_bench(N_FULL, M_SLOTS, device=dev)
    po, pt, pv = sweep.publish_schedule(FORMATION_ROUNDS + MEASURED_ROUNDS + 1,
                                        N_FULL, n_topics, honest)
    st = sweep.run_rounds(st, step, po[:8], pt[:8], pv[:8])
    sched = [torch.as_tensor(a[8], device=dev) for a in (po, pt, pv)]
    st, captured = capture_round(lambda s: step(s, *sched), st, fr)
    gen = torch.Generator().manual_seed(0)
    records = check_kernels(fr, captured, gen, base)
    del st, captured

    lap("3")
    # 4. the slice at full width
    total = FORMATION_ROUNDS + MEASURED_ROUNDS
    heartbeat_launches = SELECTIONS_PER_HEARTBEAT * total
    # the lattice's CSR build: its nbr_ok for the checks, its flat edge
    # space to densify phase 6's state
    csr_net = Net.build(graph.ring_lattice(N_FULL, d=8), graph.subscribe_all(N_FULL, 1),
                        edge_layout="csr", fused=True, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, step, n_topics, honest = sweep.build_bench(N_FULL, M_SLOTS, device=dev)
    for m in counters:
        m.reset_launch_counts()
    st = sweep.run_rounds(st, step, po[:FORMATION_ROUNDS], pt[:FORMATION_ROUNDS],
                          pv[:FORMATION_ROUNDS])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sl = slice(FORMATION_ROUNDS, FORMATION_ROUNDS + MEASURED_ROUNDS)
    st = sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**fr.LAUNCHES, **sk.LAUNCHES}
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["launches"] != total:
            raise AssertionError(f"{r['name']} launched {r['launches']} times in "
                                 f"{total} rounds")
    if launches["select_topk"] != heartbeat_launches:
        raise AssertionError(f"select_topk launched {launches['select_topk']} times in "
                             f"{total} heartbeats")
    dmin, _mean, dmax = gossip_state_checks(st, csr_net, total, "GossipSub bench",
                                            (5, 12))
    peak = torch.cuda.max_memory_allocated()
    dense_final = convert.state_leaves(st)
    state_bytes = sum(a.nbytes for a in dense_final.values())
    say(f"slice N={N_FULL} M={M_SLOTS} K=16: {total} rounds, launches {launches}, "
        f"mesh degree [{dmin}, {dmax}], fwd subset of have")
    say(f"slice rate: {MEASURED_ROUNDS / dt:.3f} rounds/s over {MEASURED_ROUNDS} rounds "
        f"({1e3 * dt / MEASURED_ROUNDS:.3f} ms/round), peak memory {peak} bytes "
        f"({peak / 2**20:.1f} MiB), state {state_bytes} bytes, on {card}")
    del st

    lap("4")
    # 5. card against CPU from the same seed, also under subnormal scores
    gossip_parity(sweep, convert, "GossipSub bench", lambda d: sweep.build_bench(
        N_PARITY, M_SLOTS, count_events=True, device=d)[:2])
    for cell in SUBNORMAL_CELLS:
        gossip_parity(sweep, convert, f"GossipSub subnormal {cell}",
                      lambda d, c=cell: build_subnormal_gossipsub(sweep, N_PARITY, d, c),
                      SUBNORMAL_PARITY_ROUNDS)

    lap("5")
    # 6. the CSR bench: the same run CSR-resident through the composites
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, step, _t, _h = sweep.build_bench(N_FULL, M_SLOTS, edge_layout="csr", fused=True,
                                         device=dev)
    for m in counters:
        m.reset_launch_counts()
    st = sweep.run_rounds(st, step, po[:FORMATION_ROUNDS], pt[:FORMATION_ROUNDS],
                          pv[:FORMATION_ROUNDS])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = sweep.run_rounds(st, step, po[sl], pt[sl], pv[sl])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**fr.LAUNCHES, **sk.LAUNCHES, **cd.LAUNCHES, **db.LAUNCHES}
    want = {"edge_exchange": 0, "fused_delivery": 0, "csr_delivery": 0,
            "delivery_banded": 0, "select_topk": heartbeat_launches}
    if launches != want:
        raise AssertionError(f"CSR bench launches {launches}, expected {want}")
    csr_launches = launches["select_topk"]
    dmin, _mean, dmax = gossip_state_checks(st, csr_net, total, "CSR bench", (5, 12))
    peak = torch.cuda.max_memory_allocated()
    leaves = convert.state_leaves(st)
    state_bytes = sum(a.nbytes for a in leaves.values())
    leaves_equal(dense_final, convert.state_leaves(densify_edge_planes(csr_net, st)),
                 "CSR bench final state against the dense bench's")
    say(f"CSR bench N={N_FULL} K=16 E={csr_net.n_edges} fused: {total} rounds, launches "
        f"{launches}, mesh degree [{dmin}, {dmax}], fwd subset of have, final state "
        f"densified equal to phase 4's leaf for leaf")
    say(f"CSR bench rate: {MEASURED_ROUNDS / dt:.3f} rounds/s over {MEASURED_ROUNDS} rounds "
        f"({1e3 * dt / MEASURED_ROUNDS:.3f} ms/round), peak memory {peak} bytes "
        f"({peak / 2**20:.1f} MiB), state {state_bytes} bytes, on {card}")
    sched = [torch.as_tensor(a[total], device=dev) for a in (po, pt, pv)]
    _st, cap = capture_round(lambda s: step(s, *sched), st, sk, ("select_topk",))
    select_calls = {"K=16": cap["select_topk"][0]}
    del st, _st, dense_final, leaves

    lap("6")
    # 7. GossipSub on the power-law graph, CSR-resident
    pl_total = FORMATION_ROUNDS + POWERLAW_ROUNDS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, step, pl_net, setup = build_powerlaw_gossipsub(sweep, N_FULL, dev)
    ppo, ppt, ppv = sweep.publish_schedule(pl_total + 1, N_FULL, 1, None)
    for m in counters:
        m.reset_launch_counts()
    st = sweep.run_rounds(st, step, ppo[:FORMATION_ROUNDS], ppt[:FORMATION_ROUNDS],
                          ppv[:FORMATION_ROUNDS])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psl = slice(FORMATION_ROUNDS, pl_total)
    st = sweep.run_rounds(st, step, ppo[psl], ppt[psl], ppv[psl])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {**fr.LAUNCHES, **sk.LAUNCHES, **cd.LAUNCHES, **db.LAUNCHES}
    want = dict(want, select_topk=SELECTIONS_PER_HEARTBEAT * pl_total)
    if launches != want:
        raise AssertionError(f"power-law GossipSub launches {launches}, expected {want}")
    dmin, dmean, dmax = gossip_state_checks(st, pl_net, pl_total, "power-law GossipSub")
    peak = torch.cuda.max_memory_allocated()
    state_bytes = sum(a.nbytes for a in convert.state_leaves(st).values())
    say(f"power-law GossipSub N={N_FULL} K={pl_net.max_degree} E={pl_net.n_edges} fused: "
        f"host set-up {setup:.3f} s, {pl_total} rounds, launches {launches}, mesh degree "
        f"min {dmin} mean {dmean:.3f} max {dmax}, fwd subset of have")
    say(f"power-law GossipSub rate: {POWERLAW_ROUNDS / dt:.3f} rounds/s over "
        f"{POWERLAW_ROUNDS} rounds ({1e3 * dt / POWERLAW_ROUNDS:.3f} ms/round), peak memory "
        f"{peak} bytes ({peak / 2**20:.1f} MiB), state {state_bytes} bytes, on {card}")
    sched = [torch.as_tensor(a[pl_total], device=dev) for a in (ppo, ppt, ppv)]
    _st, cap = capture_round(lambda s: step(s, *sched), st, sk, ("select_topk",))
    select_calls["K=64"] = cap["select_topk"][0]
    del st, _st, cap

    lap("7")
    # 8. select_topk at the main path's shapes
    sel = check_select_topk(sk, select_calls, gen, base)
    keep_call("select_topk", select_calls["K=16"])
    main16, k64 = sel["K=16"], sel["K=64"]
    records.append({
        "name": "select_topk", "route": "cuda", "source": SELECT_SOURCE,
        "replaces": REPLACES["select_topk"], "launches": csr_launches,
        **{k: main16[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "baseline_ms", "row_paths") if k in main16},
        "library_ms": None, "sort_ms": main16["sort_ms"],
        "k64": {k: k64[k] for k in ("rows", "max_abs_err", "ms", "plain_ms", "sort_ms",
                                    "bound_ms", "bound_by", "baseline_ms", "row_paths")
                if k in k64},
    })
    del select_calls

    lap("8")
    # 9. the CSR builds, card against CPU
    gossip_parity(sweep, convert, "CSR bench", lambda d: sweep.build_bench(
        N_PARITY, M_SLOTS, count_events=True, edge_layout="csr", fused=True, device=d)[:2],
        CSR_PARITY_ROUNDS)
    gossip_parity(sweep, convert, "power-law GossipSub", lambda d: build_powerlaw_gossipsub(
        sweep, N_PARITY, d, count_events=True)[:2], CSR_PARITY_ROUNDS)

    lap("9")
    # 10-12. FloodSub over the shared delivery core, both layouts
    records.append(flood_run(sweep, convert, db, "delivery_banded", dict(
        n=N_FULL, graph="lattice", layout="dense"), card, gen, dev, base))
    records.append(flood_run(sweep, convert, cd, "csr_delivery", dict(
        n=N_CSR, graph="powerlaw", layout="csr"), card, gen, dev, base))
    for kw in (dict(graph="lattice", layout="dense"), dict(graph="powerlaw", layout="csr")):
        flood_parity(sweep, convert, kw)

    lap("10-12")
    # 13-14. the phase engine bench.py measures, dense banded and CSR
    from go_libp2p_pubsub_tpu_torch import driver

    dense_leaves, phase_ex, phase_calls = phase_bench(sweep, driver, convert, "dense", card, dev,
                                                      counters, csr_net)
    phase_bench(sweep, driver, convert, "csr", card, dev, counters, csr_net,
                dense_final=dense_leaves)
    del dense_leaves

    lap("13-14")
    # 15. the phase engine, card against CPU
    for layout in ("dense", "csr"):
        phase_parity(sweep, driver, convert, layout)

    lap("15")
    # 16. edge_exchange at the phase engine's shapes
    shapes = check_phase_exchange(fr, phase_calls, gen, base)
    records[0].update(phase_launches=phase_ex, phase_head=shapes["C=6"],
                      phase_data=shapes["C=2"])
    del phase_calls

    lap("16")
    # 17. windows on the card against the eager loop; each kernel in a graph
    blocks = window_parity(sweep, convert, dev, counters)

    lap("17")
    # 18. windowed benches at full width, in turns with the eager loop
    phase_turns = window_bench(sweep, driver, dev, card, counters, "phase")
    round_turns = window_bench(sweep, driver, dev, card, counters, "per-round")
    # each kernel's launches in one replay of a captured block
    block_of = {"phase bench": (phase_turns[1]["block_dispatches"],
                                phase_turns[1]["block_launches"]),
                "per-round bench": (round_turns[1]["block_dispatches"],
                                    round_turns[1]["block_launches"]),
                **{f"{k} (N={N_PARITY})": (v["block_dispatches"], v["launches"])
                   for k, v in blocks.items() if k.startswith("floodsub")}}
    for rec in records:
        rec["graph_block_launches"] = {
            f"{k}, a block of {d} dispatches": launched[rec["name"]]
            for k, (d, launched) in block_of.items() if launched.get(rec["name"])}

    lap("18")
    # 19. the bench CLI's line at a shortened segment
    bench_cli(card)

    lap("19")
    # 20-21. the eth2 and sybil configs at full size, both engines, eager
    # and windowed; card against CPU and windows against their eager loops
    config_runs = {}
    for config in ("eth2", "sybil"):
        for engine in ("per-round", "phase"):
            config_runs[f"{config} {engine}"] = config_bench(sweep, driver, config, engine,
                                                             card, dev, counters)
        config_parity(sweep, driver, convert, config, dev)
    for rec in records:
        rec["config_launches"] = {
            f"{path} {mode}": run["launches" if mode == "eager" else "block_launches"].get(
                rec["name"], 0)
            for path, runs in config_runs.items() for mode, run in runs.items()}

    lap("20-21")
    # 22. the bench CLI's line of each config
    for config in ("eth2", "sybil"):
        bench_cli(card, config)

    lap("22")
    # 23-24. RandomSub: BASELINE.json config #2, then at full width on the
    # lattice and on the 1M-peer power-law graph CSR-resident
    slice_launches = randomsub_baseline(sweep, convert, counters, dev, card)
    scale = {}
    for cell, spec in RANDOMSUB_SCALE.items():
        scale[cell] = randomsub_scale(sweep, driver, convert, counters, dev, card, cell, spec)
        slice_launches[f"RandomSub {cell} (N={spec['n']}), a round"] = (
            scale[cell]["launches_a_round"])

    lap("23-24")
    # 25. the delivery core's options on the bench default config: card
    # against CPU and windows against eager in both engines, the kernels
    # each engine may launch under them, and the both-options cell's
    # windowed phase bench beside phase 18's plain one
    option_counts = {}
    for label, kw in CORE_OPTIONS.items():
        config_parity(sweep, driver, convert, "default", dev, label=f"default {label}", **kw)
        option_counts[label] = option_launches(sweep, driver, dev, counters, kw)
        say(f"default {label} launches at N={N_PARITY}: {option_counts[label]} (per-round: "
            "no edge_exchange, no fused_delivery; no delivery_banded anywhere)")
    option_turns = window_bench(sweep, driver, dev, card, counters, "phase",
                                **CORE_OPTIONS["both"])
    say(f"phase bench windowed N={N_FULL}: both options "
        f"{[round(t['rate'], 3) for t in option_turns if t['mode'] == 'window']} against "
        f"the plain config's {[round(t['rate'], 3) for t in phase_turns if t['mode'] == 'window']}"
        f" delivery-rounds/s (phase 18), on {card}")

    lap("25")
    # 26. FloodSub under the queue cap
    capped = flood_capped(sweep, convert, counters, dev, card)
    for rec in records:
        rec["slice_launches"] = {k: v.get(rec["name"], 0) for k, v in slice_launches.items()}
        if rec["name"] == "select_topk":
            rec["randomsub"] = {cell: scale[cell]["select_topk"] for cell in scale}
    say("slice cells: " + json.dumps({
        "randomsub": {cell: {k: v for k, v in rec.items() if k != "select_topk"}
                      for cell, rec in scale.items()},
        "options_launches": option_counts,
        "options_window_rates": [t["rate"] for t in option_turns if t["mode"] == "window"],
        "floodsub_queue_cap": capped}))

    lap("26")
    # 27. PX with edge liveness, the exact-trace plane and the int16
    # counters at full width: launch gates and each kernel call on the
    # live view, then both engines eager and windowed in turns
    gates = px_gates(sweep, driver, dev, counters)
    px_ex = check_phase_exchange(fr, gates["calls"], gen, base, label="PX")
    px_del = check_px_delivery(fr, gates["delivery"], gen, base)
    records[0]["px"] = {**px_ex, "launches": gates["launches"]}
    records[1]["px"] = {**px_del, "launches": gates["launches"]}
    px_turns = {}
    for engine in ("per-round", "phase"):
        px_turns[engine] = window_bench(sweep, driver, dev, card, counters, engine,
                                        observe=px_observe, px=True)
        for t in px_turns[engine]:
            if t["live_edges"] <= gates["live_start"]:
                raise AssertionError(f"PX {engine} {t['mode']}: {t['live_edges']} live edges, "
                                     f"{gates['live_start']} at the start: none activated")
    say("PX cell: " + json.dumps({"live_edges_start": gates["live_start"],
                                  "launches": gates["launches"], "turns": px_turns}))

    lap("27")
    # 28. the PX cell card against CPU at N=8192, both engines, every leaf
    # after every round or phase; each window against its eager loop
    config_parity(sweep, driver, convert, "default", dev, label="default PX",
                  px=True)

    lap("28")
    # 29. churn on the kernel route at N=100k: launch gates, the kill
    # window's kernel calls against their plain versions, both engines
    # eager and windowed
    cg = churn_gates(sweep, driver, dev, counters)
    churn_ex = check_phase_exchange(fr, cg["calls"], gen, base, label="churn")
    churn_del = check_px_delivery(fr, cg["delivery"], gen, base, label="churn")
    records[0]["churn"] = {**churn_ex, "launches": cg["launches"]}
    records[1]["churn"] = {**churn_del, "launches": cg["launches"]}
    churn = churn_runs(sweep, driver, dev, card, counters)
    say("churn cell: " + json.dumps({"card": card, "dead_rows": cg["dead_rows"],
                                     "launches": cg["launches"], "runs": churn}))

    lap("29")
    # 30. the mutating overlay at N=100k, dense and full-capacity CSR
    overlay = overlay_runs(sweep, driver, dev, card, counters)
    for rec in records:
        if rec["name"] == "select_topk":
            rec["overlay_launches"] = {k: v["launches"]["select_topk"]
                                       for k, v in overlay.items() if "launches" in v}
    say("overlay cell: " + json.dumps({"card": card, **overlay}))

    lap("30")
    # 31. card against CPU at N=8192 and windows against eager, both cells
    dynamic_parity(sweep, driver, convert, dev)

    lap("31")
    # 32. the lifted score plane at full width, both engines: the kernel
    # route, the first calls against plain, eager and windowed in turns,
    # one window replaying three planes
    lift = {engine: lift_cell(sweep, driver, dev, card, counters, engine, turns)
            for engine, turns in (("per-round", round_turns), ("phase", phase_turns))}
    rec_of = {rec["name"]: rec for rec in records}
    for kernel in ("edge_exchange", "fused_delivery", "select_topk"):
        rec_of[kernel]["lift_launches"] = {e: v["launches"][kernel] for e, v in lift.items()}
    say("lift cell: " + json.dumps({"card": card, **lift}))

    lap("32")
    # 33. the count path and the per-plane wire form at full width, eager
    # and windowed beside the plain config; the bench CLI's per-plane line
    forms = {}
    for label, engine, kw in (("score_counts", "phase", dict(score_counts=True)),
                              ("per-plane", "phase", dict(wire_coalesced=False)),
                              ("per-plane", "per-round", dict(wire_coalesced=False))):
        turns = window_bench(sweep, driver, dev, card, counters, engine,
                             modes=("eager", "window"), **kw)
        window_gates(engine, turns, **kw)
        forms[f"{label} {engine}"] = turns
    forms["plain (phase 18)"] = {"phase": phase_turns, "per-round": round_turns}
    say("forms cell: " + json.dumps({"card": card, **forms}))
    bench_cli(card, coalesced=False)

    lap("33")
    # 34. card against CPU at N=8192 and windows against eager: the lifted
    # step (plane A then B, dense banded and CSR-resident), the count path,
    # the per-plane form; FloodSub and RandomSub with a plane; forward_mask
    for layout in ("dense", "csr"):
        config_parity(sweep, driver, convert, "default", dev, label=f"default lifted {layout}",
                      plane=lambda d: (lift_planes(sweep, d)["A"], lift_planes(sweep, d)["B"]),
                      lift_scores=True, edge_layout=layout, fused=layout == "csr")
    config_parity(sweep, driver, convert, "default", dev, label="default score_counts",
                  score_counts=True)
    config_parity(sweep, driver, convert, "default", dev, label="default per-plane",
                  wire_coalesced=False)
    plane_engines_parity(sweep, convert, dev)
    fm = forward_mask_parity(dev, counters)
    for kernel in ("delivery_banded", "csr_delivery"):
        rec_of[kernel]["forward_mask_launches"] = {layout: fm[layout][kernel] for layout in fm}

    lap("34")
    # 35. the trace drain: card against CPU trace bytes at N=8192, then the
    # full-width traced per-round and phase runs reconciled with the state
    from go_libp2p_pubsub_tpu_torch import checkpoint
    from go_libp2p_pubsub_tpu_torch.pb import trace_pb2
    from go_libp2p_pubsub_tpu_torch.trace import drain, sinks

    t0 = time.perf_counter()
    trace_cells = trace_parity(sweep, driver, drain, sinks, counters, card)
    traced = {engine: traced_full(sweep, driver, convert, drain, sinks, trace_pb2, dev, card,
                                  counters, engine) for engine in ("per-round", "phase")}
    say("trace cell: " + json.dumps({"card": card, "parity": trace_cells, **traced}))
    say(f"trace phase {time.perf_counter() - t0:.1f} s")

    lap("35")
    # 36. the checkpoint at full width: save, restore, resume eagerly and
    # into a captured window
    t0 = time.perf_counter()
    ckpt = [checkpoint_cell(sweep, driver, convert, checkpoint, dev, engine)
            for engine in ("per-round", "phase")]
    say("checkpoint cell: " + json.dumps({"card": card, "runs": ckpt}))
    say(f"checkpoint phase {time.perf_counter() - t0:.1f} s")

    lap("36")
    # 37. the application API: card == CPU at N=8192, the block plane on
    # the kernels' routes, the API at full width against the direct build
    from go_libp2p_pubsub_tpu_torch import api, sign

    t0 = time.perf_counter()
    api_cells = api_parity(api, sweep, counters)
    wb = wire_block_parity(sweep, driver, convert, dev, counters)
    api_runs = [api_full(api, sign, sweep, convert, dev, card, counters, r)
                for r in (PHASE_R, 1)]
    for rec in records:
        rec["api_launches"] = {
            **{f"API {c} (N={N_PARITY})": v.get(rec["name"], 0) for c, v in api_cells.items()},
            **{f"API r={a['r']} (N={N_FULL}), {API_PHASES if a['r'] > 1 else API_ROUNDS} "
               "dispatches": a["launches"].get(rec["name"], 0) for a in api_runs},
            **{f"wire_block {c} (N={N_PARITY})": v.get(rec["name"], 0) for c, v in wb.items()}}
    say("api cell: " + json.dumps({"card": card, "runs": api_runs}))
    say(f"api phase {time.perf_counter() - t0:.1f} s")

    lap("37")
    # 38. the link-fault plane: every engine under i.i.d. and GE flaps and
    # under a scheduled partition, card against CPU with the routes asserted
    # from launch counts; the full-width rates and the partition's recovery
    t0 = time.perf_counter()
    chaos_cells = chaos_parity(sweep, driver, convert, dev, counters)
    chaos_runs = chaos_full(sweep, driver, dev, card, counters)
    partition = chaos_partition(driver, dev, card, counters)
    for rec in records:
        rec["chaos_launches"] = {
            **{f"{c} (N={N_PARITY})": v.get(rec["name"], 0) for c, v in chaos_cells.items()},
            **{f"{c} window, a block of {t[1]['block_dispatches']} dispatches (N={N_FULL})":
               t[1]["block_launches"].get(rec["name"], 0)
               for c, t in chaos_runs.items() if not c.startswith("floodsub")},
            **{f"{c} {label}, {SCALE_ROUNDS} rounds": run["launches"].get(rec["name"], 0)
               for c, turns in chaos_runs.items() if c.startswith("floodsub")
               for turn in turns for label, run in turn.items()},
            f"partition window, a block of 1 phase (N={N_FULL})":
                partition["block_launches"].get(rec["name"], 0)}
    say("chaos cell: " + json.dumps({"card": card, "runs": chaos_runs,
                                     "partition": partition}))
    say(f"chaos phase {time.perf_counter() - t0:.1f} s")

    lap("38")
    # 40. the attack plane: all five behaviours in all four engines card
    # against CPU with their routes; the sybil flood and the eclipse at
    # full width
    t0 = time.perf_counter()
    attack_cells = attack_parity(sweep, driver, convert, dev, counters)
    flood = attack_flood(sweep, driver, convert, dev, card, counters)
    eclipse = attack_eclipse(sweep, driver, dev, card, counters)
    say(f"attack phase {time.perf_counter() - t0:.1f} s")

    lap("40")
    # 41. the telemetry panel on and off, windowed, at full width
    t0 = time.perf_counter()
    telemetry = telemetry_cost(sweep, driver, dev, card, counters)
    say(f"telemetry phase {time.perf_counter() - t0:.1f} s")
    for rec in records:
        rec["attack_launches"] = {
            **{f"{c} (N={N_PARITY})": v.get(rec["name"], 0) for c, v in attack_cells.items()},
            **{f"sybil flood {c} {run['mode']} (N={N_FULL}), "
               + (f"a block of {run['block_dispatches']} dispatches" if "block_launches" in run
                  else f"{ATTACK_ROUNDS} rounds"):
               run.get("block_launches", run.get("launches", {})).get(rec["name"], 0)
               for c, runs in flood.items() for run in runs},
            **{f"eclipse {e} (N={N_FULL}), {ECLIPSE_ROUNDS} rounds":
               run["launches"].get(rec["name"], 0) for e, run in eclipse.items()}}
        rec["telemetry_launches"] = {
            f"{e} window {'on' if t['telemetry'] else 'off'} (N={N_FULL}), a block of "
            f"{t['block_dispatches']} dispatches": t["block_launches"].get(rec["name"], 0)
            for e, cell in telemetry.items() for t in cell["turns"][:2]}
    say("attack cell: " + json.dumps({"card": card, "eclipse": {
        e: {k: v for k, v in run.items() if k not in ("series", "target_score_series")}
        for e, run in eclipse.items()},
        "eclipse_series": {e: {"mesh": run["series"], "target_scores": run["target_score_series"]}
                           for e, run in eclipse.items()},
        "flood": flood}))
    say("telemetry cell: " + json.dumps({"card": card, **telemetry}))

    lap("41")
    # 42. the invariant oracle: checked windows at full width beside
    # unchecked ones, every seeded violation card against CPU, the due
    # contract under a partition and a churn storm, the CDF parity
    t0 = time.perf_counter()
    oracle = oracle_full(sweep, driver, dev, card)
    seeded = oracle_seeded(convert, dev)
    partition42 = oracle_partition(driver, convert, dev)
    storm42 = oracle_storm(driver, convert, dev)
    cdf = oracle_cdf(dev, card)
    for rec in records:
        rec["oracle_launches"] = {
            f"{e} checked window (N={N_FULL}), a block of {v['block_dispatches']} dispatches":
            v["block_launches"].get(rec["name"], 0) for e, v in oracle.items()}
    say("oracle cell: " + json.dumps({"card": card, "full": oracle, "seeded": seeded,
                                      "partition": partition42, "storm": storm42,
                                      "cdf": cdf}))
    say(f"oracle phase {time.perf_counter() - t0:.1f} s")

    lap("42")
    # 43. the router plane: card against CPU at N=8192, the choke smoke's
    # cells at full width, the bench lattice with the router on and off
    t0 = time.perf_counter()
    rparity = router_parity(sweep, driver, convert, checkpoint, dev, counters)
    say(f"router parity {time.perf_counter() - t0:.1f} s")
    rfull = router_full(sweep, driver, dev, card, counters)
    say(f"router parity and full width {time.perf_counter() - t0:.1f} s")
    rlattice = router_lattice(sweep, driver, dev, card, counters)
    for rec in records:
        rec["router_launches"] = {
            **{f"{c} (N={N_PARITY}), {ROUTER_PARITY_ROUNDS} rounds": v.get(rec["name"], 0)
               for c, v in rparity.items() if "block" not in c},
            **{f"{c.replace(' block', '')}, a block of 4 dispatches (N={N_PARITY})":
               v.get(rec["name"], 0) for c, v in rparity.items() if "block" in c},
            **{f"{c} (N={N_FULL}), a round": v["launches_per_round"].get(rec["name"], 0)
               for c, v in rfull.items() if c != "summary"},
            **{f"lattice window {label} (N={N_FULL}), a block of "
               f"{t[0]['block_dispatches']} dispatches": t[0]["block_launches"].get(
                   rec["name"], 0) for label, t in rlattice["turns"].items()}}
    say("router cell: " + json.dumps({"card": card, "parity": rparity, "full": {
        c: {k: v for k, v in rec.items()} for c, rec in rfull.items()},
        "lattice": rlattice}))
    say(f"router phase {time.perf_counter() - t0:.1f} s")

    lap("43")
    # 44. the ensemble plane: six builds as S=3 ensembles card against card
    # one-sim, CPU and window; the kernels' S=8 launches; the phase bench as
    # an S=8 windowed ensemble; the choke smoke and the router's latency
    # cells as S=4 ensembles
    t0 = time.perf_counter()
    eparity = ensemble_parity(sweep, driver, convert, dev, counters)
    ekernels = ensemble_kernel_times(dev, card)
    efull = ensemble_full(sweep, driver, convert, dev, card, counters)
    echoke = ensemble_choke(sweep, driver, dev, card, counters)
    for rec in records:
        rec["ensemble"] = {
            "batched_s8": ekernels[rec["name"]],
            "launches_s3": {f"{label} (N={N_PARITY}, S={ENSEMBLE_SIMS}), "
                            f"{v['dispatches']} dispatches": v["launches"].get(rec["name"], 0)
                            for label, v in eparity.items()},
            "full_block_launches_s8": efull["batched"]["block_launches"].get(rec["name"], 0)}
    say("ensemble cell: " + json.dumps({"card": card, "parity": eparity, "kernels": ekernels,
                                        "full": efull, "choke": echoke}))
    say(f"ensemble phase {time.perf_counter() - t0:.1f} s")

    lap("44")
    # 45. the supervised service loop: the _child cell card against CPU with
    # the ladder, the bench default supervised at full width against the
    # bare window, recovery at full width, a kill -9 resumed
    t0 = time.perf_counter()
    sparity = serve_parity(dev, counters)
    sfull = serve_full(sweep, driver, dev, card)
    srecovery = serve_recovery(sweep, driver, dev, sfull)
    skill = serve_kill(sparity["digest"])
    for rec in records:
        rec["serve_launches"] = {
            f"_child cell (N={N_PARITY}), {sparity['counted_dispatches']} counted "
            f"dispatches of {SERVE_ARGS['rounds']} (warm-up and capture)":
                sparity["launches"].get(rec["name"], 0),
            f"_child cell (N={N_PARITY}), a replay block of {sparity['block_dispatches']} "
            "dispatches": sparity["block_launches"].get(rec["name"], 0),
            f"supervised bench (N={N_FULL}), a block of {sfull['block_dispatches']} phases":
                sfull["block_launches"].get(rec["name"], 0)}
    say("serve cell: " + json.dumps({"card": card, "parity": sparity, "full": sfull,
                                     "recovery": srecovery, "kill": skill}))
    say(f"serve phase {time.perf_counter() - t0:.1f} s")

    lap("45")
    # 39. launches of a bench round, a phase-bench phase and a windowed
    # phase, traced; then the configs' rounds and phases (last: the
    # profiler's tracing must not touch a rate timed in this process)
    bench_launches(card)
    config_traced_launches(card)

    lap("39")
    say(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
