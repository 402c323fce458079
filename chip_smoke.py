#!/usr/bin/env python3
"""Smoke run of raft_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``raft_tpu_torch/csrc`` and runs the
port's deployments. First the north star (3 replicas, 256-byte entries, batch
1024, a 32 768-slot ring):

1. prints the card (``nvidia-smi`` name and power limit);
2. builds the kernels (all ``nvcc`` runs in parallel) and prints the time;
3. holds every kernel against its plain PyTorch version on the card, bit
   for bit, on seam, partial, slow-row, dead-row, conflict, infeasible and
   turnover cases (K1 also where rows hold entries of the window's own
   terms, with conflicts on two rows, a one-entry window and 88-byte rows;
   K2 also on an empty window, a stale leader, a member mask, conflicts on
   two rows and the term_floor gate; a K3 flight also phase by phase: its
   plan's per-step record and outputs against ``pipeline_plan_plain``, its writer's
   payload ring against ``pipeline_write_plain``), then through a
   200-step randomized multi-term schedule (kernel path on the card,
   plain path on the host);
4. drives the main path through ``SingleDeviceTransport``: election,
   repair-capable ticks healing a slow row, steady ticks, then the port's
   ``northstar.run_device`` on the same cluster with pipeline flights
   until 1 048 576 entries have committed (32 ring laps), a leader kill
   with re-election and catch-up; follower read-back hashes must equal the
   input stream's, every kernel must have launched, and the north star's
   own metric, the p50/p99 of per-step time (probe flights on a fresh
   cluster, CUDA events around each), is printed on the same line;
5. times each kernel (profiler medians of 21; K3 as its plan plus its
   writer, printed apart as ``k3_split``, with the turnover decision
   alone and an 8-step dead-row flight; ``k2_split``, K2's device time
   against its wrapper's CUDA-event time per call) beside its plain
   version and its byte bound (K4 and K4·mesh also beside
   ``library_ms``, the same ring writes as one ``index_copy_`` and one
   ``fill_``; K1 beside its write yardstick, two ``index_copy_`` calls),
   ``launch_floor`` (the device time of a one-element ``fill_``), and
   the main path per step.

Then BASELINE config 4 (5 replicas, 256-byte entries, batch 1024, a
32 768-slot ring, row 4 induced-slow):

5a. runs both of ``bench.py``'s programs on fresh clusters: 8 flights of
    32 steps with ``allow_turnover=False`` (K3, no K4) and 64
    repair-capable ticks (the general path, K1 twice a tick); each must
    read back row 1 hash-equal to its input with commit equal to
    submitted at rows 0-3 and row 4's log unmoved; prints their K3 and
    K1 launches, entries/s, per-step p50/p99 (CUDA events), a profile of
    one call (device time by kernel, idle share) and the faster program.

Then the engine's tick loop (``raft_tpu_torch.raft.RaftEngine``):

5b. drives the north star through the engine at the same deployment: an
    election, 65 536 entries in two halves through the tick loop (64 full
    leader ticks: K1 while repairing, K2 once steady), one
    ``submit_pipelined`` chunk of 32 768 entries that the gate must admit
    (one K3/K4 flight), the leader failed, a re-election and 4 096 more
    entries; every window read back through ``committed_entries`` and
    every live follower, and the apply stream over all of it, must hash
    to the input's, and K1-K4 must all have launched; prints entries/s on
    the host clock, CUDA-event ms per leader tick, and a profiled window
    of ticks (kernels per tick, device idle share);
5c. runs K-tick fusion through the engine (``engine_fused_path``): first
    ``replicate_fused`` (one replay of a captured CUDA graph of K ticks)
    against ``fused_steady_scan`` run uncaptured on the card at the north
    star's shape, K = 8 and 32 (a full window across the ring seam,
    ``n_run < K``, an escape mid-window, an escape on a follower's raised
    term, ``halted0``, two launches pipelined, a launch after an unbooked
    escape, a second launch at a size captured between the two), every
    leaf and output equal; then the north star through ``RaftEngine`` at
    ``fuse_k`` 1, 8 and 32 on one schedule (an election, 65 536 entries in
    bursts of 8 192 drained by ``run_for``, idle heartbeats, the leader
    failed, a re-election and 4 096 more), every burst read back through
    ``committed_entries`` and every live follower, the apply stream equal
    to the input's, and K = 8 and 32 equal to K = 1 in nodelog lines,
    commit stamps, terms, state and read-backs; then the same schedule at
    a 4 096-slot ring with ``fuse_k`` 8 on the card and on the CPU,
    equal; prints ms per leader tick and entries/s of the drain per K,
    the graphs captured and replayed, a profiled burst (device busy, idle
    share, kernels per launch) and the ``HostProfiler``'s phases per
    leader tick;
5d. drives the engine with the host observability plane attached
    (``engine_obs_path``): the north star through ``RaftEngine`` at
    ``fuse_k`` 1 and 8 (64 full leader ticks in bursts of 8 192, one
    ``submit_pipelined`` ring, a failover, 4 096 more; every submit in a
    span of its own), each run detached, with spans, metrics, auditor,
    SLO and status board but no recorder or trace, and with the full
    plane (recorder, trace, an ``OpsServer`` scraped from a thread during
    the run); exact: the recorder's nodelog lines equal the trace, the
    read-backs and apply stream equal the detached run's, every span
    reaches committed (and applied, off the pipelined chunk), no audit
    violation and the auditor's commit digest equal to one recomputed
    from the read-back bytes, the Prometheus text round-trips with
    ``raft_commits_total`` = ``committed_total``, every ``/status``,
    ``/metrics``, ``/slo`` and ``/healthz`` answer 200 and the board's
    snapshot, ``fuse_k`` 8's recorder dump, span table, metrics text and
    auditor summary (bar its count of audited events) equal to
    ``fuse_k`` 1's, a bundle explained by ``python -m raft_tpu_torch.obs
    --explain`` naming every term's last leader, and the attached plane's
    device fetches equal to the detached run's (``_fetch`` calls, and
    the profiler's device-to-host copies over one burst); prints ms per
    leader tick detached and attached, fetches and copies per leader
    tick with and without a recorder, events and spans per leader tick,
    one ``/status`` and one ``/metrics`` request, the bundle's size and
    write time; then (``obs_card_equals_cpu``) the full plane at a
    4 096-slot ring and ``fuse_k`` 8 on the card and on the CPU: recorder
    dumps, span tables, Prometheus text, auditor, SLO and status
    snapshots equal;
5e. runs BASELINE config 5, ``bench.py``'s ``bench_storm`` (3 replicas,
    256-byte entries, B = 64, C = 4096, seed 2; both variants), through
    the engine on the card and again on the CPU: the nodelog lines,
    terms, commit latencies, committed bytes and state must be equal;
    prints ``bench_storm_once``'s fields and the storm's host wall;
5f. builds the port's C++ host codec (``raft_tpu_torch/native``, ``g++``;
    a missing compiler fails the phase) and holds it on one 4 MiB segment
    at RS(6,4) (``native_codec``): ``encode_host`` equal to the NumPy
    oracle, ``decode_host`` giving the segment back from all fifteen
    4-of-6 row sets; prints host ms of encode and decode against the
    oracle's and the host CPU;
5g. drives the tiered archive through the engine (``engine_tiered_path``):
    the north star with ``tiered_log_dir`` in a temporary directory, 16
    ring laps (524 288 entries: leader ticks and one ``submit_pipelined``
    ring), 28 segments of C/2 sealed behind the 65 536-entry hot tail (~170
    MiB of shard files); ``register_apply(replay=True)`` from index 1 must
    hash to the input; the same run with the tier off must make the same
    ``_fetch`` calls; a second run (hot tail C/2, segments of C/4) keeps a
    follower dead for 3 laps and recovers it through the snapshot stream
    from the sealed tier (its ring window equal to the input), reads back
    a segment with one data shard bit-flipped and another deleted, and
    saves and restores a checkpoint with the tier; then the first run at
    C = 4 096 on the card and on the CPU: nodelog lines, state leaves,
    read-backs and shard files equal; prints ms a seal, entries/s with
    the tier on and off and replay entries/s; the files are deleted;
5h. drives the device event ring through the engine
    (``engine_device_obs_path``): ``fused_graph_vs_loop``'s cases again
    with an event ring on both sides (the recorded K-tick graph against
    the uncaptured recorded loop, on every state leaf and the ring's four
    tensors; a new event ring recaptures); ``engine_obs_path``'s schedule
    at ``fuse_k`` 1 and 8 detached and with ``attach_device_obs(4096)``:
    state leaves, read-backs, nodelog lines and K1-K4 launches equal, the
    decoded elect/commit lines equal to the trace's, the device counters
    equal to the host tallies, exactly one fetch more per launch
    boundary; at capacity 64 with every flush held to the end,
    ``dropped`` = total - 64 and the survivors equal to the full ring's
    last 64; then at C = 4 096 on the card and on the CPU, the packed ring
    and the decoded events equal; prints ms a leader tick and device ops a
    leader tick attached and detached at K = 1 and 8.

Then BASELINE config 3 (5 replicas, RS(5,3) shards of 264-byte entries,
batch 1024, a 32 768-slot ring, commit quorum 4):

6. holds K6 (encode; decode for all ten 3-row sets and the rotated set
   (2,0,1); RS(6,3) at config 3's widths, all twenty 3-row sets, with
   K7; RS(4,2) with 8-byte entries, single words; RS(6,4)), K6's
   decode of the log ring in place (``reconstruct``: the whole ring, a
   window across the seam, a partial window, every decoding row set,
   against the gathered window and the plain decode), K7 and K2/K3/K4 in
   their in-kernel parity mode against their plain versions on the card,
   bit for bit (K7 also on one entry, a batch that leaves a block partly
   idle, an odd shard width, k = 4 with m = 1 and RS(32,16), the widest
   code it takes; seam, partial, dead-row, slow-row, conflict, turnover and
   two-dead-row cases, K2·ec's edges as K2's, its member mask under the
   EC floor, then randomized multi-term schedules at config 3
   and at RS(4,2) with 8-byte entries and B = 128, and K3·ec/K4·ec
   flights at the odd shard widths W = 1 and 3);
7. drives the EC main path on a fresh cluster: election, K7-fed ticks
   (K2), a data-lane steady scan (K2·ec), ``northstar.run_device_ec`` to
   1 048 576 committed entries read back through rows (0,1,2) and (1,2,4)
   (K3/K4·ec, K6 decode), a flight with row 4 dead (committed at 4 of 5),
   the heal of row 4 (K6 encode), and a flight with rows 3 and 4 dead (no
   commit, the committed bytes still read); every EC kernel must have
   launched on it;
8. times each EC kernel as in 5 (K7 beside its copy yardstick, one
   strided ``copy_`` of the data words into the folded layout, and the
   launch floor again, ``k7_vs_floor``; ``k6_bank_probe``: K6 decode on
   all-zero bytes), ``k6_read_path`` (a decoding read of one flight's
   window before, gathered and decoded contiguous, and after, K6 on the
   ring), and the EC path's device idle share;
8a. drives config 3 through the erasure-coded engine (``RaftEngine`` with
    ``rs_k=3``, a vote log in a temporary directory): an election and
    65 536 entries through 64 full leader ticks (K7 encodes each batch,
    K2 replicates it at the quorum of 4), one ``submit_pipelined`` ring
    (one K4 flight), a data row failed and 8 192 entries committed at 4
    of 5 and read back through a parity row (K6 decoding the ring), a
    second row slow under 2 048 uncommitted entries while the first
    recovers (healed by reconstruction: K6 decode, K6 encode, install;
    the suffix re-served: K6 encode), the second row failed and lapped
    by 40 960 entries (ticks, then a K3 flight with the dead row) and
    recovered (the heal refuses, the snapshot stream installs chunks
    until the heal can finish), a leader failover with 4 096 entries,
    then ``save_checkpoint``, a vote after it, ``RaftEngine.restore`` on
    a fresh transport with the vote log, an election and 4 096 entries;
    every read-back, every live row's shard column (against a fresh K6
    encode), the apply stream and the restored terms and votedFor are
    checked, and K7, K6 encode, K6 decode, K2 and K3 or K4 must launch;
    prints entries/s, CUDA-event ms per leader tick, a profiled window of
    steady EC ticks and the walls of the stream, the save and the
    restore;
8b. runs 8a's steps at a 4 096-slot ring on the card and on the CPU
    (the CPU's flight gate opened, so both fly the same chunks): the
    nodelog lines, terms, commit stamps, state leaves and committed bytes
    of the engine before the crash and of the restored one must be
    equal, which holds K6 and K7 inside the engine against their plain
    versions;
8c. drives the replicated KV store (``raft_tpu_torch.examples``:
    ``ReplicatedKV`` and ``ReplicatedCounter`` on one log) through the
    engine at the north star's deployment with headroom (3 voters of 5
    rows, PreVote, CheckQuorum, leader leases, C = 32 768): 64 full ticks
    of SETs (8-byte keys over 16 384, 243-byte values) with lease reads,
    one ``submit_pipelined`` ring under the voter plane, ``add_server(3)``
    and ``add_server(4)`` (snapshot stream, repair, promotion; ReadIndex
    rounds and write-confirmed ticket batches under the packed
    voter|learner mask meanwhile), 16 ticks at 5 voters (a profiled
    window of 8 with reads), a voter wiped and ``replace``d by itself,
    counter increments blindly retried across ``remove_server(leader)``,
    and a partitioned minority leader refusing; every get equals the
    model at its read index, the counter is exactly-once, the applied
    SETs and every live voter's ring equal the input; prints ms per
    leader tick and per read round, tickets per round, lease reads per
    host second, the join walls and the launches;
8d. runs 8c at a 4 096-slot ring on the card and on the CPU: nodelog
    lines, terms, roles, masks, commit stamps, read indices, tickets,
    state, the store and the counter must be equal;
8e. grows config 3's width with headroom (RS(6,3), 5 voters of 6 rows)
    5 -> 6 with ``add_voter(5)`` under traffic, heals the joiner by
    reconstruction, fails two rows, shrinks to 4 and refuses a removal
    below the quorum, at C = 4 096 on the card and on the CPU, equal.

Then the multi-Raft group data plane at the two deployments the JAX
package's bench runs on it: config A (16 groups of 3 replicas, 256-byte
entries, batch 256, a 4096-slot ring each; ``bench.py``
``bench_multi_group``) and config B (1024 groups, 64-byte entries, batch
16, a 1024-slot ring each, 32-tick fused launches; ``_group_shard_sweep``):

9. holds K5 (the masked ring-window write, one launch for all groups)
   against its plain version on the card, bit for bit, at both shapes with
   per-group seam starts, counts and lane masks, all lanes rejected, and
   one group; then a randomized 8-group schedule at config A's widths
   (elections, slow and dead rows, masked groups, term changes, fused
   launches, stale-term conflicts) with the group programs on the card and
   their plain versions on the host;
10. drives config A through ``group_vote_step`` and
    ``group_replicate_step`` (a slow follower in half the groups healed by
    the repair window, a masked group left bit-unchanged, 64 saturated
    steps) and config B through ``fused_group_scan`` (4 clean launches, a
    launch in which 64 groups lose two rows and halt, a launch with
    ``halted0`` that leaves them bit-unchanged); every committed entry of
    every group is read back from a follower row once a ring lap and its
    per-group SHA-256 must equal the input's; one config-A group must
    equal the single-group ``replicate_step`` path, and K5 must have
    launched on both paths;
11. times K5 at both shapes and at ``multi_card_equals_cpu``'s G = 4
    (beside its write yardstick, one ``index_copy_`` over the flattened
    group rings), config A's ms per 16-group step and config
    B's µs per group tick of a fused launch (CUDA events; the counterparts
    of ``bench.py``'s ``device_scan_us_per_step`` and
    ``single_device_us_per_group_tick``) and both device idle shares;
11a. drives config A through ``raft_tpu_torch.multi.MultiEngine`` with
    ``Router`` and ``ShardedKV`` (``engine_multi_path``, ``bench.py``'s
    seed 9): round-robin leaders, SETs in four waves (a warm batch a
    group; 2 048 a group timed from submit to durable ack, as
    ``bench_multi_group``; then a wave after the leaders of a quarter of
    the groups fail, through the Router's retries and the re-elections,
    and a profiled wave); each group's ``register_apply`` stream and
    ``committed_payloads`` against the input's SHA-256, gets against the
    model; prints ``bench_multi_group``'s metrics (entries/s, virtual
    commit p50/p99), ms per tick round (median and maximum) and per
    launch, and a profiled wave's kernels per round and idle share;
11b. runs config B through the engine (``engine_multi_fused_path``):
    ``core.graphs.FusedGroupGraphs`` (one replay of the captured K-tick
    group loop) against ``fused_group_scan`` uncaptured on the card,
    unrecorded and recorded (every leaf, output and event ring; 16
    cases: a clean window, ``n_run < K``, 64 groups escaping, masked
    groups, ``halted0``, K = 16, a new ring, a new group-id tensor);
    the launch alone, graph and loop in turns (16 a side); then 8 waves
    of 64 entries a group at ``fuse_k`` 32 with the graphs and without
    them, wave for wave in turns, and at 1, each read back against the
    input's SHA-256 and all three equal in every state leaf, commit
    stamp and clock; prints every fused window's ms and booking ms, the
    timed waves' entries/s, kernels and idle share of a profiled instant
    per run;
11c. ``multi_card_equals_cpu``: 4 groups at a 256-slot ring, ``fuse_k``
    8, a flight recorder, a trace and the device event ring,
    ``ShardedKV`` waves through fused windows and ticks, a slow follower
    healed and a leader failed and re-elected through the Router, on
    the card and on the CPU: nodelog lines, recorder events, state
    leaves, the packed group rings, decoded events and the store equal;
11d. ``group_mesh_path``: config B on the group-sharded layout, two
    shards of 512 groups on the one card (``GroupMesh([cuda:0,
    cuda:0])``; not a multi-card run): ``group_main_b``'s schedule
    through ``GroupMeshTransport`` (one graph set a shard) beside the
    resident program, every leaf and output equal after each window, a
    cross-shard ``swap_slots`` in place (data pointers kept, no graph
    recaptured) and the window alone in turns against the resident
    graphs; then ``MultiEngine`` + ``Router`` + ``ShardedKV`` at
    ``fuse_k`` 32: 2 048 SETs a group through the sharded engine in waves
    of 256, the first four taken in turns with the resident engine, a
    ``Router.rebalance`` migration mid-traffic, every group's apply
    stream and ring read-back against the input's SHA-256;
    prints entries/s, ms a fused window, K5 launches of each layout,
    graph captures and recaptures and fetches a round;
11e. ``group_mesh_card_equals_cpu``: 8 groups over two shards at a
    256-slot ring, ``fuse_k`` 8, a trace, a recorder and the device
    ring: migrations, fused windows, ``drive_schedule`` with a leader
    killed, on the card and on the CPU: nodelog lines, recorder events,
    every gathered leaf, decoded events, committed bytes equal;
11f. ``obs_planes_path``: the compile, memory and capture planes at the
    north star, ``fuse_k`` 8. A compile watch and retrace sentinel are
    installed, two bursts of 8 192 entries warm up, the sentinel freezes,
    and at least 8 steady fused windows must show no violation, with
    ``compile`` events on ``single.fused`` equal to the graph captures. A
    memory watch's ``engine.state.*`` bytes must equal the state's leaf
    bytes; its census must stay flat over the steady windows, flag a held
    ``float32[123,7]`` orphan, and go flat once the orphan is gone. The
    censuses and one labeled fused launch run under
    ``torch.cuda.set_sync_debug_mode("error")``. An in-place audit is
    made on one graph replay, and an S + 1 staging buffer must trip the
    sentinel with ``int32[S+1,B,W]`` on ``single.fused``. Then a
    save/restore onto a fresh transport runs frozen, and its captures,
    seconds, violations and the allocator's bytes before and after the
    old engine is collected are printed. The schedule is run detached and
    attached in turns, with equal nodelog lines, state, read-back SHA-256
    and ``_fetch`` count, and ms per leader tick printed for each.
    ``capture_profile(0.5)`` runs while a thread drives the engine, and
    must hold CUDA kernel events (K1's or K2's) and span events.
    ``device_seconds`` of one K3 flight is printed beside its CUDA-event
    time. Last, ``serve_demo`` runs on the card for 3 s, and
    ``/compile``, ``/memory`` and ``/profile?seconds=0.2`` must answer
    200;
11g. ``chaos_path``: the chaos harness (``raft_tpu_torch.chaos``) on
    the card, every run held against the same run on the CPU field by
    field (report, nemesis log, message counts, and every op of the
    client history with its virtual times): the pinned membership seeds
    11/14/22/27 at ``phases=4`` at ``fuse_k`` 1 and at
    ``RAFT_TPU_FUSE_K=4`` (fused windows must run); seed 17 at
    ``phases=6`` with the compile and memory planes, first at ``fuse_k``
    4 with the graph pool off (the crash cycles' captures after the
    freeze, printed), then at ``fuse_k`` 1 and 4 with it on: LINEARIZABLE
    with crash cycles, no sentinel violation, a flat census, no
    recapture, and the same run as with the pool off; the broken
    ``dirty_reads`` variant rejected; ``torture_run_multi``,
    ``overload_run``, ``reconfig_run``, ``reads_run`` (correct and
    ``lease_skew``), ``segment_storage_run`` and ``migration_run`` on two
    shards of the card; then membership seed 11 at the north star's
    widths (3 -> 5 voters, 256-byte entries, B = 1 024, C = 32 768),
    LINEARIZABLE, its wall and ms a leader tick printed, and the same at
    C = 4 096 against the CPU. K1, K2 and K5 must launch;
11h. ``wire_path``: the net tier (``raft_tpu_torch.net``) over loopback
    sockets on the card: (a) the north star (``fuse_k`` 8, the drive
    quantum 8 heartbeats) behind ``IngestServer(EngineBackend(RaftEngine,
    ReplicatedKV))``, 311 296 SETs as SUBMIT_BATCH frames of 1 024 from
    4 closed-loop connections, one frame in flight on each (shed entries
    resubmitted), with linearizable and session reads of one key mixed
    in, each against its last acknowledged value: 256 frames timed, 40
    under the profiler, the last 8 at a one-heartbeat quantum (the steady
    program); every committed window read back through
    ``committed_entries`` and every live follower, the SHA-256 multiset
    equal to the acknowledged entries', every batch staged at ingest and
    none by the tick path, fused windows run, K1 and K2 launched;
    entries/s through the wire (the read-back's seconds taken out, the
    raw wall beside it), the pump's µs per phase and coverage, and the
    idle share of 8 profiled pump iterations; (b) config A behind
    ``RouterBackend`` + ``ShardedKV`` (the lease on), single-op SETs over
    16 connections: 1 024 a group in a closed loop with 1 024 in flight
    (SETs/s), then 512 a group at each of a quarter and half that rate in
    an open loop (submit-to-durable-ack p50/p99 ms from when each was
    due); each group's apply stream against its acknowledged SETs, every
    SET read back linearizably, K5 launched;
    (c) the wire drill (``wire_run(7)``) on the card and on the CPU, each
    LINEARIZABLE with JAX's pinned invariants and 144 ops, and the serial
    pin (12 submits, 4 reads, seed 9) equal card to CPU, traced and not,
    nodelog lines included; (d) a traced drill's bundle, whose
    ``python -m raft_tpu_torch.obs --explain`` prints the joined wire
    forensics. No ERROR frame and no pump crash anywhere;
11i. ``txn_path``: the transaction tier (``raft_tpu_torch.txn``) on the
    card: (a) ``txn_run`` on two shards of the card at seed 7, plain and
    with ``lease_reads``, each equal field by field to the same run on
    two CPU shards (report, commit-order witness, single-key history),
    SERIALIZABLE, conserved, at the digest the JAX package's tests pin,
    the lease certifying most basis reads; (b) ``bench.py``
    ``bench_txn``'s leg through ``IngestServer(RouterBackend,
    txn=TxnCoordinator)``: 4 groups, 64-byte entries, B = 64, C = 2 048,
    the write gate at 512, seed 17; 8 connections of 30 requests, 90 %
    64-entry SUBMIT_BATCH frames over ``mk*`` and 10 % validated
    two-account transfers over 16 ``ta*`` accounts: txn commit p50/p99
    (the wire BEGIN + COMMIT round), committed transactions/s, the abort
    rate, single-key entries/s and the raw wall; a shorter round under
    torch.profiler for the idle share; then, out of both rounds, every
    account read back with the sum conserved, every single key read back,
    the outcomes in the coordinator's counts and decision map, no lock
    held; (c) K5 at that shape against its plain version and timed. Only
    K5 may launch. No ERROR frame and no pump crash;
11j. ``cluster_path``: the cluster tier (``raft_tpu_torch.cluster``), whose
    replicas are pure host processes: (a) the drills as the JAX
    package's tests run them, three ``python -m
    raft_tpu_torch.cluster.child`` processes each: ``cluster_run(0)``,
    ``cluster_storage_run(5)`` with ``fsync_lies`` and
    ``wal_skip_corrupt``, ``cluster_net_run(7)`` with ``peer_no_crc`` and
    ``lease_stale_round`` (up to ``CLUSTER_LEASE_ATTEMPTS`` runs, one
    catch), each holding every receipt ``tests/test_cluster.py`` asserts,
    the EIO fail-stop pair printed on its own line and not held (ROADMAP
    §C), and no child holding ``/dev/nvidia*`` open or listed by
    ``nvidia-smi``; (b) ``bench.py`` ``bench_cluster``'s goodput row, 900
    unbatched single-op writes over 6 connections against the 3-process
    cluster (goodput, e2e p50/p99, WAL fsync batching, commit digests
    agreeing) beside the same shape against the single-process wire
    reference on the card (``MultiEngine`` G = 4, B = 8, C = 2 048,
    64-byte entries, seed 23; every write applied as sent; its idle share
    under torch.profiler), and its handoff row (the leader killed, 300
    writes through the survivors, the victim respawned on its own dirs
    and then on a wiped dir: ``handoff_s``, ``reseal_s``, their ratio,
    nothing resealed on adoption); (c) K5 at the reference's shape
    against its plain version and timed. Only K5 may launch, only in the
    reference. No ERROR frame and no pump crash;
11k. ``laps_path``: the lapped flight and the engine's fault paths. (a)
    ``bench.py``'s lapped chunk (``bench_client_latency``) through
    ``RaftEngine`` at ``RaftConfig(pipeline_max_laps=8)`` at the north
    star: a warm chunk, then two timed chunks of 262 144 entries, each of
    which must ride exactly one flight of 256 steps (K3's plan, then K4
    across 8 laps), beside the one-ring chunk (a warm one and three timed
    of 32 768 entries, one flight of 32 steps each); each chunk's wall,
    entries/s and its parts (pack, fold and upload, the flight's device
    ms, bookkeeping, intake), and the last ring read back through
    ``committed_entries`` and from both followers against the input's
    SHA-256; K4 at T = 256 against its plain version, then timed beside
    its byte bound (only the last lap's windows reach the ring) and its
    ``index_copy_`` + ``fill_`` yardstick at that shape; (b) the lapped
    engine at C = 4 096 (8 laps: T = 32) on the card and on the CPU, the
    flight gate opened there: nodelog lines, flights, read-backs and
    every state leaf equal; (c) the JAX package's fault schedules
    (``tests/_torch_faults.py``) on the card and on the CPU, equal in
    nodelog lines, leaders by term, ``_ring_floor``, the watermark, every
    row's retained committed bytes and every state leaf: the ring-lap
    chaos seeds 22 and 25 (K1, K2), the EC lap chaos seed 12 (K2 on
    K7-encoded windows, K6 in its heals), the pipelined multi-lap chaos
    seed 3 (K3, K4 at T = 4), a partition schedule and a
    PreVote/CheckQuorum storm;

Then the replica mesh: one replica row per rank of a ``torch.distributed``
gloo group, all ranks on the one card (three processes time-sharing it,
not a multi-card run), built through ``make_transport`` with
``transport="tpu_mesh"``:

12. holds K2·mesh, K3·mesh and K4·mesh of every row against their plain
    versions, bit for bit, at the north star (R = 3) and at config 3 (R =
    5, the EC quorum): random gathered planes and prev columns, then the
    seam, partial, slow-row, dead-row, member-shrunk, infeasible and
    lapped-turnover cases, and K2·mesh's edges as K2's (W = 64 and 22); K4·mesh's bookkeeping (a leader term of 0, a
    term floor beyond the last tail, mixed terms and votes) at 256-, 88-
    and 12-byte rows; then randomized multi-term schedules that keep
    the engine's invariants, each row's mesh kernels against the resident
    kernels on the whole cluster;
13. spawns 3 ranks (kernels built here first) and drives the multichip
    dry run's ladder on them — an election, repair-capable ticks (K1 on
    the local row) healing a slow row, a fused step (K2·mesh), a scan —
    then the north star's 1 048 576 entries through 32-step flights
    (``northstar.run_device``; the host decides and K4·mesh alone turns
    the ring over) and a flight with row 2 slow and one with row 2 dead
    (K3·mesh: 6 launches over the 3 ranks, against 96 of K4·mesh); after
    every stage every rank's scalars, rings and info must equal its row
    of the same schedule run here through ``SingleDeviceTransport``, each
    follower rank's committed bytes must hash to the input's, and every
    rank's mesh kernels and K1 must have launched;
14. spawns 5 ranks at config 3 (K7-encoded windows, 4 turnover flights:
    K4·mesh alone, no K3·mesh launch) and holds every rank's ring to its
    row of the single-device run;
15. times K2·mesh, K3·mesh and K4·mesh beside their plain versions and
    byte bounds (``k2_split`` as in 5; ``k4_mesh_split``: its payload row, term row and
    bookkeeping each alone, the whole with the L2 cache flushed, and at
    mesh config 3's rows), ``bench.py``'s ``bench_mesh1`` (a 1-rank
    group against the resident transport, per 32-step flight) and the
    3-rank north star's wall per flight and launch-collective time;
16. drives the north star through the engine over the mesh
    (``engine_mesh_path``): ``RaftEngine`` as 3 lock-step mirrors, one
    gloo rank a replica row (``transport="tpu_mesh"``, the mirror digest
    every 64 decisions), all sharing the card: an election, 64 leader
    ticks of B entries (K1 on the local row while repairing, K2·mesh once
    steady; 8 of them profiled on rank 0), one ``submit_pipelined`` of 4
    whole rings (one K4·mesh flight a ring), a leader failover and 4 096
    more, a follower failed and lapped (a ring flown with the dead row:
    K3·mesh; then 4 ticks) and rejoined by the snapshot stream,
    ``save_checkpoint`` and ``RaftEngine.restore`` with the vote log and
    4 096 more; every rank's read-backs (``committed_entries`` and every
    live row) and apply stream against the input's SHA-256, its nodelog
    lines equal across the ranks and to the single-device engine's run of
    the same schedule here, its row equal to that engine's row, mirror
    exchanges made with no desync; prints ms a leader tick (p50/p99),
    entries/s through the ticks and the chunk, collectives and gathering
    fetches a tick with host ms each, ms a mirror exchange, the save and
    restore walls and the profiled ticks' idle share;
17. drives config 3 through the mirrored engine on 5 ranks
    (``engine_mesh_ec_path``): K7-fed ticks, a data row failed and a
    decoding read through K6 from the gathered donor windows, the row
    healed by reconstruction (K6 decode and encode), a restore (K6
    encode) and 4 096 more, every read back exactly, every rank's row
    and lines equal to the single-device engine's;
18. runs 16's schedule at C = 4 096 with a flight recorder and a
    256-record device event ring on 3 card ranks and on 3 CPU ranks
    (``mesh_engine_card_equals_cpu``): nodelog lines, rows, packed rings,
    decoded lines and read-backs equal;
19. prints the kernel table, the card line, and last
    ``{"ok": true, "device": {...}}``.

Any failure ends the run with a nonzero exit code before the last line.
It needs the repository checkout around it and a CUDA device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SEED = 20261016
ENTRIES = 1 << 20
STEPS_PER_FLIGHT = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# --------------------------------------------------------------- phase 1
def card_query():
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0].strip()


def phase_card():
    import torch

    line = card_query()
    card = {"phase": "card", "nvidia_smi": line,
            "torch_name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(card)
    return line


def mem_rate(name: str) -> float:
    """Peak device-memory bytes/s of the named card (data-sheet values)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    return 3.35e12          # H100 SXM


# --------------------------------------------------------------- phase 2
def phase_build():
    from raft_tpu_torch import cuda_build

    report = cuda_build.build_all()
    # each kernel's entry line (its mangled name), registers, spills
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln][:90]
             for name, log in report["logs"].items()}
    for name in cuda_build.SOURCES:
        cuda_build.lib(name)
    emit({"phase": "build", "seconds": report["seconds"], "ptxas": ptxas})


# --------------------------------------------------------------- phase 3
def ns_config():
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=256, batch_size=1024,
                      log_capacity=STEPS_PER_FLIGHT * 1024,
                      transport="single")


def max_err(pairs) -> int:
    """Largest absolute difference over (a, b) tensor pairs (int64)."""
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        d = (a.cpu().long() - b.cpu().long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def steady_state(cfg, dev, last, lterm=1, rng=None):
    """A caught-up, fully committed cluster whose rows all end at ``last``
    (every ring slot holds entries of term ``lterm`` and random bytes)."""
    import torch

    from raft_tpu_torch.core.state import init_state

    st = init_state(cfg, device=dev)
    for f in ("last_index", "commit_index", "match_index"):
        getattr(st, f).fill_(last)
    st.term.fill_(lterm)
    st.match_term.fill_(lterm)
    st.voted_for.fill_(0)
    st.log_term.fill_(lterm)
    g = torch.Generator(device="cpu").manual_seed(int(rng.integers(1 << 30)))
    st.log_payload.copy_(torch.randint(-2**31, 2**31 - 1,
                                       st.log_payload.shape, generator=g,
                                       dtype=torch.int32))
    return st


def rand_window(rng, B, M, dev):
    import torch

    return torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, (B, M), dtype=np.int64)
        .astype(np.int32)).to(dev)


def window_lanes(cfg, consts):
    """Lanes of a window: every row's (M), or only the k data-lane blocks
    (k*W) in the steady kernels' in-kernel parity mode."""
    if consts is None:
        return cfg.rows * cfg.shard_words
    return cfg.entry_bytes // 4


def k2_case(cfg, dev, rng, st, count, alive, slow, consts=None, lterm=1,
            tfloor=1, member=None):
    """One step of K2 (K2·ec with ``consts``) and of its plain version on
    clones of ``st``. Returns (max error, the kernel's commit index)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    L = cfg.rows
    prm = sc.step_params(0, lterm, tfloor, 0, 0, cfg.commit_quorum, L,
                         ec=cfg.ec_enabled)
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    mem = None if member is None else torch.tensor(member, dtype=torch.bool,
                                                   device=dev)
    win = rand_window(rng, cfg.batch_size, window_lanes(cfg, consts), dev)
    outs = []
    for fn in (sc.steady_step, sc.steady_step_plain):
        s2 = st.clone()
        v = sc.pack(s2)
        out = torch.zeros(2 * L + 5, dtype=torch.int32, device=dev)
        fn(v, s2.log_payload, s2.log_term, win, count, al, sl, mem, prm, out,
           consts)
        outs.append((v, s2, out))
    (vk, sk, ok_), (vp, sp, op) = outs
    return max_err([(vk, vp), (ok_, op), (sk.log_payload, sp.log_payload),
                    (sk.log_term, sp.log_term)]), int(ok_[L])


def k2_edge_states(cfg, dev, rng):
    """States for K2's edge cases (all three modes), from a caught-up
    cluster at 5·B: ``stale``, whose leader (row 0) is in term 3, so a
    step in term 2 is stale; ``two``, whose rows 1 and 2 hold suffixes
    past the leader's tail (term 1, some slots term 0), so a step in term
    2 raises the §5.3 conflict on both."""
    B = cfg.batch_size
    base = steady_state(cfg, dev, 5 * B, rng=rng)
    stale = base.clone()
    stale.term[0] = 3
    two = base.clone()
    two.last_index[1] = 5 * B + 500
    two.last_index[2] = 5 * B + 700
    two.log_term[1, 5 * B + 100:5 * B + 200] = 0
    two.log_term[2, 5 * B:5 * B + 300] = 0
    return base, stale, two


def k2_edge_cases(cfg, dev, rng, k2, quorum_member):
    """K2's edges through ``k2(state, count, alive, slow, **kw)`` (which
    returns the commit index): an empty window, a stale leader, a member
    mask (``quorum_member``; in the parity mode the EC floor clamps its
    majority), conflicts on two rows, and the term_floor gate holding the
    commit back. Checks what each must commit."""
    B, L = cfg.batch_size, cfg.rows
    ones, none = [1] * L, [0] * L
    base, stale, two = k2_edge_states(cfg, dev, rng)
    check(k2(base, 0, ones, none) == 5 * B, "K2 empty window")
    check(k2(stale, B, ones, none, lterm=2) == 5 * B,
          "K2 stale leader must not commit")
    member, want = quorum_member
    check(k2(base, B, ones, none, member=member) == want,
          f"K2 member mask {member} commits to {want}")
    check(k2(two, B, ones, none, lterm=2, tfloor=5 * B + 1) == 6 * B,
          "K2 conflicts on two rows")
    check(k2(base, B, ones, none, tfloor=6 * B + 1) == 5 * B,
          "K2 term_floor holds the commit back")
    return 5


def scan_case(cfg, dev, rng, st, counts, alive, slow, consts=None):
    """K2 (or K2·ec) as a main path reaches it: a steady scan whose counts
    stay on the device (each launch reads its count through a view),
    against the plain scan on the host. Returns the max error."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc
    from raft_tpu_torch.core.state import (FIELDS, state_from_numpy,
                                           state_to_numpy)

    B = cfg.batch_size
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    pays = torch.stack([rand_window(rng, B, window_lanes(cfg, consts), dev)
                        for _ in counts])
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    key = "steady_step" if consts is None else "steady_step_ec"
    n0 = sc.LAUNCHES[key]
    res = [sc.steady_scan_replicate(s2, pays, cnt, 0, 1, al, sl, 0, 0, None,
                                    1, commit_quorum=cfg.commit_quorum,
                                    ec_consts=consts)
           for s2 in (st.clone(), state_from_numpy(state_to_numpy(st), "cpu"))]
    check(sc.LAUNCHES[key] - n0 == len(counts),
          f"the scan did not launch {key} once per step")
    (sk, ik), (sp, ip) = res
    check(sk.log_payload.is_cuda and not sp.log_payload.is_cuda,
          "scan case: kernel side on the card, plain side on the host")
    return max_err([(getattr(sk, f), getattr(sp, f)) for f in FIELDS]
                   + [(getattr(ik, f), getattr(ip, f)) for f in ik._fields])


def phase_check(what, rec, before, got, wins, cnt, al, sl, mem, prm, br,
                turnover_ok, consts=None, my=-1, prev=None):
    """K3's two phases apart, on the card, for a flight the plan ran:
    ``rec`` (the plan kernel's per-step record) and the plan's outputs
    against ``pipeline_plan_plain`` from the same inputs (``before`` =
    copies of the plane, payload ring and term ring taken before the
    flight), then the writer's payload ring against
    ``pipeline_write_plain``. ``got`` = the kernel flight's (plane, out,
    payload ring, term ring). A mismatch names its phase."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    v, lp, lt = (x.clone() for x in before)
    out = torch.zeros_like(got[1])
    prec = sc.pipeline_plan_plain(v, lt, cnt, wins.shape[1], al, sl, mem,
                                  prm, br, turnover_ok, out,
                                  sc.workspace(v.device), my, prev)
    check(prec is not None and torch.equal(rec, prec),
          f"{what} plan: the per-step record differs from the plain plan's")
    check(max_err([(v, got[0]), (out, got[1]), (lt, got[3])]) == 0,
          f"{what} plan: plane, out or term ring differs from the plain "
          "plan's")
    sc.pipeline_write_plain(lp, lt, wins, prec, consts, my)
    check(max_err([(lp, got[2])]) == 0,
          f"{what} writer: payload ring differs from the plain writer's")


def flight_case(cfg, dev, rng, st, T, P, counts, alive, slow, turnover_ok,
                consts=None):
    """One T-step flight over P windows through K3 (and K4 behind it when
    ``turnover_ok``) and through their plain versions, on clones of
    ``st``; a flight K3 ran is also held phase by phase (``phase_check``).
    Returns (whether K4 wrote it, max error, the commit index)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    prm = sc.step_params(0, 1, 1, 0, 0, cfg.commit_quorum, L,
                         ec=cfg.ec_enabled)
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    wins = torch.stack([rand_window(rng, B, window_lanes(cfg, consts), dev)
                        for _ in range(P)])
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    work = sc.workspace(dev)
    br = sc.pick_br(B, C)
    res = []
    for kernel in (True, False):
        s2 = st.clone()
        v = sc.pack(s2)
        out = torch.zeros(L + 5, dtype=torch.int32, device=dev)
        r4 = int(work[sc.WK_RAN4])
        if kernel:
            rec = sc.pipeline_flight(v, s2.log_payload, s2.log_term, wins,
                                     cnt, al, sl, None, prm, br, turnover_ok,
                                     out, consts).clone()
            if turnover_ok:
                sc.turnover_flight(v, s2.log_payload, s2.log_term, wins, T,
                                   prm, out, consts)
        else:
            sc.pipeline_flight_plain(v, s2.log_payload, s2.log_term, wins,
                                     cnt, al, sl, None, prm, br, turnover_ok,
                                     out, work, consts)
            if turnover_ok:
                sc.turnover_flight_plain(v, s2.log_payload, s2.log_term, wins,
                                         T, prm, out, work, consts)
        res.append((v, s2, out, int(work[sc.WK_RAN4]) - r4))
    (vk, sk, ok_, k4k), (vp, sp, op, k4p) = res
    check(k4k == k4p, "flight: kernel and plain took different branches")
    if not k4k:
        phase_check("K3" if consts is None else "K3·ec", rec,
                    (sc.pack(st), st.log_payload, st.log_term),
                    (vk, ok_, sk.log_payload, sk.log_term), wins, cnt, al,
                    sl, None, prm, br, turnover_ok, consts)
    return bool(k4k), max_err(
        [(vk, vp), (ok_, op), (sk.log_payload, sp.log_payload),
         (sk.log_term, sp.log_term)]), int(ok_[L])


def k1_case(dev, rng, L, M, C, B, s, count, acc, kind):
    """K1 and its plain version on the same random rings and window (L
    rows of M / L lanes): ``kind`` "random" (random terms and last
    indices around the window), "conflict" (row 1 holds a stale term in
    the window's middle), "conflict2" (rows 0 and L-1 hold stale terms,
    at the window's last and first entries), "same_term" (every row holds
    entries of the window's own terms across it: the old terms are read
    and no flag may rise). Returns the max error; checks the flags."""
    import torch

    from raft_tpu_torch.core import ring_cuda

    buf_p = rand_window(rng, C, M, dev)
    buf_t = torch.from_numpy(rng.integers(1, 4, (L, C)).astype(
        np.int32)).to(dev)
    win = rand_window(rng, B, M, dev)
    win_t = torch.from_numpy(rng.integers(1, 4, B).astype(np.int32)).to(dev)
    ws = s + 1 + 3 * C
    last = torch.from_numpy(rng.integers(ws - 5, ws + B + 5, L).astype(
        np.int32)).to(dev)
    slots = (s + torch.arange(B, device=dev)) % C
    n = min(count, B)
    if kind in ("conflict", "conflict2"):
        win_t.fill_(3)
        buf_t[:, slots] = 3
        last.fill_(ws + B + 9)
        if kind == "conflict":
            buf_t[1, slots[n // 2]] = 2
        else:
            buf_t[0, slots[max(n - 1, 0)]] = 2
            buf_t[L - 1, slots[0]] = 1
    elif kind == "same_term":
        buf_t[:, slots] = win_t
        last.fill_(ws + B + 9)
    accept = torch.tensor(acc, dtype=torch.bool, device=dev)
    a = (buf_p.clone(), buf_t.clone())
    b = (buf_p.clone(), buf_t.clone())
    mm_k = ring_cuda.write_window_both(a[0], a[1], win, win_t, s, count, ws,
                                       accept, last)
    mm_p = ring_cuda.write_window_both_plain(b[0], b[1], win, win_t, s,
                                             count, ws, accept, last)
    flags = mm_k.tolist()
    if kind == "conflict" and count:
        check(flags[1] == 1, "K1 conflict flag not raised")
    if kind == "conflict2" and count:
        check(flags[0] == 1 and flags[L - 1] == 1 and sum(flags) == 2,
              f"K1 two-row conflict flags {flags}")
    if kind == "same_term":
        check(sum(flags) == 0, f"K1 raised {flags} on matching terms")
    return max_err([(a[0], b[0]), (a[1], b[1]), (mm_k, mm_p)])


def phase_kernels(cfg, dev, n_random=200):
    """Every kernel against its plain version on the same inputs."""
    import torch

    from raft_tpu_torch.core import ring_cuda

    rng = np.random.default_rng(SEED)
    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    errs = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    cases = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def note(key, err):
        errs[key] = max(errs[key], err)
        cases[key] += 1

    # K1 — seam, partial count, mixed accept, truncating conflict; rows
    # that hold entries of the window's own terms (the read path, no
    # flag), conflicts on two rows, a one-entry window; then 88-byte rows
    # (config 3's M = 110, moved word by word)
    k1_rows = {}
    for L_, M_, table in (
            (L, M, [(0, B, [1, 1, 1], "random"),
                    (C - B + 300, B, [1, 0, 1], "random"),
                    (C - 1, 777, [1, 1, 0], "random"),
                    (4096, 777, [0, 0, 0], "random"),
                    (C - 200, B, [1, 1, 1], "conflict"),
                    (12345, 0, [1, 1, 1], "conflict"),
                    (0, B, [1, 1, 1], "same_term"),
                    (C - 300, B, [1, 0, 1], "conflict2"),
                    (4097, 1, [1, 1, 1], "random"),
                    (C - 1, 1, [1, 1, 1], "conflict")]),
            (5, 110, [(C - B + 77, B, [1, 1, 0, 1, 1], "random"),
                      (5, 500, [1, 1, 1, 1, 1], "conflict2"),
                      (C - 40, B, [1, 0, 1, 1, 1], "same_term"),
                      (99, 1, [1, 1, 1, 1, 1], "conflict")]),
            # one row, as a mesh rank writes its local row: the 2-D
            # mesh's slices, 32 words (the north star) and 11 (config 3)
            *((1, m, [(C - B + 77, B, [1], "random"),
                      (5, 500, [0], "random"),
                      (C - 40, B, [1], "same_term"),
                      (99, 1, [1], "random")]) for m in (32, 11))):
        for s, count, acc, kind in table:
            note("K1", k1_case(dev, rng, L_, M_, C, B, s, count, acc, kind))
            k1_rows[f"M={M_}"] = k1_rows.get(f"M={M_}", 0) + 1

    def k2_commit(key, *args, **kw):
        err, commit = k2_case(cfg, dev, rng, *args, **kw)
        note(key, err)
        return commit

    def k2(*args, **kw):
        k2_commit("K2", *args, **kw)

    base = steady_state(cfg, dev, 5 * B, rng=rng)
    seam = steady_state(cfg, dev, 3 * C - B + 300, rng=rng)
    k2(base, B, [1, 1, 1], [0, 0, 0])
    k2(seam, B, [1, 1, 1], [0, 0, 0])                     # wrap seam
    cases["K2 edges"] = k2_edge_cases(
        cfg, dev, rng, lambda *a, **kw: k2_commit("K2", *a, **kw),
        ([1, 1, 0], 6 * B))
    k2(seam, 777, [1, 1, 1], [0, 0, 1])                   # partial, slow row
    k2(base, B, [1, 1, 0], [0, 0, 0])                     # dead row
    k2(base, B, [1, 1, 1], [0, 1, 1])                     # no quorum
    k2(base, B, [1, 1, 1], [0, 0, 0], lterm=2, tfloor=5 * B + 1)
    conflict = base.clone()                               # stale suffix
    conflict.last_index[2] = 5 * B + 700
    conflict.log_term[2, 5 * B:5 * B + 300] = 0
    k2(conflict, B, [1, 1, 1], [0, 0, 0], lterm=2, tfloor=5 * B + 1)
    note("K2", scan_case(cfg, dev, rng, seam, [B, 777, 0, B, 1, B],
                         [1, 1, 1], [0, 0, 1]))
    note("K2", scan_case(cfg, dev, rng, base, [0, B, 300, B], [1, 1, 0],
                         [0, 0, 0]))

    def flight(*args):
        k4, err, _ = flight_case(cfg, dev, rng, *args)
        which = "K4" if k4 else "K3"
        note(which, err)
        return which

    T = STEPS_PER_FLIGHT
    full = [B] * T
    check(flight(base, T, 4, full, [1, 1, 1], [0, 0, 0], False) == "K3",
          "K3 flight")
    part = list(full)
    part[5], part[17] = 300, 0
    check(flight(base, T, 3, part, [1, 1, 1], [0, 0, 1], True) == "K3",
          "infeasible K3")
    check(flight(seam, 8, 8, [B] * 8, [1, 1, 0], [0, 0, 0], True) == "K3",
          "seam K3")
    check(flight(base, T, T, full, [1, 1, 1], [0, 0, 0], True) == "K4",
          "K4 flight")
    check(flight(base, 2 * T + 5, 7, [B] * (2 * T + 5), [1, 1, 1],
                 [0, 0, 0], True) == "K4", "lapped K4")

    # randomized multi-term schedules: kernel path on the card, plain path
    # on the host, through the public step functions — at the north-star
    # shape (16-byte lane vectors), and at shapes whose lane blocks are
    # not whole int4s or whose window is not a multiple of 128 rows
    from raft_tpu_torch.config import RaftConfig

    rsteps = {"north_star": random_schedule(cfg, dev, n_random, rng)}
    for name, kw in (("r3_w2_b4", dict(n_replicas=3, entry_bytes=8,
                                       batch_size=4, log_capacity=32)),
                     ("r5_w3_b96", dict(n_replicas=5, entry_bytes=12,
                                        batch_size=96, log_capacity=288))):
        small = RaftConfig(transport="single", **kw)
        rsteps[name] = random_schedule(small, dev, n_random // 2, rng)
    for k in errs:
        check(errs[k] == 0, f"{k} differs from its plain version by "
                            f"{errs[k]}")
    emit({"phase": "kernels_vs_plain", "cases": cases, "k1_cases": k1_rows,
          "max_abs_err": errs, "random_schedule_steps": rsteps})
    return errs


class Lockstep:
    """One cluster held twice — kernels on the card, plain versions on the
    host — and stepped in lock step: every step's info must agree. Row 0
    leads term 1 at the start; ``masks`` moves the term and the leader
    now and then."""

    def __init__(self, cfg, dev, rng):
        from raft_tpu_torch.core.comm import SingleDeviceComm
        from raft_tpu_torch.core.state import init_state

        self.dev, self.rng, self.R = dev, rng, cfg.rows
        self.comm = SingleDeviceComm(cfg.rows)
        self.sts = {"k": init_state(cfg, device=dev),
                    "p": init_state(cfg, device="cpu")}
        self.term, self.leader, self.floor = 1, 0, 1
        self.vote(0, 1, [True] * cfg.rows)

    def __call__(self, fn, *args, **kw):
        import torch

        infos = {}
        for side, d in (("k", self.dev), ("p", "cpu")):
            conv = [a.to(d) if isinstance(a, torch.Tensor) else a
                    for a in args]
            self.sts[side], infos[side] = fn(self.sts[side], *conv, **kw)
        for f in infos["k"]._fields:
            a, b = getattr(infos["k"], f), getattr(infos["p"], f)
            check(torch.equal(a.cpu(), b.cpu()), f"schedule info.{f}")
        return infos["k"]

    def vote(self, cand, term, alive):
        import torch

        from raft_tpu_torch.core.step import vote_step

        return self(lambda st, *a: vote_step(self.comm, st, *a), cand, term,
                    torch.tensor(alive))

    def masks(self):
        """Maybe a new term and leader; then random (alive, slow, member)
        masks with the leader alive and a member."""
        import torch

        rng, R = self.rng, self.R
        if rng.random() < 0.08:
            self.term += int(rng.integers(1, 3))
            self.leader = int(rng.integers(0, R))
            self.vote(self.leader, self.term, list(rng.random(R) > 0.2))
            self.floor = int(self.sts["p"].last_index[self.leader]) + 1
        alive = list(rng.random(R) > 0.1)
        alive[self.leader] = True
        slow = list(rng.random(R) < 0.15)
        member = None
        if rng.random() < 0.2:              # a configuration mask
            member = list(rng.random(R) < 0.8)
            member[self.leader] = True
            member = torch.tensor(member)
        return torch.tensor(alive), torch.tensor(slow), member

    def check_states(self, what):
        import torch

        from raft_tpu_torch.core.state import FIELDS

        for f in FIELDS:
            check(torch.equal(getattr(self.sts["k"], f).cpu(),
                              getattr(self.sts["p"], f)),
                  f"{what}: state.{f}")


def flight_counts(rng, B, C):
    """A random flight: 2-5 full steps, or one that laps the ring, its
    last count partial half the time."""
    T = int(rng.integers(2, 6))
    if rng.random() < 0.3:
        T = C // B + int(rng.integers(0, 3))
    counts = [B] * T
    if rng.random() < 0.5:
        counts[-1] = int(rng.integers(0, B))
    return counts


def random_schedule(cfg, dev, n, rng):
    """Elections, repair-capable ticks (K1), steady ticks (K2) and flights
    (K3/K4) under random fault and membership masks."""
    import torch

    from raft_tpu_torch.core.state import fold_batch
    from raft_tpu_torch.core.step import replicate_step
    from raft_tpu_torch.core.step_cuda import steady_pipeline

    R, B, E, C = cfg.rows, cfg.batch_size, cfg.entry_bytes, cfg.log_capacity
    ls = Lockstep(cfg, dev, rng)
    steps = 0
    while steps < n:
        masks = ls.masks()
        kind = rng.choice(["repair", "steady", "flight"], p=[0.4, 0.45, 0.15])
        if kind == "flight":
            counts = flight_counts(rng, B, C)
            T = len(counts)
            data = rng.integers(0, 256, (T * B, E), dtype=np.uint8)
            ls(lambda st, *a: steady_pipeline(st, *a),
               fold_batch(data, R).reshape(T, B, -1),
               torch.tensor(counts, dtype=torch.int32), ls.leader, ls.term,
               masks[0], masks[1], 0, 0, masks[2], ls.floor)
            steps += T
        else:
            count = int(rng.choice([0, 3, 17, 777, B]))
            data = rng.integers(0, 256, (B, E), dtype=np.uint8)
            data[count:] = 0
            steady = kind == "steady"
            ls(lambda st, *a, **k: replicate_step(ls.comm, st, *a, **k),
               fold_batch(data, R), count, ls.leader, ls.term, masks[0],
               masks[1], 0, 0, masks[2], repair=not steady,
               term_floor=ls.floor if steady else None)
            steps += 1
        if steps % 25 < 5 or steps >= n:
            ls.check_states(f"schedule after {steps} steps")
    return steps


# --------------------------------------------------------------- phase 4
def zero_counters(dev):
    from raft_tpu_torch.core import ring_cuda, step_cuda

    for d in (ring_cuda.LAUNCHES, step_cuda.LAUNCHES):
        for k in d:
            d[k] = 0
    w = step_cuda.workspace(dev)
    w[step_cuda.WK_RAN3] = 0
    w[step_cuda.WK_RAN4] = 0


def read_counters(dev):
    from raft_tpu_torch.core import ring_cuda, step_cuda

    w = step_cuda.workspace(dev)
    return {
        "K1": ring_cuda.LAUNCHES["write_window_both"],
        "K2": step_cuda.LAUNCHES["steady_step"],
        "K3": step_cuda.LAUNCHES["pipeline_flight"],
        "K4": step_cuda.LAUNCHES["turnover_flight"],
        "K3_flights_run": int(w[step_cuda.WK_RAN3]),
        "K4_flights_run": int(w[step_cuda.WK_RAN4]),
    }


class Stream:
    """The client stream: seeded entries, the input hash in index order,
    and per-follower read-back hashes of what each row has committed."""

    def __init__(self, cfg, rows=(1, 2)):
        self.rng = np.random.default_rng(SEED + 1)
        self.cfg = cfg
        self.submitted = 0
        self.h_in = hashlib.sha256()
        self.rows = rows
        self.h_row = {r: hashlib.sha256() for r in rows}
        self.done = {r: 0 for r in rows}

    def batches(self, T, counts):
        """u8 entries for T windows of B (zero past each count)."""
        from raft_tpu_torch.core.state import fold_batch

        B, E = self.cfg.batch_size, self.cfg.entry_bytes
        data = np.zeros((T * B, E), np.uint8)
        for t, c in enumerate(counts):
            chunk = self.rng.integers(0, 256, (c, E), dtype=np.uint8)
            data[t * B:t * B + c] = chunk
            self.h_in.update(chunk.tobytes())
            self.submitted += c
        return fold_batch(data, self.cfg.rows).reshape(T, B, -1)

    def read_back(self, state):
        from raft_tpu_torch.core.state import log_entries

        commits = state.commit_index.tolist()
        for r in self.rows:
            hi = commits[r]
            check(hi - self.done[r] <= self.cfg.log_capacity,
                  f"row {r} fell a ring behind the read-back")
            if hi > self.done[r]:
                self.h_row[r].update(
                    log_entries(state, r, self.done[r] + 1, hi).tobytes())
                self.done[r] = hi

    def skip(self, n):
        """``n`` entries that another stream submitted and read back."""
        check(all(d == self.submitted for d in self.done.values()),
              "a follower's read-back lags before the skip")
        self.submitted += n
        self.done = {r: self.submitted for r in self.rows}


def phase_main_path(cfg, dev, entries=ENTRIES):
    import torch

    from raft_tpu_torch.northstar import run_device
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    tr = SingleDeviceTransport(cfg, device=dev)
    R, B, C = cfg.rows, cfg.batch_size, cfg.log_capacity
    T = STEPS_PER_FLIGHT
    S = Stream(cfg)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(R, dtype=torch.bool, device=dev)
    slow2 = torch.tensor([False, False, True], device=dev)
    zero_counters(dev)
    t_all = time.perf_counter()
    state = tr.init()

    # election: row 0 wins term 1
    state, vi = tr.request_votes(state, 0, 1, alive)
    check(int(vi.votes) == R and bool(vi.grants.all()), "election of row 0")

    # repair-capable ticks (K1): row 2 slow, then healed by the repair window
    for _ in range(4):
        state, info = tr.replicate(state, S.batches(1, [B])[0], B, 0, 1,
                                   alive, slow2)
        check(int(info.frontier_len) == B, "tick ingest")
    check(int(info.match[2]) == 0, "slow row stays behind")
    heal = 0
    while int(info.match[2]) < S.submitted:
        state, info = tr.replicate(state, S.batches(1, [0])[0], 0, 0, 1,
                                   alive, quiet)
        heal += 1
        check(heal <= 8, "repair window did not heal row 2")
    S.read_back(state)

    # steady ticks through the whole-step kernel (K2), as one scan
    pays = S.batches(8, [B] * 8)
    state, infos = tr.replicate_many(state, pays, torch.full(
        (8,), B, dtype=torch.int32, device=dev), 0, 1, alive, quiet,
        repair=False, term_floor=1)
    check(int(infos.commit_index[-1]) == S.submitted, "steady scan commit")
    S.read_back(state)

    # saturated flights (K3/K4) through the port's north-star entry point:
    # 32 ring laps of 32 x 1024 entries, read back from both followers
    flights = -(-entries // (T * B))
    run = run_device(cfg, entries, SEED + 3, transport=tr, state=state,
                     rows=S.rows, measure_latency=True)
    check(run.latency_method == "device", "north-star latency not from the "
                                          "device")
    state = run.state
    S.skip(entries)
    check(state.commit_index.tolist()[0] == S.submitted, "flight commit")
    for r in S.rows:
        check(run.row_digests[r] == run.input_digest,
              f"row {r} read-back of the flights differs from their input")

    # leader kill: row 0 dies, row 1 wins term 2 and keeps committing
    alive01 = torch.tensor([False, True, True], device=dev)
    state, vi = tr.request_votes(state, 1, 2, alive01)
    check(int(vi.votes) == 2, "re-election of row 1")
    floor2 = int(state.last_index[1]) + 1
    state, info = tr.replicate(state, S.batches(1, [B])[0], B, 1, 2,
                               alive01, quiet)
    check(int(info.commit_index) == S.submitted, "term-2 commit")
    S.read_back(state)
    Tk = 8
    state, info = tr.replicate_pipeline(
        state, S.batches(Tk, [B] * Tk).to(dev), torch.full(
            (Tk,), B, dtype=torch.int32, device=dev), 1, 2, alive01, quiet,
        term_floor=floor2)
    check(int(info.commit_index) == S.submitted, "flight without row 0")
    S.read_back(state)
    # row 0 returns and catches up through the repair window. Its match is
    # not verified for term 2, so repair restarts at the leader's ring
    # horizon; the slot before it was overwritten by a later lap, so (as
    # the engine does) the step gets the ring-validity floor and the
    # attested term of the entry below it: term 1, written before the kill
    floor = S.submitted - C + 1
    check(floor - 1 <= floor2 - 1, "attested entry predates the kill")
    catch = 0
    while int(info.match[0]) < S.submitted:
        state, info = tr.replicate(state, S.batches(1, [0])[0], 0, 1, 2,
                                   alive, quiet, repair_floor=floor,
                                   floor_prev_term=1)
        catch += 1
        check(catch <= C // B + 4, "row 0 did not catch up")
    S.read_back(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    counters = read_counters(dev)

    commits = state.commit_index.tolist()
    check(commits == [S.submitted] * R, f"commit {commits} != "
                                        f"{S.submitted} submitted")
    digest = S.h_in.hexdigest()
    for r in S.rows:
        check(S.h_row[r].hexdigest() == digest,
              f"row {r} read-back differs from the input stream")
    for k in ("K1", "K2", "K3", "K4", "K3_flights_run", "K4_flights_run"):
        check(counters[k] > 0, f"{k} never ran on the main path")
    result = {
        "phase": "main_path", "entries_committed": S.submitted,
        "pipeline_entries": entries, "pipeline_flights": flights,
        "ring_laps": entries // C,
        "heal_ticks": heal, "catch_up_ticks": catch,
        # the ticks around the flights, and the flights themselves
        "sha256_input": digest,
        "sha256_rows": {str(r): S.h_row[r].hexdigest() for r in S.rows},
        "flights_sha256_input": run.input_digest,
        "flights_sha256_rows": {str(r): d for r, d in run.row_digests.items()},
        "launches": counters,
        # run_device on the host clock: stream generation, fold, upload,
        # flights, follower read-back and the three SHA-256 folds
        "pipeline_wall_s": run.wall_s,
        "pipeline_us_per_step_wall": run.wall_s * 1e6 / (flights * T),
        "pipeline_entries_per_s_wall": entries / run.wall_s,
        # the north star's metric: per-step time of 32-step probe flights
        # on a fresh cluster, CUDA events around each flight / 32
        "p50_us_per_step": run.p50_us, "p99_us_per_step": run.p99_us,
        "latency_method": run.latency_method,
        "main_path_wall_s": wall,
    }
    emit(result)
    return result


# ---------------------------------------------------- BASELINE config 4
C4_CALLS = 8          # calls of each program
C4_TICKS = 8          # repair-capable ticks a call (64 in all)


def c4_config():
    """BASELINE config 4 (``bench.py`` ``c4_slow``, :3214-3231): 5
    replicas, 256-byte entries, batch 1024, a 32 768-slot ring, one
    induced-slow follower (row 4); commit at a majority, which the four
    rows that accept hold."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=5, entry_bytes=256, batch_size=1024,
                      log_capacity=1 << 15, transport="single")


def phase_config4_main_path(dev):
    """Config 4 through ``SingleDeviceTransport``, both of the JAX bench's
    programs, each on a fresh cluster (row 0 elected in term 1, row 4
    slow): 8 flights of 32 steps with ``allow_turnover=False`` (262 144
    entries of K3, no K4), and 64 repair-capable ticks as 8
    ``replicate_many(..., repair=True)`` calls of 8 (the general path,
    two K1 launches a tick). For each: row 1's read-back SHA-256 against
    the input's, commit equal to submitted and held by rows 0-3 (4 of 5),
    row 4's log unmoved, the K3 and K1 launches (counted from zero just
    before the program), entries/s on the host clock over the program
    (generation, upload, calls, read-back, hashing), and per-step p50/p99
    from CUDA events around each call (uploads outside them), all but the
    last call, which runs under the profiler (device time by kernel, idle
    share). The faster program is the one with the lower p50 per
    step, as ``bench.py``'s ``_best_program`` picks it."""
    import torch

    from raft_tpu_torch.transport.device import SingleDeviceTransport

    cfg = c4_config()
    R, B = cfg.rows, cfg.batch_size
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    slow4 = torch.tensor([False] * 4 + [True], device=dev)
    programs = {
        "steady_flights": (STEPS_PER_FLIGHT, lambda tr, st, pay, cnt:
                           tr.replicate_pipeline(
                               st, pay, cnt, 0, 1, alive, slow4,
                               term_floor=1, allow_turnover=False)),
        "repair_capable_ticks": (C4_TICKS, lambda tr, st, pay, cnt:
                                 tr.replicate_many(st, pay, cnt, 0, 1,
                                                   alive, slow4,
                                                   repair=True)),
    }
    res = {"phase": "config4_main_path", "n_replicas": R,
           "entry_bytes": cfg.entry_bytes, "batch": B,
           "capacity": cfg.log_capacity, "slow_row": 4,
           "commit_quorum": cfg.commit_quorum}
    for name, (steps, call) in programs.items():
        tr = SingleDeviceTransport(cfg, device=dev)
        S = Stream(cfg, rows=(1,))
        state, vi = tr.request_votes(tr.init(), 0, 1, alive)
        check(int(vi.votes) == R, f"config 4 {name}: election of row 0")
        row4_last = int(state.last_index[4])
        cnt = torch.full((steps,), B, dtype=torch.int32, device=dev)
        zero_counters(dev)
        times = []
        box = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(C4_CALLS):
            if i == C4_CALLS - 1:
                wall = time.perf_counter() - t0
            pay = S.batches(steps, [B] * steps).to(dev)
            if i < C4_CALLS - 1:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                state, info = call(tr, state, pay, cnt)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) * 1e3 / steps)
            else:       # the last call under the profiler
                def one(st=state, pay=pay):
                    box["out"] = call(tr, st, pay, cnt)

                events, pwall = _device_events(one, 1)
                state, info = box.pop("out")
            S.read_back(state)
        counters = read_counters(dev)
        n = S.submitted
        check(n == C4_CALLS * steps * B, f"config 4 {name}: submitted")
        by_kind = {}
        for ev, us in events:
            kind = kernel_of(ev) or ("copy" if "emcpy" in ev else "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us
        busy = sum(by_kind.values())
        check(state.commit_index.tolist()[:4] == [n] * 4
              and state.last_index.tolist()[:4] == [n] * 4,
              f"config 4 {name}: commit {state.commit_index.tolist()} is "
              f"not {n} on rows 0-3")
        check(int(state.last_index[4]) == row4_last,
              f"config 4 {name}: the slow row's log moved")
        check(S.h_row[1].hexdigest() == S.h_in.hexdigest(),
              f"config 4 {name}: row 1's read-back differs from the input")
        if name == "steady_flights":
            check(counters["K3_flights_run"] == C4_CALLS
                  and counters["K4"] == 0 and counters["K1"] == 0,
                  f"config 4 flights: launches {counters}")
        else:
            check(counters["K1"] == 2 * C4_CALLS * steps
                  and counters["K3"] == 0,
                  f"config 4 ticks: launches {counters}")
        res[name] = {
            "calls": C4_CALLS, "steps_per_call": steps, "entries": n,
            "commit": int(state.commit_index[0]), "holders": 4,
            "row4_last_index": int(state.last_index[4]),
            "sha256_input": S.h_in.hexdigest(),
            "sha256_row1": S.h_row[1].hexdigest(),
            "launches": counters,
            # all calls but the last: host clock (generation, upload, the
            # call, read-back, hashing) and CUDA events per call
            "timed_calls": C4_CALLS - 1, "wall_s": wall,
            "entries_per_s_wall": (C4_CALLS - 1) * steps * B / wall,
            "p50_us_per_step": float(np.percentile(times, 50)),
            "p99_us_per_step": float(np.percentile(times, 99)),
            "latency_method": "device",
            # the last call under the profiler: where its time went
            "profiled_call": {
                "wall_ms": pwall * 1e3, "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / (pwall * 1e6),
                "device_us_per_step": busy / steps,
                "device_ms_by_kind": {k: v / 1e3
                                      for k, v in by_kind.items()}},
        }
        del state, tr
    res["faster_program"] = min(
        programs, key=lambda k: res[k]["p50_us_per_step"])
    emit(res)
    return res


# ------------------------------------------------- the engine (A9a)
ENGINE_TICK_ENTRIES = 1 << 16      # 64 full leader ticks, in two halves
ENGINE_FLIGHT_ENTRIES = 1 << 15    # one submit_pipelined chunk: one ring
ENGINE_AFTER_ENTRIES = 4096        # committed after the leader failover
ENGINE_PROFILED_TICKS = 8


class EngineInput:
    """Seeded entries for the engine phase, kept for window read-backs,
    with the input stream's running SHA-256."""

    def __init__(self, cfg):
        self.rng = np.random.default_rng(SEED + 40)
        self.E = cfg.entry_bytes
        self.blobs = []            # one bytes object per submitted batch
        self.h = hashlib.sha256()

    def take(self, n):
        blob = self.rng.integers(0, 256, n * self.E, dtype=np.uint8).tobytes()
        self.blobs.append(blob)
        self.h.update(blob)
        return [blob[i * self.E:(i + 1) * self.E] for i in range(n)]

    def window(self, lo, hi):
        """The input bytes of log indices [lo, hi] (1-based; every entry
        committed in submit order)."""
        whole = b"".join(self.blobs)
        return whole[(lo - 1) * self.E:hi * self.E]


def engine_read_back(e, inp, lo, hi, what):
    """Indices [lo, hi] read through ``committed_entries`` and from every
    live follower's ring: each SHA-256 must be the input's."""
    from raft_tpu_torch.core.state import log_entries

    want = hashlib.sha256(inp.window(lo, hi)).hexdigest()
    got = {"committed_entries": hashlib.sha256(
        e.committed_entries(lo, hi).tobytes()).hexdigest()}
    for r in range(e.cfg.rows):
        if r != e.leader_id and e.alive[r]:
            check(int(e.state.commit_index[r]) >= hi,
                  f"{what}: row {r} has not committed {hi}")
            got[f"row{r}"] = hashlib.sha256(
                log_entries(e.state, r, lo, hi).tobytes()).hexdigest()
    for k, v in got.items():
        check(v == want, f"{what}: {k}'s read-back of [{lo}, {hi}] differs "
                         "from the input")
    return {"lo": lo, "hi": hi, "sha256": want, "readers": sorted(got)}


def phase_engine_main_path(cfg, dev):
    """The north star through ``RaftEngine`` at ``RaftConfig()``'s
    deployment (3 replicas, 256-byte entries, B = 1024, C = 32 768, the
    ring on the card): an election; 65 536 entries through the tick loop
    (64 full leader ticks: K1 while repairing, K2 once steady) in two
    halves, each read back; one ``submit_pipelined`` chunk of 32 768 (the
    gate admits it: one K3/K4 flight); the leader failed, a re-election,
    4 096 more committed; every committed window read back through
    ``committed_entries`` and every live follower, and the apply stream's
    SHA-256 over all of it. The K1-K4 launch counters must all move.
    Recorded, not gated: entries/s on the host clock, CUDA-event ms per
    leader tick, and a profiled window of ticks (kernels per tick, device
    idle share)."""
    import torch

    from raft_tpu_torch.obs import profiling
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    B = cfg.batch_size
    tr = SingleDeviceTransport(cfg, device=dev)
    flights = []
    run_flight = tr.replicate_pipeline

    def counted_flight(*a, **k):
        flights.append(int(a[2].shape[0]))
        return run_flight(*a, **k)

    tr.replicate_pipeline = counted_flight
    e = RaftEngine(cfg, tr)
    inp = EngineInput(cfg)
    h_apply = hashlib.sha256()
    applied = [0]

    def apply(idx, payload):
        check(idx == applied[0] + 1, "the apply stream skipped an index")
        applied[0] = idx
        h_apply.update(payload)

    e.register_apply(apply)
    tick_events = []
    run_tick = e._fire_leader_tick

    def timed_tick(r):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run_tick(r)
        b.record()
        tick_events.append((a, b))

    e._fire_leader_tick = timed_tick
    res = {"phase": "engine_main_path", "n_replicas": cfg.n_replicas,
           "entry_bytes": cfg.entry_bytes, "batch": B,
           "capacity": cfg.log_capacity}
    zero_counters(dev)
    e.run_until_leader()
    res["first_leader"] = e.leader_id
    res["first_leader_virtual_s"] = e.clock.now
    # 2. two halves of 32 768 entries through the tick loop
    reads = []
    half = ENGINE_TICK_ENTRIES // 2
    for h in range(2):
        seqs = [e.submit(p) for p in inp.take(half)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if h == 1:
            # a profiled window of leader ticks, annotated by launch
            ticks0 = e._tick_count

            def window():
                with profiling.annotating():
                    while e._tick_count < ticks0 + ENGINE_PROFILED_TICKS:
                        e.step_event()

            events, pwall = _device_events(window, 1)
            # the launch annotations show as device ranges of their own
            # (``leader_tick#n``, spanning each tick's work): not device
            # work, so kept out of the busy time and the counts
            annotations = [n for n, _ in events
                           if n.startswith("leader_tick#")]
            events = [(n, us) for n, us in events
                      if not n.startswith("leader_tick#")]
        e.run_until_committed(seqs[-1])
        torch.cuda.synchronize()
        if h == 0:        # the unprofiled half: the host-clock rate
            tick_wall = time.perf_counter() - t0
        check(e.commit_watermark == (h + 1) * half,
              f"engine: commit {e.commit_watermark} after half {h}")
        reads.append(engine_read_back(e, inp, h * half + 1, (h + 1) * half,
                                      f"engine ticks, half {h}"))
    ticks = len(tick_events)
    tick_ms = [a.elapsed_time(b) for a, b in tick_events]
    res["ticks"] = {
        "leader_ticks": ticks, "entries": ENGINE_TICK_ENTRIES,
        "entries_per_s_wall": half / tick_wall,
        "rate_over": "the first half (32 768 entries, not profiled)",
        "wall_s": tick_wall,
        "ms_per_tick_p50": float(np.percentile(tick_ms, 50)),
        "ms_per_tick_p99": float(np.percentile(tick_ms, 99)),
        "ms_per_tick_mean": float(np.mean(tick_ms)),
        "latency_method": "CUDA events around each leader tick (host "
                          "work inside)"}
    by_kind = {}
    for name, us in events:
        kind = kernel_of(name) or ("copy" if "emcpy" in name else "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    busy = sum(by_kind.values())
    kernels = [n for n, _ in events if "emcpy" not in n and "emset" not in n]
    by_name = {}
    for name, us in events:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res["profiled_ticks"] = {
        "ticks": ENGINE_PROFILED_TICKS, "wall_ms": pwall * 1e3,
        "launch_annotations": len(annotations),
        "kernels_per_tick": len(kernels) / ENGINE_PROFILED_TICKS,
        "device_ops_per_tick": len(events) / ENGINE_PROFILED_TICKS,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / (pwall * 1e6),
        "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
        "device_ms_top_names": {k: v / 1e3 for k, v in top}}
    tick_counts = read_counters(dev)
    check(tick_counts["K1"] > 0 and tick_counts["K2"] > 0,
          f"engine ticks: K1 and K2 must both launch: {tick_counts}")
    # 3. one pipelined chunk of one ring: the gate must admit it
    leader_last = int(e.state.last_index[e.leader_id])
    payloads = inp.take(ENGINE_FLIGHT_ENTRIES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.submit_pipelined(payloads)
    torch.cuda.synchronize()
    flight_wall = time.perf_counter() - t0
    check(flights == [cfg.log_capacity // B],
          f"engine: the pipeline gate did not admit the chunk: {flights}")
    check(e.commit_watermark == leader_last + ENGINE_FLIGHT_ENTRIES,
          f"engine: the flight committed {e.commit_watermark}")
    reads.append(engine_read_back(e, inp, leader_last + 1,
                                  e.commit_watermark, "engine flight"))
    res["flight"] = {"entries": ENGINE_FLIGHT_ENTRIES, "steps": flights[0],
                     "wall_s": flight_wall,
                     "entries_per_s_wall": ENGINE_FLIGHT_ENTRIES
                     / flight_wall}
    # 5. fail the leader, re-elect, commit 4 096 more
    old = e.leader_id
    e.fail(old)
    e.run_until_leader()
    res["failover"] = {"failed": old, "new_leader": e.leader_id,
                       "term": int(e.leader_term)}
    lo = e.commit_watermark + 1
    seqs = [e.submit(p) for p in inp.take(ENGINE_AFTER_ENTRIES)]
    e.run_until_committed(seqs[-1])
    reads.append(engine_read_back(e, inp, lo, e.commit_watermark,
                                  "engine after failover"))
    total = ENGINE_TICK_ENTRIES + ENGINE_FLIGHT_ENTRIES + ENGINE_AFTER_ENTRIES
    check(e.commit_watermark == total and applied[0] == total,
          f"engine: commit {e.commit_watermark}, applied {applied[0]}, "
          f"submitted {total}")
    check(h_apply.hexdigest() == inp.h.hexdigest(),
          "engine: the apply stream differs from the input")
    counters = read_counters(dev)
    for k in ("K1", "K2", "K3", "K4"):
        check(counters[k] > 0, f"engine: {k} never launched: {counters}")
    check(counters["K4_flights_run"] == 1,
          f"engine: the turnover flight did not run: {counters}")
    res.update({"entries": total, "commit_watermark": e.commit_watermark,
                "sha256_input": inp.h.hexdigest(),
                "sha256_apply_stream": h_apply.hexdigest(),
                "read_backs": reads, "launches": counters,
                "launches_in_ticks": tick_counts,
                "nodelog": "off (no trace attached)"})
    emit(res)
    return res


# ------------------------------------------------ 5c. the fused engine
FUSED_KS = (8, 32)            # fuse_k of the fused runs (K = 1 beside them)
FUSED_BURST = 8192            # entries per burst: 8 full batches
FUSED_BURSTS = 8              # 65 536 entries
FUSED_TIMED_BURSTS = 6        # the host-clock drain; burst 6 runs under the
#                               HostProfiler, burst 7 under torch.profiler
FUSED_AFTER = 4096            # committed after the leader failover
FUSED_SMALL_CAPACITY = 4096   # the card-vs-CPU run's ring


def fused_config(capacity, fuse_k):
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=256, batch_size=1024,
                      log_capacity=capacity, transport="single",
                      fuse_k=fuse_k)


def host_leaves(state):
    """Every state leaf as a host copy (never a view of a live tensor)."""
    from raft_tpu_torch.core.state import FIELDS

    return {f: getattr(state, f).cpu().numpy().copy() for f in FIELDS}


def fused_outputs(state, infos, esc, ran, halted):
    out = host_leaves(state)
    for f in infos._fields:
        out[f"info.{f}"] = getattr(infos, f).cpu().numpy().copy()
    out["escaped"] = esc.cpu().numpy().copy()
    out["ran"] = ran.cpu().numpy().copy()
    out["halted"] = np.array(bool(halted))
    for k in ("escaped", "ran"):
        check(out[k].dtype == np.int32, f"{k} dtype {out[k].dtype}")
    return out


def same_outputs(a, b, what):
    check(a.keys() == b.keys(), f"{what}: outputs {sorted(a)} vs {sorted(b)}")
    for k in a:
        check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
              f"{what}: {k} differs (graph replay vs the uncaptured loop)")


def fused_graph_vs_loop(cfg, dev, record=False):
    """``SingleDeviceTransport.replicate_fused`` (one replay of the captured
    graph) against ``fused_steady_scan`` run uncaptured on the card, at the
    north star's shape with K = 8 and 32: a full window crossing the ring
    seam, ``n_run < K``, an escape mid-window (a quorum lost after three
    heartbeats), an escape at the first tick (a follower's term raised on
    the device), ``halted0`` set, two launches pipelined, a launch after
    an unbooked escape fed the first launch's device ``halted``, a
    second launch at a size first captured between the two, a launch on
    new ring tensors (recaptured), and the bool and packed member masks.
    Every state leaf, infos, ``escaped``, ``ran`` and ``halted`` must be
    equal. With ``record`` both sides record into event rings of their
    own (``ring=``; the loop with ``record=True``), compared on all four
    ring tensors after every case, and a new event ring recaptures."""
    import torch

    from raft_tpu_torch.core.comm import SingleDeviceComm
    from raft_tpu_torch.core.step import fused_steady_scan
    from raft_tpu_torch.obs.device import init_ring
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    rng = np.random.default_rng(SEED + 60)
    B, C, W, R = (cfg.batch_size, cfg.log_capacity, cfg.shard_words,
                  cfg.rows)
    last = C - 3 * B + 5                       # a window crosses the seam
    base = steady_state(cfg, dev, last, rng=rng)
    gst, lst = base.clone(), base.clone()       # rings kept for the run
    tr = SingleDeviceTransport(cfg, device=dev)
    comm = SingleDeviceComm(R)
    full = np.ones(R, bool)
    lone = np.array([True] + [False] * (R - 1))
    slow = np.zeros(R, bool)
    floor = last - C + 1
    fpt = 1
    cases = []
    rings = [init_ring(4096, dev), init_ring(4096, dev)] if record else None

    def same_rings(what):
        if rings is None:
            return
        for name, a, b in zip(("buf", "count", "tick", "counters"),
                              rings[0].tensors(), rings[1].tensors()):
            check(torch.equal(a, b),
                  f"{what}: the recorded ring's {name} differs (graph "
                  "replay vs the uncaptured loop)")

    def reset(st, term_raise=False):
        from raft_tpu_torch.core.state import FIELDS

        for f in FIELDS:
            getattr(st, f).copy_(getattr(base, f))
        if term_raise:
            st.term[R - 1] = 99

    def launch(st_g, st_l, staging, start, counts, n_run, h_g, h_l, alive,
               member=None, tr=tr, comm=comm, cfg=cfg, slow=slow):
        g = tr.replicate_fused(st_g, staging, start, counts, n_run, h_g, 0,
                               1, alive, slow, member=member,
                               repair_floor=floor, floor_prev_term=fpt,
                               ring=rings[0] if rings else None)
        rec = {"ring": rings[1], "record": True} if rings else {}
        lo = fused_steady_scan(
            comm, cfg.commit_quorum, st_l, staging,
            torch.tensor(start, dtype=torch.int32, device=dev),
            torch.from_numpy(counts).to(dev),
            torch.tensor(n_run, dtype=torch.int32, device=dev),
            h_l if isinstance(h_l, torch.Tensor)
            else torch.tensor(h_l, device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev),
            torch.tensor(1, dtype=torch.int32, device=dev),
            torch.from_numpy(alive).to(dev), torch.from_numpy(slow).to(dev),
            torch.tensor(fpt, dtype=torch.int32, device=dev),
            torch.tensor(floor, dtype=torch.int32, device=dev),
            None if member is None else torch.from_numpy(member).to(dev),
            **rec)
        return g[:5], lo[:5]

    for K in FUSED_KS:
        S = 2 * K
        staging = torch.from_numpy(rng.integers(
            -2**31, 2**31, (S, B, W), dtype=np.int64).astype(np.int32)).to(
                dev)
        start = S - 3                           # windows wrap the staging
        fullc = np.full(K, B, np.int32)
        part = fullc.copy()
        part[K - 4] = B - 100
        mid = fullc.copy()
        mid[:3] = 0
        singles = [("full", fullc, K, False, full, False),
                   ("partial_n_run", part, K - 3, False, full, False),
                   ("escape_mid_window", mid, K, False, lone, False),
                   ("escape_term_raised", fullc, K, False, full, True),
                   ("halted0", fullc, K, True, full, False)]
        for name, counts, n_run, h0, alive, raise_ in singles:
            reset(gst, raise_)
            reset(lst, raise_)
            g, lo = launch(gst, lst, staging, start, counts, n_run, h0, h0,
                           alive)
            a, b = fused_outputs(*g), fused_outputs(*lo)
            same_outputs(a, b, f"K={K} {name}")
            same_rings(f"K={K} {name}")
            cases.append({"K": K, "case": name, "ran": int(b["ran"].sum()),
                          "escaped_at": (int(np.argmax(b["escaped"]))
                                         if b["escaped"].any() else None),
                          "equal": True})
        for name, alive1 in (("pipelined", full),
                             ("pipelined_after_escape", lone)):
            reset(gst)
            reset(lst)
            g1, l1 = launch(gst, lst, staging, start, fullc, K, False,
                            False, alive1)
            g2, l2 = launch(g1[0], l1[0], staging, (start + K) % S, fullc,
                            K, g1[4], l1[4], full)
            # launch 1's outputs are read only after launch 2 replayed
            a1, b1 = fused_outputs(*g1), fused_outputs(*l1)
            a2, b2 = fused_outputs(*g2), fused_outputs(*l2)
            for k in list(a1):
                if "." not in k and k not in ("escaped", "ran", "halted"):
                    del a1[k], b1[k]     # the state: consumed by launch 2
            same_outputs(a1, b1, f"K={K} {name}, launch 1")
            same_outputs(a2, b2, f"K={K} {name}, launch 2")
            same_rings(f"K={K} {name}")
            cases.append({"K": K, "case": name,
                          "ran": [int(b1["ran"].sum()),
                                  int(b2["ran"].sum())], "equal": True})
        # a window's second launch at a size not captured yet: its
        # capture runs between the two launches, and the halted flag the
        # first left must survive the warm-up
        reset(gst)
        reset(lst)
        half = np.full(K // 2, B, np.int32)
        g1, l1 = launch(gst, lst, staging, start, fullc, K, False, False,
                        full)
        g2, l2 = launch(g1[0], l1[0], staging, (start + K) % S, half,
                        K // 2, g1[4], l1[4], full)
        a1, b1 = fused_outputs(*g1), fused_outputs(*l1)
        a2, b2 = fused_outputs(*g2), fused_outputs(*l2)
        same_outputs({k: v for k, v in a1.items() if k in b1
                      and ("." in k or k in ("escaped", "ran", "halted"))},
                     {k: v for k, v in b1.items()
                      if "." in k or k in ("escaped", "ran", "halted")},
                     f"K={K} new size, launch 1")
        same_outputs(a2, b2, f"K={K} new size, launch 2")
        same_rings(f"K={K} new size")
        check(int(b2["ran"].sum()) == K // 2,
              f"K={K}: the second launch did not run")
        cases.append({"K": K, "case": "pipelined_into_a_new_size",
                      "ran": [K, K // 2], "equal": True})
    # new ring tensors (as after a restore): the transport drops its
    # graphs for that shape and captures anew, never copying the ring
    rec0 = tr.graphs.recaptures
    staging = staging[:16].clone()
    g, lo = launch(base.clone(), base.clone(), staging, 3,
                   np.full(8, B, np.int32), 8, False, False, full)
    same_outputs(fused_outputs(*g), fused_outputs(*lo),
                 "K=8 on new rings")
    same_rings("K=8 on new rings")
    check(tr.graphs.recaptures == rec0 + 1,
          f"new rings: {tr.graphs.recaptures - rec0} recaptures")
    cases.append({"K": 8, "case": "recapture_on_new_rings", "ran": 8,
                  "equal": True})
    if rings is not None:
        # a new event ring (a new attachment) on the same state rings
        rings[0], rings[1] = init_ring(64, dev), init_ring(64, dev)
        g, lo = launch(g[0], lo[0], staging, 11, np.full(8, B, np.int32),
                       8, False, False, full)
        same_outputs(fused_outputs(*g), fused_outputs(*lo),
                     "K=8 on a new event ring")
        same_rings("K=8 on a new event ring")
        check(tr.graphs.recaptures == rec0 + 2,
              "a new event ring did not recapture")
        cases.append({"K": 8, "case": "recapture_on_a_new_event_ring",
                      "ran": 8, "equal": True})
    # member modes (the graph key's third part): 3 voters of 5 rows, the
    # voter plane as a bool mask and packed with a learner on row 3
    from raft_tpu_torch.core.state import pack_membership

    mcfg = dataclasses.replace(fused_config(4096, 1), max_replicas=5)
    mtr = SingleDeviceTransport(mcfg, device=dev)
    mbase = steady_state(mcfg, dev, 3 * B + 11, rng=rng)
    floor, fpt = 1, 0
    voters = np.array([True, True, True, False, False])
    learner = np.array([False, False, False, True, False])
    for name, member in (("member_bool", voters),
                         ("member_packed", pack_membership(voters,
                                                           learner))):
        mg, ml = mbase.clone(), mbase.clone()
        stg = staging[:4]
        counts = np.full(8, B, np.int32)
        g, lo = launch(mg, ml, stg, 1, counts, 8, False, False,
                       np.array([True, True, False, True, True]),
                       member=member, tr=mtr, comm=SingleDeviceComm(5),
                       cfg=mcfg, slow=np.zeros(5, bool))
        a, b = fused_outputs(*g), fused_outputs(*lo)
        same_outputs(a, b, f"K=8 {name}")
        same_rings(f"K=8 {name}")
        check(int(b["info.commit_index"][-1]) == 3 * B + 11 + 8 * B,
              f"{name}: the window did not commit")
        cases.append({"K": 8, "case": name, "ran": int(b["ran"].sum()),
                      "equal": True})
    torch.cuda.synchronize()
    g = tr.graphs
    out = {"cases": cases, "graphs_captured": g.captures,
           "replays": g.replays, "recaptures": g.recaptures,
           "shape": {"R": R, "B": B, "C": C, "W": W, "last": last}}
    if rings is not None:
        out["ring"] = {"count": int(rings[0].count),
                       "tick": int(rings[0].tick),
                       "counters": rings[0].counters.tolist()}
    return out


def fused_engine_run(cfg, dev, timed):
    """The fused phase's schedule through ``RaftEngine`` at ``cfg`` on
    ``dev``: an election; 65 536 entries in bursts of 8 192, each drained
    by ``run_for`` and read back (its last C entries when the ring is
    smaller) through ``committed_entries`` and every live follower; idle
    heartbeats; the leader failed, a re-election and 4 096 more. Bursts
    0-5 are timed on the host clock, burst 6 runs under a
    ``HostProfiler``, and with ``timed`` burst 7 under torch.profiler.
    Returns what the K runs and the two devices are compared on, and what
    is recorded."""
    import torch

    from raft_tpu_torch.obs import HostProfiler
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, C = cfg.batch_size, cfg.log_capacity
    hb = cfg.heartbeat_period
    tr = SingleDeviceTransport(cfg, device=dev)
    lines = []
    e = RaftEngine(cfg, tr, trace=lines.append)
    inp = EngineInput(cfg)
    h_apply = hashlib.sha256()
    applied = [0]

    def apply(idx, payload):
        check(idx == applied[0] + 1, "the apply stream skipped an index")
        applied[0] = idx
        h_apply.update(payload)

    e.register_apply(apply)
    windows = [0]
    if e._fused_driver is not None:
        run_window = e._fused_driver._run_window

        def counted_window(*a):
            windows[0] += 1
            return run_window(*a)

        e._fused_driver._run_window = counted_window
    res = {"fuse_k": e.fuse_k, "capacity": C, "device": str(dev)}
    e.run_until_leader()
    reads = []

    def read_back(hi, what):
        lo = max(hi - C + 1, hi - FUSED_BURST + 1, 1)
        reads.append(engine_read_back(e, inp, lo, hi, what))

    wall = 0.0
    ticks = 0
    capture_in_drain = 0.0
    burst_ms = []

    def capture_s():
        return tr.graphs.capture_s if tr.graphs is not None else 0.0

    for b in range(FUSED_BURSTS):
        c0 = capture_s()
        seqs = [e.submit(p) for p in inp.take(FUSED_BURST)]
        t0n, f0, w0 = e._tick_count, e.fused_launches, windows[0]
        if b == FUSED_TIMED_BURSTS:
            e.hostprof = hp = HostProfiler()
        sync()
        t0 = time.perf_counter()
        if b == FUSED_TIMED_BURSTS + 1 and timed:
            events, pwall = _device_events(
                lambda: e.run_for((FUSED_BURST // B + 2) * hb), 1)
        else:
            e.run_for((FUSED_BURST // B + 2) * hb)
        sync()
        dt = time.perf_counter() - t0
        burst_ms.append(dt * 1e3)
        check(e.is_durable(seqs[-1]),
              f"fuse_k={e.fuse_k}: burst {b} did not drain")
        if b < FUSED_TIMED_BURSTS:
            wall += dt
            ticks += e._tick_count - t0n
            capture_in_drain += capture_s() - c0
        elif b == FUSED_TIMED_BURSTS:
            e.hostprof = None
            lt = e._tick_count - t0n
            res["hostprof"] = {
                "leader_ticks": lt, "events": hp.ticks,
                "us_per_leader_tick": {p: s / lt * 1e6 for p, s in
                                       sorted(hp.totals().items())},
                "us_per_event": hp.us_per_tick(),
                "note": "one event is one popped heap entry: a whole "
                        "fused window, or one tick"}
        elif timed:
            launches = e.fused_launches - f0
            wins = windows[0] - w0
            lt = e._tick_count - t0n
            kern = [n for n, _ in events
                    if "emcpy" not in n and "emset" not in n]
            busy = sum(us for _, us in events)
            by_name = {}
            for n, us in events:
                k = kernel_of(n) or ("copy" if "emcpy" in n else "other")
                by_name[k] = by_name.get(k, 0.0) + us
            res["profiled_burst"] = {
                "entries": FUSED_BURST, "leader_ticks": lt,
                "fused_windows": wins, "fused_launches": launches,
                "wall_ms": pwall * 1e3,
                "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / (pwall * 1e6),
                "kernels": len(kern), "device_ops": len(events),
                "kernels_per_leader_tick": len(kern) / max(lt, 1),
                "kernels_per_fused_launch": (len(kern) / launches
                                             if launches else None),
                "kernels_per_fused_window": (len(kern) / wins
                                             if wins else None),
                "device_ms_by_kind": {k: v / 1e3
                                      for k, v in by_name.items()}}
        read_back(e.commit_watermark, f"fuse_k={e.fuse_k} burst {b}")
    res["drain"] = {
        "entries": FUSED_TIMED_BURSTS * FUSED_BURST, "leader_ticks": ticks,
        "wall_s": wall, "entries_per_s_wall": FUSED_TIMED_BURSTS
        * FUSED_BURST / wall, "ms_per_leader_tick": wall / ticks * 1e3,
        "ms_per_leader_tick_without_captures":
            (wall - capture_in_drain) / ticks * 1e3,
        "ms_per_burst": burst_ms,
        "method": "host clock around run_for, synchronized at both ends; "
                  "the drain includes the first captures of the graphs "
                  "its windows need"}
    e.run_for(20 * hb)                           # idle heartbeats
    old = e.leader_id
    e.fail(old)
    e.run_until_leader()
    seqs = [e.submit(p) for p in inp.take(FUSED_AFTER)]
    e.run_for((FUSED_AFTER // B + 4) * hb)
    check(e.is_durable(seqs[-1]),
          f"fuse_k={e.fuse_k}: the entries after the failover did not "
          "commit")
    read_back(e.commit_watermark, f"fuse_k={e.fuse_k} after failover")
    total = FUSED_BURSTS * FUSED_BURST + FUSED_AFTER
    check(e.commit_watermark == total and applied[0] == total,
          f"fuse_k={e.fuse_k}: commit {e.commit_watermark}, applied "
          f"{applied[0]}, submitted {total}")
    check(h_apply.hexdigest() == inp.h.hexdigest(),
          f"fuse_k={e.fuse_k}: the apply stream differs from the input")
    sync()
    res.update({
        "failover": {"failed": old, "new_leader": e.leader_id,
                     "term": int(e.leader_term)},
        "fused_windows": windows[0], "fused_launches": e.fused_launches,
        "fused_ticks": e.fused_ticks, "leader_ticks": e._tick_count,
        "nodelog_lines": len(lines),
        "sha256_apply_stream": h_apply.hexdigest(), "read_backs": len(reads),
    })
    if tr.graphs is not None:
        res["graphs"] = {"captured": tr.graphs.captures,
                         "replays": tr.graphs.replays,
                         "recaptures": tr.graphs.recaptures,
                         "k1_launches": tr.graphs.k1_launches,
                         "capture_s": tr.graphs.capture_s,
                         "capture_s_in_drain": capture_in_drain}
    keep = {"lines": lines, "commit_time": dict(e.commit_time),
            "terms": e.terms.tolist(), "roles": list(e.roles),
            "state": host_leaves(e.state), "reads": reads}
    return res, keep


def same_runs(a, b, what):
    """Two runs of the schedule: equal nodelog lines, commit stamps, terms,
    roles, state leaves and read-backs."""
    check(a["lines"] == b["lines"], f"{what}: nodelog lines differ")
    check(a["commit_time"] == b["commit_time"],
          f"{what}: commit stamps differ")
    check(a["terms"] == b["terms"] and a["roles"] == b["roles"],
          f"{what}: terms or roles differ")
    for f in a["state"]:
        check(np.array_equal(a["state"][f], b["state"][f]),
              f"{what}: state.{f} differs")
    check(a["reads"] == b["reads"], f"{what}: read-backs differ")


def phase_engine_fused_path(dev):
    """K-tick fusion through ``RaftEngine`` on the card: the graph against
    the uncaptured loop (``fused_graph_vs_loop``); the north star's
    deployment at C = 32 768 with ``fuse_k`` 1, 8 and 32 on one schedule
    (``fused_engine_run``: every burst read back, the apply stream equal
    to the input's, and the K > 1 runs equal to K = 1's in nodelog lines,
    commit stamps, terms, state and read-backs, with fused launches); the
    same schedule at C = 4 096 and ``fuse_k`` 8 on the card and on the
    CPU, equal. Recorded, not gated: ms per leader tick and entries/s of
    the drain per K, a profiled burst (device busy, idle share, kernels
    per launch), the graphs captured and replayed, and the HostProfiler's
    phases per leader tick."""
    import torch

    t_phase = time.perf_counter()
    res = {"phase": "engine_fused_path"}
    res["graph_vs_loop"] = fused_graph_vs_loop(fused_config(
        STEPS_PER_FLIGHT * 1024, 1), dev)
    zero_counters(dev)
    runs, keeps = {}, {}
    for k in (1,) + FUSED_KS:
        runs[k], keeps[k] = fused_engine_run(
            fused_config(STEPS_PER_FLIGHT * 1024, k), dev, timed=True)
    res["launches"] = read_counters(dev)
    for k in FUSED_KS:
        same_runs(keeps[1], keeps[k], f"fuse_k={k} against fuse_k=1")
        check(runs[k]["fused_launches"] > 0,
              f"fuse_k={k}: no fused launch")
        check(runs[k]["graphs"]["k1_launches"] > 0,
              f"fuse_k={k}: no K1 launch from a graph replay")
    check(runs[1]["fused_launches"] == 0, "fuse_k=1 fused")
    res["runs"] = {str(k): v for k, v in runs.items()}
    res["fused_k1_launches"] = sum(runs[k]["graphs"]["k1_launches"]
                                   for k in FUSED_KS)
    zero_counters(dev)
    small = fused_config(FUSED_SMALL_CAPACITY, 8)
    t0 = time.perf_counter()
    card, card_keep = fused_engine_run(small, dev, timed=False)
    t1 = time.perf_counter()
    res["card_equals_cpu_launches"] = read_counters(dev)
    cpu, cpu_keep = fused_engine_run(small, "cpu", timed=False)
    t2 = time.perf_counter()
    same_runs(card_keep, cpu_keep, "C = 4 096, fuse_k = 8: card vs CPU")
    check(card["fused_launches"] == cpu["fused_launches"] > 0
          and card["fused_ticks"] == cpu["fused_ticks"],
          "card vs CPU: fused launches or ticks differ")
    res["card_equals_cpu"] = {
        "capacity": FUSED_SMALL_CAPACITY, "fuse_k": 8, "equal": True,
        "fused_launches": card["fused_launches"],
        "fused_ticks": card["fused_ticks"],
        "nodelog_lines": card["nodelog_lines"],
        "card_s": t1 - t0, "cpu_s": t2 - t1}
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ------------------------------------ 5c'. the engine with the obs plane
#: ``engine_obs_path``'s schedule: 64 full leader ticks in bursts of 8 192
#: drained by ``run_for``, one ``submit_pipelined`` ring, a failover and
#: 4 096 more entries (``engine_main_path``'s deployment and schedule)
OBS_PLAN = dict(bursts=8, burst=8192, after=4096)
OBS_PROFILED_BURST = 2        # the burst run under torch.profiler
OBS_SMALL_CAPACITY = 4096     # obs_card_equals_cpu's ring
OBS_SCRAPE_PATHS = ("/status", "/metrics", "/slo", "/healthz")


def obs_plane(cfg):
    """The plane ``engine_obs_path`` attaches: an ``ObsStack`` with the
    safety auditor and one commit objective, and a status board."""
    from raft_tpu_torch.obs import ObsStack, SLObjective, StatusBoard

    stack = ObsStack.build(audit=True, slo_objectives=(
        SLObjective("commit_fast", "commit",
                    threshold_s=2 * cfg.heartbeat_period, target=0.99),))
    return stack, StatusBoard()


class Scraper:
    """A client thread that GETs the ops endpoints in a loop while the
    engine runs on the main thread; every answer is kept."""

    def __init__(self, port):
        import threading

        self.port = port
        self.answers = []             # (path, status, body)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def get(self, path):
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}{path}", timeout=30) as r:
                return r.status, r.read().decode()
        except urllib.error.HTTPError as ex:
            return ex.code, ex.read().decode()

    def _loop(self):
        while not self._stop.is_set():
            for path in OBS_SCRAPE_PATHS:
                self.answers.append((path, *self.get(path)))
            self._stop.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)


def span_table_sha(spans):
    """SHA-256 of the span table: every field and annotation of every
    span in order (the fields ``Span.to_jsonable`` dumps)."""
    h = hashlib.sha256()
    for sp in spans.spans:
        h.update(json.dumps(
            [sp.trace_id, sp.op, sp.t_start, sp.t_end, sp.state, sp.seq,
             sp.ticket, sp.queue_delay_s, sp.replication_rounds,
             sp.read_class, sp.refusal_reasons, sp.annotations],
            default=repr).encode())
    return h.hexdigest()


def audit_digest_from_bytes(e, inp, max_entries):
    """The auditor's committed-prefix CRC (``SafetyAuditor.commit_digest``)
    recomputed from the input bytes the read-backs matched and the
    archive's terms, over the archive's retention horizon."""
    import zlib

    wm = e.commit_watermark
    crc = zlib.crc32(f"wm:{wm}".encode())
    lo = max(1, wm - max_entries + 1)
    whole = inp.window(lo, wm)
    E = e.cfg.entry_bytes
    for i, idx in enumerate(range(lo, wm + 1)):
        term = e.store.get(idx)[1]
        pc = zlib.crc32(whole[i * E:(i + 1) * E]) & 0xFFFFFFFF
        crc = zlib.crc32(f"{idx}:{term}:{pc:08x}".encode(), crc)
    return f"{crc:08x}"


def obs_engine_run(cfg, dev, mode, plan=OBS_PLAN, serve=False,
                   profile=False):
    """``engine_obs_path``'s schedule through ``RaftEngine`` at ``cfg`` on
    ``dev``: an election; ``plan["bursts"]`` bursts of ``plan["burst"]``
    entries, each drained by ``run_for`` (full leader ticks; fused windows
    at ``fuse_k`` > 1) and read back; one ``submit_pipelined`` ring that
    the gate must admit (one flight); the leader failed, a re-election and
    ``plan["after"]`` more. ``mode``: "detached" (nothing attached),
    "plane" (spans, metrics, auditor, SLO and board, no recorder, no
    trace) or "full" (the plane, a flight recorder and a trace). Every
    submit opens a span of its own when spans are attached. ``serve``
    runs an ``OpsServer`` scraped from a thread during the run;
    ``profile`` counts the device-to-host copies of one burst under
    torch.profiler. Returns (recorded values, what runs are compared on,
    the plane)."""
    import torch

    from raft_tpu_torch.obs import OpsServer, parse_prometheus
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, C = cfg.batch_size, cfg.log_capacity
    hb = cfg.heartbeat_period
    tr = SingleDeviceTransport(cfg, device=dev)
    flights = []
    run_flight = tr.replicate_pipeline

    def counted_flight(*a, **k):
        flights.append(int(a[2].shape[0]))
        return run_flight(*a, **k)

    tr.replicate_pipeline = counted_flight
    stack = board = None
    lines = [] if mode == "full" else None
    if mode != "detached":
        stack, board = obs_plane(cfg)
    e = RaftEngine(cfg, tr, trace=lines.append if lines is not None else None,
                   recorder=stack.recorder if mode == "full" else None)
    if stack is not None:
        stack.attach(e)
        e.status_board = board
        if mode == "plane":
            e.recorder = None
    published = {}
    if serve:
        publish = board.publish

        def keep_publish(snapshot, section="engine"):
            publish(snapshot, section)
            # snapshot text -> the first generation that published it
            text = json.dumps(snapshot, sort_keys=True)
            published.setdefault(text, board.generation)
            published[None] = text

        board.publish = keep_publish
    # device fetches: the engine's _fetch calls inside its events
    fetch = e._fetch
    counts = {"fetches": 0, "in_events": 0}

    def counted_fetch(x):
        counts["fetches"] += 1
        return fetch(x)

    e._fetch = counted_fetch
    step = e.step_event
    per_tick_ms = []

    def timed_step(horizon=None):
        t0n, f0 = e._tick_count, counts["fetches"]
        t0 = time.perf_counter()
        got = step(horizon)
        dt = time.perf_counter() - t0
        counts["in_events"] += counts["fetches"] - f0
        if e._tick_count > t0n:
            per_tick_ms.append(dt * 1e3 / (e._tick_count - t0n))
        return got

    e.step_event = timed_step
    inp = EngineInput(cfg)
    h_apply = hashlib.sha256()
    applied = [0]

    def apply(idx, payload):
        check(idx == applied[0] + 1, "the apply stream skipped an index")
        applied[0] = idx
        h_apply.update(payload)

    e.register_apply(apply)
    spans = stack.spans if stack is not None else None
    tick_seqs = []

    def submit_all(ps, ticked):
        seqs = []
        for p in ps:
            if spans is not None:
                spans.current = spans.begin("write", e.clock.now)
            seqs.append(e.submit(p))
        if spans is not None:
            spans.current = None
        if ticked:
            tick_seqs.extend(seqs)
        return seqs

    what = f"obs {mode} fuse_k={e.fuse_k} on {dev}"
    res = {"mode": mode, "fuse_k": e.fuse_k, "capacity": C,
           "device": str(dev)}
    srv = scraper = None
    if serve:
        srv = OpsServer(board=board, registry=stack.registry, slo=stack.slo,
                        auditor=stack.audit, spans=spans, port=0)
        srv.start()
        scraper = Scraper(srv.port).__enter__()
    reads = []
    try:
        sync()
        t_run = time.perf_counter()
        e.run_until_leader()
        for b in range(plan["bursts"]):
            seqs = submit_all(inp.take(plan["burst"]), True)
            drain = (plan["burst"] // B + 2) * hb
            if profile and b == OBS_PROFILED_BURST:
                t0n, f0 = e._tick_count, counts["fetches"]
                events, _ = _device_events(lambda: e.run_for(drain), 1)
                lt = e._tick_count - t0n
                dtoh = sum(1 for n, _ in events if "DtoH" in n)
                res["profiled_burst"] = {
                    "leader_ticks": lt, "dtoh_copies": dtoh,
                    "dtoh_per_leader_tick": dtoh / lt,
                    "fetches": counts["fetches"] - f0,
                    "fetches_per_leader_tick":
                        (counts["fetches"] - f0) / lt}
            else:
                e.run_for(drain)
            check(e.is_durable(seqs[-1]), f"{what}: burst {b} did not drain")
        sync()
        ticks_wall = time.perf_counter() - t_run
        tick_ticks = e._tick_count
        reads.append(engine_read_back(e, inp, max(1, e.commit_watermark
                                                  - C + 1),
                                      e.commit_watermark, f"{what} ticks"))
        # one ring through submit_pipelined: the entries are submitted
        # first (each in its span), then the chunk takes the queue
        leader_last = e.commit_watermark
        submit_all(inp.take(C), False)
        e.submit_pipelined([])
        check(flights == [C // B],
              f"{what}: the pipeline gate did not admit the ring: {flights}")
        check(e.commit_watermark == leader_last + C,
              f"{what}: the flight committed {e.commit_watermark}")
        reads.append(engine_read_back(e, inp, leader_last + 1,
                                      e.commit_watermark, f"{what} flight"))
        old = e.leader_id
        e.fail(old)
        e.run_until_leader()
        lo = e.commit_watermark + 1
        seqs = submit_all(inp.take(plan["after"]), True)
        e.run_for((plan["after"] // B + 4) * hb)
        check(e.is_durable(seqs[-1]),
              f"{what}: the entries after the failover did not commit")
        reads.append(engine_read_back(e, inp, lo, e.commit_watermark,
                                      f"{what} after failover"))
        sync()
        run_wall = time.perf_counter() - t_run
    finally:
        if scraper is not None:
            scraper.__exit__()
    total = plan["bursts"] * plan["burst"] + C + plan["after"]
    check(e.commit_watermark == total and applied[0] == total,
          f"{what}: commit {e.commit_watermark}, applied {applied[0]}, "
          f"submitted {total}")
    check(h_apply.hexdigest() == inp.h.hexdigest(),
          f"{what}: the apply stream differs from the input")
    lt = e._tick_count
    res.update({
        "leader_ticks": lt, "leader_ticks_in_bursts": tick_ticks,
        "fused_launches": e.fused_launches, "fused_ticks": e.fused_ticks,
        "ms_per_leader_tick_p50": float(np.percentile(per_tick_ms, 50)),
        "ms_per_leader_tick_p99": float(np.percentile(per_tick_ms, 99)),
        "ms_per_leader_tick_mean_bursts": ticks_wall * 1e3 / tick_ticks,
        "tick_samples": len(per_tick_ms),
        "timing": "host clock around each step_event, divided by the "
                  "leader ticks it fired (a fused window is one sample)",
        "run_wall_s": run_wall, "fetches": counts["fetches"],
        "fetches_in_events": counts["in_events"],
        "fetches_per_leader_tick": counts["in_events"] / lt})
    keep = {"reads": reads, "apply_sha256": h_apply.hexdigest(),
            "commit_watermark": e.commit_watermark,
            "fetches_in_events": counts["in_events"],
            "terms": e.terms.tolist(),
            "commit_time": dict(e.commit_time)}
    if stack is None:
        return res, keep, None
    # the plane's own checks
    rec, reg, aud, slo = stack.recorder, stack.registry, stack.audit, \
        stack.slo
    n_spans = len(spans.spans)
    check(n_spans == total, f"{what}: {n_spans} spans for {total} submits")
    ticked = set(tick_seqs)
    for sp in spans.spans:
        names = {a[1] for a in sp.annotations}
        check("committed" in names, f"{what}: seq {sp.seq} not committed "
                                    "in its span")
        # the pipelined chunk books no ingest and so no apply annotation,
        # in the JAX engine as here
        check(sp.seq not in ticked or "applied" in names,
              f"{what}: seq {sp.seq} not applied in its span")
    check(aud.total_violations == 0,
          f"{what}: {aud.total_violations} audit violations")
    digest = aud.commit_digest()
    check(digest == audit_digest_from_bytes(e, inp, e.store.max_entries),
          f"{what}: the auditor's commit digest differs from the one of "
          "the read-back bytes")
    text = reg.to_prometheus()
    parsed = parse_prometheus(text)
    snap = reg.snapshot()
    for name, m in snap.items():
        if m["type"] in ("counter", "gauge"):
            for s in m["series"]:
                key = tuple(sorted((k, str(v)) for k, v in
                                   s["labels"].items()))
                check(parsed[name][key] == s["value"],
                      f"{what}: {name}{key} does not round-trip")
    check(parsed["raft_commits_total"][(("group", "0"),)] == e.committed_total
          == total, f"{what}: raft_commits_total differs from "
                    "committed_total")
    status = e._status_snapshot()
    json.dumps(status)
    keep.update({
        "spans_sha256": span_table_sha(spans), "prometheus": text,
        "audit_summary": aud.summary(), "commit_digest": digest,
        "slo": slo.snapshot(), "status": status})
    res.update({"spans": n_spans, "spans_per_leader_tick": n_spans / lt,
                "commit_digest": digest,
                "audit_violations": aud.total_violations})
    if mode == "full":
        check(rec.nodelog_lines() == lines,
              f"{what}: the recorder's nodelog lines differ from the trace")
        keep["events_sha256"] = hashlib.sha256(json.dumps(
            rec.to_jsonable()).encode()).hexdigest()
        keep["lines"] = lines
        res.update({"events": rec.total_recorded,
                    "events_per_leader_tick": rec.total_recorded / lt,
                    "nodelog_lines": len(lines),
                    "leaders_by_term": {str(t): sorted(v) for t, v in
                                        rec.leaders_by_term().items()}})
    if serve:
        answers = scraper.answers
        check(answers, f"{what}: no endpoint answered during the run")
        for path, status_code, body in answers:
            check(status_code == 200, f"{what}: GET {path} -> {status_code}")
            if path == "/status":
                got = json.loads(body)
                gen = got.pop("board_generation")
                # a snapshot the board published (compose() reads the
                # generation after the sections, so publishes landing in
                # between leave it behind the generation, never ahead by
                # more than the one being published)
                if gen == 0:
                    # nothing published yet: the server adds the live
                    # auditor's summary to the empty board
                    got.pop("audit", None)
                g = published.get(json.dumps(got, sort_keys=True))
                check(got == {} or (g is not None and g <= gen + 1),
                      f"{what}: /status answered a snapshot the board "
                      f"never published (generation {gen})")
            elif path == "/healthz":
                got = json.loads(body)
                check(got["status"] == "ok" and set(got) == {
                    "status", "t_virtual", "generation"},
                    f"{what}: /healthz answered {got}")
            elif path == "/metrics":
                parse_prometheus(body)
            else:
                check(set(json.loads(body)) >= {"objectives", "digests"},
                      f"{what}: /slo answered {body[:80]}")
        walls = {}
        for path in ("/status", "/metrics"):
            t0 = time.perf_counter()
            code, body = scraper.get(path)
            walls[path] = (time.perf_counter() - t0) * 1e3
            check(code == 200, f"{what}: GET {path} after the run")
        final = json.loads(scraper.get("/status")[1])
        check(final.pop("board_generation") == board.generation
              and json.dumps(final, sort_keys=True) == published[None],
              f"{what}: the final /status is not the last snapshot")
        srv.stop()
        res["ops"] = {
            "answers_during_run": len(answers),
            "by_path": {p: sum(1 for a in answers if a[0] == p)
                        for p in OBS_SCRAPE_PATHS},
            "status_request_ms": walls["/status"],
            "metrics_request_ms": walls["/metrics"],
            "metrics_bytes": len(body), "board_generation":
                board.generation}
    return res, keep, stack


def obs_bundle(e_cfg, stack, tmpdir):
    """A repro bundle of ``stack`` through ``write_bundle``, explained by
    ``python -m raft_tpu_torch.obs --explain`` in a process of its own:
    the explanation must name the last leader of every term."""
    import os

    from raft_tpu_torch.obs import write_bundle

    t0 = time.perf_counter()
    path = write_bundle(tmpdir, kind="engine_obs", seed=SEED,
                        expected="LINEARIZABLE", verdict="LINEARIZABLE",
                        config=e_cfg, obs=stack)
    write_s = time.perf_counter() - t0
    env = dict(os.environ, PYTHONPATH=str(HERE))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "raft_tpu_torch.obs",
                          "--explain", path], capture_output=True,
                         text=True, timeout=300, cwd=str(HERE), env=env)
    explain_s = time.perf_counter() - t0
    check(out.returncode == 0, f"--explain failed: {out.stderr[-2000:]}")
    named = {}
    for term, ev in stack.recorder.last_leader_per_term().items():
        check(f"term {term}: {ev.node} " in out.stdout,
              f"--explain does not name {ev.node} as term {term}'s leader")
        named[str(term)] = ev.node
    return {"bytes": os.path.getsize(path), "write_s": write_s,
            "explain_s": explain_s, "last_leader_per_term": named,
            "explain_lines": len(out.stdout.splitlines())}


def phase_engine_obs_path(dev):
    """The observed engine at the north star's deployment (3 replicas,
    256-byte entries, B = 1024, C = 32 768): ``obs_engine_run``'s schedule
    at ``fuse_k`` 1 and 8, each detached, with the plane but no recorder
    or trace, and with the full plane (recorder, trace, an ``OpsServer``
    scraped from a thread during the run). Exact checks: the recorder's
    nodelog lines equal the trace; read-backs and the apply stream equal
    the detached run's; every span committed (and applied, off the
    pipelined chunk); no audit violation and the auditor's digest equal
    to the read-back bytes'; the Prometheus text round-trips with
    ``raft_commits_total`` = ``committed_total``; every answer of the
    server 200 and the board's snapshot; at ``fuse_k`` 8 the recorder
    dump, span table, metrics text and auditor summary (apart from its
    count of audited events) equal ``fuse_k`` 1's; a bundle explained by
    the CLI names every term's last leader; and the device fetches of
    the plane-attached run equal the detached run's, by ``_fetch`` and by
    the profiler's device-to-host copies. Recorded: ms per leader tick
    (p50, p99) detached and attached, fetches and copies per leader tick
    with and without a recorder, events and spans per leader tick, one
    ``/status`` and one ``/metrics`` request, the bundle's size and
    write time."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    res = {"phase": "engine_obs_path", "plan": OBS_PLAN}
    zero_counters(dev)
    keeps = {}
    for k in (1, 8):
        cfg = fused_config(STEPS_PER_FLIGHT * 1024, k)
        runs = {}
        for mode in ("detached", "plane", "full"):
            runs[mode], keeps[(k, mode)], stack = obs_engine_run(
                cfg, dev, mode, serve=(mode == "full"),
                profile=(mode != "full" or k == 1))
            if mode == "full" and k == 8:
                with tempfile.TemporaryDirectory() as tmp:
                    res["bundle"] = obs_bundle(cfg, stack, tmp)
            stack = None
        d, p, f = (keeps[(k, m)] for m in ("detached", "plane", "full"))
        for m, kp in (("plane", p), ("full", f)):
            for key in ("reads", "apply_sha256", "commit_watermark",
                        "terms", "commit_time"):
                check(kp[key] == d[key],
                      f"fuse_k={k}: {m} run's {key} differs from the "
                      "detached run's")
        check(p["fetches_in_events"] == d["fetches_in_events"],
              f"fuse_k={k}: the attached plane fetched "
              f"{p['fetches_in_events']} times, detached "
              f"{d['fetches_in_events']}")
        check(runs["plane"]["profiled_burst"]["dtoh_copies"]
              == runs["detached"]["profiled_burst"]["dtoh_copies"],
              f"fuse_k={k}: the attached plane's device-to-host copies "
              "differ from the detached run's")
        for key in ("spans_sha256", "prometheus", "audit_summary",
                    "commit_digest", "slo", "status"):
            check(p[key] == f[key], f"fuse_k={k}: {key} differs between "
                                    "the plane and the full run")
        res[f"fuse_k={k}"] = runs
    a, b = keeps[(1, "full")], keeps[(8, "full")]
    check(b["lines"] == a["lines"], "fuse_k=8: nodelog lines differ")
    for key in ("events_sha256", "spans_sha256", "prometheus",
                "commit_digest", "reads", "apply_sha256"):
        check(b[key] == a[key], f"fuse_k=8: {key} differs from fuse_k=1's")
    sa, sb = dict(a["audit_summary"]), dict(b["audit_summary"])
    res["ticks_audited"] = {"fuse_k=1": sa.pop("ticks_audited"),
                            "fuse_k=8": sb.pop("ticks_audited")}
    check(sa == sb, "fuse_k=8: the auditor's summary differs from fuse_k=1's")
    check(res["fuse_k=8"]["full"]["fused_launches"] > 0,
          "fuse_k=8: no fused launch")
    res["launches"] = read_counters(dev)
    for key in ("K1", "K2", "K3", "K4"):
        check(res["launches"][key] > 0,
              f"engine_obs_path: {key} never launched")
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


def phase_obs_card_equals_cpu(dev):
    """``obs_engine_run`` with the full plane at a 4 096-slot ring and
    ``fuse_k`` 8 on the card and on the CPU (the CPU's flight gate
    opened, so both fly the same ring): the recorder dumps, nodelog
    lines, span tables, Prometheus text, auditor summaries, SLO and
    status snapshots, read-backs and apply streams must be equal."""
    import raft_tpu_torch.raft.engine as engine_mod

    t_phase = time.perf_counter()
    cfg = fused_config(OBS_SMALL_CAPACITY, 8)
    keeps, walls, runs = {}, {}, {}
    zero_counters(dev)
    counters = None
    for where in (dev, "cpu"):
        hook = engine_mod._pipeline_backend_ok
        if where == "cpu":
            engine_mod._pipeline_backend_ok = lambda *a: True
        try:
            t0 = time.perf_counter()
            runs[str(where)], keeps[str(where)], _ = obs_engine_run(
                cfg, where, "full")
            walls[str(where)] = time.perf_counter() - t0
        finally:
            engine_mod._pipeline_backend_ok = hook
        if where == dev:
            counters = read_counters(dev)
    card, cpu = keeps[str(dev)], keeps["cpu"]
    equal = sorted(k for k in card if k != "fetches_in_events")
    for key in equal:
        check(card[key] == cpu[key], f"obs card vs CPU: {key} differs")
    check(runs[str(dev)]["fused_launches"] == runs["cpu"]["fused_launches"]
          > 0, "obs card vs CPU: fused launches differ")
    for key in ("K1", "K3", "K4"):
        # K1 in the ticks and the fused graphs, K3's plan and K4's writes
        # in the flight (every steady tick of this run is fused)
        check(counters[key] > 0, f"obs card run: {key} never launched")
    emit({"phase": "obs_card_equals_cpu", "capacity": OBS_SMALL_CAPACITY,
          "fuse_k": 8, "equal": equal,
          "events": runs[str(dev)]["events"],
          "spans": runs[str(dev)]["spans"],
          "leader_ticks": runs[str(dev)]["leader_ticks"],
          "fused_launches": runs[str(dev)]["fused_launches"],
          "launches_card": counters, "walls_s": walls,
          "phase_s": time.perf_counter() - t_phase})
    return {"launches": counters}


def phase_config5_storm(dev):
    """BASELINE config 5 (``bench.py`` ``bench_storm``, both variants)
    through the port's engine on the card, then the same storm through it
    on the CPU: the trace lines, terms, commit latencies, committed bytes
    and state must be equal, which holds K1 and K2 inside the engine
    against their plain versions. Prints ``bench_storm_once``'s fields
    (virtual-clock figures, deterministic per seed) and the storm's host
    wall on the card."""
    import torch

    from raft_tpu_torch.core.state import state_to_numpy
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.storm import storm, storm_config
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    def runner(device):
        tr = SingleDeviceTransport(storm_config(2, False), device=device)
        return lambda seed, prevote, trace: RaftEngine(
            storm_config(seed, prevote), tr, trace=trace)

    zero_counters(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = storm(runner(dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = read_counters(dev)
    t0 = time.perf_counter()
    host = storm(runner("cpu"))
    host_wall = time.perf_counter() - t0
    variants = {}
    for name, c, h in (("reference_dynamics", card, host),
                       ("prevote_checkquorum", card["hardened_run"],
                        host["hardened_run"])):
        ce, he = c["engine"], h["engine"]
        check(c["trace"] == h["trace"], f"config 5 {name}: the card's "
              "nodelog lines differ from the CPU's")
        check(np.array_equal(ce.terms, he.terms)
              and np.array_equal(ce.commit_latencies(),
                                 he.commit_latencies())
              and c["apply_sha256"] == h["apply_sha256"]
              and c["ring_read_sha256"] == h["ring_read_sha256"],
              f"config 5 {name}: the card's run differs from the CPU's")
        cs, hs = state_to_numpy(ce.state), state_to_numpy(he.state)
        check(all(np.array_equal(cs[f], hs[f]) for f in cs),
              f"config 5 {name}: the card's state differs from the CPU's")
        check(c["committed"] > 0, f"config 5 {name}: nothing committed")
        variants[name] = {"nodelog_lines": len(c["trace"]),
                          "terms": [int(x) for x in ce.terms]}
    check(counters["K1"] > 0 and counters["K2"] > 0,
          f"config 5: K1 and K2 must both launch: {counters}")
    fields = {k: v for k, v in card.items()
              if k not in ("engine", "trace", "hardened_run")}
    emit({"phase": "config5_storm", "bench_storm": fields,
          "card_equals_cpu": variants, "launches": counters,
          "wall_s_card": wall, "wall_s_cpu": host_wall,
          "note": "virtual-clock figures are deterministic per seed; the "
                  "walls are host clocks"})
    return {"launches": counters}


# ------------------------------------- the erasure-coded engine (A9b, A9e)
#: entries per step of ``ec_engine_run``: BASELINE config 3's ring at full
#: depth, and the same steps cut to a 4 096-slot ring for the card-equals-
#: CPU run (each step's count a multiple of 256, so every flight starts
#: on a block-aligned tail)
EC_ENGINE_STEPS = {
    "full": dict(capacity=1 << 15, ticks=65536, flight=32768, degraded=8192,
                 suffix=2048, lapped_ticks=8192, lapped_flight=32768,
                 after_failover=4096, after_restore=4096),
    "reduced": dict(capacity=4096, ticks=2048, flight=4096, degraded=1024,
                    suffix=512, lapped_ticks=1024, lapped_flight=4096,
                    after_failover=1024, after_restore=1024),
}


def ec_engine_config(capacity):
    """BASELINE config 3 (``ec_config``) with a ring of ``capacity``."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=5, entry_bytes=264, batch_size=1024,
                      log_capacity=capacity, rs_k=3, rs_m=2,
                      transport="single")


def read_engine_ec_counters(dev):
    from raft_tpu_torch.ec import kernels as ek

    out = read_counters(dev)
    out.update({"K6 encode": ek.LAUNCHES["encode"],
                "K6 decode": ek.LAUNCHES["decode"],
                "K7": ek.LAUNCHES["encode_fold"]})
    return out


def shard_columns_match(e, inp, what):
    """Every live row's shard column over the newest window its ring
    holds equals that row of a fresh K6 encode of the input's bytes."""
    import torch

    from raft_tpu_torch.ec.kernels import encode_device
    from raft_tpu_torch.ec.reconstruct import gather_shard_window

    hi = e.commit_watermark
    live = [r for r in range(e.cfg.rows) if e.alive[r]]
    lo = max([hi - e.state.capacity + 1, 1]
             + [int(e._ring_floor[r]) for r in live])
    data = np.frombuffer(inp.window(lo, hi), np.uint8).reshape(-1,
                                                               inp.E)
    fresh = encode_device(e._code, torch.from_numpy(data.copy()).to(
        e.state.device))
    for r in live:
        got = gather_shard_window(e.state, [r], lo, hi)[0]
        check(torch.equal(got, fresh[r]),
              f"{what}: row {r}'s shard column of [{lo}, {hi}] differs "
              "from a fresh encode of the input")
    return {"lo": lo, "hi": hi, "rows": live}


def ec_engine_run(cfg, dev, steps, tmp, timed):
    """BASELINE config 3 through ``RaftEngine`` (RS(5,3), 264-byte
    entries, B = 1024) on ``dev`` with a vote log, in seven steps:

    1. an election, then ``ticks`` entries through full leader ticks (K7
       encodes each batch, K2 replicates it at the EC quorum of 4);
    2. one ``submit_pipelined`` chunk of one ring the gate admits (K7,
       then one K4 flight: every row accepts);
    3. a data row failed and ``degraded`` entries committed at 4 of 5,
       read back through ``committed_entries`` (K6 decodes the ring);
    4. a second row made slow (3 acks: commit blocks) under ``suffix``
       uncommitted entries, then the failed row recovered: ``_ec_heal``
       heals it by reconstruction (K6 decode, K6 encode, install) and
       re-serves the suffix (K6 encode), and commit resumes; the slow row
       is released and healed too;
    5. the second row failed, more than one ring committed past it
       (``lapped_ticks`` through ticks, then a ring as one K3 flight with
       the dead row), the row recovered: the heal refuses (every donor
       ring lapped it) and the snapshot stream installs it chunk by chunk
       (K6 encode per chunk) until its match reaches the watermark;
    6. the leader failed, a re-election, ``after_failover`` entries;
    7. ``save_checkpoint``, a forced candidacy after it (a vote the log
       must carry), the process dropped, ``RaftEngine.restore`` on a
       fresh transport with the same vote log (K6 encodes the ring's
       tail once), an election and ``after_restore`` entries.

    Every committed window is read back through ``committed_entries``
    and must hash to the input's; the shard columns of every live row
    must equal a fresh K6 encode after steps 5 and 7; the apply stream
    over both engines must hash to the input's; the restored terms and
    votedFor must equal the checkpoint merged with the vote log, and the
    pre-crash engine's. ``timed`` adds the host-clock rate, CUDA events
    per leader tick and a profiled window of steady EC ticks (card
    only). Returns (result, fingerprint), the fingerprint being what the
    card-equals-CPU comparison holds equal."""
    import os

    import torch

    from raft_tpu_torch.ckpt import EngineCheckpoint, merge_restored
    from raft_tpu_torch.core.state import state_to_numpy
    from raft_tpu_torch.obs import profiling
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    B = cfg.batch_size
    C = cfg.log_capacity
    vote_log = os.path.join(tmp, "votes.log")
    ck_path = os.path.join(tmp, "cluster.npz")
    tr = SingleDeviceTransport(cfg, device=dev)
    flights = []
    run_flight = tr.replicate_pipeline

    def counted_flight(*a, **k):
        flights.append(int(a[2].shape[0]))
        return run_flight(*a, **k)

    tr.replicate_pipeline = counted_flight
    lines = []
    e = RaftEngine(cfg, tr, trace=lines.append, vote_log=vote_log)
    inp = EngineInput(cfg)
    h_apply = hashlib.sha256()
    applied = [0]

    def apply(idx, payload):
        check(idx == applied[0] + 1, "the apply stream skipped an index")
        applied[0] = idx
        h_apply.update(payload)

    e.register_apply(apply)
    res = {"n_replicas": cfg.n_replicas, "entry_bytes": cfg.entry_bytes,
           "rs": [cfg.rows, cfg.rs_k], "commit_quorum": cfg.commit_quorum,
           "batch": B, "capacity": C, "device": str(dev), "steps": steps}
    reads = []
    walls = {}

    def read_back(e, lo, what):
        hi = e.commit_watermark
        got = hashlib.sha256(e.committed_entries(lo, hi).tobytes())
        want = hashlib.sha256(inp.window(lo, hi)).hexdigest()
        check(got.hexdigest() == want,
              f"{what}: committed_entries of [{lo}, {hi}] differ from the "
              "input")
        reads.append({"what": what, "lo": lo, "hi": hi, "sha256": want})

    def commit(e, n, what, heartbeats=0):
        lo = e.commit_watermark + 1
        seqs = [e.submit(p) for p in inp.take(n)]
        e.run_until_committed(seqs[-1])
        if heartbeats:
            e.run_for(heartbeats * cfg.heartbeat_period)
        check(e.commit_watermark == lo - 1 + n,
              f"{what}: commit {e.commit_watermark}, want {lo - 1 + n}")
        read_back(e, lo, what)

    def heal_lines(r, msg, since):
        return [ln for ln in lines[since:]
                if ln.startswith(f"[Server{r}:") and msg in ln]

    def other_row(cands, *not_rows):
        return next(r for r in cands
                    if r != e.leader_id and r not in not_rows)

    # 1. an election, then full leader ticks (K7 + K2)
    e.run_until_leader()
    res["first_leader"] = e.leader_id
    half = steps["ticks"] // 2
    tick_events = []
    if timed:
        run_tick = e._fire_leader_tick

        def timed_tick(r):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run_tick(r)
            b.record()
            tick_events.append((a, b))

        e._fire_leader_tick = timed_tick
    for h in range(2):
        lo = e.commit_watermark + 1
        seqs = [e.submit(p) for p in inp.take(half)]
        sync()
        t0 = time.perf_counter()
        if timed and h == 1:
            ticks0 = e._tick_count

            def window():
                with profiling.annotating():
                    while e._tick_count < ticks0 + ENGINE_PROFILED_TICKS:
                        e.step_event()

            events, pwall = _device_events(window, 1)
            events = [(n, us) for n, us in events
                      if not n.startswith("leader_tick#")]
        e.run_until_committed(seqs[-1])
        sync()
        if h == 0:
            walls["ticks_first_half_s"] = time.perf_counter() - t0
        read_back(e, lo, f"ticks, half {h}")
    if timed:
        e._fire_leader_tick = run_tick
        tick_ms = [a.elapsed_time(b) for a, b in tick_events]
        res["ticks"] = {
            "leader_ticks": len(tick_events), "entries": steps["ticks"],
            "entries_per_s_wall": half / walls["ticks_first_half_s"],
            "rate_over": f"the first half ({half} entries, not profiled)",
            "ms_per_tick_p50": float(np.percentile(tick_ms, 50)),
            "ms_per_tick_p99": float(np.percentile(tick_ms, 99)),
            "ms_per_tick_mean": float(np.mean(tick_ms)),
            "latency_method": "CUDA events around each leader tick (host "
                              "work inside)"}
        by_kind = {}
        for name, us in events:
            kind = kernel_of(name) or ("copy" if "emcpy" in name
                                       else "other")
            if kind in ("K6 encode", "K6 decode", "K7"):
                kind = "gf_table_kernel (K7 on these ticks)"
            by_kind[kind] = by_kind.get(kind, 0.0) + us
        busy = sum(by_kind.values())
        copies = [n for n, _ in events if "emcpy" in n]
        kernels = [n for n, _ in events
                   if "emcpy" not in n and "emset" not in n]
        by_name = {}
        for name, us in events:
            by_name[name[:60]] = by_name.get(name[:60], 0.0) + us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        res["profiled_ticks"] = {
            "ticks": ENGINE_PROFILED_TICKS, "wall_ms": pwall * 1e3,
            "kernels_per_tick": len(kernels) / ENGINE_PROFILED_TICKS,
            "copies_per_tick": len(copies) / ENGINE_PROFILED_TICKS,
            "device_ops_per_tick": len(events) / ENGINE_PROFILED_TICKS,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (pwall * 1e6),
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "device_ms_top_names": {k: v / 1e3 for k, v in top}}
    # 2. one ring as one flight (every row accepts: K4)
    lo = e.commit_watermark + 1
    sync()
    t0 = time.perf_counter()
    e.submit_pipelined(inp.take(steps["flight"]))
    sync()
    walls["flight_s"] = time.perf_counter() - t0
    check(flights == [C // B],
          f"the pipeline gate did not admit the chunk: {flights}")
    check(e.commit_watermark == lo - 1 + steps["flight"],
          f"the flight committed {e.commit_watermark}")
    read_back(e, lo, "flight")
    # 3. a data row failed: commit at 4 of 5, decoding reads
    a = other_row((1, 0, 2))
    e.fail(a)
    commit(e, steps["degraded"], f"row {a} dead")
    res["degraded_read_rows"] = [
        r for r in range(cfg.rows) if e.alive[r]][:cfg.rs_k]
    # 4. a second row slow (commit blocks), the first recovered
    b = other_row((2, 0, 1, 3, 4), a)
    e.set_slow(b, True)
    wm = e.commit_watermark
    seqs = [e.submit(p) for p in inp.take(steps["suffix"])]
    e.run_for(3 * cfg.heartbeat_period)
    check(e.commit_watermark == wm
          and int(e.state.last_index[e.leader_id]) == wm + steps["suffix"],
          f"rows {a} dead and {b} slow: the suffix must sit uncommitted")
    mark = len(lines)
    e.recover(a)
    e.run_until_committed(seqs[-1])
    check(heal_lines(a, "healed by reconstruction", mark)
          and heal_lines(a, "suffix re-served", mark),
          f"row {a} was not healed and re-served: {lines[mark:][:12]}")
    read_back(e, wm + 1, f"suffix re-served to row {a}")
    mark = len(lines)
    e.set_slow(b, False)
    e.run_for(3 * cfg.heartbeat_period)
    check(heal_lines(b, "healed by reconstruction", mark),
          f"slow row {b} was not healed: {lines[mark:][:12]}")
    # 5. the second row failed and lapped, then streamed a snapshot
    e.fail(b)
    commit(e, steps["lapped_ticks"], f"row {b} dead (ticks)")
    lo = e.commit_watermark + 1
    e.submit_pipelined(inp.take(steps["lapped_flight"]))
    check(flights == [C // B] * 2,
          f"the gate did not admit the dead-row chunk: {flights}")
    check(e.commit_watermark == lo - 1 + steps["lapped_flight"],
          f"the dead-row flight committed {e.commit_watermark}")
    read_back(e, lo, f"row {b} dead (flight)")
    mark = len(lines)
    e.recover(b)
    sync()
    t0 = time.perf_counter()
    for _ in range(4 * C // B):
        e.run_for(cfg.heartbeat_period)
        if int(e.state.match_index[b]) >= e.commit_watermark:
            break
    sync()
    walls["snapshot_stream_s"] = time.perf_counter() - t0
    ours = [ln for ln in lines[mark:] if ln.startswith(f"[Server{b}:")]
    chunks = heal_lines(b, "snapshot chunk installed", mark)
    # the heal refuses first (every donor ring lapped the row), so the
    # first thing installed is a snapshot chunk; once the stream has
    # brought the row back inside the donors' ring horizon, the heal by
    # reconstruction may finish the range, as in the JAX engine
    check(len(ours) >= 2 and "snapshot chunk installed" in ours[1],
          f"lapped row {b} was not streamed: {ours[:12]}")
    check(int(e.state.match_index[b]) >= e.commit_watermark,
          f"row {b}'s match {int(e.state.match_index[b])} is below the "
          f"watermark {e.commit_watermark} after the stream")
    res["stream"] = {
        "row": b, "chunks_installed": e._shipper.chunks_total,
        "chunk_lines": len(chunks),
        "completed_by_stream": bool(heal_lines(
            b, "snapshot stream complete", mark)),
        "then_healed_by_reconstruction": bool(heal_lines(
            b, "healed by reconstruction", mark)),
        "wall_s": walls["snapshot_stream_s"]}
    shards = [shard_columns_match(e, inp, "after the stream")]
    # 6. the leader failed, a re-election
    old = e.leader_id
    e.fail(old)
    e.run_until_leader()
    res["failover"] = {"failed": old, "new_leader": e.leader_id,
                       "term": int(e.leader_term)}
    commit(e, steps["after_failover"], "after the failover")
    # 7. checkpoint, a vote after it, restore with the vote log
    sync()
    t0 = time.perf_counter()
    e.save_checkpoint(ck_path)
    walls["save_checkpoint_s"] = time.perf_counter() - t0
    ck = EngineCheckpoint.load(ck_path)
    e.force_campaign(other_row(range(cfg.rows), old))
    pre_terms = e.terms.copy()
    pre_vf = e.state.voted_for.cpu().numpy().astype(np.int64)
    wm = e.commit_watermark
    before = {"lines": list(lines), "terms": e.terms.tolist(),
              "commit_time": dict(e.commit_time),
              "state": state_to_numpy(e.state)}
    del e
    tr2 = SingleDeviceTransport(cfg, device=dev)
    lines2 = []
    sync()
    t0 = time.perf_counter()
    e2 = RaftEngine.restore(cfg, ck_path, tr2, trace=lines2.append,
                            vote_log=vote_log)
    sync()
    walls["restore_s"] = time.perf_counter() - t0
    want_terms, want_vf = merge_restored(
        cfg.rows, ck.terms.astype(np.int64).copy(),
        ck.voted_for.astype(np.int64).copy(), vote_log)
    got_vf = e2.state.voted_for.cpu().numpy()
    check(np.array_equal(e2.terms, want_terms)
          and np.array_equal(got_vf, want_vf)
          and np.array_equal(e2.terms, pre_terms)
          and np.array_equal(got_vf, pre_vf),
          f"restored terms {e2.terms.tolist()} / votedFor "
          f"{got_vf.tolist()}: the checkpoint merged with the vote log "
          f"gives {want_terms.tolist()} / {want_vf.tolist()}, the engine "
          f"held {pre_terms.tolist()} / {pre_vf.tolist()}")
    check(e2.commit_watermark == wm, f"restored to {e2.commit_watermark}")
    e2.register_apply(apply)
    e2.run_until_leader()
    commit(e2, steps["after_restore"], "after the restore",
           heartbeats=2)
    shards.append(shard_columns_match(e2, inp, "after the restore"))
    total = sum(v for k, v in steps.items() if k != "capacity")
    check(e2.commit_watermark == total and applied[0] == total,
          f"commit {e2.commit_watermark}, applied {applied[0]}, "
          f"submitted {total}")
    check(h_apply.hexdigest() == inp.h.hexdigest(),
          "the apply stream differs from the input")
    res.update({
        "entries": total, "commit_watermark": e2.commit_watermark,
        "checkpoint": {"base_index": ck.snap.base_index,
                       "last_index": ck.snap.last_index,
                       "bytes": os.path.getsize(ck_path)},
        "restored_terms": e2.terms.tolist(),
        "restored_voted_for": got_vf.tolist(),
        "sha256_input": inp.h.hexdigest(),
        "sha256_apply_stream": h_apply.hexdigest(),
        "read_backs": len(reads), "shard_checks": shards,
        "flights": flights, "walls_s": walls,
        "nodelog_lines": len(lines) + len(lines2)})
    fingerprint = {
        "before": before,
        "after": {"lines": lines2, "terms": e2.terms.tolist(),
                  "commit_time": dict(e2.commit_time),
                  "state": state_to_numpy(e2.state)},
        "apply": h_apply.hexdigest(), "reads": reads}
    return res, fingerprint


def phase_engine_ec_path(dev):
    """``ec_engine_run`` at BASELINE config 3's full depth on the card;
    every check exact, and K7, K6 encode, K6 decode and K2 must launch,
    with K3 or K4."""
    import tempfile

    zero_ec_counters(dev)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        steps = EC_ENGINE_STEPS["full"]
        res, _ = ec_engine_run(ec_engine_config(steps["capacity"]), dev,
                               steps, tmp, timed=True)
    counters = read_engine_ec_counters(dev)
    for k in ("K7", "K6 encode", "K6 decode", "K2"):
        check(counters[k] > 0, f"engine_ec: {k} never launched: {counters}")
    check(counters["K3"] + counters["K4"] > 0,
          f"engine_ec: neither K3 nor K4 launched: {counters}")
    res.update({"phase": "engine_ec_path", "launches": counters,
                "phase_wall_s": time.perf_counter() - t0,
                "nodelog": "on (heal and stream lines checked)"})
    emit(res)
    return res


def phase_engine_ec_card_equals_cpu(dev):
    """``ec_engine_run`` at a 4 096-slot ring, once with the transport on
    the card and once on the CPU (both engines' flight gates open, so
    the CPU flies the same chunks through the plain versions): the
    nodelog lines, terms, commit stamps, every state leaf and the
    committed bytes of the engine before the crash and of the restored
    one must be equal. This holds K6 and K7 inside the engine against
    their plain versions."""
    import tempfile

    import raft_tpu_torch.raft.engine as engine_mod

    steps = EC_ENGINE_STEPS["reduced"]
    cfg = ec_engine_config(steps["capacity"])
    runs = {}
    walls = {}
    zero_ec_counters(dev)
    for where in (dev, "cpu"):
        hook = engine_mod._pipeline_backend_ok
        if where == "cpu":
            engine_mod._pipeline_backend_ok = lambda *a: True
        try:
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                runs[str(where)] = ec_engine_run(cfg, where, steps, tmp,
                                                 timed=False)
            walls[str(where)] = time.perf_counter() - t0
        finally:
            engine_mod._pipeline_backend_ok = hook
        if where == dev:
            counters = read_engine_ec_counters(dev)
    (card, cf), (host, hf) = runs[str(dev)], runs["cpu"]
    for part in ("before", "after"):
        c, h = cf[part], hf[part]
        check(c["lines"] == h["lines"],
              f"card vs CPU ({part}): the nodelog lines differ")
        check(c["terms"] == h["terms"] and c["commit_time"] == h["commit_time"],
              f"card vs CPU ({part}): terms or commit stamps differ")
        for f in c["state"]:
            check(np.array_equal(c["state"][f], h["state"][f]),
                  f"card vs CPU ({part}): state.{f} differs")
    check(cf["apply"] == hf["apply"] and cf["reads"] == hf["reads"],
          "card vs CPU: the committed bytes differ")
    for k in ("K7", "K6 encode", "K6 decode", "K2"):
        check(counters[k] > 0,
              f"engine_ec card run: {k} never launched: {counters}")
    emit({"phase": "engine_ec_card_equals_cpu", "steps": steps,
          "entries": card["entries"],
          "nodelog_lines": card["nodelog_lines"],
          "read_backs": card["read_backs"], "flights": card["flights"],
          "launches_card": counters, "walls_s": walls,
          "equal": ["nodelog lines", "terms", "commit stamps",
                    "every state leaf", "committed bytes (apply stream, "
                    "every read-back)"]})
    return {"launches": counters}


# ------------------------ the replicated KV store (A9c, A9d, A10)
#: per-step sizes of ``kv_run``: the north star's ring at full depth, and
#: the same steps at a 4 096-slot ring for the card-equals-CPU run
KV_STEPS = {
    "full": dict(capacity=1 << 15, ticks=64, flight=1 << 15, after_ticks=16,
                 learner_sets=256, tickets=64, rounds=2, gets=256,
                 lease_reads=20000, counter_ops=64, profiled_ticks=8),
    "reduced": dict(capacity=4096, ticks=8, flight=4096, after_ticks=4,
                    learner_sets=256, tickets=16, rounds=2, gets=64,
                    lease_reads=500, counter_ops=32, profiled_ticks=0),
}
KV_KEYS = 16384
KV_VALUE_BYTES = 243
#   the widest value a 256-byte entry holds after the 5-byte header and
#   the 8-byte key (etcd's benchmark writes 256-byte values)
COUNTER_CLIENTS = (0x10, 0x11, 0x12, 0x13)
#   low bytes outside {1, 2}: the KV store reads a counter entry as an op
#   it ignores


def kv_config(capacity):
    """The north star's deployment with membership headroom, grown the
    way etcd's runtime-reconfiguration guide grows 3 members to 5
    (``member add --learner``, then ``member promote``), reads served by
    ReadIndex and leader leases: 3 voters of 5 rows, PreVote and
    CheckQuorum, 256-byte entries, B = 1024."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, max_replicas=5, prevote=True,
                      check_quorum=True, read_lease=True,
                      log_capacity=capacity, transport="single")


class CounterLog:
    """The engine as ``ReplicatedCounter`` sees it when it shares the log
    with the KV store: the counter's own entries only (a KV SET or DELETE
    starts with op byte 1 or 2, a configuration entry with ``RCFG``)."""

    def __init__(self, e):
        self.e, self.cfg = e, e.cfg

    def submit(self, payload):
        return self.e.submit(payload)

    def register_apply(self, fn, replay=False):
        def mine(idx, payload):
            if payload[0] not in (1, 2) and payload[:4] != b"RCFG":
                fn(idx, payload)

        return self.e.register_apply(mine, replay=replay)


class KvClient:
    """The client side of ``kv_run``: seeded SETs through
    ``ReplicatedKV`` (8-byte keys over ``KV_KEYS``, 243-byte values), the
    applied log recorded by index with its own decoder, and the model
    every read is held to: the last SET to the key at or below the read
    index, each applied SET checked against the submitted one."""

    def __init__(self, e, kv, seed):
        import struct

        self.e, self.kv, self.E = e, kv, e.cfg.entry_bytes
        self.hdr = struct.Struct("<BHH")
        self.rng = np.random.default_rng(seed)
        self.sets = []               # submitted SET entries, in seq order
        self.set_seqs = []
        self.applied = {}            # log index -> payload
        self.n_applied_sets = 0
        self.key_writes = {}         # key -> [(index, value)], applied order
        self.h_in = hashlib.sha256()
        self.h_sets = hashlib.sha256()
        self.reads = []              # every read index served, in order
        self.gets = 0

    def on_apply(self, idx, payload):
        check(idx not in self.applied, f"index {idx} applied twice")
        self.applied[idx] = payload
        if payload[0] != 1:
            return
        j = self.n_applied_sets
        check(j < len(self.sets) and payload == self.sets[j],
              f"the SET applied at {idx} is not the {j}-th submitted")
        self.n_applied_sets += 1
        _, klen, vlen = self.hdr.unpack_from(payload)
        key = payload[5:5 + klen]
        self.key_writes.setdefault(key, []).append(
            (idx, payload[5 + klen:5 + klen + vlen]))
        self.h_sets.update(payload)

    def entries(self, n):
        keys = self.rng.integers(0, KV_KEYS, n)
        vals = self.rng.integers(0, 256, (n, KV_VALUE_BYTES), dtype=np.uint8)
        out = []
        for k, v in zip(keys.tolist(), vals):
            key, val = int(k).to_bytes(8, "little"), v.tobytes()
            body = self.hdr.pack(1, len(key), len(val)) + key + val
            out.append((key, val, body + bytes(self.E - len(body))))
        return out

    def set_many(self, n):
        """``n`` SETs through ``ReplicatedKV.set``; returns the seqs."""
        seqs = []
        for key, val, entry in self.entries(n):
            self.sets.append(entry)
            self.h_in.update(entry)
            seqs.append(self.kv.set(key, val))
        self.set_seqs += seqs
        return seqs

    def pipelined(self, n):
        """``n`` SETs as one ``submit_pipelined`` call."""
        ents = self.entries(n)
        for _, _, entry in ents:     # before the call: it applies them
            self.sets.append(entry)
            self.h_in.update(entry)
        seqs = self.e.submit_pipelined([x[2] for x in ents])
        self.set_seqs += seqs
        return seqs

    def expect(self, key, idx):
        """The model: the value of the last SET to ``key`` at or below
        log index ``idx``."""
        val = None
        for i, v in self.key_writes.get(key, ()):
            if i > idx:
                break
            val = v
        return val

    def check_gets(self, n, what):
        """``n`` ``linearizable_get`` calls on seeded keys, each equal to
        the model at its read index."""
        for k in self.rng.integers(0, KV_KEYS, n).tolist():
            key = int(k).to_bytes(8, "little")
            mark = len(self.reads)
            got = self.kv.linearizable_get(key)
            check(len(self.reads) == mark + 1,
                  f"{what}: linearizable_get read no index")
            idx = self.reads[-1]
            check(self.kv.last_applied >= idx,
                  f"{what}: served below the read index")
            check(got == self.expect(key, idx),
                  f"{what}: key {k} at read index {idx} differs from the "
                  "model")
            self.gets += 1


def kv_run(cfg, dev, plan, timed):
    """The replicated KV store of ``kv_config`` through ``RaftEngine`` on
    ``dev`` (``ReplicatedKV`` and ``ReplicatedCounter`` sharing the log):

    1. an election; ``ticks`` full leader ticks of SETs (K1 repairing,
       then K2 under the voter plane), ``gets`` linearizable gets (lease
       reads) and ``lease_reads`` ``read_linearizable`` calls, none of
       which may run a round;
    2. one ``submit_pipelined`` chunk of one ring under the voter plane
       (K3 decides; with spare rows outside the accept set K3 writes);
    3. ``add_server(3)``, then ``add_server(4)``: each learner starts empty
       behind the ring horizon, takes a snapshot stream, then the repair
       window, and is promoted by the leader tick; while a learner is
       attached the lease is off, so between ticks ``rounds``
       ``read_linearizable`` calls each run one empty round under the
       packed voter|learner mask (K1 while repairing, K2 at count 0 once
       steady), then ``tickets`` ``submit_read`` tickets and
       ``learner_sets`` SETs go in, and the next tick's write round must
       confirm every ticket;
    4. ``after_ticks`` full ticks at 5 voters, lease gets between them
       (``profiled_ticks`` of them in a profiled window when ``timed``);
    5. a voter failed, wiped and brought back with ``replace(dead,
       dead)``: removal, learner, stream, promote;
    6. ``counter_ops`` counter increments, half blindly retried, then
       ``remove_server(leader)`` with more increments in flight: the
       leader steps down once the removal commits, the others elect, and
       every increment not yet durable is retried blindly;
    7. the leader partitioned alone: past its lease, ``read_linearizable``
       must raise ``LinearizableReadRefused``; the partition healed.

    Checks (all exact): the member/learner masks after every step; every
    linearizable get against the model at its read index; the counter
    (and an independent decode of its applied entries) equal to the sum
    over distinct (client, request) pairs; the applied SETs equal the
    submitted ones in order (SHA-256); every live voter's ring window,
    configuration entries taken out, equal to the applied log there.
    Returns (result, fingerprint)."""
    import struct

    import torch

    from raft_tpu_torch.core.state import log_entries, state_to_numpy
    from raft_tpu_torch.core import ring_cuda, step_cuda
    from raft_tpu_torch.examples import ReplicatedCounter, ReplicatedKV
    from raft_tpu_torch.obs import profiling
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.raft.engine import LinearizableReadRefused
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    on_card = torch.device(dev).type == "cuda"
    timed = timed and on_card
    B, C, HB = cfg.batch_size, cfg.log_capacity, cfg.heartbeat_period
    tr = SingleDeviceTransport(cfg, device=dev)
    flights, packed_rounds = [], {"calls": 0, "K1": 0, "K2": 0}
    rounds = [0]
    run_flight, run_rep = tr.replicate_pipeline, tr.replicate

    def counted_flight(*a, **k):
        flights.append(int(a[2].shape[0]))
        check(k["member"] is not None and k["member"].dtype == torch.bool,
              "the flight must take the bool voter plane")
        return run_flight(*a, **k)

    def counted_round(*a, **k):
        rounds[0] += 1
        m = k.get("member")
        check(m is not None, "a headroom cluster's step got no member mask")
        if m.dtype == torch.bool:
            return run_rep(*a, **k)
        k1 = ring_cuda.LAUNCHES["write_window_both"]
        k2 = step_cuda.LAUNCHES["steady_step"]
        out = run_rep(*a, **k)
        packed_rounds["calls"] += 1
        packed_rounds["K1"] += ring_cuda.LAUNCHES["write_window_both"] - k1
        packed_rounds["K2"] += step_cuda.LAUNCHES["steady_step"] - k2
        return out

    tr.replicate_pipeline, tr.replicate = counted_flight, counted_round
    lines = []
    e = RaftEngine(cfg, tr, trace=lines.append)
    kv = ReplicatedKV(e)
    cl = KvClient(e, kv, SEED + 70)
    e.register_apply(cl.on_apply)
    ctr = ReplicatedCounter(CounterLog(e))
    tickets = []                     # (ticket, confirmed read index)
    round_ms, tick_ms = [], []
    run_read = e.read_linearizable

    def recorded_read(r=None):
        r0 = rounds[0]
        if timed:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
        idx = run_read(r)
        if timed and rounds[0] > r0:
            b.record()
            torch.cuda.synchronize()
            round_ms.append(a.elapsed_time(b))
        cl.reads.append(idx)
        return idx

    e.read_linearizable = recorded_read
    if timed:
        run_tick = e._fire_leader_tick

        def timed_tick(r):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run_tick(r)
            b.record()
            tick_ms.append((a, b))

        e._fire_leader_tick = timed_tick
    res = {"n_replicas": cfg.n_replicas, "max_replicas": cfg.max_replicas,
           "entry_bytes": cfg.entry_bytes, "batch": B, "capacity": C,
           "device": str(dev), "plan": plan}

    def masks(member, learner, what):
        got = (e.member.astype(int).tolist(), e.learner.astype(int).tolist())
        check(got == (member, learner),
              f"{what}: member/learner {got}, expected {(member, learner)}")

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def until(cond, what, limit=2000.0):
        end = e.clock.now + limit
        while not cond():
            check(e.clock.now < end and e._q, f"{what}: not reached")
            e.step_event()

    # 1. an election, full ticks of SETs, lease reads
    e.run_until_leader()
    masks([1, 1, 1, 0, 0], [0] * 5, "elected")
    res["first_leader"] = e.leader_id
    seqs = cl.set_many(plan["ticks"] * B)
    sync()
    t0 = time.perf_counter()
    e.run_until_committed(seqs[-1])
    sync()
    res["tick_phase"] = {"entries": len(seqs),
                         "wall_s": time.perf_counter() - t0,
                         "leader_ticks": e._tick_count}
    check(e.commit_watermark == len(seqs), "ticks: commit != submitted")
    r0 = rounds[0]
    cl.check_gets(plan["gets"], "lease gets")
    n = plan["lease_reads"]
    lease0 = e.read_class_counts.get("lease", 0)
    t0 = time.perf_counter()
    for _ in range(n):
        idx = run_read()             # the engine's own call, unwrapped
    wall = time.perf_counter() - t0
    cl.reads.append(idx)
    check(rounds[0] == r0 and e.read_class_counts["lease"] == lease0 + n
          and idx == e.commit_watermark,
          "a lease read ran a replication round, or read a stale index")
    res["lease_reads"] = {"reads": n + plan["gets"], "rounds": 0,
                          "wall_s": wall, "per_host_s": n / wall}
    # 2. one pipelined ring under the voter plane
    last = e.commit_watermark
    cl.pipelined(plan["flight"])
    check(flights == [C // B], f"the pipeline gate did not admit the ring: "
                               f"{flights}")
    check(e.commit_watermark == last + plan["flight"],
          "the flight's commit")
    # 3. add_server(3) and add_server(4), reads while the learner hears
    joins = {}
    confirmed_per_round = []
    before = {"K1": ring_cuda.LAUNCHES["write_window_both"],
              "K2": step_cuda.LAUNCHES["steady_step"]}
    for r in (3, 4):
        m0 = e.member.astype(int).tolist()
        t0, v0, ticks0 = time.perf_counter(), e.clock.now, e._tick_count
        s_add = e.add_server(r)
        pending = []
        saw = {"learner": False, "stream": False}
        while not e.member[r]:
            check(e.clock.now < v0 + 2000.0, f"add_server({r}) stalled")
            t = e._tick_count
            e.step_event()
            if e.learner[r]:
                saw["learner"] = True
            if e._tick_count == t or e.leader_id is None \
                    or not e.learner.any():
                continue
            # a leader tick ran: its write round confirmed the tickets
            if pending:
                got = [e.read_confirmed(tk) for tk in pending]
                check(all(g is not None for g in got),
                      "a write round left read tickets unconfirmed")
                tickets.extend(zip(pending, got))
                confirmed_per_round.append(len(got))
            for _ in range(plan["rounds"]):
                cl.check_gets(1, f"ReadIndex get, learner {r}")
            pending = [e.submit_read() for _ in range(plan["tickets"])]
            check(all(e.read_ticket_class(tk) == "read_index"
                      for tk in pending), "a lease served with a learner")
            cl.set_many(plan["learner_sets"])
        if pending:
            t = e._tick_count
            until(lambda: e._tick_count > t, "the next write round")
            got = [e.read_confirmed(tk) for tk in pending]
            check(all(g is not None for g in got),
                  "a write round left read tickets unconfirmed")
            tickets.extend(zip(pending, got))
            confirmed_per_round.append(len(got))
        saw["stream"] = any(ln.startswith(f"[Server{r}:")
                            and "snapshot chunk installed" in ln
                            for ln in lines)
        check(saw["learner"] and saw["stream"],
              f"row {r} joined without a learner phase or a stream: {saw}")
        wall = time.perf_counter() - t0
        m0[r] = 1
        masks(m0, [0] * 5, f"row {r} promoted")
        e.run_until_committed(s_add)
        joins[r] = {"wall_s": wall, "virtual_s": e.clock.now - v0,
                    "leader_ticks": e._tick_count - ticks0}
    e.run_until_committed(cl.set_seqs[-1])
    res["joins"] = joins
    res["read_index"] = {
        "rounds_packed_mask": dict(packed_rounds),
        "launches_in_learner_windows": {
            "K1": ring_cuda.LAUNCHES["write_window_both"] - before["K1"],
            "K2": step_cuda.LAUNCHES["steady_step"] - before["K2"]},
        "tickets_confirmed": len(tickets),
        "tickets_per_write_round": (float(np.mean(confirmed_per_round))
                                    if confirmed_per_round else 0.0)}
    check(packed_rounds["calls"] > 0,
          "no step ran under the packed voter|learner mask")
    # 4. full ticks at 5 voters, lease reads between them
    masks([1] * 5, [0] * 5, "5 voters")
    seqs = cl.set_many(plan["after_ticks"] * B)
    if timed and plan["profiled_ticks"]:
        ticks0 = e._tick_count

        def window():
            with profiling.annotating():
                while e._tick_count < ticks0 + plan["profiled_ticks"]:
                    t = e._tick_count
                    e.step_event()
                    if e._tick_count != t:
                        cl.check_gets(4, "profiled lease gets")
                        tk = e.submit_read()
                        check(e.read_confirmed(tk) is not None,
                              "a lease ticket was not ready")

        events, pwall = _device_events(window, 1)
        events = [(n_, us) for n_, us in events
                  if not n_.startswith("leader_tick#")]
        busy = sum(us for _, us in events)
        by_kind = {}
        for name, us in events:
            kind = kernel_of(name) or ("copy" if "emcpy" in name
                                       else "other")
            by_kind[kind] = by_kind.get(kind, 0.0) + us
        res["profiled_ticks"] = {
            "ticks": plan["profiled_ticks"], "wall_ms": pwall * 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (pwall * 1e6),
            "device_ops_per_tick": len(events) / plan["profiled_ticks"],
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_kind.items()},
            "reads_per_tick": 5}
    e.run_until_committed(seqs[-1])
    cl.check_gets(plan["gets"], "gets at 5 voters")
    # 5. a voter failed, wiped, replaced by itself
    lead = e.leader_id
    dead = next(r for r in (1, 2, 0, 3, 4) if r != lead)
    e.fail(dead)
    e.wipe(dead)
    check(int(e.state.last_index[dead]) == 0 and e._wiped[dead],
          "wipe left the row's log")
    s_rm = e.replace(dead, dead)
    end = e.clock.now + 2000.0
    phases = []
    while not (e.alive[dead] and e.member[dead]):
        check(e.clock.now < end, "the replace ladder stalled")
        if not e.alive[dead]:
            e.recover(dead)            # refused until the removal commits
        e.run_for(HB)
        state = (bool(e.member[dead]), bool(e.learner[dead]))
        if not phases or phases[-1] != state:
            phases.append(state)
    check(e.is_durable(s_rm), "the removal of the wiped row")
    check(phases[:1] == [(False, False)] and (False, True) in phases,
          f"the replace ladder's steps: {phases}")
    masks([1] * 5, [0] * 5, "replaced")
    res["replace"] = {"row": dead, "ladder": phases}
    # 6. counter increments with blind retries across a removed leader
    e.run_for(4 * HB)
    pairs = {}                       # (client, request) -> [amount, seqs]

    def add(i, retry=None):
        if retry is None:
            client = COUNTER_CLIENTS[i % len(COUNTER_CLIENTS)]
            amount = 1 + (i * 7919) % 1000
            seq, req = ctr.add(client, amount)
            pairs[(client, req)] = [amount, [seq]]
        else:                          # the same (client, request) again
            seq, _ = ctr.add(retry[0], pairs[retry][0],
                             request_id=retry[1])
            pairs[retry][1].append(seq)

    n_ops = plan["counter_ops"]
    for i in range(n_ops // 2):
        add(i)
        if i % 2:
            add(i, retry=list(pairs)[-1])
    e.run_until_committed(max(s for _, ss in pairs.values() for s in ss))
    old = e.leader_id
    for i in range(n_ops // 2, n_ops):
        add(i)
    s_rm = e.remove_server(old)
    for i in range(n_ops, n_ops + n_ops // 4):
        add(i)
    until(lambda: e.leader_id is not None and e.leader_id != old
          and e.is_durable(s_rm), "the removed leader's successor")
    check(not e.member[old] and e.roles[old] == "follower",
          "the removed leader did not step down")
    check(any(ln.startswith(f"[Server{old}:")
              and ln.endswith("step down to follower (removed)")
              for ln in lines), "no removed-leader step-down line")
    for key, (_, ss) in list(pairs.items()):
        if not any(e.is_durable(s) for s in ss):
            add(None, retry=key)     # the ack never came: retry blindly
    until(lambda: all(any(e.is_durable(s) for s in ss)
                      for _, ss in pairs.values()), "the counter's ops")
    e.run_for(2 * HB)
    want = sum(a for a, _ in pairs.values())
    hdr = struct.Struct("<QQq")
    seen, indep = set(), 0
    for idx in sorted(cl.applied):
        p = cl.applied[idx]
        if p[0] in (1, 2) or p[:4] == b"RCFG":
            continue
        client, req, amount = hdr.unpack_from(p)
        if client and (client, req) not in seen:
            seen.add((client, req))
            indep += amount
    check(ctr.value == want == indep,
          f"counter {ctr.value}, pairs {want}, applied {indep}")
    m = [1] * 5
    m[old] = 0
    masks(m, [0] * 5, "leader removed")
    res["counter"] = {"value": ctr.value, "pairs": len(pairs),
                      "duplicates_dropped": ctr.duplicates_dropped,
                      "removed_leader": old, "new_leader": e.leader_id}
    # 7. a minority leader past its lease refuses
    lead = e.leader_id
    others = [r for r in range(cfg.rows) if e.member[r] and r != lead]
    e.partition([[lead], others])
    e.run_for(cfg.lease_duration_s + HB / 4)
    check(e.roles[lead] == "leader", "the minority leader stepped down early")
    for call in (lambda: e.read_linearizable(lead),
                 lambda: kv.linearizable_get(b"\0" * 8)):
        try:
            call()
        except LinearizableReadRefused:
            continue
        check(False, "a minority leader served a linearizable read")
    e.heal_partition()
    until(lambda: e.leader_id is not None and e.roles[e.leader_id]
          == "leader" and not any(e.roles[r] == "leader"
                                  for r in range(cfg.rows)
                                  if r != e.leader_id), "a healed leader")
    e.run_for(4 * HB)
    cl.check_gets(plan["gets"], "gets after the partition")
    # the whole log: SETs in order; every live voter's ring window
    check(cl.n_applied_sets == len(cl.sets)
          and cl.h_sets.hexdigest() == cl.h_in.hexdigest(),
          "the applied SETs differ from the submitted ones")
    hi = e.commit_watermark
    check(sorted(cl.applied) == list(range(1, hi + 1)),
          "the apply stream has a gap")
    rows = {}
    for r in range(cfg.rows):
        if not (e.alive[r] and e.member[r]):
            continue
        top = int(e.state.commit_index[r])
        lo = max(1, top - C + 1, int(e._ring_floor[r]))
        got = [bytes(x) for x in log_entries(e.state, r, lo, top)]
        want_ = [cl.applied[i] for i in range(lo, top + 1)]
        data = [x for x in got if x[:4] != b"RCFG"]
        check(hashlib.sha256(b"".join(data)).hexdigest()
              == hashlib.sha256(b"".join(
                  x for x in want_ if x[:4] != b"RCFG")).hexdigest()
              and got == want_, f"row {r}'s ring differs from the log")
        rows[r] = {"lo": lo, "hi": top, "entries": len(data)}
    res.update({
        "commit_watermark": hi, "sets": len(cl.sets), "gets": cl.gets,
        "sha256_sets": cl.h_in.hexdigest(), "rows_checked": rows,
        "config_entries": sum(1 for p in cl.applied.values()
                              if p[:4] == b"RCFG"),
        "read_classes": dict(e.read_class_counts),
        "flights": flights, "nodelog_lines": len(lines)})
    if timed:
        ms = [a.elapsed_time(b) for a, b in tick_ms]
        res["ms_per_leader_tick"] = {
            "p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99)), "ticks": len(ms),
            "method": "CUDA events around each leader tick (host work "
                      "inside)"}
        res["ms_per_read_round"] = {
            "p50": float(np.percentile(round_ms, 50)),
            "p99": float(np.percentile(round_ms, 99)),
            "rounds": len(round_ms),
            "method": "CUDA events around read_linearizable calls that ran "
                      "an empty round"}
    fingerprint = {
        "lines": lines, "terms": e.terms.tolist(), "roles": list(e.roles),
        "member": e.member.tolist(), "learner": e.learner.tolist(),
        "commit_time": dict(e.commit_time), "reads": list(cl.reads),
        "tickets": tickets, "state": state_to_numpy(e.state),
        "kv": hashlib.sha256(repr(sorted(kv._data.items())).encode())
        .hexdigest(),
        "counter": (ctr.value, ctr.duplicates_dropped)}
    return res, fingerprint


def phase_kv_main_path(dev):
    """``kv_run`` at the north star's full ring (C = 32 768) on the card:
    every check exact; K1, K2 and K3 must launch on the path."""
    zero_counters(dev)
    t0 = time.perf_counter()
    res, _ = kv_run(kv_config(KV_STEPS["full"]["capacity"]), dev,
                    KV_STEPS["full"], timed=True)
    counters = read_counters(dev)
    for k in ("K1", "K2", "K3"):
        check(counters[k] > 0, f"kv: {k} never launched: {counters}")
    packed = res["read_index"]["rounds_packed_mask"]
    check(packed["K1"] > 0 and packed["K2"] > 0,
          f"kv: K1 and K2 must both run under the packed mask: {packed}")
    res = {"phase": "kv_main_path", **res, "launches": counters,
           "phase_wall_s": time.perf_counter() - t0}
    emit(res)
    return res


def card_vs_cpu(runner, cfg, dev, plan, what):
    """``runner`` on the card, then on the CPU with the engine's flight
    gate opened (so both fly the same chunks): returns (card result, the
    card's launch counters, walls); every fingerprint field must match."""
    import raft_tpu_torch.raft.engine as engine_mod

    runs, walls = {}, {}
    zero_ec_counters(dev)
    counters = None
    for where in (dev, "cpu"):
        hook = engine_mod._pipeline_backend_ok
        if where == "cpu":
            engine_mod._pipeline_backend_ok = lambda *a: True
        try:
            t0 = time.perf_counter()
            runs[str(where)] = runner(cfg, where, plan, timed=False)
            walls[str(where)] = time.perf_counter() - t0
        finally:
            engine_mod._pipeline_backend_ok = hook
        if where == dev:
            counters = read_engine_ec_counters(dev)
    (card, cf), (_, hf) = runs[str(dev)], runs["cpu"]
    for k in cf:
        if k == "state":
            for f in cf[k]:
                check(np.array_equal(cf[k][f], hf[k][f]),
                      f"{what}, card vs CPU: state.{f} differs")
        else:
            check(cf[k] == hf[k], f"{what}, card vs CPU: {k} differs")
    return card, counters, walls, sorted(cf)


def phase_kv_card_equals_cpu(dev):
    """``kv_run`` at a 4 096-slot ring on the card and on the CPU: nodelog
    lines, terms, roles, member/learner masks, commit stamps, every read
    index and ticket result, state leaves, the KV store and the counter
    must be equal."""
    plan = KV_STEPS["reduced"]
    card, counters, walls, equal = card_vs_cpu(
        kv_run, kv_config(plan["capacity"]), dev, plan, "kv")
    for k in ("K1", "K2", "K3"):
        check(counters[k] > 0, f"kv card run: {k} never launched")
    emit({"phase": "kv_card_equals_cpu", "plan": plan,
          "commit_watermark": card["commit_watermark"],
          "nodelog_lines": card["nodelog_lines"],
          "read_classes": card["read_classes"], "joins": card["joins"],
          "launches_card": counters, "walls_s": walls, "equal": equal})
    return {"launches": counters}


#: ``ec_membership_run`` at config 3's width with headroom (RS(6,3)):
#: entries per step, every count a multiple of B
EC_MEMBERSHIP_STEPS = dict(capacity=4096, pre=2048, mid=2048, post=2048,
                           tail=2048)


def ec_membership_config(capacity):
    """BASELINE config 3's width (264-byte entries, B = 1024, quorum 4)
    with one row of headroom: 5 voters of 6 rows, RS(6,3)."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=5, max_replicas=6, entry_bytes=264,
                      batch_size=1024, log_capacity=capacity, rs_k=3,
                      rs_m=2, transport="single")


def ec_membership_run(cfg, dev, plan, timed=False):
    """JAX ``tests/test_membership.py`` ``TestECLifecycle`` at config 3's
    width: ``pre`` entries; ``add_voter(5)`` with ``mid`` entries in
    flight (K7 at RS(6,3) every tick); the joiner healed by
    reconstruction into its shard row (K6 decode and encode at RS(6,3));
    two original rows failed and ``post`` entries committed at 4 of 6,
    read back through the parity rows; the rows recovered; a non-leader
    voter removed with ``tail`` entries in flight, then another (4
    voters), and a removal below the quorum refused. Each committed
    window read back through ``committed_entries`` must equal the applied
    input there. Returns (result, fingerprint)."""
    from raft_tpu_torch.core.state import state_to_numpy
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    HB = cfg.heartbeat_period
    tr = SingleDeviceTransport(cfg, device=dev)
    lines = []
    e = RaftEngine(cfg, tr, trace=lines.append)
    inp = EngineInput(cfg)
    index = {}                       # log index -> input bytes
    h_apply = hashlib.sha256()

    def apply(idx, payload):
        if payload[:4] != b"RCFG":
            h_apply.update(payload)
            index[idx] = payload

    e.register_apply(apply)
    reads = []

    def read_back(what):
        hi = e.commit_watermark
        lo = max(1, hi - cfg.log_capacity + 1)
        got = [bytes(x) for x in e.committed_entries(lo, hi)]
        data = b"".join(x for x in got if x[:4] != b"RCFG")
        want = b"".join(index[i] for i in range(lo, hi + 1) if i in index)
        check(data == want, f"{what}: committed_entries of [{lo}, {hi}] "
                            "differ from the applied input")
        reads.append({"what": what, "lo": lo, "hi": hi,
                      "sha256": hashlib.sha256(data).hexdigest()})

    def commit(n, what, limit=900.0):
        seqs = [e.submit(p) for p in inp.take(n)]
        e.run_until_committed(seqs[-1], limit=limit)
        return seqs

    e.run_until_leader()
    commit(plan["pre"], "pre")
    read_back("pre")
    s_add = e.add_voter(5)
    seqs = [e.submit(p) for p in inp.take(plan["mid"])]
    e.run_until_committed(s_add)
    check(int(e.member.sum()) == 6 and e.member[5], "row 5 joined")
    e.run_until_committed(seqs[-1])
    e.run_for(8 * HB)
    check(int(e.state.commit_index[5]) >= e.commit_watermark - cfg.batch_size
          and any(ln.startswith("[Server5:") and "healed by reconstruction"
                  in ln for ln in lines),
          "the joiner was not healed by reconstruction")
    read_back("grown")
    lead = e.leader_id
    dead = [r for r in range(5) if r != lead][:2]
    for r in dead:
        e.fail(r)
    commit(plan["post"], "post")
    read_back("two rows dead")
    for r in dead:
        e.recover(r)
    e.run_for(8 * HB)
    victim = next(r for r in range(6) if e.member[r] and r != e.leader_id)
    s_rm = e.remove_server(victim)
    seqs = [e.submit(p) for p in inp.take(plan["tail"])]
    e.run_until_committed(s_rm, limit=900.0)
    e.run_until_committed(seqs[-1], limit=900.0)
    check(int(e.member.sum()) == 5 and not e.member[victim], "shrunk to 5")
    read_back("shrunk")
    extra = next(r for r in range(6) if e.member[r] and r != e.leader_id)
    e.run_until_committed(e.remove_server(extra), limit=900.0)
    last = next(r for r in range(6) if e.member[r] and r != e.leader_id)
    try:
        e.remove_server(last)
        check(False, "a removal below the EC commit quorum was accepted")
    except ValueError as ex:
        check("commit quorum" in str(ex), f"the refusal: {ex}")
    check(h_apply.hexdigest() == inp.h.hexdigest(),
          "the applied entries differ from the input")
    res = {"rs": [cfg.rows, cfg.rs_k], "commit_quorum": cfg.commit_quorum,
           "joined": 5, "failed": dead, "removed": [victim, extra],
           "commit_watermark": e.commit_watermark, "read_backs": reads,
           "nodelog_lines": len(lines)}
    fingerprint = {"lines": lines, "terms": e.terms.tolist(),
                   "member": e.member.tolist(),
                   "commit_time": dict(e.commit_time), "reads": reads,
                   "apply": h_apply.hexdigest(),
                   "state": state_to_numpy(e.state)}
    return res, fingerprint


def phase_ec_membership_card_equals_cpu(dev):
    """``ec_membership_run`` at C = 4 096 on the card and on the CPU:
    nodelog lines, terms, masks, commit stamps, read-backs, the applied
    bytes and every state leaf must be equal; K7, K6 encode, K6 decode
    and K2 must launch on the card (all at RS(6,3))."""
    card, counters, walls, equal = card_vs_cpu(
        ec_membership_run, ec_membership_config(
            EC_MEMBERSHIP_STEPS["capacity"]), dev, EC_MEMBERSHIP_STEPS,
        "ec membership")
    for k in ("K7", "K6 encode", "K6 decode", "K2"):
        check(counters[k] > 0, f"ec membership card run: {k} never "
                               f"launched: {counters}")
    card = {"phase": "ec_membership_card_equals_cpu", **card,
            "launches_card": counters, "walls_s": walls, "equal": equal}
    emit(card)
    return {"launches": counters}


# --------------------------------------------------------------- phase 5
def _events_ms(fn, reps, inner=1, before=None):
    """Median device ms of one ``fn`` call: CUDA events around ``inner``
    back-to-back calls, ``reps`` times (``before`` runs outside them)."""
    import torch

    for _ in range(2):
        if before:
            before()
        fn()
    times = []
    for _ in range(reps):
        if before:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _host_ms(fn, reps):
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


#: what the profiled windows lost: sessions run, leading pad records lost
#: (the most in one session, and in the session of the process's last
#: window), sessions run again behind more pads
PROFILE_LOSS = {"sessions": 0, "max_pads_lost": 0, "last_pads_lost": 0,
                "rerun": 0}


def _device_events(fn, reps, before=None):
    """Device activity of ``reps`` calls under torch.profiler: a list of
    (name, microseconds) for every kernel, copy and fill on the card, and
    the host wall seconds of the profiled loop."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the pads are float64 fills, a type the port never uses on the card,
    # so their records can be told apart and dropped. A profile loses the
    # first device records of its session, more of them the longer the
    # process has run (PERF.md §7), so the window is measured whole only
    # where some leading pad was kept; else the session runs again behind
    # four times the pads.
    pad = torch.zeros(1, dtype=torch.float64, device="cuda")
    trail = 32
    for lead in (256, 1024, 4096):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.05)
            t0 = time.perf_counter()
            for _ in range(reps):
                if before:
                    before()
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for _ in range(trail):
                pad.add_(1)
            torch.cuda.synchronize()
        pads, recs = [], []
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "CUDAFunctorOnSelf_add<double>" in e.name:
                pads.append(e.time_range.start)
            else:
                recs.append(e)
        dev = [(e.name, e.time_range.elapsed_us()) for e in recs]
        first = min((e.time_range.start for e in recs), default=None)
        kept = max(0, len(pads) - trail if first is None
                   else sum(1 for t in pads if t < first))
        PROFILE_LOSS["sessions"] += 1
        PROFILE_LOSS["last_pads_lost"] = lead - kept
        PROFILE_LOSS["max_pads_lost"] = max(PROFILE_LOSS["max_pads_lost"],
                                            lead - kept)
        if kept:
            break
        PROFILE_LOSS["rerun"] += 1
        print(f"a profile kept none of its {lead} leading pads",
              file=sys.stderr)
    return dev, wall


#: the CUDA functions behind each kernel, as the profiler names them (a
#: K3 flight is two launches: the plan and the writer)
KERNEL_FN = {"K1": ("write_window_both_kernel",),
             "K2": ("steady_step_kernel",),
             "K3": ("flight_plan_kernel", "flight_write_kernel"),
             "K4": ("turnover_kernel",),
             "K6 encode": ("gf_table_kernel",),
             "K6 decode": ("gf_table_kernel",),
             "K7": ("gf_table_kernel",), "K2·ec": ("steady_step_kernel",),
             "K3·ec": ("flight_plan_kernel", "flight_write_ec_kernel"),
             "K4·ec": ("turnover_ec_kernel",),
             "K5": ("write_window_cols_kernel",),
             "K2·mesh": ("steady_step_kernel",),
             "K3·mesh": ("flight_plan_kernel", "flight_write_kernel"),
             "K4·mesh": ("turnover_mesh_kernel",)}


def kernel_of(name):
    """The kernel a profiler record belongs to (the first in KERNEL_FN),
    or None."""
    return next((k for k, fns in KERNEL_FN.items()
                 if any(f in name for f in fns)), None)


def kernel_ms(key, fn, reps, before=None, inner=1, split=None, fns=None):
    """The kernel's device time per call (profiler medians; for a kernel
    of several CUDA functions the sum of their medians, each put in
    ``split`` by name), and the wrapper's time per call (CUDA events
    around back-to-back calls). ``fns`` names the CUDA functions when
    ``key`` is not in KERNEL_FN."""
    call_ms = _events_ms(fn, reps, inner=inner, before=before)
    fns = fns or KERNEL_FN[key]
    for attempt in range(6):
        dev, _ = _device_events(fn, reps, before=before)
        mine = {f: [us for name, us in dev if f in name] for f in fns}
        if all(len(v) == reps for v in mine.values()):
            med = {f: statistics.median(v) / 1e3 for f, v in mine.items()}
            if split is not None:
                split.update(med)
            return sum(med.values()), call_ms
        # a profiler session now and then records no device activity
        print(f"profiler session {attempt + 1} recorded "
              f"{ {f: len(v) for f, v in mine.items()} } of {reps} "
              f"launches ({len(dev)} device events: "
              f"{sorted({n for n, _ in dev})[:4]})", file=sys.stderr)
    raise RuntimeError(f"the profiler did not record the launches of "
                       f"{fns}")


def ops_ms(fn, reps):
    """Device time per call of everything ``fn`` runs on the card (a
    library yardstick, a read path of several operations): over its CUDA
    functions, n times the median of each one that runs n times a call,
    summed, from a profiler session that saw every call of each."""
    for attempt in range(6):
        dev, _ = _device_events(fn, reps)
        by_name = {}
        for name, us in dev:
            by_name.setdefault(name, []).append(us)
        if by_name and all(len(v) % reps == 0 for v in by_name.values()):
            return sum(len(v) // reps * statistics.median(v)
                       for v in by_name.values()) / 1e3
        print(f"profiler session {attempt + 1} recorded "
              f"{ {n[:40]: len(v) for n, v in by_name.items()} } of {reps} "
              "calls", file=sys.stderr)
    raise RuntimeError("the profiler did not record the yardstick's calls")


def ring_yardstick(log_payload, log_term, wins, s0, lterm):
    """The turnover's ring writes as one ``index_copy_`` and one ``fill_``
    (exact when T*B = C: every slot has one writer), timed beside K4 and
    K4·mesh and used nowhere in the port."""
    import torch

    T, B, M = wins.shape
    C = log_term.shape[1]
    idx = (s0 + torch.arange(T * B, device=wins.device)) % C
    rows = wins.reshape(T * B, M)

    def yard():
        log_payload.index_copy_(0, idx, rows)
        log_term.fill_(lterm)
    return yard


def time_steady_kernels(cfg, dev, rng, reps, consts=None):
    """K2, K3 and K4 (their in-kernel parity mode with ``consts``) at a
    main-path shape: {key: ((device ms, wrapper ms), plain ms, bytes)},
    and the flight's operands for further K3 timings (with K3's split
    into plan and writer)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    Mk = window_lanes(cfg, consts)
    T = STEPS_PER_FLIGHT
    tag = "" if consts is None else "·ec"
    al = torch.ones(L, dtype=torch.bool, device=dev)
    sl = torch.zeros(L, dtype=torch.bool, device=dev)
    prm = sc.step_params(0, 1, 1, 0, 0, cfg.commit_quorum, L,
                         ec=cfg.ec_enabled)
    out = {}

    # K2: steady steps (each appends and commits B): window read, payload
    # write, term read + write, the state vectors and the out block
    st = steady_state(cfg, dev, 5 * B, rng=rng)
    vecs = sc.pack(st)
    win = rand_window(rng, B, Mk, dev)
    o2 = torch.zeros(2 * L + 5, dtype=torch.int32, device=dev)

    def k2():
        sc.steady_step(vecs, st.log_payload, st.log_term, win, B, al, sl,
                       None, prm, o2, consts)

    def k2p():
        sc.steady_step_plain(vecs, st.log_payload, st.log_term, win, B, al,
                             sl, None, prm, o2, consts)

    step_bytes = B * Mk * 4 + B * M * 4 + 2 * L * B * 4 + 2 * 6 * L * 4 + \
        (2 * L + 5) * 4 + 2 * L
    # what this step needs: no row holds an entry inside its window, so
    # its terms are written and none is read (the prev column is)
    k2_bytes = step_bytes - L * B * 4 + L * 4
    out["K2" + tag] = (kernel_ms("K2" + tag, k2, reps, inner=20),
                       _host_ms(k2p, reps), k2_bytes)

    # K3: one main-path flight, 32 steps over 32 distinct windows (every
    # row accepting, turnover not allowed), so each step reads its own
    # window: T times a K2 step's bytes
    wins32 = torch.stack([rand_window(rng, B, Mk, dev) for _ in range(T)])
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    o3 = torch.zeros(L + 5, dtype=torch.int32, device=dev)
    br = sc.pick_br(B, C)

    def k3(turnover_ok=False):
        return sc.pipeline_flight(vecs, st.log_payload, st.log_term, wins32,
                                  counts, al, sl, None, prm, br, turnover_ok,
                                  o3, consts)

    def k3p():
        sc.pipeline_flight_plain(vecs, st.log_payload, st.log_term, wins32,
                                 counts, al, sl, None, prm, br, False, o3,
                                 sc.workspace(dev), consts)

    split = {}
    out["K3" + tag] = (kernel_ms("K3" + tag, k3, reps, split=split),
                       _host_ms(k3p, reps), T * step_bytes)
    split["record_matches_plain"] = record_matches_plain(
        "K3" + tag, k3, (vecs, st.log_payload, st.log_term), o3, wins32,
        counts, al, sl, None, prm, br, consts)

    # K4: the turnover flight (K3's plan decides on the device, its writer
    # exits, K4 writes)
    def plan():
        k3(turnover_ok=True)

    out["K4" + tag] = k4_timing(cfg, st, vecs, wins32, counts, al, sl, prm,
                                br, o3, reps, consts)
    flight = dict(k3=k3, plan=plan, wins=wins32, counts=counts, prm=prm,
                  br=br, out=o3, slow=sl, split=split)
    if consts is None:      # the parity mode has no library counterpart
        flight["library_ms"] = k4_yardstick_ms(st, vecs, wins32, reps)
    return out, flight


def k4_timing(cfg, st, vecs, wins, counts, al, sl, prm, br, out, reps,
              consts=None):
    """K4 (K4·ec with ``consts``) over the T = len(wins) steps of a
    turnover flight on ``st``, each launch behind K3's plan (which decides
    on the device; its writer exits): ((device ms, wrapper ms), plain ms,
    bytes). The bytes: the window rows that survive the flight (the last
    C/B steps' when T*B laps the ring) read once, every payload and term
    slot written once, the plane read and written."""
    from raft_tpu_torch.core import step_cuda as sc

    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    T, Mk = wins.shape[0], wins.shape[2]
    tag = "" if consts is None else "·ec"
    dev = wins.device

    def plan():
        sc.pipeline_flight(vecs, st.log_payload, st.log_term, wins, counts,
                           al, sl, None, prm, br, True, out, consts)

    k4_calls = [0]

    def k4():
        k4_calls[0] += 1
        sc.turnover_flight(vecs, st.log_payload, st.log_term, wins, T, prm,
                           out, consts)

    def k4p():
        w = sc.workspace(dev)
        sc.pipeline_flight_plain(vecs, st.log_payload, st.log_term, wins,
                                 counts, al, sl, None, prm, br, True, out, w,
                                 consts)
        sc.turnover_flight_plain(vecs, st.log_payload, st.log_term, wins, T,
                                 prm, out, w, consts)

    work = sc.workspace(dev)
    ran4 = int(work[sc.WK_RAN4])
    k4_time = kernel_ms("K4" + tag, k4, reps, before=plan)
    # every timed K4 launch must have written its flight (a profiler
    # session that lost records is run again, with launches of its own)
    check(int(work[sc.WK_RAN4]) - ran4 == k4_calls[0] >= 2 * reps + 2,
          "timed turnover launches did not all run the flight")
    k4_bytes = (min(T * B, C) * Mk * 4 + C * M * 4 + L * C * 4
                + 2 * 6 * L * 4)
    return k4_time, _host_ms(k4p, reps), k4_bytes


def k4_yardstick_ms(st, vecs, wins, reps):
    """The library yardstick of a turnover flight: the rows of its last
    C/B steps (the ones that reach the ring; T*B a multiple of C) as one
    ``index_copy_`` from the flight's start slot, and the term ring as one
    ``fill_``."""
    B = wins.shape[1]
    C = st.log_term.shape[1]
    T = wins.shape[0]
    check(T * B % C == 0, "the yardstick needs one writer a slot")
    return ops_ms(ring_yardstick(st.log_payload, st.log_term,
                                 wins[T - C // B:], int(vecs[2, 0]) % C, 1),
                  reps)


def k2_split(timed):
    """Where a K2 call's time goes: the kernel's device time against the
    wrapper's CUDA-event time per call over back-to-back calls (the
    difference is host work the device waits for)."""
    (ms, call_ms), _, _ = timed
    return {"device_ms": ms, "events_ms_per_call": call_ms,
            "host_us_per_call": (call_ms - ms) * 1e3}


def record_matches_plain(what, flight, state, out, wins, cnt, al, sl, mem,
                         prm, br, consts=None, my=-1, prev=None):
    """One more flight at the timed shape (``flight()`` runs it in place on
    ``state`` = (plane, payload ring, term ring) and ``out``, and returns
    the plan's record), held phase by phase against the plain plan and
    writer (``phase_check``)."""
    before = tuple(x.clone() for x in state)
    rec = flight().clone()
    v, lp, lt = state
    phase_check(what, rec, before, (v, out, lp, lt), wins, cnt, al, sl, mem,
                prm, br, False, consts, my, prev)
    return True


def phase_timing(cfg, dev, card_line, reps=21):
    import torch

    from raft_tpu_torch.core import ring_cuda, step_cuda as sc

    rng = np.random.default_rng(SEED + 2)
    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = L * cfg.shard_words
    rate = mem_rate(card_line)
    al = torch.ones(L, dtype=torch.bool, device=dev)
    out = {}

    # K1: a main-path frontier window (count = B, every row accepting)
    st = steady_state(cfg, dev, 5 * B, rng=rng)
    win = rand_window(rng, B, M, dev)
    win_t = torch.ones(B, dtype=torch.int32, device=dev)
    s = torch.tensor(5 * B % C, dtype=torch.int32, device=dev)
    cnt = torch.tensor(B, dtype=torch.int32, device=dev)
    ws = torch.tensor(5 * B + 1, dtype=torch.int32, device=dev)
    last = st.last_index.clone()

    def k1():
        ring_cuda.write_window_both(st.log_payload, st.log_term, win, win_t,
                                    s, cnt, ws, al, last)

    def k1p():
        ring_cuda.write_window_both_plain(st.log_payload, st.log_term, win,
                                          win_t, s, cnt, ws, al, last)

    # bytes: window read + payload write, term writes (no row holds an
    # entry in the window, so no old term is read), win_t, masks, scalars
    k1_bytes = 2 * B * M * 4 + L * B * 4 + B * 4 + 2 * L * 4 + 12
    out["K1"] = (kernel_ms("K1", k1, reps, inner=20), _host_ms(k1p, reps),
                 k1_bytes)
    # its write yardstick: the same window rows and terms as two
    # index_copy_ calls (all rows accept, nothing to compare)
    idx = (5 * B + torch.arange(B, device=dev)) % C
    wt_rows = win_t[None].expand(L, B).contiguous()

    def k1_yard():
        st.log_payload.index_copy_(0, idx, win)
        st.log_term.index_copy_(1, idx, wt_rows)

    k1_library = ops_ms(k1_yard, reps)
    # the launch floor: the device time of a one-element fill_, by the
    # same method
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = kernel_ms("launch_floor", lambda: one.fill_(7), reps,
                         inner=20, fns=("FillFunctor",))[0]

    steady, fl = time_steady_kernels(cfg, dev, rng, reps)
    out.update(steady)
    # the turnover decision alone: the plan decides, the writer exits
    decision = {}
    plan_ms = kernel_ms("K3", fl["plan"], reps, split=decision)

    # K3 as it runs a flight on the main path (after the leader kill): 8
    # steps with a dead row, on a cluster of its own. Only the live rows'
    # window lanes and term slots need to move.
    st8 = steady_state(cfg, dev, 5 * B, rng=rng)
    v8 = sc.pack(st8)
    dead = torch.tensor([True, True, False], device=dev)
    T8 = 8

    def k3_dead():
        sc.pipeline_flight(v8, st8.log_payload, st8.log_term,
                           fl["wins"][:T8], fl["counts"][:T8], dead,
                           fl["slow"], None, fl["prm"], fl["br"], False,
                           fl["out"])

    dead_split = {}
    dead_ms = kernel_ms("K3", k3_dead, reps, split=dead_split)
    live = L - 1
    dead_bytes = T8 * (2 * B * live * cfg.shard_words * 4
                       + 2 * live * B * 4) + 2 * 6 * L * 4 + (L + 5) * 4
    torch.cuda.synchronize()
    res = {"phase": "timing", "card": card_line, "mem_bytes_per_s": rate,
           "launch_floor_ms": floor_ms,
           "k2_split": k2_split(out["K2"]),
           "k3_split": fl["split"], "k3_decision_only": {
               "ms": plan_ms[0], "call_ms": plan_ms[1], "split": decision},
           "k3_dead_row_8_steps": {
               "ms": dead_ms[0], "call_ms": dead_ms[1], "bytes": dead_bytes,
               "bound_ms": dead_bytes / rate * 1e3, "split": dead_split}}
    for k, ((ms, call_ms), pms, nbytes) in out.items():
        res[k] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms,
                  "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
    res["K4"]["library_ms"] = fl["library_ms"]
    res["K1"]["library_ms"] = k1_library
    res["main_path_profile"] = profile_flights(cfg, dev)
    emit(res)
    return res


def profile_flights(cfg, dev, flights=4):
    """Where a main-path flight's time goes: ``run_device`` over
    ``flights`` saturated flights, host work included (stream generation,
    fold, upload, follower read-back, hashing), under the profiler —
    device time by kernel, and the device's idle share of its wall time."""
    from raft_tpu_torch.northstar import run_device

    B, T = cfg.batch_size, STEPS_PER_FLIGHT
    warm = run_device(cfg, T * B, SEED + 4, device=dev, rows=(1, 2))
    box = {}

    def run():
        box["run"] = run_device(cfg, flights * T * B, SEED + 5, device=dev,
                                state=warm.state, rows=(1, 2))

    events, wall = _device_events(run, 1)
    for r, d in box["run"].row_digests.items():
        check(d == box["run"].input_digest, f"profiled read-back of row {r}")
    by_name = {}
    for name, us in events:
        key = kernel_of(name) or ("copy" if "emcpy" in name else "other")
        by_name[key] = by_name.get(key, 0.0) + us
    busy = sum(by_name.values())
    kern = by_name.get("K3", 0.0) + by_name.get("K4", 0.0)
    return {"flights": flights, "wall_ms": wall * 1e3,
            "kernel_us_per_step": kern / (flights * T),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (wall * 1e6) if wall else None,
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_name.items()}}


# ------------------------------------------------- the EC data plane
def ec_config():
    """BASELINE config 3 (``bench.py`` ``bench_rs53``): 5 replicas holding
    RS(5,3) shards of 264-byte entries (88-byte shards, W = 22 words, M =
    110 lanes), batch 1024, a 32 768-slot ring, commit quorum 4."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=5, entry_bytes=264, batch_size=1024,
                      log_capacity=1 << 15, rs_k=3, rs_m=2,
                      transport="single")


def rand_bytes(rng, shape, dev):
    import torch

    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(
        dev)


def codec_cases(code, dev, rng, B, S, N, note):
    """K6 (encode, and decode for every row set) and K7 against their plain
    versions on the card, and against the NumPy oracle on the host:
    ``S``-byte entries, batches of ``B``, decode windows of ``N``."""
    from itertools import combinations

    from raft_tpu_torch.ec import kernels as ek

    for count in (B, B // 3):            # a full and a partial batch
        data = rand_bytes(rng, (B, S), dev)
        data[count:] = 0
        enc = ek.encode_device(code, data)
        note("K6 encode", max_err([(enc, ek.encode_bitwise(code, data))]))
        check(np.array_equal(enc.cpu().numpy(), code.encode(
            data.cpu().numpy())), "K6 encode != the NumPy oracle")
        fold = ek.encode_fold_device(code, data)
        note("K7", max_err([(fold, ek.encode_fold_plain(code, data)),
                            (fold, ek.fold_shards_device(enc))]))
    data = rand_bytes(rng, (N, S), dev)
    shards = ek.encode_device(code, data)
    # every row set, and the data rows rotated: a decode matrix depends on
    # the serving rows' order, and K6's tables are cached per ordered set
    for rows in [*combinations(range(code.n), code.k),
                 tuple(np.roll(np.arange(code.k), 1).tolist())]:
        sh = shards[list(rows)].contiguous()
        dec = ek.decode_device(code, sh, rows)
        note("K6 decode", max_err([(dec, ek.decode_bitwise(code, sh, rows)),
                                   (dec, data)]))


#: K7's own cases beyond the codec's (code, batch, entry bytes): one
#: entry; a batch that leaves a block partly idle; an odd shard width
#: (Wk = 3, single words); k = 4 with m = 1; the widest code MAX_ROWS
#: allows (16 rows in and out: 64 KB of tables)
K7_CASES = {"config3_b1": ((5, 3), 1, 264),
            "rs63_b1": ((6, 3), 1, 264),
            "config3_partial_block": ((5, 3), 1000, 264),
            "odd_wk": ((5, 3), 1024, 36),
            "k4_m1": ((5, 4), 1024, 256),
            "widest": ((32, 16), 1024, 128)}


def k7_cases(dev, rng, note):
    """K7 against ``encode_fold_plain`` on the card, bit for bit."""
    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.rs import RSCode

    for (n, k), B, S in K7_CASES.values():
        code = RSCode(n, k)
        data = rand_bytes(rng, (B, S), dev)
        note("K7", max_err([(ek.encode_fold_device(code, data),
                             ek.encode_fold_plain(code, data))]))
    return sorted(K7_CASES)


def ring_read_cases(ecfg, dev, rng, note):
    """K6 decoding reads of the log ring in place (``reconstruct`` on the
    card) against the gather of the same window plus the plain decode, on
    a config-3 ring: the whole ring from a slot inside it, a window across
    the seam, a partial window; every decoding row set. Returns the cases
    run."""
    from itertools import combinations

    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.reconstruct import _reconstruct, \
        gather_shard_window
    from raft_tpu_torch.ec.rs import RSCode

    C = ecfg.log_capacity
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    st = steady_state(ecfg, dev, 3 * C + 777, rng=rng)
    windows = {"whole_ring": (2 * C + 778, 3 * C + 777),
               "seam": (3 * C - 300, 3 * C + 200),
               "partial": (3 * C + 100, 3 * C + 419)}
    sets = [rs for rs in combinations(range(code.n), code.k)
            if rs != tuple(range(code.k))] + [(2, 0, 4)]
    n = 0
    for lo, hi in windows.values():
        for rows in sets:
            want = ek.decode_bitwise(
                code, gather_shard_window(st, rows, lo, hi), rows)
            note("K6 decode", max_err([(_reconstruct(st, code, rows, lo, hi),
                                        want)]))
            n += 1
    return {"windows": {k: hi - lo + 1 for k, (lo, hi) in windows.items()},
            "row_sets": len(sets), "cases": n}


def phase_ec_kernels(ecfg, dev, n_random=120):
    """K6, K7 and K2-K4 in their in-kernel parity mode against their plain
    versions on the same inputs, at config 3 and at RS(4,2) with 8-byte
    entries and B = 128."""
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.kernels import parity_consts
    from raft_tpu_torch.ec.rs import RSCode

    rng = np.random.default_rng(SEED + 10)
    C, B, L = ecfg.log_capacity, ecfg.batch_size, ecfg.rows
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    consts = parity_consts(code.n, code.k)
    keys = ("K6 encode", "K6 decode", "K7", "K2·ec", "K3·ec", "K4·ec")
    errs = {k: 0 for k in keys}
    cases = {k: 0 for k in keys}

    def note(key, err):
        errs[key] = max(errs[key], err)
        cases[key] += 1

    # the codec at the main path's shapes: a B-entry tick batch, and a
    # flight's read-back window (C entries) for every C(5,3) row set; the
    # decode also as the read path runs it, on the ring in place
    codec_cases(code, dev, rng, B, ecfg.entry_bytes, C, note)
    ring_reads = ring_read_cases(ecfg, dev, rng, note)
    k7_named = k7_cases(dev, rng, note)
    # RS(6,3): config 3 with a row of headroom (the EC membership path),
    # at config 3's widths: K6 encode, decode for all 20 row sets and a
    # rotated one, K7 on a full and a partial batch
    from itertools import combinations

    rs63 = RSCode(6, 3)
    codec_cases(rs63, dev, rng, B, ecfg.entry_bytes, C, note)
    rs63_sets = len(list(combinations(range(6), 3)))

    def k2(*args, **kw):
        err, commit = k2_case(ecfg, dev, rng, *args, consts=consts, **kw)
        note("K2·ec", err)
        return commit

    ones, none = [1] * L, [0] * L
    base = steady_state(ecfg, dev, 5 * B, rng=rng)
    seam = steady_state(ecfg, dev, 3 * C - B + 300, rng=rng)
    check(k2(base, B, ones, none) == 6 * B, "K2·ec commit")
    k2(seam, B, ones, none)                                    # wrap seam
    k2(seam, 777, ones, [0, 0, 0, 1, 0])                       # partial, slow
    check(k2(base, B, [1, 1, 1, 1, 0], none) == 6 * B,         # dead row:
          "K2·ec commits at 4 of 5")                           # 4 of 5
    check(k2(base, B, [1, 1, 1, 0, 0], none) == 5 * B,         # two dead
          "K2·ec must not commit with two rows dead")
    # the edges; three members hold a majority of 2, which the EC floor
    # lifts to 4: no commit
    cases["K2·ec edges"] = k2_edge_cases(ecfg, dev, rng, k2,
                                         ([1, 1, 1, 0, 0], 5 * B))
    conflict = base.clone()                                    # stale suffix
    conflict.last_index[2] = 5 * B + 700
    conflict.log_term[2, 5 * B:5 * B + 300] = 0
    k2(conflict, B, ones, none, lterm=2, tfloor=5 * B + 1)
    note("K2·ec", scan_case(ecfg, dev, rng, seam, [B, 777, 0, B, 1, B], ones,
                            [0, 0, 0, 0, 1], consts))
    note("K2·ec", scan_case(ecfg, dev, rng, base, [0, B, 300, B],
                            [1, 1, 1, 1, 0], none, consts))

    def flight(*args):
        k4, err, commit = flight_case(ecfg, dev, rng, *args, consts=consts)
        which = "K4·ec" if k4 else "K3·ec"
        note(which, err)
        return which, commit

    T = STEPS_PER_FLIGHT
    full = [B] * T
    check(flight(base, T, 4, full, ones, none, False)[0] == "K3·ec",
          "K3·ec flight")
    part = list(full)
    part[5], part[17] = 300, 0
    check(flight(base, T, 3, part, ones, [0, 0, 1, 0, 0], True)[0]
          == "K3·ec", "infeasible K3·ec")
    check(flight(seam, 8, 8, [B] * 8, [1, 1, 1, 1, 0], none, True)
          == ("K3·ec", 3 * C - B + 300 + 8 * B),
          "dead-row seam flight commits at 4 of 5")
    check(flight(base, 8, 8, [B] * 8, [1, 1, 1, 0, 0], none, True)
          == ("K3·ec", 5 * B), "two dead rows: no commit")
    check(flight(base, T, T, full, ones, none, True)[0] == "K4·ec",
          "K4·ec flight")
    check(flight(base, 2 * T + 5, 7, [B] * (2 * T + 5), ones, none,
                 True)[0] == "K4·ec", "lapped K4·ec")

    # randomized multi-term schedules: kernel path on the card, plain path
    # on the host — at config 3 and at RS(4,2) with 8-byte entries
    rsteps = {"config3": random_ec_schedule(ecfg, dev, n_random, rng)}
    small = RaftConfig(n_replicas=4, entry_bytes=8, batch_size=128,
                       log_capacity=512, rs_k=2, rs_m=2, transport="single")
    codec_cases(RSCode(4, 2), dev, rng, 128, 8, 512, note)
    codec_cases(RSCode(6, 4), dev, rng, B, 64, 4096, note)   # 4 data rows
    # the widest code K6 takes, 16 rows in and out: 64 KB of tables, past
    # the 48 KB a block gets without asking
    wide = RSCode(32, 16)
    data = rand_bytes(rng, (B, 16 * 8), dev)
    enc = ek.encode_device(wide, data)
    note("K6 encode", max_err([(enc, ek.encode_bitwise(wide, data))]))
    rows = tuple(range(31, 15, -1))
    sh = enc[list(rows)].contiguous()
    note("K6 decode", max_err([(ek.decode_device(wide, sh, rows), data)]))
    rsteps["rs42_e8_b128"] = random_ec_schedule(small, dev, n_random // 2,
                                                rng)
    # odd shard widths, W = 1 and W = 3 words: there K3·ec's and K4·ec's
    # row writers move single words instead of word pairs
    import dataclasses

    sc4 = parity_consts(4, 2)
    odd = {}
    for ocfg in (small, dataclasses.replace(small, entry_bytes=24)):
        ob = steady_state(ocfg, dev, 5 * 128, rng=rng)
        for T_, P_, alive_, slow_, want in (
                (4, 4, [1, 1, 1, 0], [0] * 4, "K3·ec"),
                (6, 4, [1] * 4, [0, 0, 1, 0], "K3·ec"),      # 1.5 laps
                (4, 4, [1] * 4, [0] * 4, "K4·ec"),
                (7, 3, [1] * 4, [0] * 4, "K4·ec")):          # lapped
            k4, err, _ = flight_case(ocfg, dev, rng, ob, T_, P_, [128] * T_,
                                     alive_, slow_, True, sc4)
            which = "K4·ec" if k4 else "K3·ec"
            check(which == want, f"odd-W flight: {which} ran, {want} "
                                 "expected")
            note(which, err)
        odd[f"W={ocfg.shard_words}"] = 4
    rsteps["odd_w_flights"] = odd
    for k in errs:
        check(errs[k] == 0, f"{k} differs from its plain version by "
                            f"{errs[k]}")
    emit({"phase": "ec_kernels_vs_plain", "cases": cases,
          "max_abs_err": errs, "random_schedule_steps": rsteps,
          "ring_reads": ring_reads, "k7_cases": k7_named,
          "rs63": {"decode_row_sets": rs63_sets + 1, "entry_bytes":
                   ecfg.entry_bytes, "decode_entries": C, "batch": B}})
    return errs


def random_ec_schedule(cfg, dev, n, rng):
    """Elections, K7-fed ticks (general path and K2), data-lane steady
    scans (K2·ec) and flights (K3·ec / K4·ec) under random fault and
    membership masks."""
    import torch

    from raft_tpu_torch.core.step import replicate_step
    from raft_tpu_torch.core.step_cuda import (steady_pipeline,
                                               steady_scan_replicate)
    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.rs import RSCode

    B, E, C = cfg.batch_size, cfg.entry_bytes, cfg.log_capacity
    code = RSCode(cfg.n_replicas, cfg.rs_k)
    ec = dict(commit_quorum=cfg.commit_quorum,
              ec_consts=ek.parity_consts(code.n, code.k))
    ls = Lockstep(cfg, dev, rng)

    def lanes(counts):
        data = np.zeros((len(counts) * B, E), np.uint8)
        for t, c in enumerate(counts):
            data[t * B:t * B + c] = rng.integers(0, 256, (c, E),
                                                 dtype=np.uint8)
        return torch.from_numpy(data.view(np.int32).reshape(len(counts), B,
                                                            E // 4))

    steps = 0
    while steps < n:
        alive, slow, member = ls.masks()
        kind = rng.choice(["tick", "scan", "flight"], p=[0.35, 0.4, 0.25])
        if kind == "tick":                   # K7-fed: general path or K2
            count = int(rng.choice([0, 3, 17, B // 2 + 1, B]))
            data = rng.integers(0, 256, (B, E), dtype=np.uint8)
            data[count:] = 0
            pay = ek.encode_fold_device(code, torch.from_numpy(data).to(dev))
            check(torch.equal(pay.cpu(), ek.encode_fold_plain(
                code, torch.from_numpy(data))), "ec schedule: K7 vs plain")
            steady = rng.random() < 0.6
            ls(lambda st, *a, **k: replicate_step(ls.comm, st, *a, **k),
               pay, count, ls.leader, ls.term, alive, slow, 0, 0, member,
               ec=True, commit_quorum=cfg.commit_quorum,
               term_floor=ls.floor if steady else None)
            steps += 1
        else:                                # data lanes, in-kernel parity
            if kind == "flight":
                counts, fn = flight_counts(rng, B, C), steady_pipeline
            else:
                counts = [int(rng.choice([0, 3, 17, B // 2 + 1, B]))
                          for _ in range(int(rng.integers(1, 4)))]
                fn = steady_scan_replicate
            ls(lambda st, *a: fn(st, *a, **ec), lanes(counts),
               torch.tensor(counts, dtype=torch.int32), ls.leader, ls.term,
               alive, slow, 0, 0, member, ls.floor)
            steps += len(counts)
        if steps % 25 < 5 or steps >= n:
            ls.check_states(f"ec schedule after {steps} steps")
    return steps


def zero_ec_counters(dev):
    from raft_tpu_torch.ec import kernels as ek

    zero_counters(dev)
    for k in ek.LAUNCHES:
        ek.LAUNCHES[k] = 0


def read_ec_counters(dev):
    from raft_tpu_torch.core import step_cuda
    from raft_tpu_torch.ec import kernels as ek

    w = step_cuda.workspace(dev)
    return {
        "K2": step_cuda.LAUNCHES["steady_step"],
        "K6 encode": ek.LAUNCHES["encode"],
        "K6 decode": ek.LAUNCHES["decode"],
        "K7": ek.LAUNCHES["encode_fold"],
        "K2·ec": step_cuda.LAUNCHES["steady_step_ec"],
        "K3·ec": step_cuda.LAUNCHES["pipeline_flight_ec"],
        "K4·ec": step_cuda.LAUNCHES["turnover_flight_ec"],
        "K3_flights_run": int(w[step_cuda.WK_RAN3]),
        "K4_flights_run": int(w[step_cuda.WK_RAN4]),
    }


def phase_ec_main_path(ecfg, dev, entries=ENTRIES):
    """Config 3 on a fresh cluster through SingleDeviceTransport: election,
    K7-fed ticks, a data-lane steady scan, ``run_device_ec`` to
    ``entries`` committed entries read back through a systematic and a
    decoding row set, a flight with one dead row (committed at 4 of 5), the
    heal of that row, and a flight with two dead rows (no commit)."""
    import torch

    from raft_tpu_torch.core.step_cuda import (steady_pipeline,
                                               steady_scan_replicate)
    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.reconstruct import (gather_shard_window,
                                               heal_replica, reconstruct)
    from raft_tpu_torch.ec.rs import RSCode
    from raft_tpu_torch.northstar import run_device_ec
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    tr = SingleDeviceTransport(ecfg, device=dev)
    R, B, C, E = ecfg.rows, ecfg.batch_size, ecfg.log_capacity, \
        ecfg.entry_bytes
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    consts = ek.parity_consts(code.n, code.k)
    Q = ecfg.commit_quorum
    rng = np.random.default_rng(SEED + 11)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(R, dtype=torch.bool, device=dev)
    sets = ((0, 1, 2), (1, 2, 4))
    h_in = hashlib.sha256()
    h_sets = {rs: hashlib.sha256() for rs in sets}
    zero_ec_counters(dev)
    t_all = time.perf_counter()
    state = tr.init()

    def entries_(counts):
        data = np.zeros((len(counts) * B, E), np.uint8)
        for t, c in enumerate(counts):
            chunk = rng.integers(0, 256, (c, E), dtype=np.uint8)
            data[t * B:t * B + c] = chunk
            h_in.update(chunk.tobytes())
        return data

    def read_back(lo, hi):
        for rs, h in h_sets.items():
            h.update(reconstruct(state, code, rs, lo, hi).tobytes())

    # election: row 0 wins term 1 with every vote
    state, vi = tr.request_votes(state, 0, 1, alive)
    check(int(vi.votes) == R and bool(vi.grants.all()), "ec election")

    # EC ticks as the engine does them: K7 encodes the batch into the log
    # layout, the steady step (K2, ec quorum) replicates it; one partial
    submitted = 0
    for count in (B, 300, B):
        data = entries_([count])
        pay = ek.encode_fold_device(code, torch.from_numpy(data).to(dev))
        state, info = tr.replicate(state, pay, count, 0, 1, alive, quiet,
                                   term_floor=1)
        check(int(info.commit_index) == submitted + count, "ec tick commit")
        read_back(submitted + 1, submitted + count)
        submitted += count

    # steady ticks with in-kernel parity (K2·ec), as one scan; the counts
    # bring the log back to a multiple of the 256-row block, so the
    # flights below qualify for the turnover kernel
    counts = [B, 212, B, B]
    wins = ek.fold_data_lanes(torch.from_numpy(entries_(counts)).to(
        dev)).reshape(len(counts), B, E // 4)
    state, infos = steady_scan_replicate(
        state, wins, torch.tensor(counts, dtype=torch.int32, device=dev), 0,
        1, alive, quiet, 0, 0, None, 1, commit_quorum=Q, ec_consts=consts)
    check(int(infos.commit_index[-1]) == submitted + sum(counts),
          "ec scan commit")
    read_back(submitted + 1, submitted + sum(counts))
    submitted += sum(counts)
    check(submitted % 256 == 0, "ticks end on a block boundary")
    ticks_digest = h_in.hexdigest()
    for rs, h in h_sets.items():
        check(h.hexdigest() == ticks_digest,
              f"read set {rs} of the ticks differs from their input")

    # saturated flights through the port's config-3 entry point (K3
    # decides, K4 turns the ring over), read back through both sets
    run = run_device_ec(ecfg, entries, SEED + 12, transport=tr, state=state,
                        read_sets=sets)
    state = run.state
    submitted += entries
    check(state.commit_index.tolist() == [submitted] * R, "ec flight commit")
    for rs, d in run.set_digests.items():
        check(d == run.input_digest,
              f"read set {rs} of the flights differs from their input")

    def flight(T, alive_rows):
        data = entries_([B] * T)
        w = ek.fold_data_lanes(torch.from_numpy(data).to(dev)).reshape(
            T, B, E // 4)
        al = torch.tensor(alive_rows, dtype=torch.bool, device=dev)
        st, info = steady_pipeline(
            state, w, torch.full((T,), B, dtype=torch.int32, device=dev), 0,
            1, al, quiet, 0, 0, None, 1, commit_quorum=Q, ec_consts=consts)
        return st, info, data

    # one dead row: K3 commits every step at 4 of 5
    T8 = 8
    row4_last = int(state.last_index[4])
    state, info, dead_data = flight(T8, [1, 1, 1, 1, 0])
    check(int(info.commit_index) == submitted + T8 * B,
          "dead-row flight commits at 4 of 5")
    check(int(state.last_index[4]) == row4_last, "the dead row appended")
    lo, hi = submitted + 1, submitted + T8 * B
    for rs in ((0, 1, 2), (1, 2, 3)):
        check(np.array_equal(reconstruct(state, code, rs, lo, hi),
                             dead_data), f"dead-row flight read via {rs}")
    submitted = hi

    # heal row 4 from the data rows: reconstruct, re-encode (K6), install
    state = heal_replica(state, code, 4, (0, 1, 2), row4_last + 1, submitted,
                         1, submitted, B)
    got = gather_shard_window(state, [4], lo, hi).cpu().numpy()[0]
    check(np.array_equal(got, code.encode(dead_data)[4]),
          "healed row 4 holds the encoder's shards")
    check(int(state.last_index[4]) == submitted, "healed row 4's log")
    check(np.array_equal(reconstruct(state, code, (1, 2, 4), lo, hi),
                         dead_data), "read through the healed row")

    # two dead rows: 3 shard-holders < quorum 4, nothing commits, and the
    # committed entries still read back from the data rows
    state, info, _ = flight(4, [1, 1, 1, 0, 0])
    check(int(info.commit_index) == submitted,
          "a flight with two dead rows committed")
    check(state.commit_index.tolist()[:3] == [submitted] * 3,
          "commit moved with two rows dead")
    check(np.array_equal(reconstruct(state, code, (0, 1, 2), lo, hi),
                         dead_data), "committed read with two rows dead")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_all
    counters = read_ec_counters(dev)
    for k, v in counters.items():
        check(v > 0, f"{k} never ran on the EC main path")
    result = {
        "phase": "ec_main_path", "entries_committed": submitted,
        "pipeline_entries": entries, "pipeline_flights": run.flights,
        "ring_laps": entries // C, "healed_entries": T8 * B,
        "ticks_sha256": ticks_digest,
        "flights_sha256_input": run.input_digest,
        "flights_sha256_sets": {",".join(map(str, rs)): d
                                for rs, d in run.set_digests.items()},
        "launches": counters,
        # run_device_ec on the host clock: stream generation, upload,
        # flights, reconstruction from both read sets and the hashing
        "pipeline_wall_s": run.wall_s,
        "pipeline_entries_per_s_wall": entries / run.wall_s,
        "main_path_wall_s": wall,
    }
    emit(result)
    return result


def phase_ec_timing(ecfg, dev, card_line, reps=21):
    import torch

    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.rs import RSCode

    rng = np.random.default_rng(SEED + 13)
    C, B, E = ecfg.log_capacity, ecfg.batch_size, ecfg.entry_bytes
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    consts = ek.parity_consts(code.n, code.k)
    M = ecfg.rows * ecfg.shard_words
    rate = mem_rate(card_line)
    out = {}

    # K6 encode and K7 on a main-path tick batch; K6 decode on a flight's
    # read-back window (C entries from three rows)
    data = rand_bytes(rng, (B, E), dev)
    sk = E // code.k
    out["K6 encode"] = (
        kernel_ms("K6 encode", lambda: ek.encode_device(code, data), reps,
                  inner=20),
        _host_ms(lambda: ek.encode_bitwise(code, data), reps),
        B * E + code.m * B * sk)
    out["K7"] = (
        kernel_ms("K7", lambda: ek.encode_fold_device(code, data), reps,
                  inner=20),
        _host_ms(lambda: ek.encode_fold_plain(code, data), reps),
        B * E + B * M * 4)
    # K7's copy yardstick: one strided copy_ of the data words into the
    # folded layout's systematic columns (no parity), and the launch floor
    # measured beside it
    folded = torch.empty(B, code.n, M // code.n, dtype=torch.int32,
                         device=dev)
    words = data.view(torch.int32).view(B, code.k, M // code.n)
    k7_library = ops_ms(lambda: folded[:, :code.k].copy_(words), reps)
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = kernel_ms("launch_floor", lambda: one.fill_(7), reps,
                         inner=20, fns=("FillFunctor",))[0]
    rows = (1, 2, 4)
    shards = ek.encode_device(code, rand_bytes(rng, (C, E), dev))[
        list(rows)].contiguous()
    out["K6 decode"] = (
        kernel_ms("K6 decode", lambda: ek.decode_device(code, shards, rows),
                  reps, inner=5),
        _host_ms(lambda: ek.decode_bitwise(code, shards, rows), reps),
        2 * code.k * C * sk)
    # the bank probe: all-zero input bytes, so every table lookup of a
    # warp reads one address (no bank conflicts)
    zeros = torch.zeros_like(shards)
    bank = kernel_ms("K6 decode", lambda: ek.decode_device(code, zeros, rows),
                     reps, inner=5)[0]
    read_path = time_read_path(ecfg, dev, rng, reps, rows, rate)

    steady, fl = time_steady_kernels(ecfg, dev, rng, reps, consts)
    out.update(steady)
    decision = {}
    plan_ms = kernel_ms("K3·ec", fl["plan"], reps, split=decision)
    torch.cuda.synchronize()
    res = {"phase": "ec_timing", "card": card_line, "mem_bytes_per_s": rate,
           "k2_split": k2_split(out["K2·ec"]),
           "k3_split": fl["split"], "k3_decision_only": {
               "ms": plan_ms[0], "call_ms": plan_ms[1], "split": decision},
           "k6_bank_probe": {"zero_bytes_ms": bank},
           "k6_read_path": read_path,
           "k7_vs_floor": {"launch_floor_ms": floor_ms}}
    for k, ((ms, call_ms), pms, nbytes) in out.items():
        res[k] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms,
                  "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
    res["K7"]["library_ms"] = k7_library
    res["k7_vs_floor"]["k7_ms"] = res["K7"]["ms"]
    res["k7_vs_floor"]["over_floor_us"] = (res["K7"]["ms"] - floor_ms) * 1e3
    res["ec_path_profile"] = profile_ec_flights(ecfg, dev)
    emit(res)
    return res


def time_read_path(ecfg, dev, rng, reps, rows, rate):
    """A decoding read of one flight's window (T*B = C entries, across the
    seam) from a config-3 ring: before, the window gathered (three torch
    copies) and decoded contiguous (``gather_shard_window`` +
    ``decode_device``); after, ``reconstruct``'s path, K6 on the ring in
    place. Device time per read (every CUDA function of it, profiler) and
    CUDA-event time per call, and K6's own time on the ring."""
    from raft_tpu_torch.ec import kernels as ek
    from raft_tpu_torch.ec.reconstruct import _reconstruct, \
        gather_shard_window
    from raft_tpu_torch.ec.rs import RSCode

    C, B, E = ecfg.log_capacity, ecfg.batch_size, ecfg.entry_bytes
    code = RSCode(ecfg.n_replicas, ecfg.rs_k)
    st = steady_state(ecfg, dev, 3 * C + 5 * B, rng=rng)
    lo, hi = 2 * C + 5 * B + 1, 3 * C + 5 * B
    check((lo - 1) % C != 0, "the timed window crosses the seam")

    def before():
        ek.decode_device(code, gather_shard_window(st, rows, lo, hi), rows)

    def after():
        _reconstruct(st, code, rows, lo, hi)

    check(max_err([(_reconstruct(st, code, rows, lo, hi),
                    ek.decode_device(code, gather_shard_window(
                        st, rows, lo, hi), rows))]) == 0,
          "the ring read differs from the gathered read")
    nbytes = 2 * C * E                # three shards in, the entries out
    return {"rows": list(rows), "entries": hi - lo + 1,
            "before_device_ms": ops_ms(before, reps),
            "before_call_ms": _events_ms(before, reps),
            "after_device_ms": ops_ms(after, reps),
            "after_call_ms": _events_ms(after, reps),
            "k6_ring_ms": kernel_ms("K6 decode", after, reps)[0],
            "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}


def profile_ec_flights(ecfg, dev, flights=4):
    """Where an EC flight's time goes: ``run_device_ec`` over ``flights``
    flights with their host work (stream generation, upload, both read
    sets' reconstruction, hashing) under the profiler."""
    from raft_tpu_torch.northstar import run_device_ec

    B, T = ecfg.batch_size, STEPS_PER_FLIGHT
    warm = run_device_ec(ecfg, T * B, SEED + 14, device=dev)
    box = {}

    def run():
        box["run"] = run_device_ec(ecfg, flights * T * B, SEED + 15,
                                   device=dev, state=warm.state)

    events, wall = _device_events(run, 1)
    for rs, d in box["run"].set_digests.items():
        check(d == box["run"].input_digest, f"profiled read set {rs}")
    by_name = {}
    for name, us in events:
        key = next((k for k in ("K3·ec", "K4·ec", "K6 decode")
                    if any(f in name for f in KERNEL_FN[k])),
                   "copy" if "emcpy" in name else "other")
        by_name[key] = by_name.get(key, 0.0) + us
    busy = sum(by_name.values())
    kern = by_name.get("K3·ec", 0.0) + by_name.get("K4·ec", 0.0)
    return {"flights": flights, "wall_ms": wall * 1e3,
            "entries_per_s_wall": flights * T * B / wall,
            "kernel_us_per_step": kern / (flights * T),
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (wall * 1e6) if wall else None,
            "device_ms_by_kind": {k: v / 1e3 for k, v in by_name.items()}}


# ------------------------------------------ the multi-Raft group plane
GROUP_K = 32          # ticks per fused launch at config B


def group_config_a():
    """Config A, "multi-Raft G=16" (``bench.py`` ``bench_multi_group`` row
    G=16 and its device leg ``_multi_device_scan``): 16 groups of 3
    replicas, 256-byte entries (W = 64, M = 192), batch 256, a 4096-slot
    ring per group."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=256, batch_size=256,
                      log_capacity=1 << 12, transport="single"), 16


def group_config_b():
    """Config B, "multi-Raft G=1024 fused" (``bench.py``
    ``_group_shard_sweep`` row G=1024, its single-device leg): 1024 groups
    of 3 replicas, 64-byte entries (W = 16, M = 48), batch 16, a 1024-slot
    ring per group, K = 32 ticks per fused launch."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=64, batch_size=16,
                      log_capacity=1 << 10, transport="single"), 1024


def dev_rand(rng, shape, dev):
    """Random int32 words of ``shape`` made on the card from a seed."""
    import torch

    g = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 30)))
    return torch.randint(-2**31, 2**31 - 1, shape, generator=g, device=dev,
                         dtype=torch.int32)


def lane_masks(rng, G, M, R):
    """Per-group lane masks: random lanes (partly selected 16-byte
    vectors), whole replica blocks (what the group step passes), and every
    lane (the whole-vector path)."""
    m = rng.random((G, M)) < 0.6
    for g in range(0, G, 3):
        m[g] = np.repeat(rng.random(R) < 0.7, M // R)
    m[1::7] = True
    return m


def k5_case(dev, buf, win, starts, counts, lanes):
    """K5 and its plain version on clones of ``buf``, on the card: (max
    error, the kernel's result)."""
    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.core.ring import write_window_cols_xla

    s = torch.tensor(starts, dtype=torch.int32, device=dev)
    c = torch.tensor(counts, dtype=torch.int32, device=dev)
    sel = torch.tensor(lanes, dtype=torch.bool, device=dev)
    a, b = buf.clone(), buf.clone()
    ring_cuda.write_window_cols(a, win, s, c, sel)
    write_window_cols_xla(b, win, s, c, sel)
    torch.cuda.synchronize()
    return max_err([(a, b)]), a


class GroupLockstep:
    """G groups held twice — the group programs (K5) on the card, their
    plain versions on the host — and stepped in lock step: every output
    and every state leaf must agree after every call."""

    def __init__(self, cfg, G, dev):
        from raft_tpu_torch.core.state import init_group_state

        self.dev = dev
        self.sts = {"k": init_group_state(cfg, G, device=dev),
                    "p": init_group_state(cfg, G, device="cpu")}

    def __call__(self, fn, *args):
        import torch

        from raft_tpu_torch.core.state import FIELDS

        outs = {}
        for side, d in (("k", self.dev), ("p", "cpu")):
            conv = [a.to(d) if isinstance(a, torch.Tensor) else a
                    for a in args]
            self.sts[side], *outs[side] = fn(self.sts[side], *conv)
        for a, b in zip(outs["k"], outs["p"]):
            for x, y in zip(*(t if isinstance(t, tuple) else (t,)
                              for t in (a, b))):
                check(torch.equal(x.cpu(), y), "group schedule output")
        for f in FIELDS:
            check(torch.equal(getattr(self.sts["k"], f).cpu(),
                              getattr(self.sts["p"], f)),
                  f"group schedule: state.{f}")
        return outs["k"]


def random_group_schedule(cfg, G, dev, n, rng):
    """Elections, repair-capable and steady group ticks and fused launches
    under random slow rows, dead rows, masked groups, term changes and
    member masks, with a fabricated stale-term conflict now and then.
    Returns (steps, truncating conflicts seen)."""
    import torch

    from raft_tpu_torch.core.step import (fused_group_scan,
                                          group_replicate_step,
                                          group_vote_step)

    R, B, W = cfg.rows, cfg.batch_size, cfg.shard_words
    C = cfg.log_capacity
    vote = group_vote_step(R)
    rep = {r: group_replicate_step(R, repair=r) for r in (True, False)}
    fused = fused_group_scan(R)
    ls = GroupLockstep(cfg, G, dev)
    gi = np.arange(G)
    leader, term = gi % R, np.ones(G, np.int64)

    def t(a, dtype=torch.int32):
        return torch.from_numpy(np.asarray(a)).to(dtype)

    def words(*lead):
        return dev_rand(rng, lead + (B, W), dev)

    ls(vote, t(leader), t(term), torch.ones(G, R, dtype=torch.bool))
    counts_of = [0, 1, 17, B - 1, B]
    steps = conflicts = 0
    while steps < n:
        elect = rng.random(G) < 0.1
        if elect.any():
            term = term + elect * rng.integers(1, 3, G)
            leader = np.where(elect, rng.integers(0, R, G), leader)
            al = (rng.random((G, R)) > 0.2) & elect[:, None]
            al[gi, leader] = elect
            ls(vote, t(leader), t(term), t(al, torch.bool))
        alive = rng.random((G, R)) > 0.1
        alive[gi, leader] = True
        slow = rng.random((G, R)) < 0.15
        masked = rng.random(G) < 0.15
        alive[masked] = False
        terms = np.where(masked, 0, term)
        member = np.ones((G, R), bool)
        if rng.random() < 0.2:
            member = rng.random((G, R)) < 0.8
            member[gi, leader] = True
        masks = (t(alive, torch.bool), t(slow, torch.bool),
                 t(member, torch.bool))
        if rng.random() < 0.2:
            K = int(rng.integers(2, 5))
            counts = rng.choice(counts_of, (K, G))
            ls(fused, words(K, G), t(counts), int(rng.integers(1, K + 1)),
               t(rng.random(G) < 0.2, torch.bool), t(leader), t(terms),
               *masks)
            steps += K
        else:
            counts = rng.choice(counts_of, G)
            ls(rep[bool(rng.random() < 0.7)], words(G).repeat(1, 1, R),
               t(counts), t(leader), t(terms), *masks)
            steps += 1
        if steps % 10 < 2:
            conflicts += group_conflict(ls, vote, rep[True], leader, term,
                                        words(G).repeat(1, 1, R), C)
    return steps, conflicts


def group_conflict(ls, vote, rep, leader, term, pays, C):
    """A stale-term conflict in one group: a caught-up follower is given
    two entries of the current term past the leader's log; the leader is
    re-elected in the next term, and its one-entry window must truncate the
    follower to it. Returns 1 when a group qualified, else 0."""
    import torch

    p = ls.sts["p"]
    G, R = p.term.shape
    for g in range(G):
        lg = int(leader[g])
        last = int(p.last_index[g, lg])
        rows = [r for r in range(R) if r != lg
                and int(p.last_index[g, r]) == last and last > 0
                and int(p.log_term[g, r, (last - 1) % C])
                == int(p.log_term[g, lg, (last - 1) % C])
                and int(p.term[g, r]) <= int(term[g])]
        if rows:
            break
    else:
        return 0
    r = rows[0]
    for st in ls.sts.values():
        st.last_index[g, r] = last + 2
        st.log_term[g, r, [last % C, (last + 1) % C]] = int(term[g])
    term[g] += 1
    one = torch.zeros(G, R, dtype=torch.bool)
    one[g] = True
    ls(vote, torch.from_numpy(leader.astype(np.int32)),
       torch.from_numpy(term.astype(np.int32)), one)
    counts = torch.zeros(G, dtype=torch.int32)
    counts[g] = 1
    ls(rep, pays, counts, torch.from_numpy(leader.astype(np.int32)),
       torch.from_numpy(np.where(np.arange(G) == g, term, 0).astype(
           np.int32)), one, torch.zeros(G, R, dtype=torch.bool),
       torch.ones(G, R, dtype=torch.bool))
    check(int(ls.sts["p"].last_index[g, r]) == last + 1,
          "the stale-term conflict did not truncate")
    return 1


def phase_group_kernels(dev, n_random=60):
    """K5 against its plain version on the card, bit for bit, at both
    group configurations' shapes, then a randomized multi-group schedule at
    config A's widths (kernel path on the card, plain path on the host)."""
    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.core.ring import write_window_cols_xla

    rng = np.random.default_rng(SEED + 20)
    err, cases = 0, 0
    for cfg, G in (group_config_a(), group_config_b()):
        C, B, R = cfg.log_capacity, cfg.batch_size, cfg.rows
        M = R * cfg.shard_words
        seam = [0, C // 2 + 5, C - B, C - B + 11, C - 1]
        cnts = [0, 1, 17, B - 1, B]
        starts = [seam[g % 5] for g in range(G)]
        counts = [cnts[(g + g // 5) % 5] for g in range(G)]
        buf = dev_rand(rng, (G, C, M), dev)
        win = dev_rand(rng, (G, B, M), dev)
        e, _ = k5_case(dev, buf, win, starts, counts,
                       lane_masks(rng, G, M, R))
        err, cases = max(err, e), cases + 1
        e, out = k5_case(dev, buf, win, starts, [B] * G,
                         np.zeros((G, M), bool))
        check(torch.equal(out, buf), "K5 with every lane rejected wrote")
        err, cases = max(err, e), cases + 1
        # G = 1: one ring, unbatched and batched
        for one in (buf[0], buf[:1]):
            a, b = one.clone(), one.clone()
            sel = torch.from_numpy(rng.random(M) < 0.6).to(dev)
            sel = sel if one.dim() == 2 else sel[None]
            w = win[0] if one.dim() == 2 else win[:1]
            s = torch.tensor(C - B + 11, dtype=torch.int32, device=dev)
            ring_cuda.write_window_cols(a, w, s, B - 3, sel)
            write_window_cols_xla(b, w, s, B - 3, sel)
            err, cases = max(err, max_err([(a, b)])), cases + 1
        del buf, win
    cfg, _ = group_config_a()
    steps, conflicts = random_group_schedule(cfg, 8, dev, n_random, rng)
    check(err == 0, f"K5 differs from its plain version by {err}")
    check(conflicts > 0, "no stale-term conflict in the group schedule")
    res = {"phase": "group_kernels_vs_plain", "cases": cases,
           "max_abs_err": err, "random_schedule_steps": steps,
           "random_schedule_groups": 8, "conflicts_truncated": conflicts}
    emit(res)
    return res


class GroupStream:
    """Each group's client stream: seeded entries, the group's input hash
    in index order, and the hash of what one follower row (``(g + 1) %
    R``; the leader is ``g % R``) has committed, read back once a ring lap
    at the latest."""

    def __init__(self, cfg, G, seed):
        self.rng = np.random.default_rng(seed)
        self.cfg, self.G = cfg, G
        self.rows = [(g + 1) % cfg.rows for g in range(G)]
        self.h_in = [hashlib.sha256() for _ in range(G)]
        self.h_row = [hashlib.sha256() for _ in range(G)]
        self.done = np.zeros(G, np.int64)
        self.submitted = np.zeros(G, np.int64)

    def entries(self, counts, dev):
        """Entries for windows of ``counts`` [T, G] (zero past each count),
        as untiled words i32[T, G, B, W] on ``dev``."""
        import torch

        T, G = counts.shape
        B, E = self.cfg.batch_size, self.cfg.entry_bytes
        data = self.rng.integers(0, 256, (T, G, B, E), dtype=np.uint8)
        keep = np.arange(B)[None, None, :] < counts[:, :, None]
        data[~keep] = 0
        for g in range(G):
            self.h_in[g].update(data[:, g][keep[:, g]].tobytes())
        self.submitted += counts.sum(axis=0)
        return torch.from_numpy(data).to(dev).view(torch.int32)

    def read_back(self, state):
        """Hash every entry each group's follower row committed since the
        last read, checking that none was overwritten before it."""
        import torch

        C, R = self.cfg.log_capacity, self.cfg.rows
        W, G = self.cfg.shard_words, self.G
        dev = state.device
        rows = torch.tensor(self.rows, device=dev)
        gi = torch.arange(G, device=dev)
        hi = state.commit_index[gi, rows].cpu().numpy().astype(np.int64)
        last = state.last_index.amax(dim=1).cpu().numpy().astype(np.int64)
        lo = self.done + 1
        check(bool((lo > last - C).all()),
              "a committed entry was overwritten before its read-back")
        n = int((hi - lo + 1).max())
        if n <= 0:
            return
        idx = np.clip(lo[:, None] + np.arange(n)[None, :], 1, None)
        slots = torch.from_numpy((idx - 1) % C).to(dev)
        words = state.log_payload.view(G, C, R, W)[
            gi[:, None], slots, rows[:, None]]
        got = words.cpu().numpy().view(np.uint8)
        for g in range(G):
            k = int(hi[g] - lo[g] + 1)
            if k > 0:
                self.h_row[g].update(got[g, :k].tobytes())
        self.done = np.maximum(self.done, hi)

    def check_digests(self, what):
        check(bool((self.done == self.submitted).all()),
              f"{what}: not every submitted entry was read back")
        bad = [g for g in range(self.G)
               if self.h_row[g].digest() != self.h_in[g].digest()]
        check(not bad, f"{what}: read-back of groups {bad[:8]} differs "
                       f"from their input")


def group_leaves(state, groups):
    """Clones of the given groups' leaves (for bit-unchanged checks)."""
    from raft_tpu_torch.core.state import FIELDS

    return [getattr(state, f)[groups].clone() for f in FIELDS]


def group_main_a(dev):
    """Config A through the group programs: round-robin election, 8
    repair-capable ticks with a slow follower in half the groups and one
    group masked, heal by the repair window, then T = 64 saturated steps
    in which every group commits 64·B; per-group read-back, and one group
    held against the single-group port path fed the same inputs."""
    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.core.comm import SingleDeviceComm, take_groups
    from raft_tpu_torch.core.state import (FIELDS, group_view,
                                           init_group_state, init_state)
    from raft_tpu_torch.core.step import (group_replicate_step,
                                          group_vote_step, replicate_step,
                                          vote_step)

    cfg, G = group_config_a()
    R, B, C = cfg.rows, cfg.batch_size, cfg.log_capacity
    T, SH, MASKED = 64, 4, G - 1
    vote, rep = group_vote_step(R), group_replicate_step(R)
    S = GroupStream(cfg, G, SEED + 21)
    gi = torch.arange(G, device=dev)
    leaders = (gi % R).to(torch.int32)
    ones = torch.ones(G, dtype=torch.int32, device=dev)
    alive = torch.ones(G, R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(G, R, dtype=torch.bool, device=dev)
    comm = SingleDeviceComm(R)
    ring_cuda.LAUNCHES["write_window_cols"] = 0
    t0 = time.perf_counter()
    state = init_group_state(cfg, G, device=dev)
    shadow = init_state(cfg, device=dev)
    state, vi = vote(state, leaders, ones, alive)
    check(vi.votes.tolist() == [R] * G, "round-robin election")
    shadow, _ = vote_step(comm, shadow, SH % R, 1, alive[SH])

    def tick(counts, slow=quiet, alive_=alive, terms=ones):
        nonlocal state, shadow
        cnt = np.asarray(counts, np.int64)
        pays = S.entries(cnt[None], dev)[0].repeat(1, 1, R)
        c = torch.from_numpy(cnt.astype(np.int32)).to(dev)
        state, info = rep(state, pays, c, leaders, terms, alive_, slow,
                          alive)
        shadow, _ = replicate_step(comm, shadow, pays[SH], c[SH], SH % R,
                                   terms[SH], alive_[SH], slow[SH],
                                   member=alive[SH])
        check(torch.equal(info.frontier_len, c), "group ingest")
        return info

    # 8 repair-capable ticks: row 2 slow in the first 8 groups it does not
    # lead (half the groups), group 15 masked
    slow = quiet.clone()
    lagging = [g for g in range(G) if g % R != 2][:G // 2]
    slow[lagging, 2] = True
    live = alive.clone()
    live[MASKED] = False
    terms = ones.clone()
    terms[MASKED] = 0
    masked0 = group_leaves(state, [MASKED])
    full = [B] * G
    full[MASKED] = 0
    for _ in range(8):
        info = tick(full, slow, live, terms)
    check(not info.match[lagging, 2].any(), "slow rows stayed behind")
    for a, b in zip(masked0, group_leaves(state, [MASKED])):
        check(torch.equal(a, b), "the masked group changed")
    # heal: heartbeat ticks; each repair window (K5) carries B entries
    heal = 0
    while True:
        lag = take_groups(state.last_index, leaders)[:, None] \
            - state.match_index
        if not bool(lag.any()):
            break
        before = state.match_index[lagging, 2].clone()
        info = tick([0] * G)
        heal += 1
        moved = state.match_index[lagging, 2] - before
        check(bool((moved == B).all()) or heal > 1,
              "the first repair window did not carry B entries")
        check(heal <= 10, "the repair window did not heal the slow rows")
    S.read_back(state)
    # T saturated steps: every group ingests and commits a full batch
    c0 = take_groups(state.commit_index, leaders).clone()
    for step in range(T):
        tick([B] * G)
        if (step + 1) % (C // B) == 0:
            S.read_back(state)
    S.read_back(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ring_cuda.LAUNCHES["write_window_cols"]
    commit = take_groups(state.commit_index, leaders)
    check(torch.equal(commit - c0, torch.full_like(c0, T * B)),
          "every group commits 64·B in the saturated steps")
    check(commit.tolist() == S.submitted.tolist(), "every entry committed")
    S.check_digests("config A")
    view = group_view(state, SH)
    for f in FIELDS:
        check(torch.equal(getattr(view, f), getattr(shadow, f)),
              f"group {SH} differs from the single-group path: {f}")
    check(launches > 0, "K5 never ran on config A's path")
    return {"groups": G, "entries_committed": int(S.submitted.sum()),
            "entries_per_group": int(S.submitted[0]),
            "ring_laps": int(S.submitted[0]) // C, "heal_ticks": heal,
            "saturated_steps": T, "k5_launches": launches,
            "sha256_group0": S.h_in[0].hexdigest(),
            "wall_s": wall}


def group_main_b(dev):
    """Config B through ``fused_group_scan``: 4 chained K = 32 launches
    with no escape (every group commits 128·B, 2 ring laps, read back per
    launch), then a launch in which 64 groups lose two rows (they escape
    at their first tick and halt; the rest commit K·B), then a launch with
    ``halted0`` that must leave the halted groups bit-unchanged."""
    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.core.comm import take_groups
    from raft_tpu_torch.core.state import init_group_state
    from raft_tpu_torch.core.step import fused_group_scan, group_vote_step

    cfg, G = group_config_b()
    R, B, K = cfg.rows, cfg.batch_size, GROUP_K
    fused, vote = fused_group_scan(R), group_vote_step(R)
    S = GroupStream(cfg, G, SEED + 22)
    gi = torch.arange(G, device=dev)
    leaders = (gi % R).to(torch.int32)
    ones = torch.ones(G, dtype=torch.int32, device=dev)
    alive = torch.ones(G, R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(G, R, dtype=torch.bool, device=dev)
    none = torch.zeros(G, dtype=torch.bool, device=dev)
    full = np.full((K, G), B, np.int64)
    counts = torch.full((K, G), B, dtype=torch.int32, device=dev)
    ring_cuda.LAUNCHES["write_window_cols"] = 0
    t0 = time.perf_counter()
    state = init_group_state(cfg, G, device=dev)
    state, vi = vote(state, leaders, ones, alive)
    check(vi.votes.tolist() == [R] * G, "round-robin election")

    def commits():
        return take_groups(state.commit_index, leaders)

    for _ in range(4):
        state, _, esc, _, halted = fused(state, S.entries(full, dev), counts,
                                         K, none, leaders, ones, alive,
                                         quiet, alive)
        check(not bool(esc.any()) and not bool(halted.any()),
              "a clean launch escaped")
        S.read_back(state)
    check(commits().tolist() == [4 * K * B] * G, "every group commits 128·B")
    S.check_digests("config B")
    # 64 groups lose both followers: a commit stall at their first tick
    lost = gi[::G // 64]
    cut = alive.clone()
    cut[lost] = False
    cut[lost, leaders[lost].long()] = True
    pays = dev_rand(np.random.default_rng(SEED + 23),
                    (K, G, B, cfg.shard_words), dev)
    c0 = commits().clone()
    state, _, esc, ran, halted = fused(state, pays, counts, K, none,
                                       leaders, ones, cut, quiet, alive)
    want = torch.zeros(G, dtype=torch.bool, device=dev)
    want[lost] = True
    check(torch.equal(halted, want) and torch.equal(esc[0].bool(), want)
          and int(esc.sum()) == len(lost), "the cut groups escape at once")
    check(not bool(ran[1:, lost].any()), "a halted group ran on")
    gain = commits() - c0
    check(bool((gain[~want] == K * B).all()) and not bool(gain[want].any()),
          "the other groups commit K·B, the cut ones nothing")
    kept = group_leaves(state, lost)
    state, _, esc, ran, halted2 = fused(state, pays, counts, K, halted,
                                        leaders, ones, alive, quiet, alive)
    for a, b in zip(kept, group_leaves(state, lost)):
        check(torch.equal(a, b), "a halted group changed")
    check(torch.equal(halted2, halted) and not bool(ran[:, lost].any()),
          "halted0 did not thread across the launch")
    check(bool((commits() - c0)[~want].eq(2 * K * B).all()),
          "the running groups commit on")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ring_cuda.LAUNCHES["write_window_cols"]
    check(launches > 0, "K5 never ran on config B's path")
    return {"groups": G, "ticks_per_launch": K,
            "entries_committed_read_back": int(S.submitted.sum()),
            "entries_per_group": int(S.submitted[0]),
            "ring_laps": int(S.submitted[0]) // cfg.log_capacity,
            "escaped_groups": int(len(lost)), "k5_launches": launches,
            "sha256_group0": S.h_in[0].hexdigest(), "wall_s": wall}


def phase_group_main_path(dev):
    res = {"phase": "group_main_path", "config_a": group_main_a(dev),
           "config_b": group_main_b(dev)}
    emit(res)
    return res


def k5_timing(cfg, G, dev, rng, rate, reps):
    """K5 on a frontier window of ``G`` groups at ``cfg`` (every row
    accepts, count = B): device ms, its plain version, the byte bound and
    the write yardstick (every group's window rows as one ``index_copy_``
    over the flattened (group, slot) rows)."""
    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.core.ring import write_window_cols_xla

    C, B, M = cfg.log_capacity, cfg.batch_size, cfg.rows * cfg.shard_words
    buf = dev_rand(rng, (G, C, M), dev)
    win = dev_rand(rng, (G, B, M), dev)
    s = torch.from_numpy(rng.integers(0, C, G).astype(np.int32)).to(dev)
    cnt = torch.full((G,), B, dtype=torch.int32, device=dev)
    sel = torch.ones(G, M, dtype=torch.bool, device=dev)
    ms, call_ms = kernel_ms("K5", lambda: ring_cuda.write_window_cols(
        buf, win, s, cnt, sel), reps, inner=20)
    plain = _host_ms(lambda: write_window_cols_xla(buf, win, s, cnt, sel),
                     reps)
    nbytes = 2 * G * B * M * 4 + G * M + 2 * G * 4
    idx = (torch.arange(G, device=dev)[:, None] * C
           + (s.long()[:, None] + torch.arange(B, device=dev)) % C
           ).reshape(-1)
    flat, rows = buf.view(G * C, M), win.view(G * B, M)
    library = ops_ms(lambda: flat.index_copy_(0, idx, rows), reps)
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain,
            "bytes": nbytes, "bound_ms": nbytes / rate * 1e3,
            "library_ms": library}


def phase_group_timing(dev, card_line, reps=21):
    """K5 per launch at both configurations' frontier windows (and at
    ``multi_card_equals_cpu``'s G = 4 shape) beside its plain version and
    byte bound; µs per group tick of config A's step
    and of config B's fused launch (CUDA events); the device idle share
    of both (torch.profiler)."""
    import torch

    from raft_tpu_torch.core.state import init_group_state
    from raft_tpu_torch.core.step import (fused_group_scan,
                                          group_replicate_step,
                                          group_vote_step)

    rng = np.random.default_rng(SEED + 24)
    rate = mem_rate(card_line)
    res = {"phase": "group_timing", "card": card_line,
           "mem_bytes_per_s": rate}
    for name, (cfg, G) in (("A", group_config_a()), ("B", group_config_b())):
        B, R, W = cfg.batch_size, cfg.rows, cfg.shard_words
        res[f"K5 {name}"] = k5_timing(cfg, G, dev, rng, rate, reps)
        cnt = torch.full((G,), B, dtype=torch.int32, device=dev)
        # the group tick on a steady cluster: every group ingests B
        gi = torch.arange(G, device=dev)
        leaders = (gi % R).to(torch.int32)
        ones = torch.ones(G, dtype=torch.int32, device=dev)
        alive = torch.ones(G, R, dtype=torch.bool, device=dev)
        quiet = torch.zeros(G, R, dtype=torch.bool, device=dev)
        box = {"st": group_vote_step(R)(init_group_state(cfg, G, device=dev),
                                        leaders, ones, alive)[0]}
        if name == "A":
            rep = group_replicate_step(R)
            pays = dev_rand(rng, (G, B, W), dev).repeat(1, 1, R)

            def fn():
                box["st"], _ = rep(box["st"], pays, cnt, leaders, ones,
                                   alive, quiet, alive)

            ticks = G
        else:
            fused = fused_group_scan(R)
            pays = dev_rand(rng, (GROUP_K, G, B, W), dev)
            counts = torch.full((GROUP_K, G), B, dtype=torch.int32,
                                device=dev)
            none = torch.zeros(G, dtype=torch.bool, device=dev)

            def fn():
                box["st"], *_ = fused(box["st"], pays, counts, GROUP_K, none,
                                      leaders, ones, alive, quiet, alive)

            ticks = G * GROUP_K
        call = _events_ms(fn, 7 if name == "A" else 3)
        events, wall = _device_events(fn, 4 if name == "A" else 2)
        busy = sum(us for _, us in events)
        k5_us = sum(us for n_, us in events
                    if KERNEL_FN["K5"][0] in n_)
        launches = 4 if name == "A" else 2
        res[f"group_tick_{name}"] = {
            # config A's call is one G-group step: bench.py's
            # device_scan_us_per_step; config B's us_per_group_tick is
            # bench.py's single_device_us_per_group_tick
            "ms_per_call": call, "us_per_group_tick": call * 1e3 / ticks,
            # a host-clock-bound rate over CUDA events, not a device rate
            "entries_per_s_events": ticks * B / (call * 1e-3),
            "device_busy_ms": busy / 1e3,
            "k5_ms_per_call": k5_us / 1e3 / launches,
            "device_idle_share": 1.0 - busy / (wall * 1e6),
            "device_kernels_per_call": len(events) / launches}
    res["K5 small"] = k5_timing(*multi_small_config(), dev, rng, rate, reps)
    torch.cuda.synchronize()
    emit(res)
    return res


# ------------------------------------------------ the multi-Raft engine
#: config A through the engine: entries per group in each wave: warm and
#: timed as ``bench.py``'s ``bench_multi_group`` (one batch, then 2 048
#: from submit to durable ack), then after the failover, and profiled
MULTI_WAVES = (256, 2048, 256, 256)
#: config B through the engine: entries per group in each of its waves
MULTI_B_WAVE = 64
#: config B's waves: the first window is cut short by the election
#: timers, the second captures, the last is profiled, the rest are timed
MULTI_B_WAVES = 10


def multi_config(cfg, **over):
    """A group configuration with ``bench.py``'s seed (``seed=9``)."""
    return dataclasses.replace(cfg, seed=9, **over)


class KvStream:
    """``ShardedKV`` SETs, ``per_group`` for each group: 8-byte keys the
    Router hashes onto the group, values filling the entry, each group's
    encoded ops in order and their SHA-256; ``applied`` hashes each
    group's ``register_apply`` stream."""

    def __init__(self, router, per_group, seed):
        from raft_tpu_torch.examples.kv import encode_op

        eng = router.engine
        E, G = eng.cfg.entry_bytes, eng.G
        rng = np.random.default_rng(seed)
        keys = [[] for _ in range(G)]
        i = full = 0
        while full < G:
            k = b"k%07d" % i
            i += 1
            g = router.group_of(k)
            if len(keys[g]) < per_group:
                keys[g].append(k)
                full += len(keys[g]) == per_group
        vlen = E - 5 - 8
        vals = rng.integers(0, 256, (G, per_group, vlen), dtype=np.uint8)
        self.items = [[(k, vals[g, j].tobytes()) for j, k in enumerate(ks)]
                      for g, ks in enumerate(keys)]
        self.h_in = [hashlib.sha256() for _ in range(G)]
        for g in range(G):
            for k, v in self.items[g]:
                self.h_in[g].update(encode_op(E, 1, k, v))
        self.h_apply = [hashlib.sha256() for _ in range(G)]
        self.n_apply = np.zeros(G, np.int64)
        for g in range(G):
            eng.register_apply(g, self._apply(g))
        self.at = 0

    def _apply(self, g):
        def fn(index, payload):
            check(index == self.n_apply[g] + 1, f"group {g} apply order")
            self.h_apply[g].update(payload)
            self.n_apply[g] = index
        return fn

    def wave(self, n):
        """The next ``n`` items of every group, groups interleaved."""
        a, self.at = self.at, self.at + n
        return [self.items[g][j] for j in range(a, self.at)
                for g in range(len(self.items))]


def drive_durable(e, placed):
    for g, s in placed:
        e.run_until_committed(g, s)


def count_rounds(e):
    """Wrap the engine's tick round and its launch: per-call host ms
    (the launch synchronized) into the returned lists."""
    import torch

    box = {"rounds": [], "launches": []}
    fire, rep = e._fire_leader_ticks, e._replicate_round

    def timed_fire(ticks):
        t0 = time.perf_counter()
        fire(ticks)
        box["rounds"].append((time.perf_counter() - t0) * 1e3)

    def timed_rep(active):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rep(active)
        box["launches"].append((time.perf_counter() - t0) * 1e3)
        return out

    e._fire_leader_ticks, e._replicate_round = timed_fire, timed_rep
    return box


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def phase_engine_multi_path(dev):
    """Config A through ``MultiEngine`` + ``Router`` + ``ShardedKV`` on the
    card: round-robin leaders, SETs in four waves (a warm batch a group;
    2 048 a group timed from submit to durable ack, as ``bench.py``'s
    ``bench_multi_group``; then, outside the timed window, a wave after
    the leaders of a quarter of the groups fail, through the Router's
    retry and the re-elections, and a profiled wave); each group's apply
    stream and committed payloads against the input's SHA-256, gets
    against the model, one linearizable get a group."""
    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.examples import ShardedKV
    from raft_tpu_torch.multi import MultiEngine, Router

    cfg, G = group_config_a()
    cfg = multi_config(cfg)
    hb = cfg.heartbeat_period
    ring_cuda.LAUNCHES["write_window_cols"] = 0
    t_start = time.perf_counter()
    e = MultiEngine(cfg, G)
    e.seed_leaders()
    check(sorted(e.leader_spread().values()) == [5, 5, 6],
          "round-robin leader spread")
    router = Router(e)
    kv = ShardedKV(e, router)
    S = KvStream(router, sum(MULTI_WAVES), SEED + 51)
    drive_durable(e, kv.set_many(S.wave(MULTI_WAVES[0])))
    box = count_rounds(e)
    t_virtual0 = e.clock.now
    t0 = time.perf_counter()
    drive_durable(e, kv.set_many(S.wave(MULTI_WAVES[1])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed = {k: list(v) for k, v in box.items()}
    timed.update(wall=wall, entries=G * MULTI_WAVES[1])
    lat = [e.commit_time[g][s] - e.submit_time[g][s]
           for g in range(G) for s in e.commit_time[g]
           if e.submit_time[g][s] >= t_virtual0]
    # a quarter of the groups lose their leader; the Router's retries
    # drive the event loop until they re-elect
    lost = list(range(G // 4))
    old = {g: e.leader_id[g] for g in lost}
    for g in lost:
        e.fail(g, old[g])
    t1 = time.perf_counter()
    drive_durable(e, kv.set_many(S.wave(MULTI_WAVES[2])))
    failover_wall = time.perf_counter() - t1
    for g in lost:
        check(e.leader_id[g] not in (None, old[g]) and
              int(e.lead_terms[g, e.leader_id[g]]) >= 2,
              f"group {g} re-elected in a later term")
    # profiled: one wave's rounds under torch.profiler
    placed = kv.set_many(S.wave(MULTI_WAVES[3]))
    n0 = len(box["rounds"])
    events, pwall = _device_events(lambda: e.run_for(2 * hb), 1)
    rounds = len(box["rounds"]) - n0
    drive_durable(e, placed)
    torch.cuda.synchronize()
    k5 = ring_cuda.LAUNCHES["write_window_cols"]
    total_wall = time.perf_counter() - t_start
    check(k5 > 0, "K5 never ran on the multi engine's path")
    check((S.n_apply == sum(MULTI_WAVES)).all(), "every SET applied")
    bad = [g for g in range(G)
           if S.h_apply[g].digest() != S.h_in[g].digest()]
    check(not bad, f"apply streams of groups {bad} differ from the input")
    for g in range(G):
        h = hashlib.sha256(b"".join(e.committed_payloads(g)))
        check(h.digest() == S.h_in[g].digest(),
              f"group {g}'s committed payloads differ from the input")
        k, v = S.items[g][-1]
        check(kv.linearizable_get(k) == v and kv.get(S.items[g][0][0]) ==
              S.items[g][0][1], f"group {g}'s gets")
    busy = sum(us for _, us in events)
    res = {
        "phase": "engine_multi_path", "groups": G,
        "entries": int(S.n_apply.sum()),
        "entries_per_group": int(S.n_apply[0]),
        "timed_entries": timed["entries"],
        "timed_wall_s": timed["wall"],
        # bench.py bench_multi_group's metrics over the timed wave
        "entries_per_s_wall": timed["entries"] / timed["wall"],
        "virtual_commit_p50_s": pct(lat, 50),
        "virtual_commit_p99_s": pct(lat, 99),
        # a few rounds: their median and their maximum, no tail percentile
        "tick_rounds": len(timed["rounds"]),
        "ms_per_tick_round_p50": pct(timed["rounds"], 50),
        "ms_per_tick_round_max": max(timed["rounds"]),
        "ms_per_launch_p50": pct(timed["launches"], 50),
        "failover": {"groups": lost, "wall_s": failover_wall,
                     "new_leaders": {str(g): e.leader_id[g] for g in lost}},
        "profiled": {"rounds": rounds, "host_wall_s": pwall,
                     "device_busy_ms": busy / 1e3,
                     "device_idle_share": 1.0 - busy / (pwall * 1e6),
                     "device_kernels_per_round": len(events) / rounds,
                     "k5_per_round": sum(1 for n, _ in events
                                         if KERNEL_FN["K5"][0] in n)
                     / rounds},
        "k5_launches": k5, "wall_s": total_wall,
        "sha256_group0": S.h_in[0].hexdigest(),
    }
    emit(res)
    return res


def group_launch_case(graphs, program, sts, host, K, B, W, rings=None,
                      gids=None, what=""):
    """One fused group launch twice from the same packed inputs: by a
    replay of ``graphs`` on ``sts[0]`` and by the uncaptured loop on
    ``sts[1]`` (``rings`` likewise a pair, or None); every leaf, output
    and ring equal. Returns the two new states."""
    import torch

    from raft_tpu_torch.core.graphs import run_group_launch
    from raft_tpu_torch.obs.device import packed_flush

    a = graphs.run(sts[0], host, K, B, W,
                   *(() if rings is None else (rings[0], gids)))
    b = run_group_launch(program, sts[1], torch.from_numpy(host).to(
        sts[1].term.device), K, B, W,
        *(() if rings is None else (rings[1], gids)))
    oa, ob = fused_outputs(*a[:4], False), fused_outputs(*b[:4], False)
    oa["halted"], ob["halted"] = (x[4].cpu().numpy() for x in (a, b))
    same_outputs(oa, ob, what)
    if rings is not None:
        check(torch.equal(packed_flush(rings[0]), packed_flush(rings[1])),
              f"{what}: the recorded rings differ")
    return a[0], b[0], a[4]


def group_graph_vs_loop(dev):
    """``core.graphs.FusedGroupGraphs`` (one replay of the captured K-tick
    group loop) against ``fused_group_scan`` run uncaptured on the card at
    config B (G = 1024, B = 16, C = 1024), unrecorded and recorded: a
    clean K = 32 window across the ring seam, ``n_run`` < K, 64 groups
    losing two rows (escape at their first tick), masked groups,
    ``halted0`` set, a K = 16 launch, a new event ring and a new group-id
    tensor (each a recapture)."""
    import torch

    from raft_tpu_torch.core.graphs import FusedGroupGraphs, pack_group_launch
    from raft_tpu_torch.core.state import init_group_state
    from raft_tpu_torch.core.step import fused_group_scan, group_vote_step
    from raft_tpu_torch.obs.device import init_group_rings

    cfg, G = group_config_b()
    R, B, W, K = cfg.rows, cfg.batch_size, cfg.shard_words, GROUP_K
    rng = np.random.default_rng(SEED + 52)
    leaders = (np.arange(G) % R).astype(np.int32)
    st = group_vote_step(R)(init_group_state(cfg, G, device=dev),
                            torch.from_numpy(leaders).to(dev), 1,
                            torch.ones(G, R, dtype=torch.bool,
                                       device=dev))[0]
    graphs = FusedGroupGraphs(R, dev)
    cases = 0

    def host(k, n_run, counts=B, alive=None, terms=1, halted=None):
        pays = rng.integers(-2**31, 2**31 - 1, (k, G, B, W)).astype(np.int32)
        return pack_group_launch(
            k, G, R, B, W, n_run=n_run,
            halted0=np.zeros(G) if halted is None else halted,
            leaders=leaders, terms=np.broadcast_to(terms, (G,)),
            counts=np.broadcast_to(counts, (k, G)),
            alive=np.ones((G, R)) if alive is None else alive,
            slow=np.zeros((G, R)), member=np.ones((G, R)), payloads=pays)

    cut = np.ones((G, R), bool)
    lost = np.arange(0, G, G // 64)
    cut[lost] = False
    cut[lost, leaders[lost]] = True
    masked_terms = np.ones(G, np.int32)
    masked_terms[1::5] = 0
    masked_alive = np.ones((G, R), bool)
    masked_alive[1::5] = False
    halted = np.zeros(G, bool)
    halted[lost] = True
    for record in (False, True):
        prog = fused_group_scan(R, record=record)
        sts = [st.clone(), st.clone()]
        rings = gids = None
        if record:
            rings = [init_group_rings(256, G, device=dev) for _ in range(2)]
            gids = torch.arange(G, dtype=torch.int32, device=dev)
        plan = [(K, host(K, K)), (K, host(K, 20)), (K, host(K, K, alive=cut)),
                (K, host(K, K, alive=masked_alive, terms=masked_terms)),
                (K, host(K, K, halted=halted)), (16, host(16, 16)),
                (K, host(K, K)), (K, host(K, K))]
        for i, (k, h) in enumerate(plan):
            if record and i == len(plan) - 2:
                # a new event ring on both sides: the graphs recapture
                rings = [init_group_rings(256, G, device=dev)
                         for _ in range(2)]
            if record and i == len(plan) - 1:
                # a new group-id tensor of the same values: recapture
                gids = gids.clone()
            a, b, halted_out = group_launch_case(
                graphs, prog, sts, h, k, B, W, rings, gids,
                f"group graph case {i} (record={record})")
            sts = [a, b]
            cases += 1
            if i == 2:
                check(np.array_equal(halted_out.cpu().numpy(), halted),
                      "the cut groups, and only they, escape and halt")
    torch.cuda.synchronize()
    check(graphs.recaptures == 2,
          "a new event ring and a new group-id tensor each recapture")
    return {"cases": cases, "captures": graphs.captures,
            "replays": graphs.replays, "recaptures": graphs.recaptures,
            "k5_in_replays": graphs.k5_launches,
            "capture_s": graphs.capture_s}


def group_launch_turns(dev, n=16):
    """The fused group launch alone, at config B, graph against loop in
    turns (ABBA, ``n`` a side after one launch each outside the count):
    one clean K = 32 window from the same packed host inputs, timed on
    the host clock (synchronized) from the upload to the five [K, G]
    output planes the engine books from back on the host; both sides'
    states equal at the end."""
    import torch

    from raft_tpu_torch.core.graphs import (FusedGroupGraphs,
                                            pack_group_launch,
                                            run_group_launch)
    from raft_tpu_torch.core.state import init_group_state
    from raft_tpu_torch.core.step import fused_group_scan, group_vote_step

    cfg, G = group_config_b()
    R, B, W, K = cfg.rows, cfg.batch_size, cfg.shard_words, GROUP_K
    rng = np.random.default_rng(SEED + 55)
    leaders = (np.arange(G) % R).astype(np.int32)
    st = group_vote_step(R)(init_group_state(cfg, G, device=dev),
                            torch.from_numpy(leaders).to(dev), 1,
                            torch.ones(G, R, dtype=torch.bool,
                                       device=dev))[0]
    host = pack_group_launch(
        K, G, R, B, W, n_run=K, halted0=np.zeros(G), leaders=leaders,
        terms=np.ones(G), counts=np.full((K, G), B), alive=np.ones((G, R)),
        slow=np.zeros((G, R)), member=np.ones((G, R)),
        payloads=rng.integers(-2**31, 2**31 - 1, (K, G, B, W)))
    graphs, prog = FusedGroupGraphs(R, dev), fused_group_scan(R)
    sts = {"graph": st.clone(), "loop": st.clone()}

    def one(side):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if side == "graph":
            out = graphs.run(sts[side], host, K, B, W)
        else:
            out = run_group_launch(prog, sts[side], torch.from_numpy(
                host).to(dev), K, B, W)
        infos, esc, ran = out[1:4]
        torch.stack([infos.commit_index, infos.frontier_len,
                     infos.max_term, esc, ran]).cpu()
        sts[side] = out[0]
        return (time.perf_counter() - t0) * 1e3

    first = {side: one(side) for side in ("graph", "loop")}
    ms = {"graph": [], "loop": []}
    for i in range(n):
        for side in (("graph", "loop") if i % 2 == 0 else ("loop", "graph")):
            ms[side].append(one(side))
    a, b = host_leaves(sts["graph"]), host_leaves(sts["loop"])
    for f in a:
        check(np.array_equal(a[f], b[f]),
              f"launch turns: state.{f} differs, graph against loop")
    return {"launches_a_side": n, "first_ms": first,
            **{f"{side}_ms_{k}": fn(ms[side]) for side in ms
               for k, fn in (("p50", statistics.median), ("min", min),
                             ("max", max))},
            "graph_faster_in": sum(x < y for x, y in zip(ms["graph"],
                                                         ms["loop"]))}


class FusedMultiRun:
    """Config B through ``MultiEngine`` at ``fuse_k``, a wave at a time:
    round-robin leaders; each wave submits 64 entries a group and drains
    them by ``run_for`` over 40 heartbeats, and every group's committed
    bytes are read back from a follower row against the input's SHA-256.
    At K = 32 the first wave's window is cut short by the leaders' first
    election timers and the second captures the K = 32 graph. Every
    fused window is timed on the host clock (synchronized), its booking
    apart. With ``graphs=False`` the windows run the uncaptured loop on
    the card."""

    def __init__(self, dev, fuse_k, graphs=True, seed=SEED + 53):
        import torch

        from raft_tpu_torch.multi import MultiEngine

        cfg, G = group_config_b()
        self.cfg = cfg = multi_config(cfg, fuse_k=fuse_k)
        self.e = e = MultiEngine(cfg, G, device=dev)
        if not graphs:
            e._graphs = None
        e.seed_leaders()
        self.S = GroupStream(cfg, G, seed)
        # per wave: its fused windows as (ms, booking ms, ticks)
        self.windows, self.walls, self.prof, self.k5 = [], [], None, 0
        fire, book = e._fire_fused_window, e._book_fused_window
        booked = []

        def timed_book(*args):
            t0 = time.perf_counter()
            book(*args)
            booked.append((time.perf_counter() - t0) * 1e3)

        def timed_fire(ticks, horizon):
            torch.cuda.synchronize()
            t0, k0 = time.perf_counter(), e.fused_ticks
            out = fire(ticks, horizon)
            torch.cuda.synchronize()
            if out:
                self.windows[-1].append(((time.perf_counter() - t0) * 1e3,
                                         booked.pop(), e.fused_ticks - k0))
            return out

        e._book_fused_window, e._fire_fused_window = timed_book, timed_fire

    def wave(self, profile=False):
        """One wave; ``profile``: its first leader instant (one fused
        window at K = 32, the first tick round at K = 1) under
        torch.profiler, the stale timers before it popped outside."""
        import gc

        import torch

        from raft_tpu_torch.core import ring_cuda

        e, cfg, G = self.e, self.cfg, self.e.G
        hb = cfg.heartbeat_period
        k5 = ring_cuda.LAUNCHES["write_window_cols"]
        self.windows.append([])
        counts = np.full((MULTI_B_WAVE // cfg.batch_size, G),
                         cfg.batch_size, np.int64)
        words = self.S.entries(counts, "cpu").numpy()     # [T, G, B, W]
        gc.collect()
        t0 = time.perf_counter()
        for g in range(G):
            for blk in words[:, g]:
                for row in blk:
                    e.submit(g, row.tobytes())
        end = e.clock.now + 40 * hb
        if profile:
            while e._q[0][2] != "l":
                e.step_event(horizon=end)
            n0 = e.fused_launches
            events, pwall = _device_events(
                lambda: e.step_event(horizon=end), 1)
            busy = sum(us for _, us in events)
            self.prof = {"fused_launches": e.fused_launches - n0,
                         "host_wall_ms": pwall * 1e3,
                         "device_busy_ms": busy / 1e3,
                         "device_idle_share": 1.0 - busy / (pwall * 1e6),
                         "device_kernels": len(events)}
        e.run_for(end - e.clock.now)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        self.k5 += ring_cuda.LAUNCHES["write_window_cols"] - k5
        self.S.read_back(e.state)

    def result(self, name):
        """Checks every entry committed and read back; the run's figures,
        its timed waves being all but the first two and the last."""
        e, waves = self.e, len(self.walls)
        check((e.commit_watermark == waves * MULTI_B_WAVE).all(),
              f"{name}: every entry committed")
        self.S.check_digests(f"config B through the engine ({name})")
        timed = [w for ws in self.windows[2:-1] for w in ws]
        out = {
            "wave_walls_s": self.walls,
            "timed_waves_entries_per_s": e.G * MULTI_B_WAVE * (waves - 3)
            / sum(self.walls[2:-1]),
            "fused_launches": e.fused_launches,
            "fused_ticks": e.fused_ticks,
            "windows_by_wave": [[{"ms": m, "booking_ms": bk, "ticks": k}
                                 for m, bk, k in ws] for ws in self.windows],
            "graphs": None if e._graphs is None else {
                "captures": e._graphs.captures,
                "replays": e._graphs.replays,
                "recaptures": e._graphs.recaptures,
                "capture_s": e._graphs.capture_s},
            "profiled_first_instant": self.prof,
            "k5_launches": self.k5,
        }
        if timed:
            ms = [m for m, _, _ in timed]
            book = [bk for _, bk, _ in timed]
            rest = [m - bk for m, bk, _ in timed]
            out["timed_windows"] = {
                "n": len(timed), "ms_p50": statistics.median(ms),
                "ms_min": min(ms), "ms_max": max(ms),
                "booking_ms_p50": statistics.median(book),
                # eligibility, pack, upload, the launch and its fetch
                "rest_ms_p50": statistics.median(rest),
                "rest_ms_min": min(rest), "rest_ms_max": max(rest)}
        return out


def phase_engine_multi_fused_path(dev):
    """Config B (1 024 groups) through ``MultiEngine``: the graph against
    the uncaptured loop (``group_graph_vs_loop``) and in turns
    (``group_launch_turns``); the engine at ``fuse_k`` 32 with the graphs
    and without them (the loop on the card), wave for wave in turns, then
    at ``fuse_k`` 1, on one schedule: every group's bytes read back and
    the three runs equal in every state leaf, commit stamp and clock."""
    import torch

    from raft_tpu_torch.core import ring_cuda

    ring_cuda.LAUNCHES["write_window_cols"] = 0
    cmp = group_graph_vs_loop(dev)
    turns = group_launch_turns(dev)
    ring_cuda.LAUNCHES["write_window_cols"] = 0
    graph_run = FusedMultiRun(dev, GROUP_K, graphs=True)
    loop_run = FusedMultiRun(dev, GROUP_K, graphs=False)
    for w in range(MULTI_B_WAVES):
        for run in ((graph_run, loop_run) if w % 2 == 0
                    else (loop_run, graph_run)):
            run.wave(profile=w == MULTI_B_WAVES - 1)
    runs, ref = {}, None
    for name, run in (("fuse_k_32", graph_run),
                      ("fuse_k_32_no_graphs", loop_run), ("fuse_k_1", None)):
        if run is None:
            run = FusedMultiRun(dev, 1)
            for w in range(MULTI_B_WAVES):
                run.wave(profile=w == MULTI_B_WAVES - 1)
        e = run.e
        leaves = host_leaves(e.state)
        stamps = [dict(d) for d in e.commit_time]
        if ref is None:
            ref = (leaves, stamps, e.clock.now)
        else:
            for f in leaves:
                check(np.array_equal(leaves[f], ref[0][f]),
                      f"{name}: state.{f} differs from fuse_k 32's")
            check(stamps == ref[1] and e.clock.now == ref[2],
                  f"{name}: commit stamps or clock differ")
        runs[name] = run.result(name)
        run.e = e = None
    torch.cuda.synchronize()
    k5 = ring_cuda.LAUNCHES["write_window_cols"]
    check(k5 > 0 and runs["fuse_k_32"]["fused_launches"] > 0,
          "K5 and the fused windows ran on config B's engine path")
    # wave for wave (the waves ran in turns), graph against loop: the
    # whole window, and its part outside the booking (which graphs
    # leave unchanged)
    timed = [[(ws[0]["ms"], ws[0]["ms"] - ws[0]["booking_ms"])
              for ws in runs[name]["windows_by_wave"][2:-1] if ws]
             for name in ("fuse_k_32", "fuse_k_32_no_graphs")]
    pairs = list(zip(*timed))

    def paired(i):
        d = [g[i] - lp[i] for g, lp in pairs]
        return {"graph_minus_loop_ms_p50": statistics.median(d),
                "graph_faster_in": sum(x < 0 for x in d)}

    res = {"phase": "engine_multi_fused_path", "groups": 1024,
           "entries_per_group": MULTI_B_WAVES * MULTI_B_WAVE,
           "graph_vs_loop": cmp, "launch_turns": turns, "runs": runs,
           "window_pairs": {"n": len(pairs), "window": paired(0),
                            "outside_booking": paired(1)},
           "k5_launches": k5}
    emit(res)
    return res


def multi_small_config(C=256):
    """``multi_cmp_run``'s deployment: 4 groups of 3, 64-byte entries,
    batch 16, a ``C``-slot ring, ``fuse_k`` 8, seed 9."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=64, batch_size=16,
                      log_capacity=C, transport="single", seed=9,
                      fuse_k=8), 4


def multi_cmp_run(dev, C=256):
    """A ``MultiEngine`` of ``G`` groups at a ``C``-slot ring with a flight
    recorder, a trace and the device event ring, at ``fuse_k`` 8 (fused
    windows and ticks): ``ShardedKV`` waves, a leader failed and
    re-elected through the Router, a slow follower healed. Runs on the
    CPU too; returns what card and CPU must agree on."""
    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.examples import ShardedKV
    from raft_tpu_torch.multi import MultiEngine
    from raft_tpu_torch.obs.device import packed_flush
    from raft_tpu_torch.obs.events import FlightRecorder

    cfg, G = multi_small_config(C)
    hb = cfg.heartbeat_period
    lines, rec = [], FlightRecorder()
    e = MultiEngine(cfg, G, trace=lines.append, recorder=rec, device=dev)
    dobs = e.attach_device_obs(capacity=256)
    e.seed_leaders()
    kv = ShardedKV(e)
    rng = np.random.default_rng(SEED + 54)
    ring_cuda.LAUNCHES["write_window_cols"] = 0

    def wave(n):
        items = [(b"c%05d" % int(rng.integers(1 << 16)), rng.bytes(40))
                 for _ in range(n)]
        placed = kv.set_many(items)
        e.run_for(12 * hb)
        return placed

    wave(96)
    wave(96)
    lead2 = e.leader_id[2]
    e.set_slow(2, (lead2 + 1) % 3, True)
    wave(64)
    e.set_slow(2, (lead2 + 1) % 3, False)
    wave(64)
    wave(64)                    # every row caught up: fused windows again
    # a leader fails: the Router re-elects it (the groups' ticks fall out
    # of step, so the later instants run the tick path)
    old = e.leader_id[1]
    e.fail(1, old)
    wave(96)
    e.recover(1, old)
    placed = wave(64)
    drive_durable(e, placed)
    return {"lines": lines, "events": rec.to_jsonable(),
            "leaves": host_leaves(e.state),
            "rings": packed_flush(e._dev_rings).cpu().numpy(),
            "dev_events": [ev.to_jsonable() for ev in dobs.events],
            "data": kv._data, "fused_launches": e.fused_launches,
            "k5": ring_cuda.LAUNCHES["write_window_cols"]}


def phase_multi_card_equals_cpu(dev):
    """``multi_cmp_run`` on the card and on the CPU: nodelog lines,
    recorder events, state leaves, the packed group rings, decoded device
    events and the store equal."""
    card = multi_cmp_run(dev)
    cpu = multi_cmp_run("cpu")
    for k in ("lines", "events", "dev_events", "data", "fused_launches"):
        check(card[k] == cpu[k], f"multi card vs CPU: {k} differ")
    for f in card["leaves"]:
        check(np.array_equal(card["leaves"][f], cpu["leaves"][f]),
              f"multi card vs CPU: state.{f} differs")
    check(np.array_equal(card["rings"], cpu["rings"]),
          "multi card vs CPU: the packed group rings differ")
    check(card["k5"] > 0 and cpu["k5"] == 0 and card["fused_launches"] > 0,
          "K5 ran on the card (and only there), fused windows too")
    res = {"phase": "multi_card_equals_cpu", "groups": 4,
           "lines": len(card["lines"]), "device_events":
           len(card["dev_events"]), "fused_launches": card["fused_launches"],
           "k5_launches": card["k5"]}
    emit(res)
    return res


# ------------------------------------- the group-sharded layout (A15b)
#: config B through the sharded and resident engines: SETs a group in
#: each wave; the first GMESH_TURNS waves run on both engines in turns
#: (the sharded engine first on even waves), the rest on the sharded one
GMESH_WAVE = 256
GMESH_WAVES = 8           # 2 048 a group through the sharded engine
GMESH_TURNS = 4           # 1 024 a group through the resident one
GMESH_REBALANCE_WAVE = 5  # the Router's migration comes inside this wave


def same_sharded(t, sts, st, what):
    """Every leaf of the sharded blocks ``sts`` against the resident
    ``st``, block by block on the card."""
    import torch

    from raft_tpu_torch.core.state import FIELDS

    gps = t.groups_per_shard
    for k, b in enumerate(sts):
        for f in FIELDS:
            check(torch.equal(getattr(b, f),
                              getattr(st, f)[k * gps:(k + 1) * gps]),
                  f"{what}: state.{f} of shard {k} differs")


def group_mesh_transport(dev, n_turns=8):
    """Config B's fused schedule (``group_main_b``) on two co-resident
    shards (``GroupMesh([dev, dev])``, 512 groups each, one graph set a
    shard) beside the resident program, launch for launch: 4 clean
    chained windows, 64 cut groups escaping, ``halted0``; every leaf and
    output equal after each. Then a cross-shard ``swap_slots`` in place
    (data pointers kept) and a window through the same graphs (no
    recapture), equal to the resident state permuted alike; the window
    alone in turns, sharded graphs against resident graphs."""
    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.core.comm import take_groups
    from raft_tpu_torch.core.graphs import (FusedGroupGraphs,
                                            pack_group_launch)
    from raft_tpu_torch.core.state import FIELDS, init_group_state
    from raft_tpu_torch.core.step import fused_group_scan, group_vote_step
    from raft_tpu_torch.transport.group_mesh import (GroupMesh,
                                                     GroupMeshTransport)

    cfg, G = group_config_b()
    R, B, W, K = cfg.rows, cfg.batch_size, cfg.shard_words, GROUP_K
    t = GroupMeshTransport(cfg, G, mesh=GroupMesh([dev, dev]))
    gps = t.groups_per_shard
    check(t.n_shards == 2 and gps == 512, "two shards of 512 groups")
    fused, vote = fused_group_scan(R), group_vote_step(R)
    graphs = FusedGroupGraphs(R, dev)
    S = GroupStream(cfg, G, SEED + 61)
    leaders = (np.arange(G) % R).astype(np.int32)
    ones, full = np.ones(G, np.int32), np.full((K, G), B, np.int32)
    allr, none_r = np.ones((G, R), bool), np.zeros((G, R), bool)

    def host_parts(pays, counts, halted0, alive, lead=leaders):
        return [pack_group_launch(
            K, gps, R, B, W, n_run=K, halted0=halted0[sl],
            leaders=lead[sl], terms=ones[sl], counts=counts[:, sl],
            alive=alive[sl], slow=none_r[sl], member=allr[sl],
            payloads=pays[:, sl])
            for sl in (slice(k * gps, (k + 1) * gps) for k in range(2))]

    def on(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    k5 = {"sharded": 0, "resident": 0}

    def counted(side, fn, *args):
        """``fn(*args)`` with its K5 launches (a capture's eager warm-up
        included) counted to ``side``."""
        c = ring_cuda.LAUNCHES["write_window_cols"]
        out = fn(*args)
        k5[side] += ring_cuda.LAUNCHES["write_window_cols"] - c
        return out

    def both(pays, counts, halted0, alive, what):
        nonlocal st, sts
        out_s = counted("sharded", t.replicate_fused_packed, sts, host_parts(
            pays, counts, halted0, alive), K, B, W, graphs)
        out_r = counted("resident", fused, st, on(pays), on(counts), K,
                        on(halted0), on(leaders), on(ones), on(alive),
                        on(none_r), on(allr))
        sts, st = out_s[0], out_r[0]
        for i, (a, b) in enumerate(zip(out_s[1:], out_r[1:])):
            for x, y in zip(*((a, b) if isinstance(a, tuple)
                              else ((a,), (b,)))):
                check(torch.equal(x, y), f"{what}: output {i} differs")
        same_sharded(t, sts, st, what)
        return out_r

    ring_cuda.LAUNCHES["write_window_cols"] = 0
    t0 = time.perf_counter()
    st = init_group_state(cfg, G, device=dev)
    sts = t.shard_state(st)
    st, vr = vote(st, on(leaders), on(ones), on(allr))
    sts, vs = t.request_votes(sts, leaders, ones, allr)
    check(torch.equal(vr.votes, vs.votes) and vr.votes.tolist() == [R] * G,
          "round-robin election, sharded and resident")
    same_sharded(t, sts, st, "election")
    halted = np.zeros(G, bool)
    for w in range(4):
        pays = S.entries(full, "cpu").numpy()
        both(pays, full, halted, allr, f"clean window {w}")
        S.read_back(st)
    commits = take_groups(st.commit_index, on(leaders))
    check(commits.tolist() == [4 * K * B] * G, "every group commits 128·B")
    S.check_digests("config B on two shards")
    lost = np.arange(0, G, G // 64)
    cut = allr.copy()
    cut[lost] = False
    cut[lost, leaders[lost]] = True
    pays = np.random.default_rng(SEED + 62).integers(
        -2**31, 2**31 - 1, (K, G, B, W)).astype(np.int32)
    out = both(pays, full, halted, cut, "cut window")
    want = np.zeros(G, bool)
    want[lost] = True
    check(out[4].cpu().numpy().tolist() == want.tolist(),
          "the cut groups escape and halt, on both shards")
    halted = out[4].cpu().numpy()
    out = both(pays, full, halted, allr, "halted0 window")
    check(not bool(out[3][:, lost].any()), "a halted group ran on")
    # a cross-shard swap in place: slot 3 (shard 0) <-> slot 700 (shard 1)
    swap = [3, gps + 188 % gps]
    perm = np.arange(G)
    perm[swap] = swap[::-1]
    ptrs = [[getattr(b, f).data_ptr() for f in FIELDS] for b in sts]
    caps = graphs.captures
    sts = t.swap_slots(sts, perm)
    check(ptrs == [[getattr(b, f).data_ptr() for f in FIELDS] for b in sts],
          "swap_slots kept every block's tensors")
    pt = on(perm, torch.long)
    st = type(st)(*(getattr(st, f)[pt] for f in FIELDS))
    halted = halted[perm]
    leaders_p = leaders[perm]
    pays = S.entries(full, "cpu").numpy()
    out_s = counted("sharded", t.replicate_fused_packed, sts, host_parts(
        pays, full, halted, allr, leaders_p), K, B, W, graphs)
    out_r = counted("resident", fused, st, on(pays), on(full), K,
                    on(halted), on(leaders_p), on(ones), on(allr),
                    on(none_r), on(allr))
    sts, st = out_s[0], out_r[0]
    same_sharded(t, sts, st, "window after the swap")
    check(graphs.recaptures == 0 and graphs.captures == caps,
          "the swap recaptured a graph")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the window alone in turns: sharded graphs vs resident graphs
    rgraphs = FusedGroupGraphs(R, dev)
    hosts = host_parts(pays, full, np.zeros(G, bool), allr, leaders_p)
    rhost = pack_group_launch(
        K, G, R, B, W, n_run=K, halted0=np.zeros(G), leaders=leaders_p,
        terms=ones, counts=full, alive=allr, slow=none_r, member=allr,
        payloads=pays)

    def one(side):
        nonlocal st, sts
        torch.cuda.synchronize()
        a = time.perf_counter()
        if side == "sharded":
            o = counted(side, t.replicate_fused_packed, sts, hosts, K, B,
                        W, graphs)
            sts = o[0]
        else:
            o = counted(side, rgraphs.run, st, rhost, K, B, W)
            st = o[0]
        torch.stack([o[1].commit_index, o[1].frontier_len, o[1].max_term,
                     o[2], o[3]]).cpu()
        return (time.perf_counter() - a) * 1e3

    first = {side: one(side) for side in ("sharded", "resident")}
    ms = {"sharded": [], "resident": []}
    for i in range(n_turns):
        for side in (("sharded", "resident") if i % 2 == 0
                     else ("resident", "sharded")):
            ms[side].append(one(side))
    same_sharded(t, sts, st, "timed windows")
    check(graphs.recaptures == 0, "the sharded graphs recaptured")
    return {"groups": G, "shards": 2, "groups_per_shard": gps,
            "ticks_per_launch": K,
            "entries_read_back": int(S.submitted.sum()),
            "escaped_groups": int(len(lost)), "swap": swap,
            "k5_launches": k5,
            "graphs": {"captures": graphs.captures,
                       "replays": graphs.replays,
                       "recaptures": graphs.recaptures},
            "schedule_wall_s": wall, "first_window_ms": first,
            "window_turns": n_turns,
            **{f"{side}_window_ms_{k}": fn(ms[side]) for side in ms
               for k, fn in (("p50", statistics.median), ("min", min),
                             ("max", max))},
            "sharded_faster_in": sum(x < y for x, y in zip(
                ms["sharded"], ms["resident"]))}


class GroupMeshRun:
    """Config B through ``MultiEngine`` + ``Router`` + ``ShardedKV`` at
    ``fuse_k`` 32, on the sharded layout (``mesh``) or the resident one,
    a wave at a time: SETs a group, drained by ``run_for`` (their fused
    windows timed), then each group's new entries read back from a
    follower row of the ring through the engine's slot table."""

    def __init__(self, dev, mesh=None, items=None):
        import copy

        import torch

        from raft_tpu_torch.examples import ShardedKV
        from raft_tpu_torch.multi import MultiEngine, Router

        cfg, G = group_config_b()
        over = {"fuse_k": GROUP_K}
        if mesh is not None:
            over["transport"] = "mesh_groups"
        self.cfg = cfg = multi_config(cfg, **over)
        self.e = e = MultiEngine(cfg, G, mesh=mesh, device=dev)
        e.seed_leaders()
        self.router = Router(e)
        self.kv = ShardedKV(e, self.router)
        if items is None:
            self.S = KvStream(self.router, GMESH_WAVE * GMESH_WAVES,
                              SEED + 63)
        else:
            # another run's items and input hashes, with apply hashes of
            # this engine's own (the routers hash keys alike)
            self.S = S = copy.copy(items)
            S.h_apply = [hashlib.sha256() for _ in range(G)]
            S.n_apply = np.zeros(G, np.int64)
            S.at = 0
            for g in range(G):
                e.register_apply(g, S._apply(g))
        self.h_ring = [hashlib.sha256() for _ in range(G)]
        self.done = np.zeros(G, np.int64)
        self.walls, self.windows, self.k5 = [], [], 0
        self.fetch = {"round": [], "window": []}
        self.migrations = []
        n = [0]
        fetch, fire, rep = e._fetch, e._fire_fused_window, e._replicate_round

        def counted(x):
            n[0] += 1
            return fetch(x)

        def timed_fire(ticks, horizon):
            torch.cuda.synchronize()
            a, n0 = time.perf_counter(), n[0]
            out = fire(ticks, horizon)
            torch.cuda.synchronize()
            if out:
                self.windows.append((time.perf_counter() - a) * 1e3)
                self.fetch["window"].append(n[0] - n0)
            return out

        def counted_rep(active):
            n0 = n[0]
            out = rep(active)
            self.fetch["round"].append(n[0] - n0)
            return out

        e._fetch, e._fire_fused_window = counted, timed_fire
        e._replicate_round = counted_rep

    def read_back(self):
        """Each group's entries committed since the last read, from row
        ``(g + 1) % R`` of its ring (read before the ring laps them)."""
        from raft_tpu_torch.core.state import log_entries

        e, R = self.e, self.cfg.rows
        for g in range(e.G):
            hi = int(e.commit_watermark[g])
            lo = int(self.done[g]) + 1
            if hi >= lo:
                self.h_ring[g].update(log_entries(
                    e._view(g), (g + 1) % R, lo, hi).tobytes())
                self.done[g] = hi

    def wave(self, w):
        """Wave ``w``: its SETs, then ``run_for`` 40 heartbeats; in
        ``GMESH_REBALANCE_WAVE`` shard 0's groups get theirs first and
        ``Router.rebalance`` runs before the rest are placed."""
        import torch

        from raft_tpu_torch.core import ring_cuda

        e = self.e
        k5 = ring_cuda.LAUNCHES["write_window_cols"]
        items = self.S.wave(GMESH_WAVE)
        torch.cuda.synchronize()
        a = time.perf_counter()
        if w == GMESH_REBALANCE_WAVE:
            first = set(range(0, e.G // 2))     # shard 0's slots, placed
            hot = [it for it in items
                   if self.router.group_of(it[0]) in first]
            self.kv.set_many(hot)
            out = self.router.rebalance()
            self.migrations = out["migrations"]
            self.kv.set_many([it for it in items
                              if self.router.group_of(it[0]) not in first])
        else:
            self.kv.set_many(items)
        e.run_for(40 * self.cfg.heartbeat_period)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - a)
        self.k5 += ring_cuda.LAUNCHES["write_window_cols"] - k5
        self.read_back()

    def result(self, name):
        """Checks every SET committed, applied and read back against the
        input's SHA-256 (of the waves this run took); the run's figures,
        entries/s over the waves taken in turns bar the first, and over
        the later ones."""
        from raft_tpu_torch.examples.kv import encode_op

        e, S = self.e, self.S
        waves = len(self.walls)
        total = GMESH_WAVE * waves
        check((e.commit_watermark == total).all(),
              f"{name}: every SET committed")
        check((S.n_apply == total).all(), f"{name}: every SET applied")
        want = S.h_in
        if total < len(S.items[0]):
            want = [hashlib.sha256() for _ in range(e.G)]
            for g in range(e.G):
                for k, v in S.items[g][:total]:
                    want[g].update(encode_op(self.cfg.entry_bytes, 1, k, v))
        bad = [g for g in range(e.G)
               if S.h_apply[g].digest() != want[g].digest()
               or self.h_ring[g].digest() != want[g].digest()]
        check(not bad, f"{name}: groups {bad[:8]} read back differently "
                       "from their input")
        rate = {}
        for key, walls in (("in_turns", self.walls[1:GMESH_TURNS]),
                           ("alone", self.walls[GMESH_TURNS:])):
            if walls:
                rate[key] = e.G * GMESH_WAVE * len(walls) / sum(walls)
        return {
            "transport": e.transport_mode, "shards": e.n_shards,
            "entries_per_group": total,
            "wave_walls_s": self.walls,
            "entries_per_s": rate,
            "fused_launches": e.fused_launches,
            "fused_ticks": e.fused_ticks,
            "window_ms_p50": statistics.median(self.windows),
            "window_ms_min": min(self.windows),
            "window_ms_max": max(self.windows),
            "windows": len(self.windows),
            "fetches_per_round": sorted(set(self.fetch["round"])),
            "fetches_per_window": sorted(set(self.fetch["window"])),
            "graphs": {"captures": e._graphs.captures,
                       "replays": e._graphs.replays,
                       "recaptures": e._graphs.recaptures},
            "migrations": self.migrations,
            "k5_launches": self.k5,
            "sha256_group0": want[0].hexdigest(),
        }


def group_mesh_engine(dev):
    """Config B through the sharded engine (two shards on ``dev``), its
    first ``GMESH_TURNS`` waves in turns with the resident engine's; a
    Router migration in the sharded run mid-traffic. Returns both runs'
    figures."""
    from raft_tpu_torch.transport.group_mesh import GroupMesh

    sharded = GroupMeshRun(dev, GroupMesh([dev, dev]))
    runs = {"sharded": sharded,
            "resident": GroupMeshRun(dev, items=sharded.S)}
    for w in range(GMESH_WAVES):
        names = ("sharded", "resident") if w % 2 == 0 else \
            ("resident", "sharded")
        for name in names if w < GMESH_TURNS else ("sharded",):
            runs[name].wave(w)
    out = {name: run.result(name) for name, run in runs.items()}
    sh, rs = out["sharded"], out["resident"]
    check(sh["shards"] == 2 and rs["shards"] == 1, "the two layouts")
    check(len(sh["migrations"]) == 1 and runs["sharded"].e.migrations == 1,
          "the Router moved a group off the hot shard")
    mv = sh["migrations"][0]
    check(runs["sharded"].e.shard_of(mv["group"]) == mv["dst"],
          "the moved group lives on its new shard")
    check(sh["graphs"]["recaptures"] == 0,
          "the migration recaptured the sharded graphs")
    check(sh["fetches_per_round"] == rs["fetches_per_round"] == [1]
          and sh["fetches_per_window"] == rs["fetches_per_window"],
          "one fetch a round on either layout")
    check(sh["k5_launches"] > 0 and sh["fused_launches"] > 0,
          "K5 and the fused windows ran on the sharded engine")
    return out


def phase_group_mesh_path(dev):
    """Config B on the group-sharded layout (``group_mesh_transport``,
    then ``group_mesh_engine``)."""
    from raft_tpu_torch.core import ring_cuda

    t0 = time.perf_counter()
    ring_cuda.LAUNCHES["write_window_cols"] = 0
    tr = group_mesh_transport(dev)
    ring_cuda.LAUNCHES["write_window_cols"] = 0
    eng = group_mesh_engine(dev)
    res = {"phase": "group_mesh_path", "transport": tr, "engine": eng,
           "k5_launches": {
               "transport_sharded": tr["k5_launches"]["sharded"],
               "transport_resident": tr["k5_launches"]["resident"],
               "engine_sharded": eng["sharded"]["k5_launches"],
               "engine_resident": eng["resident"]["k5_launches"]},
           "wall_s": time.perf_counter() - t0}
    emit(res)
    return res


def gmesh_cmp_run(dev):
    """The sharded engine, G = 8 over two shards on ``dev`` (B = 8, C =
    256, ``fuse_k`` 8, a trace, a flight recorder and a 128-record
    device ring): seeded leaders, two migrations, two bursts of fused
    windows over every group, a third migration, then
    ``tests/test_group_shard.py``'s ``drive_schedule``: traffic on every
    group, a leader killed and re-elected, more traffic. Runs on the CPU
    too; returns what card and CPU must agree on."""
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.multi import MultiEngine
    from raft_tpu_torch.obs.events import FlightRecorder
    from raft_tpu_torch.transport.group_mesh import GroupMesh

    cfg = RaftConfig(n_replicas=3, entry_bytes=64, batch_size=8,
                     log_capacity=256, transport="mesh_groups", seed=5,
                     fuse_k=8)
    G = 8
    rng = np.random.default_rng(SEED + 64)

    def pays(n):
        return [rng.bytes(64) for _ in range(n)]

    lines, rec = [], FlightRecorder()
    e = MultiEngine(cfg, G, trace=lines.append, recorder=rec,
                    mesh=GroupMesh([dev, dev]), device=dev)
    dobs = e.attach_device_obs(capacity=128)
    ring_cuda.LAUNCHES["write_window_cols"] = 0
    e.seed_leaders()
    e.migrate_group(1, 1)
    e.migrate_group(6, 0, partner=2)
    for _ in range(2):
        last = {g: [e.submit(g, p) for p in pays(48)][-1]
                for g in range(G)}
        e.run_for(40.0)
        check(all(e.is_durable(g, s) for g, s in last.items()),
              "the fused windows committed every group")
    e.migrate_group(5, 0)
    # drive_schedule
    last = {g: [e.submit(g, p) for p in pays(12 + g)][-1] for g in range(G)}
    for g in range(G):
        e.run_until_committed(g, last[g])
    e.fail(0, e.leader_id[0])
    e.run_until_leader(0)
    s = e.submit(0, pays(1)[0])
    e.run_until_committed(0, s)
    return {"lines": lines, "events": rec.to_jsonable(),
            "leaves": e._gshard.gather_state(e.state),
            "dev_events": [ev.to_jsonable() for ev in dobs.events],
            "committed": [e.committed_payloads(g) for g in range(G)],
            "slot": e._slot.tolist(), "fused_launches": e.fused_launches,
            "recaptures": (None if e._graphs is None
                           else e._graphs.recaptures),
            "k5": ring_cuda.LAUNCHES["write_window_cols"]}


def phase_group_mesh_card_equals_cpu(dev):
    """``gmesh_cmp_run`` on the card and on the CPU: nodelog lines,
    recorder events, every gathered leaf, decoded device events,
    committed bytes and the slot table equal."""
    card = gmesh_cmp_run(dev)
    cpu = gmesh_cmp_run("cpu")
    for k in ("lines", "events", "dev_events", "committed", "slot",
              "fused_launches"):
        check(card[k] == cpu[k], f"group mesh card vs CPU: {k} differ")
    for f in card["leaves"]:
        check(np.array_equal(card["leaves"][f], cpu["leaves"][f]),
              f"group mesh card vs CPU: state.{f} differs")
    check(card["k5"] > 0 and cpu["k5"] == 0 and card["fused_launches"] > 0
          and card["recaptures"] == 0,
          "K5 ran on the card (and only there), fused windows too, and "
          "no migration recaptured a graph")
    res = {"phase": "group_mesh_card_equals_cpu", "groups": 8, "shards": 2,
           "lines": len(card["lines"]),
           "device_events": len(card["dev_events"]),
           "fused_launches": card["fused_launches"], "slot": card["slot"],
           "k5_launches": card["k5"]}
    emit(res)
    return res


# ------------------------------------------------------- the replica mesh
MESH_RANKS = 3
#: a spawned rank still running after this many seconds fails the run
MESH_DEADLINE_S = 420.0


def local_row(st, r, W):
    """Row ``r`` of a resident state as the rank-local state of the mesh
    (vectors [1], terms [1, C], payload [C, W]), as fresh tensors."""
    from raft_tpu_torch.core.state import ReplicaState

    return ReplicaState(
        *(getattr(st, f)[r:r + 1].clone() for f in
          ("term", "voted_for", "last_index", "commit_index", "match_index",
           "match_term", "log_term")),
        st.log_payload[:, r * W:(r + 1) * W].contiguous())


def prev_column(st, leader):
    """What the launch gather gives every rank: each row's term at the
    slot before the leader's frontier (i32[R])."""
    C = st.capacity
    prev_slot = (max(int(st.last_index[leader]), 1) - 1) % C
    return st.log_term[:, prev_slot].contiguous()


def rand_plane(rng, R, C, dev):
    """A random gathered plane (6, R), prev column, local rings: any
    input, for holding a mesh kernel against its plain version."""
    import torch

    last = rng.integers(0, 3 * C, R)
    vecs = np.stack([
        rng.integers(0, 5, R), rng.integers(-1, R, R), last,
        np.maximum(last - rng.integers(0, C + 8, R), 0),
        np.minimum(last, rng.integers(0, 3 * C, R)), rng.integers(0, 5, R),
    ]).astype(np.int32)
    prev = rng.integers(-1, 5, R).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return t(vecs), t(prev)


def mesh_step_case(cfg, dev, rng, vecs, prev, lp, lt, r, count, alive, slow,
                   member=None, leader=0, lterm=1, tfloor=1):
    """K2·mesh of row ``r`` and its plain version on clones: max error."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    R, W = cfg.rows, cfg.shard_words
    prm = sc.step_params(leader, lterm, tfloor, 0, 0, cfg.commit_quorum, R,
                         ec=cfg.ec_enabled)
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    mem = None if member is None else torch.tensor(member, dtype=torch.bool,
                                                   device=dev)
    win = rand_window(rng, cfg.batch_size, W, dev)
    res = []
    for fn in (sc.steady_step, sc.steady_step_plain):
        v, p, t = vecs.clone(), lp.clone(), lt.clone()
        out = torch.zeros(2 * R + 5, dtype=torch.int32, device=dev)
        fn(v, p, t, win, count, al, sl, mem, prm, out, None, r, prev)
        res.append((v, p, t, out))
    return max_err(list(zip(*res)))


def mesh_flight_case(cfg, dev, rng, st, r, T, P, counts, alive, slow,
                     turnover_ok, member=None):
    """Row ``r``'s flight from the resident cluster ``st`` as the mesh runs
    it: with ``turnover_ok`` the host's decision on the gathered plane
    (``step_mesh.flight_branch``) picks K4·mesh and its start slot;
    otherwise K3·mesh runs (held phase by phase too). The kernels and
    their plain versions on clones. Returns (whether K4·mesh wrote it,
    max error)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc
    from raft_tpu_torch.core.step_mesh import flight_branch

    C, B, R, W = cfg.log_capacity, cfg.batch_size, cfg.rows, cfg.shard_words
    prm = sc.step_params(0, 1, 1, 0, 0, cfg.commit_quorum, R,
                         ec=cfg.ec_enabled)
    al = torch.tensor(alive, dtype=torch.bool, device=dev)
    sl = torch.tensor(slow, dtype=torch.bool, device=dev)
    mem = None if member is None else torch.tensor(member, dtype=torch.bool,
                                                   device=dev)
    wins = torch.stack([rand_window(rng, B, W, dev) for _ in range(P)])
    cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
    prev = prev_column(st, 0)
    work = sc.workspace(dev)
    br = sc.pick_br(B, C)
    branch, s0 = "flight", None
    if turnover_ok:
        branch, s0 = flight_branch(
            sc.pack(st).cpu(), prev.cpu(), cnt.cpu(), al.cpu(), sl.cpu(),
            None if mem is None else mem.cpu(), prm, B, C, r)
    k4 = branch == "turnover"
    res = []
    for kernel in (True, False):
        loc = local_row(st, r, W)
        v = sc.pack(st)
        out = torch.zeros(R + 5, dtype=torch.int32, device=dev)
        args = (v, loc.log_payload, loc.log_term, wins)
        if k4 and kernel:
            sc.turnover_flight(*args, T, prm, out, my_row=r, s0=s0)
        elif k4:
            sc.turnover_flight_plain(*args, T, prm, out, work, None, s0)
        elif kernel:
            rec = sc.pipeline_flight(*args, cnt, al, sl, mem, prm, br, False,
                                     out, my_row=r, prev=prev).clone()
        else:
            sc.pipeline_flight_plain(*args, cnt, al, sl, mem, prm, br, False,
                                     out, work, None, r, prev)
        res.append((v, loc.log_payload, loc.log_term, out))
    (vk, pk, tk, ok_), (vp, pp, tp, op) = res
    if not k4:
        loc = local_row(st, r, W)
        phase_check("K3·mesh", rec, (sc.pack(st), loc.log_payload,
                                     loc.log_term), (vk, ok_, pk, tk), wins,
                    cnt, al, sl, mem, prm, br, False, None, r, prev)
    return k4, max_err([(vk, vp), (pk, pp), (tk, tp), (ok_, op)])


def mesh_cases(cfg, dev, rng, note, n_random):
    """The mesh kernels of every row against their plain versions."""
    from raft_tpu_torch.core import step_cuda as sc

    C, B, R, W = cfg.log_capacity, cfg.batch_size, cfg.rows, cfg.shard_words
    on, off = [1] * R, [0] * R
    slow_last = off[:-1] + [1]
    dead_last = on[:-1] + [0]
    shrunk = [1] + [0] * (R - 1)
    base, stale, two = k2_edge_states(cfg, dev, rng)
    seam = steady_state(cfg, dev, 3 * C - B + 300, rng=rng)
    T = STEPS_PER_FLIGHT
    for r in range(R):
        for _ in range(n_random):            # any input
            vecs, prev = rand_plane(rng, R, C, dev)
            lp = rand_window(rng, C, W, dev)
            lt = rand_window(rng, 1, C, dev).remainder(5)
            note("K2·mesh", mesh_step_case(
                cfg, dev, rng, vecs, prev, lp, lt, r,
                int(rng.integers(-2, B + 4)), list(rng.random(R) < 0.85),
                list(rng.random(R) < 0.2), leader=int(rng.integers(0, R)),
                lterm=int(rng.integers(0, 4)),
                tfloor=int(rng.integers(0, 2 * C))))
        # the seam, a partial window, slow, dead and member-shrunk rows;
        # then the edges: an empty window, a stale leader, a member mask
        # (at config 3 the EC floor lifts its majority), two rows past
        # the leader's tail, the term_floor gate
        for st, count, alive, slow, member, kw in (
                (base, B, on, off, None, {}), (seam, B, on, off, None, {}),
                (seam, 777, on, slow_last, None, {}),
                (base, B, dead_last, off, None, {}),
                (base, B, on, off, shrunk, {}),
                (base, 0, on, off, None, {}),
                (stale, B, on, off, None, dict(lterm=2)),
                (base, B, on, off, on[:3] + off[3:], {}),
                (two, B, on, off, None, dict(lterm=2, tfloor=5 * B + 1)),
                (base, B, on, off, None, dict(tfloor=6 * B + 1))):
            loc = local_row(st, r, W)
            note("K2·mesh", mesh_step_case(
                cfg, dev, rng, sc.pack(st), prev_column(st, 0),
                loc.log_payload, loc.log_term, r, count, alive, slow,
                member, **kw))
        part = [B] * T
        part[5], part[17] = 300, 0
        for args, want in (
                ((base, T, 4, [B] * T, on, off, False), "K3"),
                ((base, T, 4, [B] * T, on, slow_last, True), "K3"),
                ((base, T, 4, [B] * T, dead_last, off, True), "K3"),
                ((base, T, 4, [B] * T, on, off, True, shrunk), "K3"),
                ((base, T, 3, part, on, slow_last, True), "K3"),
                ((seam, 8, 8, [B] * 8, on, off, True), "K3"),
                ((base, T, T, [B] * T, on, off, True), "K4"),
                ((base, 2 * T + 5, 7, [B] * (2 * T + 5), on, off, True),
                 "K4")):
            k4, err = mesh_flight_case(cfg, dev, rng, args[0], r, *args[1:])
            which = "K4" if k4 else "K3"
            check(which == want, f"mesh flight of row {r}: {which} ran, "
                                 f"{want} expected")
            note(which + "·mesh", err)


#: K4·mesh's bookkeeping cases (``mesh_turnover_cases``)
TURNOVER_CASES = ("all_accept", "lterm_0", "tfloor_beyond", "mixed_plane",
                  "lapped")


def mesh_turnover_cases(cfg, dev, rng, note):
    """K4·mesh of row 1 against the plain step loop, from a host-given
    start slot, at ``cfg``'s row width: every row caught up (the main
    path's flight), a leader term of 0 (nothing commits), a term floor
    beyond the flight's last tail (nothing commits), rows at mixed terms,
    votes and commits under a higher leader term (adoption and vote
    reset), and a lapped flight (T·B > C, fewer windows than steps)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    C, B, R, W = cfg.log_capacity, cfg.batch_size, cfg.rows, cfg.shard_words
    last, r = 5 * B, 1
    for name in TURNOVER_CASES:
        T, P, lterm, tfloor = C // B, C // B, 1, 1
        plane = np.stack([np.ones(R), np.zeros(R), np.full(R, last),
                          np.full(R, last), np.full(R, last),
                          np.ones(R)]).astype(np.int32)
        if name == "lterm_0":
            lterm = 0
        elif name == "tfloor_beyond":
            tfloor = last + T * B + 1
        elif name == "mixed_plane":
            lterm = 3
            plane[0] = rng.integers(0, 5, R)
            plane[1] = rng.integers(-1, R, R)
            plane[3] = rng.integers(0, last + 1, R)
            plane[5] = rng.integers(0, 4, R)
        elif name == "lapped":
            T, P = 2 * T + 5, 7
        prm = sc.step_params(0, lterm, tfloor, 0, 0, cfg.commit_quorum, R,
                             ec=cfg.ec_enabled)
        wins = torch.stack([rand_window(rng, B, W, dev) for _ in range(P)])
        lp0 = rand_window(rng, C, W, dev)
        lt0 = rand_window(rng, 1, C, dev).remainder(4)
        s0 = int(rng.integers(0, C))
        res = []
        for kernel in (True, False):
            v = torch.from_numpy(plane.copy()).to(dev)
            lp, lt = lp0.clone(), lt0.clone()
            out = torch.zeros(R + 5, dtype=torch.int32, device=dev)
            if kernel:
                sc.turnover_flight(v, lp, lt, wins, T, prm, out, None, r, s0)
            else:
                sc.turnover_flight_plain(v, lp, lt, wins, T, prm, out,
                                         sc.workspace(dev), None, s0)
            res.append((v, lp, lt, out))
        note("K4·mesh", max_err(list(zip(*res))))
    return len(TURNOVER_CASES)


def mesh_vs_resident(cfg, dev, n, rng):
    """A randomized multi-term schedule that keeps the engine's invariants
    (one leader a term, appending before it replicates), run twice on the
    card: the resident kernels (K2, K3, K4) on the whole cluster, and each
    row's mesh kernels on that row alone, fed the plane and prev column a
    launch gather would give. After every step each row's rings, the whole
    plane and the outputs must agree; a row's closed-form next prev term
    must be the leader's term exactly where the resident one is. Now and
    then the followers are resynchronised to the leader's log (what the
    repair window would do), so the quorum stays alive."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc
    from raft_tpu_torch.core.comm import SingleDeviceComm
    from raft_tpu_torch.core.state import init_state
    from raft_tpu_torch.core.step import vote_step
    from raft_tpu_torch.core.step_mesh import flight_branch

    C, B, R, W = cfg.log_capacity, cfg.batch_size, cfg.rows, cfg.shard_words
    comm = SingleDeviceComm(R)
    st = init_state(cfg, device=dev)
    ones = torch.ones(R, dtype=torch.bool, device=dev)
    term, leader = 1, 0
    st, _ = vote_step(comm, st, 0, 1, ones)
    floor = 1
    locs = [local_row(st, r, W) for r in range(R)]
    steps = flights = 0
    stalled = False
    while steps < n:
        if rng.random() < 0.07:
            term += int(rng.integers(1, 3))
            lasts = st.last_index.tolist()
            leader = int(rng.choice([r for r in range(R)
                                     if lasts[r] == max(lasts)]))
            st, _ = vote_step(comm, st, leader, term, ones)
            floor = int(st.last_index[leader]) + 1
        if stalled or rng.random() < 0.15:     # resync the followers
            for r in range(R):
                st.log_payload[:, r * W:(r + 1) * W] = \
                    st.log_payload[:, leader * W:(leader + 1) * W]
                st.log_term[r] = st.log_term[leader]
            for f in ("last_index", "commit_index"):
                getattr(st, f).fill_(int(getattr(st, f)[leader]))
            locs = [local_row(st, r, W) for r in range(R)]
        alive = torch.tensor(rng.random(R) > 0.1, device=dev)
        alive[leader] = True
        slow = torch.tensor(rng.random(R) < 0.1, device=dev)
        member = None
        if rng.random() < 0.15:
            member = torch.tensor(rng.random(R) < 0.8, device=dev)
            member[leader] = True
        prm = sc.step_params(leader, term, floor, 0, 0, cfg.commit_quorum, R,
                             ec=cfg.ec_enabled)
        vecs0 = sc.pack(st)
        prev0 = prev_column(st, leader)
        kind = rng.choice(["step", "scan", "flight"], p=[0.4, 0.35, 0.25])
        if kind == "flight":
            counts = flight_counts(rng, B, C)
            T = len(counts)
            wins = rand_window(rng, T * B, R * W, dev).reshape(T, B, R * W)
            cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
            outs = []
            branch, s0 = flight_branch(
                vecs0.cpu(), prev0.cpu(), cnt.cpu(), alive.cpu(), slow.cpu(),
                None if member is None else member.cpu(), prm, B, C, 0)
            for r in [None] + list(range(R)):
                v = vecs0.clone()
                o = torch.zeros(R + 5, dtype=torch.int32, device=dev)
                if r is None:       # resident: K3 decides on the device
                    sc.pipeline_flight(v, st.log_payload, st.log_term, wins,
                                       cnt, alive, slow, member, prm,
                                       sc.pick_br(B, C), T * B >= C, o)
                    if T * B >= C:
                        sc.turnover_flight(v, st.log_payload, st.log_term,
                                           wins, T, prm, o)
                    outs.append((v, o))
                    continue
                lp, lt = locs[r].log_payload, locs[r].log_term
                w = wins[..., r * W:(r + 1) * W].contiguous()
                if branch == "turnover":     # the mesh decides on the host
                    sc.turnover_flight(v, lp, lt, w, T, prm, o, my_row=r,
                                       s0=s0)
                else:
                    sc.pipeline_flight(v, lp, lt, w, cnt, alive, slow,
                                       member, prm, sc.pick_br(B, C), False,
                                       o, my_row=r, prev=prev0)
                outs.append((v, o))
            steps += T
            flights += 1
        else:
            T = 1 if kind == "step" else int(rng.integers(2, 5))
            wins = rand_window(rng, T * B, R * W, dev).reshape(T, B, R * W)
            counts = [int(rng.choice([0, 3, 17, 777, B])) for _ in range(T)]
            outs = []
            for r in [None] + list(range(R)):
                v = vecs0.clone()
                prev = prev0
                o = torch.zeros(2 * R + 5, dtype=torch.int32, device=dev)
                for t in range(T):
                    if r is None:
                        sc.steady_step(v, st.log_payload, st.log_term,
                                       wins[t], counts[t], alive, slow,
                                       member, prm, o)
                    else:
                        sc.steady_step(
                            v, locs[r].log_payload, locs[r].log_term,
                            wins[t, :, r * W:(r + 1) * W].contiguous(),
                            counts[t], alive, slow, member, prm, o, None, r,
                            prev)
                        prev = o[R + 5:].clone()
                outs.append((v, o))
            steps += T
            # where the next window's prev check can pass (a row at or
            # past the leader's new tail), the closed form must agree
            # with the ring about whether the row holds the leader's term
            vr = outs[0][0]
            reach = vr[2] >= vr[2, leader]
            nxt = outs[0][1][R + 5:]
            for _, o in outs[1:]:
                closed = o[R + 5:]
                check(torch.equal((closed == term)[reach],
                                  (nxt == term)[reach]),
                      "a closed-form next prev term disagrees with the ring")
        (vres, ores) = outs[0]
        for r, (v, o) in enumerate(outs[1:]):
            check(torch.equal(v, vres), f"mesh row {r}: plane after {kind}")
            check(torch.equal(o[:R + 5], ores[:R + 5]),
                  f"mesh row {r}: outputs after {kind}")
        stalled = int(vres[3, leader]) == int(vecs0[3, leader])
        st = sc.unpack(vres, st.log_term, st.log_payload)
        for r in range(R):
            check(torch.equal(locs[r].log_payload,
                              st.log_payload[:, r * W:(r + 1) * W]),
                  f"mesh row {r}: payload ring after {kind}")
            check(torch.equal(locs[r].log_term[0], st.log_term[r]),
                  f"mesh row {r}: term ring after {kind}")
    return {"steps": steps, "flights": flights, "final_term": term,
            "final_commit": int(st.commit_index[leader])}


def phase_mesh_kernels(cfg, ecfg, dev, n_random=8):
    """K2·mesh, K3·mesh and K4·mesh of every row against their plain
    versions (the north star, R = 3; config 3, R = 5 with the EC quorum;
    and config 3's 2-D slice, 11 words a row), then the randomized
    schedule against the resident kernels."""
    errs = {"K2·mesh": 0, "K3·mesh": 0, "K4·mesh": 0}
    cases = dict.fromkeys(errs, 0)

    def note(key, err):
        errs[key] = max(errs[key], err)
        cases[key] += 1

    rng = np.random.default_rng(SEED + 20)
    mesh_cases(cfg, dev, rng, note, n_random)
    mesh_cases(ecfg, dev, rng, note, n_random // 2)
    # config 3's 2-D slice: 5 rows of 11 words under the EC quorum (a
    # 44-byte shard), the scalar instantiations at an odd word count
    import dataclasses

    slice11 = dataclasses.replace(ecfg, entry_bytes=132)
    mesh_cases(slice11, dev, rng, note, n_random // 4)
    # K4·mesh's bookkeeping cases at 256-, 88-, 44- and 12-byte rows:
    # 16-byte vectors, word pairs, 11 single words, 3 single words
    turnover = {f"W={c.shard_words}": mesh_turnover_cases(c, dev, rng, note)
                for c in (cfg, ecfg, slice11, dataclasses.replace(
                    cfg, entry_bytes=12, batch_size=128, log_capacity=512))}
    sched = {"north_star": mesh_vs_resident(cfg, dev, 160, rng),
             "config_3": mesh_vs_resident(ecfg, dev, 80, rng)}
    for k in errs:
        check(errs[k] == 0, f"{k} differs from its plain version by "
                            f"{errs[k]}")
    emit({"phase": "mesh_kernels_vs_plain", "cases": cases,
          "max_abs_err": errs, "schedules_vs_resident": sched,
          "k4_mesh_bookkeeping_cases": turnover})
    return errs


def mesh_counters(dev):
    from raft_tpu_torch.core import ring_cuda, step_cuda
    from raft_tpu_torch.ec import kernels as ek

    w = step_cuda.workspace(dev)
    return {"K1": ring_cuda.LAUNCHES["write_window_both"],
            "K2·mesh": step_cuda.LAUNCHES["steady_step_mesh"],
            "K3·mesh": step_cuda.LAUNCHES["pipeline_flight_mesh"],
            "K4·mesh": step_cuda.LAUNCHES["turnover_flight_mesh"],
            "K7": ek.LAUNCHES["encode_fold"],
            "K3_flights_run": int(w[step_cuda.WK_RAN3]),
            "K4_flights_run": int(w[step_cuda.WK_RAN4])}


def row_digest(st, r, info, dispatch, local):
    """A stage's record of row ``r``: its six scalars, the SHA-256 of its
    term ring and payload lanes, the call's info, the dispatch witness.
    ``local``: ``st`` is a rank's own row."""
    W = st.words_per_entry
    i = 0 if local else r
    return {**part_digest(st, i, st.log_payload[:, i * W:(i + 1) * W]),
            "info": None if info is None else {
                f: getattr(info, f).cpu().tolist() for f in info._fields},
            "dispatch": dispatch}


def part_digest(st, i, lanes):
    """Row ``i`` of ``st``: its six scalars and the SHA-256 of its term
    ring and of ``lanes`` (the row's payload block, or a mesh rank's
    slice of it)."""
    return {
        "vec": [int(getattr(st, f)[i]) for f in (
            "term", "voted_for", "last_index", "commit_index",
            "match_index", "match_term")],
        "terms": hashlib.sha256(st.log_term[i].cpu().numpy()
                                .tobytes()).hexdigest(),
        "payload": hashlib.sha256(lanes.contiguous().cpu().numpy()
                                  .tobytes()).hexdigest(),
    }


def mesh_drive(tr, cfg, dev, entries, record):
    """The mesh main path's schedule on any transport: the multichip dry
    run's ladder — an election, repair-capable ticks with row 2 slow and
    its heal (K1), a fused step, a scan — then the north star's flights
    (``northstar.run_device``), a flight with row 2 slow and one with row
    2 dead. ``record(stage, state, info)`` runs after every stage. Returns
    (state, the run_device result)."""
    import torch

    from raft_tpu_torch.northstar import run_device

    R, B = cfg.rows, cfg.batch_size
    S = Stream(cfg, rows=())
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(R, dtype=torch.bool, device=dev)
    slow2 = torch.tensor([False, False, True], device=dev)
    dead2 = torch.tensor([True, True, False], device=dev)
    state = tr.init()
    state, vi = tr.request_votes(state, 0, 1, alive)
    check(int(vi.votes) == R, "mesh election of row 0")
    record("election", state, vi)
    for _ in range(4):
        state, info = tr.replicate(state, S.batches(1, [B])[0], B, 0, 1,
                                   alive, slow2)
    check(int(info.commit_index) == S.submitted, "mesh tick commit")
    record("ticks_row2_slow", state, info)
    heal = 0
    while int(info.match[2]) < S.submitted:
        state, info = tr.replicate(state, S.batches(1, [0])[0], 0, 0, 1,
                                   alive, quiet)
        heal += 1
        check(heal <= 8, "the repair window did not heal row 2")
    record("heal", state, info)
    state, info = tr.replicate(state, S.batches(1, [B])[0], B, 0, 1, alive,
                               quiet, repair=False, term_floor=1)
    check(int(info.commit_index) == S.submitted, "mesh fused step commit")
    record("fused_step", state, info)
    state, infos = tr.replicate_many(
        state, S.batches(8, [B] * 8), torch.full((8,), B, dtype=torch.int32,
                                                 device=dev),
        0, 1, alive, quiet, repair=False, term_floor=1)
    check(int(infos.commit_index[-1]) == S.submitted, "mesh scan commit")
    record("scan", state, infos)
    rows = tuple(range(1, R))
    run = run_device(cfg, entries, SEED + 3, transport=tr, state=state,
                     rows=rows)
    state = run.state
    S.skip(entries)
    record("north_star", state, None)
    for name, al, sl in (("flight_row2_slow", alive, slow2),
                         ("flight_row2_dead", dead2, quiet)):
        Tk = 8
        state, info = tr.replicate_pipeline(
            state, S.batches(Tk, [B] * Tk), torch.full(
                (Tk,), B, dtype=torch.int32, device=dev), 0, 1, al, sl,
            term_floor=1)
        check(int(info.commit_index) == S.submitted, f"mesh {name} commit")
        record(name, state, info)
    return state, run


def _timed_gathers():
    """Wrap the mesh's launch collectives in a host timer: returns the
    list the calls' seconds are appended to."""
    import raft_tpu_torch.core.step_mesh as sm

    spent = []
    inner = sm._gather_plane

    def gather(*args):
        t0 = time.perf_counter()
        res = inner(*args)
        spent.append(time.perf_counter() - t0)
        return res

    sm._gather_plane = gather
    return spent


def rank_device(device):
    """A spawned rank's device: every rank shares the one card."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def mesh_rank_main(rank, world, cfg, device, entries):
    """One rank of the north-star mesh (spawned; ``cfg.transport`` is
    "tpu_mesh")."""
    import torch

    import raft_tpu_torch.core.step_mesh as sm
    from raft_tpu_torch.transport import MeshTransport, make_transport

    dev = rank_device(device)
    tr = make_transport(cfg, device=dev)
    check(isinstance(tr, MeshTransport) and tr.rank == rank,
          f"rank {rank} did not get a MeshTransport")
    spent = _timed_gathers()
    zero_counters(dev)
    stages = {}

    def record(name, st, info):
        stages[name] = row_digest(st, rank, info, sm.LAST_DISPATCH, True)
        sm.LAST_DISPATCH = None

    t0 = time.perf_counter()
    state, run = mesh_drive(tr, cfg, dev, entries, record)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flights = -(-entries // (STEPS_PER_FLIGHT * cfg.batch_size))
    calls, spent_s = len(spent), sum(spent)
    # the two launch collectives alone: every rank enters them together
    # (after a barrier), so no rank waits for another's host work
    alone = []
    for _ in range(21):
        torch.distributed.barrier()
        t1 = time.perf_counter()
        sm._gather_plane(tr.comm, state, 0)
        alone.append(time.perf_counter() - t1)
    return {"stages": stages, "launches": mesh_counters(dev),
            "row_digests": {str(r): d for r, d in run.row_digests.items()},
            "input_digest": run.input_digest,
            "north_star_wall_s": run.wall_s, "flights": flights,
            "gather_calls": calls, "gather_s": spent_s,
            "gather_alone_ms": statistics.median(alone) * 1e3,
            "main_path_wall_s": wall}


def phase_mesh_main_path(cfg, dev, entries=ENTRIES):
    """The north star on a 3-rank gloo mesh sharing ``dev`` (three
    processes time-sharing one card), every stage of every rank held
    against its row of the same schedule run by ``SingleDeviceTransport``
    here on the card."""
    import dataclasses

    from raft_tpu_torch.transport.device import SingleDeviceTransport
    from raft_tpu_torch.transport.launch import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank_main, MESH_RANKS,
                      (dataclasses.replace(cfg, transport="tpu_mesh"),
                       str(dev), entries), timeout=MESH_DEADLINE_S)
    ranks_wall = time.perf_counter() - t0
    dispatch = {"election": None, "ticks_row2_slow": None, "heal": None,
                "fused_step": "step", "scan": "scan",
                "north_star": "pipeline", "flight_row2_slow": "pipeline",
                "flight_row2_dead": "pipeline"}
    ref = {}

    def record(name, st, info):
        ref[name] = [row_digest(st, r, info, dispatch[name], False)
                     for r in range(MESH_RANKS)]
        ref[name + ":commit"] = int(st.commit_index[0])

    tr = SingleDeviceTransport(cfg, device=dev)
    mesh_drive(tr, cfg, dev, entries, record)
    for r, res in enumerate(ranks):
        check(list(res["stages"]) == list(dispatch), f"rank {r} stages")
        for name in dispatch:
            got, want = res["stages"][name], ref[name][r]
            for k in ("vec", "terms", "payload", "info", "dispatch"):
                check(got[k] == want[k],
                      f"rank {r} after {name}: {k} {got[k]} != {want[k]}")
        for k in ("K1", "K2·mesh", "K3·mesh", "K4·mesh", "K3_flights_run",
                  "K4_flights_run"):
            # (a rehearsal on the CPU runs the plain versions: no launch)
            check(res["launches"][k] > 0 or dev.type != "cuda",
                  f"rank {r}: {k} never ran")
        if r > 0:
            check(res["row_digests"][str(r)] == res["input_digest"],
                  f"rank {r}'s committed bytes differ from the input")
    flights = ranks[0]["flights"]
    if dev.type == "cuda":
        # the turnover flights go to K4·mesh from the host's decision;
        # K3·mesh runs only the slow-row and dead-row flights, on each rank
        k3 = sum(res["launches"]["K3·mesh"] for res in ranks)
        k4 = sum(res["launches"]["K4·mesh"] for res in ranks)
        check(k3 == 2 * MESH_RANKS and k4 == flights * MESH_RANKS,
              f"mesh main path: {k3} K3·mesh and {k4} K4·mesh launches")
    result = {
        "phase": "mesh_main_path", "ranks": MESH_RANKS,
        "backend": "gloo, all ranks on cuda:0 (three processes "
                   "time-sharing one card)",
        "entries_committed": ref["flight_row2_dead:commit"],
        "north_star_entries": entries, "north_star_flights": flights,
        "stages_matched": list(dispatch),
        "sha256_input": ranks[0]["input_digest"],
        "sha256_rows": {str(r): ranks[r]["row_digests"].get(str(r))
                        for r in range(1, MESH_RANKS)},
        "launches_per_rank": [res["launches"] for res in ranks],
        "launches": {k: sum(res["launches"][k] for res in ranks)
                     for k in ranks[0]["launches"]},
        "north_star_wall_s_per_rank": [res["north_star_wall_s"]
                                       for res in ranks],
        "north_star_ms_per_flight": max(res["north_star_wall_s"]
                                        for res in ranks) * 1e3 / flights,
        "gather_calls_per_rank": ranks[0]["gather_calls"],
        # host ms in the launch collectives per call on the main path
        # (waiting for the slowest rank included), and alone after a
        # barrier (median of 21)
        "gather_ms_per_call": [res["gather_s"] * 1e3 / res["gather_calls"]
                               for res in ranks],
        "gather_alone_ms": [res["gather_alone_ms"] for res in ranks],
        "ranks_wall_s": ranks_wall,
    }
    emit(result)
    return result


def mesh_ec_drive(tr, cfg, dev, flights, record):
    """Config 3 on any transport: an election, then ``flights`` 32-step
    flights of K7-encoded windows (each rank's lane block its RS shard)."""
    import torch

    from raft_tpu_torch.ec.kernels import encode_fold_device
    from raft_tpu_torch.ec.rs import RSCode

    R, B, E = cfg.rows, cfg.batch_size, cfg.entry_bytes
    T = STEPS_PER_FLIGHT
    code = RSCode(cfg.n_replicas, cfg.rs_k)
    rng = np.random.default_rng(SEED + 21)
    alive = torch.ones(R, dtype=torch.bool, device=dev)
    quiet = torch.zeros(R, dtype=torch.bool, device=dev)
    state = tr.init()
    state, vi = tr.request_votes(state, 0, 1, alive)
    check(int(vi.votes) == R, "mesh ec election")
    record("election", state, vi)
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    for f in range(flights):
        raw = rand_bytes(rng, (T * B, E), dev)
        wins = encode_fold_device(code, raw).reshape(T, B, -1)
        state, info = tr.replicate_pipeline(state, wins, counts, 0, 1, alive,
                                            quiet, term_floor=1)
        check(int(info.commit_index) == (f + 1) * T * B,
              "mesh ec flight commit")
        record(f"flight_{f}", state, info)
    return state


def mesh_ec_rank_main(rank, world, cfg, device, flights):
    """One rank of the config-3 mesh (spawned; ``cfg.transport`` is
    "tpu_mesh")."""
    import raft_tpu_torch.core.step_mesh as sm
    from raft_tpu_torch.transport import MeshTransport, make_transport

    dev = rank_device(device)
    tr = make_transport(cfg, device=dev)
    check(isinstance(tr, MeshTransport), f"rank {rank}: no MeshTransport")
    zero_counters(dev)
    zero_ec_counters(dev)
    stages = {}

    def record(name, st, info):
        stages[name] = row_digest(st, rank, info, sm.LAST_DISPATCH, True)
        sm.LAST_DISPATCH = None

    mesh_ec_drive(tr, cfg, dev, flights, record)
    return {"stages": stages, "launches": mesh_counters(dev)}


def phase_mesh_ec_path(ecfg, dev, flights=4):
    """BASELINE config 3 on a 5-rank gloo mesh sharing ``dev``: every
    rank's ring and scalars after every flight equal its row of the
    single-device run of the same K7-encoded windows."""
    import dataclasses

    from raft_tpu_torch.transport.device import SingleDeviceTransport
    from raft_tpu_torch.transport.launch import run_ranks

    ranks = run_ranks(mesh_ec_rank_main, ecfg.rows,
                      (dataclasses.replace(ecfg, transport="tpu_mesh"),
                       str(dev), flights), timeout=MESH_DEADLINE_S)
    ref = {}
    mesh_ec_drive(SingleDeviceTransport(ecfg, device=dev), ecfg, dev,
                  flights, lambda n, st, i: ref.__setitem__(
                      n, [row_digest(st, r, i, None, False)
                          for r in range(ecfg.rows)]))
    for r, res in enumerate(ranks):
        check(list(res["stages"]) == list(ref), f"ec rank {r} stages")
        for name, rows in ref.items():
            want = dict(rows[r], dispatch=None if name == "election"
                        else "pipeline")
            check(res["stages"][name] == want,
                  f"ec rank {r} after {name} differs from its row")
        for k in ("K4·mesh", "K7", "K4_flights_run"):
            check(res["launches"][k] > 0 or dev.type != "cuda",
                  f"ec rank {r}: {k} never ran")
        check(res["launches"]["K3·mesh"] == 0,
              f"ec rank {r}: a turnover flight launched K3·mesh")
    res = {"phase": "mesh_ec_path", "ranks": ecfg.rows, "flights": flights,
           "entries_committed": flights * STEPS_PER_FLIGHT *
           ecfg.batch_size, "stages_matched": list(ref),
           "launches": {k: sum(x["launches"][k] for x in ranks)
                        for k in ranks[0]["launches"]}}
    emit(res)
    return res


def mesh1_rank_main(rank, world, device, reps):
    """``bench.py`` ``bench_mesh1`` on the card: one rank, n_replicas=1,
    32-step saturated flights through ``MeshTransport`` (the host decides,
    K4·mesh writes, two launch collectives) and through
    ``SingleDeviceTransport`` (K3, K4) at the same shape, in turns, and
    the launch collectives alone. Host µs per call, medians."""
    import torch

    import raft_tpu_torch.core.step_mesh as sm
    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.transport import MeshTransport, SingleDeviceTransport

    dev = rank_device(device)
    cfg = RaftConfig(n_replicas=1, transport="tpu_mesh")
    T, B = STEPS_PER_FLIGHT, cfg.batch_size
    rng = np.random.default_rng(SEED + 30)
    wins = rand_window(rng, B, cfg.shard_words, dev)[None]
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    zero = torch.zeros(1, dtype=torch.bool, device=dev)
    trs = {"mesh_of_1": MeshTransport(cfg, device=dev),
           "co_located": SingleDeviceTransport(cfg, device=dev)}
    states = {}
    for name, tr in trs.items():
        st, _ = tr.request_votes(tr.init(), 0, 1, one)
        st, info = tr.replicate_pipeline(st, wins, counts, 0, 1, one, zero,
                                         term_floor=1)
        check(int(info.commit_index) == T * B, "mesh1 commit")
        states[name] = st

    def timed(fn):
        sync = torch.cuda.synchronize if dev.type == "cuda" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e6

    samples = {k: [] for k in (*trs, "gather_plane")}
    for _ in range(reps):
        for name, tr in trs.items():
            def flight(name=name, tr=tr):
                states[name] = tr.replicate_pipeline(
                    states[name], wins, counts, 0, 1, one, zero,
                    term_floor=1)[0]
            samples[name].append(timed(flight))
        samples["gather_plane"].append(timed(lambda: sm._gather_plane(
            trs["mesh_of_1"].comm, states["mesh_of_1"], 0)))
    return {k: statistics.median(v) for k, v in samples.items()}


def time_mesh_kernels(cfg, dev, rng, reps, rate):
    """K2·mesh, K3·mesh and K4·mesh of row 1 at the north star's widths:
    device time per launch, the plain versions' time, the byte bounds."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    C, B, R, W = cfg.log_capacity, cfg.batch_size, cfg.rows, cfg.shard_words
    T, r = STEPS_PER_FLIGHT, 1
    al = torch.ones(R, dtype=torch.bool, device=dev)
    sl = torch.zeros(R, dtype=torch.bool, device=dev)
    prm = sc.step_params(0, 1, 1, 0, 0, cfg.commit_quorum, R)
    st = steady_state(cfg, dev, 5 * B, rng=rng)
    loc = local_row(st, r, W)
    vecs = sc.pack(st)
    prev = prev_column(st, 0)
    win = rand_window(rng, B, W, dev)
    o2 = torch.zeros(2 * R + 5, dtype=torch.int32, device=dev)
    args = (loc.log_payload, loc.log_term)

    def k2():
        sc.steady_step(vecs, *args, win, B, al, sl, None, prm, o2, None, r,
                       prev)

    def k2p():
        sc.steady_step_plain(vecs, *args, win, B, al, sl, None, prm, o2,
                             None, r, prev)

    # bytes: window read, payload write (one row's lanes), term write (one
    # row, no read), the plane in and out, the prev column, the out block
    step_bytes = 2 * B * W * 4 + B * 4 + 2 * 6 * R * 4 + R * 4 + \
        (2 * R + 5) * 4 + 2 * R
    out = {"K2·mesh": (kernel_ms("K2·mesh", k2, reps, inner=20),
                       _host_ms(k2p, reps), step_bytes)}
    wins = torch.stack([rand_window(rng, B, W, dev) for _ in range(T)])
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    o3 = torch.zeros(R + 5, dtype=torch.int32, device=dev)
    br = sc.pick_br(B, C)

    def k3():
        return sc.pipeline_flight(vecs, *args, wins, counts, al, sl, None,
                                  prm, br, False, o3, None, r, prev)

    def k3p():
        sc.pipeline_flight_plain(vecs, *args, wins, counts, al, sl, None,
                                 prm, br, False, o3, sc.workspace(dev),
                                 None, r, prev)

    split = {}
    out["K3·mesh"] = (kernel_ms("K3·mesh", k3, reps, split=split),
                      _host_ms(k3p, reps), T * step_bytes)
    split["record_matches_plain"] = record_matches_plain(
        "K3·mesh", k3, (vecs, *args), o3, wins, counts, al, sl, None, prm,
        br, None, r, prev)

    # K4·mesh as the mesh launches it: alone, from the host's decision and
    # start slot (the leader's tail here; the timed flights keep it a
    # multiple of C)
    s0 = int(vecs[2, 0]) % C

    k4_calls = [0]

    def k4():
        k4_calls[0] += 1
        sc.turnover_flight(vecs, *args, wins, T, prm, o3, None, r, s0)

    def k4p():
        sc.turnover_flight_plain(vecs, *args, wins, T, prm, o3,
                                 sc.workspace(dev), None, s0)

    work = sc.workspace(dev)
    ran4 = int(work[sc.WK_RAN4])
    k4_time = kernel_ms("K4·mesh", k4, reps)
    # every launch ran the flight, retried profiler sessions' included
    check(int(work[sc.WK_RAN4]) - ran4 == k4_calls[0] >= 2 * reps + 2,
          "timed K4·mesh launches did not all run the flight")
    # the T*B = C window rows read once, the row's C slots of payload and
    # terms written once, the plane in and out
    k4_bytes = T * B * W * 4 + C * W * 4 + C * 4 + 2 * 6 * R * 4
    out["K4·mesh"] = (k4_time, _host_ms(k4p, reps), k4_bytes)
    res = {k: {"ms": ms, "call_ms": call_ms, "plain_ms": pms,
               "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
           for k, ((ms, call_ms), pms, nbytes) in out.items()}
    res["k2_split"] = k2_split(out["K2·mesh"])
    res["k3_split"] = split
    check(T * B == C, "the yardstick needs one writer a slot")
    res["K4·mesh"]["library_ms"] = ops_ms(
        ring_yardstick(*args, wins, s0, 1), reps)
    res["k4_mesh_split"] = k4_mesh_split(cfg, dev, rng, reps, rate, k4, args,
                                         wins, vecs, prm, o3, r, s0)
    return res


def k4_mesh_split(cfg, dev, rng, reps, rate, k4, rings, wins, vecs, prm,
                  out, r, s0):
    """K4·mesh's three parts, each launched alone (payload row, term row,
    closed-form bookkeeping); the whole kernel with the L2 cache flushed
    before each launch (the windows otherwise stay in the 50 MB L2 from
    one timed launch to the next); and the whole kernel at mesh config 3's
    88-byte rows (word pairs)."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    T = STEPS_PER_FLIGHT
    res = {}
    for name, parts in (("payload", sc.TURNOVER_PAYLOAD),
                        ("terms", sc.TURNOVER_TERMS),
                        ("bookkeeping", sc.TURNOVER_BOOK)):
        def part(parts=parts):
            sc.turnover_flight(vecs, *rings, wins, T, prm, out, None, r, s0,
                               parts)
        res[name + "_ms"] = kernel_ms("K4·mesh", part, reps)[0]
    scrub = torch.empty(1 << 24, dtype=torch.int32, device=dev)   # 64 MB
    res["cold_l2_ms"] = kernel_ms("K4·mesh", k4, reps,
                                  before=lambda: scrub.fill_(0))[0]
    ecfg = ec_config()
    C, B, R, W = ecfg.log_capacity, ecfg.batch_size, ecfg.rows, \
        ecfg.shard_words
    st = steady_state(ecfg, dev, 5 * B, rng=rng)
    loc = local_row(st, r, W)
    v5 = sc.pack(st)
    w5 = torch.stack([rand_window(rng, B, W, dev) for _ in range(T)])
    p5 = sc.step_params(0, 1, 1, 0, 0, ecfg.commit_quorum, R, ec=True)
    o5 = torch.zeros(R + 5, dtype=torch.int32, device=dev)
    s5 = int(v5[2, 0]) % C

    def k4_c3():
        sc.turnover_flight(v5, loc.log_payload, loc.log_term, w5, T, p5, o5,
                           None, r, s5)

    c3_bytes = T * B * W * 4 + C * W * 4 + C * 4 + 2 * 6 * R * 4
    res["config3_ms"] = kernel_ms("K4·mesh", k4_c3, reps)[0]
    res["config3_bound_ms"] = c3_bytes / rate * 1e3
    res["config3_library_ms"] = ops_ms(ring_yardstick(
        loc.log_payload, loc.log_term, w5, s5, 1), reps)
    return res


def phase_mesh_timing(cfg, dev, card_line, kernels, main, reps=21):
    """The mesh kernels' times (``kernels``, taken before any rank was
    spawned), ``bench_mesh1``'s counterpart and the 3-rank north star's
    flight and collective times (``main``)."""
    from raft_tpu_torch.transport.launch import run_ranks

    res = {"phase": "mesh_timing", "card": card_line,
           "mem_bytes_per_s": mem_rate(card_line)}
    res.update(kernels)
    m1 = run_ranks(mesh1_rank_main, 1, (str(dev), reps),
                   timeout=MESH_DEADLINE_S)[0]
    res["bench_mesh1"] = dict(
        m1, unit="host us per 32-step flight (gather_plane: per call of "
                 "the two launch collectives), medians, in turns",
        per_device_overhead_us=m1["mesh_of_1"] - m1["co_located"])
    res["north_star_3_ranks"] = {
        "note": "three processes time-sharing one card (gloo), not a "
                "multi-card figure",
        "ms_per_flight": main["north_star_ms_per_flight"],
        "gather_ms_per_call": main["gather_ms_per_call"],
        "gather_alone_ms": main["gather_alone_ms"],
        "gather_calls_per_rank": main["gather_calls_per_rank"]}
    emit(res)
    return res


# ------------------------------------ 16. the engine over the mesh (A15)
#: the engine-over-the-mesh schedules: the north star's (full) and the
#: card-vs-CPU run's (reduced); entries in batches of B
ENGINE_MESH_PLANS = {
    "full": dict(capacity=1 << 15, ticks=64, profiled=8, rings=4,
                 after=4096, lap_ticks=4),
    "reduced": dict(capacity=4096, ticks=8, profiled=0, rings=1,
                    after=2048, lap_ticks=2),
}
ENGINE_MESH_CHECK_EVERY = 64       # mirror_check_every of the mesh engines
ENGINE_MESH_EC_PLAN = dict(ticks=16, degraded=8, after=4096)
#: the 2-D mesh's schedules (payload_shards = 2): the north star's, and
#: config 3's (a cut of the 1-D plans' depth, not of any width)
ENGINE_MESH2D_PLAN = dict(capacity=1 << 15, ticks=32, profiled=0, rings=2,
                          after=4096, lap_ticks=4)
ENGINE_MESH2D_EC_PLAN = dict(ticks=8, degraded=4, after=1024)
MESH2D_SHARDS = 2
ENGINE_MESH_DEV_RING = 256         # the card-vs-CPU run's event ring


def engine_mesh_config(capacity, **over):
    """The north star (3 replicas, 256-byte entries, B = 1024) through the
    mesh engine, with the mirror digest checked every 64 decisions."""
    from raft_tpu_torch.config import RaftConfig

    kw = dict(n_replicas=3, entry_bytes=256, batch_size=1024,
              log_capacity=capacity, transport="tpu_mesh",
              mirror_check_every=ENGINE_MESH_CHECK_EVERY, seed=15)
    kw.update(over)
    return RaftConfig(**kw)


def mesh_engine_counters(dev):
    """The launches of every kernel the mesh engine can run, this
    process."""
    from raft_tpu_torch.core import ring_cuda, step_cuda
    from raft_tpu_torch.ec import kernels as ek

    return {"K1": ring_cuda.LAUNCHES["write_window_both"],
            "K2": step_cuda.LAUNCHES["steady_step"],
            "K3": step_cuda.LAUNCHES["pipeline_flight"],
            "K4": step_cuda.LAUNCHES["turnover_flight"],
            "K2·mesh": step_cuda.LAUNCHES["steady_step_mesh"],
            "K3·mesh": step_cuda.LAUNCHES["pipeline_flight_mesh"],
            "K4·mesh": step_cuda.LAUNCHES["turnover_flight_mesh"],
            "K6 encode": ek.LAUNCHES["encode"],
            "K6 decode": ek.LAUNCHES["decode"],
            "K7": ek.LAUNCHES["encode_fold"]}


def engine_transport(cfg, dev):
    """The engine's transport: this rank's ``MeshTransport`` inside a
    process group (``make_transport`` must pick it), else the resident
    layout."""
    import torch.distributed as dist

    from raft_tpu_torch.transport import MeshTransport, make_transport
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    if dist.is_available() and dist.is_initialized():
        tr = make_transport(cfg, device=dev)
        check(isinstance(tr, MeshTransport)
              and tr.rank == dist.get_rank(),
              "make_transport did not give this rank its MeshTransport")
        return tr
    return SingleDeviceTransport(dataclasses.replace(cfg, transport="single"),
                                 device=dev)


def rows_read_back(e, inp, lo, hi, what):
    """Indices [lo, hi] through ``committed_entries`` and from every live
    row's ring (on the mesh each a gathering fetch every rank makes):
    each SHA-256 must be the input's."""
    from raft_tpu_torch.core.state import log_entries

    want = hashlib.sha256(inp.window(lo, hi)).hexdigest()
    got = {"committed_entries": hashlib.sha256(
        e.committed_entries(lo, hi).tobytes()).hexdigest()}
    commits = e._rows(e.state.commit_index)
    for r in range(e.cfg.rows):
        if e.alive[r] and int(commits[r]) >= hi and e.cfg.rs_k is None:
            got[f"row{r}"] = hashlib.sha256(log_entries(
                e.state, r, lo, hi, e.t).tobytes()).hexdigest()
    for k, v in got.items():
        check(v == want, f"{what}: {k}'s read-back of [{lo}, {hi}] differs "
                         "from the input")
    return {"lo": lo, "hi": hi, "sha256": want, "readers": sorted(got)}


def state_rows(e):
    """Digest of every part of the state this process holds, keyed by
    mesh rank: on the mesh its own (row ``e.t.row``, its lane slice); on
    the resident layout every rank's part of the whole (rank ``g`` of
    ``rows * payload_shards``: row ``g // P`` with lane block ``g``)."""
    P = e.cfg.payload_shards
    st = e.state
    if st.term.shape[0] != e.cfg.rows:
        return {str(e.t.rank): part_digest(st, 0, st.log_payload)}
    w = e.cfg.shard_words // P
    return {str(g): part_digest(st, g // P,
                                st.log_payload[:, g * w:(g + 1) * w])
            for g in range(e.cfg.rows * P)}


class TickMeter:
    """Host ms of every leader tick (ended by a synchronize, so its device
    work is inside), with the collectives (over the pshard column, and on
    the 2-D mesh over the row group) and gathering fetches it made and
    their host seconds."""

    def __init__(self, e):
        import torch

        self.e, self.rows, self.on = e, [], True
        run = e._fire_leader_tick
        comm = e.t.comm

        def timed(r):
            if not self.on:
                return run(r)
            c0 = getattr(comm, "collectives", 0)
            cs0 = getattr(comm, "collective_s", 0.0)
            r0 = getattr(comm, "row_collectives", 0)
            rs0 = getattr(comm, "row_collective_s", 0.0)
            f0 = getattr(e.t, "fetches", 0)
            fs0 = getattr(e.t, "fetch_s", 0.0)
            t0 = time.perf_counter()
            out = run(r)
            if e.state.device.type == "cuda":
                torch.cuda.synchronize()
            self.rows.append((
                (time.perf_counter() - t0) * 1e3,
                getattr(comm, "collectives", 0) - c0,
                getattr(comm, "collective_s", 0.0) - cs0,
                getattr(e.t, "fetches", 0) - f0,
                getattr(e.t, "fetch_s", 0.0) - fs0,
                getattr(comm, "row_collectives", 0) - r0,
                getattr(comm, "row_collective_s", 0.0) - rs0))
            return out

        e._fire_leader_tick = timed

    def summary(self):
        if not self.rows:
            return None
        ms, col, col_s, fet, fet_s, row, row_s = (
            np.array(x, float) for x in zip(*self.rows))
        return {"leader_ticks": len(ms),
                "ms_per_tick_p50": float(np.percentile(ms, 50)),
                "ms_per_tick_p99": float(np.percentile(ms, 99)),
                "ms_per_tick_mean": float(ms.mean()),
                "collectives_per_tick": float(col.mean()),
                "host_ms_per_collective": float(col_s.sum() * 1e3
                                                / max(col.sum(), 1)),
                "gathering_fetches_per_tick": float(fet.mean()),
                "host_ms_per_gathering_fetch": float(fet_s.sum() * 1e3
                                                     / max(fet.sum(), 1)),
                "row_collectives_per_tick": float(row.mean()),
                "host_ms_per_row_collective": float(row_s.sum() * 1e3
                                                    / max(row.sum(), 1))}


def caught_up(e, row, what, beats=64):
    """Run heartbeats until ``row``'s verified match reaches the leader's
    last index (each check a gathering fetch every rank makes)."""
    import torch

    for _ in range(beats):
        e.run_for(e.cfg.heartbeat_period)
        m, last = e._rows(torch.stack([e.state.match_index,
                                       e.state.last_index]), 1)
        if int(m[row]) >= int(last[e.leader_id]):
            return
    raise RuntimeError(f"check failed: {what} never caught up")


def collective_alone_ms(tr, reps=21):
    """Host ms of one small data-plane all_gather with every rank entering
    together (after a barrier): the fabric's own cost, no rank's host
    work waited for (median; None on the resident layout)."""
    import torch
    import torch.distributed as dist

    if tr.resident:
        return None
    x = torch.zeros(1, 6, dtype=torch.int32, device=tr.device)
    times = []
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        tr.comm.all_gather_host(x)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def engine_mesh_run(cfg, dev, plan, tmp, profile=False, dev_ring=None):
    """The north star through ``RaftEngine`` on ``engine_transport``: an
    election; ``ticks`` leader ticks of B entries (K1 while repairing on
    the local row, K2·mesh once steady); one ``submit_pipelined`` of
    ``rings`` whole rings (one K4·mesh flight a ring); the leader failed,
    re-elected, ``after`` more, the old leader recovered; a follower
    failed and lapped (one ring as a flight with the dead row: K3·mesh,
    then ``lap_ticks`` ticks), recovered and rejoined by the snapshot
    stream; ``save_checkpoint`` and ``RaftEngine.restore`` with the vote
    log, an election and ``after`` more. Every window read back through
    ``committed_entries`` and every live row, the apply stream hashed.
    ``profile``: a torch.profiler window of ``profiled`` ticks here.
    ``dev_ring``: a flight recorder and a device event ring of that
    capacity (the packed ring is returned)."""
    import os

    import torch

    from raft_tpu_torch.obs import FlightRecorder
    from raft_tpu_torch.obs.device import packed_flush
    from raft_tpu_torch.raft import RaftEngine

    B, C = cfg.batch_size, cfg.log_capacity
    lines = []
    vlog = os.path.join(tmp, "votes.log")
    rec = FlightRecorder() if dev_ring else None
    e = RaftEngine(cfg, engine_transport(cfg, dev), trace=lines.append,
                   vote_log=vlog, recorder=rec)
    dobs = e.attach_device_obs(capacity=dev_ring) if dev_ring else None
    inp = EngineInput(cfg)
    h_apply = hashlib.sha256()
    applied = [0]

    def apply(idx, payload):
        check(idx == applied[0] + 1, "the apply stream skipped an index")
        applied[0] = idx
        h_apply.update(payload)

    e.register_apply(apply)
    flights = []
    run_flight = e.t.replicate_pipeline

    def counted_flight(*a, **k):
        flights.append(bool(k.get("allow_turnover", True)))
        return run_flight(*a, **k)

    e.t.replicate_pipeline = counted_flight
    meter = TickMeter(e)
    res, reads = {}, []

    def ticks(n):
        for _ in range(n):
            seqs = [e.submit(p) for p in inp.take(B)]
            e.run_until_committed(seqs[-1])

    e.run_until_leader()
    res["first_leader"] = e.leader_id
    # 1. leader ticks, read back ring by ring
    t0 = time.perf_counter()
    half = plan["ticks"] - plan["profiled"]
    ticks(half)
    tick_wall = time.perf_counter() - t0
    res["ticks_entries_per_s_wall"] = half * B / tick_wall
    # the tick statistics cover the unprofiled ticks only: the profiler
    # on rank 0 holds every rank at its next collective
    res["ticks"] = meter.summary()
    meter.on = False
    res["collective_alone_ms"] = collective_alone_ms(e.t)
    if plan["profiled"]:
        target = e._tick_count + plan["profiled"]
        seqs = [e.submit(p) for p in inp.take(plan["profiled"] * B)]

        def window():
            while e._tick_count < target:
                e.step_event()

        if profile:
            events, pwall = _device_events(window, 1)
            busy = sum(us for _, us in events)
            by_name = {}
            for name, us in events:
                k = kernel_of(name) or name[:40]
                by_name[k] = by_name.get(k, 0.0) + us
            res["profiled_ticks"] = {
                "ticks": plan["profiled"], "wall_ms": pwall * 1e3,
                "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / (pwall * 1e6),
                "device_ops_per_tick": len(events) / plan["profiled"],
                "device_ms_by_kind": {k: v / 1e3
                                      for k, v in by_name.items()}}
        else:
            window()
        e.run_until_committed(seqs[-1])
    wm = e.commit_watermark
    check(wm == plan["ticks"] * B, f"mesh engine ticks committed {wm}")
    for a in range(max(1, wm - C + 1), wm + 1, C):
        reads.append(rows_read_back(e, inp, a, min(wm, a + C - 1),
                                    "mesh engine ticks"))
    # 2. whole rings through submit_pipelined: one flight a ring
    last0 = e.commit_watermark
    n_pipe = plan["rings"] * C
    payloads = inp.take(n_pipe)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    e.submit_pipelined(payloads)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    chunk_wall = time.perf_counter() - t0
    check(flights == [True] * plan["rings"],
          f"mesh engine: the gate did not fly every ring: {flights}")
    check(e.commit_watermark == last0 + n_pipe,
          f"mesh engine: the chunk committed {e.commit_watermark}")
    reads.append(rows_read_back(e, inp, e.commit_watermark - C + 1,
                                e.commit_watermark, "mesh engine chunk"))
    res["chunk"] = {"entries": n_pipe, "flights": len(flights),
                    "wall_s": chunk_wall,
                    "entries_per_s_wall": n_pipe / chunk_wall}
    # 3. leader failover, then the old leader back
    old = e.leader_id
    e.fail(old)
    e.run_until_leader()
    res["failover"] = {"failed": old, "new_leader": e.leader_id,
                       "term": int(e.leader_term)}
    lo = e.commit_watermark + 1
    ticks(plan["after"] // B)
    reads.append(rows_read_back(e, inp, lo, e.commit_watermark,
                                "mesh engine after failover"))
    e.recover(old)
    caught_up(e, old, "the old leader")
    # 4. a follower lapped: a flight with the dead row, then ticks
    lapped = next(q for q in range(cfg.rows) if q != e.leader_id)
    e.fail(lapped)
    e.run_for(2 * cfg.heartbeat_period)
    n0 = len(flights)
    e.submit_pipelined(inp.take(C))
    check(flights[n0:] == [False],
          f"mesh engine: the dead-row ring did not fly as K3: {flights}")
    ticks(plan["lap_ticks"])
    e.recover(lapped)
    caught_up(e, lapped, "the lapped row")
    check(e._shipper.chunks_total > 0,
          "mesh engine: the lapped row was not streamed a snapshot")
    res["lapped"] = {"row": lapped, "snapshot_chunks":
                     int(e._shipper.chunks_total)}
    reads.append(rows_read_back(e, inp, e.commit_watermark - C + 1,
                                e.commit_watermark, "mesh engine rejoin"))
    check(applied[0] == e.commit_watermark
          and h_apply.hexdigest() == hashlib.sha256(
              inp.window(1, e.commit_watermark)).hexdigest(),
          "mesh engine: the apply stream differs from the input")
    res["apply"] = {"entries": applied[0], "sha256": h_apply.hexdigest()}
    res["mirror"] = {"decisions": e._mirror_decisions,
                     "exchanges": e.mirror_exchanges,
                     "ms_per_exchange": (e.mirror_exchange_s * 1e3
                                         / max(e.mirror_exchanges, 1))}
    packed = None if dobs is None else e._fetch(packed_flush(e._dev_ring))
    # 5. checkpoint and restore (the vote log replayed over it)
    path = os.path.join(tmp, "cluster.npz")
    t0 = time.perf_counter()
    e.save_checkpoint(path)
    save_s = time.perf_counter() - t0
    pre_lines = list(lines)
    lines2 = []
    t0 = time.perf_counter()
    e2 = RaftEngine.restore(cfg, path, engine_transport(cfg, dev),
                            trace=lines2.append, vote_log=vlog)
    restore_s = time.perf_counter() - t0
    wm0 = e2.commit_watermark
    check(wm0 == e.commit_watermark, f"restored to {wm0}")
    e2.run_until_leader()
    lo = wm0 + 1
    for _ in range(plan["after"] // B):
        seqs = [e2.submit(p) for p in inp.take(B)]
        e2.run_until_committed(seqs[-1])
    reads.append(rows_read_back(e2, inp, lo, e2.commit_watermark,
                                "mesh engine after restore"))
    reads.append(rows_read_back(e2, inp, e2.commit_watermark - C + 1,
                                e2.commit_watermark,
                                "mesh engine restored ring"))
    res.update({
        "checkpoint": {"save_s": save_s, "restore_s": restore_s,
                       "restored_to": wm0},
        "entries": e2.commit_watermark,
        "sha256_input": hashlib.sha256(
            inp.window(1, e2.commit_watermark)).hexdigest(),
        "read_backs": reads, "flights": flights,
        "lines": len(pre_lines) + len(lines2),
        "lines_sha256": hashlib.sha256(
            "\n".join(pre_lines + ["--"] + lines2).encode()).hexdigest(),
        "rows": state_rows(e2), "fetches": getattr(e.t, "fetches", 0)
        + getattr(e2.t, "fetches", 0)})
    if packed is not None:
        res["packed_ring"] = packed
        res["device_lines"] = dobs.nodelog_lines()
        res["host_lines"] = [ev.nodelog() for ev in rec.events()
                             if ev.kind in ("elect", "commit")]
    return res


def engine_mesh_rank_main(rank, world, cfg, device, plan, profile,
                          dev_ring=None):
    """One rank of the mirrored engine (spawned): the counts set to 0, the
    schedule, the counts read."""
    import tempfile

    dev = rank_device(device)
    zero_ec_counters(dev)
    with tempfile.TemporaryDirectory(prefix=f"mesh_engine_{rank}_") as tmp:
        with fly_on_cpu(dev.type):
            res = engine_mesh_run(cfg, dev, plan, tmp,
                                  profile=(profile and rank == 0
                                           and dev.type == "cuda"),
                                  dev_ring=dev_ring)
    res["launches"] = mesh_engine_counters(dev)
    return res


def same_rows(ranks, ref, what):
    """Every rank's own row equal to that row of ``ref`` (a run that holds
    every row)."""
    for r, res in enumerate(ranks):
        check(res["rows"][str(r)] == ref["rows"][str(r)],
              f"{what}: rank {r}'s row differs from the reference's")


def phase_engine_mesh_path(dev):
    """The north-star deployment through the mirrored engine on 3 gloo
    ranks sharing ``dev`` (``engine_mesh_run`` at the full plan, the mirror
    digest every 64 decisions): every rank's read-backs and apply stream
    against the input's SHA-256, nodelog lines equal across the ranks and
    equal to the single-device engine's on the same seed here, every
    rank's row equal to that engine's row, mirror exchanges made with no
    desync, and K1, K2·mesh, K3·mesh and K4·mesh launched on every rank."""
    import tempfile

    from raft_tpu_torch.transport.launch import run_ranks

    plan = ENGINE_MESH_PLANS["full"]
    cfg = engine_mesh_config(plan["capacity"])
    t0 = time.perf_counter()
    ranks = run_ranks(engine_mesh_rank_main, cfg.rows,
                      (cfg, str(dev), plan, True), timeout=MESH_DEADLINE_S)
    ranks_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mesh_engine_ref_") as tmp:
        ref = engine_mesh_run(cfg, dev, plan, tmp)
    for r, res in enumerate(ranks):
        for k in ("lines_sha256", "lines", "entries", "sha256_input",
                  "apply", "flights", "first_leader", "failover",
                  "lapped"):
            check(res[k] == ref[k], f"engine mesh rank {r}: {k} "
                                    f"{res[k]} != {ref[k]}")
        check([x["sha256"] for x in res["read_backs"]]
              == [x["sha256"] for x in ref["read_backs"]],
              f"engine mesh rank {r}: read-backs differ")
        check(res["mirror"]["exchanges"] > 0,
              f"engine mesh rank {r}: no mirror digest exchange")
        for k in ("K1", "K2·mesh", "K3·mesh", "K4·mesh"):
            check(res["launches"][k] > 0 or dev.type != "cuda",
                  f"engine mesh rank {r}: {k} never launched")
        check(res["launches"]["K2"] == res["launches"]["K3"]
              == res["launches"]["K4"] == 0,
              f"engine mesh rank {r}: a resident kernel ran on the mesh")
    same_rows(ranks, ref, "engine mesh")
    r0 = ranks[0]
    out = {"phase": "engine_mesh_path", "ranks": cfg.rows,
           "backend": "gloo, all ranks on one card (three processes "
                      "time-sharing it, not a multi-card figure)",
           "capacity": cfg.log_capacity, "batch": cfg.batch_size,
           "entry_bytes": cfg.entry_bytes,
           "mirror_check_every": cfg.mirror_check_every,
           "entries": r0["entries"], "sha256_input": r0["sha256_input"],
           "apply": r0["apply"], "read_backs": len(r0["read_backs"]),
           "lines": r0["lines"], "flights": r0["flights"],
           "failover": r0["failover"], "lapped": r0["lapped"],
           "ticks_per_rank": [res["ticks"] for res in ranks],
           "ticks_note": "the 56 unprofiled leader ticks; host ms a "
                         "collective includes waiting for the slowest rank",
           "collective_alone_ms": [res["collective_alone_ms"]
                                   for res in ranks],
           "ticks_entries_per_s_wall": [res["ticks_entries_per_s_wall"]
                                        for res in ranks],
           "chunk_per_rank": [res["chunk"] for res in ranks],
           "mirror_per_rank": [res["mirror"] for res in ranks],
           "checkpoint_per_rank": [res["checkpoint"] for res in ranks],
           "gathering_fetches_per_rank": [res["fetches"] for res in ranks],
           "profiled_ticks_rank0": r0.get("profiled_ticks"),
           "single_device_ref": {"ticks": ref["ticks"],
                                 "ticks_entries_per_s_wall":
                                 ref["ticks_entries_per_s_wall"],
                                 "chunk": ref["chunk"]},
           "launches_per_rank": [res["launches"] for res in ranks],
           "launches": {k: sum(res["launches"][k] for res in ranks)
                        for k in r0["launches"]},
           "ranks_wall_s": ranks_wall}
    emit(out)
    return out


def engine_mesh_ec_run(cfg, dev, plan, tmp):
    """Config 3 through the mirrored EC engine: an election, ``ticks``
    leader ticks (K7 encodes each batch on every rank), a data row failed
    and ``degraded`` ticks committed at 4 of 5, a decoding read through
    K6 from the gathered donors, the row recovered and healed by
    reconstruction, ``save_checkpoint`` and ``RaftEngine.restore`` (K6
    encodes the restored shard rows), an election and ``after`` more;
    every read back exactly."""
    import os

    from raft_tpu_torch.ec.reconstruct import reconstruct
    from raft_tpu_torch.raft import RaftEngine

    B = cfg.batch_size
    lines = []
    e = RaftEngine(cfg, engine_transport(cfg, dev), trace=lines.append)
    inp = EngineInput(cfg)
    res = {}

    def ticks(eng, n):
        for _ in range(n):
            seqs = [eng.submit(p) for p in inp.take(B)]
            eng.run_until_committed(seqs[-1])

    def same(got, lo, hi, what):
        check(hashlib.sha256(np.ascontiguousarray(got).tobytes())
              .hexdigest() == hashlib.sha256(inp.window(lo, hi))
              .hexdigest(), f"{what}: [{lo}, {hi}] differs from the input")

    e.run_until_leader()
    ticks(e, plan["ticks"])
    dead = next(q for q in range(cfg.rs_k) if q != e.leader_id)
    e.fail(dead)
    lo = e.commit_watermark + 1
    ticks(e, plan["degraded"])
    hi = e.commit_watermark
    holders = [q for q in range(cfg.rows) if e.alive[q]][:cfg.rs_k]
    same(e.committed_entries(lo, hi), lo, hi, "decoding read")
    res["decoding_read"] = {"lo": lo, "hi": hi, "rows": holders}
    e.recover(dead)
    caught_up(e, dead, "the dead row's heal")
    rows = [dead] + [q for q in range(cfg.rows) if q != dead][:2]
    same(reconstruct(e.state, e._code, rows, 1, e.commit_watermark,
                     e.t), 1, e.commit_watermark, "healed row read")
    res["healed"] = {"row": dead, "read_rows": rows}
    path = os.path.join(tmp, "ec.npz")
    e.save_checkpoint(path)
    e2 = RaftEngine.restore(cfg, path, engine_transport(cfg, dev),
                            trace=lines.append)
    e2.run_until_leader()
    lo = e2.commit_watermark + 1
    ticks(e2, plan["after"] // B)
    same(e2.committed_entries(1, e2.commit_watermark), 1,
         e2.commit_watermark, "restored read")
    same(reconstruct(e2.state, e2._code, [2, 3, 4], lo, e2.commit_watermark,
                     e2.t), lo, e2.commit_watermark, "restored parity read")
    res.update({"entries": e2.commit_watermark, "lines": len(lines),
                "lines_sha256": hashlib.sha256(
                    "\n".join(lines).encode()).hexdigest(),
                "rows": state_rows(e2)})
    return res


def engine_mesh_ec_rank_main(rank, world, cfg, device, plan):
    import tempfile

    dev = rank_device(device)
    zero_ec_counters(dev)
    with tempfile.TemporaryDirectory(prefix=f"mesh_ec_{rank}_") as tmp:
        res = engine_mesh_ec_run(cfg, dev, plan, tmp)
    res["launches"] = mesh_engine_counters(dev)
    return res


def phase_engine_mesh_ec_path(dev):
    """BASELINE config 3 (RS(5,3), 264-byte entries, B = 1024, C = 32 768)
    through the mirrored engine on 5 gloo ranks sharing ``dev``: a dead
    data row, a decoding read through K6 from the gathered donor windows,
    the heal, a restore; exact read-backs, every rank's nodelog lines and
    row equal to the single-device engine's, K7, K6 (encode and decode)
    and K2·mesh launched on every rank."""
    import tempfile

    from raft_tpu_torch.transport.launch import run_ranks

    cfg = dataclasses.replace(ec_engine_config(1 << 15),
                              transport="tpu_mesh",
                              mirror_check_every=ENGINE_MESH_CHECK_EVERY)
    plan = ENGINE_MESH_EC_PLAN
    t0 = time.perf_counter()
    ranks = run_ranks(engine_mesh_ec_rank_main, cfg.rows,
                      (cfg, str(dev), plan), timeout=MESH_DEADLINE_S)
    ranks_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mesh_ec_ref_") as tmp:
        ref = engine_mesh_ec_run(cfg, dev, plan, tmp)
    for r, res in enumerate(ranks):
        for k in ("lines_sha256", "entries", "decoding_read", "healed"):
            check(res[k] == ref[k], f"engine mesh ec rank {r}: {k}")
        for k in ("K7", "K6 encode", "K6 decode", "K2·mesh"):
            check(res["launches"][k] > 0 or dev.type != "cuda",
                  f"engine mesh ec rank {r}: {k} never launched")
    same_rows(ranks, ref, "engine mesh ec")
    out = {"phase": "engine_mesh_ec_path", "ranks": cfg.rows,
           "backend": "gloo, all ranks on one card (five processes "
                      "time-sharing it)",
           "entries": ranks[0]["entries"],
           "decoding_read": ranks[0]["decoding_read"],
           "healed": ranks[0]["healed"], "lines": ranks[0]["lines"],
           "launches_per_rank": [res["launches"] for res in ranks],
           "launches": {k: sum(res["launches"][k] for res in ranks)
                        for k in ranks[0]["launches"]},
           "ranks_wall_s": ranks_wall}
    emit(out)
    return out


def phase_mesh_engine_card_equals_cpu(dev):
    """``engine_mesh_run`` at the reduced plan (C = 4 096) with a flight
    recorder and a 256-record device event ring: 3 ranks on the card
    against 3 ranks on the CPU (the CPU's flight gate opened), each rank's
    nodelog lines, row, packed ring and read-backs equal."""
    from raft_tpu_torch.transport.launch import run_ranks

    plan = ENGINE_MESH_PLANS["reduced"]
    cfg = engine_mesh_config(plan["capacity"])
    runs = {}
    for where in (str(dev), "cpu"):
        t0 = time.perf_counter()
        runs[where] = (run_ranks(
            engine_mesh_rank_main, cfg.rows,
            (cfg, where, plan, False, ENGINE_MESH_DEV_RING),
            timeout=MESH_DEADLINE_S), time.perf_counter() - t0)
    card, cpu = runs[str(dev)][0], runs["cpu"][0]
    for r in range(cfg.rows):
        a, b = card[r], cpu[r]
        for k in ("lines_sha256", "rows", "apply", "flights",
                  "device_lines", "host_lines"):
            check(a[k] == b[k], f"mesh card vs cpu rank {r}: {k}")
        check(np.array_equal(a["packed_ring"], b["packed_ring"]),
              f"mesh card vs cpu rank {r}: packed rings differ")
        check([x["sha256"] for x in a["read_backs"]]
              == [x["sha256"] for x in b["read_backs"]],
              f"mesh card vs cpu rank {r}: read-backs differ")
        check(a["device_lines"] == a["host_lines"] and a["device_lines"],
              f"mesh card rank {r}: the device ring's lines are not the "
              "host's")
    out = {"phase": "mesh_engine_card_equals_cpu", "ranks": cfg.rows,
           "capacity": cfg.log_capacity, "entries": card[0]["entries"],
           "device_ring": ENGINE_MESH_DEV_RING,
           "device_lines": len(card[0]["device_lines"]),
           "lines": card[0]["lines"], "flights": card[0]["flights"],
           "launches": {k: sum(res["launches"][k] for res in card)
                        for k in card[0]["launches"]},
           "card_wall_s": runs[str(dev)][1], "cpu_wall_s": runs["cpu"][1]}
    emit(out)
    return out


# ----------------------------- 17. the 2-D payload mesh (A15b, first part)
def engine_mesh2d_checks(ranks, ref, what, keys, kernels, dev):
    """The checks of a 2-D engine phase: every rank's ``keys`` equal to
    the single-device engine's on the same schedule, its slice equal to
    its part of that engine's row, mirror exchanges made with no desync,
    each of ``kernels`` launched on every rank and no resident kernel."""
    for g, res in enumerate(ranks):
        for k in keys:
            check(res[k] == ref[k], f"{what} rank {g}: {k} "
                                    f"{res[k]} != {ref[k]}")
        check(res["rows"][str(g)] == ref["rows"][str(g)],
              f"{what}: rank {g}'s slice differs from its part of the "
              "single-device engine's row")
        for k in kernels:
            check(res["launches"][k] > 0 or dev.type != "cuda",
                  f"{what} rank {g}: {k} never launched")
        check(res["launches"]["K2"] == res["launches"]["K3"]
              == res["launches"]["K4"] == 0,
              f"{what} rank {g}: a resident kernel ran on the mesh")


def phase_engine_mesh2d_path(dev):
    """The north star on the 2-D mesh: 3 replicas x ``payload_shards`` 2
    = 6 gloo ranks sharing ``dev`` (256-byte entries, 32 words a rank, B
    = 1024, C = 32 768, the mirror digest every 64 decisions): an
    election, 32 leader ticks (K1, then K2·mesh on each rank's slice), a
    2-ring ``submit_pipelined`` (K4·mesh), a failover, a follower lapped
    by a dead-row ring (K3·mesh) and rejoined by the snapshot stream, a
    checkpoint and restore and 4 096 more. Every rank's read-backs (full
    width, stitched over its row group) and apply stream against the
    input's SHA-256, its lines equal across the six and to the
    single-device engine's, its slice equal to its part of that engine's
    row, mirror exchanges with no desync."""
    import tempfile

    from raft_tpu_torch.transport.launch import run_ranks

    t_phase = time.perf_counter()
    plan = ENGINE_MESH2D_PLAN
    cfg = engine_mesh_config(plan["capacity"], payload_shards=MESH2D_SHARDS)
    world = cfg.rows * MESH2D_SHARDS
    t0 = time.perf_counter()
    ranks = run_ranks(engine_mesh_rank_main, world,
                      (cfg, str(dev), plan, False), timeout=MESH_DEADLINE_S)
    ranks_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mesh2d_ref_") as tmp:
        ref = engine_mesh_run(cfg, dev, plan, tmp)
    engine_mesh2d_checks(
        ranks, ref, "engine mesh2d",
        ("lines_sha256", "lines", "entries", "sha256_input", "apply",
         "flights", "first_leader", "failover", "lapped"),
        ("K1", "K2·mesh", "K3·mesh", "K4·mesh"), dev)
    for g, res in enumerate(ranks):
        check([x["sha256"] for x in res["read_backs"]]
              == [x["sha256"] for x in ref["read_backs"]],
              f"engine mesh2d rank {g}: read-backs differ")
        check(res["mirror"]["exchanges"] > 0,
              f"engine mesh2d rank {g}: no mirror digest exchange")
    r0 = ranks[0]
    out = {"phase": "engine_mesh2d_path", "ranks": world,
           "replicas": cfg.rows, "payload_shards": MESH2D_SHARDS,
           "words_per_rank": cfg.shard_words // MESH2D_SHARDS,
           "backend": "gloo, all six ranks on one card (six processes "
                      "time-sharing it, not a multi-card figure)",
           "capacity": cfg.log_capacity, "batch": cfg.batch_size,
           "entry_bytes": cfg.entry_bytes,
           "mirror_check_every": cfg.mirror_check_every,
           "entries": r0["entries"], "sha256_input": r0["sha256_input"],
           "apply": r0["apply"], "read_backs": len(r0["read_backs"]),
           "lines": r0["lines"], "flights": r0["flights"],
           "failover": r0["failover"], "lapped": r0["lapped"],
           "ticks_per_rank": [res["ticks"] for res in ranks],
           "ticks_note": "leader ticks; collectives_per_tick are the "
                         "replica (pshard column) collectives, "
                         "row_collectives_per_tick the row-group gathers; "
                         "host ms a collective includes waiting for the "
                         "slowest rank",
           "collective_alone_ms": [res["collective_alone_ms"]
                                   for res in ranks],
           "ticks_entries_per_s_wall": [res["ticks_entries_per_s_wall"]
                                        for res in ranks],
           "chunk_per_rank": [res["chunk"] for res in ranks],
           "mirror_per_rank": [res["mirror"] for res in ranks],
           "checkpoint_per_rank": [res["checkpoint"] for res in ranks],
           "gathering_fetches_per_rank": [res["fetches"] for res in ranks],
           "single_device_ref": {"ticks": ref["ticks"],
                                 "ticks_entries_per_s_wall":
                                 ref["ticks_entries_per_s_wall"],
                                 "chunk": ref["chunk"]},
           "launches_per_rank": [res["launches"] for res in ranks],
           "launches": {k: sum(res["launches"][k] for res in ranks)
                        for k in r0["launches"]},
           "ranks_wall_s": ranks_wall,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_engine_mesh2d_ec_path(dev):
    """BASELINE config 3 on the 2-D mesh: RS(5,3), 264-byte entries (an
    88-byte shard, 22 words, 11 a rank), B = 1024, C = 32 768, 5 replicas
    x 2 = 10 gloo ranks sharing ``dev``: K7-fed ticks (each rank cuts
    lane block g of the fold), a dead data row, a decoding read through
    K6 from the donor block stitched over the row groups, the heal (K6
    decode and encode, each rank installing its byte slice), a restore
    and 1 024 more; every window exact, every rank's lines and slice
    equal to the single-device EC engine's."""
    import tempfile

    from raft_tpu_torch.transport.launch import run_ranks

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(ec_engine_config(1 << 15),
                              transport="tpu_mesh",
                              mirror_check_every=ENGINE_MESH_CHECK_EVERY,
                              payload_shards=MESH2D_SHARDS)
    world = cfg.rows * MESH2D_SHARDS
    plan = ENGINE_MESH2D_EC_PLAN
    t0 = time.perf_counter()
    ranks = run_ranks(engine_mesh_ec_rank_main, world,
                      (cfg, str(dev), plan), timeout=MESH_DEADLINE_S)
    ranks_wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="mesh2d_ec_ref_") as tmp:
        ref = engine_mesh_ec_run(cfg, dev, plan, tmp)
    engine_mesh2d_checks(
        ranks, ref, "engine mesh2d ec",
        ("lines_sha256", "entries", "decoding_read", "healed"),
        ("K7", "K6 encode", "K6 decode", "K2·mesh"), dev)
    out = {"phase": "engine_mesh2d_ec_path", "ranks": world,
           "replicas": cfg.rows, "payload_shards": MESH2D_SHARDS,
           "words_per_rank": cfg.shard_words // MESH2D_SHARDS,
           "backend": "gloo, all ten ranks on one card (ten processes "
                      "time-sharing it)",
           "entries": ranks[0]["entries"],
           "decoding_read": ranks[0]["decoding_read"],
           "healed": ranks[0]["healed"], "lines": ranks[0]["lines"],
           "launches_per_rank": [res["launches"] for res in ranks],
           "launches": {k: sum(res["launches"][k] for res in ranks)
                        for k in ranks[0]["launches"]},
           "ranks_wall_s": ranks_wall,
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


def phase_mesh2d_card_equals_cpu(dev):
    """``engine_mesh_run`` at the reduced plan (C = 4 096) on the 2-D
    mesh, with a flight recorder and a 256-record device event ring: 6
    ranks on the card against 6 ranks on the CPU (the CPU's flight gate
    opened), each rank's lines, slice, packed ring and read-backs
    equal."""
    from raft_tpu_torch.transport.launch import run_ranks

    t_phase = time.perf_counter()
    plan = ENGINE_MESH_PLANS["reduced"]
    cfg = engine_mesh_config(plan["capacity"], payload_shards=MESH2D_SHARDS)
    world = cfg.rows * MESH2D_SHARDS
    runs = {}
    for where in (str(dev), "cpu"):
        t0 = time.perf_counter()
        runs[where] = (run_ranks(
            engine_mesh_rank_main, world,
            (cfg, where, plan, False, ENGINE_MESH_DEV_RING),
            timeout=MESH_DEADLINE_S), time.perf_counter() - t0)
    card, cpu = runs[str(dev)][0], runs["cpu"][0]
    for g in range(world):
        a, b = card[g], cpu[g]
        for k in ("lines_sha256", "rows", "apply", "flights",
                  "device_lines", "host_lines"):
            check(a[k] == b[k], f"mesh2d card vs cpu rank {g}: {k}")
        check(np.array_equal(a["packed_ring"], b["packed_ring"]),
              f"mesh2d card vs cpu rank {g}: packed rings differ")
        check([x["sha256"] for x in a["read_backs"]]
              == [x["sha256"] for x in b["read_backs"]],
              f"mesh2d card vs cpu rank {g}: read-backs differ")
        check(a["device_lines"] == a["host_lines"] and a["device_lines"],
              f"mesh2d card rank {g}: the device ring's lines are not the "
              "host's")
    check(all(np.array_equal(card[0]["packed_ring"], c["packed_ring"])
              for c in card), "mesh2d card: the ranks' packed rings differ")
    out = {"phase": "mesh2d_card_equals_cpu", "ranks": world,
           "payload_shards": MESH2D_SHARDS,
           "capacity": cfg.log_capacity, "entries": card[0]["entries"],
           "device_ring": ENGINE_MESH_DEV_RING,
           "device_lines": len(card[0]["device_lines"]),
           "lines": card[0]["lines"], "flights": card[0]["flights"],
           "launches": {k: sum(res["launches"][k] for res in card)
                        for k in card[0]["launches"]},
           "card_wall_s": runs[str(dev)][1], "cpu_wall_s": runs["cpu"][1],
           "phase_s": time.perf_counter() - t_phase}
    emit(out)
    return out


KERNELS = [
    ("K1", "write_window_both", "raft_tpu_torch/csrc/ring.cu",
     "raft_tpu/core/ring_pallas.py:145"),
    ("K2", "steady_step", "raft_tpu_torch/csrc/steady.cu",
     "raft_tpu/core/step_pallas.py:404"),
    ("K3", "pipeline_flight", "raft_tpu_torch/csrc/steady.cu",
     "raft_tpu/core/step_pallas.py:1045"),
    ("K4", "turnover_flight", "raft_tpu_torch/csrc/steady.cu",
     "raft_tpu/core/step_pallas.py:1189"),
]
#: the EC path's kernels: K6 (both uses), K7, and K2-K4's parity mode
EC_KERNELS = [
    ("K6 encode", "encode_device", "raft_tpu_torch/csrc/ec.cu",
     "raft_tpu/ec/kernels.py:77"),
    ("K6 decode", "decode_device", "raft_tpu_torch/csrc/ec.cu",
     "raft_tpu/ec/kernels.py:240"),
    ("K7", "encode_fold_device", "raft_tpu_torch/csrc/ec.cu",
     "raft_tpu/ec/kernels.py:161"),
    ("K2·ec", "steady_step (in-kernel parity)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:93"),
    ("K3·ec", "pipeline_flight (in-kernel parity)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:766"),
    ("K4·ec", "turnover_flight (in-kernel parity)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:1152"),
]


#: the replica mesh's kernels: the mesh-local mode of K2, K3 and K4
MESH_KERNELS = [
    ("K2·mesh", "steady_step (mesh-local)", "raft_tpu_torch/csrc/steady.cu",
     "raft_tpu/core/step_pallas.py:217"),
    ("K3·mesh", "pipeline_flight (mesh-local)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:751"),
    ("K4·mesh", "turnover_flight (mesh-local)",
     "raft_tpu_torch/csrc/steady.cu", "raft_tpu/core/step_pallas.py:1155"),
]


#: config 4's two programs (``phase_config4_main_path``)
C4_PROGRAMS = ("steady_flights", "repair_capable_ticks")
#: what each row's library_ms times (None: no library call computes it)
LIBRARY_IS = {
    "K1": "write-only yardstick: index_copy_ of the window rows and of "
          "the window terms (all rows accepting, no conflict to check)",
    "K4": "index_copy_ of the T*B = C window rows and fill_ of the term "
          "ring",
    "K4 lapped": "index_copy_ of the last lap's C window rows (the ones "
                 "that reach the ring) and fill_ of the term ring",
    "K4·mesh": "index_copy_ of the T*B = C window rows and fill_ of the "
               "term row",
    "K5": "write-only yardstick: one index_copy_ of every group's window "
          "rows over the flattened (group, slot) rows, all lanes selected",
    "K7": "copy yardstick: one strided copy_ of the data words into the "
          "folded layout's systematic columns (no parity computed)",
    "K2": "none: no single PyTorch call computes it (a ring merge, then a "
          "quorum commit behind the term floor, in one step)",
    "K3": "none: no single PyTorch call computes it (T dependent steps: "
          "each step's accept set follows from the last)",
    "K2·ec": "none: PyTorch has no GF(2^8) arithmetic, and K2 has no call",
    "K3·ec": "none: PyTorch has no GF(2^8) arithmetic, and K3 has no call",
    "K4·ec": "none: PyTorch has no GF(2^8) arithmetic for the parity lanes",
    "K6 encode": "none: PyTorch has no GF(2^8) matrix product",
    "K6 decode": "none: PyTorch has no GF(2^8) matrix product",
    "K2·mesh": "none: no single PyTorch call computes it (as K2)",
    "K3·mesh": "none: no single PyTorch call computes it (as K3)",
}



# ---------------------------------- 5f. the host RS codec (ROADMAP A12)
#: one sealed segment of the north star's tier: C/2 = 16 384 entries of
#: 256 bytes (4 MiB) at the default file code RS(6,4)
NATIVE_SEGMENT_BYTES = 16384 * 256
NATIVE_CODE = (6, 4)


def host_cpu_name():
    """The host CPU as ``/proc/cpuinfo`` names it: its ``model name``, or
    where that is missing or "unknown" the identifying fields it does have
    (vendor, family, model, clock; implementer and part on Arm), with the
    number of processors."""
    fields, procs = {}, 0
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, val = line.partition(":")
                key, val = key.strip(), val.strip()
                if key == "processor":
                    procs += 1
                elif val and key not in fields:
                    fields[key] = val
    except OSError:
        return "unknown (/proc/cpuinfo unreadable)"
    if fields.get("model name", "unknown") != "unknown":
        name = fields["model name"]
    else:
        keys = ("vendor_id", "cpu family", "model", "cpu MHz",
                "CPU implementer", "CPU architecture", "CPU part")
        name = ", ".join(f"{k} {fields[k]}" for k in keys if k in fields) \
            or "unnamed"
    return f"{name} ({procs} processors)"


def phase_native_codec(card_line):
    """The port's C++ host codec (``raft_tpu_torch.native``, built with
    ``g++`` here; a missing compiler fails the phase) on one 4 MiB segment
    at RS(6,4): ``encode_host`` equal to the NumPy oracle's ``encode``,
    ``decode_host`` giving the segment back from every 4-of-6 row set,
    and the oracle's ``decode`` equal on a set missing two data rows.
    Prints host ms of encode and decode against the oracle's, with the
    host CPU beside the card."""
    import itertools

    from raft_tpu_torch import native
    from raft_tpu_torch.ec.rs import RSCode

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 90)
    flat = rng.integers(0, 256, NATIVE_SEGMENT_BYTES, dtype=np.uint8)
    code = RSCode(*NATIVE_CODE)
    shards = code.encode_host(flat)
    check(np.array_equal(shards, code.encode(flat)),
          "native_codec: encode_host differs from the NumPy oracle")
    sets = list(itertools.combinations(range(code.n), code.k))
    for rows in sets:
        check(np.array_equal(code.decode_host(shards[list(rows)], rows),
                             flat),
              f"native_codec: decode_host from rows {rows} differs")
    rows = (1, 3, 4, 5)
    check(np.array_equal(code.decode(shards[list(rows)], rows), flat),
          "native_codec: the oracle's decode differs")

    def ms(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    sub = shards[list(rows)]
    times = {
        "encode_host_ms": ms(lambda: code.encode_host(flat), 9),
        "decode_host_ms": ms(lambda: code.decode_host(sub, rows), 9),
        "encode_oracle_ms": ms(lambda: code.encode(flat), 3),
        "decode_oracle_ms": ms(lambda: code.decode(sub, rows), 3),
    }
    mb = NATIVE_SEGMENT_BYTES / 2**20
    emit({"phase": "native_codec", "code": list(NATIVE_CODE),
          "segment_bytes": NATIVE_SEGMENT_BYTES, "row_sets": len(sets),
          "equal": True, "build_s": build_s, "library": str(native.lib_path()),
          **times,
          "encode_host_MiB_per_s": mb / times["encode_host_ms"] * 1e3,
          "decode_host_MiB_per_s": mb / times["decode_host_ms"] * 1e3,
          "host_cpu": host_cpu_name(), "card": card_line,
          "method": "host clock, median of 9 calls (oracle: of 3)",
          "phase_s": time.perf_counter() - t_phase})
    print(f"host CPU: {host_cpu_name()}", flush=True)
    return times


# ------------------------- 5g. the tiered archive through the engine (A13)
TIER_LAPS = 16                # 524 288 entries through the north star
TIER_PIPELINED_LAP = 7        # the lap that goes as one submit_pipelined ring
TIER_DEAD_LAPS = 3            # laps a follower misses in the second run
TIER_SMALL_CAPACITY = 4096    # the card-vs-CPU run's ring


def tier_config(capacity, tier_dir, **over):
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=256, batch_size=1024,
                      log_capacity=capacity, transport="single",
                      tiered_log_dir=tier_dir, **over)


class fly_on_cpu:
    """Open the engine's flight gate while ``where`` is the CPU, so a run
    there flies the same chunks as on the card."""

    def __init__(self, where):
        self.cpu = str(where) == "cpu"

    def __enter__(self):
        import raft_tpu_torch.raft.engine as engine_mod

        self.hook = engine_mod._pipeline_backend_ok
        if self.cpu:
            engine_mod._pipeline_backend_ok = lambda *a: True
        return self

    def __exit__(self, *exc):
        import raft_tpu_torch.raft.engine as engine_mod

        engine_mod._pipeline_backend_ok = self.hook


def counted_fetches(e):
    """Wrap ``e._fetch`` with a counter; returns the counter."""
    n = [0]
    orig = e._fetch

    def fetch(x):
        n[0] += 1
        return orig(x)

    e._fetch = fetch
    return n


def tier_files(store):
    """SHA-256 of every file of a tiered store's directory, by name."""
    root = Path(store.root)
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.iterdir()) if p.is_file()}


def tier_engine_run(cfg, dev, laps=TIER_LAPS, replay=True):
    """``engine_tiered_path``'s schedule at ``cfg`` on ``dev``: an
    election, then ``laps`` ring laps of entries, each lap in bursts of C
    drained by ``run_for`` (leader ticks) except lap
    ``TIER_PIPELINED_LAP``, which goes as one ``submit_pipelined`` ring
    (one flight); every lap's window read back. With ``replay`` a
    ``register_apply(replay=True)`` from index 1 must hash to the input.
    Returns (recorded values, what runs are compared on, the engine)."""
    import torch

    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, C = cfg.batch_size, cfg.log_capacity
    hb = cfg.heartbeat_period
    tr = SingleDeviceTransport(cfg, device=dev)
    flights = []
    run_flight = tr.replicate_pipeline

    def counted_flight(*a, **k):
        flights.append(int(a[2].shape[0]))
        return run_flight(*a, **k)

    tr.replicate_pipeline = counted_flight
    lines = []
    e = RaftEngine(cfg, tr, trace=lines.append)
    fetches = counted_fetches(e)
    inp = EngineInput(cfg)
    tiered = e._tiered_store is not None
    what = f"tier {'on' if tiered else 'off'} C={C} on {dev}"
    reads = []
    e.run_until_leader()
    sync()
    t0 = time.perf_counter()
    for lap in range(laps):
        lo = e.commit_watermark + 1
        if lap == TIER_PIPELINED_LAP:
            e.submit_pipelined(inp.take(C))
            check(flights == [C // B],
                  f"{what}: the pipeline gate did not admit the ring")
        else:
            seqs = [e.submit(p) for p in inp.take(C)]
            e.run_for((C // B + 2) * hb)
            check(e.is_durable(seqs[-1]), f"{what}: lap {lap} did not drain")
        reads.append(engine_read_back(e, inp, lo, e.commit_watermark,
                                      f"{what} lap {lap}"))
    sync()
    wall = time.perf_counter() - t0
    total = laps * C
    check(e.commit_watermark == total, f"{what}: commit {e.commit_watermark}")
    res = {"capacity": C, "device": str(dev), "tiered": tiered,
           "entries": total, "wall_s": wall,
           "entries_per_s_wall": total / wall,
           "leader_ticks": e._tick_count, "fetches": fetches[0],
           "method": "host clock around the laps (submits, run_for, the "
                     "flight and every lap's read-back), synchronized"}
    if tiered:
        st = e._tiered_store
        snap = e._status_snapshot()
        check("tiered" in snap, f"{what}: no tiered section in /status")
        sealed = st.stats["segments_sealed"]
        want = (total - st.hot_entries) // st.segment_entries
        check(sealed == want, f"{what}: {sealed} segments sealed, want {want}")
        files = tier_files(st)
        res.update({
            "segments_sealed": sealed,
            "segment_entries": st.segment_entries,
            "hot_entries": st.hot_entries,
            "shard_files_bytes": sum(p.stat().st_size for p in
                                     Path(st.root).iterdir()),
            "shard_files": len(files),
            "seal_ms": st.seal_wall_s / max(sealed, 1) * 1e3,
            "seal_method": "host clock inside TieredStore._seal_range "
                           "(encode_host and the shard writes), per "
                           "segment",
            "host_bytes": st.host_bytes(),
            "status_tiered": {k: v for k, v in snap["tiered"].items()
                              if k != "seal_wall_s"}})
    if replay:
        h = hashlib.sha256()
        n = [0]

        def apply(idx, payload):
            check(idx == n[0] + 1, f"{what}: the replay skipped an index")
            n[0] = idx
            h.update(payload)

        t1 = time.perf_counter()
        start = e.register_apply(apply, replay=True)
        replay_s = time.perf_counter() - t1
        check(start == 1 and n[0] == total,
              f"{what}: replay started at {start}, reached {n[0]}")
        check(h.hexdigest() == inp.h.hexdigest(),
              f"{what}: the replay differs from the input")
        res.update({"replay_s": replay_s,
                    "replay_entries_per_s": total / replay_s,
                    "replay_sha256": h.hexdigest()})
    keep = {"lines": lines, "commit_time": dict(e.commit_time),
            "state": host_leaves(e.state), "reads": reads}
    if tiered:
        keep["files"] = tier_files(e._tiered_store)
    return res, keep, e


def tier_dead_follower_run(cfg, dev, tmp):
    """The second run: ``tiered_hot_entries`` C/2 and ``segment_entries``
    C/4; a follower dead for ``TIER_DEAD_LAPS`` laps, then recovered: the
    snapshot stream serves it from the sealed tier (``segment_loads``
    rises) and its ring window must equal the input. Then one segment
    loses a data shard to a bit flip and another to deletion and must
    still read back exactly; then ``save_checkpoint`` and ``restore``
    with the tier, and the restored cluster commits more."""
    import os

    import torch

    from raft_tpu_torch.core.state import log_entries
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, C = cfg.batch_size, cfg.log_capacity
    hb = cfg.heartbeat_period
    tr = SingleDeviceTransport(cfg, device=dev)
    e = RaftEngine(cfg, tr)
    st = e._tiered_store
    inp = EngineInput(cfg)
    lead = e.run_until_leader()
    dead = (lead + 1) % cfg.rows
    e.fail(dead)
    for _ in range(TIER_DEAD_LAPS):
        seqs = [e.submit(p) for p in inp.take(C)]
        e.run_for((C // B + 2) * hb)
        check(e.is_durable(seqs[-1]), "tier dead follower: a lap stuck")
    wm = e.commit_watermark
    loads0 = st.stats["segment_loads"]
    sync()
    t0 = time.perf_counter()
    e.recover(dead)
    ticks0 = e._tick_count
    while int(e._fetch(e.state.match_index)[dead]) < wm:
        check(e._tick_count - ticks0 < 400,
              "tier dead follower: the stream did not catch up")
        e.run_for(hb)
    sync()
    rejoin_s = time.perf_counter() - t0
    check(st.stats["segment_loads"] > loads0,
          "tier dead follower: the stream read no segment")
    lo = wm - C + 1
    got = log_entries(e.state, dead, lo, wm).tobytes()
    check(got == inp.window(lo, wm),
          "tier dead follower: the rejoined ring window differs")
    res = {"capacity": C, "hot_entries": st.hot_entries,
           "segment_entries": st.segment_entries, "dead_laps":
           TIER_DEAD_LAPS, "committed": wm,
           "segment_loads": st.stats["segment_loads"] - loads0,
           "snapshot_chunks": e._shipper.chunks_total,
           "rejoin_ticks": e._tick_count - ticks0, "rejoin_s": rejoin_s}
    # one segment: a data shard bit-flipped, another deleted
    slo, shi = st._sealed[1]
    name = st.io.name(slo, shi)
    p0 = st.io.shard_path(name, 0)
    blob = bytearray(open(p0, "rb").read())
    blob[len(blob) // 3] ^= 0x10
    open(p0, "wb").write(bytes(blob))
    os.unlink(st.io.shard_path(name, 2))
    st._cache.clear()
    st._cache_order.clear()
    rec0 = st.stats["segment_reconstructs"]
    back = b"".join(st.get(i)[0] for i in range(slo, shi + 1))
    check(back == inp.window(slo, shi),
          "tier: the damaged segment did not read back exactly")
    check(st.stats["segment_reconstructs"] == rec0 + 1,
          "tier: the damaged segment did not go through the decode")
    res["damaged_segment"] = {"lo": slo, "hi": shi, "flipped": 0,
                              "deleted": 2, "reconstructed": True}
    # checkpoint and restore with the tier
    path = str(Path(tmp) / "tier_ckpt.npz")
    t0 = time.perf_counter()
    e.save_checkpoint(path)
    t1 = time.perf_counter()
    e2 = RaftEngine.restore(cfg, path, SingleDeviceTransport(cfg, device=dev))
    t2 = time.perf_counter()
    check(e2.commit_watermark == wm and e2._tiered_store is not None
          and e2.store.root != st.root,
          "tier restore: watermark or archive directory wrong")
    check(e2.store.get(wm)[0] == inp.window(wm, wm),
          "tier restore: the last committed entry differs")
    e2.run_until_leader()
    seqs = [e2.submit(p) for p in inp.take(B)]
    e2.run_until_committed(seqs[-1])
    check("tiered" in e2._status_snapshot(), "tier restore: no /status tier")
    res["restore"] = {"save_s": t1 - t0, "restore_s": t2 - t1,
                      "committed_after": e2.commit_watermark}
    return res


def phase_engine_tiered_path(dev):
    """The tiered archive through ``RaftEngine`` on the card (module doc,
    5g): the north star with ``tiered_log_dir`` (524 288 entries, 16 ring
    laps, segments of C/2 sealed behind the 2C hot tail), replayed from
    index 1; the same run with the tier off (equal ``_fetch`` counts);
    the dead-follower run with a damaged segment, a checkpoint and a
    restore; and the card against the CPU at C = 4 096 (nodelog lines,
    state leaves, read-backs and shard files equal). The shard files are
    deleted after the phase."""
    import shutil
    import tempfile

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tier_")
    res = {"phase": "engine_tiered_path"}
    try:
        zero_counters(dev)
        C = STEPS_PER_FLIGHT * 1024
        on, on_keep, e = tier_engine_run(tier_config(C, tmp), dev)
        res["launches"] = read_counters(dev)
        del e
        off, off_keep, e = tier_engine_run(tier_config(C, None), dev,
                                           replay=False)
        del e
        check(on["fetches"] == off["fetches"],
              f"tier on vs off: {on['fetches']} vs {off['fetches']} fetches")
        check(on_keep["lines"] == off_keep["lines"]
              and on_keep["reads"] == off_keep["reads"],
              "tier on vs off: nodelog lines or read-backs differ")
        res["tier_on"], res["tier_off"] = on, off
        for k in ("K1", "K2", "K3", "K4"):
            check(res["launches"][k] > 0, f"engine_tiered_path: {k} never "
                                          "launched")
        zero_counters(dev)
        res["dead_follower"] = tier_dead_follower_run(
            tier_config(C, tmp, tiered_hot_entries=C // 2,
                        segment_entries=C // 4), dev, tmp)
        dl = read_counters(dev)
        res["launches"] = {k: res["launches"][k] + dl[k]
                           for k in res["launches"]}
        zero_counters(dev)
        small = {}
        walls = {}
        for where in (dev, "cpu"):
            with fly_on_cpu(where):
                t0 = time.perf_counter()
                small[str(where)] = tier_engine_run(
                    tier_config(TIER_SMALL_CAPACITY, tmp), where)
                walls[str(where)] = time.perf_counter() - t0
            if where == dev:
                res["card_equals_cpu_launches"] = read_counters(dev)
        (_, ck, _), (_, hk, _) = small[str(dev)], small["cpu"]
        for k in ck:
            if k == "state":
                for f in ck[k]:
                    check(np.array_equal(ck[k][f], hk[k][f]),
                          f"tier card vs CPU: state.{f} differs")
            else:
                check(ck[k] == hk[k], f"tier card vs CPU: {k} differs")
        res["card_equals_cpu"] = {
            "capacity": TIER_SMALL_CAPACITY, "equal": sorted(ck),
            "shard_files": len(ck["files"]), "walls_s": walls,
            "segments_sealed": small[str(dev)][0]["segments_sealed"]}
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# --------------------- 5h. the device event ring through the engine (A13)
DEV_OBS_CAPACITY = 4096
DEV_OBS_LAP_CAPACITY = 64
DEV_OBS_PROFILED_BURST = 2


def host_twin_lines(lines):
    """The host trace lines the device ring also records: election wins
    and commit advances."""
    return [ln for ln in lines if ln.endswith("]state changed to leader")
            or "]commit index changed to " in ln]


def dev_obs_engine_run(cfg, dev, capacity, plan=OBS_PLAN, profile=False,
                       defer_flush=False):
    """``engine_obs_path``'s schedule (an election; ``plan["bursts"]``
    bursts drained by ``run_for``; one ``submit_pipelined`` ring; idle
    heartbeats; the leader failed, a re-election and ``plan["after"]``
    more) with the device plane attached at ``capacity`` (None:
    detached), a trace and a metrics registry (the host tallies) in
    either case. ``defer_flush`` holds every flush until the end (one
    flush: the ring laps in between). ``profile`` runs burst
    ``DEV_OBS_PROFILED_BURST`` under torch.profiler. Returns (recorded
    values, what runs are compared on, the DeviceObs)."""
    import torch

    from raft_tpu_torch.obs.registry import MetricsRegistry
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    cuda = torch.device(dev).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    B, C = cfg.batch_size, cfg.log_capacity
    hb = cfg.heartbeat_period
    tr = SingleDeviceTransport(cfg, device=dev)
    flights = []
    run_flight = tr.replicate_pipeline

    def counted_flight(*a, **k):
        flights.append(int(a[2].shape[0]))
        return run_flight(*a, **k)

    tr.replicate_pipeline = counted_flight
    lines = []
    e = RaftEngine(cfg, tr, trace=lines.append)
    e.metrics = MetricsRegistry()
    fetches = counted_fetches(e)
    dobs = None
    flushes = [0]
    if capacity is not None:
        dobs = e.attach_device_obs(capacity=capacity)
        flush = e._flush_device_obs

        def counted_flush():
            flushes[0] += 1
            if not defer_flush:
                flush()

        e._flush_device_obs = counted_flush
    inp = EngineInput(cfg)
    h_apply = hashlib.sha256()
    e.register_apply(lambda i, p: h_apply.update(p))
    what = (f"device obs {capacity} fuse_k={e.fuse_k} C={C} on {dev}")
    res = {"capacity": capacity, "fuse_k": e.fuse_k, "log_capacity": C,
           "device": str(dev)}
    reads = []
    e.run_until_leader()
    burst_wall, burst_ticks = 0.0, 0
    for b in range(plan["bursts"]):
        seqs = [e.submit(p) for p in inp.take(plan["burst"])]
        drain = (plan["burst"] // B + 2) * hb
        t0n = e._tick_count
        sync()
        t0 = time.perf_counter()
        if profile and b == DEV_OBS_PROFILED_BURST:
            events, pwall = _device_events(lambda: e.run_for(drain), 1)
            lt = e._tick_count - t0n
            kern = [n for n, _ in events
                    if "emcpy" not in n and "emset" not in n]
            res["profiled_burst"] = {
                "leader_ticks": lt, "device_ops": len(events),
                "device_ops_per_leader_tick": len(events) / lt,
                "kernels_per_leader_tick": len(kern) / lt,
                "device_busy_ms": sum(us for _, us in events) / 1e3,
                "wall_ms": pwall * 1e3}
        else:
            e.run_for(drain)
            sync()
            burst_wall += time.perf_counter() - t0
            burst_ticks += e._tick_count - t0n
        check(e.is_durable(seqs[-1]), f"{what}: burst {b} did not drain")
    reads.append(engine_read_back(e, inp, max(1, e.commit_watermark - C + 1),
                                  e.commit_watermark, f"{what} ticks"))
    leader_last = e.commit_watermark
    e.submit_pipelined(inp.take(C))
    check(flights == [C // B],
          f"{what}: the pipeline gate did not admit the ring: {flights}")
    reads.append(engine_read_back(e, inp, leader_last + 1,
                                  e.commit_watermark, f"{what} flight"))
    e.run_for(4 * hb)            # followers learn the final commit
    old = e.leader_id
    e.fail(old)
    e.run_until_leader()
    lo = e.commit_watermark + 1
    seqs = [e.submit(p) for p in inp.take(plan["after"])]
    e.run_for((plan["after"] // B + 4) * hb)
    check(e.is_durable(seqs[-1]),
          f"{what}: the entries after the failover did not commit")
    reads.append(engine_read_back(e, inp, lo, e.commit_watermark,
                                  f"{what} after failover"))
    sync()
    if defer_flush:
        e._flush_device_obs = flush
        flush()
    total = plan["bursts"] * plan["burst"] + C + plan["after"]
    check(e.commit_watermark == total and
          h_apply.hexdigest() == inp.h.hexdigest(),
          f"{what}: commit {e.commit_watermark} of {total}, or the apply "
          "stream differs")
    snap = e.metrics.snapshot()

    def tally(name):
        series = snap.get(name, {}).get("series", [])
        return int(sum(s["value"] for s in series))

    res.update({
        "leader_ticks": e._tick_count, "leader_ticks_in_bursts": burst_ticks,
        "ms_per_leader_tick": burst_wall / max(burst_ticks, 1) * 1e3,
        "ms_method": "host clock around each burst's run_for, "
                     "synchronized (the profiled burst left out)",
        "fused_launches": e.fused_launches, "fetches": fetches[0],
        "flushes": flushes[0], "flights": len(flights),
        "host_tallies": {
            "elections": tally("raft_elections_total"),
            "commits": tally("raft_commits_total"),
            "heartbeat_ticks": tally("raft_heartbeat_ticks_total")}})
    if dobs is not None:
        res["device"] = {"total": dobs.total_recorded,
                         "dropped": dobs.dropped, "laps": dobs.laps,
                         "events": len(dobs.events),
                         "counters": {k: v.get("0", 0) for k, v in
                                      dobs.counters.items()}}
    keep = {"lines": lines, "commit_time": dict(e.commit_time),
            "terms": e.terms.tolist(), "roles": list(e.roles),
            "state": host_leaves(e.state), "reads": reads}
    if dobs is not None:
        from raft_tpu_torch.obs.device import packed_flush

        keep["packed"] = packed_flush(e._dev_ring).cpu().numpy().tolist()
        keep["events"] = [ev.to_jsonable() for ev in dobs.events]
    return res, keep, dobs


def phase_engine_device_obs_path(dev):
    """The device event ring through ``RaftEngine`` on the card (module
    doc, 5h): the recorded K-tick graph against the uncaptured recorded
    loop (``fused_graph_vs_loop(record=True)``); the north star at
    ``fuse_k`` 1 and 8, detached and with ``attach_device_obs(4096)``:
    every state leaf, read-back, nodelog line and launch count equal, the
    decoded ``elect``/``commit`` lines equal to the trace's, the device
    counters equal to the host tallies, and exactly one fetch more per
    launch boundary; at capacity 64 with the flushes held to the end,
    ``dropped`` = total - 64 and the survivors equal to the 4096 run's
    last 64 records; and the card against the CPU at C = 4 096 (packed
    ring and decoded events equal)."""
    import torch

    from raft_tpu_torch.obs.device import decode_records

    t_phase = time.perf_counter()
    C = STEPS_PER_FLIGHT * 1024
    res = {"phase": "engine_device_obs_path"}
    res["graph_vs_loop"] = fused_graph_vs_loop(fused_config(C, 1), dev,
                                               record=True)
    runs = {}
    launches = {}
    for k in (1, 8):
        cfg = fused_config(C, k)
        for mode, cap in (("detached", None), ("attached", DEV_OBS_CAPACITY)):
            zero_counters(dev)
            runs[(k, mode)] = dev_obs_engine_run(cfg, dev, cap, profile=True)
            launches[(k, mode)] = read_counters(dev)
        (det, dk, _), (att, ak, dobs) = runs[(k, "detached")], \
            runs[(k, "attached")]
        what = f"device obs fuse_k={k}"
        for key in ("lines", "commit_time", "terms", "roles", "reads"):
            check(dk[key] == ak[key], f"{what}: {key} differ attached")
        for f in dk["state"]:
            check(np.array_equal(dk["state"][f], ak["state"][f]),
                  f"{what}: state.{f} differs attached")
        check(launches[(k, "detached")] == launches[(k, "attached")],
              f"{what}: launch counts differ attached: "
              f"{launches[(k, 'detached')]} vs {launches[(k, 'attached')]}")
        check(att["fetches"] == det["fetches"] + att["flushes"],
              f"{what}: {att['fetches']} fetches attached, "
              f"{det['fetches']} detached, {att['flushes']} flushes")
        check(dobs.nodelog_lines() == host_twin_lines(ak["lines"]),
              f"{what}: the decoded elect/commit lines differ from the "
              "trace's")
        cnt, tl = att["device"]["counters"], att["host_tallies"]
        chunk_steps = C // 1024
        check(cnt["raft_device_elections_total"] == tl["elections"]
              and cnt["raft_device_commits_total"] == tl["commits"]
              and cnt["raft_device_heartbeat_ticks_total"]
              == tl["heartbeat_ticks"] + chunk_steps,
              f"{what}: device counters {cnt} vs host tallies {tl}")
        check(att["device"]["dropped"] == 0, f"{what}: records dropped")
        if k > 1:
            check(att["fused_launches"] > 0, f"{what}: no fused launch")
        res[f"fuse_k_{k}"] = {
            "detached": det, "attached": att,
            "ms_per_leader_tick": {"detached": det["ms_per_leader_tick"],
                                   "attached": att["ms_per_leader_tick"]},
            "device_ops_per_leader_tick": {
                m: r["profiled_burst"]["device_ops_per_leader_tick"]
                for m, r in (("detached", det), ("attached", att))},
            "launches": launches[(k, "attached")]}
    res["launches"] = {key: launches[(1, "attached")][key]
                       + launches[(8, "attached")][key]
                       for key in launches[(1, "attached")]}
    # laps: capacity 64, every flush held to the end
    zero_counters(dev)
    lap, lap_keep, lap_obs = dev_obs_engine_run(
        fused_config(C, 8), dev, DEV_OBS_LAP_CAPACITY, defer_flush=True)
    lap_launches = read_counters(dev)
    full_keep = runs[(8, "attached")][1]
    total = lap["device"]["total"]
    check(total == runs[(8, "attached")][0]["device"]["total"],
          "capacity 64: a different number of records")
    check(lap["device"]["dropped"] == total - DEV_OBS_LAP_CAPACITY
          and lap["device"]["events"] == DEV_OBS_LAP_CAPACITY,
          f"capacity 64: dropped {lap['device']['dropped']} of {total}")
    strip = [{k: v for k, v in ev.items() if k != "t_virtual"}
             for ev in full_keep["events"][-DEV_OBS_LAP_CAPACITY:]]
    check([{k: v for k, v in ev.items() if k != "t_virtual"}
           for ev in lap_keep["events"]] == strip,
          "capacity 64: the surviving records differ from the full ring's")
    survivors = decode_records(np.asarray(lap_keep["packed"], np.int32),
                               0)[0]
    check(len(survivors) == DEV_OBS_LAP_CAPACITY,
          "capacity 64: the packed ring does not decode")
    res["laps"] = {"capacity": DEV_OBS_LAP_CAPACITY, "total": total,
                   "dropped": lap["device"]["dropped"],
                   "laps": lap["device"]["laps"], "survivors_equal": True,
                   "flushes_held": lap["flushes"]}
    res["launches"] = {key: res["launches"][key] + lap_launches[key]
                       for key in res["launches"]}
    # card vs CPU at C = 4 096, fuse_k 8, attached
    zero_counters(dev)
    small = {}
    walls = {}
    for where in (dev, "cpu"):
        with fly_on_cpu(where):
            t0 = time.perf_counter()
            small[str(where)] = dev_obs_engine_run(
                fused_config(OBS_SMALL_CAPACITY, 8), where, DEV_OBS_CAPACITY)
            walls[str(where)] = time.perf_counter() - t0
        if where == dev:
            res["card_equals_cpu_launches"] = read_counters(dev)
    ck, hk = small[str(dev)][1], small["cpu"][1]
    for key in ck:
        if key == "state":
            for f in ck[key]:
                check(np.array_equal(ck[key][f], hk[key][f]),
                      f"device obs card vs CPU: state.{f} differs")
        else:
            check(ck[key] == hk[key], f"device obs card vs CPU: {key} "
                                      "differs")
    res["card_equals_cpu"] = {"capacity": OBS_SMALL_CAPACITY, "fuse_k": 8,
                              "equal": sorted(ck), "walls_s": walls,
                              "records": small[str(dev)][0]["device"]}
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ------------------------------------- the compile, memory and capture planes
PLANES_BURST = 8192        # entries a burst: one fused window of 8 ticks
PLANES_WARM = 2            # warm-up bursts before the freeze
PLANES_STEADY = 8          # at least this many fused windows, frozen
PLANES_NEUTRAL = 4         # bursts a neutrality run
PLANES_CENSUSES = 5
PLANES_WATCHDOG_S = 300    # the phase's stacks are dumped past this
PLANES_SPAN_EVERY = 256    # a span on one submit in this many (capture)


def planes_engine(cfg, dev, lines=None):
    """A north-star ``RaftEngine`` on a fresh transport whose ``_fetch``
    calls are counted (``e.fetches``)."""
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device=dev),
                   trace=None if lines is None else lines.append)
    e.fetches = 0
    fetch = e._fetch

    def counted(x):
        e.fetches += 1
        return fetch(x)

    e._fetch = counted
    return e


def planes_burst(e, inp, spans=None):
    """Submit one burst (one submit in ``PLANES_SPAN_EVERY`` in a span of
    its own when ``spans`` is given) and drain it; returns the leader
    ticks it took."""
    B, hb = e.cfg.batch_size, e.cfg.heartbeat_period
    t0 = e._tick_count
    seqs = []
    for i, p in enumerate(inp.take(PLANES_BURST)):
        traced = spans is not None and i % PLANES_SPAN_EVERY == 0
        if traced:
            spans.current = spans.begin("write", e.clock.now)
        seqs.append(e.submit(p))
        if traced:
            spans.current = None
    e.run_for((PLANES_BURST // B + 2) * hb)
    check(e.is_durable(seqs[-1]), "a planes burst did not drain")
    return e._tick_count - t0


def fused_noop(e, state, staging):
    """One fused launch of ``e``'s transport over ``staging`` with every
    tick masked (``halted0``): the bit-exact no-op, so the engine stays
    coherent."""
    import torch

    r = e.leader_id
    return e.t.replicate_fused(
        state, staging, 0, torch.zeros(e.fuse_k, dtype=torch.int32), 2,
        True, r, int(e.lead_terms[r]), e.alive, e.slow)


def planes_neutral_run(cfg, dev, attached):
    """The neutrality schedule (an election, ``PLANES_NEUTRAL`` bursts,
    idle heartbeats) on a fresh engine, detached or with the compile
    watch (frozen after the first burst) and the memory watch (a census
    after every burst) attached. Returns what the two must agree on and
    the host ms per leader tick."""
    import torch

    from raft_tpu_torch.obs.compile import CompileWatch, RetraceSentinel
    from raft_tpu_torch.obs.memory import MemoryWatch

    sync = (torch.cuda.synchronize if torch.device(dev).type == "cuda"
            else (lambda: None))
    lines = []
    e = planes_engine(cfg, dev, lines)
    inp = EngineInput(cfg)
    watch = mem = None
    if attached:
        watch = CompileWatch().install()
        sentinel = RetraceSentinel(watch)
        mem = MemoryWatch()
        mem.watch_engine(e)
        mem.census()
    try:
        e.run_until_leader()
        ticks, wall, census_s = 0, 0.0, 0.0
        for b in range(PLANES_NEUTRAL):
            sync()
            t0 = time.perf_counter()
            lt = planes_burst(e, inp)
            if mem is not None:
                t1 = time.perf_counter()
                mem.census()
                if b:
                    census_s += time.perf_counter() - t1
            sync()
            if b:
                wall += time.perf_counter() - t0
                ticks += lt
            if watch is not None and not b:
                sentinel.freeze()
        e.run_for(20 * cfg.heartbeat_period)
    finally:
        if watch is not None:
            watch.uninstall()
    hi = e.commit_watermark
    check(hi == PLANES_NEUTRAL * PLANES_BURST, "neutrality run: commit "
          f"{hi} of {PLANES_NEUTRAL * PLANES_BURST}")
    return {
        "lines": lines, "state": host_leaves(e.state),
        "sha256": hashlib.sha256(
            e.committed_entries(max(1, hi - cfg.log_capacity + 1),
                                hi).tobytes()).hexdigest(),
        "input_sha256": hashlib.sha256(inp.window(
            max(1, hi - cfg.log_capacity + 1), hi)).hexdigest(),
        "fetches": e.fetches,
        "ms_per_leader_tick": wall / ticks * 1e3,
        "ms_per_leader_tick_without_census": (wall - census_s) / ticks * 1e3,
        "violations": (None if watch is None
                       else len(watch.sentinel.violations)),
    }


def planes_flight_seconds(cfg, dev, reps=7):
    """``obs.profiling.device_seconds`` of one K3 flight (32 saturated
    steps through ``replicate_pipeline`` from a fully committed ring, no
    turnover) beside the CUDA-event ms of the same call."""
    import torch

    from raft_tpu_torch.core.state import ReplicaState
    from raft_tpu_torch.obs import profiling
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    rng = np.random.default_rng(SEED + 181)
    tr = SingleDeviceTransport(cfg, device=dev)
    st0 = steady_state(cfg, dev, 4 * cfg.log_capacity, rng=rng)
    T, B = STEPS_PER_FLIGHT, cfg.batch_size
    wins = torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, (T, B, cfg.rows * cfg.shard_words),
        dtype=np.int64).astype(np.int32)).to(dev)
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    al = torch.ones(cfg.rows, dtype=torch.bool, device=dev)
    sl = torch.zeros(cfg.rows, dtype=torch.bool, device=dev)

    def mk():
        return (ReplicaState(**{f: getattr(st0, f).clone()
                                for f in st0.__dataclass_fields__}),)

    def fly(st):
        return tr.replicate_pipeline(st, wins, counts, 0, 1, al, sl,
                                     term_floor=1, allow_turnover=False)

    before = read_counters(dev)["K3_flights_run"]
    dev_s = profiling.device_seconds(fly, mk)
    box = {}
    ev_ms = _events_ms(lambda: fly(*box["a"]), reps,
                       before=lambda: box.update(a=mk()))
    ran = read_counters(dev)["K3_flights_run"] - before
    check(ran > 0, "the timed flights never ran K3")
    check(dev_s == dev_s and dev_s > 0,
          "device_seconds found no CUDA kernel in a K3 flight's trace")
    return {"device_seconds_ms": dev_s * 1e3, "cuda_event_ms": ev_ms,
            "k3_flights_run": ran, "steps": T, "batch": B}


def planes_capture(cfg, dev, tmpdir):
    """``capture_profile(0.5)`` from this thread while another, started
    before it, drives the engine through the capture window (one submit
    in ``PLANES_SPAN_EVERY`` in a span): the artifact must hold CUDA
    kernel events, K1's or K2's among them, and span events."""
    import threading

    from raft_tpu_torch.obs import SpanTracker, profiling

    e = planes_engine(cfg, dev)
    e.spans = spans = SpanTracker()
    inp = EngineInput(cfg)
    e.run_until_leader()
    planes_burst(e, inp, spans)          # captures the graphs first
    go, stop = threading.Event(), threading.Event()
    errors = []
    bursts = [0]

    def drive():
        try:
            go.wait(120)
            while not stop.is_set():
                planes_burst(e, inp, spans)
                bursts[0] += 1
                time.sleep(0.005)        # pace: bound the trace's volume
        except Exception as ex:          # surfaced on the main thread
            errors.append(ex)

    def window(seconds):
        # the engine thread (started before the capture) ticks for the
        # capture window only: the profiler's start and the trace's
        # export do not share the host with it
        go.set()
        time.sleep(seconds)
        stop.set()
        th.join(timeout=120)

    th = threading.Thread(target=drive, daemon=True)
    th.start()
    t0 = time.perf_counter()
    try:
        got = profiling.capture_profile(0.5, spans=spans,
                                        profile_dir=str(tmpdir),
                                        sleep=window)
    finally:
        go.set()
        stop.set()
        th.join(timeout=120)
    check(not errors, f"the engine thread failed: {errors}")
    art = json.loads(Path(got["artifact"]).read_text())
    kern = [ev["name"] for ev in art["traceEvents"]
            if ev.get("cat") == "kernel"]
    names = sorted({kernel_of(n) or "other" for n in kern})
    check(art["format"] == profiling.PROFILE_FORMAT,
          f"artifact format {art['format']!r}")
    check(kern, "the capture's artifact holds no CUDA kernel event")
    check(any(k in ("K1", "K2") for k in names),
          f"no K1 or K2 kernel in the capture: {names}")
    check(got["n_span_events"] > 0, "the capture's artifact holds no span")
    return {"seconds": 0.5, "bursts": bursts[0],
            "capture_wall_s": time.perf_counter() - t0,
            "n_device_events": got["n_device_events"],
            "n_kernel_events": got["n_kernel_events"],
            "n_launch_annotations": got["n_launch_annotations"],
            "n_span_events": got["n_span_events"],
            "all_threads": got["all_threads"],
            "kernels": {k: sum(1 for n in kern if (kernel_of(n) or "other")
                               == k) for k in names},
            "artifact_bytes": Path(got["artifact"]).stat().st_size}


def planes_serve_demo(dev):
    """``obs.serve.serve_demo`` on the card for about 3 s; ``/compile``,
    ``/memory`` and ``/profile?seconds=0.2`` must each answer 200."""
    import io
    import threading

    from raft_tpu_torch.obs.serve import serve_demo

    out = io.StringIO()
    box, errors = {}, []

    def run():
        try:
            box["res"] = serve_demo(port=0, groups=4, duration_s=3.0,
                                    out=out, device=dev)
        except Exception as ex:
            errors.append(ex)

    th = threading.Thread(target=run, daemon=True)
    th.start()
    t0 = time.perf_counter()
    while "127.0.0.1:" not in out.getvalue():
        check(not errors and time.perf_counter() - t0 < 120,
              f"serve_demo did not start: {errors}")
        time.sleep(0.02)
    port = int(out.getvalue().split("127.0.0.1:")[1].split(" ")[0])
    scr = Scraper(port)
    time.sleep(0.5)
    answers = {}
    for path in ("/compile", "/memory", "/profile?seconds=0.2"):
        t1 = time.perf_counter()
        st, body = scr.get(path)
        answers[path] = {"status": st, "ms": (time.perf_counter() - t1)
                         * 1e3, "bytes": len(body)}
        check(st == 200, f"serve_demo {path} answered {st}: {body[:200]}")
        if path == "/profile?seconds=0.2":
            answers[path]["n_kernel_events"] = json.loads(body)[
                "n_kernel_events"]
    th.join(timeout=120)
    check(not errors and "res" in box, f"serve_demo failed: {errors}")
    res = box["res"]
    check(res["violations"] == 0, "serve_demo: an audit violation")
    check(res["committed"] == res["submitted"],
          f"serve_demo committed {res['committed']} of {res['submitted']}")
    return {"result": res, "answers": answers}


def phase_obs_planes_path(dev, card_line):
    """The compile, memory and capture planes at the north star on the
    card (module doc, 7b)."""
    import gc
    import tempfile

    import torch

    from raft_tpu_torch.obs.compile import CompileWatch, RetraceSentinel
    from raft_tpu_torch.obs.memory import MemoryWatch, audit_donation
    from raft_tpu_torch.obs.registry import MetricsRegistry
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    import faulthandler

    t_phase = time.perf_counter()
    # a phase that hangs dumps every thread's stack and ends the run
    faulthandler.dump_traceback_later(PLANES_WATCHDOG_S, exit=True)

    shown = set()

    def step(name):
        # progress, with what the steps before it found
        new = {k: v for k, v in res.items() if k not in shown}
        shown.update(new)
        print(f"obs_planes_path: {name} at "
              f"{time.perf_counter() - t_phase:.1f} s "
              f"{json.dumps(new, default=str)}", flush=True)

    cfg = fused_config(STEPS_PER_FLIGHT * 1024, 8)
    res = {"phase": "obs_planes_path", "card": card_line, "fuse_k": 8,
           "capacity": cfg.log_capacity, "batch": cfg.batch_size}
    zero_counters(dev)
    # ---- compile plane: warm-up, freeze, steady windows
    reg = MetricsRegistry()
    watch = CompileWatch(registry=reg).install()
    sentinel = RetraceSentinel(watch)
    try:
        e = planes_engine(cfg, dev)
        inp = EngineInput(cfg)
        e.run_until_leader()
        for _ in range(PLANES_WARM):
            planes_burst(e, inp)
        # ---- memory plane: attribution and the baseline
        mem = MemoryWatch(registry=reg)
        mem.watch_engine(e)
        c = mem.census()
        state_bytes = sum(getattr(e.state, f).untyped_storage().nbytes()
                          for f in e.state.__dataclass_fields__)
        got = sum(b for k, (_, b) in c.by_label.items()
                  if k.startswith("engine.state."))
        check(got == state_bytes, f"engine.state.* census bytes {got} != "
                                  f"the state's leaf bytes {state_bytes}")
        mem.set_baseline()
        sentinel.freeze()
        step("steady windows")
        f0, graphs = e.fused_launches, e.t.graphs
        n_captures = graphs.captures if graphs is not None else 0
        bursts = 0
        while e.fused_launches - f0 < PLANES_STEADY:
            planes_burst(e, inp)
            bursts += 1
            check(bursts <= 4 * PLANES_STEADY, "too few fused windows")
        check(sentinel.violations == [], "steady windows: "
              + "; ".join(str(v) for v in sentinel.violations))
        captures = watch.events("single.fused", "compile")
        check(len(captures) == n_captures,
              f"{len(captures)} compile events on single.fused, "
              f"{n_captures} graph captures")
        drift = mem.drift()
        check(drift == [], f"census over the steady windows: {drift}")
        res["steady"] = {
            "fused_windows": e.fused_launches - f0, "bursts": bursts,
            "violations": 0, "graph_captures": n_captures,
            "compile_events_single_fused": len(captures),
            "programs": watch.by_program(), "census_flat": True}
        step("orphan")
        # the orphan: flagged, then flat again
        orphan = torch.zeros((123, 7), dtype=torch.float32, device=dev)
        drift = mem.drift()
        check(any("float32[123,7]" in ln for ln in drift),
              f"the orphan was not flagged: {drift}")
        del orphan
        check(mem.drift() == [], "not flat once the orphan went")
        res["orphan_drift"] = drift
        # ms per census (metadata only; no sync: set_sync_debug_mode)
        times = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(PLANES_CENSUSES):
                t0 = time.perf_counter()
                mem.census()
                times.append((time.perf_counter() - t0) * 1e3)
            win = e._fused_driver.staging
            e.state = fused_noop(e, e.state, win.buf)[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        res["census"] = {"ms": statistics.median(times), "all_ms": times,
                         "live_storages": mem.last.n_arrays,
                         "live_bytes": mem.last.total_bytes,
                         "allocator": mem.last.allocator,
                         "gc_objects": len(gc.get_objects()),
                         "sync_debug": "error mode raised nothing over "
                                       "the censuses and one labeled "
                                       "fused launch"}
        step("donation audit")
        # the in-place audit on one graph replay
        rep = audit_donation(lambda st, buf: fused_noop(e, st, buf),
                             (e.state, win.buf), donated=(0,), watch=mem)
        res["donation"] = dict(rep.__dict__)
        check(rep.engaged, f"donation audit on a graph replay: {rep}")
        # the S+1 staging drift trips the sentinel
        S, B, W = win.S, win.B, win.W
        n0 = len(sentinel.violations)
        drifted = torch.zeros((S + 1, B, W), dtype=torch.int32, device=dev)
        e.state = fused_noop(e, e.state, drifted)[0]
        new = sentinel.violations[n0:]
        traces = [v for v in new if v.event == "trace"]
        want = f"int32[{S + 1},{B},{W}]"
        check(len(traces) == 1 and traces[0].program == "single.fused"
              and want in (traces[0].arg_shapes or []),
              f"S+1 drift: {[str(v) for v in new]}")
        res["s_plus_1"] = {"violations": [str(v) for v in new],
                           "events": [v.event for v in new]}
        step("rebuild")
        # the rebuild pattern, frozen: save, restore onto a fresh
        # transport, drive the warm-up pattern again
        with tempfile.TemporaryDirectory() as tmp:
            ck = f"{tmp}/ck.npz"
            e.save_checkpoint(ck)
            torch.cuda.synchronize()
            c_old = mem.census(collect=True)
            n0 = len(sentinel.violations)
            a0 = torch.cuda.memory_allocated(dev)
            t0 = time.perf_counter()
            e2 = RaftEngine.restore(
                cfg, ck, transport=SingleDeviceTransport(cfg, device=dev))
            e2.run_until_leader()
            inp2 = EngineInput(cfg)
            for _ in range(PLANES_WARM):
                planes_burst(e2, inp2)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            a1 = torch.cuda.memory_allocated(dev)
            new = sentinel.violations[n0:]
            c_before = mem.census(collect=True)
            mem.watch_engine(e2)
            del e, graphs, win, drifted      # every reference to the old
            gc.collect()
            torch.cuda.synchronize()
            a2 = torch.cuda.memory_allocated(dev)
            c_after = mem.census(collect=True)
        res["rebuild"] = {
            "how": "save_checkpoint, RaftEngine.restore onto a fresh "
                   "SingleDeviceTransport, election, 2 bursts of 8192 "
                   "(sentinel frozen)",
            "captures": getattr(e2.t.graphs, "captures", 0),
            "capture_s": getattr(e2.t.graphs, "capture_s", 0.0),
            "wall_s": wall,
            "violations": len(new),
            "violations_by_event": {k: sum(1 for v in new if v.event == k)
                                    for k in ("trace", "compile")},
            "violation_programs": sorted({v.program for v in new}),
            "allocated_bytes_before_rebuild": a0,
            "allocated_bytes_both_engines": a1,
            "allocated_bytes_old_engine_collected": a2,
            "allocator_delta_bytes": a2 - a0,
            "unreachable_bytes_both": (c_before.allocator or {}).get(
                "cuda_unreachable_bytes"),
            "unreachable_bytes_after": (c_after.allocator or {}).get(
                "cuda_unreachable_bytes"),
            "census_bytes_old_engine": c_old.total_bytes,
            "census_bytes_new_engine": c_after.total_bytes,
            "buckets_changed": {
                k: [c_old.by_shape.get(k, (0, 0)), c_after.by_shape.get(
                    k, (0, 0))]
                for k in set(c_old.by_shape) | set(c_after.by_shape)
                if c_old.by_shape.get(k) != c_after.by_shape.get(k)},
            "reserved_bytes_after": torch.cuda.memory_reserved(dev)}
    finally:
        watch.uninstall()
    res["compile_snapshot"] = {k: v for k, v in watch.snapshot().items()
                               if k not in ("log", "sentinel")}
    # ---- neutrality: detached and attached in turns
    step("neutrality")
    runs = []
    for attached in (False, True, True, False):
        runs.append(planes_neutral_run(cfg, dev, attached))
    ref = runs[0]
    for r in runs[1:]:
        check(r["lines"] == ref["lines"], "neutrality: nodelog lines differ")
        for f in ref["state"]:
            check(np.array_equal(r["state"][f], ref["state"][f]),
                  f"neutrality: state.{f} differs")
        check(r["sha256"] == ref["sha256"] == ref["input_sha256"],
              "neutrality: read-back SHA-256 differs")
        check(r["fetches"] == ref["fetches"],
              f"neutrality: {r['fetches']} fetches vs {ref['fetches']}")
    res["neutrality"] = {
        "order": "detached, attached, attached, detached",
        "ms_per_leader_tick": [r["ms_per_leader_tick"] for r in runs],
        "ms_per_leader_tick_without_census": [
            r["ms_per_leader_tick_without_census"] for r in runs],
        "fetches": ref["fetches"], "nodelog_lines": len(ref["lines"]),
        "sha256": ref["sha256"],
        "attached_violations": [r["violations"] for r in runs]}
    # ---- capture and device_seconds
    step("capture")
    with tempfile.TemporaryDirectory() as tmp:
        res["capture"] = planes_capture(cfg, dev, tmp)
    step("device_seconds")
    res["k3_flight"] = planes_flight_seconds(cfg, dev)
    res["launches"] = read_counters(dev)
    # ---- the ops server's demo (K5 through its MultiEngine)
    from raft_tpu_torch.core import ring_cuda

    k5 = ring_cuda.LAUNCHES["write_window_cols"]
    step("serve_demo")
    res["serve_demo"] = planes_serve_demo(dev)
    res["k5_launches"] = ring_cuda.LAUNCHES["write_window_cols"] - k5
    check(res["k5_launches"] > 0, "serve_demo never launched K5")
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ------------------------------------------------------------ chaos path
CHAOS_SEEDS = (11, 14, 22, 27)  # the pinned membership seeds
CHAOS_WATCHDOG_S = 400          # the phase's stacks are dumped past this


def chaos_fingerprint(rep):
    """The chaos determinism fingerprint (the JAX package's tests'
    tuple): verdict, commit CRC, op count, op counts, crashes, shed ops,
    membership ops."""
    return (rep.verdict, rep.commit_digest, rep.ops, rep.op_counts,
            rep.crashes, rep.shed_ops, rep.membership_ops)


def chaos_plain(v):
    if hasattr(v, "verdict") and hasattr(v, "steps"):
        return (v.verdict, v.steps, v.key, v.detail)
    if isinstance(v, dict):
        return {k: chaos_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(chaos_plain(x) for x in v)
    return v


def chaos_run(fn, *args, **kw):
    """``raft_tpu_torch.chaos.runner.fn(*args, **kw)`` -> (trace, report):
    the trace is every report field but the live objects, and every
    history the checker was handed, one tuple an op (client, op, key,
    value, invoke and complete times, status, read class), and every
    commit-order witness ``check_serializable`` was handed (the txn
    drill's), one tuple a transaction and the final state."""
    from raft_tpu_torch.chaos import checker, runner

    seen = []
    saved = {n: getattr(runner, n)
             for n in ("check_history", "check_read_classes")}
    for name, orig in saved.items():
        def wrap(history, *a, _orig=orig, **k):
            seen.append([(r.client, r.op, r.key, r.value, r.invoke_t,
                          r.complete_t, r.status,
                          getattr(r, "read_class", None))
                         for r in history.ops])
            return _orig(history, *a, **k)
        setattr(runner, name, wrap)
    serializable = checker.check_serializable

    def witness(records, final_state=None, initial=None):
        seen.append([(r.txn_id, sorted(r.writes.items()),
                      sorted(r.expects.items()), r.status, r.pos,
                      r.invoke_t, r.complete_t) for r in records]
                    + [sorted((final_state or {}).items())])
        return serializable(records, final_state, initial)

    checker.check_serializable = witness
    try:
        rep = getattr(runner, fn)(*args, **kw)
    finally:
        checker.check_serializable = serializable
        for name, orig in saved.items():
            setattr(runner, name, orig)
    trace = {f.name: chaos_plain(getattr(rep, f.name))
             for f in dataclasses.fields(rep)
             if f.name not in ("obs", "bundle_path")}
    trace["verdict"] = rep.verdict
    trace["histories"] = seen
    return trace, rep


def chaos_same(a, b, what):
    for k in b:
        check(a.get(k) == b[k], f"{what}: {k} differs: "
              f"{str(a.get(k))[:300]} != {str(b[k])[:300]}")
    check(a.keys() == b.keys(), f"{what}: report fields differ")


class chaos_env:
    """``RAFT_TPU_FUSE_K`` for a block (None removes it)."""

    def __init__(self, k):
        self.k = k

    def __enter__(self):
        import os

        self.old = os.environ.get("RAFT_TPU_FUSE_K")
        if self.k is None:
            os.environ.pop("RAFT_TPU_FUSE_K", None)
        else:
            os.environ["RAFT_TPU_FUSE_K"] = str(self.k)

    def __exit__(self, *exc):
        import os

        if self.old is None:
            os.environ.pop("RAFT_TPU_FUSE_K", None)
        else:
            os.environ["RAFT_TPU_FUSE_K"] = self.old


def chaos_graph_use(fn):
    """Run ``fn()`` counting what every ``FusedGraphs`` launch did during
    it (a graph set built in the run or taken from the graph pool):
    (result, captures, recaptures and replays made in the run, and the
    graph objects that launched). Nothing of a graph set is held: a held
    one would keep its rings alive past their engine."""
    import weakref

    from raft_tpu_torch.core import graphs

    names = ("captures", "recaptures", "replays", "capture_s")
    total = dict.fromkeys(names, 0)
    seen = weakref.WeakSet()
    orig = graphs.FusedGraphs.run

    def run(self, *a, **k):
        before = [getattr(self, n) for n in names]
        try:
            return orig(self, *a, **k)
        finally:
            seen.add(self)
            for n, b in zip(names, before):
                total[n] += getattr(self, n) - b

    graphs.FusedGraphs.run = run
    try:
        out = fn()
    finally:
        graphs.FusedGraphs.run = orig
    return out, {"graph_objects_alive": len(seen),
                 **{f"graph_{n}": v for n, v in total.items()}}


def chaos_crash_cycles(dev, k, pooled):
    """Seed 17 at ``phases=6`` with the compile and memory planes (crash
    cycles after the freeze) on the card at ``fuse_k`` ``k``, the graph
    pool on or off: (trace, facts)."""
    import torch

    from raft_tpu_torch.core import graphs

    graphs.POOL.enabled = pooled
    torch.cuda.synchronize()
    a0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    try:
        with chaos_env(k):
            (trace, rep), use = chaos_graph_use(
                lambda: chaos_run("torture_run", 17, phases=6,
                                  observe_compile=True, device=dev))
    finally:
        graphs.POOL.enabled = True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w, mem = rep.obs.compile, rep.obs.memory
    viol = [str(v) for v in w.sentinel.violations]
    facts = {
        "fuse_k": k or 1, "graph_pool": pooled, "verdict": rep.verdict,
        "crashes": rep.crashes, "wall_s": wall,
        "sentinel_violations": len(viol),
        "violations_by_event": {e: sum(1 for v in w.sentinel.violations
                                       if v.event == e)
                                for e in ("trace", "compile")},
        "violation_list": viol,
        "compile_events_single_fused": len(w.events("single.fused",
                                                    "compile")),
        **use,
        "final_drift": mem.final_drift,
        "allocated_bytes_before_run": a0,
        "allocated_bytes_at_baseline": (mem.baseline.allocator or {}).get(
            "cuda_allocated_bytes"),
        "allocated_bytes_at_quiesce": ((mem.last.allocator or {}).get(
            "cuda_allocated_bytes") if mem.last is not None else None),
    }
    return trace, facts


def phase_chaos_path(dev, card_line):
    """The chaos harness (``raft_tpu_torch.chaos``) on the card against the
    same runs on the CPU (module doc, 11g)."""
    import faulthandler

    import torch

    import raft_tpu_torch.raft.steady as steady
    from raft_tpu_torch.chaos import LINEARIZABLE, VIOLATION
    from raft_tpu_torch.chaos.runner import _default_cfg, _membership_cfg
    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.raft.engine import RaftEngine
    from raft_tpu_torch.transport.group_mesh import GroupMesh

    t_phase = time.perf_counter()
    faulthandler.dump_traceback_later(CHAOS_WATCHDOG_S, exit=True)
    res = {"phase": "chaos_path", "card": card_line}

    def step(name):
        print(f"chaos_path: {name} at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    zero_counters(dev)
    fired = {"n": 0}
    fire = steady.FusedDriver.fire

    def spy(self, r, horizon):
        out = fire(self, r, horizon)
        fired["n"] += bool(out)
        return out

    # ---- the pinned membership seeds, card against CPU, fuse_k 1 and 4
    step("membership seeds")
    steady.FusedDriver.fire = spy
    try:
        seeds = {}
        for k in (None, 4):
            for seed in CHAOS_SEEDS:
                with chaos_env(k):
                    f0 = fired["n"]
                    card, rep = chaos_run("torture_run", seed, phases=4,
                                          membership=True, device=dev)
                    fused = fired["n"] - f0
                    cpu, _ = chaos_run("torture_run", seed, phases=4,
                                       membership=True, device="cpu")
                chaos_same(card, cpu, f"seed {seed} fuse_k {k or 1}")
                check(rep.verdict == LINEARIZABLE, rep.summary())
                seeds[f"{seed}@{k or 1}"] = {
                    "fingerprint": list(chaos_fingerprint(rep)),
                    "msg_stats": rep.msg_stats,
                    "nemesis_lines": len(rep.nemesis_log),
                    "fused_windows_card": fused}
            if k:
                n = sum(v["fused_windows_card"] for s, v in seeds.items()
                        if s.endswith(f"@{k}"))
                check(n > 0, f"no fused window ran at fuse_k {k}")
    finally:
        steady.FusedDriver.fire = fire
    res["membership_seeds"] = seeds
    res["membership_equal_card_cpu"] = True
    # ---- seed 17: crash cycles after the freeze. The first run at this
    # shape is cold: a launch size first used after the freeze traces and
    # captures then, as JAX's first run in a process compiles it. Then
    # the graph pool off (every crash cycle captures anew: the fault),
    # and on at fuse_k 1 and 4 (warm: each run takes the last one's
    # graphs, so nothing is captured at all)
    step("crash cycles")
    with chaos_env(4):
        cpu4, _ = chaos_run("torture_run", 17, phases=6,
                            observe_compile=True, device="cpu")
    cpu1, _ = chaos_run("torture_run", 17, phases=6, observe_compile=True,
                        device="cpu")
    crash = {}
    for name, k, pooled in (("fuse_k4_cold", 4, True),
                            ("fuse_k4_pool_off", 4, False),
                            ("fuse_k1_pool_on", None, True),
                            ("fuse_k4_pool_on", 4, True)):
        trace, facts = chaos_crash_cycles(dev, k, pooled)
        crash[name] = facts
        print(f"chaos_path: seed 17 {name} "
              f"{json.dumps(facts, default=str)}", flush=True)
        chaos_same(trace, cpu4 if k else cpu1, f"seed 17 {name}")
        check(facts["verdict"] == LINEARIZABLE and facts["crashes"] >= 1,
              f"seed 17 {name}: {facts}")
        check(facts["final_drift"] == [],
              f"seed 17 {name} census: {facts['final_drift']}")
        if k:
            check(facts["graph_replays"] > 0, f"{name}: no graph replayed")
        if pooled and name != "fuse_k4_cold":
            check(facts["sentinel_violations"] == 0,
                  f"seed 17 {name}: {facts['violation_list']}")
            check(facts["graph_recaptures"] == 0
                  and facts["graph_captures"] == 0,
                  f"seed 17 {name}: {facts}")
    res["crash_cycles"] = crash
    # ---- the broken variant must be rejected on the card
    step("broken variant")
    card, rep = chaos_run("torture_run", 0, phases=8, keys=2,
                          broken="dirty_reads", device=dev)
    cpu, _ = chaos_run("torture_run", 0, phases=8, keys=2,
                       broken="dirty_reads", device="cpu")
    chaos_same(card, cpu, "dirty_reads")
    check(rep.verdict == VIOLATION, f"dirty_reads: {rep.summary()}")
    res["dirty_reads"] = {"verdict": rep.verdict, "key": repr(rep.check.key),
                          "steps": rep.check.steps}
    # ---- the other runners, card against CPU
    step("drills")
    k1_small = {"K1": ring_cuda.LAUNCHES["write_window_both"]}
    drills, k5 = {}, {}
    cases = [
        ("multi", "torture_run_multi", (0,),
         dict(n_groups=4, phases=8), {}),
        ("overload", "overload_run", (0,), dict(rate_mult=5.0), {}),
        ("reconfig", "reconfig_run", (0,), {}, {}),
        ("reads", "reads_run", (3,), {}, {}),
        ("reads_lease_skew", "reads_run", (3,),
         dict(broken="lease_skew"), {}),
        ("segments", "segment_storage_run", (7,), {}, {}),
        ("migration", "migration_run", (0,),
         dict(n_groups=4, n_moves=2, clients=2, keys=4),
         {"mesh": GroupMesh([dev, dev])}),
    ]
    for name, fn, args, kw, card_kw in cases:
        c5 = ring_cuda.LAUNCHES["write_window_cols"]
        t0 = time.perf_counter()
        card, rep = chaos_run(fn, *args, device=dev, **kw, **card_kw)
        wall = time.perf_counter() - t0
        k5[name] = ring_cuda.LAUNCHES["write_window_cols"] - c5
        cpu_kw = {"mesh": GroupMesh(["cpu", "cpu"])} if card_kw else {}
        cpu, _ = chaos_run(fn, *args, device="cpu", **kw, **cpu_kw)
        chaos_same(card, cpu, name)
        want = VIOLATION if kw.get("broken") else LINEARIZABLE
        check(rep.verdict == want, f"{name}: {rep.summary()}")
        drills[name] = {"verdict": rep.verdict, "ops": rep.ops,
                        "card_wall_s": wall, "k5_launches": k5[name]}
    check(k5["multi"] > 0 and k5["migration"] > 0,
          f"K5 never launched on the multi-Raft chaos runs: {k5}")
    res["drills"] = drills
    torture = read_counters(dev)
    res["launches_torture"] = {key: torture[key] for key in ("K1", "K2")}
    check(torture["K1"] > k1_small["K1"] > 0, "K1 never launched")
    check(torture["K3"] == 0 and torture["K4"] == 0,
          "a flight launched under ChaosTransport")
    # ---- one torture run at the north star's widths
    step("north star widths")
    engines = []
    init = RaftEngine.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        engines.append(self)

    ns = {}
    for cap in (32768, 4096):
        cfg = dataclasses.replace(
            _membership_cfg(_default_cfg(11)), entry_bytes=256,
            batch_size=1024, log_capacity=cap)
        k2 = read_counters(dev)["K2"]
        RaftEngine.__init__ = keep
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card, rep = chaos_run("torture_run", 11, phases=4,
                                  membership=True, cfg=cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            RaftEngine.__init__ = init
        ticks = sum(e._tick_count for e in engines)
        engines.clear()
        check(rep.verdict == LINEARIZABLE, f"north star: {rep.summary()}")
        ns[cap] = {"verdict": rep.verdict, "ops": rep.ops,
                   "crashes": rep.crashes,
                   "membership_ops": rep.membership_ops,
                   "host_wall_s": wall, "leader_ticks": ticks,
                   "ms_a_leader_tick": 1e3 * wall / max(ticks, 1),
                   "ring_mb": cfg.rows * cfg.log_capacity
                   * (cfg.entry_bytes + 4) / 1e6,
                   "k2_launches": read_counters(dev)["K2"] - k2}
        if cap == 4096:
            cpu, _ = chaos_run("torture_run", 11, phases=4,
                               membership=True, cfg=cfg, device="cpu")
            chaos_same(card, cpu, "seed 11 at C = 4096")
    res["north_star_widths"] = {"C=32768": ns[32768], "C=4096": ns[4096],
                                "card": card_line}
    after = read_counters(dev)
    res["launches"] = {"K1": after["K1"], "K2": after["K2"],
                       "K3": after["K3"], "K4": after["K4"]}
    res["launches_northstar"] = {
        key: after[key] - torture[key] for key in ("K1", "K2")}
    res["k5_launches"] = {"chaos_multi": k5["multi"],
                          "chaos_migration": k5["migration"]}
    check(res["launches"]["K2"] > 0,
          "K2 never launched on the chaos path")
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ------------------------------------------------ the wire tier (net/)
#: the north star served over the wire (``wire_path`` (a)): SUBMIT_BATCH
#: frames of one batch each over WIRE_CONNS loopback connections, each
#: connection a closed loop with one frame in flight (its next frame sent
#: once the last is acknowledged), the shape of ``bench.py``
#: ``bench_macro``'s ``macro_wire`` row; the timed stage's frames (a window
#: of several seconds), then those served under torch.profiler (out of the
#: timed stage: the profiler's start and stop take seconds), then those
#: sent to a server driving one heartbeat a pump iteration (the tick
#: path's steady program, K2, behind the same backend)
WIRE_CONNS = 4
WIRE_TIMED_FRAMES = 256
WIRE_PROFILED_FRAMES = 40
WIRE_TICKED_FRAMES = 8
#: pump iterations of (a) under torch.profiler, and the first of them (a
#: pump iteration ingests at most the WIRE_CONNS frames in flight, so the
#: profiled stage's frames last past the window)
WIRE_PROFILED_ITERS = 8
WIRE_PROFILE_FROM = 2
#: config A over the wire (``wire_path`` (b)), in ``bench_macro``'s two
#: shapes, with single-op SUBMIT frames (the apply-stream check needs each
#: SET's group and seq): ``macro_wire``'s closed loop, 16 connections with
#: 64 entries in flight on each (its one 64-entry frame a connection), for
#: the SETs/s the tier sustains; then ``macro_leader_kill``'s open loop
#: (requests scheduled 8 at a time on an absolute clock, each timed from
#: when it was due) at fractions of that rate below saturation, for the
#: commit latency a client sees when no queue has formed
WIRE_MACRO_CONNS = 16
WIRE_MACRO_IN_FLIGHT = 64
WIRE_PACE_SLICE = 8
WIRE_PACED_LOADS = (0.25, 0.5)
#: SETs a group: the closed loop's, and each paced rate's
WIRE_CLOSED_SETS = 1024
WIRE_PACED_SETS = 512

def wire_fuse_config(capacity):
    """The north star with K-tick fusion as ``tests/test_net_wire.py``'s
    staged-ingest pin sets it (``fuse_k`` 8, PreVote)."""
    return dataclasses.replace(fused_config(capacity, 8), prevote=True)


class WireWatch:
    """Every ``IngestServer`` built while the watch is on, and every ERROR
    frame any of them encodes: ``check()`` fails on an ERROR frame, and on
    a pump task that ended with an exception or never ended."""

    def __enter__(self):
        from raft_tpu_torch.net import protocol, server

        self.servers, self.errors = [], []
        self._proto, self._srv = protocol, server.IngestServer
        self._enc = protocol.encode_error
        self._init = server.IngestServer.__init__
        watch = self

        def encode_error(req_id, message, **kw):
            watch.errors.append(message)
            return watch._enc(req_id, message, **kw)

        def init(srv, *a, **k):
            watch._init(srv, *a, **k)
            watch.servers.append(srv)

        protocol.encode_error = encode_error
        server.IngestServer.__init__ = init
        return self

    def __exit__(self, *exc):
        self._proto.encode_error = self._enc
        self._srv.__init__ = self._init

    def check(self, what):
        check(not self.errors, f"{what}: ERROR frames {self.errors[:4]}")
        for srv in self.servers:
            t = srv._pump_task
            check(t is not None and t.done() and not t.cancelled()
                  and t.exception() is None,
                  f"{what}: a pump task ended badly: {t}")
        return {"servers": len(self.servers), "error_frames": 0}


def _pump_profiler(first, iters):
    """A ``PumpProfiler`` that holds pump iterations [first, first +
    iters) under torch.profiler (on the card): ``result()`` gives the
    window's device busy time, wall and idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.obs.hostprof import PumpProfiler

    class Profiled(PumpProfiler):
        prof = None
        wall = None
        t0 = 0.0

        def iter_begin(self):
            if self.iters == first:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            super().iter_begin()

        def iter_end(self):
            super().iter_end()
            if self.prof is not None and self.wall is None \
                    and self.iters == first + iters:
                self.stop()

        def stop(self):
            torch.cuda.synchronize()
            self.wall = time.perf_counter() - self.t0
            self.prof.__exit__(None, None, None)

        def result(self):
            """The window's figures; a window the stage ended inside is
            closed here and fails the run."""
            if self.prof is not None and self.wall is None:
                self.stop()
                check(False, f"the stage ended after {self.iters} pump "
                      f"iterations, inside the profiled window")
            check(self.prof is not None, "no pump iteration profiled")
            ev = [(e.name, e.time_range.elapsed_us())
                  for e in self.prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(us for _, us in ev)
            return {"profiled_iters": iters, "wall_ms": self.wall * 1e3,
                    "device_busy_ms": busy / 1e3,
                    "device_ops": len(ev),
                    "device_idle_share": 1.0 - busy / (self.wall * 1e6)}

    return Profiled()


def wire_engine_run(cfg, dev):
    """``wire_path`` (a) on the card: ``IngestServer(EngineBackend(
    RaftEngine(cfg), ReplicatedKV))``, SETs of unique keys as SUBMIT_BATCH
    frames of one batch each from ``WIRE_CONNS`` closed-loop connections
    (shed entries resubmitted), while one more connection writes a key and
    reads it back linearizably and through its session, each read against
    the last acknowledged value. Three servers in turn on the one engine:
    the timed stage and the profiled stage drive ``fuse_k`` heartbeats a
    pump iteration (fused windows over the staged batches), the ticked
    stage one. Every committed window is read back through
    ``committed_entries`` and every live follower while it is in the ring
    (on the loop's thread, between acknowledgements: its seconds are
    counted and taken out of the wire rate); the per-entry SHA-256
    multiset must equal the acknowledged entries'."""
    import asyncio
    from collections import Counter

    import torch

    from raft_tpu_torch.core.state import log_entries
    from raft_tpu_torch.examples.kv import ReplicatedKV, encode_op
    from raft_tpu_torch.net import EngineBackend, IngestServer, WireClient
    from raft_tpu_torch.obs.hostprof import PumpProfiler
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    B, E, C = cfg.batch_size, cfg.entry_bytes, cfg.log_capacity
    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device=dev))
    kv = ReplicatedKV(e)
    e.run_until_leader()
    n_frames = WIRE_TIMED_FRAMES + WIRE_PROFILED_FRAMES + WIRE_TICKED_FRAMES
    entries = n_frames * B
    rng = np.random.default_rng(SEED + 71)
    vals = rng.integers(0, 256, (entries, E - 5 - 8), dtype=np.uint8)
    items = [(b"w%07d" % i, vals[i].tobytes()) for i in range(entries)]
    frames = [items[i:i + B] for i in range(0, entries, B)]
    acked = Counter()              # sha256 of each acknowledged entry
    read_back = Counter()          # ... of each entry read back
    readers = {"hi": 0, "windows": 0, "readers": set(), "s": 0.0}
    res = {"device": str(dev), "entries": entries, "frames": n_frames,
           "conns": WIRE_CONNS, "frames_in_flight_per_conn": 1}

    def digest(k, v):
        return hashlib.sha256(encode_op(E, 1, k, v)).digest()

    dig = {k: digest(k, v) for k, v in items}   # before any timing

    def read_windows(final=False):
        """Read [hi+1, min live commit index] through committed_entries
        and every live follower, once it spans a fused window (or at the
        end), in slices the ring still holds."""
        t_read = time.perf_counter()
        live = [r for r in range(cfg.rows) if e.alive[r]]
        top = min(int(x) for x in
                  e.state.commit_index.cpu()[live].tolist())
        top = min(top, e.commit_watermark)
        lo = readers["hi"] + 1
        if top < lo or (not final and top - lo + 1 < cfg.fuse_k * B):
            readers["s"] += time.perf_counter() - t_read
            return
        check(e.commit_watermark - lo < C, "the ring lapped a window "
              "before it was read back")
        for a in range(lo, top + 1, C // 2):
            b = min(a + C // 2 - 1, top)
            want = e.committed_entries(a, b)
            readers["readers"].add("committed_entries")
            for r in live:
                if r == e.leader_id:
                    continue
                got = log_entries(e.state, r, a, b)
                check(np.array_equal(np.asarray(got), want),
                      f"row {r}'s read-back of [{a}, {b}] differs from "
                      "committed_entries")
                readers["readers"].add(f"row{r}")
            for row in want:
                read_back[hashlib.sha256(row.tobytes()).digest()] += 1
            readers["windows"] += 1
        readers["hi"] = top
        readers["s"] += time.perf_counter() - t_read

    lat_ms, reads = [], {"linearizable": 0, "session": 0}
    shed = {"entries": 0}

    async def bulk(c, mine):
        """One closed-loop connection: each frame until all of it is
        acknowledged (the depth gate sheds a frame's tail: resubmit it),
        then the next."""
        for frame in mine:
            while frame:
                t0 = time.perf_counter()
                r = await c.submit_many(frame)
                lat_ms.append((time.perf_counter() - t0) * 1e3)
                acked.update(dig[k] for k, _ in frame[:r.accepted])
                shed["entries"] += r.shed
                frame = frame[r.accepted:]
                read_windows()

    async def reader(c, stop):
        i = 0
        while not stop.is_set():
            v = b"rv%06d" % i
            await c.submit(b"rk", v)
            acked[digest(b"rk", v)] += 1
            lin = await c.read(b"rk")
            check(lin.value == v,
                  f"linearizable read {lin.value!r} != last ack {v!r}")
            ses = await c.read(b"rk", cls="session")
            check(ses.value == v, f"session read {ses.value!r} != {v!r}")
            reads["linearizable"] += 1
            reads["session"] += 1
            i += 1

    async def stage(quantum, part, pump=None):
        """One server on the engine: ``part``'s frames from WIRE_CONNS
        connections and the reader on one more; (wall, server stats)."""
        srv = IngestServer(EngineBackend(e, kv), pump=pump,
                           drive_quantum_s=quantum)
        port = await srv.start()
        conns = [await WireClient("127.0.0.1", port).connect()
                 for _ in range(WIRE_CONNS + 1)]
        stop = asyncio.Event()
        rd = asyncio.ensure_future(reader(conns[-1], stop))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        await asyncio.gather(*[bulk(c, part[j::WIRE_CONNS])
                               for j, c in enumerate(conns[:-1])])
        wall = time.perf_counter() - t0
        stop.set()
        await rd
        for c in conns:
            await c.close()
        stats = srv.stats()
        await srv.stop()
        return wall, stats

    hb = cfg.heartbeat_period
    cut_p = WIRE_TIMED_FRAMES
    cut_t = cut_p + WIRE_PROFILED_FRAMES
    f0, t0n = e.fused_launches, e._tick_count
    # timed: the drive quantum of the staged-ingest pin, fuse_k ticks
    wall, stats = asyncio.run(stage(cfg.fuse_k * hb, frames[:cut_p],
                                    PumpProfiler()))
    read_s = readers["s"]
    timed_lat = list(lat_ms)
    # profiled: the same quantum, WIRE_PROFILED_ITERS pump iterations under
    # torch.profiler (its start-up paid before the stage)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
    pump = _pump_profiler(WIRE_PROFILE_FROM, WIRE_PROFILED_ITERS)
    stats_p = asyncio.run(stage(cfg.fuse_k * hb, frames[cut_p:cut_t],
                                pump))[1]
    res["profiled"] = pump.result()
    fused = e.fused_launches - f0
    for st in (stats, stats_p):
        check(st["wire_staged_batches"] > 0, "no batch staged at ingest")
        check(st["tick_staged_batches"] == 0,
              f"{st['tick_staged_batches']} batches re-packed by the tick "
              "path")
    check(fused > 0, "no fused window ran")
    # ticked: one heartbeat a pump iteration, under the fused window's
    # two-tick minimum, so every leader tick is the steady program's
    f1 = e.fused_launches
    wall2, stats2 = asyncio.run(stage(hb, frames[cut_t:]))
    check(e.fused_launches == f1, "a window fused at a one-tick quantum")
    read_windows(final=True)
    check(e.commit_watermark == sum(acked.values()),
          f"watermark {e.commit_watermark} != {sum(acked.values())} "
          "acknowledged entries")
    check(read_back == acked, "the read-back multiset differs from the "
          "acknowledged entries'")
    for k, v in items:
        check(kv.get(k) == v, f"kv value of {k!r} differs")
    ps = stats["pump"]
    n1 = cut_p * B
    every = (stats, stats_p, stats2)
    res.update({
        "timed_entries": n1, "wall_s": wall,
        "read_back_s_in_wall": read_s,
        "entries_per_s_wire": n1 / (wall - read_s),
        "entries_per_s_wall": n1 / wall,
        "ticked": {"entries": WIRE_TICKED_FRAMES * B, "wall_s": wall2,
                   "entries_per_s_wall": WIRE_TICKED_FRAMES * B / wall2,
                   "pump_iters": stats2["pump_iters"],
                   "wire_staged_batches": stats2["wire_staged_batches"]},
        "frame_acks": len(timed_lat),
        "frame_ack_ms_p50": pct(timed_lat, 50),
        "frame_ack_ms_p90": pct(timed_lat, 90),
        "shed": shed, "acknowledged": sum(acked.values()),
        "commit_watermark": e.commit_watermark,
        "read_back_windows": readers["windows"],
        "read_back_readers": sorted(readers["readers"]),
        "reads_checked": reads, "fused_launches": fused,
        "leader_ticks": e._tick_count - t0n,
        "wire_staged_batches": stats["wire_staged_batches"]
        + stats_p["wire_staged_batches"],
        "tick_staged_batches": stats["tick_staged_batches"]
        + stats_p["tick_staged_batches"],
        "tick_tail_batches": stats["tick_tail_batches"]
        + stats_p["tick_tail_batches"],
        "pump_iters": stats["pump_iters"],
        "bytes_in": sum(st["bytes_in"] for st in every),
        "refusals": [st["refusals"] for st in every],
        "pump_us_per_iter": ps["us_per_iter"],
        "pump_coverage": ps["coverage"],
        "coalesce_batch": ps["coalesce_batch"],
    })
    check(reads["linearizable"] > 0, "no read ran beside the bulk")
    return res


def wire_router_run(dev):
    """``wire_path`` (b) on the card: config A (``group_config_a``)
    behind ``RouterBackend`` + ``ShardedKV``, single-op SETs of unique keys
    over ``WIRE_MACRO_CONNS`` connections: ``WIRE_CLOSED_SETS`` a group in
    the closed loop (SETs/s, and the ack latency of a saturated tier),
    then ``WIRE_PACED_SETS`` a group at each of ``WIRE_PACED_LOADS`` of
    the closed loop's rate in the open loop (submit-to-durable-ack latency
    from when each SET was due, and how late the generator ran). Each
    group's apply stream against its acknowledged SETs in seq order
    (SHA-256), then every acknowledged SET read back through a
    linearizable read (a check: its rate is not reported). The read
    plane's leader lease is on (``read_lease``, with the PreVote it
    requires): a linearizable read is then certified by the lease, or by
    a ReadIndex round when the lease has lapsed, instead of a quorum
    round each."""
    import asyncio

    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.examples import ShardedKV
    from raft_tpu_torch.examples.kv import encode_op
    from raft_tpu_torch.multi import MultiEngine, Router
    from raft_tpu_torch.net import IngestServer, RouterBackend, WireClient

    cfg, G = group_config_a()
    cfg = multi_config(cfg, read_lease=True, prevote=True)
    E = cfg.entry_bytes
    e = MultiEngine(cfg, G, device=dev)
    e.seed_leaders()
    router = Router(e, drive=False)
    skv = ShardedKV(e, router)
    per_group = WIRE_CLOSED_SETS + WIRE_PACED_SETS * len(WIRE_PACED_LOADS)
    S = KvStream(router, per_group, SEED + 73)
    acked = [[] for _ in range(G)]
    read_cls = {}
    k5 = ring_cuda.LAUNCHES["write_window_cols"]

    async def put(c, kvp, lat, t_due=None):
        k, v = kvp
        t0 = time.perf_counter() if t_due is None else t_due
        r = await c.submit(k, v)
        lat.append((time.perf_counter() - t0) * 1e3)
        check(r.group == router.group_of(k), "SET routed to another group")
        acked[r.group].append((r.seq, k, v))

    async def get(c, kvp, _lat):
        _, k, v = kvp
        out = await c.read(k)
        check(out.value == v, f"linearizable read of {k!r} differs from "
              "its acknowledged SET")
        read_cls[out.cls] = read_cls.get(out.cls, 0) + 1

    async def closed(conns, jobs, fn):
        """Each connection keeps WIRE_MACRO_IN_FLIGHT requests in flight
        until ``jobs`` is empty; (wall s, latencies ms)."""
        jobs, lat = list(reversed(jobs)), []

        async def worker(c):
            while jobs:
                await fn(c, jobs.pop(), lat)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        await asyncio.gather(*[worker(c) for c in conns
                               for _ in range(WIRE_MACRO_IN_FLIGHT)])
        return time.perf_counter() - t0, lat

    async def paced(conns, jobs, rate):
        """``jobs`` sent at ``rate`` a second, WIRE_PACE_SLICE at a time
        on an absolute schedule, round robin over ``conns``: after a stall
        every slice already due is sent at once; each latency from its
        slice's due time."""
        lat, tasks, late = [], [], []
        interval = WIRE_PACE_SLICE / rate
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i = 0
        while i < len(jobs):
            await asyncio.sleep(max(t0 + i // WIRE_PACE_SLICE * interval
                                    - time.perf_counter(), 0.0))
            now = time.perf_counter()
            while i < len(jobs) \
                    and t0 + i // WIRE_PACE_SLICE * interval <= now:
                due = t0 + i // WIRE_PACE_SLICE * interval
                late.append((now - due) * 1e3)
                tasks.extend(asyncio.ensure_future(
                    put(conns[(i + j) % len(conns)], kvp, lat, due))
                    for j, kvp in enumerate(jobs[i:i + WIRE_PACE_SLICE]))
                i += WIRE_PACE_SLICE
        t_gen = time.perf_counter() - t0
        await asyncio.gather(*tasks)
        wall = time.perf_counter() - t0
        return {"target_sets_per_s": rate,
                "offered_sets_per_s": len(jobs) / t_gen,
                "sets": len(jobs), "wall_s": wall,
                "generator_late_ms_p50": pct(late, 50),
                "generator_late_ms_p99": pct(late, 99),
                "generator_late_ms_max": max(late),
                "submit_to_durable_ack_ms_p50": pct(lat, 50),
                "submit_to_durable_ack_ms_p99": pct(lat, 99),
                "submit_to_durable_ack_ms_max": max(lat)}

    async def main():
        srv = IngestServer(RouterBackend(router, skv))
        port = await srv.start()
        conns = [await WireClient("127.0.0.1", port).connect()
                 for _ in range(WIRE_MACRO_CONNS)]
        wall, lat = await closed(conns, S.wave(WIRE_CLOSED_SETS), put)
        out = {"closed": {
            "sets": len(lat), "in_flight": WIRE_MACRO_CONNS
            * WIRE_MACRO_IN_FLIGHT, "wall_s": wall,
            "sets_per_s_wire": len(lat) / wall,
            "submit_to_durable_ack_ms_p50": pct(lat, 50),
            "submit_to_durable_ack_ms_p99": pct(lat, 99)}}
        for load in WIRE_PACED_LOADS:
            out[f"paced_{load}"] = await paced(
                conns, S.wave(WIRE_PACED_SETS),
                load * out["closed"]["sets_per_s_wire"])
        out["reads"] = sum(len(a) for a in acked)
        await closed(conns, [x for g in range(G) for x in acked[g]], get)
        for c in conns:
            await c.close()
        out["stats"] = srv.stats()
        await srv.stop()
        return out

    out = asyncio.run(main())
    stats = out.pop("stats")
    sha = []
    for g in range(G):
        h = hashlib.sha256()
        for _, k, v in sorted(acked[g]):
            h.update(encode_op(E, 1, k, v))
        check(len(acked[g]) == per_group == int(S.n_apply[g]),
              f"group {g}: {len(acked[g])} acknowledged, "
              f"{int(S.n_apply[g])} applied")
        check(h.hexdigest() == S.h_apply[g].hexdigest(),
              f"group {g}'s apply stream differs from its acknowledged "
              "SETs")
        sha.append(h.hexdigest())
    out.update({
        "device": str(dev), "groups": G, "sets": G * per_group,
        "conns": WIRE_MACRO_CONNS, "read_classes": read_cls,
        "pump_iters": stats["pump_iters"], "refusals": stats["refusals"],
        "sha256_group0": sha[0],
        "k5_launches": ring_cuda.LAUNCHES["write_window_cols"] - k5,
    })
    return out


def wire_serial_run(dev, traced):
    """``tests/test_wire_trace.py``'s serial scenario (one connection, 12
    submits and 4 reads, seed 9) on ``dev``: (commit watermark, per-op
    CRC, the three applied values, the nodelog lines)."""
    import asyncio
    import zlib

    from raft_tpu_torch.config import RaftConfig
    from raft_tpu_torch.examples.kv import ReplicatedKV
    from raft_tpu_torch.net import EngineBackend, IngestServer, WireClient
    from raft_tpu_torch.obs.hostprof import PumpProfiler
    from raft_tpu_torch.obs.registry import MetricsRegistry
    from raft_tpu_torch.obs.spans import SpanTracker
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    cfg = RaftConfig(n_replicas=3, entry_bytes=32, batch_size=4,
                     log_capacity=256, transport="single", seed=9,
                     admission_max_writes=64)
    lines = []
    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device=dev),
                   trace=lines.append)
    kv = ReplicatedKV(e)
    e.run_until_leader()
    srv_kw, cli_kw = {}, {}
    if traced:
        sspans, reg = SpanTracker(), MetricsRegistry()
        e.spans = sspans
        srv_kw = dict(spans=sspans, registry=reg,
                      pump=PumpProfiler(registry=reg))
        cli_kw = dict(spans=SpanTracker(), clock=lambda: e.clock.now)

    async def main():
        srv = IngestServer(EngineBackend(e, kv), **srv_kw)
        port = await srv.start()
        c = await WireClient("127.0.0.1", port, **cli_kw).connect()
        trace = []
        for i in range(12):
            r = await c.submit(b"dk%d" % (i % 3), b"dv%d" % i)
            trace.append(("ok", r.group, r.seq, r.floor))
            if i % 3 == 0:
                o = await c.read(b"dk0")
                trace.append(("rd", o.index, o.value))
        await c.close()
        await srv.stop()
        return trace

    crc = 0
    for item in asyncio.run(main()):
        crc = zlib.crc32(repr(item).encode(), crc)
    return (int(e.commit_watermark), crc, kv.get(b"dk0"), kv.get(b"dk1"),
            kv.get(b"dk2"), lines)


def wire_drill_check(rep, what):
    """``tests/test_net_wire.py``'s pinned invariants of the wire drill."""
    check(rep.verdict == "LINEARIZABLE", f"{what}: {rep.summary()}")
    check(rep.shed_writes >= 1 and rep.not_leader_frames >= 1
          and rep.leader_kills == 1
          and rep.wire_refusals.get("depth", 0) >= 1
          and rep.op_counts.get("ok", 0) > 50, f"{what}: {rep.summary()}")
    check(rep.traced and rep.client_spans == rep.ops
          and rep.server_spans >= rep.ops and rep.pump is not None
          and rep.pump["coverage"] >= 0.9, f"{what}: trace plane")
    check(rep.ops == 144, f"{what}: {rep.ops} ops, JAX's drill has 144")
    return {"verdict": rep.verdict, "ops": rep.ops,
            "op_counts": rep.op_counts, "shed_writes": rep.shed_writes,
            "not_leader_frames": rep.not_leader_frames,
            "wire_refusals": rep.wire_refusals,
            "pump_coverage": rep.pump["coverage"],
            "commit_digest": rep.commit_digest}


def phase_wire_path(dev, card_line):
    """The net tier on the card (module doc, 11h): (a) the north star
    behind ``EngineBackend``, (b) config A behind ``RouterBackend``, (c)
    the wire drill and the serial pin, card against CPU, (d) the joined
    bundle explained."""
    import faulthandler
    import os
    import tempfile

    import torch

    from raft_tpu_torch.chaos.runner import wire_run
    from raft_tpu_torch.core import ring_cuda

    t_phase = time.perf_counter()
    faulthandler.enable()
    res = {"phase": "wire_path", "card": card_line}

    def step(name):
        print(f"wire_path: {name} at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    with WireWatch() as watch:
        # (a) the north star behind EngineBackend: the counts from 0
        step("the north star behind EngineBackend")
        zero_counters(dev)
        res["engine"] = wire_engine_run(wire_fuse_config(32768), dev)
        res["engine"]["launches"] = {
            k: v for k, v in read_counters(dev).items()
            if k in ("K1", "K2", "K3", "K4")}
        print(f"wire_path: engine {json.dumps(res['engine'])}", flush=True)
        watch.check("wire engine")
        check(res["engine"]["launches"]["K1"] > 0, "K1 never launched "
              "behind the EngineBackend")
        check(res["engine"]["launches"]["K2"] > 0, "K2 never launched "
              "behind the EngineBackend")
        check(res["engine"]["launches"]["K3"] == 0
              and res["engine"]["launches"]["K4"] == 0,
              "a flight launched behind the EngineBackend (its submits "
              "never take submit_pipelined)")
        # (b) config A behind RouterBackend + ShardedKV
        step("config A behind RouterBackend")
        ring_cuda.LAUNCHES["write_window_cols"] = 0
        res["router"] = wire_router_run(dev)
        print(f"wire_path: router {json.dumps(res['router'])}", flush=True)
        watch.check("wire router")
        check(res["router"]["k5_launches"] > 0, "K5 never launched "
              "behind the RouterBackend")
        # (c) the drill and the serial pin, card against CPU
        step("the wire drill, card and CPU")
        k5 = ring_cuda.LAUNCHES["write_window_cols"]
        t0 = time.perf_counter()
        card = wire_drill_check(wire_run(7, device=dev), "wire drill card")
        card["wall_s"] = time.perf_counter() - t0
        card["k5_launches"] = ring_cuda.LAUNCHES["write_window_cols"] - k5
        cpu = wire_drill_check(wire_run(7, device="cpu"), "wire drill cpu")
        res["drill"] = {"card": card, "cpu": cpu}
        step("the serial pin, card and CPU")
        c1 = read_counters(dev)
        serial = {t: (wire_serial_run(dev, t), wire_serial_run("cpu", t))
                  for t in (True, False)}
        c2 = read_counters(dev)
        for t, (a, b) in serial.items():
            check(a == b, f"serial pin (traced={t}): card {a[:5]} != "
                  f"CPU {b[:5]}")
        check(serial[True][0][:5] == serial[False][0][:5],
              "serial pin: trace on != off")
        res["serial"] = {"watermark": serial[True][0][0],
                         "crc": serial[True][0][1],
                         "nodelog_lines": len(serial[True][0][5]),
                         "launches": {k: c2[k] - c1[k]
                                      for k in ("K1", "K2")}}
        watch.check("wire drill")
        # (d) the joined bundle, explained by the port's CLI
        step("the joined bundle")
        with tempfile.TemporaryDirectory() as tmp:
            rep = wire_run(3, clients=2, ops_per_phase=4, bundle_dir=tmp,
                           device=dev)
            check(rep.bundle_path is not None, "no wire bundle written")
            env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
            out = subprocess.run(
                [sys.executable, "-m", "raft_tpu_torch.obs", "--explain",
                 rep.bundle_path], cwd=HERE, env=env, capture_output=True,
                text=True, timeout=120)
            check(out.returncode == 0
                  and "joined wire forensics" in out.stdout,
                  f"--explain of the wire bundle: {out.stderr[-500:]}")
        res["bundle"] = {"verdict": rep.verdict, "explained": True}
        res["watch"] = watch.check("wire bundle")
    res["k5_launches"] = {"config_a": res["router"]["k5_launches"],
                          "drill": card["k5_launches"]}
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ------------------------------------------------ the transaction tier
#: ``bench.py`` ``bench_txn``'s shape (:1818-1851): G groups, B-entry
#: SUBMIT_BATCH frames, CONNS connections of REQS requests each, a 10 %
#: share of validated two-account transfers over ACCOUNTS accounts (``ta*``)
#: beside the single-key frames (``mk*``, a disjoint keyspace)
TXN_G, TXN_B, TXN_CONNS, TXN_REQS, TXN_ACCOUNTS = 4, 64, 8, 30, 16
TXN_SHARE = 0.10
#: a second, shorter round of the same mix served under torch.profiler
#: (out of the timed round): pump iterations [FROM, FROM + ITERS)
TXN_PROFILED_REQS = 12
TXN_PROFILE_FROM, TXN_PROFILED_ITERS = 2, 8
#: the seed-7 drill's commit digest, as the JAX package's tests pin it
#: (``tests/test_txn.py:509``)
TXN_SEED7_DIGEST = "6961c982"


def txn_bench_config():
    """``bench_txn``'s deployment: 4 groups of 3, 64-byte entries, batch
    64, a 2 048-slot ring, the write-depth gate at 512, seed 17."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=64, batch_size=TXN_B,
                      log_capacity=1 << 11, transport="single", seed=17,
                      admission_max_writes=512)


def txn_bench_run(dev):
    """``txn_path`` (b) on the card: ``bench_txn``'s leg served through
    ``IngestServer(RouterBackend, txn=TxnCoordinator)``: the accounts
    seeded (100 each), then the timed round (``TXN_CONNS`` connections of
    ``TXN_REQS`` requests, each a B-entry SUBMIT_BATCH or, with
    probability ``TXN_SHARE``, a transfer that reads both balances and
    commits both writes expecting both), then a shorter round under
    torch.profiler for the idle share, then the checks, out of both
    rounds: every account read back linearizably and the sum conserved,
    every single key read back as written, each transfer's outcome in the
    coordinator's counts and the replicated decision map, no lock held."""
    import asyncio
    import random as _random

    import torch

    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.multi import MultiEngine, Router
    from raft_tpu_torch.net import (IngestServer, RouterBackend, WireClient,
                                    WireRefused)
    from raft_tpu_torch.net.client import WireDisconnected, WireError
    from raft_tpu_torch.txn import TxnCoordinator, TxnShardedKV

    cfg = txn_bench_config()
    eng = MultiEngine(cfg, TXN_G, device=dev)
    router = Router(eng, drive=False)
    skv = TxnShardedKV(eng, router)
    eng.seed_leaders()
    coord = TxnCoordinator(skv, decision_group=0)
    payload = bytes(cfg.entry_bytes // 2)
    keys = [b"mk%d" % i for i in range(64)]
    accounts = [b"ta%d" % i for i in range(TXN_ACCOUNTS)]

    async def serve(reqs, tag, pump=None, seed_accounts=False):
        tally = {"lat": [], "committed": 0, "aborted": 0, "refused": 0,
                 "unknown": 0, "single_acked": 0, "single_shed": 0,
                 "reasons": {}}
        srv = IngestServer(RouterBackend(router, skv), txn=coord,
                           drive_quantum_s=cfg.heartbeat_period, pump=pump)
        port = await srv.start()
        cs = [await WireClient("127.0.0.1", port, txn=True,
                               rng=_random.Random(f"bench-txn:{tag}{i}")
                               ).connect() for i in range(TXN_CONNS)]
        if seed_accounts:
            for i, a in enumerate(accounts):
                await cs[i % TXN_CONNS].submit(a, b"100")

        async def one_txn(c, rng):
            src, dst = rng.sample(range(TXN_ACCOUNTS), 2)
            ka, kb = accounts[src], accounts[dst]
            try:
                va = (await c.read(ka)).value or b"0"
                vb = (await c.read(kb)).value or b"0"
            except (WireRefused, WireDisconnected, WireError):
                tally["refused"] += 1
                return
            amt = 1 + rng.randrange(5)
            t0 = time.perf_counter()
            try:
                r = await c.txn_commit(
                    [(ka, b"%d" % (int(va) - amt)),
                     (kb, b"%d" % (int(vb) + amt))],
                    expects=[(ka, va), (kb, vb)])
            except WireRefused:
                tally["refused"] += 1
                return
            except (WireDisconnected, WireError):
                tally["unknown"] += 1
                return
            tally["lat"].append((time.perf_counter() - t0) * 1e3)
            tally["committed" if r.committed else "aborted"] += 1
            if not r.committed:
                tally["reasons"][r.reason] = \
                    tally["reasons"].get(r.reason, 0) + 1

        async def one_frame(c, j):
            items = [(keys[(j * TXN_B + i) % len(keys)], payload)
                     for i in range(TXN_B)]
            try:
                r = await c.submit_many(items)
            except (WireRefused, WireDisconnected, WireError):
                tally["single_shed"] += TXN_B
            else:
                tally["single_acked"] += r.accepted
                tally["single_shed"] += r.shed

        async def worker(i):
            c = cs[i]
            rng = _random.Random(f"bench-txn-mix:{tag}{i}")
            for j in range(reqs):
                if rng.random() < TXN_SHARE:
                    await one_txn(c, rng)
                else:
                    await one_frame(c, j)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        await asyncio.gather(*[worker(i) for i in range(TXN_CONNS)])
        tally["wall_s"] = time.perf_counter() - t0
        for c in cs:
            await c.close()
        tally["stats"] = srv.stats()
        await srv.stop()
        return tally

    async def verify():
        srv = IngestServer(RouterBackend(router, skv), txn=coord,
                           drive_quantum_s=cfg.heartbeat_period)
        c = await WireClient("127.0.0.1", await srv.start()).connect()
        bal = {a: (await c.read(a)).value for a in accounts}
        singles = {k: (await c.read(k)).value for k in keys}
        await c.close()
        await srv.stop()
        return bal, singles

    k5 = ring_cuda.LAUNCHES["write_window_cols"]
    timed = asyncio.run(serve(TXN_REQS, "", seed_accounts=True))
    k5_timed = ring_cuda.LAUNCHES["write_window_cols"] - k5
    prof = _pump_profiler(TXN_PROFILE_FROM, TXN_PROFILED_ITERS)
    profiled = asyncio.run(serve(TXN_PROFILED_REQS, "profiled:", pump=prof))
    idle = prof.result()
    k5_all = ring_cuda.LAUNCHES["write_window_cols"] - k5
    bal, singles = asyncio.run(verify())
    check(all(v is not None for v in bal.values())
          and sum(int(v) for v in bal.values()) == 100 * TXN_ACCOUNTS,
          f"txn bench: the account sum is not conserved: {bal}")
    acked = timed["single_acked"] + profiled["single_acked"]
    check(acked > 0 and all(v == payload for v in singles.values()),
          "txn bench: a single key does not read back as written")
    committed = timed["committed"] + profiled["committed"]
    aborted = timed["aborted"] + profiled["aborted"]
    st = coord.status_snapshot()
    check(committed > 0 and st["committed"] == committed
          and st["aborted"] == aborted and st["decisions"] == committed
          + aborted, f"txn bench: outcomes {committed}/{aborted} against "
          f"the coordinator's {st}")
    check(st["held"] == 0 and st["open_resolves"] == 0,
          f"txn bench: locks left behind: {st}")
    check(timed["unknown"] == profiled["unknown"] == 0,
          "txn bench: a transaction's outcome came back unknown")
    for t in (timed, profiled):
        check(t["stats"]["pending_txns"] == 0, "txn bench: txns pending "
              "at the server's stop")
    lat, wall = timed["lat"], timed["wall_s"]
    txns = timed["committed"] + timed["aborted"]
    return {
        "device": str(dev), "groups": TXN_G, "wire_batch": TXN_B,
        "entry_bytes": cfg.entry_bytes, "log_capacity": cfg.log_capacity,
        "connections": TXN_CONNS, "requests": TXN_CONNS * TXN_REQS,
        "txns": txns, "txn_committed": timed["committed"],
        "txn_aborted": timed["aborted"], "abort_reasons": timed["reasons"],
        "txn_refused": timed["refused"], "txn_unknown": timed["unknown"],
        "abort_rate": timed["aborted"] / max(txns, 1),
        "txn_commit_ms_p50": pct(lat, 50) if lat else None,
        "txn_commit_ms_p99": pct(lat, 99) if lat else None,
        "txn_goodput_per_s": timed["committed"] / wall,
        "single_entries": timed["single_acked"],
        "single_shed": timed["single_shed"],
        "single_goodput_entries_per_s": timed["single_acked"] / wall,
        "lock_conflicts": st["lock_conflicts"],
        "wall_s": wall, "pump_iters": timed["stats"]["pump_iters"],
        "refusals": timed["stats"]["refusals"],
        "profiled": {"requests": TXN_CONNS * TXN_PROFILED_REQS,
                     "txn_committed": profiled["committed"],
                     "txn_aborted": profiled["aborted"], **idle},
        "coordinator": st,
        "k5_launches": {"timed": k5_timed, "all": k5_all},
    }


def txn_drills(dev):
    """``txn_path`` (a): ``txn_run`` on two shards of the card: seed 7
    plain and with ``lease_reads``, each equal to the same run on two CPU
    shards field by field (report, witness, single-key history), both at
    the pinned digest. K5 counted from here. (The ``extra_nemeses`` run
    and the broken variants at seed 0 left the card for the cluster
    path's time; ``tests/test_torch_txn_drill.py`` holds them against
    JAX's on the CPU.)"""
    from raft_tpu_torch.chaos import LINEARIZABLE
    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.transport.group_mesh import GroupMesh

    out, k5 = {}, 0
    for name, seed, kw in (
            ("seed7", 7, {}),
            ("seed7_lease_reads", 7, {"lease_reads": True})):
        c5 = ring_cuda.LAUNCHES["write_window_cols"]
        t0 = time.perf_counter()
        card, rep = chaos_run("txn_run", seed, device=dev,
                              mesh=GroupMesh([dev, dev]), **kw)
        wall = time.perf_counter() - t0
        n5 = ring_cuda.LAUNCHES["write_window_cols"] - c5
        k5 += n5
        row = {"verdict": rep.verdict, "singles": rep.singles.verdict,
               "txns": rep.txns, "committed": rep.committed,
               "aborted": rep.aborted, "conflicts": rep.conflicts,
               "moves": len(rep.moves), "nemeses": rep.nemeses,
               "read_certs": rep.read_certs,
               "commit_digest": rep.commit_digest, "card_wall_s": wall,
               "k5_launches": n5}
        t0 = time.perf_counter()
        cpu, _ = chaos_run("txn_run", seed, device="cpu",
                           mesh=GroupMesh(["cpu", "cpu"]), **kw)
        row["cpu_wall_s"] = time.perf_counter() - t0
        chaos_same(card, cpu, f"txn drill {name}")
        check(rep.verdict == "SERIALIZABLE" and rep.conserved_ok
              and rep.singles.verdict == LINEARIZABLE
              and rep.unresolved == 0 and rep.moves,
              f"txn drill {name}: {rep.summary()}")
        check(rep.commit_digest == TXN_SEED7_DIGEST,
              f"txn drill {name}: digest {rep.commit_digest}, "
              f"pinned {TXN_SEED7_DIGEST}")
        print(f"txn_path: drill {name} {json.dumps(row)}", flush=True)
        out[name] = row
    lease = out["seed7_lease_reads"]["read_certs"]
    check(lease.get("lease", 0) > lease.get("read_index", 0),
          f"txn drill: the lease did not certify most basis reads {lease}")
    check(k5 > 0, "K5 never launched on the txn drills")
    return out, k5


def txn_k5_cases(dev, rng, n=24):
    """K5 against its plain version at ``bench_txn``'s shape (G = 4, C =
    2 048, B = 64, 64-byte entries): random starts (seams included),
    counts and lane masks: the largest error."""
    cfg, G = txn_bench_config(), TXN_G
    C, B, R = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = R * cfg.shard_words
    buf = dev_rand(rng, (G, C, M), dev)
    err = 0
    for i in range(n):
        win = dev_rand(rng, (G, B, M), dev)
        starts = rng.integers(0, C, G)
        if i % 4 == 0:
            starts[:] = C - rng.integers(1, B, G)    # across the seam
        counts = rng.integers(0, B + 1, G)
        err = max(err, k5_case(dev, buf, win, starts, counts,
                               lane_masks(rng, G, M, R))[0])
    return err


def phase_txn_path(dev, card_line):
    """The transaction tier on the card (module doc, 11i): (a) the drills,
    card against CPU; (b) ``bench_txn``'s leg through the wire; (c) K5 at
    the leg's shape against its plain version and timed."""
    import faulthandler

    import torch

    from raft_tpu_torch.core import ring_cuda

    t_phase = time.perf_counter()
    faulthandler.enable()
    res = {"phase": "txn_path", "card": card_line}

    def step(name):
        print(f"txn_path: {name} at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    before = read_counters(dev)
    with WireWatch() as watch:
        step("the drills, card and CPU")
        res["drills"], k5_drill = txn_drills(dev)
        step("bench_txn's leg through the wire")
        res["bench"] = txn_bench_run(dev)
        print(f"txn_path: bench {json.dumps(res['bench'])}", flush=True)
        res["watch"] = watch.check("txn bench")
    after = read_counters(dev)
    others = {k: after[k] - before[k] for k in ("K1", "K2", "K3", "K4")}
    check(not any(others.values()),
          f"the txn path launched a kernel other than K5: {others}")
    check(res["bench"]["k5_launches"]["all"] > 0,
          "K5 never launched behind the txn server")
    step("K5 at the leg's shape")
    rng = np.random.default_rng(SEED + 91)
    res["k5_max_abs_err"] = txn_k5_cases(dev, rng)
    check(res["k5_max_abs_err"] == 0, "K5 differs from its plain version "
          "at bench_txn's shape")
    res["k5_timing"] = k5_timing(txn_bench_config(), TXN_G, dev, rng,
                                 mem_rate(card_line), 21)
    res["k5_launches"] = {"drill": k5_drill,
                          "bench": res["bench"]["k5_launches"]["all"]}
    res["other_kernel_launches"] = others
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


#: cluster_path: the three cluster drills as ``tests/test_cluster.py``
#: runs them (3 child processes, 50 ms heartbeat, 400 ms election
#: timeout), then ``bench.py`` ``bench_cluster``'s goodput and handoff
#: rows (:1978-2330): 900 unbatched single-op writes over 6 connections
#: against the 3-process cluster and against the single-process wire
#: reference (``MultiEngine`` G = 4, B = 8, C = 2 048, 64-byte entries,
#: seed 23, the write gate at 512) on the card
CLUSTER_NODES, CLUSTER_CONNS, CLUSTER_N, CLUSTER_G = 3, 6, 900, 4
#: writes through the survivors while the handoff row's victim is down
#: (``bench_cluster``'s kill row writes at least 300 there)
CLUSTER_GAP_N = 300
#: attempts of the ``lease_stale_round`` variant: it provokes a stale
#: lease read by timing (a reply-delay ramp, a one-sided partition) and
#: misses it in some runs of either package; one catch is the receipt
CLUSTER_LEASE_ATTEMPTS = 5
#: runs of the healthy network drill: one of them must meet every receipt.
#: Its commit digests diverged in 1 of 7 runs on the card's host (PERF.md
#: §6, PR 22), a fault of the reference's drill left in place (ROADMAP
#: §C); a run that misses a receipt is printed with the receipts it
#: missed and the digest detail
CLUSTER_NET_ATTEMPTS = 3


def cluster_bench_config():
    """``bench_cluster``'s single-process reference (``bench.py``
    :2030-2034)."""
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=64, batch_size=8,
                      log_capacity=1 << 11, transport="single", seed=23,
                      admission_max_writes=512)


class ChildGpuWatch:
    """While on, samples every ``raft_tpu_torch.cluster.child`` process this
    process spawned: the ``/dev/nvidia*`` files it holds open (a CUDA context
    opens them) and, once a second, whether ``nvidia-smi`` lists it as a
    compute app. ``result()`` gives the pids seen, those holding the card,
    and whether ``nvidia-smi`` lists this process (it must, or its pids
    are of another namespace)."""

    def __init__(self):
        import threading

        self.pids, self.nvidia, self.smi = set(), {}, set()
        self.samples = 0
        self.smi_ok = True
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def _children():
        """This process's ``cluster.child`` children (the supervisor
        spawns them directly)."""
        import os

        me = os.getpid()
        for d in os.listdir("/proc"):
            if not d.isdigit():
                continue
            try:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    cmd = f.read()
                with open(f"/proc/{d}/stat") as f:
                    ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                continue
            if ppid == me and b"raft_tpu_torch.cluster.child" in cmd:
                yield int(d)

    def _run(self):
        import os

        tick = 0
        while not self._stop.is_set():
            for pid in self._children():
                self.pids.add(pid)
                try:
                    fds = os.listdir(f"/proc/{pid}/fd")
                except OSError:
                    continue
                for fd in fds:
                    try:
                        t = os.readlink(f"/proc/{pid}/fd/{fd}")
                    except OSError:
                        continue
                    if t.startswith("/dev/nvidia"):
                        self.nvidia.setdefault(pid, set()).add(t)
            if tick % 4 == 0 and self.smi_ok:
                try:
                    r = subprocess.run(
                        ["nvidia-smi", "--query-compute-apps=pid",
                         "--format=csv,noheader"], capture_output=True,
                        text=True, timeout=30)
                except (OSError, subprocess.TimeoutExpired):
                    self.smi_ok = False
                else:
                    self.smi |= {int(x) for x in r.stdout.split()
                                 if x.strip().isdigit()}
            self.samples += 1
            tick += 1
            self._stop.wait(0.25)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)

    def result(self):
        import os

        return {"children_seen": len(self.pids), "samples": self.samples,
                "children_with_nvidia_fds": sorted(self.nvidia),
                "children_in_nvidia_smi": sorted(self.pids & self.smi),
                "nvidia_smi_ran": self.smi_ok,
                "nvidia_smi_lists_this_process": os.getpid() in self.smi}


def net_receipts_missing(rep, text):
    """The receipts ``tests/test_cluster.py::TestClusterNetDrill`` asserts
    of a healthy ``cluster_net_run`` that ``rep`` (and its ``--explain``
    text) lacks, by name."""
    from raft_tpu_torch.chaos import LINEARIZABLE

    sts = [st for st in rep.statuses.values() if st]
    need = {
        "linearizable": rep.verdict == LINEARIZABLE and all(
            r.verdict == LINEARIZABLE for r in rep.per_class.values()),
        "digest_ok": rep.digest_ok,
        "kills_partitions": rep.kills >= 1 and rep.partitions >= 1,
        "net_ok": rep.net_ok and rep.frames_delayed >= 1
        and rep.frames_dup >= 1 and rep.conns_torn >= 1
        and rep.redials >= 1 and rep.corrupt_injected >= 1
        and rep.corrupt_dropped >= 1 and rep.stale_round_ignored >= 1
        and rep.demotions >= 1,
        "reelected": rep.reelected and rep.reelect_s is not None,
        "handoff": rep.handoff_ok and rep.generation >= 2
        and rep.segments_adopted >= 1 and rep.rejoined,
        "dialer_status": any("dialer" in st for st in sts) and sum(
            int(st.get("dialer", {}).get("dials", 0)) for st in sts) >= 1,
        "explain": "net_faults_armed" in text and "peer_redial" in text,
    }
    return [k for k, ok in need.items() if not ok]


def cluster_drill_run(fn, seed, **kw):
    """One drill of the port (``raft_tpu_torch.chaos.runner``): (report,
    wall s). A ``ClusterBroken`` (children cannot spawn) fails the run."""
    from raft_tpu_torch.chaos import runner

    t0 = time.perf_counter()
    rep = getattr(runner, fn)(seed, **kw)
    return rep, time.perf_counter() - t0


def cluster_drills():
    """``cluster_path`` (a): ``cluster_run(0)``, ``cluster_storage_run(5)``
    and ``cluster_net_run(7)`` with their broken variants, each holding
    every receipt ``tests/test_cluster.py`` asserts of it, the EIO pair
    printed (not held: ROADMAP §C), while a ``ChildGpuWatch`` checks that
    no child opened the card."""
    import shutil

    from raft_tpu_torch.chaos import LINEARIZABLE, VIOLATION
    from raft_tpu_torch.obs.__main__ import _explain_any

    out = {}

    def row(name, rep, wall, **extra):
        r = {"verdict": rep.verdict, "summary": rep.summary(),
             "wall_s": wall, **extra}
        print(f"cluster_path: drill {name} {json.dumps(r)}", flush=True)
        out[name] = r
        shutil.rmtree(rep.base_dir, ignore_errors=True)

    def linearizable(rep, what):
        check(rep.verdict == LINEARIZABLE and all(
            r.verdict == LINEARIZABLE for r in rep.per_class.values()),
            f"{what}: {rep.summary()}")

    with ChildGpuWatch() as watch:
        rep, wall = cluster_drill_run("cluster_run", 0)
        linearizable(rep, "cluster_run(0)")
        check(rep.nodes == 3 and rep.kills >= 1 and rep.partitions >= 1
              and rep.pauses >= 1 and rep.ops > 0 and rep.flood_ops > 0,
              f"cluster_run(0) faults: {rep.summary()}")
        check(rep.handoff_ok and rep.generation >= 2
              and rep.segments_adopted >= 1 and rep.segments_resealed == 0
              and rep.snap_chunks_in >= 1 and rep.rejoined
              and rep.incarnations >= 2,
              f"cluster_run(0) handoff: {rep.summary()}")
        text = _explain_any(f"{rep.base_dir}/blackbox")
        for word in ("merged timeline", "process incarnations",
                     "cluster_kill9", "child_start", "cluster_spawn"):
            check(word in text, f"cluster_run(0) --explain lacks {word!r}")
        row("seed0", rep, wall, ops=rep.ops,
            read_classes=rep.read_classes, explain_chars=len(text))

        rep, wall = cluster_drill_run("cluster_storage_run", 5)
        linearizable(rep, "cluster_storage_run(5)")
        check(rep.kills >= 1 and rep.partitions >= 1 and rep.restarts >= 2
              and rep.digest_ok, f"cluster_storage_run(5): {rep.summary()}")
        check(rep.wal_truncated >= 1 and rep.manifest_fallbacks >= 1
              and rep.segment_reconstructs >= 1 and rep.disk_full_sheds >= 1
              and rep.stalls >= 1 and rep.handoff_ok
              and rep.segments_resealed == 0,
              f"cluster_storage_run(5) receipts: {rep.summary()}")
        eio = {"fail_stop_ok": rep.fail_stop_ok, "eio_exit": rep.eio_exit,
               "eio_cert": rep.eio_cert,
               "fsync_after_eio": rep.fsync_after_eio}
        print(f"cluster_path: eio {json.dumps(eio)}", flush=True)
        row("storage_seed5", rep, wall, ops=rep.ops, storage_ok=rep.storage_ok,
            **eio)
        for broken in ("fsync_lies", "wal_skip_corrupt"):
            rep, wall = cluster_drill_run("cluster_storage_run", 5,
                                          broken=broken)
            if broken == "fsync_lies":
                check(rep.caught is True and rep.caught_by == "checker"
                      and rep.verdict == VIOLATION,
                      f"fsync_lies not caught: {rep.summary()}")
            else:
                check(rep.caught is True and rep.caught_by == "digest"
                      and not rep.digest_ok
                      and "DIVERGED" in rep.digest_detail,
                      f"wal_skip_corrupt not caught: {rep.summary()}")
            row(f"storage_seed5_{broken}", rep, wall, caught=rep.caught)

        tries = []
        for attempt in range(CLUSTER_NET_ATTEMPTS):
            rep, wall = cluster_drill_run("cluster_net_run", 7)
            text = _explain_any(f"{rep.base_dir}/blackbox")
            bad = net_receipts_missing(rep, text)
            tries.append(bad)
            row(f"net_seed7_{attempt}", rep, wall, ops=rep.ops,
                reelect_s=rep.reelect_s, digest_detail=rep.digest_detail,
                missing=bad)
            if not bad:
                break
        check(not tries[-1], f"cluster_net_run(7) missed receipts in "
              f"{len(tries)} runs: {tries}")
        out["net_seed7_attempts"] = tries
        rep, wall = cluster_drill_run("cluster_net_run", 7,
                                      broken="peer_no_crc")
        check(rep.caught is True and rep.caught_by == "digest"
              and not rep.digest_ok and "DIVERGED" in rep.digest_detail,
              f"peer_no_crc not caught: {rep.summary()}")
        row("net_seed7_peer_no_crc", rep, wall, caught=rep.caught)
        tries = []
        for attempt in range(CLUSTER_LEASE_ATTEMPTS):
            rep, wall = cluster_drill_run("cluster_net_run", 7,
                                          broken="lease_stale_round")
            tries.append(bool(rep.caught))
            row(f"net_seed7_lease_stale_round_{attempt}", rep, wall,
                caught=rep.caught, caught_by=rep.caught_by)
            if rep.caught:
                check(rep.caught_by == "checker"
                      and rep.verdict == VIOLATION,
                      f"lease_stale_round: {rep.summary()}")
                break
        check(any(tries), f"lease_stale_round never caught in {len(tries)} "
              "attempts")
        out["lease_stale_round_attempts"] = tries
    gpu = watch.result()
    print(f"cluster_path: children and the card {json.dumps(gpu)}",
          flush=True)
    check(gpu["children_seen"] >= 3, f"the watch saw no drill child: {gpu}")
    check(not gpu["children_with_nvidia_fds"]
          and not gpu["children_in_nvidia_smi"],
          f"a cluster child opened the card: {gpu}")
    out["children_and_the_card"] = gpu
    return out


def cluster_bench_run(dev):
    """``cluster_path`` (b): ``bench_cluster``'s goodput row against the
    3-process cluster beside the same shape against the single-process
    wire reference on ``dev`` (a warm-up round, the timed round, then the
    same round under torch.profiler for the card's idle share), then the
    handoff row: the goodput's leader killed, ``CLUSTER_GAP_N`` writes
    through the survivors, the victim respawned on its own dirs (adopting
    its segments), killed again, and respawned on a wiped dir. Checks:
    every reference write acknowledged and applied as sent; the cluster's
    writes acknowledged, committed on every node, commit digests agreeing;
    both restarts caught up, the adopted one resealing nothing."""
    import asyncio
    import random as _random
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch.chaos.runner import _digest_agreement
    from raft_tpu_torch.cluster import ClusterSupervisor
    from raft_tpu_torch.cluster.netfault import write_net_plan
    from raft_tpu_torch.core import ring_cuda
    from raft_tpu_torch.multi import MultiEngine, Router
    from raft_tpu_torch.net import (IngestServer, RouterBackend, WireClient,
                                    WireRefused)
    from raft_tpu_torch.net.client import WireDisconnected, WireError

    cuda = torch.device(dev).type == "cuda"
    keys = [b"bk%d" % i for i in range(32)]
    errs = (WireRefused, WireDisconnected, WireError, ConnectionError,
            OSError)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # ---- (b1) the single-process reference -------------------------------
    cfg = cluster_bench_config()
    eng = MultiEngine(cfg, CLUSTER_G, device=dev)
    eng.seed_leaders()
    router = Router(eng, drive=False)
    applied = [{} for _ in range(CLUSTER_G)]
    for g in range(CLUSTER_G):
        eng.register_apply(g, lambda i, p, g=g: applied[g].__setitem__(i, p))
    sent = []

    async def ref_round(tag, n, prof=False):
        srv = IngestServer(RouterBackend(router),
                           drive_quantum_s=cfg.heartbeat_period)
        port = await srv.start()
        cs = [await WireClient("127.0.0.1", port).connect()
              for _ in range(CLUSTER_CONNS)]
        lat = []

        async def w(ci, c):
            ok = 0
            for j in range(n // CLUSTER_CONNS):
                payload = (b"%s%d-%d" % (tag, ci, j)).ljust(
                    cfg.entry_bytes, b"\0")
                b0 = time.perf_counter()
                try:
                    r = await c.submit(keys[j % len(keys)], payload)
                except errs:
                    continue
                lat.append((time.perf_counter() - b0) * 1e3)
                sent.append((r.group, r.seq, payload))
                ok += 1
            return ok

        sync()
        p = None
        if prof and cuda:
            p = profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
            p.__enter__()
        t0 = time.perf_counter()
        acked = sum(await asyncio.gather(*[w(ci, c) for ci, c
                                           in enumerate(cs)]))
        sync()
        wall = time.perf_counter() - t0
        res = {"writes": n, "acked": acked, "wall_s": wall,
               "goodput_eps": acked / wall, "e2e_ms_p50": pct(lat, 50),
               "e2e_ms_p99": pct(lat, 99)}
        if p is not None:
            p.__exit__(None, None, None)
            busy = sum(e.time_range.elapsed_us() for e in p.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
            res.update({"device_busy_ms": busy / 1e3,
                        "device_idle_share": 1.0 - busy / (wall * 1e6)})
        for c in cs:
            await c.close()
        res["pump_iters"] = srv.stats()["pump_iters"]
        await srv.stop()
        return res

    k5 = ring_cuda.LAUNCHES["write_window_cols"]
    warm = asyncio.run(ref_round(b"w", 60))
    k5_warm = ring_cuda.LAUNCHES["write_window_cols"] - k5
    timed = asyncio.run(ref_round(b"t", CLUSTER_N))
    k5_timed = ring_cuda.LAUNCHES["write_window_cols"] - k5 - k5_warm
    profiled = asyncio.run(ref_round(b"p", CLUSTER_N, prof=True))
    k5_ref = ring_cuda.LAUNCHES["write_window_cols"] - k5
    eng.run_for(4 * cfg.heartbeat_period)
    for g, seq, payload in sent:
        check(applied[g].get(seq) == payload,
              f"reference: group {g} entry {seq} not applied as sent")
    check(timed["acked"] == CLUSTER_N and profiled["acked"] == CLUSTER_N,
          f"reference: writes refused {timed['acked']} {profiled['acked']}")
    reference = {"warm_up": warm, "timed": timed, "profiled": profiled,
                 "k5_launches": {"warm_up": k5_warm, "timed": k5_timed,
                                 "all": k5_ref},
                 "applied_as_sent": len(sent)}
    print(f"cluster_path: reference {json.dumps(reference)}", flush=True)

    # ---- (b2) the 3-process cluster --------------------------------------
    base = tempfile.mkdtemp(prefix="smoke-cluster-")
    sup = ClusterSupervisor(
        CLUSTER_NODES, base, heartbeat_s=0.05, election_timeout_s=0.4,
        snap_threshold=24, segment_entries=16, hot_entries=32)
    for i in range(CLUSTER_NODES):
        write_net_plan(sup.node_dir(i), {"seed": 23})
    try:
        sup.start_all()
        deadline = time.monotonic() + 15.0
        while sup.leader() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        check(sup.leader() is not None, "the cluster elected no leader")
        addr_map = sup.addr_map()

        async def connect(i):
            host, _, port = sup.addr(i).rpartition(":")
            return await WireClient(host, int(port), retries=40,
                                    max_backoff_s=0.25, addr_map=addr_map,
                                    rng=_random.Random(f"smoke:{i}")
                                    ).connect()

        def status(i):
            return sup.status(i) or {}

        def fsyncs():
            return sum(int(status(i).get("wal_fsyncs", 0))
                       for i in range(CLUSTER_NODES))

        async def writes(n, tag, nodes):
            cs = [await connect(nodes[i % len(nodes)])
                  for i in range(CLUSTER_CONNS)]
            lat = []

            async def w(ci, c):
                ok = 0
                for j in range(n // CLUSTER_CONNS):
                    b0 = time.perf_counter()
                    try:
                        await c.submit(keys[j % len(keys)],
                                       b"%s%d-%d" % (tag, ci, j))
                    except errs:
                        continue
                    lat.append((time.perf_counter() - b0) * 1e3)
                    ok += 1
                return ok

            t0 = time.perf_counter()
            acked = sum(await asyncio.gather(*[w(ci, c) for ci, c
                                               in enumerate(cs)]))
            wall = time.perf_counter() - t0
            for c in cs:
                await c.close()
            return acked, wall, lat

        f0 = fsyncs()
        acked, wall, lat = asyncio.run(writes(
            CLUSTER_N, b"c", list(range(CLUSTER_NODES))))
        time.sleep(0.7)                      # one status-publish period
        dsync = max(fsyncs() - f0, 1)
        eps = acked / wall
        goodput = {
            "processes": CLUSTER_NODES, "connections": CLUSTER_CONNS,
            "entries": acked, "wall_s": wall,
            "e2e_ms_p50": pct(lat, 50), "e2e_ms_p99": pct(lat, 99),
            "wal_fsync_batched": CLUSTER_NODES * acked / dsync,
            "cluster_goodput_eps": eps,
            "singleproc_goodput_eps": timed["goodput_eps"],
            "cluster_vs_singleproc": eps / timed["goodput_eps"],
        }
        sts = {i: sup.status(i) for i in range(CLUSTER_NODES)}
        ok, detail = _digest_agreement(sts)
        commits = [int((s or {}).get("commit", 0)) for s in sts.values()]
        goodput.update({"commits": commits, "digest_detail": detail})
        print(f"cluster_path: goodput {json.dumps(goodput)}", flush=True)
        check(acked == CLUSTER_N, f"cluster: {acked} of {CLUSTER_N} acked")
        check(ok and min(commits) >= acked,
              f"cluster: commits {commits}, digests {detail}")

        # ---- (b3) restart handoff vs re-seal -----------------------------
        victim = sup.leader()
        check(victim is not None, "no leader before the handoff row")
        sup.kill9(victim)
        live = [i for i in range(CLUSTER_NODES) if i != victim]
        gap, _, _ = asyncio.run(writes(CLUSTER_GAP_N, b"g", live))

        def timed_restart(budget_s=30.0):
            time.sleep(0.7)
            target = max(int(status(i).get("commit", 0)) for i in live)
            t0 = time.monotonic()
            sup.restart(victim, wait_ready=True)
            t_ready = time.monotonic()
            caught = False
            while time.monotonic() < t_ready + budget_s:
                if sup.alive(victim) and \
                        int(status(victim).get("commit", 0)) >= target:
                    caught = True
                    break
                time.sleep(0.05)
            t_caught = time.monotonic()
            st = status(victim)
            tier = st.get("tier", {})
            return {"boot_s": t_ready - t0, "catchup_s": t_caught - t_ready,
                    "total_s": t_caught - t0, "caught_up": caught,
                    "target": target,
                    "generation": int(st.get("generation", 0)),
                    "segments_adopted": int(tier.get("segments_adopted", 0)),
                    "segments_resealed": int(tier.get("segments_resealed",
                                                      0)),
                    "segments_sealed": int(tier.get("segments_sealed", 0)),
                    "snap_chunks_in": int(st.get("snap_chunks_in", 0))}

        handoff = timed_restart()
        sup.kill9(victim)
        shutil.rmtree(sup.node_dir(victim), ignore_errors=True)
        reseal = timed_restart()
        handoff_row = {
            "victim": victim, "gap_writes": gap,
            "handoff_s": handoff["catchup_s"],
            "reseal_s": reseal["catchup_s"],
            "handoff_ratio": handoff["catchup_s"] / max(reseal["catchup_s"],
                                                        1e-9),
            "handoff": handoff, "reseal": reseal}
        print(f"cluster_path: handoff {json.dumps(handoff_row)}", flush=True)
        check(gap == CLUSTER_GAP_N, f"handoff: {gap} gap writes acked")
        check(handoff["caught_up"] and handoff["generation"] >= 2
              and handoff["segments_adopted"] >= 1
              and handoff["segments_resealed"] == 0,
              f"handoff: the adopted restart {handoff}")
        check(reseal["caught_up"] and reseal["generation"] == 1,
              f"handoff: the wiped restart {reseal}")
    finally:
        sup.stop_all()
        shutil.rmtree(base, ignore_errors=True)
    return {"reference": reference, "goodput": goodput,
            "handoff": handoff_row, "k5_launches": k5_ref}


def cluster_k5_cases(dev, rng, n=24):
    """K5 against its plain version at the reference's shape (G = 4, C =
    2 048, B = 8, 64-byte entries): random starts (seams included),
    counts and lane masks: the largest error."""
    cfg, G = cluster_bench_config(), CLUSTER_G
    C, B, R = cfg.log_capacity, cfg.batch_size, cfg.rows
    M = R * cfg.shard_words
    buf = dev_rand(rng, (G, C, M), dev)
    err = 0
    for i in range(n):
        win = dev_rand(rng, (G, B, M), dev)
        starts = rng.integers(0, C, G)
        if i % 4 == 0:
            starts[:] = C - rng.integers(1, B, G)    # across the seam
        counts = rng.integers(0, B + 1, G)
        err = max(err, k5_case(dev, buf, win, starts, counts,
                               lane_masks(rng, G, M, R))[0])
    return err


def phase_cluster_path(dev, card_line):
    """The cluster tier (module doc, 11j): (a) the drills with three real
    child processes, no child on the card; (b) ``bench_cluster``'s goodput
    and handoff rows, the reference on the card; (c) K5 at the
    reference's shape against its plain version and timed. Only K5 may
    launch, and only in (b)'s reference."""
    import faulthandler

    import torch

    from raft_tpu_torch.core import ring_cuda

    t_phase = time.perf_counter()
    faulthandler.enable()
    res = {"phase": "cluster_path", "card": card_line}

    def step(name):
        print(f"cluster_path: {name} at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    before = read_counters(dev)
    with WireWatch() as watch:
        step("the drills")
        k5 = ring_cuda.LAUNCHES["write_window_cols"]
        res["drills"] = cluster_drills()
        check(ring_cuda.LAUNCHES["write_window_cols"] == k5,
              "a cluster drill launched K5")
        step("bench_cluster's goodput and handoff rows")
        res["bench"] = cluster_bench_run(dev)
        res["watch"] = watch.check("cluster bench")
    after = read_counters(dev)
    others = {k: after[k] - before[k] for k in ("K1", "K2", "K3", "K4")}
    check(not any(others.values()),
          f"the cluster path launched a kernel other than K5: {others}")
    check(res["bench"]["k5_launches"] > 0,
          "K5 never launched behind the reference's server")
    step("K5 at the reference's shape")
    rng = np.random.default_rng(SEED + 97)
    res["k5_max_abs_err"] = cluster_k5_cases(dev, rng)
    check(res["k5_max_abs_err"] == 0, "K5 differs from its plain version "
          "at the cluster reference's shape")
    res["k5_timing"] = k5_timing(cluster_bench_config(), CLUSTER_G, dev, rng,
                                 mem_rate(card_line), 21)
    res["k5_launches"] = res["bench"]["k5_launches"]
    res["other_kernel_launches"] = others
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


# ------------------------------------ 11k. the lapped flight and the faults
#: ``bench.py``'s lapped chunk (``bench_client_latency`` :823-870): rings a
#: launch, and the chunks after the warm one that are timed; beside it the
#: one-ring chunk (:796-821) and its timed chunks
LAPS = 8
LAPS_TIMED = 2
ONE_RING_TIMED = 3
#: (b)'s engine: 8 laps of a 4 096-slot ring (T = 32) card against CPU
LAPS_SMALL_CAPACITY = 4096
LAPS_SMALL_CHUNKS = (4096, 8 * 4096, 8 * 4096 + 4096, 2048)
#: (c)'s fault schedules (``tests/_torch_faults.py``), card against CPU:
#: the ring-lap chaos reproducers, an EC lap-chaos seed, the pipelined
#: multi-lap chaos, one partition and one PreVote schedule
LAP_CHAOS_RUNS = (("run_lap_chaos", (22,)), ("run_lap_chaos", (25,)),
                  ("run_ec_lap_chaos", (12,)),
                  ("run_pipelined_lap_chaos", (3,)),
                  ("partition_safety", (0, 5)), ("pv_chaos_mix", ()))
#: the kernels whose launches laps_path reports (``read_engine_ec_counters``)
LAPS_KERNELS = ("K1", "K2", "K3", "K4", "K6 encode", "K6 decode", "K7")


def lapped_config(capacity, laps):
    from raft_tpu_torch.config import RaftConfig

    return RaftConfig(n_replicas=3, entry_bytes=256, batch_size=1024,
                      log_capacity=capacity, transport="single",
                      pipeline_max_laps=laps)


class ChunkClock:
    """The parts of a timed ``submit_pipelined`` chunk: the host's pack
    and fold (with the upload), each flight (CUDA events on the card, the
    host wall of the call with its result read), and the chunk's
    bookkeeping (seqs, commit stamps, the archive); the rest of the wall
    is the intake (one ``submit`` an entry) and the gate."""

    def __init__(self, e, dev):
        import raft_tpu_torch.raft.engine as engine_mod

        self.e, self.cuda = e, str(dev) != "cpu"
        self.flights, self.parts = [], {}
        self.mod, self.fold = engine_mod, engine_mod.fold_batch
        self.pack, self.account = e._pack_entries, e._account_chunk_prefix
        self.fly = e.t.replicate_pipeline
        engine_mod.fold_batch = self._wrap("fold_batch_ms", self.fold)
        e._pack_entries = self._wrap("pack_entries_ms", self.pack)
        e._account_chunk_prefix = self._wrap("bookkeeping_ms", self.account)
        e.t.replicate_pipeline = self._flight

    def _wrap(self, key, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.parts[key] = self.parts.get(key, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
        return timed

    def _flight(self, state, payloads, counts, *a, **k):
        import torch

        self.flights.append(int(counts.shape[0]))
        t0 = time.perf_counter()
        if self.cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out = self.fly(state, payloads, counts, *a, **k)
        if self.cuda:
            ev[1].record()
            torch.cuda.synchronize()
            self.parts["flight_events_ms"] = self.parts.get(
                "flight_events_ms", 0.0) + ev[0].elapsed_time(ev[1])
        self.parts["flight_call_ms"] = self.parts.get(
            "flight_call_ms", 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def start(self):
        self.flights.clear()
        self.parts.clear()

    def close(self):
        self.mod.fold_batch = self.fold
        for name in ("_pack_entries", "_account_chunk_prefix"):
            self.e.__dict__.pop(name, None)
        self.e.t.replicate_pipeline = self.fly


def lapped_chunks(cfg, dev, chunks, seed, clock=False):
    """The engine at ``cfg`` on ``dev``: an election, then one
    ``submit_pipelined`` chunk of seeded entries per entry count in
    ``chunks``; after each, the flights it launched (and with ``clock``
    its wall and the ``ChunkClock`` parts). At the end the last ring is
    read back through ``committed_entries`` and from both followers, each
    SHA-256 against the input's. Returns (result, fingerprint): the
    fingerprint is what a card run and a CPU run must agree on (nodelog
    lines, flights, watermark, read-back hashes, every state leaf)."""
    import torch

    from raft_tpu_torch.core.state import log_entries, state_to_numpy
    from raft_tpu_torch.raft import RaftEngine
    from raft_tpu_torch.transport.device import SingleDeviceTransport

    lines = []
    e = RaftEngine(cfg, SingleDeviceTransport(cfg, device=dev),
                   trace=lines.append)
    ck = ChunkClock(e, dev)
    rng = np.random.default_rng(seed)
    E, C = cfg.entry_bytes, cfg.log_capacity
    sent = []
    runs = []
    try:
        e.run_until_leader()
        for n in chunks:
            blob = rng.integers(0, 256, n * E, dtype=np.uint8).tobytes()
            sent.append(blob)
            ps = [blob[i * E:(i + 1) * E] for i in range(n)]
            ck.start()
            if ck.cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            seqs = e.submit_pipelined(ps)
            if ck.cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(e.is_durable(seqs[-1]), f"a chunk of {n} is not durable")
            run = {"entries": n, "flights": list(ck.flights),
                   "watermark": e.commit_watermark}
            if clock:
                parts = dict(ck.parts)
                host = wall * 1e3 - parts.get("flight_events_ms", 0.0)
                known = sum(v for k, v in parts.items()
                            if k not in ("flight_events_ms",))
                parts["intake_and_gate_ms"] = wall * 1e3 - known
                run.update(wall_ms=wall * 1e3, entries_per_s_wall=n / wall,
                           host_ms=host, parts=parts)
            runs.append(run)
    finally:
        ck.close()
    whole = b"".join(sent)
    wm = e.commit_watermark
    check(wm == len(whole) // E, f"committed {wm} of {len(whole) // E}")
    lo = max(1, wm - C + 1)
    want = hashlib.sha256(whole[(lo - 1) * E:wm * E]).hexdigest()
    got = {"committed_entries": hashlib.sha256(
        e.committed_entries(lo, wm).tobytes()).hexdigest()}
    for r in range(cfg.rows):
        if r != e.leader_id:
            got[f"row{r}"] = hashlib.sha256(
                log_entries(e.state, r, lo, wm).tobytes()).hexdigest()
    for k, v in got.items():
        check(v == want, f"lapped chunks: {k}'s last ring differs from the "
                         "input's")
    fp = {"lines": lines, "flights": [r["flights"] for r in runs],
          "watermark": wm, "read_back": got,
          "state": state_to_numpy(e.state)}
    return {"chunks": runs, "last_ring": {"lo": lo, "hi": wm,
                                          "sha256": want,
                                          "readers": sorted(got)}}, fp


def lapped_north_star(dev):
    """(a) ``bench.py``'s lapped chunk and its one-ring baseline at the
    north star (3 replicas, 256-byte entries, B = 1 024, C = 32 768): a
    warm chunk, then timed chunks; each timed lapped chunk must ride
    exactly one launch of LAPS·C/B steps, each timed one-ring chunk one
    of C/B."""
    C = 32768
    out = {}
    for name, laps, timed in (("one_ring", 1, ONE_RING_TIMED),
                              ("lapped", LAPS, LAPS_TIMED)):
        cfg = lapped_config(C, laps)
        zero_ec_counters(dev)
        res, _ = lapped_chunks(cfg, dev, [laps * C] * (1 + timed),
                               SEED + 120 + laps, clock=True)
        T = laps * C // cfg.batch_size
        for run in res["chunks"][1:]:
            check(run["flights"] == [T],
                  f"{name}: a timed chunk launched {run['flights']}, not "
                  f"one flight of {T} steps")
        timed_runs = res["chunks"][1:]
        best = min(timed_runs, key=lambda r: r["wall_ms"])
        res.update(laps=laps, steps_per_flight=T,
                   launches=read_engine_ec_counters(dev),
                   best_wall_ms=best["wall_ms"],
                   best_entries_per_s_wall=best["entries_per_s_wall"])
        check(res["launches"]["K4"] >= timed,
              f"{name}: K4 launched {res['launches']['K4']} times")
        out[name] = res
    return out


def lapped_k4(dev, rate, reps=21):
    """K4 at the lapped shape (T = LAPS·C/B = 256 steps at the north
    star): held against its plain version on one flight, then timed (the
    profiler's device time behind K3's plan), beside its byte bound (only
    the last lap's windows reach the ring) and its ``index_copy_`` +
    ``fill_`` yardstick at that shape."""
    import torch

    from raft_tpu_torch.core import step_cuda as sc

    cfg = lapped_config(32768, LAPS)
    C, B, L = cfg.log_capacity, cfg.batch_size, cfg.rows
    T = LAPS * C // B
    rng = np.random.default_rng(SEED + 131)
    st = steady_state(cfg, dev, 5 * B, rng=rng)
    wrote, err, commit = flight_case(cfg, dev, rng, st, T, T, [B] * T,
                                     [1] * L, [0] * L, True)
    check(wrote and err == 0 and commit == 5 * B + T * B,
          f"K4 at T = {T}: wrote {wrote}, max_abs_err {err}, commit "
          f"{commit}")
    vecs = sc.pack(st)
    wins = torch.stack([rand_window(rng, B, cfg.rows * cfg.shard_words, dev)
                        for _ in range(T)])
    counts = torch.full((T,), B, dtype=torch.int32, device=dev)
    al = torch.ones(L, dtype=torch.bool, device=dev)
    sl = torch.zeros(L, dtype=torch.bool, device=dev)
    prm = sc.step_params(0, 1, 1, 0, 0, cfg.commit_quorum, L)
    o3 = torch.zeros(L + 5, dtype=torch.int32, device=dev)
    (ms, call_ms), plain_ms, nbytes = k4_timing(
        cfg, st, vecs, wins, counts, al, sl, prm, sc.pick_br(B, C), o3, reps)
    library = k4_yardstick_ms(st, vecs, wins, reps)
    return {"steps": T, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": nbytes / rate * 1e3, "library_ms": library,
            "window_stack_bytes": int(wins.numel()) * 4}


def fault_schedules():
    """``tests/_torch_faults.py`` (the JAX package's fault schedules
    written against the engine API; it imports no JAX), loaded from its
    path: an installed package named ``tests`` may come first on
    ``sys.path``."""
    import importlib.util

    name = "raft_tpu_torch_fault_schedules"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, HERE / "tests" / "_torch_faults.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


def fault_run(name, args):
    """A ``card_vs_cpu`` runner of one schedule of
    ``tests/_torch_faults.py`` through the port's engine: its facts, and
    as its fingerprint ``observe``'s fields, the schedule's own
    observations and every state leaf."""
    def run(cfg, where, plan, timed=False):
        from raft_tpu_torch.core.state import state_to_numpy

        F = fault_schedules()
        pkg = F.package("port", where)
        e, extra = getattr(F, name)(pkg, *args)
        obs = F.observe(pkg, e)
        facts = {"watermark": obs["watermark"], "lines": len(obs["lines"]),
                 "terms": len(obs["leaders_by_term"]),
                 "ring_floor": obs["ring_floor"],
                 "archive_checked": obs["archive_checked"]}
        return facts, dict(obs, extra=extra, state=state_to_numpy(e.state))
    return run


def lapped_run(cfg, where, chunks, timed=False):
    """A ``card_vs_cpu`` runner of ``lapped_chunks``."""
    return lapped_chunks(cfg, where, chunks, SEED + 140, clock=timed)


def phase_laps_path(dev, card_line):
    """The lapped flight and the engine's fault paths (module doc, 11k):
    (a) ``bench.py``'s lapped chunk at the north star with its one-ring
    baseline; K4 at T = 256 against its plain version, timed beside its
    bound and yardstick; (b) the lapped engine at C = 4 096 on the card
    against the CPU; (c) the fault schedules card against CPU."""
    import torch

    t_phase = time.perf_counter()
    res = {"phase": "laps_path", "card": card_line}

    def step(name):
        print(f"laps_path: {name} at "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    rate = mem_rate(card_line)
    step("(a) the lapped chunk")
    res["north_star"] = lapped_north_star(dev)
    step("(a) K4 at T = 256")
    res["k4_lapped"] = lapped_k4(dev, rate)
    # (b) 8 laps of a 4 096-slot ring, card against CPU
    step("(b) the lapped engine, card vs CPU")
    cfg = lapped_config(LAPS_SMALL_CAPACITY, LAPS)
    card, small_launches, walls, _ = card_vs_cpu(
        lapped_run, cfg, dev, LAPS_SMALL_CHUNKS,
        "the lapped engine at C = 4 096")
    T = LAPS * LAPS_SMALL_CAPACITY // cfg.batch_size
    flights = [c["flights"] for c in card["chunks"]]
    check(any(T in f for f in flights),
          f"the lapped engine never flew {T} steps: {flights}")
    res["engine_small"] = dict(card, launches=small_launches, walls_s=walls,
                               card_equals_cpu=True)
    engine_laps = {k: sum(r["launches"][k] for r in
                          res["north_star"].values()) + small_launches[k]
                   for k in LAPS_KERNELS}
    # (c) the fault schedules, card against CPU
    chaos = {k: 0 for k in LAPS_KERNELS}
    res["faults"] = {}
    for name, args in LAP_CHAOS_RUNS:
        step(f"(c) {name}{args}")
        facts, launches, walls, _ = card_vs_cpu(
            fault_run(name, args), None, dev, None, f"{name}{args}")
        for k in LAPS_KERNELS:
            chaos[k] += launches[k]
        res["faults"][f"{name}{args}"] = dict(facts, launches=launches,
                                             walls_s=walls,
                                             card_equals_cpu=True)
    # the EC engine encodes its windows with K7 and steps them with K2
    # (K2·ec's in-kernel parity is the scans' mode, not the engine's)
    for k in ("K1", "K2", "K3", "K4", "K6 encode", "K7"):
        check(chaos[k] > 0, f"lap chaos: {k} never launched: {chaos}")
    res["launches"] = {"engine_laps": engine_laps, "lap_chaos": chaos}
    torch.cuda.synchronize()
    res["phase_s"] = time.perf_counter() - t_phase
    emit(res)
    return res


#: phases ``--only=a,b`` runs alone (after the card and the build): the
#: kernels against their plain versions, the mesh engine's (1-D and
#: 2-D), and the resident main paths whose host code the mesh engine's
#: seam runs through (for comparing two trees in turns)
ONLY_PHASES = {"kernels": lambda dev: phase_kernels(ns_config(), dev),
               "mesh_kernels": lambda dev: phase_mesh_kernels(
                   ns_config(), ec_config(), dev),
               "main_path": lambda dev: phase_main_path(ns_config(), dev),
               "engine_main_path":
               lambda dev: phase_engine_main_path(ns_config(), dev),
               "kv_main_path": phase_kv_main_path,
               "engine_mesh_path": phase_engine_mesh_path,
               "engine_mesh_ec_path": phase_engine_mesh_ec_path,
               "mesh_engine_card_equals_cpu":
               phase_mesh_engine_card_equals_cpu,
               "engine_mesh2d_path": phase_engine_mesh2d_path,
               "engine_mesh2d_ec_path": phase_engine_mesh2d_ec_path,
               "mesh2d_card_equals_cpu": phase_mesh2d_card_equals_cpu,
               "group_mesh_path": phase_group_mesh_path,
               "group_mesh_card_equals_cpu":
               phase_group_mesh_card_equals_cpu,
               "obs_planes_path":
               lambda dev: phase_obs_planes_path(dev, card_query()),
               "chaos_path":
               lambda dev: phase_chaos_path(dev, card_query()),
               "wire_path":
               lambda dev: phase_wire_path(dev, card_query()),
               "txn_path":
               lambda dev: phase_txn_path(dev, card_query()),
               "cluster_path":
               lambda dev: phase_cluster_path(dev, card_query()),
               "laps_path":
               lambda dev: phase_laps_path(dev, card_query())}


def main() -> int:
    if not (HERE / "raft_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py needs the repository around it: "
              "raft_tpu_torch/ was not found beside it", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card_line = phase_card()
    phase_build()
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]
    if only:
        # a development run of some phases: no kernel table, no last line
        for name in only[0]:
            ONLY_PHASES[name](dev)
        emit({"profile_loss": PROFILE_LOSS})
        return 0
    cfg = ns_config()
    errs = phase_kernels(cfg, dev)
    main_res = phase_main_path(cfg, dev)
    timing = phase_timing(cfg, dev, card_line)
    c4_main = phase_config4_main_path(dev)
    engine_main = phase_engine_main_path(cfg, dev)
    engine_fused = phase_engine_fused_path(dev)
    engine_obs = phase_engine_obs_path(dev)
    engine_obs_small = phase_obs_card_equals_cpu(dev)
    c5 = phase_config5_storm(dev)
    phase_native_codec(card_line)
    engine_tiered = phase_engine_tiered_path(dev)
    engine_dev_obs = phase_engine_device_obs_path(dev)
    ecfg = ec_config()
    ec_errs = phase_ec_kernels(ecfg, dev)
    ec_main = phase_ec_main_path(ecfg, dev)
    ec_timing = phase_ec_timing(ecfg, dev, card_line)
    engine_ec = phase_engine_ec_path(dev)
    engine_ec_small = phase_engine_ec_card_equals_cpu(dev)
    kv_main = phase_kv_main_path(dev)
    kv_small = phase_kv_card_equals_cpu(dev)
    ec_member = phase_ec_membership_card_equals_cpu(dev)
    group_errs = phase_group_kernels(dev)
    group_main = phase_group_main_path(dev)
    group_timing = phase_group_timing(dev, card_line)
    engine_multi = phase_engine_multi_path(dev)
    engine_multi_fused = phase_engine_multi_fused_path(dev)
    multi_small = phase_multi_card_equals_cpu(dev)
    gmesh = phase_group_mesh_path(dev)
    gmesh_small = phase_group_mesh_card_equals_cpu(dev)
    planes = phase_obs_planes_path(dev, card_line)
    chaos = phase_chaos_path(dev, card_line)
    wire = phase_wire_path(dev, card_line)
    txn = phase_txn_path(dev, card_line)
    cluster = phase_cluster_path(dev, card_line)
    laps = phase_laps_path(dev, card_line)
    mesh_errs = phase_mesh_kernels(cfg, ecfg, dev)
    mesh_kernel_times = time_mesh_kernels(
        cfg, dev, np.random.default_rng(SEED + 31), 21, mem_rate(card_line))
    mesh_main = phase_mesh_main_path(cfg, dev)
    phase_mesh_ec_path(ecfg, dev)
    engine_mesh = {"engine_mesh": phase_engine_mesh_path(dev),
                   "engine_mesh_ec": phase_engine_mesh_ec_path(dev),
                   "mesh_engine_card_equals_cpu":
                   phase_mesh_engine_card_equals_cpu(dev),
                   "engine_mesh2d": phase_engine_mesh2d_path(dev),
                   "engine_mesh2d_ec": phase_engine_mesh2d_ec_path(dev),
                   "mesh2d_card_equals_cpu":
                   phase_mesh2d_card_equals_cpu(dev)}
    mesh_timing = phase_mesh_timing(cfg, dev, card_line, mesh_kernel_times,
                                    mesh_main)
    kernels = []
    for table, err, main, tim in ((KERNELS, errs, main_res, timing),
                                  (EC_KERNELS, ec_errs, ec_main, ec_timing),
                                  (MESH_KERNELS, mesh_errs, mesh_main,
                                   mesh_timing)):
        for key, name, src, replaces in table:
            t = tim[key]
            by_path = {"main": main["launches"][key]}
            if main is main_res and key in ("K1", "K3"):
                # config 4's programs run K1 (the ticks) and K3 (the
                # flights) on their own main path
                by_path["config4"] = sum(c4_main[p]["launches"][key]
                                         for p in C4_PROGRAMS)
            if main is main_res:
                # launched by the engine: its north-star path, and K1/K2
                # in config 5's storm on the card
                by_path["engine"] = engine_main["launches"][key]
                if key in ("K1", "K2"):
                    # the engine with K-tick fusion (K1 in the replayed
                    # graphs, K1/K2 in the ticks around the windows), and
                    # its reduced run on the card against the CPU
                    by_path["engine_fused"] = \
                        engine_fused["launches"][key]
                    by_path["engine_fused_card_equals_cpu"] = \
                        engine_fused["card_equals_cpu_launches"][key]
                # the engine with the observability plane attached, and its
                # reduced run on the card against the CPU
                by_path["engine_obs"] = engine_obs["launches"][key]
                by_path["engine_obs_card_equals_cpu"] = \
                    engine_obs_small["launches"][key]
                if key in ("K1", "K2"):
                    by_path["config5"] = c5["launches"][key]
                if planes["launches"].get(key):
                    # the compile, memory and capture planes' engine
                    # runs (K1 in the graphs) and their K3 flights
                    by_path["obs_planes"] = planes["launches"][key]
                if key in ("K1", "K2"):
                    # the chaos harness: the torture runs and drills at
                    # the torture configs, then the north-star widths
                    by_path["chaos_torture"] = \
                        chaos["launches_torture"][key]
                    by_path["chaos_northstar"] = \
                        chaos["launches_northstar"][key]
                    # the net tier: the north star behind the
                    # EngineBackend, and the serial pin's card runs
                    by_path["wire_engine"] = \
                        wire["engine"]["launches"][key]
                    by_path["wire_serial"] = \
                        wire["serial"]["launches"][key]
                # the replicated KV store under member masks, and its
                # reduced run on the card against the CPU
                by_path["kv"] = kv_main["launches"][key]
                by_path["kv_card_equals_cpu"] = kv_small["launches"][key]
                # the tiered archive and the device event ring through the
                # engine, and their reduced runs on the card against the
                # CPU
                for path, ph in (("engine_tiered", engine_tiered),
                                 ("engine_device_obs", engine_dev_obs)):
                    by_path[path] = ph["launches"][key]
                    by_path[f"{path}_card_equals_cpu"] = \
                        ph["card_equals_cpu_launches"][key]
            if key in ("K2", "K3", "K4", "K6 encode", "K6 decode", "K7"):
                # the erasure-coded engine at config 3, and its reduced
                # run on the card against the CPU
                by_path["engine_ec"] = engine_ec["launches"][key]
                by_path["engine_ec_card_equals_cpu"] = \
                    engine_ec_small["launches"][key]
                # RS(6,3): the EC cluster grown 5 -> 6 -> 4 on the card
                by_path["ec_membership_card_equals_cpu"] = \
                    ec_member["launches"][key]
            # the lapped flight through the engine (the north star's
            # lapped and one-ring chunks, 8 laps at C = 4 096 card vs CPU)
            # and the fault schedules on the card (laps_path)
            for path in ("engine_laps", "lap_chaos"):
                n = laps["launches"][path].get(key, 0)
                if n:
                    by_path[path] = n
            # the engine over the mesh: the mirrored ranks' launches
            for path, ph in engine_mesh.items():
                n = ph["launches"].get(key, 0)
                if key in ("K1", "K2·mesh", "K3·mesh", "K4·mesh",
                           "K6 encode", "K6 decode", "K7") and n:
                    by_path[path] = n
            kernels.append({
                "name": f"{key} {name}", "route": "cuda", "source": src,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": err[key], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "library_ms": t.get("library_ms"),
                "library_is": LIBRARY_IS.get(key),
                "matches_plain": True,
            })
    for key, cfg_key, label, engine_paths in (
            # the group programs and the engine at config A
            ("K5 A", "config_a", "multi-Raft G=16",
             (("engine_multi", engine_multi),)),
            # the group programs and the engine at config B: the runs at
            # fuse_k 32 (with and without the graphs) and 1
            ("K5 B", "config_b", "multi-Raft G=1024 fused",
             (("engine_multi_fused", engine_multi_fused),)),
            # the reduced engine run (G = 4, C = 256) on the card against
            # the CPU, at its own shape
            ("K5 small", None, "multi-Raft G=4 card vs CPU",
             (("multi_card_equals_cpu", multi_small),))):
        t = group_timing[key]
        by_path = ({} if cfg_key is None else
                   {"group_main": group_main[cfg_key]["k5_launches"]})
        for path, ph in engine_paths:
            by_path[path] = ph["k5_launches"]
        if key == "K5 A":
            # config A behind the wire's RouterBackend
            by_path["wire_config_a"] = wire["k5_launches"]["config_a"]
        if key == "K5 B":
            # the group-sharded layout: its two shards (one launch a shard
            # a tick) and the resident program beside them
            by_path.update({f"group_mesh_{k}": n for k, n
                            in gmesh["k5_launches"].items()})
        if key == "K5 small":
            by_path["group_mesh_card_equals_cpu"] = gmesh_small["k5_launches"]
            # the ops server's demo MultiEngine (G = 4, C = 256, B = 8)
            by_path["obs_planes_serve_demo"] = planes["k5_launches"]
            # the chaos harness's multi-Raft torture and migration drill
            # (G = 4, C = 128, B = 4; the drill on two shards of the card)
            by_path.update(chaos["k5_launches"])
            # the wire drill's MultiEngine (G = 2, C = 128, B = 4)
            by_path["wire_drill"] = wire["k5_launches"]["drill"]
            # the txn drills' sharded MultiEngine (G = 4, C = 256, B = 4;
            # two shards of the card)
            by_path["txn_drill"] = txn["k5_launches"]["drill"]
        kernels.append({
            "name": f"K5 write_window_cols ({label})", "route": "cuda",
            "source": "raft_tpu_torch/csrc/ring.cu",
            "replaces": "raft_tpu/core/ring_pallas.py:208",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": group_errs["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": t["library_ms"],
            "library_is": LIBRARY_IS["K5"], "matches_plain": True,
        })
    # K4 at the lapped chunk's shape (T = 256: 8 laps of the north star's
    # ring in one flight), timed at that shape; its launches are the
    # lapped chunks' flights of that length (also in K4's engine_laps)
    t = laps["k4_lapped"]
    n_lapped = sum(run["flights"].count(t["steps"]) for run in
                   laps["north_star"]["lapped"]["chunks"])
    kernels.append({
        "name": f"K4 turnover_flight (lapped, T={t['steps']})",
        "route": "cuda", "source": "raft_tpu_torch/csrc/steady.cu",
        "replaces": "raft_tpu/core/step_pallas.py:1189",
        "launches": n_lapped,
        "launches_by_path": {"engine_laps_lapped_chunk": n_lapped},
        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["library_ms"],
        "library_is": LIBRARY_IS["K4 lapped"], "matches_plain": True,
    })
    # K5 behind the txn server at bench_txn's shape, timed at that shape
    t = txn["k5_timing"]
    kernels.append({
        "name": "K5 write_window_cols (multi-Raft G=4 txn bench)",
        "route": "cuda", "source": "raft_tpu_torch/csrc/ring.cu",
        "replaces": "raft_tpu/core/ring_pallas.py:208",
        "launches": txn["k5_launches"]["bench"],
        "launches_by_path": {"txn_bench": txn["k5_launches"]["bench"]},
        "max_abs_err": txn["k5_max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["library_ms"],
        "library_is": LIBRARY_IS["K5"], "matches_plain": True,
    })
    # K5 behind the cluster bench's single-process reference (Q), timed at
    # its shape
    t = cluster["k5_timing"]
    kernels.append({
        "name": "K5 write_window_cols (multi-Raft G=4 cluster reference)",
        "route": "cuda", "source": "raft_tpu_torch/csrc/ring.cu",
        "replaces": "raft_tpu/core/ring_pallas.py:208",
        "launches": cluster["k5_launches"],
        "launches_by_path": {"cluster_reference": cluster["k5_launches"]},
        "max_abs_err": cluster["k5_max_abs_err"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["library_ms"],
        "library_is": LIBRARY_IS["K5"], "matches_plain": True,
    })
    emit({"profile_loss": PROFILE_LOSS})
    emit({"kernels": kernels})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
