#!/usr/bin/env python3
"""Drive the PyTorch port (dlrover_tpu_torch) on one Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. device: CUDA with compute capability 9.0; prints the card's name and
   power limit as nvidia-smi reports them. TF32 is switched off for
   matmuls and cuDNN, so every f32 product in the references is full f32.
2. build: compiles every kernel of the main path from the sources in this
   checkout (``dlrover_tpu_torch/ops/csrc``: flash_attn.cu, fused_ce.cu and
   the header sm90_gemm.cuh they both include), one nvcc per source, in
   parallel; prints each kernel's registers and spills, and any warning of
   ptxas that it serialised a kernel's wgmma. Then counts, in
   each built library's SASS (``cuobjdump -sass``), every kernel's
   ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions:
   ``WGMMA_KERNELS`` (``fused_ce_fwd``, ``fused_ce_bwd_q``,
   ``fused_ce_bwd_dx`` and ``fused_ce_bwd_dw`` on the main loop of
   sm90_gemm.cuh, ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` on
   their own warp-specialised loops) must have both; ``NO_WGMMA_KERNELS``
   (``fused_ce_merge``, no GEMM) must show neither.
3. kernels: each flash-attention kernel (fwd, dq, dk/dv) against its plain
   PyTorch version on the same bf16 inputs on the card, for the main-path
   shape and for non-causal, ragged, group-1, head-dim-64, ViT-B/16
   (non-causal, s 196, head dim 64, batch 64), two cases that cut the
   128-row tiles (s 130 with batches meeting inside a tile, and s 200 at
   head dim 64), one of group 8 (s 300: every dk/dv tile takes the
   most query heads, and both the 64- and 128-row tiles are cut) and the
   four-card tp leg's local heads of the main shape (``TP_LOCAL_CASES``:
   h 16 / hkv 4 at tp2, h 8 / hkv 2 at tp4); each
   fused-CE kernel (fwd, merge, bwd_q, bwd_dx, bwd_dw) against its plain
   version for the main-path shape and for ragged, ragged-d (every edge of
   the wgmma tiles), ViT, all-masked, last-column and half-tile cases;
   with the tolerances below. Then each kernel's time, its plain version's
   time, the least time the card could take (bound), and one PyTorch call
   of the same function as the library yardstick (timed only; the port
   never calls it): SDPA's forward for flash_fwd, SDPA's backward for dq
   and dk/dv together, ``torch.mm(..., out_dtype=torch.float32)`` of the
   same product for the CE kernels, with each CE kernel's achieved TFLOP/s
   and its time over the library's. SDPA (forward and backward) and the
   merge are timed by replaying a captured CUDA graph (``graph_ms``), so
   host launch gaps do not enter them; the rest by CUDA events around
   back-to-back calls (``cuda_ms``). Each kernel's timing block starts
   after a synchronise and an idle gap of ``IDLE_GAP_S``, so no block
   inherits the clocks or heat of the one before, and the SM clock and
   power draw are printed after it. The flash kernels at the tp-local
   heads are timed once each beside their plain versions and bounds
   (``phase_tp_timing``; on the JSON line as each flash kernel's
   ``tp_local``). Last, the whole forward and backward of the fused CE
   against the chunked CE at the main-path shape.
4. main path: 4 training steps of the Llama-3-8B-width model cut to 4 of
   32 layers (seq 2048, micro-batch 1, global batch 2) through the port's
   ``ElasticTrainer``, with every kernel launch counter at 0 just before
   and read just after; checks the losses, that every flash and fused-CE
   kernel ran and that the chunked CE did not. Then the same 4 steps under
   ``DLROVER_TPU_FUSED_CE=0`` (the chunked CE), with tokens/s and peak
   memory of both runs and their step-1 losses compared.
4b. ViT-B/16 (224x224, patch 16, dim 768, 12 layers, 12 heads, mlp 3072,
   1000 classes) through ``run/vit_classify.py``: micro-batch 64, global
   batch 128, 4 steps, counters at 0 just before and read just after;
   checks the losses and that the flash and fused-CE kernels ran.
4c. flash checkpoint (``dlrover_tpu_torch/checkpoint``) at the main path's
   size, whose train state is 23,077,502,976 bytes of f32 params and adam
   moments. First the machine's facts: ``df -B1 /dev/shm``, MemAvailable,
   the free bytes under the checkpoint directory and the PCIe link; fails,
   naming the shortfall, if shm or the disk cannot hold the state (the
   disk: one persisted step on two tiers, ``ckpt_disk_peak``; each leg
   removes its directory once its restore is checked). Then, with no saver
   listening (a bare run, which persists inline): a save run
   (``run/llama_pretrain.py --ckpt-dir``, 6 steps, a memory save after
   each, every 4th persisted to disk, launch counters at 0 just before and
   read just after), every save required to take the device snapshot,
   with each save's pause, its background stage and device-to-host GB/s,
   tokens/s beside phase 4's and peak memory; 2 steps under
   ``DLROVER_TPU_DEVICE_SNAPSHOT=0`` (the pause is the whole
   device-to-host copy); then, with the segment unlinked, a child that
   must restore the save run's committed step 4 from the disk tier with
   every leaf's CRC32 equal to its manifest's. Then under the port's
   ``AsyncCheckpointSaver``, hosted in this process as an agent hosts it:
   a child trains 3 steps, step 2 a storage save (a persist event to the
   saver) and step 3 a memory save whose stage waits for the saver to
   copy step 2 (the back-pressure), and the saver must commit step 2; its
   copy and fanout seconds and step 3's wait are printed beside the bare
   run's inline persist. Then the elastic restart, through the port's
   control plane as a user launches it: ``python -m
   dlrover_tpu_torch.run.elastic_run --standalone --nnodes=1
   --nproc_per_node=1 --max_restarts=1`` (with the checkout on
   ``PYTHONPATH``) spawns the port's master and runs its agent, which
   hosts the saver; the worker is ``chip_smoke.py --ckpt-child elastic
   DIR``. Its first life trains 2 steps with a memory save after each,
   then steps 3-4 unsaved, prints the CRC32 of every leaf it staged and
   SIGKILLs itself; the agent must see the failure, classify it, persist
   step 2 at the breakpoint (every manifest CRC32 equal to the killed
   worker's), rendezvous again and restart the worker; the second life
   must restore step 2 from shm with every CRC32 equal and train steps
   3-4, a memory save after each, to the first life's losses of steps 3-4
   bitwise (flash dk/dv sum a GQA group in a fixed order, so a step is
   the same bits from the same state and batch). Every flash and fused-CE
   kernel must launch in each life; the CLI must exit 0 and the master log
   the job's exit as succeeded with the worker's last reported checkpoint
   step, 4. The master serves ``/metrics`` (``DLROVER_TPU_MASTER_METRICS_PORT``
   on a free port), read every ``METRICS_POLL_S`` while the CLI runs; the
   last reading's goodput, downtime total, global step and straggler count
   are printed beside what the master logs at its exit (the same, its
   lost-time attribution and its downtime brackets), and checked: one
   bracket for the kill, opened by the failure report and closed by the
   second life's first step report, inside the span from the agent's
   detection to the end of the second life's first step widened by one
   step report interval on each side (``check_master_downtime``), and no
   straggler in a one-worker job (``check_master_gauges``). The second
   life's step reports carry the trainer's step-time digest: its median
   sample must lie within ``DIGEST_WALL_TOL`` (15 %) of the median step
   wall the script times for the same steps
   (``check_digest_against_wall``). Before each of its steps the second
   life waits for the previous save's background staging: its
   device-to-host copy would otherwise share the step (the step's loss
   reaching the host queues behind it), and the wall and the digest
   would time the copy, not the step. No periodic persist
   runs in this leg: the disk holds one persisted step of the state on
   two tiers, and the breakpoint's is it. The time to recover is printed
   by phase: the kill to the agent's detection, the breakpoint persist,
   the rendezvous, the worker's start to its restore (with the restore's
   seconds, tier and registration), and the restore to the end of step
   3. Last, with the segment gone (the agent unlinks it at the job's
   end), a child must restore step 2 from the breakpoint persist on disk
   with every leaf's CRC32 equal to what the killed worker staged. The
   phase's shm segments, sockets and logs are named for this run (pid and
   a random suffix), so two runs on one
   machine never share them. Bounds are printed beside the times.
4d. the data plane at the main path's configuration (``DATA_*``): a
   corpus of 32 sequences of 2048 random uint32 token ids below 128256
   from the seed, written by the port's ``pack_tokens`` under the phase's
   temporary directory. The loader leg: ``run/llama_pretrain.py --data FILE
   --data-dtype uint32 --steps 4`` in this process (sampler, loader,
   prefetch to the card), launch counters at 0 just before and read just
   after, every flash and fused-CE kernel required to run; each step's
   batch, read back from the card, must equal bitwise the file's rows in
   the order the script computes on its own (numpy's ``RandomState(1 +
   epoch)`` permutation, ``sampler_order``); prints tokens/s beside phase
   4's and each step's wait on the prefetch. The shard leg: ``python -m
   dlrover_tpu_torch.run.elastic_run --standalone --nnodes=1
   --nproc_per_node=1 --max_restarts=1`` with the checkout on
   ``PYTHONPATH``, its worker ``chip_smoke.py --data-child shards FILE``,
   which registers the dataset (32 records, shard size 2, one epoch, no
   shuffle) with the port's master, leases 4 shards a call through
   ``ShardingClient``, trains one step a shard on the shard's rows and
   prints each lease call (its tasks, the ids the master acked, its
   seconds) and each shard (task id, range, the CRC32 of the batch read
   back from the card); its first life SIGKILLs itself after its 6th
   shard's step, and the agent must restart it; the second life takes
   shards until the master says exhausted. ``check_shard_accounting``:
   every one of the 16 ranges trained, no range the master acked in the
   first life reaches the second, a range trained in both lives only if
   the first held it un-acked when it died, each step's CRC32 equal to the
   file's rows; then the master's dataset complete (32 records), every
   kernel launched in each life, the per-task fallback never fired, the CLI
   exits 0 and the master logs the job as succeeded. Prints the lease
   RPCs' median and largest seconds, the kill to the agent's detection,
   the kill to the end of the first re-delivered shard's step, and the
   second life's start to its first step. The worker reports each step to
   the master with its step-time digest, and the master's ``/metrics`` and
   exit line are read and checked as in 4c's elastic leg (the bracket
   closes at the second life's first shard's step). Nothing is
   checkpointed; the job name, logs and socket directory are unique to the
   run. The phase fails past ``DATA_PHASE_LIMIT_S`` (120 s).
4e. the control plane's recovery, at phase 4d's configuration on the same
   corpus (written again from the seed), in two legs whose job names,
   state directories, logs and sockets are unique to the run. The
   master-relaunch leg: the script starts the port's master itself on a
   fixed free port, ``python -m dlrover_tpu_torch.master.main --port P``
   with ``DLROVER_TPU_STATE_BACKEND=file`` and a state directory under the
   phase's temporary directory, the goodput planner armed
   (``DLROVER_TPU_PLANNER=1``, a decision every
   ``RELAUNCH_PLANNER_INTERVAL_S`` once the auto-scaler's 90 s warmup has
   passed) and ``/metrics`` on a free port read every ``METRICS_POLL_S``,
   then ``python -m dlrover_tpu_torch.run.elastic_run --master_addr
   127.0.0.1:P --nnodes=1 --nproc_per_node=1``, its worker
   ``chip_smoke.py --data-child relaunch FILE`` (4d's shard worker, never
   killed, printing each step report's stamp and outcome; it holds before
   its first step until the script saw the first master's planner
   document record a decision, and before its last until the relaunched
   master's did, so that both lives of the master outlast the warmup).
   Once the worker's log shows its ``RELAUNCH_KILL_AFTER``-th shard's
   step, the script SIGKILLs the master and starts it again on the same
   port with the same state directory;
   the worker's lease calls, step reports and its agent's heartbeats ride
   the gap on the client's retries. ``check_relaunch``: every one of the
   16 ranges trained exactly once, each step's CRC32 equal to the file's
   rows, the relaunched master restored one dataset at a global step in
   (0, the last step reported before the kill] and ended at the steps
   trained, goodput in (0, 1], and one downtime bracket from no later than
   the kill to the stamp of the first step report the relaunched master
   took; the CLI exits 0, the relaunched master finds the dataset complete
   and logs the job as succeeded, every kernel launched. Prints the gap
   from the kill to the new master serving, the worker's longest interval
   between two step ends before its hold for the last, the largest lease
   RPC, the bracket, goodput and the attribution. The worker's trainer polls the runtime config and the
   planner's hint at its default cadence. ``check_relaunch_planner``: the
   planner document the first master left in the state store (what the
   relaunched one imports) holds at least one decision, the relaunched
   master's last document (read every ``METRICS_POLL_S / 2``: the master
   clears it when the job succeeds) continues that ledger and count with
   at least one more, every decision is HOLD (world 1, nothing waiting)
   and none executed, ``/metrics`` carries
   ``dlrover_tpu_scale_decisions_total``, no master logged a failed
   planner sweep, and the last decision that observed a step p50 reads
   within ``PLANNER_STEP_TOL`` (15 %) of the median of the digest samples
   the worker's reports carried; both are printed. The hang leg: ``elastic_run --standalone`` with
   ``DLROVER_TPU_HANG_WATCHDOG_WINDOW_S`` = ``HANG_WINDOW_S`` (40 s: over
   twice the agent's 15 s heartbeat, so its node is never taken for a
   silent member), its worker ``chip_smoke.py --data-child hang FILE``:
   ``run/llama_pretrain.py``'s loader flow on the file, no checkpoint,
   every step reported; its first life SIGSTOPs itself after its first step
   report ``HANG_STOP_AFTER_S`` (W/4 + 2 s) into the life, once the
   watchdog has latched the round, alive and never stepping again while
   its agent heartbeats. ``check_hang``: the master declared one hang with no
   silent member, billed ``collective_hang`` in [W, 1.25 W + 1 s] (one
   sweep is W/4), kept one downtime bracket from the last progress stamp
   (the first life's last step report) to the second life's first step
   report; the agent stopped the wedged worker (its SIGTERM waits in the
   stopped process; the SIGKILL after the 10 s grace ends it) and started
   it again, the second life trained every step, its step-1 loss bitwise
   the first life's, every kernel launched in both lives, the CLI exits 0.
   Prints the time to recover by phase: the stall to the declaration, the
   declaration to the worker stopped, the stop to the new worker's first
   step end. The diagnosis and the hang legs run, one after the other,
   while the relaunch leg's worker holds before its first step (the hold
   waits for them). The diagnosis leg: the script's own master
   (``--master-child``: the planner off, the diagnosis chain every
   ``DIAG_MASTER_INTERVAL_S``, ``seconds_hang_threshold``
   ``DIAG_SILENCE_S``, the hang watchdog at ``DIAG_WATCHDOG_WINDOW_S``),
   ``elastic_run --master_addr --tpu-timer`` (the device timer in the
   worker; the agent's interval ``DIAG_AGENT_INTERVAL_S``, the timer's
   hang timeout ``DIAG_TIMER_HANG_S``), its worker ``chip_smoke.py
   --data-child diag FILE`` (``_diag_child``: phase 4d's configuration and
   corpus, a save every step, the one before the spin's step a storage
   save; the first life reads its own timer after steps 2 and 11, then
   enqueues ``torch.cuda._sleep`` for ``DIAG_SPIN_S`` in step 12 before
   the optimizer). The script reads the worker's ``/pending`` during the
   hang. ``check_diagnosis``: one hang confirmed; the master's actions a
   ``CollectHangDump`` then one ``RestartWorker`` whose reason names
   ``stuck_at`` (``check_action_sequence``), the worker's wait for its
   step in ``timed_step``, the leaf of the dumped stacks' path through
   ``llama_pretrain.run`` (``check_stuck_at``); a hang dump holding the
   first life's stack; pending ``train_step``; one restart before the
   spin's end; the second life restored step 11 and trained steps 12-16
   at the first life's step time; every kernel launched in both lives;
   the timer's ``train_step`` between the two scrapes within
   ``DIAG_TIMER_TOL`` of the digest's mean over the same steps and its
   MFU gauge within ``DIAG_MFU_TOL`` of the script's MFU
   (``check_timer_against_digest``). Prints the readings, every action the
   master enqueued and the time between each step of the chain. Every
   other leg of phases 4c-4e fails if its master enqueued any action
   (``check_no_actions``). The phase fails past ``CONTROL_PHASE_LIMIT_S``.
5. reference: a small Llama (head dim 128) and a small ViT (head dim 64,
   100 patches, 300 classes) on the card, bf16 with the kernels, against
   the same weights on the CPU in f32 with the plain versions: loss and
   every gradient (Llama under remat "all" and "mlp").
6. output: one JSON line of the kernels, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --four-card`` runs the four-card leg instead, on
four cards of one host (it raises with fewer): builds the kernels, checks
the host's free disk, /dev/shm and MemAvailable (``check_space``) and
prints them, then runs ``python -m dlrover_tpu_torch.run.elastic_run
--standalone --nproc_per_node 4 --max_restarts=1``, its workers
``chip_smoke.py --ckpt-child four DIR`` (NCCL dp4 of the main path's
widths, global batch 8, ``run/llama_pretrain.py``'s build, checkpoint and
data flow on a uint32 corpus from the seed, a memory save every step).
Each rank's first life trains steps 1-2, saving each, writes the loader's
sidecar at step 2, then trains steps 3-4 unsaved; rank 3 then SIGKILLs
itself and the agent persists step 2 at the breakpoint and restarts all
four; each second life restores step 2 (its own quarter from shm, the
rest from disk) and trains steps 3-4. ``check_four_card``: the ranks'
losses equal at every step, each rank's staged bytes a quarter of the
state (replica-deduplicated staging), one restored step on every rank,
every leaf's CRC32 equal across the ranks and to the state the first life
staged, the resumed steps 3-4 bitwise the first life's, every kernel
launched on every rank in both lives. Prints each step's gradient
all-reduce (``reduce_ms``), global tokens/s and the time to recover by
phase. The leg runs under ``--tpu-timer``: in its first life's unsaved
steps 3-4 each rank reads its device timer just before and just after the
step's gradient all-reduces, and after step 4 every program it timed;
``check_nccl_programs`` prints each rank's ``nccl:*`` programs (count,
bytes, µs) and fails unless every rank timed ``nccl:AllReduce``, and
unless in each of the two steps the timer ended exactly one all-reduce a
gradient leaf between its reads, their device µs within
``FOUR_CARD_REDUCE_BOUNDS`` of the trainer's ``reduce_events`` span.

Then the collective hang (``COLL_HANG_*``, ``DIAG_*``): the script's own
master as in phase 4e's diagnosis leg, ``elastic_run --master_addr
--nproc_per_node 4 --tpu-timer``, its workers ``chip_smoke.py
--ckpt-child collhang DIR`` (``_coll_hang_life``: the kill leg's
configuration, a save every step, the third a storage save); rank 3
SIGSTOPs itself in step 4 before the step's last all-reduce, so ranks 0-2
wait in NCCL. ``check_coll_hang``: one hang confirmed, a dump request and
one restart whose ``stuck_at`` is the running ranks' wait in
``timed_step`` and whose pending programs hold ``nccl:AllReduce``, a hang
dump of every running rank, eight workers started, every rank restored
the same step and trained the rest with equal losses, every kernel
launched after the restart.

Then the scale-out leg (``SCALE_*``): the script starts the port's master
through ``--master-child`` (``LocalJobMaster(node_num=2, min_node_num=1,
planner=True)``, the file state backend, a planner decision every
``SCALE_PLANNER_INTERVAL_S``, hysteresis ``SCALE_HYSTERESIS``,
``DLROVER_TPU_PLANNER_HBM_GB`` ``SCALE_HBM_GB``, the local master's
defaults otherwise: the 60 s last-call window and the auto-scaler's 90 s
warmup), then node 0, ``elastic_run
--master_addr 127.0.0.1:P --nnodes=1:2 --nproc_per_node=2 --node_id=0``
under ``CUDA_VISIBLE_DEVICES=0,1``, its workers ``chip_smoke.py
--ckpt-child scale DIR`` (``_scale_life``: the main path's widths at dp2,
global batch 8, a corpus of ``SCALE_RECORDS`` sequences from the seed, a
memory save, a loader sidecar and a step report with the digest every
step, the runtime config polled at every step), and, once node 0's rank
0 logged its ``SCALE_JOIN_AFTER``-th step, node 1 the same with
``--node_id=1`` under ``CUDA_VISIBLE_DEVICES=2,3``. The growth gate hides
node 1 until the planner's RESIZE is executed; node 0's agent then
persists its breakpoint and restarts, and the round re-forms at four
ranks once node 0 has re-joined (node 1, which waited longer than the
window, forms no round alone), each restoring the persisted step and
training ``SCALE_AFTER`` steps. ``check_scale_out``: HOLDs up to the hysteresis streak, exactly
one RESIZE to 2 nodes, executed once; node 0's ranks stepped at dp2 at
least twice between node 1's start and their agent seeing the waiter and
armed the hint ``dp4`` before their life ended; ranks 0-3 at dp4, started
after the execution, one restored step, every persisted piece's CRC32
(node 0's manifests: what the dp2 life staged) equal on every rank; every
step of both lives trained its rows of the loader's order (the committed
steps train every record once); the dp4 ranks' losses equal, their first
step's within ``SCALE_LOSS_RTOL`` of the dp2 life's same step; every
kernel launched on every rank in both lives; both CLIs and the master
exit 0 and no sweep failed. Prints dp2 and dp4 global tokens/s, the
planner's predicted dp4 step against the measured one, the time from node
1's join to the decision and from the decision to the first dp4 step's
end by phase, and the downtime bracket the ledger billed (the
auto-scaler opens it when the grown round forms, backdated to the last
dp2 step report) with the ``resize_cost_s`` later decisions read.
Global tokens/s is every token of a life's steps after its first over the
wall from the first step's end to the last step's end, saves and reports
included; the median step wall is printed beside it.

Then the zero-1 leg (``ZERO1_*``, ``_zero1_leg``): under the node's
``AsyncCheckpointSaver``, which the script hosts as an agent would, four
ranks of ``chip_smoke.py --zero1-child dp4 DIR``, their process group
formed by ``train/bootstrap.py`` from the environment the script sets
(NCCL, one card each), train the kill leg's configuration and corpus,
with no lr warmup (every step updates at the schedule's rate),
``ZERO1_STEPS`` steps through ``run/llama_pretrain.py``'s build and data
flow replicated, then from the same init with ``--zero1`` (the worker's
``DeviceMesh``, dp-sharded adam moments, reduce-scattered gradients,
all-gathered params), which saves its last step to storage; two ranks of
``--zero1-child dp2 DIR`` then restore it under zero-1 at dp2 and train
one step. ``check_zero1``: the modes ``off`` and ``scatter``; each run's
losses equal across the ranks, its whole params' CRC32 after the last
step equal across the ranks (a missing all-gather leaves other quarters
stale) and every kernel launched on every rank; the zero-1 losses within
``ZERO1_LOSS_RTOL`` of the replicated ones; each rank's change of its
whole params from init to step 1 and to the last step, at
``ZERO1_SAMPLE_PER_LEAF`` fixed indices a leaf spread over every quarter
(``param_sample``), against the replicated run's (``compare_delta``):
the same init, at least ``ZERO1_DELTA_MOVED_MIN`` of the sampled params
moved by the replicated run, and in each quarter at most
``ZERO1_DELTA_MISS_MAX`` (step 1) or ``ZERO1_DELTA_LAST_MISS_MAX`` (the
last step) of them whose two changes differ by more than
``ZERO1_DELTA_ATOL`` times the leaf's largest change; the
moments 8 bytes a param replicated and exactly a quarter of that under
zero-1; the peak allocation lower by ``ZERO1_PEAK_SAVING_MIN``; each
rank's step-1 moments at ``ZERO1_SAMPLE_PER_LEAF`` fixed indices a leaf of
its zero-1 region (``moment_sample``, at least ``ZERO1_SAMPLE_MIN``) within
``ZERO1_MOMENT_RTOL`` plus ``ZERO1_MOMENT_ATOL`` times the leaf's largest
magnitude of the replicated run's (``compare_sample``); the restored step
on both dp2 ranks, the CRC32 of each dp4 quarter of every param and
moment leaf they hold equal to the dp4 rank's (``quarter_crcs``), and
their one step's losses finite and equal. Prints, a rank and a step, the
moments' bytes, ``max_memory_allocated``, the step wall and the device ms
of the gradient collectives, ``optimizer_update`` and the param
all-gathers, in both modes; the restore's tier and seconds; and the
goodput planner's same-world prediction for ``dp4+zero1`` beside the
measured zero-1 step (``planner_zero1_step``).

Then the fsdp leg (``FSDP_*``, ``_fsdp_leg``): the full 32-layer
Llama-3-8B (seq 2048, micro-batch 1, the four-card global batch, seed 0,
synthetic tokens, no lr warmup) through ``run/llama_pretrain.py --fsdp``,
ranks of ``chip_smoke.py --fsdp-child ROLE DIR`` bootstrapped as in the
zero-1 leg, under a saver the script hosts, with
``DLROVER_TPU_CKPT_DEDUP=0`` (each rank stages all it holds) and nothing
persisted. ``life1``: fsdp4 steps 1-3, a memory save after step 2 and the
CRC32 of what each rank staged; rank 3 SIGKILLs itself once step 3's
loss is printed, and the script ends the others, which wait in step 4's
first gather. ``life2``: four new ranks restore step 2, each from its own
segment, CRC32 what they restored and train steps 3-4 on the same
batches. ``zero1``: dp2 x fsdp2 under ``--zero1`` (``"gspmd"``), steps
1-2 from the same init. Each run samples its params at init and after
step 1 at ``ZERO1_SAMPLE_PER_LEAF`` flat indices a leaf, each rank the
indices in the region it holds (``fsdp_sample``), merged whole by the
script (``merge_samples``). ``check_fsdp``: every run's losses equal
across its ranks and every kernel launched on every rank; every
``max_memory_allocated`` under ``FSDP_MEMORY_MAX`` and not under the
init's peak; fsdp4 ranks hold a quarter of every matrix, of its moments
and of its gradients; the restore by tier shm alone, every restored
leaf's CRC32 equal to the staged one, the resumed step-3 loss within
``FSDP_LOSS_TOL`` of life 1's; the zero-1 ranks in mode ``gspmd``, a
quarter of every matrix's moments (the norms' half), ``lm_head``'s
moments on the nested ``("fsdp", "dp")`` tiling in block ``fsdp * 2 +
dp``, the step-1 loss within ``FSDP_LOSS_TOL`` of fsdp4's and the step-1
change of the sampled params against fsdp4's as the zero-1 leg holds its
step 1 (``compare_delta``). Prints each rank's param, gradient and moment
bytes and peaks, each step's wall, tokens/s a card and MFU, the save's
pause, each restore's tier and seconds, each rank's kernel launches and
the leg's seconds, beside the card's name and power limit.

Then the tp leg (``TP_*``, ``_tp_leg``): the fsdp leg's configuration
through ``run/llama_pretrain.py --tp 2``, ranks of ``chip_smoke.py
--tp-child ROLE DIR`` bootstrapped as there, no checkpoint.
``fsdp2xtp2``: ``--fsdp 2 --tp 2`` (the JAX example's layout), steps 1-3;
``dp2xtp2``: dp2 x tp2 under ``--zero1`` (``"gspmd"``), steps 1-2, from
the same init. ``check_tp``: each run's mode and mesh, its losses equal
across its ranks, its step-1 loss within ``TP_LOSS_RTOL`` (relative) of
the fsdp leg's fsdp4 step-1 loss; every rank's params, moments and
gradients at the arithmetic's share (fsdp2 x tp2: a quarter of every
matrix, the norms whole; dp2 x tp2: half of every matrix, its moments a
quarter, the norms' moments half), its ``max_memory_allocated`` under
``FSDP_MEMORY_MAX``, every kernel launched on every rank. Prints each
rank's bytes, peaks and launches, each step's wall (slowest rank),
tokens/s a card (the global batch's tokens over the four cards) and MFU,
and a ``kernels`` line of each kernel's launches by run and rank.

Then the sp leg (``SP_*``, ``_sp_leg``): the main path's widths at
``SP_LAYERS`` of 32 layers and the preset's seq ``SP_SEQ`` (global batch
2, micro-batch 1, seed 0, no lr warmup, remat "all", the fused CE; tokens
drawn on the host, ``sp_batches``, the same rows in every run) through
``run/llama_pretrain.py``'s build. First ``chip_smoke.py --sp-child
reference DIR``, one process on one card with no process group: the flash
kernels against their plain versions at every shape the leg launches them
(``sp_flash_cases``, derived from ``SP_RUNS`` and ``SP_SEQ``: the
reference's causal kernel at s 8192, each ring run's causal diagonal
chunk and non-causal earlier chunk at ``s/sp``, each ulysses run's causal
kernel at s 8192 on its local heads; a random ``lse`` cotangent in
every case, as ring's merge gives), each timed once beside its plain
version and bound (``time_flash_case``), then the reference's steps 1-2
with the flash kernels on the whole sequence. Then, in one start of four
ranks of ``--sp-child ranks DIR`` bootstrapped as in the zero-1 leg, sp4
ring, sp4 ulysses and fsdp2 x sp2 ring (``SP_RUNS``), steps 1-2 each, the
mesh rebuilt and the memory freed between them. Each run samples its
params at init and after step 2 (``fsdp_sample``). ``check_sp``: each
run's losses equal across its ranks and at steps 1 and 2 within
``SP_LOSS_RTOL`` (relative) of the reference's; its mode and mesh;
every rank's params, gradients and moments at the arithmetic's share,
its peak under ``FSDP_MEMORY_MAX``; every kernel launched on every rank,
the flash kernels exactly as ``sp_expected_flash`` counts them (under
causal ring rank r runs r + 1 chunk kernels a layer a forward); every
rank holding a sampled param holds the same bits (``merge_samples``: a
missing sp sum of the gradients leaves the ranks apart, and moves the
step-2 loss by less than the bound); each leaf's change of the sampled
params after step 2 against the reference's within ``SP_DELTA_REL_FRO``
relative (``compare_delta``). Prints each rank's bytes, peaks and
launches, each step's loss against the reference's, wall (slowest
rank), tokens/s a card and MFU, each leaf's relative error and share of
changes past ``SP_DELTA_ATOL``, and a ``kernels`` line of each kernel's
launches by run and rank. The last line is the contract's, with the
cards' count.

Exits with code 2 and prints no result when CUDA is not available.
``--ckpt-child ROLE DIR`` runs one of phase 4c's children or the
four-card leg's workers (``four``, ``scale``), ``--data-child ROLE FILE``
phase 4d's worker (``shards``) or one of phase 4e's (``relaunch``,
``hang``), ``--master-child SPEC`` the scale-out leg's master, and
``--zero1-child ROLE DIR`` a rank of the zero-1 leg (``dp4``, ``dp2``),
``--fsdp-child ROLE DIR`` one of the fsdp leg's (``life1``, ``life2``,
``zero1``), ``--tp-child ROLE DIR`` one of the tp leg's (``fsdp2xtp2``,
``dp2xtp2``), ``--sp-child ROLE DIR`` the sp leg's reference or its four
ranks (``reference``, ``ranks``); none is run by hand.
"""

import contextlib
import gc
import dataclasses
import json
import math
import os
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import uuid
import zlib
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

# kernel vs plain version, both from the same bf16 inputs: the kernel
# rounds p and ds to bf16 before its tensor-core products, so the error
# is a few bf16 ulps of the result's scale
REL_MAX_TOL = 2e-2   # max |kernel - plain| <= REL_MAX_TOL * max |plain|
REL_FRO_TOL = 1e-2   # ||kernel - plain|| <= REL_FRO_TOL * ||plain||
LSE_ABS_TOL = 1e-3   # lse is f32 in both; only the summation order differs

# end-to-end reference (phase 5): bf16 compute on the card vs f32 on the CPU
E2E_LOSS_TOL = 2e-2
E2E_GRAD_REL_FRO_TOL = 5e-2

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3

# seconds the card idles before each kernel's timing block
IDLE_GAP_S = 1.0

SOURCE = "dlrover_tpu_torch/ops/csrc/flash_attn.cu"
KERNELS = [
    # name, launch-counter key, the TPU kernel it replaces
    ("flash_fwd", "fwd", "dlrover_tpu/ops/attention.py:96"),
    ("flash_bwd_dq", "bwd_dq", "dlrover_tpu/ops/attention.py:227"),
    ("flash_bwd_dkv", "bwd_dkv", "dlrover_tpu/ops/attention.py:279"),
]
MAIN_CASE = dict(b=1, s=2048, h=32, hkv=8, d=128, causal=True)
CASES = [
    ("main", MAIN_CASE),
    ("non_causal", dict(b=1, s=2048, h=32, hkv=8, d=128, causal=False)),
    ("ragged_causal", dict(b=2, s=1000, h=32, hkv=8, d=128, causal=True)),
    ("ragged_non_causal", dict(b=1, s=1000, h=8, hkv=2, d=128, causal=False)),
    ("group1", dict(b=1, s=1024, h=8, hkv=8, d=128, causal=True)),
    ("head_dim64", dict(b=2, s=520, h=8, hkv=2, d=64, causal=True)),
    # the ViT-B/16 path's shape: 196 patches, 12 heads of 64, micro-batch 64
    ("vit_b16", dict(b=64, s=196, h=12, hkv=12, d=64, causal=False)),
    # the forward's 128-row tile: s 130 leaves a 2-row second tile whose
    # box would reach into the next batch's rows, with group 4
    ("tile_edge_gqa4", dict(b=3, s=130, h=8, hkv=2, d=128, causal=True)),
    ("tile_edge_d64", dict(b=2, s=200, h=4, hkv=4, d=64, causal=False)),
    # one kv head for eight query heads: the most blocks adding into each
    # dk/dv tile, and s 300 cuts the 64- and the 128-row tiles
    ("mqa_group8", dict(b=2, s=300, h=8, hkv=1, d=128, causal=True)),
    # the four-card tp leg's local heads of the main shape: a tp rank's
    # 32/tp query heads and 8/tp kv heads (group 4 either way)
    ("tp2_local", dict(b=1, s=2048, h=16, hkv=4, d=128, causal=True)),
    ("tp4_local", dict(b=1, s=2048, h=8, hkv=2, d=128, causal=True)),
]
#: the cases timed beside the main shape (``phase_tp_timing``)
TP_LOCAL_CASES = ("tp2_local", "tp4_local")


# fused CE, kernel vs plain version on the same bf16 inputs: logits are
# bf16 products accumulated in f32 in both, so logz and nll_sum differ by
# the order of f32 sums (and __expf) only; q is rounded to bf16 in both,
# where a 1-ulp flip is 2^-8 relative, so q, dx and dw take the flash
# tolerances above
CE_LOGZ_ABS_TOL = 1e-3
CE_NLL_REL_TOL = 1e-4
# fused vs chunked step-1 loss of the main path: the same bf16 products
# and roundings, summed in another order (loss ~12.6)
FUSED_VS_CHUNKED_LOSS_TOL = 1e-2

CE_SOURCE = "dlrover_tpu_torch/ops/csrc/fused_ce.cu"
CE_KERNELS = [
    # name, launch-counter key, the TPU kernel it replaces
    ("fused_ce_fwd", "fwd", "dlrover_tpu/ops/fused_ce.py:201"),
    # the per-token finalize of the same TPU kernel (fused_ce.py:230)
    ("fused_ce_merge", "merge", "dlrover_tpu/ops/fused_ce.py:201"),
    # the logits recompute that both TPU backward kernels ran (:290)
    ("fused_ce_bwd_q", "bwd_q", "dlrover_tpu/ops/fused_ce.py:300"),
    ("fused_ce_bwd_dx", "bwd_dx", "dlrover_tpu/ops/fused_ce.py:300"),
    ("fused_ce_bwd_dw", "bwd_dw", "dlrover_tpu/ops/fused_ce.py:322"),
]
CE_MAIN = dict(n=2048, d=4096, v=128256, targets="main")
CE_CASES = [
    ("main", CE_MAIN),
    ("ragged", dict(n=1000, d=4096, v=50000, targets="ragged")),
    # every edge of the wgmma tiles: d 520 is no multiple of 64 (bwd_q's K
    # step) or 256 (bwd_dx's N tile); the vocab splits into chunks of 8192
    # and 808 columns, the second at c0 8192 (the chunk's tensor-map base)
    # and no multiple of 64 (bwd_dx's K step); n 300 is no multiple of 128
    ("ragged_d", dict(n=300, d=520, v=9000, targets="ragged")),
    # the ViT-B/16 path's shape: one pooled row per image of a micro-batch
    ("vit", dict(n=64, d=768, v=1000, targets="ragged")),
    ("all_masked", dict(n=256, d=1024, v=5000, targets="all_masked")),
    # 32001 = 125 * 256 + 1: the last forward tile is one column wide
    ("last_column", dict(n=512, d=1024, v=32001, targets="last_column")),
    # 384 = 256 + 128: the second forward tile is half real columns; n 130
    # leaves the second token tile 2 rows, none of them consumer 1's
    ("half_tile", dict(n=130, d=1024, v=384, targets="ragged")),
]


# flash checkpoint (phase 4c)
CKPT_CHILD_TIMEOUT_S = 600
# seconds the saver gets to copy, fan out and commit a persisted step (at
# the disk's 0.7-0.9 GB/s, two tiers of 23.1 GB take about a minute)
CKPT_COMMIT_TIMEOUT_S = 600
# seconds the elastic leg's CLI may take: two lives of the worker (each
# about a minute on the card) and the breakpoint persist between them
ELASTIC_TIMEOUT_S = 900
# the data plane (phase 4d): a corpus of DATA_RECORDS sequences of
# DATA_SEQ random uint32 token ids below DATA_VOCAB (Llama-3's vocabulary),
# drawn from DATA_SEED; the loader leg trains DATA_LOADER_STEPS steps; the
# shard leg's master splits the records into shards of DATA_SHARD_SIZE
# (one optimizer step of the global batch, 2, each), leased DATA_LEASE_COUNT
# at a time, and its worker's first life is SIGKILLed after its
# DATA_KILL_AFTER-th shard's step
DATA_RECORDS = 32
DATA_SEQ = 2048
DATA_VOCAB = 128256
DATA_SEED = 0
# the shuffle seed of run/llama_pretrain.py's sampler (the JAX example's)
DATA_SAMPLER_SEED = 1
DATA_LOADER_STEPS = 4
DATA_SHARD_SIZE = 2
DATA_LEASE_COUNT = 4
DATA_KILL_AFTER = 6
DATA_DATASET = "chip-smoke-shards"
# seconds the shard leg's CLI may take: two lives of the worker, each a
# process start, the model's build and up to twelve steps
DATA_TIMEOUT_S = 600
# seconds the whole of phase 4d may take
DATA_PHASE_LIMIT_S = 120
# the control plane's recovery (phase 4e), at phase 4d's configuration and
# corpus. The master-relaunch leg: the worker leases DATA_LEASE_COUNT shards
# a call of the DATA_RECORDS / DATA_SHARD_SIZE ranges and is never killed;
# the script SIGKILLs the master once the worker has trained
# RELAUNCH_KILL_AFTER shards and starts it again on its port.
RELAUNCH_KILL_AFTER = 6
# the relaunch leg's masters (the master CLI) arm the goodput planner
# (DLROVER_TPU_PLANNER) and decide every RELAUNCH_PLANNER_INTERVAL_S once
# the auto-scaler's warmup (the master config's seconds_to_autoscale_worker,
# 90 s from each master's first poll) has passed. So that both lives of the
# master decide, the worker holds before its first step until the script
# has seen the first master decide, and before its last until the script
# has seen the relaunched master decide (RELAUNCH_GO files beside the
# corpus). A decision's observed step p50 must lie within PLANNER_STEP_TOL
# of the median of the digest samples the worker reported (both read the
# card's step time)
RELAUNCH_PLANNER_INTERVAL_S = 1.0
RELAUNCH_GO = ("relaunch-go-first", "relaunch-go-last")
PLANNER_STEP_TOL = 0.15
# the hang leg: the worker trains HANG_STEPS steps through the loader,
# reporting every step (its step-report interval lowered to
# HANG_REPORT_INTERVAL_S); its first life SIGSTOPs itself after its first
# report at least HANG_STOP_AFTER_S into the life. The watchdog's window is
# HANG_WINDOW_S: at least 3 report intervals, and over twice the agents'
# 15 s heartbeat, so that a live agent's node is never taken for a silent
# member (silent: no heartbeat for half the window). The watchdog latches a
# new round at its first sweep after the round forms (one sweep every
# window / 4) and counts a stall from the later of that and the last step
# report: stopping one sweep and a margin into the life puts the stall's
# start at the last report
HANG_STEPS = 24
HANG_REPORT_INTERVAL_S = 0.0
HANG_WINDOW_S = 40.0
HANG_STOP_AFTER_S = HANG_WINDOW_S / 4 + 2.0
# the digest against the step wall (phase 4c's second life): the median
# sample within DIGEST_WALL_TOL of the median step the script times
DIGEST_WALL_TOL = 0.15
# seconds each leg's CLI may take, and the whole of phase 4e (the relaunch
# leg waits out the auto-scaler's warmup in both lives of its master, the
# first behind the diagnosis and the hang legs)
CONTROL_TIMEOUT_S = 600
CONTROL_PHASE_LIMIT_S = 600
# the master's /metrics (phases 4c and 4d): read every METRICS_POLL_S while
# the CLI runs; the last reading before the master exits is kept
METRICS_POLL_S = 0.25
# the four-card leg: four ranks of one host, the main path's widths at
# global batch 8 (dp4, two microbatches a rank), a corpus of
# FOUR_CARD_RECORDS sequences; rank FOUR_CARD_KILL_RANK is SIGKILLed after
# step 4, with step 2 staged. Each rank's staged share of the state must
# lie within FOUR_CARD_SHARE_TOL of a quarter (leaves split on rows)
FOUR_CARD_WORLD = 4
FOUR_CARD_GLOBAL_BATCH = 8
FOUR_CARD_RECORDS = 64
FOUR_CARD_KILL_RANK = 3
FOUR_CARD_SHARE_TOL = 0.02
FOUR_CARD_TIMEOUT_S = 1500
# the hook's gradient all-reduces against the trainer's reduce_events, in
# the kill leg's first-life steps 3-4 (no save, no barrier): each rank reads
# its timer once the step's last token-count all-reduce has ended and again
# before the step's loss all-reduce, so the reads bracket exactly the
# gradients' collectives. Kernels serial on one stream cannot take longer
# than the span the trainer's events bracket around them, so the timer's
# device µs pass it only by the events' rounding (the upper bound), where
# host times from each call to its poll would count the kernels queued
# ahead of it; they fall short of it by the host's launch gaps between
# the kernels, and a hook missing half the span (the lower bound) would
# time something other than the kernels
FOUR_CARD_REDUCE_STEPS = (3, 4)
FOUR_CARD_REDUCE_BOUNDS = (0.5, 1.01)
# the four-card scale-out leg: the script's own master (node_num 2,
# min_node_num 1, the planner armed, a decision every
# SCALE_PLANNER_INTERVAL_S, hysteresis SCALE_HYSTERESIS, the memory gate at
# SCALE_HBM_GB a card, the local master's defaults otherwise: its 60 s
# last-call window, which the first round waits out with node 0 alone, and
# the auto-scaler's 90 s warmup); node 0 (cards 0-1) trains at dp2 on the
# main path's widths at global batch 8 (four microbatches a rank) over a
# corpus of SCALE_RECORDS sequences, a memory save, a loader sidecar and a
# step report every step; node 1 (cards 2-3) starts once node 0's rank 0
# logged SCALE_JOIN_AFTER steps. After the restore the dp4 ranks train
# SCALE_AFTER steps, long enough for a decision to read the resize's billed
# cost. SCALE_STEPS is both lives' schedule length (and the cap of the dp2
# life)
SCALE_WORLD = 4
SCALE_NODE_PROCS = 2
SCALE_RECORDS = 1024
SCALE_STEPS = 128
SCALE_JOIN_AFTER = 3
SCALE_AFTER = 24
SCALE_PLANNER_INTERVAL_S = 5.0
SCALE_HYSTERESIS = 2
SCALE_HBM_GB = 80
SCALE_TIMEOUT_S = 1200
# the dp4 life's first step against the dp2 life's same step: the same
# params (the restored state), the same eight rows, the same kernels, so
# each row's loss term is the same bits; only the order of the f32 sums
# differs (four microbatches and a two-rank all-reduce against two and a
# four-rank one), at most a few ulps of 8 additions, 8 * 2^-24 = 4.8e-7
# relative: SCALE_LOSS_RTOL leaves a factor of 20 over that
SCALE_LOSS_RTOL = 1e-5
# the diagnosis chain on the card (phase 4e's diagnosis leg, the four-card
# collective hang): the device timer's hang timeout, the agent's and the
# master's diagnosis intervals and the hang check's step-report silence,
# each cut from the JAX default (300, 60, 60 and 300 s) to fit a run. The
# master's interval stays above the time from its restart to the restarted
# workers' timers reporting no hang (the agent's 15 s heartbeat, the
# breakpoint persist, the stop, one agent interval): a cycle inside it would
# read the old workers' flag and confirm the hang again
DIAG_TIMER_HANG_S = 20
DIAG_AGENT_INTERVAL_S = 5.0
DIAG_MASTER_INTERVAL_S = 50.0
DIAG_SILENCE_S = 20.0
# the hang watchdog stays on, its window above the chain's (about 1-2 min
# from the stall to the restart, and the breakpoint persist after it)
DIAG_WATCHDOG_WINDOW_S = 600.0
# the diagnosis leg's worker (phase 4d's configuration and corpus, a
# save every step): its first life enqueues a spin of DIAG_SPIN_S (sized
# from the card's clock) in step DIAG_SPIN_STEP, before the optimizer, and
# reads its own timer after the steps of DIAG_SCRAPE_AFTER; the save of the
# step before the spin is a storage save, whose persist the agent's saver
# runs during the hang, so the breakpoint persist finds it done; the second
# life restores the last staged step and trains to DIAG_STEPS
DIAG_STEPS = 16
DIAG_SPIN_STEP = 12
DIAG_SCRAPE_AFTER = (2, DIAG_SPIN_STEP - 1)
DIAG_SPIN_S = 600.0
# the timer's train_step latency between the two scrapes against the
# digest's mean over the same steps (both CUDA events around the same
# work on one stream), and its MFU gauge (an average decaying by 0.8 a
# step) against the script's MFU from that mean
DIAG_TIMER_TOL = 0.05
DIAG_MFU_TOL = 0.10
# a life after the spin against the life before it: a spin that outlived
# its process would share the card and slow the new steps by about half
DIAG_RESUMED_STEP_TOL = 0.25
DIAG_TIMEOUT_S = 900
# the four-card collective hang: NCCL dp4 at the kill leg's configuration
# and corpus, a save every step (a storage save at the step before the
# stop, as in the diagnosis leg); rank COLL_HANG_RANK SIGSTOPs itself in
# step COLL_HANG_STOP_STEP before the step's last all-reduce, so ranks 0-2
# wait in NCCL for it; NCCL's own watchdog (the process group's timeout) is
# set past the chain's restart, so the chain and not NCCL ends the hang
COLL_HANG_STEPS = 8
COLL_HANG_STOP_STEP = 4
COLL_HANG_RANK = 3
COLL_DIST_TIMEOUT_S = 900
# the four-card zero-1 leg: the kill leg's configuration and corpus (the
# main path's widths, global batch 8, seed 0) trained ZERO1_STEPS steps at
# dp4 replicated and then from the same init under zero-1 in the same four
# processes, the zero-1 state saved to storage after its last step, then
# restored at ZERO1_RESTORE_WORLD ranks under zero-1, which train one step.
# Zero-1 against replicated: the losses within ZERO1_LOSS_RTOL (the same
# gradients up to the order of the collectives' and the norm's f32 sums;
# the kernels' atomics-free sums are the same bits; 1.9e-5 apart at step 4
# on four H100s, where the random-token corpus moves the loss by 0.0105
# over three full-lr steps), each rank's step-1
# moments at ZERO1_SAMPLE_PER_LEAF fixed indices a leaf of its zero-1
# region (at least ZERO1_SAMPLE_MIN in all) within ZERO1_MOMENT_RTOL plus
# ZERO1_MOMENT_ATOL times the leaf's largest magnitude (mu and nu are one
# multiply-add from the gradient at step 1; a region on the wrong rank or
# dim is unrelated values), the moments exactly 1/dp of the replicated
# bytes, and the peak allocation lower by at least ZERO1_PEAK_SAVING_MIN
# (the moments alone save 3/4 of 8 bytes a param, 11.5e9). The leg trains
# with no lr warmup, so that every step moves the params. Each rank's
# whole params' change from init, sampled over every quarter after step 1
# and after the last step, against the replicated run's, element by
# element within ZERO1_DELTA_ATOL times the leaf's largest change: after
# step 1 both runs have updated from the same gradients, so at most
# ZERO1_DELTA_MISS_MAX of a quarter's sampled elements may miss; by the
# last step the bf16 forward has turned last-bit differences of the params
# into small differences of the gradients, and adam, which moves an
# element by about the lr whatever its gradient's size, steps an element
# whose gradient is near zero either way (2.7 % of them missed on four
# H100s), so at most ZERO1_DELTA_LAST_MISS_MAX may miss. A skipped update
# misses every moved element (at least ZERO1_DELTA_MOVED_MIN of them), a
# stale or misplaced quarter every moved element of that quarter
ZERO1_STEPS = 4
ZERO1_RESTORE_WORLD = 2
ZERO1_LOSS_RTOL = 1e-4
ZERO1_DELTA_ATOL = 1e-2
ZERO1_DELTA_MISS_MAX = 1e-3
ZERO1_DELTA_LAST_MISS_MAX = 0.1
ZERO1_DELTA_MOVED_MIN = 0.5
ZERO1_MOMENT_RTOL = 1e-3
ZERO1_MOMENT_ATOL = 1e-3
ZERO1_SAMPLE_PER_LEAF = 1 << 17
ZERO1_SAMPLE_MIN = 10 ** 6
ZERO1_PEAK_SAVING_MIN = 10e9
ZERO1_TIMEOUT_S = 900
# the four-card fsdp leg (``_fsdp_leg``): the full 32-layer Llama-3-8B at
# fsdp4, a memory save after step FSDP_SAVE_STEP, rank FSDP_KILL_RANK
# SIGKILLed once step FSDP_KILL_AFTER's loss is logged, four new ranks
# restoring from their own shm segments (DLROVER_TPU_CKPT_DEDUP=0: each
# stages all it holds, so nothing is read from disk and nothing persisted)
# and training to FSDP_STEPS; then dp2 x fsdp2 under zero-1 ("gspmd")
# from the same init for FSDP_ZERO1_STEPS steps. Losses within
# FSDP_LOSS_TOL (absolute); every rank's max_memory_allocated under
# FSDP_MEMORY_MAX; the step-1 change of the sampled params held to the
# fsdp4 run's as the zero-1 leg holds it (compare_delta, the ZERO1_DELTA_*
# bounds of its step 1)
FSDP_WORLD = 4
FSDP_STEPS = 4
FSDP_SAVE_STEP = 2
FSDP_KILL_RANK = 3
FSDP_KILL_AFTER = 3
FSDP_ZERO1_DP = 2
FSDP_ZERO1_STEPS = 2
FSDP_LOSS_TOL = 1e-4
FSDP_MEMORY_MAX = 80e9
FSDP_TIMEOUT_S = 600
# the four-card tp leg (``_tp_leg``): the fsdp leg's configuration at
# fsdp2 x tp2, the JAX example's layout, steps 1 to TP_STEPS, then dp2 x
# tp2 under zero-1 ("gspmd") from the same init for TP_ZERO1_STEPS steps.
# Each run's step-1 loss within TP_LOSS_RTOL (relative) of the fsdp leg's
# fsdp4 step-1 loss: the same init cut another way, on the same 8 rows,
# but the row-parallel products round to bf16 before the tp all-reduce
# sums them. bf16 compute at tp2 against one process on the CPU
# (tests/test_torch_tp.py's bf16_drift: dim 128, 8/4 heads, 2 and 8
# layers, four seeds) parted by at most 3.7e-5 relative; the bound is
# 13.7 times that, under 1e-3
TP_SIZE = 2
TP_FSDP = 2
TP_STEPS = 3
TP_ZERO1_STEPS = 2
TP_LOSS_RTOL = 5e-4
TP_TIMEOUT_S = 300
# the tp ranks' caching allocator grows its segments in place: dp2 x tp2
# zero-1 holds the f32 accumulator and a second microbatch's gradients
# (16.1 GB each) beside params and moments, and fixed segments left 11.56
# GiB reserved but unallocated when a 3.5 GiB gradient did not fit (my
# chip run 1, PR 19)
TP_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
# the four-card sp leg (``_sp_leg``): the main path's widths at 4 of 32
# layers and the preset's seq 8192, global batch 2, trained 2 steps by one
# process on one card (the reference: the flash kernels on the whole
# sequence) and, from the same init and rows, at sp4 ring, sp4 ulysses and
# fsdp2 x sp2 ring in one start of four ranks. Each run's step-1 and
# step-2 losses within SP_LOSS_RTOL (relative) of the reference's; every
# rank's sampled params after step 2, their change from init, against the
# reference's (``compare_delta``): each leaf's relative error (the norm of
# the changes' difference over the reference change's) at most
# SP_DELTA_REL_FRO. bf16 compute at sp2 and sp4 against one process on
# the CPU (tests/test_torch_sp.py: dim 128, 8/2 heads, 2 layers, seq 64,
# three seeds) parted by at most 2.5e-5 in the loss, the bound 20 times
# that. SP_DELTA_REL_FRO sits between that run's noise (a leaf's relative
# error at most 0.13 at seq 64 and 256) and two faults that are global,
# put in a copy of the port (RoPE by chunk-local positions 1.29-1.31, the
# sp sum of the gradients dropped 1.16-1.23); a fault on a chunk's border
# (the shift made on the chunk) touches sp - 1 of 8192 targets here and
# is held by tests/test_torch_sp.py, not by this bound (PERF.md). The
# card's share of sampled elements parted by more than SP_DELTA_ATOL of
# the leaf's largest change (8.2-18.7 %) is printed, not held
SP_WORLD = 4
SP_SEQ = 8192
SP_LAYERS = 4
SP_GLOBAL_BATCH = 2
SP_STEPS = 2
SP_LOSS_RTOL = 5e-4
SP_DELTA_ATOL = 1e-2
SP_DELTA_REL_FRO = 0.35
SP_TIMEOUT_S = 300
# bf16 dense peak of an H100 SXM, for MFU (PERF.md section 2)
PEAK_FLOPS = 989e12
# manifests, commit votes and the tracker beside a persisted step's leaves
CKPT_DISK_SLACK = 64 << 20
# a PCIe link's transfer rate a lane (GT/s) by generation; gens 1-2 encode
# 8b/10b, later ones 128b/130b
PCIE_GT_PER_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}
# the H100 SXM's link, taken when nvidia-smi cannot read the link
H100_PCIE = (5, 16)
CRC_CHUNK = 256 << 20  # bytes a device-to-host copy for a leaf's CRC32


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_usage(log):
    """[(kernel, "registers, spills")] from nvcc's -Xptxas -v output."""
    import re

    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?\d(flash_(?:fwd|bwd_dq|bwd_dkv)"
                      r"_kernel)ILi(\d+)E", line)
        m_ce = re.search(r"Function properties for \S*?\d(fused_ce_\w+?_kernel)",
                         line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif m_ce:
            kernel = m_ce.group(1)
        elif "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers; {spills}"))
            kernel = None
    return out


# kernels a wrapper of KERNELS launches after its own, in the same C call,
# whose output is that wrapper's and is held with it against the plain
# version: flash_bwd_dkv's group sum (GQA) adds the query heads' partials
HELD_BY = {"flash_dkv_sum": "flash_bwd_dkv"}
# the kernels that run wgmma with TMA loads (HGMMA and UTMALDG in their
# SASS), and those that must show neither; every kernel is in one of them
WGMMA_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_q", "fused_ce_bwd_dx",
                 "fused_ce_bwd_dw", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv")
NO_WGMMA_KERNELS = ("fused_ce_merge", "flash_dkv_sum")


def sass_counts(library):
    """{kernel instance: (HGMMA, UTMALDG) instruction count} in the SASS of
    a built library; an instance is a kernel's name (``fused_ce_bwd_q``)
    or, for a template, its name and head dim (``flash_fwd<128>``)."""
    import re

    from dlrover_tpu_torch.ops import cuda_build

    out = subprocess.run(
        [cuda_build.toolkit_binary("cuobjdump"), "-sass", str(library)],
        capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    counts, kernel = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(r"\d((?:fused_ce|flash)_\w+?)_kernel(?:ILi(\d+)E)?",
                          line)
            kernel = None
            if m:
                kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
                counts[kernel] = [0, 0]
        elif kernel:
            counts[kernel][0] += "HGMMA" in line
            counts[kernel][1] += "UTMALDG" in line
    return {k: tuple(v) for k, v in counts.items()}


def check_sass(sass):
    """Each kernel of KERNELS, CE_KERNELS and HELD_BY is in the SASS; every
    instance of a WGMMA_KERNELS kernel has HGMMA and UTMALDG, every
    instance of a NO_WGMMA_KERNELS kernel has neither."""
    for kname in [k for k, _, _ in KERNELS + CE_KERNELS] + list(HELD_BY):
        found = {inst: c for inst, c in sass.items()
                 if inst.split("<")[0] == kname}
        check(found, f"{kname}_kernel not in the SASS")
        for inst, (hgmma, tma) in sorted(found.items()):
            print(f"  sass {inst}: {hgmma} HGMMA, {tma} UTMALDG", flush=True)
            if kname in WGMMA_KERNELS:
                check(hgmma > 0 and tma > 0,
                      f"{inst} has no HGMMA or no UTMALDG: {(hgmma, tma)}")
            else:
                check(hgmma == 0 and tma == 0,
                      f"{inst} should run no wgmma or TMA: {(hgmma, tma)}")


def settle(torch):
    """Synchronise, then leave the card idle for IDLE_GAP_S."""
    torch.cuda.synchronize()
    time.sleep(IDLE_GAP_S)


def clocks_line():
    """The SM clock and power draw now, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return (out.stdout.strip().splitlines() or ["?"])[0]


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back
    calls, timed with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, stream=None, reps=20, iters=5):
    """Mean device milliseconds of one ``fn()``, read from a CUDA graph
    that holds ``reps`` calls back to back and is replayed ``iters`` times
    between CUDA events. A replay is one launch, so no host launch gap and
    no Python overhead enters the time: it is what a short kernel (the
    merge) or a call of several kernels (SDPA's backward through autograd)
    costs the device. ``stream`` is the capture stream: an autograd
    backward runs on the stream its forward ran on, so to capture a
    backward, pass that stream."""
    stream = stream or torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):  # capture wants warm calls on a side stream
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay, iters=iters, warmup=1) / reps


def visible_pairs(sq, sk, causal):
    if not causal:
        return sq * sk
    return sum(min(q + 1, sk) for q in range(sq))


def bounds(case):
    """(fwd, dq, dkv) -> (bound_ms, bound_by): the larger of the tensor-core
    time of the products the visible (q, k) pairs need and the time to move
    each input once and each output once."""
    b, s, h, hkv, d = (case[k] for k in ("b", "s", "h", "hkv", "d"))
    pairs = b * h * visible_pairs(s, s, case["causal"])
    qo = b * s * h * d * 2        # bytes of q (and of o, do, dq)
    kv = b * s * hkv * d * 2      # bytes of k (and of v, dk, dv)
    vec = b * h * s * 4           # bytes of lse (and of delta)
    work = {
        "flash_fwd": (4 * d * pairs, 2 * qo + 2 * kv + vec),
        "flash_bwd_dq": (6 * d * pairs, 3 * qo + 2 * kv + 2 * vec),
        "flash_bwd_dkv": (8 * d * pairs, 2 * qo + 4 * kv + 2 * vec),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def compare(got, ref):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    peak = ref.abs().max().item()
    fro = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    return err, peak, fro


def check_dkv_deterministic(torch, attention, case=MAIN_CASE):
    """flash_bwd_dkv twice on the same inputs at ``case`` (group 4 at the
    main case): dk and dv must be the same bits both times."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    b, s, h, hkv, d, causal = (case[k] for k in
                               ("b", "s", "h", "hkv", "d", "causal"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), \
        rnd(b, s, h, d)
    o, lse = attention.flash_fwd(q, k, v, causal)
    delta = attention.attention_delta(o, do, torch.zeros_like(lse))
    runs = [attention.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
            for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    print(f"  flash_bwd_dkv twice at group {h // hkv} ({case}): dk bitwise "
          f"{same[0]}, dv bitwise {same[1]}", flush=True)
    check(all(same), f"flash_bwd_dkv is not deterministic: dk, dv equal "
          f"{same}")


def check_flash_case(torch, attention, label, case, gen):
    """The three flash kernels against their plain versions on random bf16
    inputs of ``case`` (with a random ``lse`` cotangent folded into delta);
    returns each kernel's worst max-abs error and the inputs."""
    b, s, h, hkv, d, causal = (case[k] for k in
                               ("b", "s", "h", "hkv", "d", "causal"))

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, k, v, do = rnd(b, s, h, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), \
        rnd(b, s, h, d)
    g_lse = 0.1 * torch.randn((b, h, s), generator=gen, device="cuda")
    o_p, lse_p = attention.mha_reference_with_lse(q, k, v, causal)
    o_k, lse_k = attention.flash_fwd(q, k, v, causal)
    # the backward kernels and their plain versions share lse and delta
    delta = attention.attention_delta(o_p, do, g_lse)
    dq_p = attention.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, causal)
    dq_k = attention.flash_bwd_dq(q, k, v, do, lse_p, delta, causal)
    dk_p, dv_p = attention.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta,
                                               causal)
    dk_k, dv_k = attention.flash_bwd_dkv(q, k, v, do, lse_p, delta, causal)
    torch.cuda.synchronize()
    results = {
        "flash_fwd": [("o", o_k, o_p)],
        "flash_bwd_dq": [("dq", dq_k, dq_p)],
        "flash_bwd_dkv": [("dk", dk_k, dk_p), ("dv", dv_k, dv_p)],
    }
    lse_err = (lse_k - lse_p).abs().max().item()
    print(f"  [{label}] {case}: lse max_abs_err {lse_err:.3e} "
          f"(tol {LSE_ABS_TOL})", flush=True)
    check(lse_err <= LSE_ABS_TOL, f"{label}: lse error {lse_err}")
    worst = {}
    for name, outs in results.items():
        worst[name] = 0.0
        for tag, got, ref in outs:
            err, peak, fro = compare(got, ref)
            worst[name] = max(worst[name], err)
            print(f"  [{label}] {name} {tag}: max_abs_err {err:.3e} "
                  f"(max|ref| {peak:.3e}, tol {REL_MAX_TOL * peak:.3e}) "
                  f"rel_fro {fro:.3e} (tol {REL_FRO_TOL})", flush=True)
            check(math.isfinite(err) and err <= REL_MAX_TOL * peak,
                  f"{label}: {name} {tag} max error {err} > "
                  f"{REL_MAX_TOL} * {peak}")
            check(fro <= REL_FRO_TOL,
                  f"{label}: {name} {tag} relative error {fro}")
    return worst, (q, k, v, do, lse_p, delta)


def phase_kernels(torch, attention):
    """Every case of ``CASES`` against the plain versions; returns the
    main case's worst error a kernel and its inputs, and the same for
    each of ``TP_LOCAL_CASES`` (``{label: (errors, inputs)}``)."""
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errors = {}
    timing = None
    tp_local = {}
    for label, case in CASES:
        worst, inputs = check_flash_case(torch, attention, label, case, gen)
        if label == "main":
            errors, timing = worst, inputs
        if label in TP_LOCAL_CASES:
            tp_local[label] = (worst, inputs)
    return errors, timing, tp_local


def _flash_runs(attention, inputs, c):
    """name -> (kernel call, plain call) of the three flash kernels on
    ``inputs`` (q, k, v, do, lse, delta), causal ``c``."""
    q, k, v, do, lse, delta = inputs
    return {
        "flash_fwd": (lambda: attention.flash_fwd(q, k, v, c),
                      lambda: attention.mha_reference_with_lse(q, k, v, c)),
        "flash_bwd_dq": (
            lambda: attention.flash_bwd_dq(q, k, v, do, lse, delta, c),
            lambda: attention.flash_bwd_dq_plain(q, k, v, do, lse, delta, c)),
        "flash_bwd_dkv": (
            lambda: attention.flash_bwd_dkv(q, k, v, do, lse, delta, c),
            lambda: attention.flash_bwd_dkv_plain(q, k, v, do, lse, delta, c)),
    }


def time_flash_case(torch, attention, label, case, errs, inputs):
    """Each flash kernel and its plain version timed once at ``case`` on
    ``inputs`` (after the idle gap, by CUDA events), with the case's bound
    and ``errs``, the kernels' worst errors there: ``{kernel: {h, hkv, ms,
    plain_ms, bound_ms, bound_by, max_abs_err}}``."""
    bound = bounds(case)
    out = {}
    for name, (kernel, plain) in _flash_runs(attention, inputs,
                                             case["causal"]).items():
        settle(torch)
        k_ms = cuda_ms(torch, kernel)
        p_ms = cuda_ms(torch, plain, iters=5)
        out[name] = {
            "h": case["h"], "hkv": case["hkv"], "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": bound[name][0],
            "bound_by": bound[name][1], "max_abs_err": errs[name]}
        print(f"  [{label}] {name}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"bound {bound[name][0]:.4f} ms ({bound[name][1]}), "
              f"{k_ms / bound[name][0]:.2f}x bound; sm clock, power: "
              f"{clocks_line()}", flush=True)
    return out


def phase_tp_timing(torch, attention, tp_local):
    """``time_flash_case`` at each of the tp leg's local head counts:
    ``{label: {kernel: {...}}}``."""
    return {label: time_flash_case(torch, attention, label,
                                   dict(CASES)[label], *tp_local[label])
            for label in TP_LOCAL_CASES}


def phase_timing(torch, F, attention, inputs):
    q, k, v, do, lse, delta = inputs
    c = MAIN_CASE["causal"]
    runs = _flash_runs(attention, inputs, c)
    times = {}
    for name, (kernel, plain) in runs.items():
        settle(torch)
        # plain, kernel, kernel, plain: the two orders average out drift
        p1 = cuda_ms(torch, plain, iters=5)
        k1 = cuda_ms(torch, kernel)
        k2 = cuda_ms(torch, kernel)
        p2 = cuda_ms(torch, plain, iters=5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  {name} timed; sm clock, power: {clocks_line()}", flush=True)

    # library yardstick: SDPA in (b, h, s, d), timed only, by graph replay
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    settle(torch)
    sdpa_fwd = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=c, enable_gqa=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=c,
                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    settle(torch)
    sdpa_bwd = graph_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True), stream=side)
    print(f"  sdpa timed; sm clock, power: {clocks_line()}", flush=True)
    return times, sdpa_fwd, sdpa_bwd


def ce_inputs(torch, gen, case):
    """bf16 tokens, an f32 lm-head at the model's init scale and int32
    targets for one CE case."""
    n, d, v = case["n"], case["d"], case["v"]
    x = torch.randn((n, d), generator=gen, device="cuda").to(torch.bfloat16)
    w = 0.02 * torch.randn((d, v), generator=gen, device="cuda")
    tgt = torch.randint(0, v, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    kind = case["targets"]
    if kind == "main":
        tgt[::97] = -1
        tgt[-1] = -1  # the last position of a sequence has no target
    elif kind == "ragged":
        tgt[::13] = -1
    elif kind == "all_masked":
        tgt[:] = -1
    elif kind == "last_column":
        tgt[:] = v - 1
    return x, w, tgt


class _Worst:
    """Running max |got - ref|, max |ref| and Frobenius sums over parts."""

    def __init__(self):
        self.err = self.peak = self.diff_sq = self.ref_sq = 0.0

    def add(self, got, ref):
        got, ref = got.float(), ref.float()
        self.err = max(self.err, (got - ref).abs().max().item())
        self.peak = max(self.peak, ref.abs().max().item())
        self.diff_sq += (got - ref).norm().item() ** 2
        self.ref_sq += ref.norm().item() ** 2

    def check(self, label, name):
        fro = math.sqrt(self.diff_sq) / max(math.sqrt(self.ref_sq), 1e-30)
        print(f"  [{label}] {name}: max_abs_err {self.err:.3e} (max|ref| "
              f"{self.peak:.3e}, tol {REL_MAX_TOL * self.peak:.3e}) rel_fro "
              f"{fro:.3e} (tol {REL_FRO_TOL})", flush=True)
        check(math.isfinite(self.err) and self.err <= REL_MAX_TOL * self.peak,
              f"{label}: {name} max error {self.err} > {REL_MAX_TOL} * "
              f"{self.peak}")
        check(fro <= REL_FRO_TOL, f"{label}: {name} relative error {fro}")
        return self.err


def phase_ce_kernels(torch, fce):
    """Each fused-CE kernel against its plain version on the same inputs:
    the forward kernel's partials go through the plain merge, the merge
    kernel takes the plain partials, and the q, dx and dw kernels take the
    plain logz and q, so each comparison isolates one kernel."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    errors, timing = {}, None
    for label, case in CE_CASES:
        x, w, tgt = ce_inputs(torch, gen, case)
        v = case["v"]
        wc = fce.compute_weight(w, torch.bfloat16)
        part_p = fce.fused_ce_fwd_plain(x, wc, tgt, v)
        part_k = fce.fused_ce_fwd(x, wc, tgt, v)
        logz_p, gold_p = fce.fused_ce_merge_plain(part_p)
        logz_f, gold_f = fce.fused_ce_merge_plain(part_k)
        logz_m, gold_m = fce.fused_ce_merge(part_p)
        logz_k, gold_k = fce.fused_ce_merge(part_k)
        vf = (tgt >= 0).float()
        nll_p = ((logz_p - gold_p) * vf).sum().item()
        nll_k = ((logz_k - gold_k) * vf).sum().item()
        torch.cuda.synchronize()
        fwd_err = max((logz_f - logz_p).abs().max().item(),
                      (gold_f - gold_p).abs().max().item())
        merge_err = max((logz_m - logz_p).abs().max().item(),
                        (gold_m - gold_p).abs().max().item())
        nll_rel = abs(nll_k - nll_p) / max(abs(nll_p), 1e-30)
        print(f"  [{label}] n={case['n']} d={case['d']} v={v}: fwd logz/gold "
              f"max_abs_err {fwd_err:.3e}, merge {merge_err:.3e} (tol "
              f"{CE_LOGZ_ABS_TOL}); nll_sum {nll_k:.6e} vs {nll_p:.6e}, "
              f"rel {nll_rel:.3e} (tol {CE_NLL_REL_TOL}); n_valid "
              f"{int(vf.sum().item())}", flush=True)
        check(fwd_err <= CE_LOGZ_ABS_TOL, f"{label}: fwd error {fwd_err}")
        check(merge_err <= CE_LOGZ_ABS_TOL,
              f"{label}: merge error {merge_err}")
        check(nll_rel <= CE_NLL_REL_TOL, f"{label}: nll_sum error {nll_rel}")

        row_scale = vf.contiguous()
        n, d = x.shape
        dx_p = torch.zeros((n, d), dtype=torch.float32, device="cuda")
        dx_k = torch.zeros_like(dx_p)
        dw_p = torch.empty((d, v), dtype=torch.float32, device="cuda")
        dw_k = torch.empty_like(dw_p)
        q_worst = _Worst()
        first_q = None
        for c0, cw in fce._chunks(wc.shape[1]):
            q_p = fce.fused_ce_bwd_q_plain(x, wc, tgt, logz_p, row_scale, v,
                                           c0, cw)
            q_k = fce.fused_ce_bwd_q(x, wc, tgt, logz_p, row_scale, v, c0, cw)
            q_worst.add(q_k, q_p)
            fce.fused_ce_bwd_dx_plain(q_p, wc, c0, dx_p)
            fce.fused_ce_bwd_dx(q_p, wc, c0, dx_k)
            fce.fused_ce_bwd_dw_plain(x, q_p, v, c0, dw_p)
            fce.fused_ce_bwd_dw(x, q_p, v, c0, dw_k)
            first_q = q_p if first_q is None else first_q
        torch.cuda.synchronize()
        worst = {"fused_ce_fwd": fwd_err, "fused_ce_merge": merge_err,
                 "fused_ce_bwd_q": q_worst.check(label, "bwd_q q")}
        for name, got, ref in (("fused_ce_bwd_dx", dx_k, dx_p),
                               ("fused_ce_bwd_dw", dw_k, dw_p)):
            one = _Worst()
            one.add(got, ref)
            worst[name] = one.check(label, name)
        if label == "main":
            errors = worst
            timing = (x, w, wc, tgt, part_p, logz_p, row_scale, first_q,
                      dx_k, dw_k)
    return errors, timing


def ce_work(n, d, v, cw, tile):
    """Per-kernel (tensor-core FLOPs or None, bytes): the products' FLOPs
    and each input read once and each output written once."""
    vp = -(-v // 8) * 8
    ntiles = -(-v // tile)
    part = 3 * n * ntiles * 4
    return {
        "fused_ce_fwd": (2 * n * d * v, n * d * 2 + d * vp * 2 + n * 4 + part),
        "fused_ce_merge": (None, part + 2 * n * 4),
        "fused_ce_bwd_q": (2 * n * d * cw,
                           n * d * 2 + d * cw * 2 + 3 * n * 4 + n * cw * 2),
        "fused_ce_bwd_dx": (2 * n * cw * d,
                            n * cw * 2 + d * cw * 2 + 2 * n * d * 4),
        "fused_ce_bwd_dw": (2 * d * n * cw, n * d * 2 + n * cw * 2 + d * cw * 4),
    }


def ce_bounds(n, d, v, cw, tile):
    """Per-kernel (bound_ms, bound_by) at these dims: the larger of the
    tensor-core time of the kernel's products and the time to read each
    input once and write each output once. The merge does ~10 f32
    operations per partial on the 67 TFLOP/s non-tensor path."""
    ntiles = -(-v // tile)
    out = {}
    for name, (flops, nbytes) in ce_work(n, d, v, cw, tile).items():
        t_ops = (10 * n * ntiles / 67e12 if flops is None
                 else flops / PEAK_BF16_FLOPS) * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        out[name] = ((t_ops, "operations") if t_ops >= t_bytes
                     else (t_bytes, "bytes"))
    return out


def phase_ce_timing(torch, fce, chunked_ce, inputs):
    """Each CE kernel at the main shape (the backward ones on one
    BWD_CHUNK-column chunk, as the main path launches them), its plain
    version, and ``torch.mm`` of the same product; then the whole forward
    and backward, fused against chunked."""
    x, w, wc, tgt, part, logz, row_scale, q, dx, dw = inputs
    v = w.shape[1]
    cw = q.shape[1]
    f32 = torch.float32
    runs = {
        "fused_ce_fwd": (
            lambda: fce.fused_ce_fwd(x, wc, tgt, v),
            lambda: fce.fused_ce_fwd_plain(x, wc, tgt, v),
            lambda: torch.mm(x, wc[:, :v], out_dtype=f32)),
        "fused_ce_merge": (
            lambda: fce.fused_ce_merge(part),
            lambda: fce.fused_ce_merge_plain(part), None),
        "fused_ce_bwd_q": (
            lambda: fce.fused_ce_bwd_q(x, wc, tgt, logz, row_scale, v, 0, cw),
            lambda: fce.fused_ce_bwd_q_plain(x, wc, tgt, logz, row_scale, v,
                                             0, cw),
            lambda: torch.mm(x, wc[:, :cw], out_dtype=f32)),
        "fused_ce_bwd_dx": (
            lambda: fce.fused_ce_bwd_dx(q, wc, 0, dx),
            lambda: fce.fused_ce_bwd_dx_plain(q, wc, 0, dx),
            lambda: torch.mm(q, wc[:, :cw].t(), out_dtype=f32)),
        "fused_ce_bwd_dw": (
            lambda: fce.fused_ce_bwd_dw(x, q, v, 0, dw),
            lambda: fce.fused_ce_bwd_dw_plain(x, q, v, 0, dw),
            lambda: torch.mm(x.t(), q, out_dtype=f32)),
    }
    times = {}
    for name, (kernel, plain, library) in runs.items():
        settle(torch)
        # the merge's launches are shorter than the host's: graph replay
        timer = graph_ms if name == "fused_ce_merge" else cuda_ms
        # plain, kernel, kernel, plain: the two orders average out drift
        p1 = timer(torch, plain, iters=5)
        k1 = timer(torch, kernel)
        k2 = timer(torch, kernel)
        p2 = timer(torch, plain, iters=5)
        lib = cuda_ms(torch, library) if library else None
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, lib)
        print(f"  {name} timed; sm clock, power: {clocks_line()}", flush=True)

    xr = x.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(xr, wr, tgt)[0], (xr, wr))

    fused = fwd_bwd(fce.fused_cross_entropy)
    chunked = fwd_bwd(lambda a, b, t: chunked_ce.chunked_cross_entropy(
        a, b, t, chunk_size=2048))
    c1 = cuda_ms(torch, chunked, iters=5, warmup=1)
    f1 = cuda_ms(torch, fused, iters=5, warmup=1)
    f2 = cuda_ms(torch, fused, iters=5, warmup=1)
    c2 = cuda_ms(torch, chunked, iters=5, warmup=1)
    whole = ((f1 + f2) / 2, (c1 + c2) / 2)
    return times, whole, ce_bounds(x.shape[0], x.shape[1], v, cw,
                                   fce.FWD_TILE)


def _launch_counts(attention, fce):
    """Every kernel's launch count, keyed by its JSON name."""
    counts = {name: attention.launch_counts[key] for name, key, _ in KERNELS}
    counts.update({name: fce.launch_counts[key] for name, key, _ in CE_KERNELS})
    return counts


def _reset_counts(attention, fce, chunked_calls):
    attention.reset_launch_counts()
    fce.reset_launch_counts()
    chunked_calls[0] = 0


def _llama_run(torch, attention, fce, chunked_calls, label):
    from dlrover_tpu_torch.run import llama_pretrain

    args = llama_pretrain.parse_args([
        "--model", "8b", "--layers", "4", "--seq", "2048",
        "--micro-batch", "1", "--global-batch", "2", "--steps", "4",
        "--device", "cuda", "--seed", "0",
    ])
    torch.cuda.empty_cache()
    _reset_counts(attention, fce, chunked_calls)
    result = llama_pretrain.run(args, log=lambda m: print(f"  [{label}] {m}",
                                                          flush=True))
    counts = _launch_counts(attention, fce)
    print(f"  [{label}] params {result['params']}, tokens/step "
          f"{result['tokens_per_step']}, step_s {result['step_s']}, "
          f"tokens/s (steps 2-4) {result['tokens_per_s']:.1f}, "
          f"max_memory_allocated {result['max_memory_bytes']} bytes",
          flush=True)
    print(f"  [{label}] kernel launches: {counts}; chunked CE calls "
          f"{chunked_calls[0]}", flush=True)
    losses = result["losses"]
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    return counts, result


def phase_main_path(torch, attention, fce, chunked_calls):
    """The Llama main path with the flag at its default (fused CE), then
    the same steps under ``DLROVER_TPU_FUSED_CE=0`` (chunked CE)."""
    saved = os.environ.pop("DLROVER_TPU_FUSED_CE", None)
    try:
        counts, result = _llama_run(torch, attention, fce, chunked_calls,
                                    "fused")
        losses = result["losses"]
        # at random init the final-norm hidden state has norm sqrt(dim), so
        # the logits are ~N(0, sigma^2) with sigma = 0.02 sqrt(4096) = 1.28,
        # and the expected loss is ln(vocab) + sigma^2 / 2 = 11.76 + 0.82
        expected = math.log(128256) + 0.5 * (0.02 ** 2) * 4096
        print(f"  step-1 loss {losses[0]:.4f}, expected {expected:.4f} "
              f"(ln(128256) + sigma^2/2), tol 0.5", flush=True)
        check(abs(losses[0] - expected) < 0.5,
              f"step-1 loss {losses[0]} not within 0.5 of {expected}")
        for name in counts:
            check(counts[name] > 0,
                  f"kernel {name} never launched on the main path")
        check(chunked_calls[0] == 0, "the chunked CE ran on the fused path")

        os.environ["DLROVER_TPU_FUSED_CE"] = "0"
        c_counts, c_result = _llama_run(torch, attention, fce, chunked_calls,
                                        "chunked")
    finally:
        os.environ.pop("DLROVER_TPU_FUSED_CE", None)
        if saved is not None:
            os.environ["DLROVER_TPU_FUSED_CE"] = saved
    check(chunked_calls[0] > 0, "DLROVER_TPU_FUSED_CE=0 did not take the "
          "chunked CE")
    check(not any(c_counts[name] for name, _, _ in CE_KERNELS),
          "a fused-CE kernel ran under DLROVER_TPU_FUSED_CE=0")
    diff = abs(c_result["losses"][0] - losses[0])
    print(f"  fused vs chunked: step-1 loss {losses[0]:.5f} vs "
          f"{c_result['losses'][0]:.5f}, diff {diff:.2e} (tol "
          f"{FUSED_VS_CHUNKED_LOSS_TOL}); tokens/s {result['tokens_per_s']:.1f}"
          f" vs {c_result['tokens_per_s']:.1f}; max_memory_allocated "
          f"{result['max_memory_bytes']} vs {c_result['max_memory_bytes']} "
          f"bytes", flush=True)
    check(diff <= FUSED_VS_CHUNKED_LOSS_TOL,
          f"fused and chunked step-1 losses differ by {diff}")
    return counts, result


def phase_vit(torch, attention, fce, chunked_calls):
    """ViT-B/16 through run/vit_classify.py on the flash and CE kernels."""
    from dlrover_tpu_torch.run import vit_classify

    args = vit_classify.parse_args([
        "--model", "b16", "--micro-batch", "64", "--global-batch", "128",
        "--steps", "4", "--device", "cuda", "--seed", "0",
    ])
    torch.cuda.empty_cache()
    _reset_counts(attention, fce, chunked_calls)
    result = vit_classify.run(args, log=lambda m: print("  " + m, flush=True))
    counts = _launch_counts(attention, fce)
    losses = result["losses"]
    print(f"  params {result['params']}, images/step "
          f"{result['images_per_step']}, step_s {result['step_s']}, "
          f"images/s (steps 2-4) {result['images_per_s']:.1f}, "
          f"max_memory_allocated {result['max_memory_bytes']} bytes",
          flush=True)
    print(f"  kernel launches: {counts}", flush=True)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # the pooled feature is the mean of 196 rms-normed tokens (unit RMS
    # each), so its mean square sigma^2 lies in [0, 1]; the head is
    # N(0, 1/768), so the logits are ~N(0, sigma^2) and the expected loss
    # is ln(1000) + sigma^2 / 2, in [6.908, 7.408]; 0.1 on either side
    # covers the spread of a 64-image mean
    lo, hi = math.log(1000) - 0.1, math.log(1000) + 0.5 + 0.1
    print(f"  step-1 loss {losses[0]:.4f}, expected in [{lo:.3f}, {hi:.3f}] "
          f"(ln(1000) + sigma^2/2, sigma^2 in [0, 1])", flush=True)
    check(lo <= losses[0] <= hi, f"ViT step-1 loss {losses[0]}")
    for name in counts:
        check(counts[name] > 0, f"kernel {name} never launched on ViT-B/16")
    check(chunked_calls[0] == 0, "the chunked CE ran on the ViT path")
    return counts, result


def ckpt_state_bytes(n_params):
    """Bytes of the train state's tensors: f32 params and adam's f32 mu and
    nu (the three 4-byte scalars of step, count and lr_scale aside)."""
    return 3 * 4 * n_params


def ckpt_disk_peak(nbytes):
    """The disk phase 4c needs at its peak: one persisted step of
    ``nbytes``, on the local and the object tier, and ``CKPT_DISK_SLACK``.
    Each leg removes its directory once its restore is checked, so no two
    persisted steps are on disk at once."""
    return 2 * nbytes + CKPT_DISK_SLACK


def snapshot_bound_ms(nbytes):
    """The device snapshot reads every byte once and writes it once."""
    return 2 * nbytes / PEAK_BYTES_PER_S * 1e3


def pcie_bytes_per_s(gen, width):
    """One direction of a PCIe link: lanes times the lane's transfer rate
    times the encoding's payload share, in bytes."""
    payload = 8 / 10 if gen <= 2 else 128 / 130
    return PCIE_GT_PER_S[gen] * 1e9 * width * payload / 8


def pcie_link(line):
    """(gen, width, note) from nvidia-smi's ``pcie.link.gen.max,
    pcie.link.width.max`` line; the H100 SXM's Gen5 x16 where it reads no
    number ([N/A] in a sandbox)."""
    try:
        gen, width = (int(x) for x in line.split(","))
        return gen, width, "as nvidia-smi reads it"
    except ValueError:
        return (*H100_PCIE, f"nvidia-smi reads {line.strip()!r}: the H100 "
                "SXM's Gen5 x16")


def check_space(path, need, what, statvfs=os.statvfs):
    """The bytes free under ``path``; fails, naming the shortfall, when
    they are fewer than ``need``."""
    st = statvfs(path)
    free = st.f_bavail * st.f_frsize
    check(free >= need, f"{what} {path} has {free} bytes free, the state "
          f"needs {need}: {need - free} bytes short")
    return free


def crc_table(named, crc_of=lambda v: zlib.crc32(memoryview(v)),
              workers=8):
    """{name: ``crc_of(value)``}, by default the zlib.crc32 of a bytes-like
    value, computed by a pool (the crc releases the interpreter lock)."""
    def one(item):
        name, value = item
        return name, crc_of(value)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return dict(pool.map(one, named.items()))


def compare_crcs(want, got, label):
    """Every leaf of ``want`` in ``got`` with the same CRC32, and no other."""
    check(sorted(got) == sorted(want),
          f"{label}: leaves differ: missing {sorted(set(want) - set(got))[:3]}"
          f", extra {sorted(set(got) - set(want))[:3]}")
    bad = [n for n in want if got[n] != want[n]]
    check(not bad, f"{label}: {len(bad)} leaves differ in CRC32, first "
          f"{bad[0] if bad else ''}: {want.get(bad[0]) if bad else ''} vs "
          f"{got.get(bad[0]) if bad else ''}")


def check_breakpoint_step(staged, manifest, restored):
    """A killed child's step persisted at the breakpoint: the manifest the
    saver wrote and the disk restore both hold, leaf for leaf, the CRC32 of
    what the child staged, so the dead process's bytes reached disk and
    came back."""
    compare_crcs(staged, manifest, "breakpoint manifest against the killed "
                 "child's segment")
    compare_crcs(staged, restored, "disk restore of the breakpoint step "
                 "against the killed child's segment")


def check_agent_persist(saves, persist_log, committed):
    """The agent leg: saves of steps 1-3, step 2's persist queued to the
    saver, which copied step 2 alone and committed it. Returns step 2's
    pause, the seconds step 3's stage waited for the saver, and the
    saver's copy (shm to the local tier) and fanout (to the object tier,
    and the commit) seconds."""
    by_step = {s["step"]: s["stage"] or {} for s in saves}
    check(sorted(by_step) == [1, 2, 3], f"the agent child saved steps "
          f"{sorted(by_step)}, not 1-3")
    modes = [by_step[k].get("persist") for k in (1, 2, 3)]
    check(modes == [None, "queued", None], f"persists of saves 1-3: "
          f"{modes}, not save 2's queued to the saver")
    check("wait_s" in by_step[3], "save 3's stage recorded no wait")
    entries = [e for e in persist_log if e["step"] == 2]
    check(len(entries) == 1 and entries[0].get("steps") == [2]
          and "fanout_s" in entries[0], f"the saver's persists of step 2: "
          f"{entries}")
    check(committed == 2, f"the saver committed step {committed}, not 2")
    blocking = {s["step"]: s["blocking_s"] for s in saves}
    return (blocking[2], by_step[3]["wait_s"], entries[0]["copy_s"],
            entries[0]["fanout_s"])


def parse_metrics(text):
    """{name: value} of a prometheus text body's samples without labels."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#") or "{" in line:
            continue
        name, _, value = line.partition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


class Poller:
    """Calls ``read`` every ``period`` seconds in a thread while it is
    entered, keeping the last result that is not None (``value``; a read
    that raises OSError or ValueError is skipped)."""

    def __init__(self, read, period=METRICS_POLL_S):
        self.value = None
        self._read, self._period = read, period
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(self._period):
            try:
                value = self._read()
            except (OSError, ValueError):
                continue
            if value is not None:
                self.value = value

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)


class MetricsPoller(Poller):
    """Reads ``http://127.0.0.1:<port>/metrics`` every METRICS_POLL_S while
    it is entered: ``text``, the last body (labelled samples included);
    ``last``, its samples without labels (empty until the master
    serves)."""

    def __init__(self, port):
        import urllib.request

        def read():
            url = f"http://127.0.0.1:{port}/metrics"
            with urllib.request.urlopen(url, timeout=2) as resp:
                return resp.read().decode()

        super().__init__(read)
        self.port = port

    @property
    def text(self):
        return self.value or ""

    @property
    def last(self):
        return parse_metrics(self.text)


MASTER_SUMMARY = re.compile(
    r"goodput ([0-9.]+), downtime ([0-9.]+)s, global step (-?\d+), "
    r"stragglers (\[[^\]]*\]); attribution (\{.*\}); downtime brackets "
    r"(\[.*\])")


def master_reading(lines):
    """What the master logged at its exit (``LocalJobMaster.goodput_
    summary``): goodput, downtime seconds, global step, straggler ids, the
    attribution and the closed downtime brackets."""
    for line in reversed(lines):
        m = MASTER_SUMMARY.search(line)
        if m:
            return {"goodput": float(m.group(1)),
                    "downtime_s": float(m.group(2)),
                    "global_step": int(m.group(3)),
                    "stragglers": json.loads(m.group(4)),
                    "attribution": json.loads(m.group(5)),
                    "brackets": json.loads(m.group(6))}
    raise SmokeFailure("the master logged no goodput summary at its exit")


def check_master_downtime(brackets, detected_t, step_end_t, slack_s):
    """The master's downtime for one kill: one bracket, from the failure
    report to the second life's first step report, inside the span from
    the agent's detection to the end of that life's first step, widened by
    ``slack_s`` (one step report interval) on each side. Returns its
    seconds."""
    check(len(brackets) == 1, f"the master closed {len(brackets)} downtime "
          f"brackets, not one: {brackets}")
    start, end = brackets[0]
    lo, hi = detected_t - slack_s, step_end_t + slack_s
    check(lo <= start <= end <= hi,
          f"the master's downtime bracket [{start:.3f}, {end:.3f}] is not "
          f"inside [{lo:.3f}, {hi:.3f}]: the agent's detection to the end of "
          f"the second life's first step, widened by {slack_s} s")
    return end - start


def check_master_gauges(gauges, reading):
    """The master's last ``/metrics`` reading and its exit summary: served,
    goodput in (0, 1], and no straggler flagged (a one-worker job has no
    fleet to straggle in)."""
    check(gauges, "the master's /metrics was never read")
    for label, goodput in (("gauge", gauges.get("dlrover_tpu_master_goodput")),
                           ("exit", reading["goodput"])):
        check(goodput is not None and 0.0 < goodput <= 1.0,
              f"the master's goodput ({label}) is {goodput}")
    check(gauges.get("dlrover_tpu_master_stragglers") == 0
          and reading["stragglers"] == [],
          f"a straggler was flagged in a one-worker job: gauge "
          f"{gauges.get('dlrover_tpu_master_stragglers')}, exit "
          f"{reading['stragglers']}")


def print_master(label, gauges, reading, bracket_s=None,
                 bracket_of="the kill's bracket"):
    """Print the master's last ``/metrics`` reading (none when ``gauges``
    is None: a leg that does not poll it) and its exit summary."""
    polled = "" if gauges is None else (
        f"the master's last /metrics: goodput "
        f"{gauges.get('dlrover_tpu_master_goodput')}, downtime total "
        f"{gauges.get('dlrover_tpu_master_downtime_seconds_total')} s, "
        f"global step {gauges.get('dlrover_tpu_master_global_step')}, "
        f"stragglers {gauges.get('dlrover_tpu_master_stragglers')}; ")
    print(f"  [{label}] {polled}at its exit: goodput {reading['goodput']}, "
          f"downtime {reading['downtime_s']} s, global step "
          f"{reading['global_step']}, stragglers {reading['stragglers']}, "
          f"brackets {reading['brackets']}"
          + ("" if bracket_s is None else
             f" ({bracket_of} {bracket_s:.3f} s)"), flush=True)
    print(f"  [{label}] the master's attribution at its exit: "
          f"{json.dumps(reading['attribution'])}", flush=True)


def report_interval():
    """The seconds between a worker's throttled step reports."""
    from dlrover_tpu_torch.train import bootstrap

    return bootstrap.WorkerContext(bootstrap.WorkerEnv()).step_report_interval


def metrics_env(env):
    """``env`` with the master's /metrics on a free port; returns it and
    the port."""
    from dlrover_tpu_torch.utils.net import find_free_port

    port = find_free_port()
    return dict(env, DLROVER_TPU_MASTER_METRICS_PORT=str(port)), port


def tensor_crcs(torch, named):
    """``crc_table`` of tensors (or arrays): a device tensor's bytes are
    copied to the host in CRC_CHUNK pieces through a pinned buffer of
    each worker's."""
    from dlrover_tpu_torch.checkpoint.shm_handler import as_bytes

    local = threading.local()

    def crc(value):
        with torch.no_grad():
            flat = as_bytes(value)
        if not flat.is_cuda:
            return zlib.crc32(memoryview(flat.numpy()))
        if not hasattr(local, "buf"):
            local.buf = torch.empty(CRC_CHUNK, dtype=torch.uint8,
                                    pin_memory=True)
        out = 0
        for o in range(0, flat.numel(), CRC_CHUNK):
            n = min(CRC_CHUNK, flat.numel() - o)
            local.buf[:n].copy_(flat[o:o + n])
            out = zlib.crc32(memoryview(local.buf[:n].numpy()), out)
        return out

    return crc_table(named, crc)


def state_crcs(torch, state):
    """The CRC32 of every leaf of a train state under its JAX name."""
    from dlrover_tpu_torch.checkpoint.shm_handler import flatten_state

    return tensor_crcs(torch, {leaf.name: leaf.value
                               for leaf in flatten_state(state)})


def segment_crcs(job):
    """The CRC32 of every leaf staged in the job's shm segment, under its
    leaf name, and the staged step."""
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler, shm_name)

    h = SharedMemoryHandler(shm_name(job, 0, 0))
    try:
        meta = h.read_meta()
        check(meta is not None, f"nothing staged in {h.name}")
        crcs = crc_table(
            {m.path.rsplit("#", 1)[0]: m for m in meta.leaves},
            lambda m: zlib.crc32(memoryview(h.leaf_bytes(m).numpy())))
        return meta.step, crcs
    finally:
        h.close()


def manifest_crcs(ckpt_dir, step):
    """The CRC32 of every leaf in a persisted step's local-tier manifest."""
    from dlrover_tpu_torch.checkpoint.saver import local_tier_dir, step_dir
    from dlrover_tpu_torch.checkpoint.shm_handler import CheckpointMeta

    path = os.path.join(step_dir(local_tier_dir(ckpt_dir, 0), step),
                        "proc-0", "meta.json")
    with open(path) as f:
        meta = CheckpointMeta.from_json(f.read())
    return {m.path.rsplit("#", 1)[0]: m.crc32 for m in meta.leaves}


def unlink_segment(job, process_id=0):
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler, shm_name)

    h = SharedMemoryHandler(shm_name(job, 0, process_id))
    if h.attach():
        h.close(unlink=True)


def _ckpt_args(steps, ckpt_dir, save_every):
    from dlrover_tpu_torch.run import llama_pretrain

    return llama_pretrain.parse_args([
        "--model", "8b", "--layers", "4", "--seq", "2048",
        "--micro-batch", "1", "--global-batch", "2", "--steps", str(steps),
        "--device", "cuda", "--seed", "0", "--ckpt-dir", ckpt_dir,
        "--save-every", str(save_every),
    ])


def _print_saves(label, saves, nbytes):
    for save in saves:
        st = save["stage"] or {}
        copy_s = st.get("copy_s")
        rate = (f"{st['device_bytes'] / copy_s / 1e9:.2f} GB/s"
                if copy_s else "n/a")
        persist = (f", persist {st['persist_s']:.3f}s"
                   if "persist_s" in st else
                   f", persist {st['persist']}" if "persist" in st else "")
        print(f"  [{label}] save step {save['step']}: blocking "
              f"{save['blocking_s'] * 1e3:.2f} ms (registering the segment "
              f"{st.get('register_s', float('nan')):.3f}s of it), mode "
              f"{save['mode']}; waited {st.get('wait_s', float('nan')):.3f}"
              f"s for the segment, then stage "
              f"{st.get('stage_s', float('nan')):.3f}s"
              f" (device-to-host "
              f"{copy_s if copy_s is None else round(copy_s, 4)}s of "
              f"{st.get('device_bytes')} bytes, {rate}){persist}",
              flush=True)
        check(st.get("device_bytes") == nbytes,
              f"save {save['step']} staged {st.get('device_bytes')} device "
              f"bytes, not the state's {nbytes}")


def _run_child(role, ckpt_dir, job):
    """Run ``chip_smoke.py --ckpt-child role ckpt_dir`` under the job name
    ``job``, echoing its output; returns its JSON result. Fails on a child
    that fails."""
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--ckpt-child", role,
         ckpt_dir], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, DLROVER_TPU_JOB_NAME=job))
    timer = threading.Timer(CKPT_CHILD_TIMEOUT_S, proc.kill)
    timer.start()
    result = None
    try:
        for line in iter(proc.stdout.readline, ""):
            if line.startswith("CKPT_CHILD_JSON "):
                result = json.loads(line.split(" ", 1)[1])
                continue
            print(f"  [child {role}] {line.rstrip()}", flush=True)
    finally:
        timer.cancel()
        proc.kill()
        proc.wait(timeout=60)
    check(proc.returncode == 0, f"child {role} exited {proc.returncode}")
    check(result is not None, f"child {role} printed no result")
    return result


def ckpt_child(role, ckpt_dir):
    """One child of phase 4c, on the card; prints its result as one JSON
    line. agent: trains steps 1-3, saving each to memory and step 2 to
    storage, and prints its saves. disk: restores (from disk, the segment
    gone) and prints the CRC32s. elastic: the elastic leg's worker, started
    by the agent (``_elastic_life``). The job name, and so the segment and
    the saver's socket, is ``DLROVER_TPU_JOB_NAME``'s."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlrover_tpu_torch.run import llama_pretrain

    if role == "agent":
        result = llama_pretrain.run(_ckpt_args(3, ckpt_dir, 2))
        print(f"step_s {result['step_s']}", flush=True)
        _print_saves("agent", result["saves"], ckpt_state_bytes(
            result["params"]))
        print("CKPT_CHILD_JSON " + json.dumps({
            "losses": result["losses"], "saves": result["saves"]}),
            flush=True)
        return 0
    if role == "elastic":
        return _elastic_life(torch, ckpt_dir)
    if role == "four":
        return _four_card_life(torch, ckpt_dir)
    if role == "scale":
        return _scale_life(torch, ckpt_dir)
    if role == "collhang":
        return _coll_hang_life(torch, ckpt_dir)
    args = _ckpt_args(4, ckpt_dir, 0)
    _, _, state, next_batch, _ = llama_pretrain.build(args)
    torch.cuda.synchronize()
    ckpt, _, restore = llama_pretrain.open_checkpoint(args, state,
                                                      next_batch)
    check(restore is not None, f"child {role} restored nothing")
    crcs = state_crcs(torch, state)
    ckpt.close()
    print("CKPT_CHILD_JSON " + json.dumps({"restore": restore, "crc": crcs}),
          flush=True)
    return 0


def _elastic_life(torch, ckpt_dir):
    """The elastic leg's worker, in the agent's environment. First life
    (``DLROVER_TPU_RESTART_COUNT`` 0): trains steps 1-2 with a memory save
    after each, then steps 3-4 unsaved (the uninterrupted continuation of
    the staged state), prints the CRC32 of every leaf it staged and
    SIGKILLs itself. Second life: restores (it must find step 2 in shm), prints the
    restored leaves' CRC32, trains steps 3-4 with a memory save after each
    (each step timed once the save before it has staged), and exits 0. Each life prints its kernels' launch counts and the times
    the recovery is cut by."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    t_start = time.time()
    job = os.environ["DLROVER_TPU_JOB_NAME"]
    _reset_counts(attention, fce, [0])
    ctx = bootstrap.init()
    reports = []
    _record_reports(ctx.client, reports)
    args = _ckpt_args(4, ckpt_dir, 0)
    cfg, trainer, state, next_batch, _ = llama_pretrain.build(args)
    torch.cuda.synchronize()
    ckpt, start, restore = llama_pretrain.open_checkpoint(args, state,
                                                          next_batch)
    if os.environ["DLROVER_TPU_RESTART_COUNT"] == "0":
        check(restore is None, f"the first life restored {restore}")
        losses, saves = [], []
        for step in range(args.steps):
            state, loss, seconds = llama_pretrain.timed_step(
                trainer, state, next_batch())
            losses.append(loss)
            print(f"step {step + 1} loss {loss:.4f} ({seconds:.3f}s)",
                  flush=True)
            ctx.report_step(step + 1, force=True, digest=trainer.step_digest)
            if step < 2:  # steps 3-4 continue from step 2 unsaved
                blocking = ckpt.save(step + 1, state)
                saves.append({"step": step + 1, "blocking_s": blocking,
                              "mode": ckpt.last_stage_mode})
        ckpt.close()
        stages = {s["step"]: s for s in ckpt.stage_log}
        for save in saves:
            save["stage"] = stages.get(save["step"])
        _print_saves("elastic", saves, ckpt_state_bytes(
            llama.param_count(cfg)))
        step, crcs = segment_crcs(job)
        print("CKPT_CHILD_JSON " + json.dumps({
            "losses": losses, "staged_step": step, "crc": crcs,
            "modes": [s["mode"] for s in saves],
            "counts": _launch_counts(attention, fce), "start_t": t_start,
            "digests": [r["digest"] for r in reports],
            "kill_t": time.time()}), flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    t_restored = time.time()
    check(restore is not None, "the second life restored nothing")
    crcs = state_crcs(torch, state)
    crc_s = time.time() - t_restored
    losses, step_s, step_end_t = [], [], []
    for step in range(start, args.steps):
        # the step's wall and digest sample time the step, not the last
        # save's device-to-host copy (module docstring, phase 4c)
        ckpt.wait_staging()
        state, loss, seconds = llama_pretrain.timed_step(
            trainer, state, next_batch())
        step_end_t.append(time.time())
        losses.append(loss)
        step_s.append(seconds)
        print(f"step {step + 1} loss {loss:.4f} ({seconds:.3f}s)", flush=True)
        ckpt.save(step + 1, state)
        ctx.report_step(step + 1, force=True, digest=trainer.step_digest)
    ckpt.close()
    print("CKPT_CHILD_JSON " + json.dumps({
        "restore": restore, "crc": crcs, "losses": losses, "step_s": step_s,
        "counts": _launch_counts(attention, fce), "start_t": t_start,
        "restored_t": t_restored, "crc_s": crc_s,
        "digests": [r["digest"] for r in reports],
        "step_end_t": step_end_t}), flush=True)
    return 0


def _wait_persisted(saver, step):
    """Wait until the saver has logged a persist that copied ``step`` from
    every local process: it logs one once the persist has ended, its
    commit included. Each rank's save sends its own event, and a persist
    that ran before every rank had staged the step logs it without the
    step among the copied ones (``steps``)."""
    deadline = time.time() + CKPT_COMMIT_TIMEOUT_S
    while not any(step in e.get("steps", ())
                  for e in list(saver.persist_log)):
        check(time.time() < deadline, f"the saver did not persist step "
              f"{step} in {CKPT_COMMIT_TIMEOUT_S}s")
        time.sleep(0.5)


def phase_checkpoint(torch, attention, fce, chunked_calls, main_result):
    """Flash checkpoint at the main path's size (module docstring, 4c)."""
    from dlrover_tpu_torch.checkpoint.saver import (AsyncCheckpointSaver,
                                                    CheckpointPersister)
    from dlrover_tpu_torch.checkpoint.shm_handler import HEADER_SPACE
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.run import llama_pretrain

    t0 = time.perf_counter()
    n_params = llama.param_count(llama_pretrain.model_config("8b", 4))
    nbytes = ckpt_state_bytes(n_params)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    # this run's own segment and socket: another run on the machine has
    # another name
    job = f"chip_smoke_ckpt_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    host = None
    try:
        for cmd in (["df", "-B1", "/dev/shm"], ["df", "-B1", workdir]):
            out = subprocess.run(cmd, capture_output=True, text=True)
            print("  " + out.stdout.strip().replace("\n", "\n  "), flush=True)
        with open("/proc/meminfo") as f:
            print("  " + [l for l in f if l.startswith("MemAvailable")][0]
                  .strip(), flush=True)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pcie.link.gen.current,"
             "pcie.link.width.current", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print(f"  pcie link (gen, width) now: {out.stdout.strip()}",
              flush=True)
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=pcie.link.gen.max,"
             "pcie.link.width.max", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        gen, width, note = pcie_link(out.stdout.strip().splitlines()[0]
                                     if out.stdout.strip() else "")
        shm_free = check_space("/dev/shm", nbytes + HEADER_SPACE, "shm")
        disk_free = check_space(workdir, ckpt_disk_peak(nbytes), "disk")
        snap_ms = snapshot_bound_ms(nbytes)
        copy_s = nbytes / pcie_bytes_per_s(gen, width)
        print(f"  state {n_params} params, {nbytes} bytes; shm free "
              f"{shm_free}, disk free {disk_free} (peak need "
              f"{ckpt_disk_peak(nbytes)}); bounds: snapshot "
              f"{snap_ms:.2f} ms (2 x bytes / 3.35 TB/s), device-to-host "
              f"{copy_s:.4f} s (bytes / PCIe Gen{gen} x{width}, {note})",
              flush=True)

        # the save run (bare): a memory save after every step, step 4
        # persisted inline
        t_leg = time.perf_counter()
        d_save = os.path.join(workdir, "save")
        torch.cuda.empty_cache()
        _reset_counts(attention, fce, chunked_calls)
        with mock.patch.dict(os.environ, DLROVER_TPU_JOB_NAME=job):
            result = llama_pretrain.run(
                _ckpt_args(6, d_save, 4),
                log=lambda m: print(f"  [save run] {m}", flush=True))
        counts = _launch_counts(attention, fce)
        print(f"  [save run] kernel launches: {counts}; chunked CE calls "
              f"{chunked_calls[0]}", flush=True)
        for name in counts:
            check(counts[name] > 0,
                  f"kernel {name} never launched in the checkpointed run")
        check(chunked_calls[0] == 0, "the chunked CE ran in the save run")
        losses = result["losses"]
        check(len(losses) == 6 and all(math.isfinite(x) for x in losses),
              f"save run losses {losses}")
        _print_saves("save run", result["saves"], nbytes)
        modes = [s["mode"] for s in result["saves"]]
        check(modes == ["device_snapshot"] * 6,
              f"the save run staged as {modes}, not device_snapshot")
        paused = [s + v["blocking_s"] for s, v in
                  zip(result["step_s"], result["saves"])]
        tokens = result["tokens_per_step"]
        # steps 3-4 follow memory saves whose segment is registered, before
        # save 5 waits for step 4's persist
        print(f"  [save run] step_s {result['step_s']}; tokens/s with each "
              f"save's pause: steps 3-4 {tokens * 2 / sum(paused[2:4]):.1f}"
              f", steps 2-6 {tokens * 5 / sum(paused[1:]):.1f}; steps "
              f"alone: steps 3-4 {tokens * 2 / sum(result['step_s'][2:4]):.1f}"
              f", steps 2-6 {result['tokens_per_s']:.1f}; phase 4 "
              f"{main_result['tokens_per_s']:.1f}; max_memory_allocated "
              f"{result['max_memory_bytes']} bytes (phase 4 "
              f"{main_result['max_memory_bytes']})", flush=True)
        inline_s = (result["saves"][3]["stage"] or {}).get("persist_s")
        check(inline_s is not None, "save 4 was not persisted inline")
        save5_s = result["saves"][4]["blocking_s"]
        committed = CheckpointPersister(job, 0).committed_step(d_save)
        check(committed == 4, f"the save run committed step {committed}")

        # the pause without the snapshot: the whole device-to-host copy
        d_gather = os.path.join(workdir, "gather")
        torch.cuda.empty_cache()
        with mock.patch.dict(os.environ, DLROVER_TPU_JOB_NAME=job,
                             DLROVER_TPU_DEVICE_SNAPSHOT="0"):
            gather = llama_pretrain.run(_ckpt_args(2, d_gather, 0),
                                        log=lambda m: None)
        _print_saves("host gather", gather["saves"], nbytes)
        modes = [s["mode"] for s in gather["saves"]]
        check(modes == ["host_gather"] * 2,
              f"DLROVER_TPU_DEVICE_SNAPSHOT=0 staged as {modes}")
        shutil.rmtree(d_gather, ignore_errors=True)
        torch.cuda.empty_cache()

        # the segment lost: the save run's committed step 4 from disk
        unlink_segment(job)
        disk = _run_child("disk", d_save, job)
        restore = disk["restore"]
        print(f"  restore from disk: step {restore['step']}, tier "
              f"{restore['tier']}, {restore['seconds']:.3f}s for "
              f"{restore['bytes']} bytes (CRC-verified)", flush=True)
        check(restore["tier"] == "disk" and restore["step"] == 4,
              f"the disk child restored {restore}, not step 4 from disk")
        compare_crcs(manifest_crcs(d_save, 4), disk["crc"], "disk restore")
        print(f"  every leaf's CRC32 equal to its manifest's "
              f"({len(disk['crc'])} leaves)", flush=True)
        shutil.rmtree(d_save, ignore_errors=True)
        print(f"  bare legs: {time.perf_counter() - t_leg:.1f}s", flush=True)

        # under the agent's saver: step 2 persisted through its event queue
        t_leg = time.perf_counter()
        d_agent = os.path.join(workdir, "agent")
        host = AsyncCheckpointSaver(job_name=job, node_id=0)
        host.start()
        agent = _run_child("agent", d_agent, job)
        _wait_persisted(host, 2)
        pause2, wait3, copy_s, fanout_s = check_agent_persist(
            agent["saves"], list(host.persist_log),
            host.persister.committed_step(d_agent))
        print(f"  [agent] step 2 persisted through the saver: pause "
              f"{pause2 * 1e3:.2f} ms; step 3's stage waited {wait3:.3f}s "
              f"for the saver's copy; the saver's copy to the local tier "
              f"{copy_s:.3f}s ({nbytes / copy_s / 1e9:.2f} GB/s), fanout to "
              f"the object tier and commit {fanout_s:.3f}s; committed step "
              f"2. The bare run: inline persist of step 4 {inline_s:.3f}s, "
              f"save 5's pause {save5_s:.3f}s", flush=True)
        host.stop()
        host = None
        shutil.rmtree(d_agent, ignore_errors=True)
        # the elastic leg stages under its own job's name: free this
        # segment's host memory first
        unlink_segment(job)
        print(f"  agent leg: {time.perf_counter() - t_leg:.1f}s", flush=True)

        # the elastic restart: a worker killed under the real CLI, its
        # agent and master
        phase_elastic(workdir, nbytes)
    finally:
        if host is not None:
            host.stop()
        unlink_segment(job)
        shutil.rmtree(workdir, ignore_errors=True)
        # the savers' socket directory, /tmp/dlrover_tpu/<job>
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    print(f"  flash checkpoint phase: {time.perf_counter() - t0:.1f}s",
          flush=True)


def _agent_stamp(lines, marker, pattern):
    """The number the agent logged on the first line holding ``marker``,
    read by ``pattern`` (a regex with one group)."""
    for line in lines:
        if marker in line:
            m = re.search(pattern, line)
            if m:
                return float(m.group(1))
    raise SmokeFailure(f"the CLI logged no {marker!r} line")


def _life_result(job, restart, rank=0):
    """The JSON result of worker ``rank``'s life ``restart`` (the elastic
    leg's or the four-card leg's), from its log under the agent's log
    directory, and the log's other lines."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir

    path = os.path.join(agent_log_dir(job, 0),
                        f"worker-{rank}-restart{restart}.log")
    check(os.path.exists(path), f"no log of life {restart}: {path}")
    result, lines = None, []
    with open(path, errors="replace") as f:
        for line in f:
            if line.startswith("CKPT_CHILD_JSON "):
                result = json.loads(line.split(" ", 1)[1])
            else:
                lines.append(line.rstrip())
    check(result is not None, f"life {restart} printed no result")
    return result, lines


def phase_elastic(workdir, nbytes):
    """Phase 4c's elastic leg (module docstring): the CLI, a master and an
    agent of the port, a worker SIGKILLed with step 2 in shm, persisted at
    the breakpoint and restarted from shm; then the breakpoint step from
    disk."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.checkpoint.saver import CheckpointPersister
    from dlrover_tpu_torch.common.ipc import default_socket_path

    t_leg = time.perf_counter()
    job = f"chip_smoke_elastic_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    d_el = os.path.join(workdir, "elastic")
    repo = os.path.dirname(os.path.abspath(__file__))
    env, metrics_port = metrics_env(dict(
        os.environ, PYTHONPATH=repo + os.pathsep
        + os.environ.get("PYTHONPATH", "")))
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
           "--standalone", "--nnodes=1", "--nproc_per_node=1",
           "--max_restarts=1", f"--job_name={job}",
           os.path.abspath(__file__), "--", "--ckpt-child", "elastic", d_el]
    print(f"  [elastic] {' '.join(cmd[1:])} (master /metrics on port "
          f"{metrics_port})", flush=True)
    try:
        poller = MetricsPoller(metrics_port)
        proc, lines = _run_cli(cmd, env, "elastic", ELASTIC_TIMEOUT_S,
                               poller)
        killed, killed_log = _life_result(job, 0)
        resumed, resumed_log = _life_result(job, 1)
        for life, log in (("first", killed_log), ("second", resumed_log)):
            for line in log:
                print(f"  [elastic {life} life] {line}", flush=True)
        check(proc.returncode == 0,
              f"the elastic CLI exited {proc.returncode}, not 0")
        check_no_actions(lines, "elastic leg")
        check(any("checkpoint saver started" in x for x in lines),
              "the agent's checkpoint saver did not start")

        # the first life: step 2 staged, then killed; the agent saw it,
        # classified it, persisted step 2 and restarted the worker
        check(killed["staged_step"] == 2 and killed["modes"] == [
            "device_snapshot"] * 2, f"the first life staged {killed}")
        seen_t = _agent_stamp(lines, "node 0: worker failed (exit -9)",
                              r"seen at ([0-9.]+)")
        classified = [x for x in lines if " classified " in x]
        check(classified and classified[0].rstrip().endswith(
            "(restarts 0/1)") and "-> restart" in classified[0],
            f"the agent's diagnosis: {classified}")
        persist_s = _agent_stamp(lines, "node 0: breakpoint persist True",
                                 r"in ([0-9.]+)s")
        rdzv_s = _agent_stamp(lines, "node 0: rendezvous round 2 in",
                              r"in ([0-9.]+)s")
        start_t = _agent_stamp(lines, "worker-0-restart1.log",
                               r" at ([0-9.]+) log=")
        committed = CheckpointPersister(job, 0).committed_step(d_el)
        check(committed == 2, f"the breakpoint persist committed {committed}")
        compare_crcs(killed["crc"], manifest_crcs(d_el, 2),
                     "breakpoint manifest against the killed worker's "
                     "segment")
        print(f"  every leaf's CRC32 in the breakpoint manifest equal to "
              f"what the killed worker staged ({len(killed['crc'])} leaves)",
              flush=True)

        # the second life: step 2 from shm, steps 3-4 within the resume
        # tolerance
        restore = resumed["restore"]
        check(restore["tier"] == "shm" and restore["step"] == 2,
              f"the second life restored {restore}, not step 2 from shm")
        compare_crcs(killed["crc"], resumed["crc"], "shm restore")
        print(f"  the second life restored step 2 from shm, every leaf's "
              f"CRC32 equal ({len(resumed['crc'])} leaves)", flush=True)
        for life, res in (("first", killed), ("second", resumed)):
            print(f"  [elastic] {life} life's kernel launches: "
                  f"{res['counts']}", flush=True)
            for name, n in res["counts"].items():
                check(n > 0, f"kernel {name} never launched in the {life} "
                      "life")
        continued = killed["losses"][2:4]
        diff = max(abs(a - b) for a, b in zip(resumed["losses"], continued))
        print(f"  resumed steps 3-4 (step_s {resumed['step_s']}) losses "
              f"{resumed['losses']} vs the first life's own steps 3-4 from "
              f"the state it staged {continued}: bitwise "
              f"{resumed['losses'] == continued} (diff {diff:.3e})",
              flush=True)
        check(resumed["losses"] == continued,
              f"resumed steps 3-4 {resumed['losses']} are not bitwise the "
              f"first life's {continued} (diff {diff})")
        sample, wall = check_digest_against_wall(resumed["digests"],
                                                 resumed["step_s"])
        print(f"  the second life's step-time digest: median sample "
              f"{sample:.4f} s against the median step wall {wall:.4f} s "
              f"(within {DIGEST_WALL_TOL:.0%}); the windows its reports "
              f"carried {resumed['digests']}, the first life's "
              f"{killed['digests']}", flush=True)
        exit_line = [x for x in lines if "local master exiting:" in x]
        check(exit_line and exit_line[-1].endswith(
            "succeeded; checkpoint steps by node {0: 4}"),
            f"the master's exit: {exit_line}")

        # the time to recover, by phase
        restored_t = resumed["restored_t"]
        step3_t = resumed["step_end_t"][0] - resumed["crc_s"]
        phases = {
            "kill_to_detection_s": seen_t - killed["kill_t"],
            "breakpoint_persist_s": persist_s,
            "rendezvous_s": rdzv_s,
            "worker_start_to_restore_s": restored_t - start_t,
            "restore_to_step3_end_s": step3_t - restored_t,
        }
        print(f"  time to recover: {step3_t - killed['kill_t']:.3f}s from "
              f"the kill to the end of step 3; by phase {json.dumps(phases)}"
              f"; the restore {restore['seconds']:.3f}s by tier "
              f"{restore['tier']} (registering the segment "
              f"{restore['register_s']:.3f}s of it, {restore['bytes']} "
              f"bytes); the second life's start {start_t - seen_t:.3f}s "
              f"after the detection (the persist, the failure report, the "
              f"diagnosis and the rendezvous); its CRC32s "
              f"{resumed['crc_s']:.3f}s (left out of the last phase)",
              flush=True)

        # the master's goodput ledger: its bracket for the kill against
        # this script's own clock, and no straggler
        reading = master_reading(lines)
        bracket_s = check_master_downtime(
            reading["brackets"], seen_t, resumed["step_end_t"][0],
            report_interval())
        check_master_gauges(poller.last, reading)
        print_master("elastic", poller.last, reading, bracket_s)

        # the segment gone (the agent unlinked it at the job's end): step
        # 2 from the breakpoint persist on disk
        unlink_segment(job)
        disk = _run_child("disk", d_el, job)
        restore = disk["restore"]
        print(f"  restore of the breakpoint step from disk: step "
              f"{restore['step']}, tier {restore['tier']}, "
              f"{restore['seconds']:.3f}s for {restore['bytes']} bytes "
              f"(CRC-verified)", flush=True)
        check(restore["tier"] == "disk" and restore["step"] == 2,
              f"the disk child restored {restore}, not step 2 from disk")
        check_breakpoint_step(killed["crc"], manifest_crcs(d_el, 2),
                              disk["crc"])
        print(f"  every leaf's CRC32, in the breakpoint manifest and "
              f"restored from disk, equal to what the killed worker staged "
              f"({len(disk['crc'])} leaves)", flush=True)
    finally:
        unlink_segment(job)
        shutil.rmtree(d_el, ignore_errors=True)
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    print(f"  elastic leg: {time.perf_counter() - t_leg:.1f}s", flush=True)


def write_corpus(path, seed=DATA_SEED, records=DATA_RECORDS, seq=DATA_SEQ,
                 vocab=DATA_VOCAB):
    """Phase 4d's corpus: ``records`` sequences of ``seq`` random token ids
    in [0, vocab) from ``seed``, as uint32 through the port's
    ``pack_tokens``. Returns the tokens, shaped (records, seq)."""
    import numpy as np

    from dlrover_tpu_torch.train.datasets import pack_tokens

    tokens = np.random.RandomState(seed).randint(
        0, vocab, (records, seq)).astype(np.uint32)
    if os.path.exists(path):
        os.remove(path)  # pack_tokens appends
    n = pack_tokens(path, tokens.reshape(-1).tolist(), dtype="uint32")
    check(n == records * seq, f"packed {n} tokens, not {records * seq}")
    return tokens


def sampler_order(n, seed, epoch):
    """The sampler's global order, computed here on its own: numpy's
    ``RandomState(seed + epoch)`` permutation of ``range(n)``
    (``ElasticDistributedSampler._global_order`` with shuffle)."""
    import numpy as np

    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def loader_rows(tokens, steps, global_batch, seed=DATA_SAMPLER_SEED):
    """Each step's rows of the file, (global_batch, seq), as the loader
    must give them from the epoch's start: the sampler's order over the
    file's sequences, ``global_batch`` a step, epochs in turn."""
    import numpy as np

    n = len(tokens)
    per_epoch = n // global_batch
    out = []
    for step in range(steps):
        epoch, k = divmod(step, per_epoch)
        idx = sampler_order(n, seed, epoch)[k * global_batch:
                                            (k + 1) * global_batch]
        out.append(np.asarray(tokens[idx]))
    return out


def check_shard_accounting(first, second, ranges, file_crc):
    """Phase 4d's shard accounting over the two lives of the shard leg's
    worker. ``first`` and ``second``: each life's ``shards`` (the
    ``[task_id, start, end, crc]`` it trained, in order) and ``leases``
    (each lease call's ``granted`` ``[task_id, start, end]`` and
    ``acked`` task ids). ``ranges``: every ``(start, end)`` of the
    dataset; ``file_crc``: each range's CRC32 of the file's rows. Fails
    on a range no life trained, a range one life trained twice, a range
    the master acked in the first life that reaches the second, a range
    trained in both lives that the first did not hold un-acked when it
    died, or a step's CRC32 unlike the file's. Returns the ranges trained
    in both lives."""
    def spans(life):
        return [(start, end) for _, start, end, _ in life["shards"]]

    for label, life in (("first", first), ("second", second)):
        trained = spans(life)
        twice = sorted({r for r in trained if trained.count(r) > 1})
        check(not twice, f"the {label} life trained {twice} twice")
        for task_id, start, end, crc in life["shards"]:
            check(crc == file_crc[(start, end)],
                  f"the {label} life's step on range {start}:{end} (task "
                  f"{task_id}) has CRC32 {crc}, the file's rows "
                  f"{file_crc[(start, end)]}")
    granted = {tid: (start, end) for lease in first["leases"]
               for tid, start, end in lease["granted"]}
    acked = {granted[tid] for lease in first["leases"]
             for tid in lease["acked"]}
    held = set(granted.values()) - acked
    done = set(spans(first)) | set(spans(second))
    missing = sorted(set(ranges) - done)
    check(not missing, f"no life trained {missing}")
    leaked = sorted(acked & set(spans(second)))
    check(not leaked, f"ranges {leaked} were acked in the first life and "
          "delivered to the second")
    again = set(spans(first)) & set(spans(second))
    stray = sorted(again - held)
    check(not stray, f"ranges {stray} were trained in both lives but not "
          "held un-acked by the first when it died")
    return sorted(again)


def _data_args(steps, extra=()):
    from dlrover_tpu_torch.run import llama_pretrain

    return llama_pretrain.parse_args([
        "--model", "8b", "--layers", "4", "--seq", str(DATA_SEQ),
        "--micro-batch", "1", "--global-batch", "2", "--steps", str(steps),
        "--device", "cuda", "--seed", "0", *extra,
    ])


def _data_emit(kind, **fields):
    print("DATA_CHILD_JSON " + json.dumps({"kind": kind, **fields}),
          flush=True)


def _record_reports(client, sink=None, emit=False):
    """Wrap ``client``'s step report: each call's step, stamp (``ts``,
    the stamp the master's ledger reads), digest window, whether it
    reached a master (``ok``) and when it returned (``done_t``), appended
    to ``sink`` and, with ``emit``, printed as a ``report`` record."""
    real = client.report_global_step

    def report(step, digest=None, timestamp=0.0):
        ts = timestamp or time.time()
        ok = False
        try:
            resp = real(step, digest=digest, timestamp=ts)
            ok = True
            return resp
        finally:
            rec = {"step": step, "ts": ts, "digest": digest, "ok": ok,
                   "done_t": time.time()}
            if sink is not None:
                sink.append(rec)
            if emit:
                _data_emit("report", **rec)

    client.report_global_step = report


def data_child(role, path):
    """Phase 4d's shard-leg worker (``shards``) and phase 4e's workers
    (``relaunch``, ``hang``), started by the agent (module docstring).
    ``shards`` and ``relaunch`` register the dataset, train one step a
    shard on the shard's rows of the file through ``ShardingClient`` and
    print a JSON line for each lease call, each step report and each
    shard; the ``shards`` worker's first life SIGKILLs itself after its
    ``DATA_KILL_AFTER``-th shard's step, its second takes shards until the
    master says exhausted; the ``relaunch`` worker is never killed and
    holds before its first and its last step for the script's
    ``RELAUNCH_GO`` files beside ``path``.
    ``hang``: ``_hang_child``; ``diag``: ``_diag_child``."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    check(role in ("shards", "relaunch", "hang", "diag"),
          f"unknown data child {role!r}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if role == "hang":
        return _hang_child(path)
    if role == "diag":
        return _diag_child(path)
    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap
    from dlrover_tpu_torch.train.data import ShardingClient
    from dlrover_tpu_torch.train.datasets import TokenFileDataset

    first = os.environ["DLROVER_TPU_RESTART_COUNT"] == "0"
    ctx = bootstrap.init()
    device = torch.device("cuda", ctx.local_rank)
    # the trainer polls the runtime config and the planner's hint at its
    # default cadence (its first step)
    _, trainer, state, _, _ = llama_pretrain.build(_data_args(1), device,
                                                   ctx)
    a, b = trainer.step_batch_shape
    dataset = TokenFileDataset(path, DATA_SEQ, dtype="uint32")
    client = ctx.client
    fallback = {"get_task": 0, "report_task_result": 0}
    real_lease = client.lease_shards

    def lease(*args, **kwargs):
        t0 = time.perf_counter()
        resp = real_lease(*args, **kwargs)
        seconds = time.perf_counter() - t0
        _data_emit("lease", seconds=seconds, granted=[
            [t.task_id, t.shard_start, t.shard_end]
            for t in getattr(resp, "tasks", [])],
            acked=list(getattr(resp, "acked", [])),
            idle=getattr(resp, "idle", None),
            exhausted=getattr(resp, "exhausted", None))
        return resp

    def counted(name):
        real = getattr(client, name)

        def call(*args, **kwargs):
            fallback[name] += 1
            return real(*args, **kwargs)
        return call

    client.lease_shards = lease
    for name in fallback:
        setattr(client, name, counted(name))
    _record_reports(client, emit=True)
    _reset_counts(attention, fce, [0])
    sharding = ShardingClient(DATA_DATASET, client,
                              lease_count=DATA_LEASE_COUNT)
    sharding.register_dataset(DATA_RECORDS, DATA_SHARD_SIZE, num_epochs=1,
                              shuffle=False)
    n = 0
    shards = DATA_RECORDS // DATA_SHARD_SIZE
    for task in sharding.iter_tasks():
        if role == "relaunch" and n in (0, shards - 1):
            go = os.path.join(os.path.dirname(path),
                              RELAUNCH_GO[0 if n == 0 else 1])
            deadline = time.time() + CONTROL_TIMEOUT_S
            while not os.path.exists(go):
                check(time.time() < deadline, f"no {go} in time")
                time.sleep(0.05)
            _data_emit("go", file=os.path.basename(go), t=time.time())
        rows = np.stack([dataset[i] for i in
                         range(task.shard_start, task.shard_end)])
        batch = torch.from_numpy(rows.reshape(a, b, DATA_SEQ)).to(device)
        state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                         batch)
        end_t = time.time()
        crc = zlib.crc32(batch.cpu().numpy().tobytes())
        n += 1
        ctx.report_step(n, force=True, digest=trainer.step_digest)
        _data_emit("shard", task_id=task.task_id, start=task.shard_start,
                   end=task.shard_end, crc=crc, loss=loss, seconds=seconds,
                   end_t=end_t)
        if role == "shards" and first and n == DATA_KILL_AFTER:
            _data_emit("end", counts=_launch_counts(attention, fce),
                       fallback=fallback, kill_t=time.time())
            os.kill(os.getpid(), signal.SIGKILL)
    _data_emit("end", counts=_launch_counts(attention, fce),
               fallback=fallback,
               shard_ckpt=json.loads(sharding.checkpoint_shards()))
    return 0


def _hang_child(path):
    """Phase 4e's hang-leg worker: ``run/llama_pretrain.py``'s loader flow
    on the token file (``--data``, no checkpoint), every step reported
    (the context's step-report interval lowered to
    ``HANG_REPORT_INTERVAL_S``). Its first life (no marker file beside the
    corpus yet) SIGSTOPs itself after its first step report at least
    ``HANG_STOP_AFTER_S`` into the life: alive, never stepping again, its
    agent still heartbeating. The second life trains every step. Prints a ``life`` record, each step (its loss
    at full precision), each step report, a ``stop`` record before the
    stop and an ``end`` record, each life's kernel launches included."""
    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    marker = os.path.join(os.path.dirname(path), "hang-stopped")
    first = not os.path.exists(marker)
    start_t = time.time()
    _data_emit("life", first=first, pid=os.getpid(), start_t=start_t)
    ctx = bootstrap.init()
    ctx.step_report_interval = HANG_REPORT_INTERVAL_S
    _record_reports(ctx.client, emit=True)
    _reset_counts(attention, fce, [0])
    real_report = ctx.report_step

    def report_step(step, force=False, digest=None):
        real_report(step, force=force, digest=digest)
        if first and time.time() >= start_t + HANG_STOP_AFTER_S:
            _data_emit("stop", step=step, counts=_launch_counts(
                attention, fce), stop_t=time.time())
            open(marker, "w").close()
            os.kill(os.getpid(), signal.SIGSTOP)

    ctx.report_step = report_step
    real_step = llama_pretrain.timed_step

    def timed(trainer, state, batch):
        state, loss, seconds = real_step(trainer, state, batch)
        _data_emit("step", loss=loss, seconds=seconds, end_t=time.time())
        return state, loss, seconds

    with mock.patch.object(llama_pretrain, "timed_step", timed):
        result = llama_pretrain.run(
            _data_args(HANG_STEPS, ["--data", path, "--data-dtype",
                                    "uint32"]),
            log=lambda m: print(m, flush=True))
    _data_emit("end", counts=_launch_counts(attention, fce),
               losses=result["losses"])
    return 0


def max_sm_clock_hz():
    """The card's highest SM clock, from nvidia-smi: a spin of ``c``
    cycles lasts at least ``c`` over it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi: {out.stderr}")
    return max(float(x) for x in out.stdout.split()) * 1e6


def _diag_child(path):
    """Phase 4e's diagnosis-leg worker, under the device timer:
    ``run/llama_pretrain.py``'s loader and checkpoint flow on the token
    file (a memory save every step, the one before the spin's step a
    storage save, with the loader's sidecar; every step reported). Its first life (no marker beside the corpus yet) reads its
    own timer's ``/metrics`` after each step of DIAG_SCRAPE_AFTER (with
    the digest's samples so far) and, in step DIAG_SPIN_STEP, enqueues a
    spin of DIAG_SPIN_S on the step's stream before the optimizer: the
    step's loss and end event wait behind it, the process stays alive and
    its host waits for the step in ``timed_step``. The second life
    restores the last staged step and trains to DIAG_STEPS. Prints a
    ``life`` record, each step, each report, the scrapes, a ``spin``
    record (with the first life's kernel launches) and the second life's
    ``end`` record (its restore and launches)."""
    import torch

    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.profiler import tpu_timer
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    workdir = os.path.dirname(path)
    marker = os.path.join(workdir, "diag-spun")
    first = not os.path.exists(marker)
    _data_emit("life", first=first, pid=os.getpid(), start_t=time.time())
    ctx = bootstrap.init()
    ctx.step_report_interval = HANG_REPORT_INTERVAL_S
    _record_reports(ctx.client, emit=True)
    _reset_counts(attention, fce, [0])
    port = int(os.environ["DLROVER_TPU_TIMER_PORT"])
    seen = {"trainer": None, "samples": [], "n": 0}
    real_step = llama_pretrain.timed_step

    class SpinFirst:
        """The trainer's optimizer, whose next step first enqueues the
        spin (the optimizer is a frozen dataclass)."""

        def __init__(self, trainer, spin):
            self._trainer, self._real, self._spin = (
                trainer, trainer.optimizer, spin)

        def __getattr__(self, name):
            return getattr(self._real, name)

        def step(self, *args, **kwargs):
            self._trainer.optimizer = self._real
            self._spin()
            return self._real.step(*args, **kwargs)

    def spin_before_optimizer(trainer):
        hz = max_sm_clock_hz()
        cycles = int(DIAG_SPIN_S * hz)

        def spin():
            open(marker, "w").close()
            _data_emit("spin", n=seen["n"], cycles=cycles, clock_hz=hz,
                       t=time.time(), counts=_launch_counts(attention, fce))
            torch.cuda._sleep(cycles)

        trainer.optimizer = SpinFirst(trainer, spin)

    def timed(trainer, state, batch):
        if seen["trainer"] is None:
            seen["trainer"] = trainer
            add = trainer._digest.add

            def sample(seconds):
                seen["samples"].append(seconds)
                add(seconds)

            trainer._digest.add = sample
        seen["n"] += 1
        if first and seen["n"] == DIAG_SPIN_STEP:
            spin_before_optimizer(trainer)
        state, loss, seconds = real_step(trainer, state, batch)
        _data_emit("step", n=seen["n"], loss=loss, seconds=seconds,
                   end_t=time.time())
        if first and seen["n"] in DIAG_SCRAPE_AFTER:
            torch.cuda.synchronize()
            trainer.step_digest  # folds the step just ended
            time.sleep(0.05)  # the timer's poller ends it within 1 ms
            _data_emit("scrape", n=seen["n"],
                       metrics=tpu_timer.scrape_metrics(port),
                       samples=list(seen["samples"]))
        return state, loss, seconds

    ck = os.path.join(workdir, "diag_ck")
    with mock.patch.object(llama_pretrain, "timed_step", timed):
        result = llama_pretrain.run(
            _data_args(DIAG_STEPS, ["--data", path, "--data-dtype",
                                    "uint32", "--ckpt-dir", ck,
                                    "--save-every", str(DIAG_SPIN_STEP - 1)]),
            log=lambda m: print(m, flush=True))
    _data_emit("end", counts=_launch_counts(attention, fce),
               losses=result["losses"], start_step=result["start_step"],
               restore=result["restore"],
               tokens_per_step=result["tokens_per_step"],
               params=result["params"])
    return 0


def _data_life(job, restart):
    """The lines the shard leg's worker printed in life ``restart``: its
    ``shards``, ``leases`` and ``end`` record, read from its log under the
    agent's log directory."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir

    path = os.path.join(agent_log_dir(job, 0),
                        f"worker-0-restart{restart}.log")
    check(os.path.exists(path), f"no log of life {restart}: {path}")
    life = {"shards": [], "leases": [], "reports": [], "end": None,
            "records": []}
    with open(path, errors="replace") as f:
        for line in f:
            if not line.startswith("DATA_CHILD_JSON "):
                continue
            rec = json.loads(line.split(" ", 1)[1])
            life["records"].append(rec)
            if rec["kind"] == "shard":
                life["shards"].append([rec["task_id"], rec["start"],
                                       rec["end"], rec["crc"]])
            elif rec["kind"] == "lease":
                life["leases"].append(rec)
            elif rec["kind"] == "report":
                life["reports"].append(rec)
            elif rec["kind"] == "end":
                life["end"] = rec
    check(life["end"] is not None, f"life {restart} printed no end record")
    return life


def phase_data(torch, attention, fce, chunked_calls, main_result):
    """Phase 4d, the data plane (module docstring)."""
    import numpy as np

    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.run import llama_pretrain

    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_data_")
    job = f"chip_smoke_data_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    try:
        path = os.path.join(workdir, "corpus.bin")
        tokens = write_corpus(path)
        print(f"  corpus: {DATA_RECORDS} sequences of {DATA_SEQ} uint32 "
              f"token ids in [0, {DATA_VOCAB}) from seed {DATA_SEED}, "
              f"{os.path.getsize(path)} bytes", flush=True)

        # the loader leg: the token file through the sampler, the loader
        # and prefetch, in this process
        recorded = []
        real_step = llama_pretrain.timed_step

        def recording_step(trainer, state, batch):
            recorded.append(batch.clone())
            return real_step(trainer, state, batch)

        torch.cuda.empty_cache()
        _reset_counts(attention, fce, chunked_calls)
        with mock.patch.object(llama_pretrain, "timed_step", recording_step):
            result = llama_pretrain.run(
                _data_args(DATA_LOADER_STEPS, ["--data", path,
                                               "--data-dtype", "uint32"]),
                log=lambda m: print(f"  [loader] {m}", flush=True))
        counts = _launch_counts(attention, fce)
        print(f"  [loader] kernel launches: {counts}; chunked CE calls "
              f"{chunked_calls[0]}", flush=True)
        for name in counts:
            check(counts[name] > 0,
                  f"kernel {name} never launched in the loader leg")
        check(all(b.is_cuda for b in recorded),
              "a loader batch reached the step on the host")
        want = loader_rows(tokens, DATA_LOADER_STEPS, 2)
        check(len(recorded) == DATA_LOADER_STEPS,
              f"the loader leg trained {len(recorded)} steps")
        for step, (got, rows) in enumerate(zip(recorded, want)):
            got = got.cpu().numpy().reshape(-1, DATA_SEQ)
            check(got.dtype == np.int32 and np.array_equal(
                got, rows.astype(np.int32)),
                f"step {step + 1}'s batch differs from the file's rows "
                f"{sampler_order(DATA_RECORDS, DATA_SAMPLER_SEED, 0)[2 * step:2 * step + 2]}")
        losses = result["losses"]
        check(all(math.isfinite(x) for x in losses),
              f"non-finite loss {losses}")
        print(f"  [loader] every step's batch, read back from the card, "
              f"bitwise equal to the file's rows in the sampler's order "
              f"(RandomState({DATA_SAMPLER_SEED}) over "
              f"{DATA_RECORDS} sequences); losses {losses}; step_s "
              f"{result['step_s']}; tokens/s (steps 2-{DATA_LOADER_STEPS}) "
              f"{result['tokens_per_s']:.1f} vs phase 4's synthetic "
              f"{main_result['tokens_per_s']:.1f}; each step's wait on the "
              f"prefetch {result['data_wait_s']} s", flush=True)
        del recorded
        torch.cuda.empty_cache()

        # the shard leg: the port's CLI, master and agent; a worker taking
        # shard ranges through ShardingClient, killed once and restarted
        t_leg = time.perf_counter()
        repo = os.path.dirname(os.path.abspath(__file__))
        env, metrics_port = metrics_env(dict(
            os.environ, PYTHONPATH=repo + os.pathsep
            + os.environ.get("PYTHONPATH", "")))
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
               "--standalone", "--nnodes=1", "--nproc_per_node=1",
               "--max_restarts=1", f"--job_name={job}",
               os.path.abspath(__file__), "--", "--data-child", "shards",
               path]
        print(f"  [shards] {' '.join(cmd[1:])} (master /metrics on port "
              f"{metrics_port})", flush=True)
        poller = MetricsPoller(metrics_port)
        proc, lines = _run_cli(cmd, env, "shards", DATA_TIMEOUT_S, poller)
        first, second = _data_life(job, 0), _data_life(job, 1)
        for label, life in (("first", first), ("second", second)):
            for rec in life["records"]:
                print(f"  [shards {label} life] {json.dumps(rec)}",
                      flush=True)
        check(proc.returncode == 0,
              f"the shard leg's CLI exited {proc.returncode}, not 0")
        check_no_actions(lines, "shard leg")
        exit_line = [x for x in lines if "local master exiting:" in x]
        check(exit_line and "local master exiting: succeeded" in
              exit_line[-1], f"the master's exit: {exit_line}")
        check(len(first["shards"]) == DATA_KILL_AFTER,
              f"the first life trained {len(first['shards'])} shards")
        ranges = [(s, min(s + DATA_SHARD_SIZE, DATA_RECORDS))
                  for s in range(0, DATA_RECORDS, DATA_SHARD_SIZE)]
        file_crc = {(s, e): zlib.crc32(tokens[s:e].astype(np.int32)
                                       .tobytes()) for s, e in ranges}
        again = check_shard_accounting(first, second, ranges, file_crc)
        for label, life in (("first", first), ("second", second)):
            end = life["end"]
            print(f"  [shards] {label} life's kernel launches: "
                  f"{end['counts']}; per-task calls {end['fallback']}",
                  flush=True)
            for name, n in end["counts"].items():
                check(n > 0, f"kernel {name} never launched in the {label} "
                      "life of the shard leg")
            check(not any(end["fallback"].values()),
                  f"the per-task fallback fired in the {label} life: "
                  f"{end['fallback']}")
        ckpt = second["end"]["shard_ckpt"]
        check(ckpt["completed_records"] == DATA_RECORDS and not ckpt["todo"]
              and not ckpt["doing"] and ckpt["epoch"] == 1,
              f"the master's dataset at the end: {ckpt}")
        lease_s = sorted(x["seconds"] for life in (first, second)
                         for x in life["leases"])
        seen_t = _agent_stamp(lines, "node 0: worker failed (exit -9)",
                              r"seen at ([0-9.]+)")
        kill_t = first["end"]["kill_t"]
        redelivered_t = next(
            rec["end_t"] for rec in second["records"]
            if rec["kind"] == "shard" and [rec["start"], rec["end"]]
            in [list(r) for r in again]) if again else None
        first_step_t = next(rec["end_t"] for rec in second["records"]
                            if rec["kind"] == "shard")
        start_t = _agent_stamp(lines, "worker-0-restart1.log",
                               r" at ([0-9.]+) log=")
        print(f"  [shards] all {len(ranges)} ranges trained, "
              f"{len(first['shards'])} in the first life and "
              f"{len(second['shards'])} in the second; re-delivered "
              f"{again} (held un-acked by the first life when it died); "
              f"every step's CRC32 equal to the file's rows; the dataset "
              f"complete with {ckpt['completed_records']} records",
              flush=True)
        print(f"  [shards] lease RPCs: {len(lease_s)}, median "
              f"{lease_s[len(lease_s) // 2] * 1e3:.3f} ms, largest "
              f"{lease_s[-1] * 1e3:.3f} ms; the kill to the agent's "
              f"detection {seen_t - kill_t:.3f} s; the kill to the end of "
              f"the first re-delivered shard's step "
              f"{'n/a' if redelivered_t is None else f'{redelivered_t - kill_t:.3f} s'}"
              f"; the second life's start (the agent's) to the end of its "
              f"first step {first_step_t - start_t:.3f} s", flush=True)
        reading = master_reading(lines)
        bracket_s = check_master_downtime(reading["brackets"], seen_t,
                                          first_step_t, report_interval())
        check_master_gauges(poller.last, reading)
        print_master("shards", poller.last, reading, bracket_s)
        print(f"  shard leg: {time.perf_counter() - t_leg:.1f}s", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  data plane phase: {seconds:.1f}s (limit {DATA_PHASE_LIMIT_S}s)",
          flush=True)
    check(seconds < DATA_PHASE_LIMIT_S,
          f"phase 4d took {seconds:.1f}s, over {DATA_PHASE_LIMIT_S}s")


def check_digest_against_wall(windows, step_s):
    """A life's step-time digest against the step walls this script times
    (``llama_pretrain.timed_step``: a device sync, the step, the loss on the
    host). ``windows``: the digest windows the life's step reports carried
    (None where a report carried none); ``step_s``: the life's step walls,
    its first (which the digest leaves out) included. Fails when no sample
    arrived or the median sample is more than ``DIGEST_WALL_TOL`` off the
    median wall
    of the steps after the first. Returns the two medians."""
    samples = [w["p50_s"] for w in windows if w and w.get("count")]
    walls = list(step_s[1:])
    check(samples, f"no step report carried a digest sample: {windows}")
    check(walls, f"no step after the first to hold the digest to: {step_s}")
    sample, wall = statistics.median(samples), statistics.median(walls)
    tol = DIGEST_WALL_TOL
    check(abs(sample - wall) <= tol * wall,
          f"the digest's median sample {sample:.4f} s is not within "
          f"{tol:.0%} of the median step wall {wall:.4f} s (samples "
          f"{samples}, walls {walls})")
    return sample, wall


RESUMED = re.compile(r"resumed state: (\d+) datasets, global_step=(\d+)")


def check_relaunch(life, ranges, file_crc, kill_t, reading, resumed):
    """Phase 4e's master-relaunch leg. ``life``: the worker's one life
    (it survives the master): its ``shards`` (``[task_id, start, end,
    crc]``) and step ``reports`` (``step``, ``ts``, ``ok``, ``done_t``).
    ``reading``: the relaunched master's exit summary (``master_reading``);
    ``resumed``: the ``(datasets, global step)`` it restored. Fails on a
    range not trained or trained twice, a step's CRC32 unlike the file's
    rows, a restore other than one dataset and a global step in (0, the
    last step reported before the kill], a final global step other than
    the steps trained, goodput outside (0, 1], or downtime other than one
    bracket from no later than the kill to the stamp of the first step
    report the relaunched master took. Returns the bracket's seconds."""
    trained = [(start, end) for _, start, end, _ in life["shards"]]
    twice = sorted({r for r in trained if trained.count(r) > 1})
    check(not twice, f"ranges {twice} trained twice across the relaunch")
    missing = sorted(set(ranges) - set(trained))
    check(not missing, f"ranges {missing} never trained")
    for task_id, start, end, crc in life["shards"]:
        check(crc == file_crc[(start, end)],
              f"the step on range {start}:{end} (task {task_id}) has CRC32 "
              f"{crc}, the file's rows {file_crc[(start, end)]}")
    before = [r["step"] for r in life["reports"]
              if r["ok"] and r["done_t"] <= kill_t]
    check(resumed is not None and resumed[0] == 1 and before
          and 0 < resumed[1] <= max(before),
          f"the relaunched master resumed {resumed}; steps reported before "
          f"the kill {before}")
    check(reading["global_step"] == len(trained),
          f"the relaunched master's global step {reading['global_step']}, "
          f"not the {len(trained)} steps trained")
    check(0.0 < reading["goodput"] <= 1.0,
          f"the relaunched master's goodput is {reading['goodput']}")
    after = [r for r in life["reports"] if r["ok"] and r["done_t"] > kill_t]
    check(after, "no step report reached the relaunched master")
    first_ts = after[0]["ts"]
    brackets = reading["brackets"]
    check(len(brackets) == 1, f"the relaunched master closed {len(brackets)} "
          f"downtime brackets, not one: {brackets}")
    start, end = brackets[0]
    check(start <= kill_t <= end and abs(end - first_ts) < 1e-3,
          f"the downtime bracket [{start:.3f}, {end:.3f}] does not run from "
          f"no later than the kill ({kill_t:.3f}) to the first step report "
          f"the relaunched master took ({first_ts:.3f})")
    return end - start


def check_relaunch_planner(before, after, metrics_text, windows):
    """Phase 4e's planner checks across the master's relaunch. ``before``:
    the planner document the first master left in the state store (what
    the relaunched one imports); ``after``: the relaunched master's last;
    ``metrics_text``: a ``/metrics`` body of the run; ``windows``: the
    digest windows the worker's step reports carried. Fails unless a
    decision was recorded before the kill and one after the relaunch, the
    relaunched ledger continues the imported one and its decision count
    the imported count, every decision is HOLD (world 1 with nothing
    waiting has only the incumbent) and no plan was executed, ``/metrics``
    carries ``dlrover_tpu_scale_decisions_total``, and the last decision
    that observed a step p50 reads within PLANNER_STEP_TOL of the digest
    samples' median. Returns that p50, the median and the two counts."""
    check(before is not None and before["decisions_total"] >= 1,
          f"no decision before the kill: {before}")
    check(after is not None and after["decisions_total"]
          > before["decisions_total"],
          f"no decision after the relaunch: {before and before['decisions_total']}"
          f" imported, {after and after['decisions_total']} at the end")
    n = len(before["ledger"])
    check(after["ledger"][:n] == before["ledger"]
          and after["decisions_total"] == before["decisions_total"]
          + len(after["ledger"]) - n,
          "the relaunched planner's ledger does not continue the imported "
          "one")
    verdicts = sorted({d["verdict"] for d in after["ledger"]})
    check(verdicts == ["hold"] and after["counts"].get("resize", 0) == 0
          and not after["executed"] and not after["intent"],
          f"the planner did more than HOLD: verdicts {verdicts}, counts "
          f"{after['counts']}, executed {after['executed']}")
    check('dlrover_tpu_scale_decisions_total{verdict="hold"}' in metrics_text,
          "the master's /metrics carries no planner lines")
    p50s = [d["inputs"]["step_p50_s"] for d in after["ledger"]
            if d["inputs"]["step_p50_s"] > 0]
    samples = [w["p50_s"] for w in windows if w and w.get("count")]
    check(p50s and samples, f"no decision observed a step p50 ({p50s}) or "
          f"no digest sample reached the master ({samples})")
    planner, median = p50s[-1], statistics.median(samples)
    check(abs(planner - median) <= PLANNER_STEP_TOL * median,
          f"the planner's step p50 {planner:.4f} s is not within "
          f"{PLANNER_STEP_TOL:.0%} of the digest samples' median "
          f"{median:.4f} s")
    return planner, median, before["decisions_total"], after[
        "decisions_total"]


def load_planner_doc(state_dir, job):
    """The planner document a master keeps in the file state store under
    ``state_dir`` for ``job`` (None when there is none)."""
    from dlrover_tpu_torch.master.state_store import (
        FileStateBackend, MasterStateManager)

    return MasterStateManager(FileStateBackend(
        os.path.join(state_dir, job))).load_planner()


def planner_doc_poller(state_dir, job):
    """A ``Poller`` of the planner document (``value``: the last one found;
    the master clears it when the job succeeds)."""
    return Poller(lambda: load_planner_doc(state_dir, job),
                  METRICS_POLL_S / 2)


def master_child(spec):
    """A master this script starts itself (the master CLI takes neither
    ``min_node_num`` nor the diagnosis settings): ``spec`` is a JSON
    object with ``port``, ``node_num`` and ``min_node_num``, and
    optionally ``planner`` (default armed, the scale-out leg's),
    ``config`` (master config values) and
    ``dump_records`` (print every hang dump the diagnosis manager holds at
    the end, one ``DIAG_RECORDS`` line); every other setting is the local
    master's default. Runs the master to the job's end; its log is the
    caller's."""
    from dlrover_tpu_torch.master.local_master import LocalJobMaster

    spec = json.loads(spec)
    master = LocalJobMaster(
        port=spec["port"], node_num=spec["node_num"],
        min_node_num=spec["min_node_num"], planner=spec.get("planner", True))
    master.container.config.update(spec.get("config", {}))
    master.prepare()
    rc = master.run()
    if spec.get("dump_records"):
        dumps = master.diagnosis_manager.data_manager.get_data("hang_dump")
        print("DIAG_RECORDS " + json.dumps([
            {"node_id": r.node_id, "timestamp": r.timestamp,
             "reason": r.reason, "stacks": r.stacks, "pending": r.pending}
            for r in dumps]), flush=True)
    return rc


def _master_cmd(spec):
    return [sys.executable, os.path.abspath(__file__), "--master-child",
            json.dumps(spec)]


DECLARED = re.compile(r"collective hang declared: .* silent members (.*); ")
ENQUEUED = re.compile(r"diagnosis: enqueued (\w+) for node (-?\d+): (.*)$")
RESTART_ALL = re.compile(r"diagnosis: training hang -> restart all workers")
PENDING = re.compile(r"\(pending: ([^)]*)\)")
LOG_STAMP = re.compile(r"^\[(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3})\]")


def enqueued_actions(lines):
    """Every action a master's diagnosis enqueued, in order, as
    ``(action_cls, node_id, action_content)``."""
    return [(m.group(1), int(m.group(2)), m.group(3))
            for m in map(ENQUEUED.search, lines) if m]


def check_no_actions(lines, leg):
    """The chain runs in every leg: fails if the master enqueued an action
    the leg did not cause (a restart read off a log tail, say)."""
    actions = enqueued_actions(lines)
    check(not actions, f"the master enqueued actions the {leg} did not "
          f"cause: {actions}")


def log_epoch(line):
    """The epoch seconds of a port log line's ``[date time,ms]`` stamp
    (local time, as the logger writes it)."""
    m = LOG_STAMP.search(line)
    check(m, f"no log stamp on {line!r}")
    return time.mktime(time.strptime(m.group(1), "%Y-%m-%d %H:%M:%S")) + \
        int(m.group(2)) / 1000.0


def check_action_sequence(actions, nodes):
    """A diagnosed hang's actions, as ``enqueued_actions`` reads them: one
    ``CollectHangDump`` for every node of ``nodes``, then one
    ``RestartWorker`` each with one reason, ``training_hang @ <stuck_at>``
    (and the slowest node, when the timers gave an MFU), and nothing else.
    Returns the ``stuck_at``."""
    n = len(nodes)
    check(len(actions) == 2 * n, f"the master enqueued {len(actions)} "
          f"actions, not a dump and a restart for each of nodes {nodes}: "
          f"{actions}")
    dumps, restarts = actions[:n], actions[n:]
    check(all(a[0] == "CollectHangDump" and a[2] == "training_hang"
              for a in dumps) and sorted(a[1] for a in dumps) == sorted(
                  nodes), f"the first actions are not one hang dump a "
          f"node: {dumps}")
    check(all(a[0] == "RestartWorker" for a in restarts)
          and sorted(a[1] for a in restarts) == sorted(nodes),
          f"the dumps are not followed by one restart a node: {restarts}")
    reasons = sorted({a[2] for a in restarts})
    check(len(reasons) == 1, f"the restarts differ in reason: {reasons}")
    m = re.match(r"training_hang @ (.+?)( \[slowest node -?\d+\])?$",
                 reasons[0])
    check(m, f"the restart's reason names no stuck_at: {reasons[0]!r}")
    return m.group(1)


def check_stuck_at(stuck_at, hot_path, want_leaf, want_through):
    """The master's ``stuck_at`` matches the regex ``want_leaf`` and is
    the leaf of ``hot_path`` (the dumped stacks' heaviest path, root
    first), which passes through a frame matching ``want_through``."""
    check(re.match(want_leaf, stuck_at),
          f"stuck_at {stuck_at!r} is not the wait {want_leaf!r}")
    check(hot_path and hot_path[-1] == stuck_at,
          f"stuck_at {stuck_at!r} is not the dumped stacks' leaf: "
          f"{hot_path}")
    check(any(re.match(want_through, f) for f in hot_path),
          f"the dumped stacks' path {hot_path} passes through no "
          f"{want_through!r}")


def check_timer_against_digest(before, after, samples, flops_per_step):
    """The device timer's ``train_step`` between two scrapes of its
    ``/metrics`` (``scrape_metrics`` dicts) against the digest's samples of
    the same steps: as many executions as samples, at least 8; the mean
    latency within DIAG_TIMER_TOL of the samples' mean; the MFU gauge of
    the later scrape within DIAG_MFU_TOL of ``flops_per_step`` over that
    mean over the bf16 peak. Returns (timer mean s, digest mean s, gauge,
    the script's MFU)."""
    a = before["programs"]["train_step"]
    b = after["programs"]["train_step"]
    n = int(b["execute_total"] - a["execute_total"])
    check(n == len(samples) and n >= 8, f"the timer ended {n} train_step "
          f"executions between its scrapes, the digest took "
          f"{len(samples)} samples (at least 8 needed)")
    timer_s = (b["execute_us_sum"] - a["execute_us_sum"]) / n / 1e6
    digest_s = sum(samples) / n
    check(abs(timer_s - digest_s) <= DIAG_TIMER_TOL * digest_s,
          f"the timer's train_step {timer_s:.6f} s is not within "
          f"{DIAG_TIMER_TOL:.0%} of the digest's {digest_s:.6f} s")
    mfu = flops_per_step / digest_s / PEAK_BF16_FLOPS
    gauge = float(after.get("mfu", 0.0))
    check(abs(gauge - mfu) <= DIAG_MFU_TOL * mfu,
          f"the timer's MFU gauge {gauge:.4f} is not within "
          f"{DIAG_MFU_TOL:.0%} of the script's {mfu:.4f}")
    return timer_s, digest_s, gauge, mfu


def check_hang(first, second, declared, reading):
    """Phase 4e's hang leg. ``first``, ``second``: the worker's two lives
    (``steps`` with full-precision losses, ``reports``, the ``stop``
    record of the first, the ``end`` record of the second); ``declared``:
    the master's declaration lines; ``reading``: its exit summary. Fails
    unless the master declared one hang with no silent member, billed
    ``collective_hang`` in [W, 1.25 W + 1 s] (W ``HANG_WINDOW_S``), and
    kept one downtime bracket from the first life's last step report (the
    last progress stamp) to the second life's first; unless the first life
    stopped before ``HANG_STEPS`` steps and the second trained every step,
    its step 1 bitwise the first life's (same seed, batch and state); or
    unless every kernel launched in both lives. Returns the hang seconds
    and the bracket."""
    check(len(declared) == 1, f"the master declared {len(declared)} hangs, "
          f"not one: {declared}")
    m = DECLARED.search(declared[0])
    check(m and m.group(1) == "none",
          f"the declaration named silent members: {declared[0]}")
    check(first["stop"] is not None and len(first["steps"]) < HANG_STEPS,
          f"the first life trained {len(first['steps'])} steps and stopped "
          f"{first['stop']}")
    check(second["end"] is not None and len(second["steps"]) == HANG_STEPS,
          f"the second life trained {len(second['steps'])} of {HANG_STEPS} "
          "steps")
    one, two = first["steps"][0]["loss"], second["steps"][0]["loss"]
    check(one == two, f"the second life's step-1 loss {two!r} is not "
          f"bitwise the first life's {one!r}")
    hang_s = reading["attribution"]["categories"]["collective_hang"]
    window = HANG_WINDOW_S
    check(window <= hang_s <= 1.25 * window + 1.0,
          f"collective_hang {hang_s:.3f} s is outside [{window}, "
          f"{1.25 * window + 1.0}] s")
    last = [r["ts"] for r in first["reports"] if r["ok"]][-1]
    resumed = [r["ts"] for r in second["reports"] if r["ok"]][0]
    brackets = reading["brackets"]
    check(len(brackets) == 1 and abs(brackets[0][0] - last) < 1e-3
          and abs(brackets[0][1] - resumed) < 1e-3,
          f"the downtime brackets {brackets} are not one from the last "
          f"progress stamp {last:.3f} to the second life's first step "
          f"report {resumed:.3f}")
    for label, counts in (("first", first["stop"]["counts"]),
                          ("second", second["end"]["counts"])):
        for name, n in counts.items():
            check(n > 0, f"kernel {name} never launched in the {label} "
                  "life of the hang leg")
    return hang_s, brackets[0]


def _hang_lives(job, leg="hang", rank=0):
    """The two lives of the hang leg's worker (or of ``leg``'s worker
    ``rank``): both wrote the one log (a re-formed round restarts the
    worker under the same restart count), split at each ``life``
    record."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir

    path = os.path.join(agent_log_dir(job, 0),
                        f"worker-{rank}-restart0.log")
    check(os.path.exists(path), f"no log of the {leg} leg's worker: {path}")
    lives = []
    with open(path, errors="replace") as f:
        for line in f:
            if not line.startswith("DATA_CHILD_JSON "):
                continue
            rec = json.loads(line.split(" ", 1)[1])
            if rec["kind"] == "life":
                lives.append({"life": rec, "steps": [], "reports": [],
                              "stop": None, "end": None, "records": []})
                continue
            check(lives, f"a record before the first life's: {rec}")
            life = lives[-1]
            life["records"].append(rec)
            if rec["kind"] in ("step", "report"):
                life[rec["kind"] + "s"].append(rec)
            else:
                life[rec["kind"]] = rec
    check(len(lives) == 2 and lives[0]["life"]["first"]
          and not lives[1]["life"]["first"],
          f"the {leg} leg's worker lived {len(lives)} lives: "
          f"{[x['life'] for x in lives]}")
    return lives


def _run_cli(cmd, env, label, timeout, poller=None):
    """Run a CLI from the checkout until it ends, killed after ``timeout``
    seconds, printing each line under ``label`` and keeping it; a
    ``MetricsPoller`` given reads the master's /metrics meanwhile. Returns
    the ended process and its lines."""
    repo = os.path.dirname(os.path.abspath(__file__))
    lines = []
    proc = subprocess.Popen(cmd, cwd=repo, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    timer = threading.Timer(timeout, proc.kill)
    timer.start()
    try:
        with poller or contextlib.nullcontext():
            for line in iter(proc.stdout.readline, ""):
                lines.append(line.rstrip())
                print(f"  [{label}] {line.rstrip()}", flush=True)
    finally:
        timer.cancel()
        proc.kill()
        proc.wait(timeout=60)
    return proc, lines


def _relaunch_leg(workdir, path, tokens, before_go=lambda: None):
    """Phase 4e's master-relaunch leg (module docstring); ``before_go``
    returns once the worker may leave its hold before the first step."""
    import numpy as np

    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.utils.net import find_free_port

    t_leg = time.perf_counter()
    job = f"chip_smoke_relaunch_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    repo = os.path.dirname(os.path.abspath(__file__))
    port = find_free_port()
    state_dir = os.path.join(workdir, "state")
    # the master CLI with the planner armed by its flags
    env, mport = metrics_env(dict(
        os.environ, PYTHONPATH=repo + os.pathsep
        + os.environ.get("PYTHONPATH", ""),
        DLROVER_TPU_STATE_BACKEND="file", DLROVER_TPU_STATE_DIR=state_dir,
        DLROVER_TPU_JOB_NAME=job, DLROVER_TPU_PLANNER="1",
        DLROVER_TPU_PLANNER_INTERVAL_S=str(RELAUNCH_PLANNER_INTERVAL_S)))
    masters = []

    def launch(tag):
        log = os.path.join(workdir, f"master-{tag}.log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.master.main",
                 "--port", str(port)], cwd=repo, env=env, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True)
        masters.append(proc)
        deadline = time.time() + 60
        while f"serving on port {port}" not in open(log).read():
            check(proc.poll() is None and time.time() < deadline,
                  f"the {tag} master did not serve on port {port}: "
                  f"{open(log).read()[-2000:]}")
            time.sleep(0.02)
        return proc, log, time.time()

    cli_out = {}
    metrics = MetricsPoller(mport)
    try:
        metrics.__enter__()
        m1, log1, _ = launch("first")
        print(f"  [relaunch] master on port {port} (planner armed, a "
              f"decision every {RELAUNCH_PLANNER_INTERVAL_S} s after the "
              f"auto-scaler's warmup), state under {state_dir}", flush=True)
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
               f"--master_addr=127.0.0.1:{port}", "--nnodes=1",
               "--nproc_per_node=1", f"--job_name={job}",
               os.path.abspath(__file__), "--", "--data-child", "relaunch",
               path]
        print(f"  [relaunch] {' '.join(cmd[1:])}", flush=True)

        def run_cli():
            cli_out["proc"], cli_out["lines"] = _run_cli(
                cmd, env, "relaunch", CONTROL_TIMEOUT_S)

        cli = threading.Thread(target=run_cli, daemon=True)
        cli.start()
        wlog = os.path.join(agent_log_dir(job, 0), "worker-0-restart0.log")
        deadline = time.time() + CONTROL_TIMEOUT_S
        go_dir = os.path.dirname(path)

        def decided(n, what):
            """Wait for the master's planner document to count more than
            ``n`` decisions, then let the worker past its hold."""
            while True:
                doc = load_planner_doc(state_dir, job)
                if doc is not None and doc["decisions_total"] > n:
                    break
                check(cli.is_alive() and time.time() < deadline,
                      f"the {what} master decided nothing")
                time.sleep(0.1)
            open(os.path.join(go_dir, RELAUNCH_GO[what != "first"]),
                 "w").close()

        before_go()
        decided(0, "first")
        while True:
            text = open(wlog).read() if os.path.exists(wlog) else ""
            if text.count('"kind": "shard"') >= RELAUNCH_KILL_AFTER:
                break
            check(cli.is_alive() and time.time() < deadline,
                  f"the worker never trained {RELAUNCH_KILL_AFTER} shards: "
                  f"{text[-2000:]}")
            time.sleep(0.02)
        os.kill(m1.pid, signal.SIGKILL)
        kill_t = time.time()
        m1.wait(timeout=30)
        # what the relaunched master imports
        imported = load_planner_doc(state_dir, job)
        with planner_doc_poller(state_dir, job) as docs:
            m2, log2, serve_t = launch("second")
            decided(imported["decisions_total"], "relaunched")
            cli.join(timeout=CONTROL_TIMEOUT_S)
            check(not cli.is_alive(), "the relaunch leg's CLI did not end")
            m2.wait(timeout=120)
        metrics.__exit__(None, None, None)
        with open(log1) as f:
            m1_lines = [x.rstrip() for x in f]
        with open(log2) as f:
            m2_lines = [x.rstrip() for x in f]
        for line in m2_lines:
            print(f"  [relaunch second master] {line}", flush=True)
        check(not any("planner sweep failed" in x
                      for x in m1_lines + m2_lines),
              "a master's planner sweep raised")
        check_no_actions(m1_lines + m2_lines, "relaunch leg")
        life = _data_life(job, 0)
        for rec in life["records"]:
            print(f"  [relaunch worker] {json.dumps(rec)}", flush=True)
        check(cli_out["proc"].returncode == 0,
              f"the relaunch leg's CLI exited {cli_out['proc'].returncode}")
        check(m2.returncode == 0 and any(
            "local master exiting: succeeded" in x for x in m2_lines),
            f"the relaunched master's exit {m2.returncode}: "
            f"{[x for x in m2_lines if 'exiting' in x]}")
        end = life["end"]
        ckpt = end["shard_ckpt"]
        check(ckpt["completed_records"] == DATA_RECORDS and not ckpt["todo"]
              and not ckpt["doing"] and ckpt["epoch"] == 1,
              f"the relaunched master's dataset at the end: {ckpt}")
        for name, n in end["counts"].items():
            check(n > 0, f"kernel {name} never launched in the relaunch "
                  "leg's worker")
        check(not any(end["fallback"].values()),
              f"the per-task fallback fired: {end['fallback']}")
        ranges = [(s, min(s + DATA_SHARD_SIZE, DATA_RECORDS))
                  for s in range(0, DATA_RECORDS, DATA_SHARD_SIZE)]
        file_crc = {(s, e): zlib.crc32(tokens[s:e].astype(np.int32)
                                       .tobytes()) for s, e in ranges}
        resumed = next(((int(m.group(1)), int(m.group(2))) for m in map(
            RESUMED.search, m2_lines) if m), None)
        reading = master_reading(m2_lines)
        bracket_s = check_relaunch(life, ranges, file_crc, kill_t, reading,
                                   resumed)
        # the last step waited for the relaunched master's decision
        ends = [rec["end_t"] for rec in life["records"]
                if rec["kind"] == "shard"][:-1]
        longest = max(b - a for a, b in zip(ends, ends[1:]))
        lease_s = max(x["seconds"] for x in life["leases"])
        failed = sum(not r["ok"] for r in life["reports"])
        print(f"  [relaunch] all {len(ranges)} ranges trained once, every "
              f"step's CRC32 equal to the file's rows, the dataset complete "
              f"with {ckpt['completed_records']} records; the relaunched "
              f"master restored {resumed[0]} dataset at global step "
              f"{resumed[1]} and ended at {reading['global_step']}; the "
              f"gap from the kill to the new master serving "
              f"{serve_t - kill_t:.3f} s; the worker's longest interval "
              f"between two step ends before its hold for the last "
              f"{longest:.3f} s; the largest lease "
              f"RPC {lease_s:.3f} s; step reports that failed in the gap "
              f"{failed}", flush=True)
        print_master("relaunch", None, reading, bracket_s,
                     "the relaunch's bracket")
        p50, median, n_before, n_after = check_relaunch_planner(
            imported, docs.value, metrics.text,
            [r["digest"] for r in life["reports"]])
        print(f"  [relaunch] planner: {n_before} decisions before the kill, "
              f"the relaunched master imported them and ended at "
              f"{n_after}, every one HOLD ({sorted({d['reason'] for d in docs.value['ledger']})}),"
              f" none executed; its last observed step p50 {p50:.4f} s "
              f"against the digest samples' median {median:.4f} s "
              f"({(p50 - median) / median:+.1%}, tol "
              f"{PLANNER_STEP_TOL:.0%}); /metrics: "
              f"{[x for x in metrics.text.splitlines() if 'scale_decisions' in x and not x.startswith('#')]}",
              flush=True)
    finally:
        metrics.__exit__(None, None, None)
        for proc in masters:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    print(f"  master-relaunch leg: {time.perf_counter() - t_leg:.1f}s",
          flush=True)


def _hang_leg(path):
    """Phase 4e's hang leg (module docstring)."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.common.ipc import default_socket_path

    t_leg = time.perf_counter()
    job = f"chip_smoke_hang_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               DLROVER_TPU_HANG_WATCHDOG_WINDOW_S=str(HANG_WINDOW_S))
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
           "--standalone", "--nnodes=1", "--nproc_per_node=1",
           "--max_restarts=1", f"--job_name={job}",
           os.path.abspath(__file__), "--", "--data-child", "hang", path]
    try:
        print(f"  [hang] {' '.join(cmd[1:])}", flush=True)
        proc, lines = _run_cli(cmd, env, "hang", CONTROL_TIMEOUT_S)
        first, second = _hang_lives(job)
        for label, life in (("first", first), ("second", second)):
            for rec in life["records"]:
                print(f"  [hang {label} life] {json.dumps(rec)}",
                      flush=True)
        check(proc.returncode == 0,
              f"the hang leg's CLI exited {proc.returncode}, not 0")
        check_no_actions(lines, "hang leg")
        exit_line = [x for x in lines if "local master exiting:" in x]
        check(exit_line and "local master exiting: succeeded" in
              exit_line[-1], f"the master's exit: {exit_line}")
        declared = [x for x in lines if "collective hang declared" in x]
        reading = master_reading(lines)
        hang_s, bracket = check_hang(first, second, declared, reading)
        declared_t = bracket[0] + hang_s
        seen_t = _agent_stamp(lines, "membership changed; restarting",
                              r"seen at ([0-9.]+)")
        stopped_t = _agent_stamp(lines, "workers stopped at",
                                 r"stopped at ([0-9.]+)")
        starts = [float(m.group(1)) for m in (
            re.search(r" at ([0-9.]+) log=", x) for x in lines
            if "started worker" in x) if m]
        check(len(starts) == 2, f"the agent started {len(starts)} workers")
        step1_t = second["steps"][0]["end_t"]
        phases = {
            "stall_to_declaration_s": declared_t - bracket[0],
            "declaration_to_agent_s": seen_t - declared_t,
            "agent_to_worker_stopped_s": stopped_t - seen_t,
            "stopped_to_new_worker_start_s": starts[1] - stopped_t,
            "new_worker_start_to_step1_end_s": step1_t - starts[1],
        }
        print(f"  [hang] one hang declared ({declared[0].split('] ')[-1]}),"
              f" collective_hang {hang_s:.3f} s (window {HANG_WINDOW_S} s);"
              f" the first life stopped after step {first['stop']['step']},"
              f" the second trained steps 1-{len(second['steps'])}, step 1 "
              f"loss {second['steps'][0]['loss']!r} bitwise the first "
              f"life's; time to recover {step1_t - bracket[0]:.3f} s from "
              f"the stall to the new worker's first step end: the stall to "
              f"the declaration {declared_t - bracket[0]:.3f} s, the "
              f"declaration to the worker stopped {stopped_t - declared_t:.3f}"
              f" s, the stop to the new worker's first step end "
              f"{step1_t - stopped_t:.3f} s; by phase {json.dumps(phases)}",
              flush=True)
        print_master("hang", None, reading, bracket[1] - bracket[0],
                     "the hang's bracket")
    finally:
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    print(f"  hang leg: {time.perf_counter() - t_leg:.1f}s", flush=True)


def free_port_block(n):
    """The first of ``n`` consecutive free loopback ports."""
    from dlrover_tpu_torch.utils.net import find_free_port

    for _ in range(50):
        base = find_free_port()
        try:
            with contextlib.ExitStack() as stack:
                for port in range(base, base + n):
                    sock = stack.enter_context(socket.socket())
                    sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
    raise SmokeFailure(f"no {n} consecutive free ports")


def start_master_child(spec, env, log, label):
    """Start ``master_child(spec)`` with its log in ``log``; returns the
    process once it serves."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(log, "w") as out:
        proc = subprocess.Popen(_master_cmd(spec), cwd=repo, env=env,
                                stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    deadline = time.time() + 60
    while f"serving on port {spec['port']}" not in open(log).read():
        check(proc.poll() is None and time.time() < deadline,
              f"the {label} master did not serve: {open(log).read()[-2000:]}")
        time.sleep(0.05)
    return proc


def diag_master_spec(port, node_num):
    """The diagnosis legs' master: the planner off, the chain every
    DIAG_MASTER_INTERVAL_S with the silence cut to DIAG_SILENCE_S, its
    hang dumps printed at the end."""
    return {"port": port, "node_num": node_num, "min_node_num": node_num,
            "planner": False,
            "config": {"seconds_hang_threshold": DIAG_SILENCE_S,
                       "seconds_diagnosis_interval": DIAG_MASTER_INTERVAL_S},
            "dump_records": True}


def diag_env(base):
    """The agent's and the workers' environment in the diagnosis legs:
    the agent's interval and the timer's hang timeout cut."""
    return dict(base, DLROVER_TPU_DIAG_INTERVAL=str(DIAG_AGENT_INTERVAL_S),
                DLROVER_TPU_TIMER_HANG_SECS=str(DIAG_TIMER_HANG_S))


def hang_dump_records(mlines):
    """The hang dumps the master held at its end (``DIAG_RECORDS``)."""
    rec = [x for x in mlines if x.startswith("DIAG_RECORDS ")]
    check(rec, "the master printed no hang-dump records")
    return json.loads(rec[-1].split(" ", 1)[1])


def dumped_hot_path(records, pids):
    """The heaviest path of the main-thread stacks of ``pids`` over every
    hang dump the master held (what its resolver summarised)."""
    from dlrover_tpu_torch.profiler.analysis import StackTrie

    trie = StackTrie()
    for rec in records:
        for pid, text in rec["stacks"].items():
            if int(pid) in pids:
                trie.add_dump(text, main_only=True)
    return trie.hot_path()


def diag_phases(mlines, lines, spin_t, stall_label):
    """Seconds between the steps of a diagnosed hang, from the master's
    log stamps and the agent's lines: the stall to the agent reading the
    timer's flag, to the master confirming it, to the agent getting the
    dump request, to the dump shipped, to the master's restart, to the
    agent getting it, to the workers stopped (the breakpoint persist
    first), to the new workers' start. Returns (stamps, phases)."""
    confirmed = [log_epoch(x) for x in mlines if "hang confirmed" in x]
    restart = [log_epoch(x) for x in mlines
               if "enqueued RestartWorker" in x]
    check(confirmed and restart, "the master logged no confirmed hang or "
          "no restart")
    t = {
        stall_label: spin_t,
        "agent_read_the_flag": _agent_stamp(
            lines, "the device timer flagged a hang", r"at ([0-9.]+);"),
        "master_confirmed": confirmed[0],
        "agent_got_dump_request": _agent_stamp(
            lines, "master requested a hang dump", r"seen at ([0-9.]+)"),
        "dump_shipped": _agent_stamp(
            lines, "shipped master-requested hang dump", r"at ([0-9.]+)$"),
        "master_restart_all": restart[0],
        "agent_got_restart": _agent_stamp(
            lines, "master requested a restart", r"seen at ([0-9.]+)"),
        "workers_stopped": _agent_stamp(lines, "workers stopped at",
                                        r"stopped at ([0-9.]+)"),
    }
    starts = [float(m.group(1)) for m in (
        re.search(r" at ([0-9.]+) log=", x) for x in lines
        if "started worker" in x) if m]
    t["new_workers_started"] = max(starts)
    names = list(t)
    phases = {f"{a}_to_{b}_s": t[b] - t[a] for a, b in zip(names,
                                                            names[1:])}
    return t, phases


def _diag_leg(workdir, path):
    """Phase 4e's diagnosis leg (module docstring): a device hang
    detected by the timer, dumped, named and recovered."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.profiler import tpu_timer
    from dlrover_tpu_torch.utils.net import find_free_port

    t_leg = time.perf_counter()
    job = f"chip_smoke_diag_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    repo = os.path.dirname(os.path.abspath(__file__))
    port = find_free_port()
    tport = free_port_block(1)
    base = dict(os.environ, PYTHONPATH=repo + os.pathsep
                + os.environ.get("PYTHONPATH", ""), DLROVER_TPU_JOB_NAME=job)
    mlog = os.path.join(workdir, "diag-master.log")
    master = None
    try:
        master = start_master_child(diag_master_spec(port, 1), dict(
            base, DLROVER_TPU_HANG_WATCHDOG_WINDOW_S=str(
                DIAG_WATCHDOG_WINDOW_S)), mlog, "diagnosis")
        # the device snapshot's copy of the state would not fit beside
        # the relaunch leg's held worker: each save pauses for its copy
        env = dict(diag_env(base), DLROVER_TPU_DEVICE_SNAPSHOT="0")
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
               f"--master_addr=127.0.0.1:{port}", "--nnodes=1",
               "--nproc_per_node=1", "--max_restarts=1", "--tpu-timer",
               f"--tpu-timer-port={tport}", f"--job_name={job}",
               os.path.abspath(__file__), "--", "--data-child", "diag",
               path]
        print(f"  [diag] master on port {port} (chain every "
              f"{DIAG_MASTER_INTERVAL_S} s, silence {DIAG_SILENCE_S} s, "
              f"watchdog window {DIAG_WATCHDOG_WINDOW_S} s); agent interval "
              f"{DIAG_AGENT_INTERVAL_S} s, timer hang {DIAG_TIMER_HANG_S} s;"
              f" {' '.join(cmd[1:])}", flush=True)
        out = {}

        def run_cli():
            out["proc"], out["lines"] = _run_cli(cmd, env, "diag",
                                                 DIAG_TIMEOUT_S)

        cli = threading.Thread(target=run_cli, daemon=True)
        cli.start()
        wlog = os.path.join(agent_log_dir(job, 0), "worker-0-restart0.log")
        deadline = time.time() + DIAG_TIMEOUT_S
        pending = None
        while cli.is_alive() and time.time() < deadline:
            text = open(wlog).read() if os.path.exists(wlog) else ""
            spin = [json.loads(x.split(" ", 1)[1]) for x in
                    text.splitlines() if x.startswith("DATA_CHILD_JSON ")
                    and '"kind": "spin"' in x]
            if spin and time.time() > spin[0]["t"] + DIAG_TIMER_HANG_S + 2:
                pending = json.loads(tpu_timer._http_get(tport, "/pending"))
                break
            time.sleep(0.2)
        print(f"  [diag] /pending during the hang: {json.dumps(pending)}",
              flush=True)
        cli.join(timeout=DIAG_TIMEOUT_S)
        check(not cli.is_alive(), "the diagnosis leg's CLI did not end")
        master.wait(timeout=120)
        with open(mlog) as f:
            mlines = [x.rstrip() for x in f]
        for line in mlines:
            if not line.startswith("DIAG_RECORDS "):
                print(f"  [diag master] {line}", flush=True)
        lines = out["lines"]
        first, second = _hang_lives(job, "diagnosis")
        for label, life in (("first", first), ("second", second)):
            for rec in life["records"]:
                if rec["kind"] != "scrape":
                    print(f"  [diag {label} life] {json.dumps(rec)}",
                          flush=True)
        check(out["proc"].returncode == 0 and master.returncode == 0,
              f"the diagnosis leg's CLI exited {out['proc'].returncode}, "
              f"its master {master.returncode}")
        check(any("local master exiting: succeeded" in x for x in mlines),
              "the diagnosis leg's master did not log the job succeeded")
        spin = next(r for r in first["records"] if r["kind"] == "spin")
        check(pending is not None and pending["hang"] and [
            p["name"] for p in pending["pending"]] == ["train_step"],
            f"/pending during the hang: {pending}")
        result = check_diagnosis(first, second, mlines, lines, spin)
        stamps, phases = diag_phases(mlines, lines, spin["t"],
                                     "spin_enqueued")
        check(stamps["agent_got_restart"] < spin["t"] + DIAG_SPIN_S,
              "the restart came after the spin's end")
        step1_t = second["steps"][0]["end_t"]
        phases["new_workers_started_to_step_end_s"] = (
            step1_t - stamps["new_workers_started"])
        print(f"  [diag] every action the master enqueued: "
              f"{json.dumps(enqueued_actions(mlines))}", flush=True)
        print(f"  [diag] {result['summary']}; the worker stopped "
              f"{stamps['workers_stopped'] - stamps['agent_got_restart']:.3f}"
              f" s after the agent got the restart ({result['ended']}); "
              f"the stall to the resumed step's end "
              f"{step1_t - spin['t']:.3f} s; by phase {json.dumps(phases)}",
              flush=True)
    finally:
        if master is not None and master.poll() is None:
            master.kill()
            master.wait()
        unlink_segment(job)
        shutil.rmtree(os.path.join(workdir, "diag_ck"), ignore_errors=True)
        with contextlib.suppress(OSError):
            os.unlink(os.path.join(workdir, "diag-spun"))
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    print(f"  diagnosis leg: {time.perf_counter() - t_leg:.1f}s", flush=True)


def check_diagnosis(first, second, mlines, lines, spin):
    """The diagnosis leg's checks: one hang confirmed; the master's actions
    a dump request and then one restart (``check_action_sequence``), whose
    ``stuck_at`` is the worker's wait for its step in ``timed_step``, the
    leaf of the dumped stacks' path through the training loop; a hang
    dump holding the first life's stack; the restart's pending programs
    ``train_step``; one restart: the second life restored the last staged
    step and trained every step after it, at the first life's step time
    (no spin outlived the first life); every kernel launched in both
    lives; the timer against the digest (``check_timer_against_digest``).
    Returns the readings."""
    confirmed = [x for x in mlines if "hang confirmed" in x]
    check(len(confirmed) == 1, f"{len(confirmed)} hangs confirmed: "
          f"{confirmed}")
    stuck_at = check_action_sequence(enqueued_actions(mlines), [0])
    records = hang_dump_records(mlines)
    pid = first["life"]["pid"]
    check(any(str(pid) in r["stacks"] and "timed_step" in r["stacks"][
        str(pid)] for r in records), f"no hang dump holds the first "
          f"life's stack (pid {pid}): {records}")
    hot = dumped_hot_path(records, {pid})
    check_stuck_at(stuck_at, hot, r"timed_step \(llama_pretrain\.py:\d+\)$",
                   r"run \(llama_pretrain\.py:\d+\)$")
    restart = [x for x in mlines if RESTART_ALL.search(x)]
    pending = [PENDING.search(x) for x in restart]
    check(len(restart) == 1 and pending[0] and pending[0].group(1)
          == "train_step", f"the restart's pending programs: {restart}")
    starts = [x for x in lines if "started worker" in x]
    check(len(starts) == 2, f"the agent started {len(starts)} workers")
    end = second["end"]
    check(end is not None and end["restore"] is not None,
          f"the second life restored nothing: {end}")
    check(end["restore"]["step"] == DIAG_SPIN_STEP - 1
          and end["start_step"] == DIAG_SPIN_STEP - 1
          and len(second["steps"]) == DIAG_STEPS - DIAG_SPIN_STEP + 1,
          f"the second life restored step {end['restore']['step']} and "
          f"trained {len(second['steps'])} steps")
    for label, counts in (("first", spin["counts"]),
                          ("second", end["counts"])):
        for name, n in counts.items():
            check(n > 0, f"kernel {name} never launched in the {label} "
                  "life of the diagnosis leg")
    before = [r["seconds"] for r in first["steps"][2:]]
    after = [r["seconds"] for r in second["steps"][1:]]
    ratio = statistics.median(after) / statistics.median(before)
    check(ratio <= 1 + DIAG_RESUMED_STEP_TOL, f"the resumed life's step "
          f"{statistics.median(after):.4f} s against "
          f"{statistics.median(before):.4f} s before the spin: a spin "
          "outlived its process?")
    scrapes = [r for r in first["records"] if r["kind"] == "scrape"]
    check(len(scrapes) == 2, f"the first life read its timer "
          f"{len(scrapes)} times")
    n0 = len(scrapes[0]["samples"])
    samples = scrapes[1]["samples"][n0:]
    flops = 6.0 * end["params"] * end["tokens_per_step"]
    timer_s, digest_s, gauge, mfu = check_timer_against_digest(
        scrapes[0]["metrics"], scrapes[1]["metrics"], samples, flops)
    b = scrapes[1]["metrics"]["programs"]["train_step"]
    stopped = _agent_stamp(lines, "workers stopped at",
                           r"stopped at ([0-9.]+)")
    seen = _agent_stamp(lines, "master requested a restart",
                        r"seen at ([0-9.]+)")
    persist = _agent_stamp(lines, "breakpoint persist", r"in ([0-9.]+)s")
    ended = ("SIGTERM ended it" if stopped - seen - persist < 10.0
             else "the SIGKILL after the 10 s grace ended it")
    summary = (
        f"one hang confirmed; stuck_at {stuck_at!r} (the dumped path "
        f"{hot}); pending {pending[0].group(1)!r}; restored step "
        f"{end['restore']['step']} by tier {end['restore']['tier']} in "
        f"{end['restore']['seconds']:.3f} s and trained steps "
        f"{DIAG_SPIN_STEP}-{DIAG_STEPS}, median step {statistics.median(after):.4f} s "
        f"against {statistics.median(before):.4f} s before the spin; "
        f"before the hang the timer counted {int(b['execute_total'])} "
        f"train_step executions, {len(samples)} between its scrapes at "
        f"{timer_s:.6f} s against the digest's {digest_s:.6f} s "
        f"({(timer_s - digest_s) / digest_s:+.3%}); its MFU gauge "
        f"{gauge:.4f} against the script's {mfu:.4f} "
        f"({(gauge - mfu) / mfu:+.2%}); breakpoint persist {persist:.3f} s")
    return {"summary": summary, "ended": ended, "stuck_at": stuck_at}


def phase_control(torch):
    """Phase 4e, the control plane's recovery (module docstring)."""
    t0 = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_control_")
    try:
        path = os.path.join(workdir, "corpus.bin")
        tokens = write_corpus(path)
        torch.cuda.empty_cache()
        # the diagnosis and the hang legs run, one after the other, while
        # the relaunch leg's worker holds before its first step (the
        # auto-scaler's warmup), beside a worker that holds only its state:
        # a trained one keeps more of the card's memory cached than a
        # second trainer leaves free
        legs = {}

        def overlapped():
            try:
                _diag_leg(workdir, path)
                _hang_leg(path)
            except BaseException as e:  # re-raised by the relaunch leg
                legs["error"] = e

        thread = threading.Thread(target=overlapped, daemon=True)
        thread.start()

        def legs_done():
            thread.join(timeout=DIAG_TIMEOUT_S + CONTROL_TIMEOUT_S)
            check(not thread.is_alive(), "the diagnosis and hang legs did "
                  "not end")
            if "error" in legs:
                raise legs["error"]

        try:
            _relaunch_leg(workdir, path, tokens, before_go=legs_done)
        finally:
            thread.join(timeout=DIAG_TIMEOUT_S + CONTROL_TIMEOUT_S)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  control-plane phase: {seconds:.1f}s (limit "
          f"{CONTROL_PHASE_LIMIT_S}s)", flush=True)
    check(seconds < CONTROL_PHASE_LIMIT_S,
          f"phase 4e took {seconds:.1f}s, over {CONTROL_PHASE_LIMIT_S}s")


def _card_vs_cpu(torch, label, params_cpu, batch_cpu, batch_gpu, loss_cpu,
                 loss_gpu):
    """Loss and every grad: bf16 + kernels on the card against f32 + plain
    versions on the CPU, same weights, same batch."""
    from dlrover_tpu_torch.common.tree import flatten, map_tree

    params_gpu = map_tree(lambda t: t.cuda(), params_cpu)

    def loss_and_grads(params, batch, loss_fn):
        leaves = [p.requires_grad_(True) for _, p in flatten(params)]
        loss = loss_fn(params, batch)
        return loss, torch.autograd.grad(loss, leaves)

    loss_c, grads_c = loss_and_grads(params_cpu, batch_cpu, loss_cpu)
    loss_g, grads_g = loss_and_grads(params_gpu, batch_gpu, loss_gpu)
    diff = abs(loss_g.item() - loss_c.item())
    print(f"  {label}: loss card(bf16) {loss_g.item():.5f} cpu(f32) "
          f"{loss_c.item():.5f} diff {diff:.2e} (tol {E2E_LOSS_TOL})",
          flush=True)
    check(diff <= E2E_LOSS_TOL, f"{label}: reference loss differs by {diff}")
    worst = 0.0
    for (path, _), gg, gc in zip(flatten(params_cpu), grads_g, grads_c):
        fro = ((gg.float().cpu() - gc).norm() / gc.norm().clamp_min(1e-30))
        worst = max(worst, fro.item())
        check(fro.item() <= E2E_GRAD_REL_FRO_TOL,
              f"{label}: reference grad {path} relative error {fro.item()}")
    print(f"  {label}: every grad within rel_fro {worst:.3e} "
          f"(tol {E2E_GRAD_REL_FRO_TOL})", flush=True)


def phase_reference(torch, remat_policy):
    """A small Llama with head dim 128 (its loss on the fused CE)."""
    from dlrover_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(
        vocab_size=512, dim=256, n_heads=2, n_kv_heads=1, ffn_dim=512,
        n_layers=2, remat=True, remat_policy=remat_policy,
    )
    gen = torch.Generator(device="cpu").manual_seed(7)
    params = llama.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 320), generator=gen)
    cfg_bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    _card_vs_cpu(torch, f"llama remat {remat_policy!r}", params, tokens,
                 tokens.cuda(), lambda p, t: llama.loss_fn(p, t, cfg),
                 lambda p, t: llama.loss_fn(p, t, cfg_bf16))


def phase_reference_vit(torch):
    """A small ViT with head dim 64, 100 patches (not a multiple of the
    kernels' 64-row tiles) and 300 classes (not a multiple of 8), a -1 pad
    label, remat on."""
    from dlrover_tpu_torch.models import vit

    cfg = vit.ViTConfig.tiny(image_size=80, patch_size=8, n_classes=300,
                             dim=128, n_heads=2, mlp_dim=256, remat=True)
    gen = torch.Generator(device="cpu").manual_seed(11)
    params = vit.init_params(cfg, gen)
    images = torch.randn((6, 80, 80, 3), generator=gen)
    labels = torch.randint(0, 300, (6,), generator=gen)
    labels[-1] = -1
    cfg_bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    _card_vs_cpu(torch, "vit", params, (images, labels),
                 (images.cuda(), labels.cuda()),
                 lambda p, b: vit.loss_fn(p, b, cfg),
                 lambda p, b: vit.loss_fn(p, b, cfg_bf16))


def check_four_card(first, second, nbytes, world=FOUR_CARD_WORLD):
    """The four-card leg's checks over each rank's result (indexed by rank)
    of the first and the second life: the ranks' losses equal at every
    step of each life; each rank's staged bytes within
    FOUR_CARD_SHARE_TOL of ``nbytes / world`` and the shares together the
    state (plus its scalars' few bytes); every rank restored step 2, every
    leaf's CRC32 equal across the ranks and to the state the first life
    staged (the same on every rank); the resumed steps 3-4 bitwise the
    first life's; every kernel launched on every rank in both lives."""
    for label, life in (("first", first), ("second", second)):
        check([r["rank"] for r in life] == list(range(world)),
              f"the {label} life's ranks: {[r['rank'] for r in life]}")
        losses = [[st["loss"] for st in r["steps"]] for r in life]
        check(all(x == losses[0] for x in losses),
              f"the ranks' losses differ in the {label} life: {losses}")
        for r in life:
            for name, n in r["counts"].items():
                check(n > 0, f"kernel {name} never launched on rank "
                      f"{r['rank']} in the {label} life")
    staged = [r["stage"]["staged_bytes"] for r in first]
    check(nbytes <= sum(staged) <= nbytes + 64,
          f"the ranks staged {sum(staged)} bytes in all, not the state's "
          f"{nbytes}")
    for r, b in zip(first, staged):
        check(abs(b * world / nbytes - 1) <= FOUR_CARD_SHARE_TOL,
              f"rank {r['rank']} staged {b} bytes, not about 1/{world} of "
              f"{nbytes}")
    for r in first:
        compare_crcs(first[0]["crc"], r["crc"],
                     f"the state rank {r['rank']} staged against rank 0's")
    restored = [r["restore"]["step"] for r in second]
    check(restored == [2] * world, f"the ranks restored steps {restored}")
    for r in second:
        compare_crcs(first[0]["crc"], r["crc"],
                     f"rank {r['rank']}'s restore against the staged state")
    continued = [st["loss"] for st in first[0]["steps"]][2:4]
    resumed = [st["loss"] for st in second[0]["steps"]]
    check(resumed == continued, f"resumed steps 3-4 {resumed} are not "
          f"bitwise the first life's {continued}")


def _four_card_args(ckpt_dir):
    from dlrover_tpu_torch.run import llama_pretrain

    return llama_pretrain.parse_args([
        "--model", "8b", "--layers", "4", "--seq", str(DATA_SEQ),
        "--micro-batch", "1", "--global-batch", str(FOUR_CARD_GLOBAL_BATCH),
        "--steps", "4", "--device", "cuda", "--seed", "0", "--data",
        os.path.join(os.path.dirname(ckpt_dir), "corpus.bin"),
        "--data-dtype", "uint32", "--ckpt-dir", ckpt_dir,
        "--save-every", "0"])


def _four_card_life(torch, ckpt_dir):
    """One rank of the four-card leg, in the agent's environment (module
    docstring): ``run/llama_pretrain.py``'s build, checkpoint and data flow
    at dp4. First life: steps 1-2 with a memory save after each and the
    loader's sidecar at step 2, the CRC32 of every leaf of the staged
    state, a barrier, then steps 3-4 unsaved; rank FOUR_CARD_KILL_RANK then
    SIGKILLs itself and the others wait for the agent. Second life:
    restores step 2 and the loader, the CRC32s, steps 3-4 with a memory
    save after each. Under the device timer the first life reads its
    gradient all-reduces in steps FOUR_CARD_REDUCE_STEPS and every program
    after step 4. Each life prints one JSON result."""
    import torch.distributed as dist

    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.profiler import tpu_timer
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    t_start = time.time()
    _reset_counts(attention, fce, [0])
    ctx = bootstrap.init()
    rank = bootstrap.process_index()
    check(bootstrap.process_count() == FOUR_CARD_WORLD,
          f"a world of {bootstrap.process_count()}, not {FOUR_CARD_WORLD}")
    args = _four_card_args(ckpt_dir)
    device = (f"cuda:{ctx.local_rank}" if args.device == "cuda"
              else args.device)
    cfg, trainer, state, _, tokens = llama_pretrain.build(args, device)
    torch.cuda.synchronize()
    ckpt, start, restore = llama_pretrain.open_checkpoint(args, state, None)
    batches, positions, loader_restored = llama_pretrain.open_data(
        args, cfg, trainer, args.seq, device,
        None if restore is None else start)
    first = os.environ["DLROVER_TPU_RESTART_COUNT"] == "0"
    result = {"rank": rank, "start_t": t_start, "tokens_per_step": tokens,
              "restore": restore, "loader_restored": loader_restored}
    if first:
        check(restore is None, f"the first life restored {restore}")
    else:
        result["restored_t"] = time.time()
        check(restore is not None, "the second life restored nothing")
        result["crc"] = state_crcs(torch, state)
        result["crc_s"] = time.time() - result["restored_t"]
    steps = []
    timer_port = os.environ.get("DLROVER_TPU_TIMER_PORT")
    grads = len(flatten(state["params"]))
    result["grad_all_reduces"] = grads
    result["reduce_windows"] = []
    calls = {"n": 0, "step": 0}
    real_all_reduce = dist.all_reduce

    def all_reduce(tensor, *a, **kw):
        # a step's all-reduces: one token count a microbatch, one a
        # gradient leaf, the loss (trainer.py)
        calls["n"] += 1
        window = (first and timer_port
                  and calls["step"] in FOUR_CARD_REDUCE_STEPS)
        if window and calls["n"] == trainer.accum_steps + grads + 1:
            result["reduce_windows"][-1]["after"] = settled_all_reduces(
                torch, int(timer_port))
        out = real_all_reduce(tensor, *a, **kw)
        if window and calls["n"] == trainer.accum_steps:
            result["reduce_windows"].append({
                "step": calls["step"],
                "before": settled_all_reduces(torch, int(timer_port))})
        return out

    with mock.patch.object(dist, "all_reduce", all_reduce):
        for step in range(start, args.steps):
            t0 = time.perf_counter()
            batch = next(batches)
            wait = time.perf_counter() - t0
            loader_pos = positions.popleft()
            calls["n"], calls["step"] = 0, step + 1
            state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                             batch)
            if first and timer_port and step + 1 == 4:
                # every program the hook timed in the first life
                torch.cuda.synchronize()
                time.sleep(0.05)
                result["timer"] = tpu_timer.scrape_metrics(int(timer_port))
            begin, end = trainer.reduce_events
            steps.append({"step": step + 1, "loss": loss,
                          "seconds": seconds,
                          "reduce_ms": begin.elapsed_time(end),
                          "end_t": time.time()})
            print(f"rank {rank} step {step + 1} loss {loss:.6f} "
                  f"({seconds:.3f}s, all-reduce "
                  f"{steps[-1]['reduce_ms']:.2f} ms)", flush=True)
            ctx.add_input_wait(wait)
            ctx.report_step(step + 1, force=True,
                            digest=trainer.step_digest)
            if first and step >= 2:
                continue  # steps 3-4 continue from step 2 unsaved
            ckpt.save(step + 1, state)
            if first and step + 1 == 2:
                llama_pretrain.write_sidecar(
                    llama_pretrain.sidecar_path(ckpt_dir, rank), 2,
                    loader_pos)
                ckpt.wait_staging()
                result["stage"] = ckpt.stage_log[-1]
                result["crc"] = state_crcs(torch, state)
                dist.barrier()  # every rank has step 2 staged
    result["steps"] = steps
    result["counts"] = _launch_counts(attention, fce)
    if first:
        if rank == FOUR_CARD_KILL_RANK:
            result["kill_t"] = time.time()
        print("CKPT_CHILD_JSON " + json.dumps(result), flush=True)
        if rank == FOUR_CARD_KILL_RANK:
            os.kill(os.getpid(), signal.SIGKILL)
        time.sleep(FOUR_CARD_TIMEOUT_S)  # the agent stops this process
        return 1
    ckpt.close()
    print("CKPT_CHILD_JSON " + json.dumps(result), flush=True)
    return 0


def settled_all_reduces(torch, port):
    """This rank's ``nccl:AllReduce`` totals from its device timer once
    the card has drained and the hook's poller has ended every collective
    (its ``/pending`` lists no ``nccl:*`` program): ``count`` executions,
    ``us_sum`` their device µs."""
    from dlrover_tpu_torch.profiler import tpu_timer

    torch.cuda.synchronize()
    deadline = time.time() + 10
    while True:
        pending = json.loads(tpu_timer._http_get(port, "/pending"))["pending"]
        if not any(p["name"].startswith("nccl:") for p in pending):
            break
        check(time.time() < deadline, f"collectives still pending after "
              f"the card drained: {pending}")
        time.sleep(0.005)
    p = tpu_timer.scrape_metrics(port)["programs"]["nccl:AllReduce"]
    return {"count": p["execute_total"], "us_sum": p["execute_us_sum"]}


def _coll_hang_life(torch, ckpt_dir):
    """One rank of the four-card collective hang, under the device timer:
    the kill leg's configuration (``run/llama_pretrain.py``'s build,
    checkpoint and data flow at dp4), a save (the step before the stop's a
    storage save) and a step report every step, to COLL_HANG_STEPS. In its first life (no marker beside
    the checkpoint directory yet) rank COLL_HANG_RANK SIGSTOPs itself in
    step COLL_HANG_STOP_STEP, just before its last all-reduce of the step
    (the loss's), once its last save's stage is done: the other ranks'
    grads are reduced, their loss's
    all-reduce waits in NCCL for the stopped rank, and their hosts wait for
    the step's loss in ``timed_step``. Prints a ``life`` record, each step
    and a ``stop`` or ``end`` record as ``DATA_CHILD_JSON`` lines."""
    import torch.distributed as dist

    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    marker = os.path.join(os.path.dirname(ckpt_dir), "coll-stopped")
    first = not os.path.exists(marker)
    _data_emit("life", first=first, pid=os.getpid(), start_t=time.time())
    _reset_counts(attention, fce, [0])
    ctx = bootstrap.init()
    ctx.step_report_interval = HANG_REPORT_INTERVAL_S
    rank = bootstrap.process_index()
    args = _four_card_args(ckpt_dir)
    args.steps = COLL_HANG_STEPS
    # the second life persists nothing: the job's end would wait for it
    args.save_every = COLL_HANG_STOP_STEP - 1 if first else 0
    device = f"cuda:{ctx.local_rank}"
    cfg, trainer, state, _, tokens = llama_pretrain.build(args, device)
    torch.cuda.synchronize()
    ckpt, start, restore = llama_pretrain.open_checkpoint(args, state, None)
    batches, positions, _ = llama_pretrain.open_data(
        args, cfg, trainer, args.seq, device,
        None if restore is None else start)
    per_step = trainer.accum_steps + len(flatten(state["params"])) + 1
    calls = {"n": 0, "step": 0}
    real_all_reduce = dist.all_reduce

    def all_reduce(tensor, *a, **kw):
        calls["n"] += 1
        if (first and rank == COLL_HANG_RANK and calls["n"] == per_step
                and calls["step"] == COLL_HANG_STOP_STEP):
            # the last save's background stage holds the node's shm lock:
            # a rank stopped inside it would stall every other rank's
            # stage and the breakpoint persist
            ckpt.wait_staging()
            open(marker, "w").close()
            _data_emit("stop", rank=rank, step=calls["step"],
                       counts=_launch_counts(attention, fce),
                       stop_t=time.time())
            os.kill(os.getpid(), signal.SIGSTOP)
        return real_all_reduce(tensor, *a, **kw)

    _data_emit("restored", rank=rank, restore=restore, start=start)
    with mock.patch.object(dist, "all_reduce", all_reduce):
        for step in range(start, args.steps):
            batch = next(batches)
            positions.popleft()
            calls["n"], calls["step"] = 0, step + 1
            state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                             batch)
            _data_emit("step", rank=rank, step=step + 1, loss=loss,
                       seconds=seconds, end_t=time.time())
            ctx.report_step(step + 1, force=True,
                            digest=trainer.step_digest)
            ckpt.save(step + 1, state)
    ckpt.close()
    _data_emit("end", rank=rank, counts=_launch_counts(attention, fce),
               tokens_per_step=tokens)
    return 0


def _scale_args(ckpt_dir):
    from dlrover_tpu_torch.run import llama_pretrain

    return llama_pretrain.parse_args([
        "--model", "8b", "--layers", "4", "--seq", str(DATA_SEQ),
        "--micro-batch", "1", "--global-batch", str(FOUR_CARD_GLOBAL_BATCH),
        "--steps", str(SCALE_STEPS), "--device", "cuda", "--seed", "0",
        "--data", os.path.join(os.path.dirname(ckpt_dir), "corpus.bin"),
        "--data-dtype", "uint32", "--ckpt-dir", ckpt_dir,
        "--save-every", "0"])


def persisted_pieces(ckpt_dir, step, node=0, procs=SCALE_NODE_PROCS):
    """The pieces (``TensorMeta``) of ``step`` that node ``node``'s agent
    persisted from its ``procs`` processes' segments, from its local tier's
    manifests: together the whole state, each with the CRC32 of its bytes
    as staged."""
    from dlrover_tpu_torch.checkpoint.saver import local_tier_dir, step_dir
    from dlrover_tpu_torch.checkpoint.shm_handler import CheckpointMeta

    pieces = []
    for proc in range(procs):
        path = os.path.join(step_dir(local_tier_dir(ckpt_dir, node), step),
                            f"proc-{proc}", "meta.json")
        with open(path) as f:
            pieces += CheckpointMeta.from_json(f.read()).leaves
    return pieces


def piece_crcs(torch, state, pieces):
    """The CRC32 of the bytes each persisted piece covers in ``state``,
    under the piece's path: the piece's rows (``index``) of its leaf."""
    from dlrover_tpu_torch.checkpoint.shm_handler import as_bytes, flatten_state

    leaves = {leaf.name: leaf.value for leaf in flatten_state(state)}
    buf = None
    out = {}
    for m in pieces:
        value = leaves[m.path.rsplit("#", 1)[0]]
        if m.index and isinstance(value, torch.Tensor):
            value = value[tuple(slice(a, b) for a, b in m.index)]
        flat = as_bytes(value)
        if not flat.is_cuda:
            out[m.path] = zlib.crc32(memoryview(flat.numpy()))
            continue
        if buf is None:
            buf = torch.empty(CRC_CHUNK, dtype=torch.uint8, pin_memory=True)
        crc = 0
        for o in range(0, flat.numel(), CRC_CHUNK):
            n = min(CRC_CHUNK, flat.numel() - o)
            buf[:n].copy_(flat[o:o + n])
            crc = zlib.crc32(memoryview(buf[:n].numpy()), crc)
        out[m.path] = crc
    return out


def _scale_emit(kind, **fields):
    print("SCALE_CHILD_JSON " + json.dumps({"kind": kind, **fields}),
          flush=True)


def _scale_life(torch, ckpt_dir):
    """One rank of the scale-out leg, in its agent's environment (module
    docstring): ``run/llama_pretrain.py``'s build, checkpoint and data flow
    with the worker context, the runtime config polled at every step
    (``poll_every_steps`` 1), a step report with the digest, a memory save
    and the loader's sidecar after it. At dp2 it trains until its agent stops it;
    at dp4 it restores, takes the CRC32 of every persisted piece of the
    restored state, and trains SCALE_AFTER steps. Prints a ``life`` record,
    each step (its loss, seconds, the CRC32 of this rank's rows, the armed
    hint, the kernel launches so far) and an ``end`` record."""
    import numpy as np

    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    t_start = time.time()
    _reset_counts(attention, fce, [0])
    ctx = bootstrap.init()
    ctx.step_report_interval = 0.0
    rank, world = bootstrap.process_index(), bootstrap.process_count()
    args = _scale_args(ckpt_dir)
    device = f"cuda:{ctx.local_rank}"
    cfg, trainer, state, _, tokens = llama_pretrain.build(args, device, ctx)
    trainer.poll_every_steps = 1
    torch.cuda.synchronize()
    ckpt, start, restore = llama_pretrain.open_checkpoint(args, state, None)
    batches, positions, loader_restored = llama_pretrain.open_data(
        args, cfg, trainer, args.seq, device,
        None if restore is None else start)
    grown = world == SCALE_WORLD
    life = {"rank": rank, "world": world, "start": start,
            "start_t": t_start, "restore": restore,
            "loader_restored": loader_restored, "tokens_per_step": tokens}
    if grown:
        check(restore is not None, "the grown world restored nothing")
        life["restored_t"] = time.time()
        life["pieces"] = piece_crcs(torch, state,
                                    persisted_pieces(ckpt_dir, start))
        life["crc_s"] = time.time() - life["restored_t"]
    _scale_emit("life", **life)
    end = start + SCALE_AFTER if grown else args.steps
    for step in range(start, end):
        batch = next(batches)
        loader_pos = positions.popleft()
        crc = zlib.crc32(batch.cpu().numpy().astype(np.int64).tobytes())
        state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                         batch)
        ctx.report_step(step + 1, force=True, digest=trainer.step_digest)
        hint = trainer.speculation_hint
        begin, done = trainer.reduce_events
        # before the save: every step that can be staged is on record
        _scale_emit("step", step=step + 1, loss=loss, seconds=seconds,
                    reduce_ms=begin.elapsed_time(done), end_t=time.time(),
                    crc=crc, hint=hint.spec if hint is not None else "",
                    counts=_launch_counts(attention, fce))
        ckpt.save(step + 1, state)
        llama_pretrain.write_sidecar(
            llama_pretrain.sidecar_path(ckpt_dir, rank), step + 1,
            loader_pos)
    ckpt.close()
    _scale_emit("end", counts=_launch_counts(attention, fce))
    return 0


def scale_rows_crc(tokens, step, rank, world, global_batch=FOUR_CARD_GLOBAL_BATCH,
                   micro=1):
    """The CRC32 of the rows rank ``rank`` of a dp ``world`` must train at
    ``step`` (1-based): the loader's global batch of that step in the
    sampler's order from the epoch's start (``loader_rows``), shaped
    (accum, micro x world, seq), this rank's micro rows of each
    microbatch, as int64."""
    import numpy as np

    rows = loader_rows(tokens, step, global_batch)[step - 1]
    accum = global_batch // (micro * world)
    mine = rows.reshape(accum, micro * world, -1)[
        :, rank * micro:(rank + 1) * micro]
    return zlib.crc32(np.ascontiguousarray(mine).astype(np.int64).tobytes())


def check_scale_out(firsts, seconds, ledger, executed, join_t, seen_t,
                    pieces, expected_crc):
    """The scale-out leg's checks. ``firsts``: node 0's ranks' dp2 lives;
    ``seconds``: the four dp4 lives (by rank); each ``{"life", "steps",
    "end"}``. ``ledger``, ``executed``: the planner's last document's;
    ``join_t``: node 1's start; ``seen_t``: when node 0's agent saw the
    waiter; ``pieces``: ``{path: crc32}`` of the persisted step's
    manifests; ``expected_crc(step, rank, world)``: the CRC32 of the rows a
    rank must train. Fails unless: the ledger holds HOLDs up to the
    hysteresis streak and then exactly one RESIZE, to 2 nodes, executed
    once; node 0's ranks trained at dp2 only, at least two steps after
    node 1 started and before their agent saw the waiter, and armed the
    hint ``dp4`` before their life ended; the re-formed round has ranks
    0-3 at dp4, each started after the execution and restored one step,
    the same, every persisted piece's CRC32 equal on every rank to its
    manifest's; every step of every life trained its rows of the loader's
    order, so the committed trajectory (dp2 steps up to the restored one,
    then dp4) trains every record once; the dp4 ranks' losses are equal
    and its first step's is the dp2 life's same step within
    SCALE_LOSS_RTOL; every kernel launched on every rank in both lives.
    Returns the restored step."""
    verdicts = [d["verdict"] for d in ledger]
    check(verdicts.count("resize") == 1,
          f"the planner decided {verdicts.count('resize')} RESIZEs: "
          f"{[(d['verdict'], d['reason']) for d in ledger]}")
    i = verdicts.index("resize")
    resize = ledger[i]
    check(resize["target"] == "dp2" and resize["target_world"] == 2
          and resize["current_world"] == 1,
          f"the RESIZE was {resize['current_world']} -> {resize['target']}")
    check(i >= 1 and ledger[i - 1]["reason"]
          == f"hysteresis:{SCALE_HYSTERESIS - 1}/{SCALE_HYSTERESIS}"
          and all(v == "hold" for v in verdicts[:i]),
          f"the decisions before the RESIZE: "
          f"{[(d['verdict'], d['reason']) for d in ledger[:i]]}")
    check([e["target_world"] for e in executed] == [2],
          f"the executed plans: {executed}")
    exec_ts = executed[0]["ts"]
    check(len(firsts) == SCALE_NODE_PROCS and len(seconds) == SCALE_WORLD,
          f"{len(firsts)} dp2 lives and {len(seconds)} dp4 lives")
    for x in firsts:
        rank = x["life"]["rank"]
        steps = x["steps"]
        check(x["life"]["world"] == SCALE_NODE_PROCS
              and x["life"]["start"] == 0 and x["life"]["restore"] is None,
              f"node 0's rank {rank} first life: {x['life']}")
        waited = [st for st in steps if join_t < st["end_t"] < seen_t]
        check(len(waited) >= 2, f"rank {rank} reported {len(waited)} steps "
              "between node 1's start and its agent seeing the waiter")
        check(steps and steps[-1]["hint"] == f"dp{SCALE_WORLD}"
              and all(st["hint"] == "" for st in steps
                      if st["end_t"] < exec_ts),
              f"rank {rank}'s hints: {[(st['step'], st['hint']) for st in steps[-4:]]}")
    check(sorted(x["life"]["rank"] for x in seconds)
          == list(range(SCALE_WORLD))
          and all(x["life"]["world"] == SCALE_WORLD
                  and x["life"]["start_t"] > exec_ts for x in seconds),
          f"the re-formed round: {[x['life']['rank'] for x in seconds]}")
    starts = {x["life"]["start"] for x in seconds}
    check(len(starts) == 1, f"the dp4 ranks restored steps {starts}")
    start = starts.pop()
    check(0 < start <= min(x["steps"][-1]["step"] for x in firsts),
          f"the dp4 ranks restored step {start}")
    check((start + SCALE_AFTER) * FOUR_CARD_GLOBAL_BATCH <= SCALE_RECORDS,
          f"steps 1-{start + SCALE_AFTER} run past one epoch of "
          f"{SCALE_RECORDS} records")
    for x in seconds:
        compare_crcs(pieces, x["life"]["pieces"],
                     f"rank {x['life']['rank']}'s restored pieces against "
                     "the persisted manifests")
        check([st["step"] for st in x["steps"]] == list(
            range(start + 1, start + 1 + SCALE_AFTER)),
            f"rank {x['life']['rank']}'s dp4 steps "
            f"{[st['step'] for st in x['steps']]}")
    for x in firsts + seconds:
        rank, world = x["life"]["rank"], x["life"]["world"]
        for st in x["steps"]:
            check(st["crc"] == expected_crc(st["step"], rank, world),
                  f"rank {rank} at dp{world} trained other rows at step "
                  f"{st['step']} than the loader's order gives")
    losses = [[st["loss"] for st in x["steps"]] for x in seconds]
    check(all(x == losses[0] for x in losses),
          f"the dp4 ranks' losses differ: {losses}")
    dp2 = {st["step"]: st["loss"] for st in firsts[0]["steps"]}
    check(start + 1 in dp2, f"the dp2 life never trained step {start + 1}")
    check(abs(losses[0][0] - dp2[start + 1])
          <= SCALE_LOSS_RTOL * abs(dp2[start + 1]),
          f"the dp4 life's step {start + 1} loss {losses[0][0]!r} is not "
          f"within {SCALE_LOSS_RTOL} of the dp2 life's {dp2[start + 1]!r}")
    for label, lives, key in (("dp2", firsts, None), ("dp4", seconds, "end")):
        for x in lives:
            counts = (x[key] or {}).get("counts") if key else \
                x["steps"][-1]["counts"]
            check(counts and all(n > 0 for n in counts.values()),
                  f"a kernel never launched on rank {x['life']['rank']} in "
                  f"the {label} life: {counts}")
    return start


def _scale_lives(job, node, pid):
    """The ``SCALE_CHILD_JSON`` records of process ``pid`` of node
    ``node``, split into lives at each ``life`` record."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir

    path = os.path.join(agent_log_dir(job, node),
                        f"worker-{pid}-restart0.log")
    check(os.path.exists(path), f"no log of node {node}'s process {pid}")
    lives = []
    with open(path, errors="replace") as f:
        for line in f:
            if not line.startswith("SCALE_CHILD_JSON "):
                continue
            rec = json.loads(line.split(" ", 1)[1])
            if rec["kind"] == "life":
                lives.append({"life": rec, "steps": [], "end": None})
            elif lives and rec["kind"] == "step":
                lives[-1]["steps"].append(rec)
            elif lives:
                lives[-1]["end"] = rec
    return lives


def _scale_out_leg(torch):
    """The four-card leg's planner-directed scale-out (module docstring):
    node 0 at dp2, node 1 joins, the planner's RESIZE, dp4."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.agent.paral_config_tuner import (
        default_config_path)
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.utils.net import find_free_port

    t_leg = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_scale_")
    job = f"chip_smoke_scale_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    ckpt_dir = os.path.join(workdir, "ck")
    state_dir = os.path.join(workdir, "state")
    repo = os.path.dirname(os.path.abspath(__file__))
    port = find_free_port()
    base = dict(os.environ, PYTHONPATH=repo + os.pathsep
                + os.environ.get("PYTHONPATH", ""))
    menv, mport = metrics_env(dict(
        base, DLROVER_TPU_JOB_NAME=job, DLROVER_TPU_STATE_BACKEND="file",
        DLROVER_TPU_STATE_DIR=state_dir,
        DLROVER_TPU_PLANNER_INTERVAL_S=str(SCALE_PLANNER_INTERVAL_S),
        DLROVER_TPU_PLANNER_HYSTERESIS=str(SCALE_HYSTERESIS),
        DLROVER_TPU_PLANNER_HBM_GB=str(SCALE_HBM_GB)))
    spec = {"port": port, "node_num": 2, "min_node_num": 1}
    master = None
    clis = {}
    try:
        tokens = write_corpus(os.path.join(workdir, "corpus.bin"),
                              records=SCALE_RECORDS)
        mlog = os.path.join(workdir, "master.log")
        master = start_master_child(spec, menv, mlog, "scale-out")
        print(f"  [scale] master on port {port}: node_num 2, min_node_num "
              f"1, planner every {SCALE_PLANNER_INTERVAL_S} s, hysteresis "
              f"{SCALE_HYSTERESIS}, memory gate {SCALE_HBM_GB} GB",
              flush=True)

        def run_node(node):
            env = dict(base, CUDA_VISIBLE_DEVICES=",".join(
                str(node * SCALE_NODE_PROCS + i)
                for i in range(SCALE_NODE_PROCS)))
            cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
                   f"--master_addr=127.0.0.1:{port}", "--nnodes=1:2",
                   f"--nproc_per_node={SCALE_NODE_PROCS}",
                   f"--node_id={node}", f"--job_name={job}",
                   "--max_restarts=0", os.path.abspath(__file__), "--",
                   "--ckpt-child", "scale", ckpt_dir]
            print(f"  [scale node {node}] CUDA_VISIBLE_DEVICES="
                  f"{env['CUDA_VISIBLE_DEVICES']} {' '.join(cmd[1:])}",
                  flush=True)
            clis[node] = _run_cli(cmd, env, f"scale node {node}",
                                  SCALE_TIMEOUT_S)

        with MetricsPoller(mport) as metrics, \
                planner_doc_poller(state_dir, job) as docs:
            threads = [threading.Thread(target=run_node, args=(0,),
                                        daemon=True)]
            threads[0].start()
            log0 = os.path.join(agent_log_dir(job, 0),
                                "worker-0-restart0.log")
            deadline = time.time() + SCALE_TIMEOUT_S
            while True:
                text = open(log0).read() if os.path.exists(log0) else ""
                if text.count('"kind": "step"') >= SCALE_JOIN_AFTER:
                    break
                check(threads[0].is_alive() and time.time() < deadline,
                      f"node 0 never trained {SCALE_JOIN_AFTER} steps: "
                      f"{text[-2000:]}")
                time.sleep(0.05)
            join_t = time.time()
            threads.append(threading.Thread(target=run_node, args=(1,),
                                            daemon=True))
            threads[1].start()
            for t in threads:
                t.join(timeout=SCALE_TIMEOUT_S)
            check(not any(t.is_alive() for t in threads),
                  "a scale-out CLI did not end")
            master.wait(timeout=120)
        with open(mlog) as f:
            mlines = [x.rstrip() for x in f]
        for line in mlines:
            print(f"  [scale master] {line}", flush=True)
        check_no_actions(mlines, "scale-out leg")
        for node in (0, 1):
            check(clis[node][0].returncode == 0,
                  f"node {node}'s CLI exited {clis[node][0].returncode}")
        check(master.returncode == 0 and any(
            "local master exiting: succeeded" in x for x in mlines),
            f"the scale-out master's exit {master.returncode}")
        check(not any("planner sweep failed" in x for x in mlines),
              "the master's planner sweep raised")
        doc = docs.value
        check(doc is not None, "the master wrote no planner document")
        firsts, seconds = [], []
        for pid in range(SCALE_WORLD):
            lives = _scale_lives(job, pid // SCALE_NODE_PROCS, pid)
            want = 2 if pid < SCALE_NODE_PROCS else 1
            check(len(lives) == want, f"process {pid} lived {len(lives)} "
                  f"lives, not {want}")
            if pid < SCALE_NODE_PROCS:
                firsts.append(lives[0])
            seconds.append(lives[-1])
        lines0 = clis[0][1]
        seen_t = _agent_stamp(lines0, "node 0: membership changed",
                              r"seen at ([0-9.]+)")
        pieces_meta = None
        start = None
        restored = {x["life"]["start"] for x in seconds}
        check(len(restored) == 1, f"the dp4 ranks restored {restored}")
        start = restored.pop()
        pieces_meta = persisted_pieces(ckpt_dir, start)
        pieces = {m.path: m.crc32 for m in pieces_meta}
        start = check_scale_out(
            firsts, seconds, doc["ledger"], doc["executed"], join_t, seen_t,
            pieces, lambda step, rank, world: scale_rows_crc(
                tokens, step, rank, world))
        _print_scale_out(firsts, seconds, doc, mlines, lines0, join_t,
                         seen_t, start, len(pieces), metrics.last)
    finally:
        if master is not None and master.poll() is None:
            master.kill()
            master.wait()
        for node in (0, 1):
            for pid in range(SCALE_WORLD):
                _unlink_node_segment(job, node, pid)
            shutil.rmtree(os.path.dirname(agent_log_dir(job, node)),
                          ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_config_path(job, 0))), ignore_errors=True)
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"  scale-out leg: {time.perf_counter() - t_leg:.1f}s", flush=True)


def _unlink_node_segment(job, node, pid):
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler, shm_name)

    h = SharedMemoryHandler(shm_name(job, node, pid))
    if h.attach():
        h.close(unlink=True)


def _print_scale_out(firsts, seconds, doc, mlines, lines0, join_t, seen_t,
                     start, n_pieces, gauges):
    """The scale-out leg's numbers: global tokens/s at dp2 and dp4, the
    planner's predicted dp4 step against the measured one, the time from
    node 1's join to the decision and from the decision to the first dp4
    step's end by phase, and the downtime the ledger billed."""
    tokens = firsts[0]["life"]["tokens_per_step"]

    def walls(lives):
        n = min(len(x["steps"]) for x in lives)
        return [max(x["steps"][i]["seconds"] for x in lives)
                for i in range(1, n)]

    def rate(lives, last):
        """Global tokens/s of the steps after a life's first up to
        ``last``: their tokens over the wall from the first step's end to
        step ``last``'s end (the slowest rank's), with every save, sidecar
        and report between them. Returns it and the steps counted."""
        first = lives[0]["steps"][0]["step"]
        t0 = max(x["steps"][0]["end_t"] for x in lives)
        t1 = max(st["end_t"] for x in lives for st in x["steps"]
                 if st["step"] == last)
        return tokens * (last - first) / (t1 - t0), last - first

    dp2, dp4 = walls(firsts), walls(seconds)
    # the dp2 life's committed steps end at the restored one
    rate2, n2 = rate(firsts, start)
    rate4, n4 = rate(seconds, start + SCALE_AFTER)
    ledger = doc["ledger"]
    resize = next(d for d in ledger if d["verdict"] == "resize")
    pred = next(sc["t_pred_s"] for sc in resize["scores"]
                if sc["world"] == 2)
    saw = next(d for d in ledger
               if d["inputs"]["waiting"] >= 1 and d["inputs"]["world"] >= 1)
    exec_ts = doc["executed"][0]["ts"]
    persist_s = _agent_stamp(lines0, "node 0: breakpoint persist True",
                             r"in ([0-9.]+)s")
    stopped_t = _agent_stamp(lines0, "node 0: workers stopped at",
                             r"stopped at ([0-9.]+)")
    rdzv_s = _agent_stamp(lines0, "node 0: rendezvous round 2 in",
                          r"in ([0-9.]+)s")
    starts = [float(m.group(1)) for m in (
        re.search(r" at ([0-9.]+) log=", x) for x in lines0
        if "started worker" in x) if m]
    restart_t = min(starts[SCALE_NODE_PROCS:])
    restored_t = max(x["life"]["restored_t"] for x in seconds)
    crc_s = max(x["life"]["crc_s"] for x in seconds)
    step1_t = max(x["steps"][0]["end_t"] for x in seconds)
    phases = {
        "decision_to_agent_seen_s": seen_t - exec_ts,
        "breakpoint_persist_s": persist_s,
        "persist_end_to_workers_stopped_s": stopped_t - seen_t - persist_s,
        "rendezvous_s": rdzv_s,
        "restart_to_restored_s": restored_t - restart_t,
        "piece_crc_s": crc_s,
        "restored_to_first_dp4_step_end_s": step1_t - restored_t - crc_s,
    }
    reading = master_reading(mlines)
    brackets = reading["brackets"]
    later = [d for d in ledger if d["ts"] > step1_t]
    costs = [d["inputs"]["resize_cost_s"] for d in later]
    dp4_p50 = [d["inputs"]["step_p50_s"] for d in later]
    print(f"  [scale] decisions: {[(d['verdict'], d['reason']) for d in ledger]}",
          flush=True)
    print(f"  [scale] restored step {start} on every dp4 rank (tiers "
          f"{[x['life']['restore']['tier'] for x in seconds]}, "
          f"{[round(x['life']['restore']['seconds'], 3) for x in seconds]} s);"
          f" {n_pieces} persisted pieces' CRC32s equal on every rank; the "
          f"loader's order trained (every record once on the committed "
          f"steps 1-{start + SCALE_AFTER}); dp4 step {start + 1} loss "
          f"{seconds[0]['steps'][0]['loss']!r} against dp2's "
          f"{ {st['step']: st['loss'] for st in firsts[0]['steps']}[start + 1]!r}",
          flush=True)
    print(f"  [scale] global tokens/s, every token over the wall: dp2 "
          f"{rate2:.1f} (steps 2-{start}, {n2} steps), dp4 {rate4:.1f} "
          f"(steps {start + 2}-{start + SCALE_AFTER}, {n4} steps); the "
          f"median step wall (the slowest rank's): dp2 "
          f"{statistics.median(dp2):.4f} s over {len(dp2)} steps "
          f"({tokens / statistics.median(dp2):.1f} tokens/s at the median), "
          f"dp4 {statistics.median(dp4):.4f} s over {len(dp4)} steps "
          f"({tokens / statistics.median(dp4):.1f}); the planner's predicted dp4 step {pred:.4f} s (from "
          f"its observed dp2 step p50 {resize['inputs']['step_p50_s']:.4f} "
          f"s) against the measured {statistics.median(dp4):.4f} s (the "
          f"digest's device step p50 the later decisions observed: "
          f"{dp4_p50})", flush=True)
    print(f"  [scale] node 1 started at {join_t:.3f}; the first decision "
          f"that saw it waiting {saw['ts'] - join_t:.3f} s later "
          f"({saw['reason']}); the RESIZE {resize['ts'] - join_t:.3f} s "
          f"after the start, executed at {exec_ts - join_t:.3f} s; from "
          f"the decision to the first dp4 step's end "
          f"{step1_t - exec_ts:.3f} s, by phase {json.dumps(phases)}",
          flush=True)
    print(f"  [scale] the ledger billed {len(brackets)} bracket(s) "
          f"{brackets} ({[round(b - a, 3) for a, b in brackets]} s), "
          f"downtime {reading['downtime_s']} s, goodput "
          f"{reading['goodput']}; decisions after the first dp4 step read "
          f"resize_cost_s {costs} (avg_downtime); /metrics at the end: "
          f"{ {k: v for k, v in gauges.items() if 'planner' in k} }",
          flush=True)


def check_nccl_programs(life):
    """The kill leg's first life under the device timer: every rank timed
    ``nccl:*`` programs by step 4, and its gradient all-reduces in each
    step of FOUR_CARD_REDUCE_STEPS hold to the trainer's
    ``reduce_events`` (``check_reduce_window``). Returns one reading a
    rank."""
    out = []
    for r in life:
        programs = r.get("timer", {}).get("programs", {})
        nccl = {name: {"count": int(p["execute_total"]),
                       "bytes": p.get("program_bytes", 0.0),
                       "us_sum": p["execute_us_sum"]}
                for name, p in programs.items() if name.startswith("nccl:")}
        check("nccl:AllReduce" in nccl, f"rank {r['rank']} timed no "
              f"nccl:AllReduce: {sorted(programs)}")
        windows = {w["step"]: w for w in r["reduce_windows"]}
        check(sorted(windows) == list(FOUR_CARD_REDUCE_STEPS)
              and all("after" in w for w in windows.values()),
              f"rank {r['rank']} read its gradient all-reduces in steps "
              f"{sorted(windows)}")
        spans = {st["step"]: st["reduce_ms"] for st in r["steps"]}
        out.append({"rank": r["rank"], "programs": nccl, "windows": [
            (step,) + check_reduce_window(windows[step],
                                          r["grad_all_reduces"],
                                          spans[step])
            for step in FOUR_CARD_REDUCE_STEPS]})
    return out


def check_reduce_window(window, grads, span_ms):
    """One step's gradient all-reduces as the device timer saw them
    between its reads before and after them (``window``, each read
    ``settled_all_reduces``), against the span the trainer's
    ``reduce_events`` bracket around them: exactly ``grads`` executions,
    their device time within FOUR_CARD_REDUCE_BOUNDS of the span. Returns
    (executions, the timer's ms, the span's ms)."""
    a, b = window["before"], window["after"]
    n = int(b["count"] - a["count"])
    check(n == grads, f"the timer ended {n} all-reduces between its reads "
          f"in step {window['step']}, the trainer made {grads}")
    ms = (b["us_sum"] - a["us_sum"]) / 1e3
    lo, hi = FOUR_CARD_REDUCE_BOUNDS
    check(span_ms > 0 and lo * span_ms <= ms <= hi * span_ms,
          f"the timer's {ms:.3f} ms of gradient all-reduces in step "
          f"{window['step']} is not within [{lo}, {hi}] x the trainer's "
          f"reduce_events {span_ms:.3f} ms")
    return n, ms, span_ms


def print_nccl_programs(life):
    for x in check_nccl_programs(life):
        windows = "; ".join(
            f"step {step}: {n} gradient all-reduces, {ms:.3f} ms against "
            f"reduce_events {span:.3f} ms ({ms / span:.4f})"
            for step, n, ms, span in x["windows"])
        print(f"  [four timer] rank {x['rank']}: {json.dumps(x['programs'])};"
              f" {windows}", flush=True)


def _coll_hang_leg(torch):
    """The four-card collective hang (module docstring): rank 3 stopped in
    NCCL dp4, the others' timers flag the pending all-reduce, the chain
    dumps, names the wait, restarts all four ranks, and they resume."""
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.utils.net import find_free_port

    t_leg = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_coll_")
    job = f"chip_smoke_coll_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    ckpt_dir = os.path.join(workdir, "ck")
    repo = os.path.dirname(os.path.abspath(__file__))
    port = find_free_port()
    base = dict(os.environ, PYTHONPATH=repo + os.pathsep
                + os.environ.get("PYTHONPATH", ""), DLROVER_TPU_JOB_NAME=job)
    mlog = os.path.join(workdir, "master.log")
    master = None
    try:
        write_corpus(os.path.join(workdir, "corpus.bin"),
                     records=FOUR_CARD_RECORDS)
        master = start_master_child(diag_master_spec(port, 1), dict(
            base, DLROVER_TPU_HANG_WATCHDOG_WINDOW_S=str(
                DIAG_WATCHDOG_WINDOW_S)), mlog, "collective-hang")
        env = dict(diag_env(base), DLROVER_TPU_DIST_INIT_TIMEOUT=str(
            COLL_DIST_TIMEOUT_S))
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
               f"--master_addr=127.0.0.1:{port}", "--nnodes=1",
               f"--nproc_per_node={FOUR_CARD_WORLD}", "--max_restarts=1",
               "--tpu-timer",
               f"--tpu-timer-port={free_port_block(FOUR_CARD_WORLD)}",
               f"--job_name={job}", os.path.abspath(__file__), "--",
               "--ckpt-child", "collhang", ckpt_dir]
        print(f"  [coll] master on port {port} (chain every "
              f"{DIAG_MASTER_INTERVAL_S} s, silence {DIAG_SILENCE_S} s, "
              f"watchdog window {DIAG_WATCHDOG_WINDOW_S} s); agent interval "
              f"{DIAG_AGENT_INTERVAL_S} s, timer hang {DIAG_TIMER_HANG_S} s,"
              f" process-group timeout {COLL_DIST_TIMEOUT_S} s; "
              f"{' '.join(cmd[1:])}", flush=True)
        proc, lines = _run_cli(cmd, env, "coll", FOUR_CARD_TIMEOUT_S)
        master.wait(timeout=120)
        with open(mlog) as f:
            mlines = [x.rstrip() for x in f]
        for line in mlines:
            if not line.startswith("DIAG_RECORDS "):
                print(f"  [coll master] {line}", flush=True)
        lives = [_hang_lives(job, "collective-hang", rank)
                 for rank in range(FOUR_CARD_WORLD)]
        for rank, (one, two) in enumerate(lives):
            for label, life in (("first", one), ("second", two)):
                for rec in life["records"]:
                    print(f"  [coll rank {rank} {label} life] "
                          f"{json.dumps(rec)}", flush=True)
        check(proc.returncode == 0 and master.returncode == 0,
              f"the collective-hang CLI exited {proc.returncode}, its "
              f"master {master.returncode}")
        result = check_coll_hang(lives, mlines, lines)
        stop = lives[COLL_HANG_RANK][0]["stop"]
        stamps, phases = diag_phases(mlines, lines, stop["stop_t"],
                                     "rank_stopped")
        step_t = max(two["steps"][0]["end_t"] for _, two in lives)
        phases["new_workers_started_to_step_end_s"] = (
            step_t - stamps["new_workers_started"])
        print(f"  [coll] every action the master enqueued: "
              f"{json.dumps(enqueued_actions(mlines))}", flush=True)
        print(f"  [coll] {result}; the stop to the slowest rank's resumed "
              f"step end {step_t - stop['stop_t']:.3f} s; by phase "
              f"{json.dumps(phases)}", flush=True)
    finally:
        if master is not None and master.poll() is None:
            master.kill()
            master.wait()
        for pid in range(FOUR_CARD_WORLD):
            unlink_segment(job, pid)
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    print(f"  collective-hang leg: {time.perf_counter() - t_leg:.1f}s",
          flush=True)


def check_coll_hang(lives, mlines, lines):
    """The collective hang's checks: one hang confirmed; a dump request and
    then one restart (``check_action_sequence``) whose ``stuck_at`` is the
    running ranks' wait for their step in ``timed_step`` and whose pending
    programs hold ``nccl:AllReduce`` (the collective the stopped rank never
    joined); a hang dump holding the running ranks' stacks; the agent
    started eight workers; every rank's second life restored one step, the
    same on every rank, and trained every step after it, the ranks' losses
    equal; every kernel launched on every rank in the second life."""
    confirmed = [x for x in mlines if "hang confirmed" in x]
    check(len(confirmed) == 1, f"{len(confirmed)} hangs confirmed")
    stuck_at = check_action_sequence(enqueued_actions(mlines), [0])
    records = hang_dump_records(mlines)
    running = {one["life"]["pid"] for rank, (one, _) in enumerate(lives)
               if rank != COLL_HANG_RANK}
    for pid in running:
        check(any(str(pid) in r["stacks"] and "timed_step" in r["stacks"][
            str(pid)] for r in records), f"no hang dump holds the stack of "
              f"running rank pid {pid}")
    hot = dumped_hot_path(records, running)
    check_stuck_at(stuck_at, hot, r"timed_step \(llama_pretrain\.py:\d+\)$",
                   r"_coll_hang_life \(chip_smoke\.py:\d+\)$")
    restart = [x for x in mlines if RESTART_ALL.search(x)]
    pending = [PENDING.search(x) for x in restart]
    check(len(restart) == 1 and pending[0] and "nccl:AllReduce" in
          pending[0].group(1).split(","), f"the restart's pending "
          f"programs: {restart}")
    starts = [x for x in lines if "started worker" in x]
    check(len(starts) == 2 * FOUR_CARD_WORLD,
          f"the agent started {len(starts)} workers")
    stop = lives[COLL_HANG_RANK][0]["stop"]
    check(stop is not None and stop["step"] == COLL_HANG_STOP_STEP,
          f"rank {COLL_HANG_RANK}'s stop: {stop}")
    restored = {two["restored"]["restore"]["step"]
                for _, two in lives if two["restored"]["restore"]}
    check(len(restored) == 1 and all(
        two["restored"]["restore"] for _, two in lives),
        f"the ranks restored steps {restored}")
    step = restored.pop()
    losses = [[st["loss"] for st in two["steps"]] for _, two in lives]
    check(all(len(x) == COLL_HANG_STEPS - step for x in losses)
          and all(x == losses[0] for x in losses),
          f"the resumed ranks' losses from step {step + 1}: {losses}")
    for rank, (_, two) in enumerate(lives):
        check(two["end"] is not None, f"rank {rank}'s second life did not "
              "end")
        for name, n in two["end"]["counts"].items():
            check(n > 0, f"kernel {name} never launched on rank {rank} "
                  "after the restart")
    tiers = [two["restored"]["restore"]["tier"] for _, two in lives]
    return (f"one hang confirmed; stuck_at {stuck_at!r} (the dumped path "
            f"{hot}); pending {pending[0].group(1)!r}; every rank "
            f"restored step {step} (tiers {tiers}) and trained steps "
            f"{step + 1}-{COLL_HANG_STEPS}, the ranks' losses equal")


# -- the four-card zero-1 leg ---------------------------------------------------


def _zero1_args(workdir, zero1_on, steps=ZERO1_STEPS):
    """``run/llama_pretrain.py``'s options for the zero-1 leg: the kill
    leg's widths, batch and corpus, no lr warmup; ``--zero1`` and the
    checkpoint directory when ``zero1_on`` (every ZERO1_STEPS-th save
    persisted)."""
    from dlrover_tpu_torch.run import llama_pretrain

    extra = (["--zero1", "--ckpt-dir", os.path.join(workdir, "ck"),
              "--save-every", str(ZERO1_STEPS)] if zero1_on else [])
    return llama_pretrain.parse_args([
        "--model", "8b", "--layers", "4", "--seq", str(DATA_SEQ),
        "--micro-batch", "1", "--global-batch", str(FOUR_CARD_GLOBAL_BATCH),
        "--steps", str(steps), "--warmup-steps", "0", "--device", "cuda",
        "--seed", "0", "--data", os.path.join(workdir, "corpus.bin"),
        "--data-dtype", "uint32", *extra])


def zero1_region(tensor, path_dim, rank, world):
    """This rank's zero-1 region of a whole leaf at dp ``world`` (the
    partition rule's dim), as a view; the leaf itself when it does not
    shard."""
    if path_dim is None:
        return tensor
    k = tensor.shape[path_dim] // world
    return tensor.narrow(path_dim, rank * k, k)


def moment_sample(torch, state, world):
    """Each moment leaf's values at fixed indices of this rank's zero-1
    region at dp ``world`` (a DTensor's local shard under zero-1, else the
    region of the whole leaf), ``{name: (values, the whole leaf's largest
    magnitude or None)}``; the indices evenly spaced, at most
    ZERO1_SAMPLE_PER_LEAF a leaf."""
    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.train import bootstrap, zero1

    rank = bootstrap.process_index()
    out = {}
    for key in ("mu", "nu"):
        for path, m in flatten(state["opt"][key]):
            if hasattr(m, "to_local"):
                local, peak = m.to_local(), None
            else:
                dim = zero1.scatter_dim((), tuple(m.shape), {"dp": world})
                local = zero1_region(m, dim, rank, world)
                peak = float(m.abs().max())
            flat = local.reshape(-1)
            n = min(flat.numel(), ZERO1_SAMPLE_PER_LEAF)
            # integer spacing: a float linspace over 1e8 elements rounds
            # past the last index
            idx = (torch.arange(n, dtype=torch.int64, device=flat.device)
                   * (flat.numel() - 1)) // max(n - 1, 1)
            out[f"{key}/{path}"] = (flat[idx].float().cpu().numpy(), peak)
    return out


def compare_sample(ref, got, rtol=ZERO1_MOMENT_RTOL,
                   atol_frac=ZERO1_MOMENT_ATOL):
    """The zero-1 run's moment sample ``got`` against the replicated run's
    ``ref`` (``moment_sample``'s), leaf by leaf: ``{"elements", "leaves",
    "worst"}``, ``worst`` the largest ``|got - ref| / (atol + rtol |ref|)``
    with ``atol`` = ``atol_frac`` times the leaf's largest magnitude (at
    most 1 passes)."""
    import numpy as np

    check(sorted(got) == sorted(ref),
          f"sampled leaves differ: {sorted(set(ref) ^ set(got))[:3]}")
    worst, elements = 0.0, 0
    for name, (want, peak) in ref.items():
        have = got[name][0]
        check(have.shape == want.shape,
              f"{name}: sample of {have.shape}, not {want.shape}")
        tol = atol_frac * peak + rtol * np.abs(want)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(tol > 0, np.abs(have - want) / tol,
                             np.where(have == want, 0.0, np.inf))
        worst = max(worst, float(ratio.max(initial=0.0)))
        elements += int(want.size)
    return {"elements": elements, "leaves": len(ref), "worst": worst}


def param_sample(torch, params, world):
    """Each param leaf's values at fixed indices of the whole leaf, spread
    over all its zero-1 quarters at dp ``world``: ``{name: (values as
    float64, the quarter of each index, -1 for a leaf that does not
    shard)}``; the indices evenly spaced, at most ZERO1_SAMPLE_PER_LEAF a
    leaf."""
    import numpy as np

    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.train import zero1

    out = {}
    for path, p in flatten(params):
        flat = p.detach().reshape(-1)
        n = min(flat.numel(), ZERO1_SAMPLE_PER_LEAF)
        idx = (torch.arange(n, dtype=torch.int64, device=flat.device)
               * (flat.numel() - 1)) // max(n - 1, 1)
        values = flat[idx].double().cpu().numpy()
        dim = zero1.scatter_dim((), tuple(p.shape), {"dp": world})
        if dim is None:
            quarters = np.full(n, -1)
        else:
            stride = math.prod(p.shape[dim + 1:])
            quarters = ((idx.cpu().numpy() // stride) % p.shape[dim]
                        // (p.shape[dim] // world))
        out[f"params/{path}"] = (values, quarters)
    return out


def compare_delta(ref_init, ref_final, init, final,
                  atol_frac=ZERO1_DELTA_ATOL):
    """The zero-1 run's change of the sampled params from ``init`` to
    ``final`` against the replicated run's from ``ref_init`` to
    ``ref_final`` (``param_sample``'s), leaf by leaf: ``{"elements",
    "moved", "init_differs", "worst", "quarters": {quarter or "all":
    {"elements", "misses"}}, "leaves": {name: {"elements", "misses",
    "rel_fro"}}}``. An element misses where the two changes differ by
    more than ``atol_frac`` times its leaf's largest replicated change,
    and moved where the replicated change is larger than that; ``worst``
    is the largest difference over that tolerance; a leaf's ``rel_fro``
    is the norm of the two changes' difference over the norm of the
    replicated change."""
    import numpy as np

    names = sorted(ref_init)
    check(names == sorted(ref_final) == sorted(init) == sorted(final),
          f"sampled param leaves differ: {names[:3]}")
    out = {"elements": 0, "moved": 0, "init_differs": 0, "worst": 0.0,
           "quarters": {}, "leaves": {}}
    for name in names:
        r0, quarters = ref_init[name]
        g0 = init[name][0]
        check(g0.shape == r0.shape, f"{name}: sample of {g0.shape}, not "
              f"{r0.shape}")
        want, got = ref_final[name][0] - r0, final[name][0] - g0
        atol = atol_frac * float(np.abs(want).max(initial=0.0))
        err = np.abs(got - want)
        miss = err > atol
        out["elements"] += int(want.size)
        out["moved"] += int((np.abs(want) > atol).sum())
        out["init_differs"] += int((g0 != r0).sum())
        if atol > 0:
            out["worst"] = max(out["worst"], float(err.max()) / atol)
        out["leaves"][name] = {
            "elements": int(want.size), "misses": int(miss.sum()),
            "rel_fro": float(np.linalg.norm(got - want)
                             / max(float(np.linalg.norm(want)), 1e-30))}
        for q in np.unique(quarters):
            sel = quarters == q
            e = out["quarters"].setdefault("all" if q < 0 else str(int(q)),
                                           {"elements": 0, "misses": 0})
            e["elements"] += int(sel.sum())
            e["misses"] += int(miss[sel].sum())
    return out


def param_crcs(torch, params):
    """The CRC32 of every whole param leaf, ``{name: crc}``."""
    from dlrover_tpu_torch.common.tree import flatten

    return tensor_crcs(torch, {f"params/{p}": t.detach()
                               for p, t in flatten(params)})


def quarter_crcs(torch, state, quarters, world=FOUR_CARD_WORLD):
    """The CRC32 of each of the given quarters (zero-1 regions at dp
    ``world``) of every leaf of a train state, params and moments,
    ``{quarter: {name: crc}}``. A DTensor leaf's quarter must lie in this
    rank's local shard."""
    from dlrover_tpu_torch.checkpoint import ownership
    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.train import bootstrap, zero1

    rank = bootstrap.process_index()
    named = {f"params/{p}": t for p, t in flatten(state["params"])}
    for key in ("mu", "nu"):
        named.update({f"{key}/{p}": t for p, t in flatten(state["opt"][key])})
    parts = {}
    for q in quarters:
        for name, t in named.items():
            shape, regions = ownership.leaf_layout(t)
            dim = zero1.scatter_dim((), shape, {"dp": world})
            k = shape[dim] // world if dim is not None else 0
            if regions is None:
                parts[(str(q), name)] = zero1_region(t, dim, q, world)
                continue
            mine = [r for r, ranks in regions.items() if rank in ranks][0]
            start = q * k - mine[dim][0] if dim is not None else -1
            check(0 <= start and start + k <= mine[dim][1] - mine[dim][0],
                  f"{name}: quarter {q} is not in rank {rank}'s shard "
                  f"{mine}")
            parts[(str(q), name)] = t.to_local().narrow(dim, start, k)
    out = {str(q): {} for q in quarters}
    for (q, name), crc in tensor_crcs(torch, parts).items():
        out[q][name] = crc
    return out


def _event_ms(events):
    return None if events is None else events[0].elapsed_time(events[1])


def _zero1_run(torch, workdir, device, zero1_on, ref=None):
    """One run of the dp4 child: build, ZERO1_STEPS steps, the moments'
    bytes and peak allocation, each step's loss, wall and device ms of the
    gradient collectives, the update and the param gather; the step-1
    moment sample and the whole params' sample at init, after step 1 and
    after the last step (returned whole from the replicated run as
    ``ref``, compared with it for the zero-1 run); the CRC32 of the whole
    params after the last
    step; the zero-1 run then saves its state to storage and CRCs this
    rank's quarter."""
    import gc

    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    args = _zero1_args(workdir, zero1_on)
    cfg, trainer, state, _, _ = llama_pretrain.build(args, device)
    mode = "scatter" if zero1_on else "off"
    check(trainer.zero1_mode == mode,
          f"the trainer's zero-1 mode {trainer.zero1_mode}, not {mode}")
    ckpt = None
    if zero1_on:
        ckpt, _, restore = llama_pretrain.open_checkpoint(args, state, None)
        check(restore is None, f"the zero-1 run restored {restore}")
    batches, _, _ = llama_pretrain.open_data(args, cfg, trainer, args.seq,
                                             device, None)
    moments = [t for key in ("mu", "nu")
               for _, t in flatten(state["opt"][key])]
    run = {"mode": trainer.zero1_mode, "moment_bytes": sum(
        (t.to_local() if hasattr(t, "to_local") else t).nbytes
        for t in moments), "steps": []}
    world = bootstrap.process_count()
    init = param_sample(torch, state["params"], world)
    _reset_counts(attention, fce, [0])
    sample = None
    for step in range(1, ZERO1_STEPS + 1):
        state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                         next(batches))
        run["steps"].append({
            "step": step, "loss": loss, "seconds": seconds,
            "reduce_ms": _event_ms(trainer.reduce_events),
            "update_ms": _event_ms(trainer.update_events),
            "gather_ms": (_event_ms(trainer.gather_events) if zero1_on
                          else None)})
        print(f"rank {bootstrap.process_index()} {mode} step {step} loss "
              f"{loss:.6f} ({seconds:.3f}s)", flush=True)
        if step == 1:
            sample = moment_sample(torch, state, world)
            first = param_sample(torch, state["params"], world)
    run["counts"] = _launch_counts(attention, fce)
    run["max_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    final = param_sample(torch, state["params"], world)
    run["param_crc"] = param_crcs(torch, state["params"])
    if ref is not None:
        run["sample"] = compare_sample(ref["moments"], sample)
        run["delta"] = compare_delta(ref["init"], ref["first"], init, first)
        run["delta_last"] = compare_delta(ref["init"], ref["final"], init,
                                          final)
    if zero1_on:
        ckpt.save(ZERO1_STEPS, state)
        ckpt.close()
        run["stage"] = ckpt.stage_log[-1]
        run["crc"] = quarter_crcs(torch, state,
                                  [bootstrap.process_index()])
    del state, trainer, batches, moments
    return run, {"moments": sample, "init": init, "first": first,
                 "final": final}


def zero1_child(role, workdir):
    """One rank of the zero-1 leg (``_zero1_leg``), its process group
    formed by ``train/bootstrap.py`` from the environment the leg sets.
    ``dp4``: the replicated and the zero-1 runs. ``dp2``: restores the dp4
    zero-1 checkpoint under zero-1, CRCs the dp4 quarters its shard holds
    and trains one step. Prints one JSON result."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    ctx = bootstrap.init()
    rank, world = bootstrap.process_index(), bootstrap.process_count()
    device = f"cuda:{ctx.local_rank}"
    result = {"rank": rank, "world": world}
    if role == "dp4":
        result["replicated"], ref = _zero1_run(torch, workdir, device, False)
        result["zero1"], _ = _zero1_run(torch, workdir, device, True, ref)
    else:
        args = _zero1_args(workdir, True, steps=ZERO1_STEPS + 1)
        cfg, trainer, state, _, _ = llama_pretrain.build(args, device)
        check(trainer.zero1_mode == "scatter",
              f"the dp{world} trainer's zero-1 mode {trainer.zero1_mode}")
        ckpt, start, restore = llama_pretrain.open_checkpoint(args, state,
                                                              None)
        result["restore"] = restore
        check(start == ZERO1_STEPS, f"rank {rank} restored step {start}")
        per = FOUR_CARD_WORLD // world
        result["crc"] = quarter_crcs(
            torch, state, range(rank * per, (rank + 1) * per))
        batches, _, _ = llama_pretrain.open_data(args, cfg, trainer,
                                                 args.seq, device, None)
        _reset_counts(attention, fce, [0])
        state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                         next(batches))
        result["step"] = {"loss": loss, "seconds": seconds}
        result["counts"] = _launch_counts(attention, fce)
        ckpt.close()
    dist.barrier()
    print("CHILD_JSON " + json.dumps(result), flush=True)
    return 0


def _run_ranks(flag, label, role, world, workdir, job, timeout,
               extra_env=None, killed=None):
    """Start ``world`` ranks of ``chip_smoke.py FLAG role workdir`` on
    cards 0..world-1, the process group's address in their environment
    (and ``extra_env``), echo their output and return the result each
    prints on its ``CHILD_JSON`` line, in rank order; every rank is killed
    past ``timeout``. A rank that fails before its result fails the leg.
    With ``killed``, that rank must SIGKILL itself after its result; once
    it has and every result is in, the others are ended."""
    from dlrover_tpu_torch.common.constants import NodeEnv

    repo = os.path.dirname(os.path.abspath(__file__))
    port = free_port_block(1)
    env = {k: v for k, v in os.environ.items()
           if k != NodeEnv.MASTER_ADDR}
    env.update({NodeEnv.JOB_NAME: job, NodeEnv.NODE_ID: "0",
                NodeEnv.NUM_PROCESSES: str(world),
                NodeEnv.COORDINATOR_ADDR: f"127.0.0.1:{port}",
                "DLROVER_TPU_ACCELERATOR": "cuda",
                # the group's collective timeout: a rank's persist and CRCs
                # may run ahead of another's barrier
                "DLROVER_TPU_DIST_INIT_TIMEOUT": str(timeout),
                "PYTHONPATH": repo + os.pathsep
                + os.environ.get("PYTHONPATH", "")})
    env.update(extra_env or {})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), flag, role, workdir],
        cwd=repo, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        env=dict(env, **{NodeEnv.PROCESS_ID: str(r),
                         "DLROVER_TPU_LOCAL_RANK": str(r)}))
        for r in range(world)]
    results = [None] * world

    def read(r):
        for line in iter(procs[r].stdout.readline, ""):
            if line.startswith("CHILD_JSON "):
                results[r] = json.loads(line.split(" ", 1)[1])
                continue
            print(f"  [{label} {role} rank {r}] {line.rstrip()}", flush=True)

    readers = [threading.Thread(target=read, args=(r,), daemon=True)
               for r in range(world)]
    for t in readers:
        t.start()
    deadline = time.time() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if killed is None and None not in codes:
                break
            if (killed is not None and codes[killed] is not None
                    and None not in results):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)
                      and (killed is None or results[r] is None)]
            check(not failed and time.time() < deadline,
                  f"{label} {role}: ranks {failed} failed" if failed else
                  f"{label} {role}: not done after {timeout} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=60)
        for t in readers:
            t.join(timeout=30)
    codes = [p.returncode for p in procs]
    if killed is None:
        check(codes == [0] * world, f"{label} {role}: exit codes {codes}")
    else:
        check(codes[killed] == -signal.SIGKILL,
              f"{label} {role}: rank {killed} exited {codes[killed]}, not "
              "by its SIGKILL")
    check(all(r is not None for r in results),
          f"{label} {role}: a rank printed no result")
    return results


def _zero1_ranks(role, world, workdir, job):
    """``_run_ranks`` of the zero-1 leg's children."""
    return _run_ranks("--zero1-child", "zero1", role, world, workdir, job,
                      ZERO1_TIMEOUT_S)


def check_zero1(dp4, dp2, n_params):
    """The zero-1 leg's checks (module docstring) over the dp4 ranks'
    results and the restored ranks' (each indexed by rank)."""
    world = len(dp4)
    check([r["rank"] for r in dp4] == list(range(world)),
          f"the dp4 ranks: {[r['rank'] for r in dp4]}")
    for mode in ("replicated", "zero1"):
        losses = [[st["loss"] for st in r[mode]["steps"]] for r in dp4]
        check(all(x == losses[0] for x in losses)
              and len(losses[0]) == ZERO1_STEPS,
              f"the ranks' {mode} losses differ: {losses}")
        for r in dp4[1:]:
            compare_crcs(dp4[0][mode]["param_crc"], r[mode]["param_crc"],
                         f"rank {r['rank']}'s {mode} params against rank 0's")
        for r in dp4:
            for name, n in r[mode]["counts"].items():
                check(n > 0, f"kernel {name} never launched on rank "
                      f"{r['rank']} in the {mode} run")
    for r in dp4:
        rep, z1 = r["replicated"], r["zero1"]
        check(rep["mode"] == "off" and z1["mode"] == "scatter",
              f"rank {r['rank']}: modes {rep['mode']}, {z1['mode']}")
        for a, b in zip(rep["steps"], z1["steps"]):
            check(abs(b["loss"] - a["loss"])
                  <= ZERO1_LOSS_RTOL * abs(a["loss"]),
                  f"step {a['step']}: zero-1 loss {b['loss']} vs "
                  f"replicated {a['loss']}")
        check(rep["moment_bytes"] == 8 * n_params,
              f"rank {r['rank']}: replicated moments {rep['moment_bytes']} "
              f"bytes, not 8 a param ({8 * n_params})")
        check(z1["moment_bytes"] * world == rep["moment_bytes"],
              f"rank {r['rank']}: zero-1 moments {z1['moment_bytes']} bytes,"
              f" not 1/{world} of {rep['moment_bytes']}")
        saved = rep["max_memory_bytes"] - z1["max_memory_bytes"]
        check(saved >= ZERO1_PEAK_SAVING_MIN,
              f"rank {r['rank']}: zero-1 peak {z1['max_memory_bytes']} only "
              f"{saved} bytes under replicated {rep['max_memory_bytes']}")
        s = z1["sample"]
        check(s["elements"] >= ZERO1_SAMPLE_MIN and s["worst"] <= 1.0,
              f"rank {r['rank']}: step-1 moments sample {s}")
        for key, step, bound in (
                ("delta", 1, ZERO1_DELTA_MISS_MAX),
                ("delta_last", ZERO1_STEPS, ZERO1_DELTA_LAST_MISS_MAX)):
            d = z1[key]
            at = f"rank {r['rank']}, step {step}"
            check(d["init_differs"] == 0,
                  f"{at}: {d['init_differs']} sampled params differ at "
                  f"init between the runs")
            check(d["elements"] >= ZERO1_SAMPLE_MIN
                  and d["moved"] >= ZERO1_DELTA_MOVED_MIN * d["elements"],
                  f"{at}: the replicated run moved {d['moved']} of "
                  f"{d['elements']} sampled params")
            check(sorted(q for q in d["quarters"] if q != "all")
                  == [str(q) for q in range(world)],
                  f"{at}: params sampled in quarters "
                  f"{sorted(d['quarters'])}")
            for q, e in sorted(d["quarters"].items()):
                check(e["misses"] <= bound * e["elements"],
                      f"{at}, quarter {q}: the zero-1 change from init "
                      f"misses the replicated one in {e['misses']} of "
                      f"{e['elements']} sampled params")
        check(len(z1["crc"][str(r["rank"])]) > 0,
              f"rank {r['rank']}: no CRC32 of its quarter")
    check([r["rank"] for r in dp2] == list(range(len(dp2))),
          f"the restored ranks: {[r['rank'] for r in dp2]}")
    for r in dp2:
        check(r["restore"]["step"] == ZERO1_STEPS,
              f"restored rank {r['rank']}: step {r['restore']['step']}")
        for q, crcs in r["crc"].items():
            compare_crcs(dp4[int(q)]["zero1"]["crc"][q], crcs,
                         f"restored rank {r['rank']}'s quarter {q}")
        for name, n in r["counts"].items():
            check(n > 0, f"kernel {name} never launched on restored rank "
                  f"{r['rank']}")
        check(math.isfinite(r["step"]["loss"]),
              f"restored rank {r['rank']}: loss {r['step']['loss']}")
    check(len({r["step"]["loss"] for r in dp2}) == 1,
          f"the restored ranks' losses differ: "
          f"{[r['step']['loss'] for r in dp2]}")
    quarters = sorted(q for r in dp2 for q in r["crc"])
    check(quarters == [str(q) for q in range(world)],
          f"the restored ranks CRC'd quarters {quarters}")


def planner_zero1_step(dp4):
    """The goodput planner's same-world layout prediction for
    ``dp4+zero1`` from the replicated run (its step p50, the median over
    steps 2 on of the slowest rank's wall, and the gradient collectives'
    share of it as the kernel breakdown's comm), beside the zero-1 run's
    measured step p50: ``(predicted, replicated p50, zero-1 p50)``."""
    from dlrover_tpu_torch.brain.planner import GoodputPlanner, PlannerInputs
    from dlrover_tpu_torch.common.world import WorldDescriptor

    def p50(mode, key):
        return statistics.median(
            max(r[mode]["steps"][i][key] for r in dp4)
            for i in range(1, ZERO1_STEPS))

    base = p50("replicated", "seconds")
    comm = p50("replicated", "reduce_ms") / 1e3 / base
    inputs = PlannerInputs(world=len(dp4), step_p50_s=base, layout_spec="dp4",
                           kernel_breakdown={"comm.all-reduce": comm})
    wd = WorldDescriptor.from_axis_sizes({"dp": len(dp4)}, zero1=True)
    return (GoodputPlanner().predict_layout_step_time(wd, inputs), base,
            p50("zero1", "seconds"))


def print_zero1(dp4, dp2):
    """The zero-1 leg's readings, rank by rank."""
    for r in dp4:
        rep, z1 = r["replicated"], r["zero1"]
        print(f"  rank {r['rank']}: moments {rep['moment_bytes']} bytes "
              f"replicated, {z1['moment_bytes']} zero-1; "
              f"max_memory_allocated {rep['max_memory_bytes']} replicated, "
              f"{z1['max_memory_bytes']} zero-1 (lower by "
              f"{rep['max_memory_bytes'] - z1['max_memory_bytes']}); step-1 "
              f"moments sample {json.dumps(z1['sample'])}; params' change "
              f"from init to step 1 {json.dumps(z1['delta'])}, to step "
              f"{ZERO1_STEPS} {json.dumps(z1['delta_last'])}; staged "
              f"{z1['stage']['staged_bytes']} bytes", flush=True)
        for mode, run in (("replicated", rep), ("zero-1", z1)):
            for st in run["steps"]:
                gather = ("" if st["gather_ms"] is None
                          else f", param all-gather {st['gather_ms']:.3f} ms")
                print(f"  rank {r['rank']} {mode} step {st['step']}: loss "
                      f"{st['loss']:.6f}, step wall {st['seconds']:.4f} s, "
                      f"optimizer_update {st['update_ms']:.3f} ms, gradient "
                      f"collectives {st['reduce_ms']:.3f} ms{gather}",
                      flush=True)
    for r in dp2:
        res = r["restore"]
        print(f"  restored rank {r['rank']}: step {res['step']} by tier "
              f"{res['tier']} (rungs {res['tiers_read']}) in "
              f"{res['seconds']:.3f} s, {res['bytes']} bytes; the CRC32 of "
              f"quarters {sorted(r['crc'])} read; step "
              f"{ZERO1_STEPS + 1} loss {r['step']['loss']:.6f} in "
              f"{r['step']['seconds']:.3f} s", flush=True)
    predicted, rep, z1 = planner_zero1_step(dp4)
    print(f"  the planner's dp4+zero1 step {predicted:.4f} s (its layout "
          f"model from the replicated step p50 {rep:.4f} s) against the "
          f"measured zero-1 step p50 {z1:.4f} s", flush=True)


def _zero1_leg(torch):
    """The four-card zero-1 leg (module docstring)."""
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.run import llama_pretrain

    n_params = llama.param_count(llama_pretrain.model_config("8b", 4))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_zero1_")
    job = f"chip_smoke_zero1_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    t0 = time.perf_counter()
    # the node's saver, as the agent hosts it: it persists the four ranks'
    # segments of the saved step together
    host = AsyncCheckpointSaver(job_name=job, node_id=0,
                                local_process_ids=list(range(
                                    FOUR_CARD_WORLD)))
    host.start()
    try:
        write_corpus(os.path.join(workdir, "corpus.bin"),
                     records=FOUR_CARD_RECORDS)
        dp4 = _zero1_ranks("dp4", FOUR_CARD_WORLD, workdir, job)
        _wait_persisted(host, ZERO1_STEPS)
        committed = host.persister.committed_step(os.path.join(workdir, "ck"))
        check(committed == ZERO1_STEPS, f"committed step {committed}")
        host.stop()
        host = None
        t_dp2 = time.perf_counter()
        dp2 = _zero1_ranks("dp2", ZERO1_RESTORE_WORLD, workdir, job)
        print_zero1(dp4, dp2)
        check_zero1(dp4, dp2, n_params)
        print(f"  zero-1 leg: dp4 runs and the persist {t_dp2 - t0:.1f} s, "
              f"dp2 restore and step {time.perf_counter() - t_dp2:.1f} s; "
              f"every check passed", flush=True)
    finally:
        if host is not None:
            host.stop()
        for pid in range(FOUR_CARD_WORLD):
            unlink_segment(job, pid)
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)


# -- the four-card fsdp leg -------------------------------------------------------


def _fsdp_args(workdir, role):
    """``run/llama_pretrain.py``'s options for the fsdp leg: the whole
    32-layer Llama-3-8B, seq 2048, micro-batch 1, the four-card global
    batch, no lr warmup, synthetic tokens from the seed (a resumed life
    skips the batches of the restored steps, so it trains the same ones);
    fsdp4 with a checkpoint directory that is never persisted (``life1``,
    ``life2``), or dp2 x fsdp2 under ``--zero1`` (``zero1``)."""
    from dlrover_tpu_torch.run import llama_pretrain

    argv = ["--model", "8b", "--layers", "0", "--seq", str(DATA_SEQ),
            "--micro-batch", "1", "--global-batch",
            str(FOUR_CARD_GLOBAL_BATCH), "--steps", str(FSDP_STEPS),
            "--warmup-steps", "0", "--device", "cuda", "--seed", "0"]
    if role == "zero1":
        argv += ["--fsdp", str(FSDP_WORLD // FSDP_ZERO1_DP), "--zero1"]
    else:
        argv += ["--fsdp", str(FSDP_WORLD), "--ckpt-dir",
                 os.path.join(workdir, "ck"), "--save-every", "0"]
    return llama_pretrain.parse_args(argv)


def _held(t):
    """What this rank holds of a leaf, detached: a DTensor's local shard,
    a whole tensor itself."""
    return t.to_local().detach() if hasattr(t, "to_local") else t.detach()


def leaf_bytes(tree):
    """``{path: [global elements, elements this rank holds, element
    size]}`` of a tree of tensors and DTensors."""
    from dlrover_tpu_torch.common.tree import flatten

    return {path: [int(t.numel()), int(_held(t).numel()),
                   int(t.element_size())] for path, t in flatten(tree)}


def local_state_crcs(torch, state):
    """The CRC32 of what this rank holds of every leaf of a train state
    (a DTensor's local shard, a Python scalar as a numpy scalar), under
    its JAX name."""
    import numpy as np

    from dlrover_tpu_torch.checkpoint.shm_handler import flatten_state

    with torch.no_grad():
        named = {leaf.name: (_held(leaf.value)
                             if isinstance(leaf.value, torch.Tensor)
                             else np.array(leaf.value))
                 for leaf in flatten_state(state)}
    return tensor_crcs(torch, named)


def fsdp_sample(torch, params):
    """This rank's values of every param leaf at ZERO1_SAMPLE_PER_LEAF
    evenly spaced flat indices of the whole leaf, where they fall in the
    region it holds: ``{name: (sample positions, float64 values,
    samples in all)}``."""
    import numpy as np

    from dlrover_tpu_torch.common.tree import flatten
    from dlrover_tpu_torch.parallel.sharding import local_region, spec_of

    out = {}
    for path, p in flatten(params):
        shape = tuple(int(d) for d in p.shape)
        numel = math.prod(shape)
        n = min(numel, ZERO1_SAMPLE_PER_LEAF)
        idx = np.arange(n, dtype=np.int64) * (numel - 1) // max(n - 1, 1)
        region = (local_region(p.device_mesh, spec_of(p), shape)
                  if hasattr(p, "to_local") else tuple((0, d) for d in shape))
        coords = np.unravel_index(idx, shape)
        inside = np.ones(n, dtype=bool)
        for c, (lo, hi) in zip(coords, region):
            inside &= (c >= lo) & (c < hi)
        pos = np.nonzero(inside)[0]
        held = _held(p)
        at = tuple(torch.from_numpy(c[pos] - lo).to(held.device)
                   for c, (lo, _) in zip(coords, region))
        out[f"params/{path}"] = (pos, held[at].double().cpu().numpy(), n)
    return out


def _sample_path(workdir, role, rank, kind):
    return os.path.join(workdir, f"sample-{role}-{kind}-{rank}.npz")


def save_sample(workdir, role, rank, kind, sample):
    import numpy as np

    arrays = {}
    for name, (pos, values, n) in sample.items():
        arrays[f"{name}|pos"] = pos
        arrays[f"{name}|values"] = values
        arrays[f"{name}|n"] = np.array(n)
    np.savez(_sample_path(workdir, role, rank, kind), **arrays)


def load_sample(workdir, role, rank, kind):
    import numpy as np

    with np.load(_sample_path(workdir, role, rank, kind)) as f:
        names = sorted({k.rsplit("|", 1)[0] for k in f.files})
        return {name: (f[f"{name}|pos"], f[f"{name}|values"],
                       int(f[f"{name}|n"])) for name in names}


def merge_samples(parts):
    """The ranks' ``fsdp_sample``s of one run as whole-leaf samples in
    ``param_sample``'s form, ``{name: (values, holder)}``: the holder is
    the one rank holding a position, -1 where every rank holds it.
    Every position must be held, and ranks holding the same position must
    agree bitwise (a stale replica differs)."""
    import numpy as np

    out = {}
    for name in parts[0]:
        n = parts[0][name][2]
        values = np.zeros(n)
        holder = np.full(n, -1)
        held = np.zeros(n, dtype=np.int64)
        for r, part in enumerate(parts):
            pos, val, _ = part[name]
            seen = held[pos] > 0
            bad = int((values[pos][seen] != val[seen]).sum())
            check(bad == 0, f"{name}: rank {r} disagrees with another "
                  f"holder in {bad} sampled params")
            values[pos] = val
            holder[pos] = r
            held[pos] += 1
        check(bool((held > 0).all()), f"{name}: {int((held == 0).sum())} "
              f"sampled params held by no rank")
        holder[held == len(parts)] = -1
        out[name] = (values, holder)
    return out


def fsdp_child(role, workdir):
    """One rank of the fsdp leg (``_fsdp_leg``), its process group formed
    by ``train/bootstrap.py`` from the environment the leg sets. ``life1``:
    fsdp4 steps 1 to FSDP_KILL_AFTER with a memory save after
    FSDP_SAVE_STEP, the staged state's CRC32s, then rank FSDP_KILL_RANK
    SIGKILLs itself and the others wait in step 4's first gather. ``life2``:
    fsdp4 restored from this rank's shm segment, its CRC32s, steps to
    FSDP_STEPS. ``zero1``: dp2 x fsdp2 under zero-1, FSDP_ZERO1_STEPS
    steps. The init and step-1 params are sampled to the work directory;
    prints one JSON result."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import torch.distributed as dist

    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.parallel.sharding import local_region, spec_of
    from dlrover_tpu_torch.run import llama_pretrain
    from dlrover_tpu_torch.train import bootstrap

    t0 = time.perf_counter()
    ctx = bootstrap.init()
    rank, world = bootstrap.process_index(), bootstrap.process_count()
    device = f"cuda:{ctx.local_rank}"
    args = _fsdp_args(workdir, role)
    cfg, trainer, state, next_batch, tokens = llama_pretrain.build(args,
                                                                   device)
    result = {"rank": rank, "world": world, "mode": trainer.zero1_mode,
              "mesh": trainer.world_descriptor().spec,
              "tokens_per_step": tokens,
              "params": leaf_bytes(state["params"]),
              "moments": leaf_bytes({"mu": state["opt"]["mu"],
                                     "nu": state["opt"]["nu"]}),
              "build_s": time.perf_counter() - t0}
    ckpt, start = None, 0
    if role != "zero1":
        ckpt, start, result["restore"] = llama_pretrain.open_checkpoint(
            args, state, next_batch)
        if role == "life2":
            result["crc"] = local_state_crcs(torch, state)
    if role != "life2":
        save_sample(workdir, role, rank, "init",
                    fsdp_sample(torch, state["params"]))
    last = {"life1": FSDP_KILL_AFTER, "life2": FSDP_STEPS,
            "zero1": FSDP_ZERO1_STEPS}[role]
    # the sharded init's (and a restore's) peak, apart from the steps'
    result["init_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    _reset_counts(attention, fce, [0])
    torch.cuda.reset_peak_memory_stats(device)
    result["steps"] = []
    for step in range(start + 1, last + 1):
        state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                         next_batch())
        result["steps"].append({"step": step, "loss": loss,
                                "seconds": seconds,
                                "grad_bytes": trainer.grad_bytes})
        print(f"rank {rank} {role} step {step} loss {loss:.6f} "
              f"({seconds:.3f}s)", flush=True)
        if step == 1:
            save_sample(workdir, role, rank, "first",
                        fsdp_sample(torch, state["params"]))
        if role == "life1" and step == FSDP_SAVE_STEP:
            pause = ckpt.save(step, state)
            ckpt.wait_staging()
            result["save"] = {"pause_s": pause,
                              "mode": ckpt.last_stage_mode,
                              "staged_bytes":
                              ckpt.stage_log[-1]["staged_bytes"]}
            result["crc"] = local_state_crcs(torch, state)
    result["counts"] = _launch_counts(attention, fce)
    result["max_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    if role == "zero1":
        mu = state["opt"]["mu"]["lm_head"]
        mesh = trainer.mesh
        result["lm_head_mu"] = {
            "spec": spec_of(mu),
            "region": local_region(mesh, spec_of(mu), tuple(mu.shape)),
            "dp": mesh.get_local_rank("dp"),
            "fsdp": mesh.get_local_rank("fsdp"), "rows": int(mu.shape[0])}
    result["seconds"] = time.perf_counter() - t0
    print("CHILD_JSON " + json.dumps(result), flush=True)
    if role == "life1":
        if rank == FSDP_KILL_RANK:
            os.kill(os.getpid(), signal.SIGKILL)
        # step 4's first gather waits for the killed rank until the leg
        # ends this one
        llama_pretrain.timed_step(trainer, state, next_batch())
        raise SmokeFailure(f"rank {rank} finished step {last + 1} without "
                           f"rank {FSDP_KILL_RANK}")
    if ckpt is not None:
        ckpt.close()
    dist.barrier()
    return 0


def _quartered(run, tree, name, world=FSDP_WORLD):
    """Every fsdp-split leaf of ``tree`` (``leaf_bytes``) holds exactly
    1/``world`` on this rank; only the norms are whole."""
    for path, (total, held, _) in run[tree].items():
        if "norm" in path:
            continue
        check(held * world == total,
              f"{name}: rank {run['rank']} holds {held} of {path}'s {total} "
              f"elements, not 1/{world}")


def _held_bytes(run, tree):
    return sum(held * size for _, held, size in run[tree].values())


def check_fsdp(life1, life2, zero1, ref_init, ref_first, init, first):
    """The fsdp leg's checks (module docstring) over each run's ranks'
    results, in rank order, and the merged samples (``merge_samples``) of
    the fsdp4 run (``ref_*``) and the zero-1 run at init and after step
    1."""
    world = FSDP_WORLD
    for name, runs in (("life 1", life1), ("life 2", life2),
                       ("zero-1", zero1)):
        check([r["rank"] for r in runs] == list(range(world)),
              f"{name}: ranks {[r['rank'] for r in runs]}")
        losses = [[st["loss"] for st in r["steps"]] for r in runs]
        check(all(x == losses[0] for x in losses),
              f"{name}: the ranks' losses differ: {losses}")
        for r in runs:
            check(all(math.isfinite(x) for x in losses[r["rank"]]),
                  f"{name}: rank {r['rank']} losses {losses[r['rank']]}")
            for kname, n in r["counts"].items():
                check(n > 0, f"{name}: kernel {kname} never launched on "
                      f"rank {r['rank']}")
            check(r["init_peak_bytes"] <= r["max_memory_bytes"]
                  < FSDP_MEMORY_MAX,
                  f"{name}: rank {r['rank']} max_memory_allocated "
                  f"{r['max_memory_bytes']} in the steps, "
                  f"{r['init_peak_bytes']} before them")
    for r in life1 + life2:
        check(r["mode"] == "off" and r["mesh"] == f"fsdp{world}",
              f"rank {r['rank']}: mode {r['mode']} on {r['mesh']}")
        _quartered(r, "params", "fsdp4 params")
        _quartered(r, "moments", "fsdp4 moments")
        check(_held_bytes(r, "moments") == 2 * _held_bytes(r, "params"),
              f"rank {r['rank']}: moments {_held_bytes(r, 'moments')} bytes "
              f"against params {_held_bytes(r, 'params')}")
        for st in r["steps"]:
            check(st["grad_bytes"] == _held_bytes(r, "params"),
                  f"rank {r['rank']} step {st['step']}: gradients "
                  f"{st['grad_bytes']} bytes, params "
                  f"{_held_bytes(r, 'params')}")
    for r in life1:
        check([st["step"] for st in r["steps"]]
              == list(range(1, FSDP_KILL_AFTER + 1)),
              f"life 1 rank {r['rank']} steps {r['steps']}")
        check(r["restore"] is None, f"life 1 rank {r['rank']} restored "
              f"{r['restore']}")
    for r1, r2 in zip(life1, life2):
        res = r2["restore"]
        at = f"life 2 rank {r2['rank']}"
        check(res is not None and res["step"] == FSDP_SAVE_STEP,
              f"{at}: restored {res}")
        check(res["tier"] == "shm" and res["tiers_read"] == ["shm"],
              f"{at}: restored by tier {res['tier']} (rungs "
              f"{res['tiers_read']}), not from its own shm segment")
        compare_crcs(r1["crc"], r2["crc"],
                     f"{at}'s restored state against the one staged")
        check([st["step"] for st in r2["steps"]]
              == list(range(FSDP_SAVE_STEP + 1, FSDP_STEPS + 1)),
              f"{at}: steps {r2['steps']}")
        want = r1["steps"][FSDP_SAVE_STEP]["loss"]
        got = r2["steps"][0]["loss"]
        check(abs(got - want) <= FSDP_LOSS_TOL,
              f"{at}: resumed step {FSDP_SAVE_STEP + 1} loss {got} against "
              f"life 1's {want}")
    for r in zero1:
        at = f"zero-1 rank {r['rank']}"
        check(r["mode"] == "gspmd"
              and r["mesh"] == f"dp{FSDP_ZERO1_DP}xfsdp"
              f"{world // FSDP_ZERO1_DP}+zero1",
              f"{at}: mode {r['mode']} on {r['mesh']}")
        for path, (total, held, _) in r["moments"].items():
            split = FSDP_ZERO1_DP if "norm" in path else world
            check(held * split == total,
                  f"{at}: holds {held} of {path}'s {total} moment elements, "
                  f"not 1/{split}")
        mu = r["lm_head_mu"]
        block = mu["fsdp"] * FSDP_ZERO1_DP + mu["dp"]
        rows = mu["rows"] // world
        check(tuple(map(tuple, mu["region"]))[0]
              == (block * rows, (block + 1) * rows)
              and tuple(mu["spec"][0]) == ("fsdp", "dp"),
              f"{at}: lm_head's moments hold rows {mu['region'][0]} on "
              f"{mu['spec']}, not fsdp-major block {block}")
        got, want = r["steps"][0]["loss"], life1[0]["steps"][0]["loss"]
        check(abs(got - want) <= FSDP_LOSS_TOL,
              f"{at}: step-1 loss {got} against fsdp4's {want}")
    d = compare_delta(ref_init, ref_first, init, first)
    check(d["init_differs"] == 0,
          f"{d['init_differs']} sampled params differ at init between the "
          "fsdp4 and the zero-1 runs")
    check(d["elements"] >= ZERO1_SAMPLE_MIN
          and d["moved"] >= ZERO1_DELTA_MOVED_MIN * d["elements"],
          f"the fsdp4 run moved {d['moved']} of {d['elements']} sampled "
          "params in step 1")
    check(sorted(q for q in d["quarters"] if q != "all")
          == [str(q) for q in range(world)],
          f"params sampled in shards {sorted(d['quarters'])}")
    for q, e in sorted(d["quarters"].items()):
        check(e["misses"] <= ZERO1_DELTA_MISS_MAX * e["elements"],
              f"shard {q}: the zero-1 change from init misses the fsdp4 "
              f"one in {e['misses']} of {e['elements']} sampled params")
    return d


def print_fsdp(life1, life2, zero1, delta, n_params, card):
    """The fsdp leg's readings, each beside the cards' name and power
    limit."""
    for name, runs in (("fsdp4 life 1", life1), ("fsdp4 life 2", life2),
                       ("dp2xfsdp2 zero-1", zero1)):
        for r in runs:
            print(f"  {name} rank {r['rank']}: params "
                  f"{_held_bytes(r, 'params')} bytes, grads "
                  f"{r['steps'][-1]['grad_bytes']} bytes, moments "
                  f"{_held_bytes(r, 'moments')} bytes, max_memory_allocated "
                  f"{r['max_memory_bytes']} (before the steps "
                  f"{r['init_peak_bytes']}); build {r['build_s']:.1f} s, "
                  f"the run {r['seconds']:.1f} s; launches "
                  f"{json.dumps(r['counts'])} ({card})", flush=True)
        per_card = runs[0]["tokens_per_step"] / len(runs)
        for i, st in enumerate(runs[0]["steps"]):
            wall = max(r["steps"][i]["seconds"] for r in runs)
            mfu = 6 * n_params * per_card / wall / PEAK_FLOPS
            print(f"  {name} step {st['step']}: loss {st['loss']:.6f}, step "
                  f"wall {wall:.4f} s (slowest rank), {per_card / wall:.1f} "
                  f"tokens/s a card, MFU {mfu:.4f} ({card})", flush=True)
    for r in life1:
        sv = r["save"]
        print(f"  life 1 rank {r['rank']}: the step-{FSDP_SAVE_STEP} save "
              f"paused {sv['pause_s']:.4f} s ({sv['mode']}), staged "
              f"{sv['staged_bytes']} bytes ({card})", flush=True)
    for r1, r2 in zip(life1, life2):
        res = r2["restore"]
        bitwise = r2["steps"][0]["loss"] == r1["steps"][FSDP_SAVE_STEP][
            "loss"]
        print(f"  life 2 rank {r2['rank']}: restored step {res['step']} by "
              f"tier {res['tier']} in {res['seconds']:.3f} s, {res['bytes']}"
              f" bytes, {len(r2['crc'])} leaves' CRC32 equal to the staged; "
              f"step {FSDP_SAVE_STEP + 1} loss "
              f"{r2['steps'][0]['loss']:.6f} against "
              f"{r1['steps'][FSDP_SAVE_STEP]['loss']:.6f} "
              f"({'bitwise' if bitwise else 'not bitwise'}) ({card})",
              flush=True)
    print(f"  zero-1 step 1 loss {zero1[0]['steps'][0]['loss']:.6f} against "
          f"fsdp4 {life1[0]['steps'][0]['loss']:.6f}; lm_head moments on "
          f"{zero1[0]['lm_head_mu']['spec']}; the step-1 change from init "
          f"against fsdp4's {json.dumps(delta)}", flush=True)


def _fsdp_leg(torch):
    """The four-card fsdp leg (module docstring)."""
    from dlrover_tpu_torch.checkpoint.saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.checkpoint.shm_handler import HEADER_SPACE
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.run import llama_pretrain

    n_params = llama.param_count(llama_pretrain.model_config("8b", 0))
    card = "; ".join(sorted(set(nvidia_smi_line().splitlines())))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    job = f"chip_smoke_fsdp_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    t0 = time.perf_counter()
    nbytes = 12 * n_params
    shm_free = check_space("/dev/shm", nbytes + FSDP_WORLD * HEADER_SPACE,
                           "shm")
    print(f"  {n_params} params, {nbytes} bytes of params and moments over "
          f"four shm segments, nothing to disk; shm free {shm_free} ({card})",
          flush=True)
    # the node's saver, as the agent hosts it: the stages run under its
    # shm lock; it persists nothing (no storage save is asked for)
    host = AsyncCheckpointSaver(job_name=job, node_id=0,
                                local_process_ids=list(range(FSDP_WORLD)))
    host.start()
    whole = {"DLROVER_TPU_CKPT_DEDUP": "0"}
    try:
        life1 = _run_ranks("--fsdp-child", "fsdp", "life1", FSDP_WORLD,
                           workdir, job, FSDP_TIMEOUT_S, whole,
                           killed=FSDP_KILL_RANK)
        t1 = time.perf_counter()
        life2 = _run_ranks("--fsdp-child", "fsdp", "life2", FSDP_WORLD,
                           workdir, job, FSDP_TIMEOUT_S, whole)
        t2 = time.perf_counter()
        zero1 = _run_ranks("--fsdp-child", "fsdp", "zero1", FSDP_WORLD,
                           workdir, job, FSDP_TIMEOUT_S)
        t3 = time.perf_counter()
        samples = {
            (role, kind): merge_samples([
                load_sample(workdir, role, r, kind)
                for r in range(FSDP_WORLD)])
            for role in ("life1", "zero1") for kind in ("init", "first")}
        delta = compare_delta(samples[("life1", "init")],
                              samples[("life1", "first")],
                              samples[("zero1", "init")],
                              samples[("zero1", "first")])
        print_fsdp(life1, life2, zero1, delta, n_params, card)
        check_fsdp(life1, life2, zero1, samples[("life1", "init")],
                   samples[("life1", "first")], samples[("zero1", "init")],
                   samples[("zero1", "first")])
        print(f"  fsdp leg: life 1 {t1 - t0:.1f} s, life 2 {t2 - t1:.1f} s, "
              f"zero-1 {t3 - t2:.1f} s, {time.perf_counter() - t0:.1f} s in "
              f"all; every check passed ({card})", flush=True)
        return life1[0]["steps"][0]["loss"]
    finally:
        host.stop()
        for pid in range(FSDP_WORLD):
            unlink_segment(job, pid)
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)


def _tp_args(role):
    """``run/llama_pretrain.py``'s options for the tp leg: the fsdp leg's
    (the whole 32-layer Llama-3-8B, seq 2048, micro-batch 1, the
    four-card global batch, no lr warmup, synthetic tokens from seed 0)
    at ``--tp 2`` beside ``--fsdp 2`` (``fsdp2xtp2``) or beside dp under
    ``--zero1`` (``dp2xtp2``)."""
    from dlrover_tpu_torch.run import llama_pretrain

    steps = TP_STEPS if role == "fsdp2xtp2" else TP_ZERO1_STEPS
    argv = ["--model", "8b", "--layers", "0", "--seq", str(DATA_SEQ),
            "--micro-batch", "1", "--global-batch",
            str(FOUR_CARD_GLOBAL_BATCH), "--steps", str(steps),
            "--warmup-steps", "0", "--device", "cuda", "--seed", "0",
            "--tp", str(TP_SIZE)]
    argv += (["--fsdp", str(TP_FSDP)] if role == "fsdp2xtp2"
             else ["--zero1"])
    return llama_pretrain.parse_args(argv)


def tp_child(role, workdir):
    """One rank of the tp leg (``_tp_leg``), its process group formed by
    ``train/bootstrap.py`` from the environment the leg sets: ``role``'s
    steps through ``llama_pretrain.build`` with the launch counters at 0
    just before them; prints one JSON result (the held bytes of the
    params and moments, each step's loss, wall and gradient bytes, the
    launch counts and the peaks)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from dlrover_tpu_torch.train import bootstrap

    t0 = time.perf_counter()
    ctx = bootstrap.init()
    rank, world = bootstrap.process_index(), bootstrap.process_count()
    try:
        return _tp_run(torch, role, t0, rank, world,
                       f"cuda:{ctx.local_rank}")
    except BaseException:
        # exit at once: the peers' NCCL wait would hold this process, and
        # the leg, to its timeout
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _tp_run(torch, role, t0, rank, world, device):
    """``tp_child``'s run on ``device`` once the group has formed."""
    import torch.distributed as dist

    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain

    args = _tp_args(role)
    _, trainer, state, next_batch, tokens = llama_pretrain.build(args,
                                                                 device)
    result = {"rank": rank, "world": world, "mode": trainer.zero1_mode,
              "mesh": trainer.world_descriptor().spec,
              "tokens_per_step": tokens,
              "params": leaf_bytes(state["params"]),
              "moments": leaf_bytes({"mu": state["opt"]["mu"],
                                     "nu": state["opt"]["nu"]}),
              "build_s": time.perf_counter() - t0,
              "init_peak_bytes": torch.cuda.max_memory_allocated(device)}
    _reset_counts(attention, fce, [0])
    torch.cuda.reset_peak_memory_stats(device)
    result["steps"] = []
    for step in range(1, args.steps + 1):
        state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                         next_batch())
        result["steps"].append({"step": step, "loss": loss,
                                "seconds": seconds,
                                "grad_bytes": trainer.grad_bytes})
        print(f"rank {rank} {role} step {step} loss {loss:.6f} "
              f"({seconds:.3f}s)", flush=True)
    result["counts"] = _launch_counts(attention, fce)
    result["max_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    result["seconds"] = time.perf_counter() - t0
    print("CHILD_JSON " + json.dumps(result), flush=True)
    dist.barrier()
    return 0


def _tp_split(path, fsdp, dp_moments=1):
    """The factor a rank's share of leaf ``path`` is cut by: fsdp times
    tp for a matrix, whole for a norm; ``dp_moments`` more for a zero-1
    moment (a norm's moments too)."""
    return (1 if "norm" in path else fsdp * TP_SIZE) * dp_moments


def check_tp(runs, fsdp4_loss):
    """The tp leg's checks over each run's ranks' results, in rank order
    (``runs``: ``{"fsdp2xtp2": [...], "dp2xtp2": [...]}``): every run's
    mode and mesh, its losses equal across its ranks and finite, its
    step-1 loss within TP_LOSS_RTOL of ``fsdp4_loss``; every rank's
    params, moments and gradients at the arithmetic's share, its peak
    under FSDP_MEMORY_MAX and not under the init's, every kernel
    launched."""
    world = FSDP_WORLD
    want = {"fsdp2xtp2": ("off", "fsdp2xtp2", TP_FSDP, 1, TP_STEPS),
            "dp2xtp2": ("gspmd", "dp2xtp2+zero1", 1, 2, TP_ZERO1_STEPS)}
    for name, (mode, mesh, fsdp, dp, steps) in want.items():
        rs = runs[name]
        check([r["rank"] for r in rs] == list(range(world)),
              f"{name}: ranks {[r['rank'] for r in rs]}")
        losses = [[st["loss"] for st in r["steps"]] for r in rs]
        check(all(x == losses[0] for x in losses),
              f"{name}: the ranks' losses differ: {losses}")
        check(len(losses[0]) == steps
              and all(math.isfinite(x) for x in losses[0]),
              f"{name}: losses {losses[0]}")
        rel = abs(losses[0][0] - fsdp4_loss) / abs(fsdp4_loss)
        check(rel <= TP_LOSS_RTOL,
              f"{name}: step-1 loss {losses[0][0]} against fsdp4's "
              f"{fsdp4_loss}, {rel:.3e} relative > {TP_LOSS_RTOL}")
        for r in rs:
            at = f"{name} rank {r['rank']}"
            check(r["mode"] == mode and r["mesh"] == mesh,
                  f"{at}: mode {r['mode']} on {r['mesh']}")
            for tree, z in (("params", 1), ("moments", dp)):
                for path, (total, held, _) in r[tree].items():
                    split = _tp_split(path, fsdp, z)
                    check(held * split == total,
                          f"{at}: holds {held} of {tree} {path}'s {total} "
                          f"elements, not 1/{split}")
            for st in r["steps"]:
                check(st["grad_bytes"] == _held_bytes(r, "params"),
                      f"{at} step {st['step']}: gradients "
                      f"{st['grad_bytes']} bytes, params "
                      f"{_held_bytes(r, 'params')}")
            for kname, n in r["counts"].items():
                check(n > 0, f"{at}: kernel {kname} never launched")
            check(r["init_peak_bytes"] <= r["max_memory_bytes"]
                  < FSDP_MEMORY_MAX,
                  f"{at}: max_memory_allocated {r['max_memory_bytes']} in "
                  f"the steps, {r['init_peak_bytes']} before them")


def tp_kernels_line(runs):
    """The tp leg's ``kernels`` line: each kernel's launches by run and
    rank."""
    kernels = []
    for table, source in ((KERNELS, SOURCE), (CE_KERNELS, CE_SOURCE)):
        for kname, _, replaces in table:
            kernels.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": {name: [r["counts"][kname] for r in rs]
                             for name, rs in runs.items()}})
    return json.dumps({"kernels": kernels})


def print_tp(runs, fsdp4_loss, n_params, card):
    """The tp leg's readings, each beside the cards' name and power
    limit."""
    for name, rs in runs.items():
        for r in rs:
            print(f"  {name} rank {r['rank']}: params "
                  f"{_held_bytes(r, 'params')} bytes, grads "
                  f"{r['steps'][-1]['grad_bytes']} bytes, moments "
                  f"{_held_bytes(r, 'moments')} bytes, max_memory_allocated "
                  f"{r['max_memory_bytes']} (before the steps "
                  f"{r['init_peak_bytes']}); build {r['build_s']:.1f} s, "
                  f"the run {r['seconds']:.1f} s; launches "
                  f"{json.dumps(r['counts'])} ({card})", flush=True)
        per_card = rs[0]["tokens_per_step"] / len(rs)
        for i, st in enumerate(rs[0]["steps"]):
            wall = max(r["steps"][i]["seconds"] for r in rs)
            mfu = 6 * n_params * per_card / wall / PEAK_FLOPS
            print(f"  {name} step {st['step']}: loss {st['loss']:.6f}, step "
                  f"wall {wall:.4f} s (slowest rank), {per_card / wall:.1f} "
                  f"tokens/s a card, MFU {mfu:.4f} ({card})", flush=True)
        got = rs[0]["steps"][0]["loss"]
        print(f"  {name} step-1 loss {got:.6f} against fsdp4's "
              f"{fsdp4_loss:.6f}: {abs(got - fsdp4_loss) / fsdp4_loss:.3e} "
              f"relative (bound {TP_LOSS_RTOL})", flush=True)


def _tp_leg(torch, fsdp4_loss):
    """The four-card tp leg (module docstring)."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.run import llama_pretrain

    n_params = llama.param_count(llama_pretrain.model_config("8b", 0))
    card = "; ".join(sorted(set(nvidia_smi_line().splitlines())))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    job = f"chip_smoke_tp_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    t0 = time.perf_counter()
    try:
        runs, walls = {}, {}
        for name in ("fsdp2xtp2", "dp2xtp2"):
            t = time.perf_counter()
            runs[name] = _run_ranks("--tp-child", "tp", name, FSDP_WORLD,
                                    workdir, job, TP_TIMEOUT_S, TP_ENV)
            walls[name] = time.perf_counter() - t
        print_tp(runs, fsdp4_loss, n_params, card)
        check_tp(runs, fsdp4_loss)
        print(tp_kernels_line(runs), flush=True)
        print(f"  tp leg: fsdp2 x tp2 {walls['fsdp2xtp2']:.1f} s, dp2 x tp2 "
              f"zero-1 {walls['dp2xtp2']:.1f} s, "
              f"{time.perf_counter() - t0:.1f} s in all; every check passed "
              f"({card})", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


#: the sp leg's runs in the four ranks' one start: run -> (fsdp, sp,
#: attn_impl, the world's spec)
SP_RUNS = {
    "sp4_ring": (1, 4, "ring", "sp4"),
    "sp4_ulysses": (1, 4, "ulysses", "sp4"),
    "fsdp2xsp2_ring": (2, 2, "ring", "fsdp2xsp2"),
}


def sp_flash_cases(h, hkv, d, runs=SP_RUNS, seq=SP_SEQ):
    """Every shape at which the sp leg launches the flash kernels, derived
    from ``runs`` and ``seq`` so that no run adds a shape nothing holds:
    the reference's causal kernel on the whole sequence of ``h`` / ``hkv``
    heads; each ring run's causal diagonal chunk and non-causal earlier
    chunk at ``seq/sp``; each ulysses run's causal kernel on the whole
    sequence of its local heads (the kv heads repeated where sp does not
    divide them, as ``ops/ulysses.py`` repeats them). ``[(label, case)]``,
    each shape once, labelled by the first run that launches it."""
    want = [("reference", dict(b=1, s=seq, h=h, hkv=hkv, d=d, causal=True))]
    for run, (_, sp, impl, _) in runs.items():
        if impl == "ring":
            for tag, causal in (("diagonal", True), ("earlier", False)):
                want.append((f"{run}_{tag}", dict(
                    b=1, s=seq // sp, h=h, hkv=hkv, d=d, causal=causal)))
        else:
            rep = 1 if hkv % sp == 0 else sp // math.gcd(hkv, sp)
            want.append((f"{run}_local", dict(
                b=1, s=seq, h=h // sp, hkv=hkv * rep // sp, d=d,
                causal=True)))
    out = []
    for label, case in want:
        if all(case != c for _, c in out):
            out.append((label, case))
    return out


def _sp_args(run):
    """``run/llama_pretrain.py``'s options for one run of the sp leg: the
    main path's widths at SP_LAYERS layers, seq SP_SEQ, global batch
    SP_GLOBAL_BATCH, micro-batch 1, no lr warmup, seed 0; the reference
    on one card, the flash kernels on the whole sequence, else
    ``SP_RUNS[run]``'s mesh with its attention."""
    from dlrover_tpu_torch.run import llama_pretrain

    argv = ["--model", "8b", "--layers", str(SP_LAYERS), "--seq",
            str(SP_SEQ), "--micro-batch", "1", "--global-batch",
            str(SP_GLOBAL_BATCH), "--steps", str(SP_STEPS),
            "--warmup-steps", "0", "--device", "cuda", "--seed", "0"]
    if run in SP_RUNS:
        fsdp, sp, impl, _ = SP_RUNS[run]
        argv += ["--fsdp", str(fsdp), "--sp", str(sp), "--attn-impl", impl]
    return llama_pretrain.parse_args(argv)


def sp_batches(torch, steps=SP_STEPS, global_batch=SP_GLOBAL_BATCH,
               seq=SP_SEQ, vocab=DATA_VOCAB, seed=DATA_SEED):
    """The sp leg's global batches, ``(steps, global_batch, seq)`` token
    ids drawn on the host from ``seed``: the same rows whatever a run's
    layout."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (steps, global_batch, seq), generator=gen)


def sp_expected_flash(run, rank, accum, layers=SP_LAYERS, steps=SP_STEPS):
    """The flash kernels' launches a rank of ``run`` makes in ``steps``
    steps of ``accum`` microbatches under remat "all": a chunk kernel a
    layer a forward (ring: rank r of the sp group runs r + 1 causal chunk
    kernels, ulysses and the reference one on the whole sequence), the
    forward twice (the recompute), each backward kernel once. Returns
    ``{kernel: launches}``."""
    if run == "reference":
        chunks = 1
    else:
        _, sp, impl, _ = SP_RUNS[run]
        chunks = rank % sp + 1 if impl == "ring" else 1
    n = steps * accum * layers * chunks
    return {"flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}


def _sp_train(torch, run, device, batches, workdir, rank):
    """One run of the sp leg on ``device``: built through
    ``llama_pretrain.build``, its params sampled at init and after the last
    step to the work directory, the launch counters at 0 just before the
    steps. Returns the run's result."""
    from dlrover_tpu_torch.ops import attention
    from dlrover_tpu_torch.ops import fused_ce as fce
    from dlrover_tpu_torch.run import llama_pretrain

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    args = _sp_args(run)
    _, trainer, state, _, tokens = llama_pretrain.build(args, device)
    a, b = trainer.step_batch_shape
    result = {"rank": rank, "mode": trainer.zero1_mode,
              "mesh": (trainer.world_descriptor().spec
                       if trainer.mesh is not None else "one card"),
              "accum": a, "tokens_per_step": tokens,
              "params": leaf_bytes(state["params"]),
              "moments": leaf_bytes({"mu": state["opt"]["mu"],
                                     "nu": state["opt"]["nu"]}),
              "build_s": time.perf_counter() - t0,
              "init_peak_bytes": torch.cuda.max_memory_allocated(device)}
    save_sample(workdir, run, rank, "init",
                fsdp_sample(torch, state["params"]))
    _reset_counts(attention, fce, [0])
    torch.cuda.reset_peak_memory_stats(device)
    result["steps"] = []
    for step in range(1, args.steps + 1):
        batch = trainer.local_rows(batches[step - 1].reshape(a, b, -1)).to(
            device)
        state, loss, seconds = llama_pretrain.timed_step(trainer, state,
                                                         batch)
        result["steps"].append({"step": step, "loss": loss,
                                "seconds": seconds,
                                "grad_bytes": trainer.grad_bytes})
        print(f"rank {rank} {run} step {step} loss {loss:.6f} "
              f"({seconds:.3f}s)", flush=True)
    result["counts"] = _launch_counts(attention, fce)
    result["max_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    save_sample(workdir, run, rank, "last",
                fsdp_sample(torch, state["params"]))
    result["seconds"] = time.perf_counter() - t0
    return result


def sp_child(role, workdir):
    """The sp leg's processes (``_sp_leg``). ``reference``: one process on
    one card, no process group: the flash kernels against their plain
    versions at ``sp_flash_cases`` and their times, then the reference
    run. ``ranks``: one
    rank of the four, its group formed by ``train/bootstrap.py`` from the
    environment the leg sets, running every run of ``SP_RUNS`` in turn, the
    mesh rebuilt and the memory freed between them. Prints one JSON
    result; a rank that raises exits at once."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        batches = sp_batches(torch)
        if role == "reference":
            from dlrover_tpu_torch.ops import attention
            from dlrover_tpu_torch.run import llama_pretrain

            cfg = llama_pretrain.model_config("8b", SP_LAYERS)
            gen = torch.Generator(device="cuda").manual_seed(4321)
            out = {"rank": 0, "flash": {}}
            for label, case in sp_flash_cases(cfg.n_heads, cfg.n_kv_heads,
                                              cfg.head_dim):
                errs, inputs = check_flash_case(torch, attention, label,
                                                case, gen)
                out["flash"][label] = dict(time_flash_case(
                    torch, attention, label, case, errs, inputs),
                    case=case)
                del inputs
                gc.collect()
                torch.cuda.empty_cache()
            out["runs"] = {"reference": _sp_train(
                torch, "reference", "cuda:0", batches, workdir, 0)}
            print("CHILD_JSON " + json.dumps(out), flush=True)
            return 0
        import torch.distributed as dist

        from dlrover_tpu_torch.train import bootstrap

        ctx = bootstrap.init()
        rank = bootstrap.process_index()
        device = f"cuda:{ctx.local_rank}"
        out = {"rank": rank, "runs": {}}
        for run in SP_RUNS:
            out["runs"][run] = _sp_train(torch, run, device, batches,
                                         workdir, rank)
            gc.collect()
            torch.cuda.empty_cache()
            dist.barrier()
        print("CHILD_JSON " + json.dumps(out), flush=True)
        dist.barrier()
        return 0
    except BaseException:
        # exit at once: the peers' NCCL wait would hold this process, and
        # the leg, to its timeout
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _sp_held_split(run, path):
    """The factor a rank's share of param leaf ``path`` is cut by in
    ``run``: fsdp for a matrix (sp splits no param), whole for a norm."""
    fsdp = SP_RUNS[run][0] if run in SP_RUNS else 1
    return 1 if "norm" in path else fsdp


def _sp_results(ref, ranks):
    """``{run: [each rank's result]}`` of the sp leg, the reference
    child's run first (one rank)."""
    runs = {"reference": [ref["runs"]["reference"]]}
    runs.update({run: [r["runs"][run] for r in ranks] for run in SP_RUNS})
    return runs


def check_sp(ref, ranks, deltas):
    """The sp leg's checks: ``ref`` the reference child's result, ``ranks``
    the four ranks' results in rank order, ``deltas`` ``{run:
    compare_delta of its merged samples against the reference's}``.
    Every run's losses equal across its
    ranks, finite, and at steps 1 and 2 within SP_LOSS_RTOL of the
    reference's; every rank's mode and mesh, its params, gradients and
    moments at the arithmetic's share, its peak under FSDP_MEMORY_MAX;
    every kernel launched, the flash kernels as often as
    ``sp_expected_flash`` says; each leaf's change after the last step
    against the reference's within ``SP_DELTA_REL_FRO``."""
    runs = _sp_results(ref, ranks)
    want_losses = [st["loss"] for st in runs["reference"][0]["steps"]]
    check(len(want_losses) == SP_STEPS
          and all(math.isfinite(x) for x in want_losses),
          f"reference losses {want_losses}")
    check([r["rank"] for r in ranks] == list(range(SP_WORLD)),
          f"sp ranks {[r['rank'] for r in ranks]}")
    for run, rs in runs.items():
        losses = [[st["loss"] for st in r["steps"]] for r in rs]
        check(all(x == losses[0] for x in losses),
              f"{run}: the ranks' losses differ: {losses}")
        for i, (got, want) in enumerate(zip(losses[0], want_losses)):
            rel = abs(got - want) / abs(want)
            check(math.isfinite(got) and rel <= SP_LOSS_RTOL,
                  f"{run}: step-{i + 1} loss {got} against the reference's "
                  f"{want}, {rel:.3e} relative > {SP_LOSS_RTOL}")
        for rank, r in enumerate(rs):
            at = f"{run} rank {rank}"
            mesh = SP_RUNS[run][3] if run in SP_RUNS else "one card"
            check(r["mode"] == "off" and r["mesh"] == mesh,
                  f"{at}: mode {r['mode']} on {r['mesh']}")
            for path, (total, held, _) in r["params"].items():
                split = _sp_held_split(run, path)
                check(held * split == total,
                      f"{at}: holds {held} of param {path}'s {total} "
                      f"elements, not 1/{split}")
            check(_held_bytes(r, "moments") == 2 * _held_bytes(r, "params"),
                  f"{at}: moments {_held_bytes(r, 'moments')} bytes against "
                  f"params {_held_bytes(r, 'params')}")
            for st in r["steps"]:
                check(st["grad_bytes"] == _held_bytes(r, "params"),
                      f"{at} step {st['step']}: gradients "
                      f"{st['grad_bytes']} bytes, params "
                      f"{_held_bytes(r, 'params')}")
            check(r["max_memory_bytes"] < FSDP_MEMORY_MAX,
                  f"{at}: max_memory_allocated {r['max_memory_bytes']}")
            for kname, n in r["counts"].items():
                check(n > 0, f"{at}: kernel {kname} never launched")
            for kname, n in sp_expected_flash(run, rank,
                                              r["accum"]).items():
                check(r["counts"][kname] == n,
                      f"{at}: {kname} launched {r['counts'][kname]} times, "
                      f"not {n}")
    for run, d in deltas.items():
        check(d["init_differs"] == 0,
              f"{run}: {d['init_differs']} sampled params differ at init "
              "from the reference's")
        check(d["moved"] >= ZERO1_DELTA_MOVED_MIN * d["elements"],
              f"{run}: the reference moved {d['moved']} of {d['elements']} "
              "sampled params")
        for name, e in sorted(d["leaves"].items()):
            check(e["rel_fro"] <= SP_DELTA_REL_FRO,
                  f"{run}: {name}'s change from init parts from the "
                  f"reference's by {e['rel_fro']:.3f} relative > "
                  f"{SP_DELTA_REL_FRO:.3f}")


def sp_kernels_line(ref, ranks):
    """The sp leg's ``kernels`` line: each kernel's launches by run and
    rank, the references' one rank among them."""
    runs = _sp_results(ref, ranks)
    kernels = []
    for table, source in ((KERNELS, SOURCE), (CE_KERNELS, CE_SOURCE)):
        for kname, _, replaces in table:
            kernels.append({
                "name": kname, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": {run: [r["counts"][kname] for r in rs]
                             for run, rs in runs.items()}})
    return json.dumps({"kernels": kernels})


def print_sp(ref, ranks, deltas, n_params, card):
    """The sp leg's readings, each beside the cards' name and power
    limit."""
    for label, kernels in ref["flash"].items():
        print(f"  [{label}] {json.dumps(kernels)} ({card})", flush=True)
    runs = _sp_results(ref, ranks)
    want = [st["loss"] for st in runs["reference"][0]["steps"]]
    for run, rs in runs.items():
        for rank, r in enumerate(rs):
            print(f"  {run} rank {rank}: params {_held_bytes(r, 'params')} "
                  f"bytes, grads {r['steps'][-1]['grad_bytes']} bytes, "
                  f"moments {_held_bytes(r, 'moments')} bytes, "
                  f"max_memory_allocated {r['max_memory_bytes']} (before "
                  f"the steps {r['init_peak_bytes']}); build "
                  f"{r['build_s']:.1f} s, the run {r['seconds']:.1f} s; "
                  f"launches {json.dumps(r['counts'])} ({card})", flush=True)
        cards = len(rs)
        per_card = rs[0]["tokens_per_step"] / cards
        for i, st in enumerate(rs[0]["steps"]):
            wall = max(r["steps"][i]["seconds"] for r in rs)
            mfu = 6 * n_params * per_card / wall / PEAK_FLOPS
            rel = abs(st["loss"] - want[i]) / abs(want[i])
            print(f"  {run} step {st['step']}: loss {st['loss']:.6f} "
                  f"({rel:.3e} relative to the reference), step wall "
                  f"{wall:.4f} s (slowest rank), {per_card / wall:.1f} "
                  f"tokens/s a card, MFU {mfu:.4f} ({card})", flush=True)
    for run, d in deltas.items():
        misses = sum(e["misses"] for e in d["quarters"].values())
        leaves = {name.split("/", 1)[1]: [
            round(e["rel_fro"], 4), round(e["misses"] / e["elements"], 4)]
            for name, e in sorted(d["leaves"].items())}
        print(f"  {run} params after step {SP_STEPS}, each leaf's relative "
              f"error of the change from init against the reference's "
              f"(bound {SP_DELTA_REL_FRO}) and its share of sampled "
              f"changes past {SP_DELTA_ATOL} of the leaf's largest: "
              f"{json.dumps(leaves)};"
              f" {misses} of {d['elements']} past in all, {d['moved']} "
              f"moved", flush=True)


def _sp_leg(torch):
    """The four-card sp leg (module docstring)."""
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.run import llama_pretrain

    cfg = llama_pretrain.model_config("8b", SP_LAYERS)
    n_params = llama.param_count(cfg)
    card = "; ".join(sorted(set(nvidia_smi_line().splitlines())))
    workdir = tempfile.mkdtemp(prefix="chip_smoke_sp_")
    job = f"chip_smoke_sp_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    t0 = time.perf_counter()
    try:
        ref = _run_ranks("--sp-child", "sp", "reference", 1, workdir, job,
                         SP_TIMEOUT_S)[0]
        cases = sp_flash_cases(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        check([(label, k["case"]) for label, k in ref["flash"].items()]
              == cases, f"the reference child held the flash kernels at "
              f"{list(ref['flash'])}, not at every shape of {cases}")
        t1 = time.perf_counter()
        ranks = _run_ranks("--sp-child", "sp", "ranks", SP_WORLD, workdir,
                           job, SP_TIMEOUT_S)
        t2 = time.perf_counter()
        samples = {
            (run, kind): merge_samples([
                load_sample(workdir, run, r, kind)
                for r in range(SP_WORLD if run in SP_RUNS else 1)])
            for run in ("reference",) + tuple(SP_RUNS)
            for kind in ("init", "last")}
        deltas = {run: compare_delta(
            samples[("reference", "init")], samples[("reference", "last")],
            samples[(run, "init")], samples[(run, "last")],
            atol_frac=SP_DELTA_ATOL)
            for run in SP_RUNS}
        print_sp(ref, ranks, deltas, n_params, card)
        check_sp(ref, ranks, deltas)
        print(sp_kernels_line(ref, ranks), flush=True)
        print(f"  sp leg: the reference {t1 - t0:.1f} s, the four ranks "
              f"{t2 - t1:.1f} s, {time.perf_counter() - t0:.1f} s in all; "
              f"every check passed ({card})", flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main_four_card():
    """The four-card leg (module docstring)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from dlrover_tpu_torch.agent.elastic_agent import agent_log_dir
    from dlrover_tpu_torch.checkpoint.shm_handler import HEADER_SPACE
    from dlrover_tpu_torch.common.ipc import default_socket_path
    from dlrover_tpu_torch.models import llama
    from dlrover_tpu_torch.ops import cuda_build
    from dlrover_tpu_torch.run import llama_pretrain

    t_start = time.perf_counter()
    print("== four-card leg: devices", flush=True)
    count = torch.cuda.device_count()
    if count < FOUR_CARD_WORLD:
        raise SmokeFailure(f"--four-card needs {FOUR_CARD_WORLD} cards; "
                           f"this host has {count}")
    name = torch.cuda.get_device_name(0)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print("  " + out.stdout.strip().replace("\n", "\n  "), flush=True)
    print("== build", flush=True)
    print(f"  nvcc seconds: {cuda_build.build(cuda_build.sources())}",
          flush=True)
    print("== the four-card leg: NCCL dp4, a kill and a restore", flush=True)
    n_params = llama.param_count(llama_pretrain.model_config("8b", 4))
    nbytes = ckpt_state_bytes(n_params)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_four_")
    job = f"chip_smoke_four_{os.getpid()}_{uuid.uuid4().hex[:8]}"
    ckpt_dir = os.path.join(workdir, "ck")
    try:
        for cmd in (["df", "-B1", "/dev/shm"], ["df", "-B1", workdir]):
            out = subprocess.run(cmd, capture_output=True, text=True)
            print("  " + out.stdout.strip().replace("\n", "\n  "),
                  flush=True)
        with open("/proc/meminfo") as f:
            print("  " + [x for x in f if x.startswith("MemAvailable")][0]
                  .strip(), flush=True)
        shm_free = check_space("/dev/shm",
                               nbytes + FOUR_CARD_WORLD * HEADER_SPACE, "shm")
        disk_free = check_space(workdir, ckpt_disk_peak(nbytes), "disk")
        print(f"  state {n_params} params, {nbytes} bytes, a quarter a "
              f"rank staged; shm free {shm_free}, disk free {disk_free} "
              f"(peak need {ckpt_disk_peak(nbytes)})", flush=True)
        write_corpus(os.path.join(workdir, "corpus.bin"),
                     records=FOUR_CARD_RECORDS)
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.run.elastic_run",
               "--standalone", "--nnodes=1",
               f"--nproc_per_node={FOUR_CARD_WORLD}", "--max_restarts=1",
               "--tpu-timer",
               f"--tpu-timer-port={free_port_block(FOUR_CARD_WORLD)}",
               f"--job_name={job}", os.path.abspath(__file__), "--",
               "--ckpt-child", "four", ckpt_dir]
        print(f"  [four] {' '.join(cmd[1:])}", flush=True)
        proc, lines = _run_cli(cmd, env, "four", FOUR_CARD_TIMEOUT_S)
        lives = []
        for restart in (0, 1):
            life = []
            for rank in range(FOUR_CARD_WORLD):
                res, log = _life_result(job, restart, rank)
                for line in log:
                    print(f"  [four life {restart} rank {rank}] {line}",
                          flush=True)
                life.append(res)
            lives.append(life)
        first, second = lives
        check(proc.returncode == 0,
              f"the four-card CLI exited {proc.returncode}, not 0")
        check_no_actions(lines, "four-card kill leg")
        exit_line = [x for x in lines if "local master exiting:" in x]
        check(exit_line and "local master exiting: succeeded" in
              exit_line[-1], f"the master's exit: {exit_line}")
        check_four_card(first, second, nbytes)
        for r in first:
            print(f"  rank {r['rank']} staged {r['stage']['staged_bytes']} "
                  f"bytes of {nbytes} (skipped replica bytes "
                  f"{r['stage']['skipped_replica_bytes']}), pause "
                  f"{r['stage']['pause_s']:.4f} s, stage "
                  f"{r['stage']['stage_s']:.3f} s", flush=True)
        for r in second:
            print(f"  rank {r['rank']} restored step {r['restore']['step']} "
                  f"by tier {r['restore']['tier']} (rungs "
                  f"{r['restore']['tiers_read']}) in "
                  f"{r['restore']['seconds']:.3f} s, {r['restore']['bytes']} "
                  f"bytes; loader from step {r['loader_restored']}",
                  flush=True)
        print(f"  every rank's losses equal at every step; every leaf's "
              f"CRC32 ({len(first[0]['crc'])} leaves) equal across the "
              f"ranks after the restore and to the staged state; resumed "
              f"steps 3-4 bitwise the first life's; every kernel on every "
              f"rank in both lives", flush=True)
        tokens = first[0]["tokens_per_step"]
        for label, life in (("first", first), ("second", second)):
            for i, st in enumerate(life[0]["steps"]):
                wall = max(r["steps"][i]["seconds"] for r in life)
                print(f"  [{label} life] step {st['step']}: loss "
                      f"{st['loss']:.6f}, reduce_ms "
                      f"{[round(r['steps'][i]['reduce_ms'], 3) for r in life]}"
                      f", slowest rank {wall:.3f} s, global tokens/s "
                      f"{tokens / wall:.1f}", flush=True)
        killed = first[FOUR_CARD_KILL_RANK]
        seen_t = _agent_stamp(lines, "node 0: worker failed (exit -9)",
                              r"seen at ([0-9.]+)")
        persist_s = _agent_stamp(lines, "node 0: breakpoint persist True",
                                 r"in ([0-9.]+)s")
        rdzv_s = _agent_stamp(lines, "node 0: rendezvous round 2 in",
                              r"in ([0-9.]+)s")
        start_t = _agent_stamp(lines, "worker-0-restart1.log",
                               r" at ([0-9.]+) log=")
        lead = second[0]
        restored_t = max(r["restored_t"] for r in second)
        step3_t = max(r["steps"][0]["end_t"] - r["crc_s"] for r in second)
        phases = {
            "kill_to_detection_s": seen_t - killed["kill_t"],
            "breakpoint_persist_s": persist_s,
            "rendezvous_s": rdzv_s,
            "worker_start_to_restore_s": restored_t - start_t,
            "restore_to_step3_end_s": step3_t - restored_t,
        }
        print(f"  time to recover: {step3_t - killed['kill_t']:.3f}s from "
              f"the kill to the end of step 3 on the slowest rank; by phase "
              f"{json.dumps(phases)}; rank 0's restore "
              f"{lead['restore']['seconds']:.3f}s", flush=True)
        print(f"  [four] the master at its exit: "
              f"{json.dumps(master_reading(lines))}", flush=True)
        print_nccl_programs(first)
    finally:
        for pid in range(FOUR_CARD_WORLD):
            unlink_segment(job, pid)
        shutil.rmtree(workdir, ignore_errors=True)
        shutil.rmtree(os.path.dirname(agent_log_dir(job, 0)),
                      ignore_errors=True)
        shutil.rmtree(os.path.dirname(os.path.dirname(
            default_socket_path(job, 0))), ignore_errors=True)
    print("== the four-card leg: a collective hang, diagnosed and recovered",
          flush=True)
    _coll_hang_leg(torch)
    print("== the four-card leg: a planner-directed scale-out, dp2 -> dp4",
          flush=True)
    _scale_out_leg(torch)
    print("== the four-card leg: zero-1 against replicated at dp4, restored "
          "at dp2", flush=True)
    _zero1_leg(torch)
    print("== the four-card leg: the 32-layer Llama-3-8B at fsdp4, a killed "
          "rank restored from shm, and dp2 x fsdp2 under zero-1", flush=True)
    fsdp4_loss = _fsdp_leg(torch)
    print("== the four-card leg: the 32-layer Llama-3-8B at fsdp2 x tp2, and "
          "dp2 x tp2 under zero-1", flush=True)
    _tp_leg(torch, fsdp4_loss)
    print("== the four-card leg: Llama-3-8B widths (4 of 32 layers) at seq "
          f"{SP_SEQ}, sp4 ring, sp4 ulysses and fsdp2 x sp2 ring against "
          "one card", flush=True)
    _sp_leg(torch)
    print(f"== done in {time.perf_counter() - t_start:.1f}s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import attention, chunked_ce, cuda_build
    from dlrover_tpu_torch.ops import fused_ce as fce

    # count the chunked CE's calls where cross_entropy_sums reaches it
    chunked_calls = [0]
    real_chunked = fce.chunked_cross_entropy

    def counted_chunked(*args, **kwargs):
        chunked_calls[0] += 1
        return real_chunked(*args, **kwargs)

    fce.chunked_cross_entropy = counted_chunked

    t_start = time.perf_counter()
    print("== phase 1: device", flush=True)
    # full-f32 references: no TF32 in matmuls or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi_line()
    print(f"  {name}, capability {cap}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    print(f"  nvidia-smi: {smi}", flush=True)
    check(cap >= (9, 0), f"needs compute capability >= 9.0, got {cap}")

    print("== phase 2: build", flush=True)
    seconds = cuda_build.build(cuda_build.sources())
    print(f"  nvcc seconds: {seconds}", flush=True)
    for src in cuda_build.sources():
        log = cuda_build.library_path(src).with_suffix(".log").read_text()
        for kernel, usage in ptxas_usage(log):
            print(f"  ptxas {kernel}: {usage}", flush=True)
        # e.g. wgmma serialised where ptxas cannot keep a group in flight
        for line in log.splitlines():
            if "Performance Loss" in line:
                print(f"  ptxas: {line.strip()}", flush=True)
    sass = {}
    for src in cuda_build.sources():
        sass.update(sass_counts(cuda_build.library_path(src)))
    check_sass(sass)
    check_dkv_deterministic(torch, attention)

    print("== phase 3: kernels against their plain versions", flush=True)
    errors, inputs, tp_local = phase_kernels(torch, attention)
    times, sdpa_fwd, sdpa_bwd = phase_timing(torch, F, attention, inputs)
    del inputs
    tp_times = phase_tp_timing(torch, attention, tp_local)
    del tp_local
    bound = bounds(MAIN_CASE)
    for kname, (k_ms, p_ms) in times.items():
        print(f"  {kname}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{bound[kname][0]:.4f} ms ({bound[kname][1]})", flush=True)
    print(f"  library (graph replay): sdpa fwd {sdpa_fwd:.4f} ms, sdpa bwd "
          f"(dq, dk, dv together) {sdpa_bwd:.4f} ms", flush=True)
    bwd_ms = times["flash_bwd_dq"][0] + times["flash_bwd_dkv"][0]
    print(f"  flash_bwd_dq + flash_bwd_dkv: {bwd_ms:.4f} ms, "
          f"{bwd_ms / sdpa_bwd:.2f}x sdpa bwd", flush=True)
    ce_errors, ce_inputs_main = phase_ce_kernels(torch, fce)
    ce_times, whole, ce_bound = phase_ce_timing(torch, fce, chunked_ce,
                                                ce_inputs_main)
    del ce_inputs_main
    ce_flops = ce_work(CE_MAIN["n"], CE_MAIN["d"], CE_MAIN["v"], fce.BWD_CHUNK,
                       fce.FWD_TILE)
    for kname, (k_ms, p_ms, lib_ms) in ce_times.items():
        flops = ce_flops[kname][0]
        rate = (f", {flops / k_ms / 1e9:.1f} TFLOP/s" if flops is not None
                else "")
        lib = (f"{lib_ms:.4f} ms, kernel/library {k_ms / lib_ms:.2f}x"
               if lib_ms is not None else "none")
        print(f"  {kname}: {k_ms:.4f} ms{rate}, plain {p_ms:.4f} ms, bound "
              f"{ce_bound[kname][0]:.4f} ms ({ce_bound[kname][1]}), "
              f"{k_ms / ce_bound[kname][0]:.2f}x bound; library torch.mm "
              f"{lib}", flush=True)
    print(f"  whole CE forward + backward at n={CE_MAIN['n']} d={CE_MAIN['d']}"
          f" v={CE_MAIN['v']}: fused {whole[0]:.4f} ms, chunked "
          f"{whole[1]:.4f} ms", flush=True)

    print("== phase 4: main path (Llama-3-8B width, 4 of 32 layers)",
          flush=True)
    counts, main_result = phase_main_path(torch, attention, fce,
                                          chunked_calls)

    print("== phase 4b: ViT-B/16", flush=True)
    phase_vit(torch, attention, fce, chunked_calls)

    print("== phase 4c: flash checkpoint (Llama-3-8B width, 4 of 32 layers)",
          flush=True)
    phase_checkpoint(torch, attention, fce, chunked_calls, main_result)

    print("== phase 4d: the data plane (Llama-3-8B width, 4 of 32 layers)",
          flush=True)
    phase_data(torch, attention, fce, chunked_calls, main_result)

    print("== phase 4e: the control plane's recovery (Llama-3-8B width, 4 of "
          "32 layers)", flush=True)
    phase_control(torch)

    print("== phase 5: small-model reference (card bf16 vs cpu f32)",
          flush=True)
    for policy in ("all", "mlp"):
        phase_reference(torch, policy)
    phase_reference_vit(torch)

    kernels = []
    for kname, _, replaces in KERNELS:
        entry = {
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": errors[kname], "ms": times[kname][0],
            "plain_ms": times[kname][1], "bound_ms": bound[kname][0],
            "bound_by": bound[kname][1],
            "library_ms": sdpa_fwd if kname == "flash_fwd" else sdpa_bwd,
        }
        if kname != "flash_fwd":
            # one SDPA backward computes dq, dk and dv: the pair's yardstick
            entry["library_of"] = "pair"
        # the tp leg's local head counts, timed once each
        entry["tp_local"] = {label: tp_times[label][kname]
                             for label in TP_LOCAL_CASES}
        kernels.append(entry)
    for kname, _, replaces in CE_KERNELS:
        kernels.append({
            "name": kname, "route": "cuda", "source": CE_SOURCE,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": ce_errors[kname], "ms": ce_times[kname][0],
            "plain_ms": ce_times[kname][1], "bound_ms": ce_bound[kname][0],
            "bound_by": ce_bound[kname][1], "library_ms": ce_times[kname][2],
        })
    print(f"== done in {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--ckpt-child"]:
            sys.exit(ckpt_child(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--data-child"]:
            sys.exit(data_child(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--master-child"]:
            sys.exit(master_child(sys.argv[2]))
        if sys.argv[1:2] == ["--zero1-child"]:
            sys.exit(zero1_child(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--fsdp-child"]:
            sys.exit(fsdp_child(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--tp-child"]:
            sys.exit(tp_child(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--sp-child"]:
            sys.exit(sp_child(*sys.argv[2:4]))
        if sys.argv[1:2] == ["--four-card"]:
            sys.exit(main_four_card())
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
