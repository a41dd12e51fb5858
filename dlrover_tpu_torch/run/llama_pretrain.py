"""Llama pretraining on one card: the port's counterpart of
examples/llama_pretrain.py.

    python -m dlrover_tpu_torch.run.llama_pretrain --model 8b --layers 4 \\
        --seq 2048 --micro-batch 1 --global-batch 2 --steps 4

Random weights drawn from ``--seed``. Prints the loss of each step.
``--device cpu`` runs the plain PyTorch path in place of the kernels (use
``--model tiny`` there).

The tokens are synthetic, drawn from ``--seed``, unless ``--data FILE``
names a flat binary token file (``train/datasets.py``; ``--data-dtype``
uint16, uint32 or int32: Llama-3's vocabulary needs uint32). Then, as in
examples/llama_pretrain.py, every process draws the same global batch
through ``ElasticDistributedSampler`` (shuffled, seed 1, one replica) and
``ElasticDataLoader``, and ``prefetch_to_device`` keeps two batches in
flight on the device, each process copying only its own rows. With
``--ckpt-dir`` the loader's position rides a per-process sidecar,
``loader_state-<rank>.json``, written at every ``--save-every``-th step
through a temporary file and a rename; a restore loads it only when it is
not ahead of the restored step and every process holds the same step, so a
restore past the last sidecar replays data rather than skipping it. Two
differences from the JAX example, so that a resized world trains every
record once: a process the world grew by (dp2 -> dp4) has no sidecar of
its own and reads process 0's, the same position; and a sidecar ahead of
the restored step (the worker stepped on while the agent persisted the
breakpoint) is rewound by one global batch a step where the JAX example
replays the epoch from its start.

With ``--ckpt-dir``, flash checkpoint as examples/llama_pretrain.py runs it:
the state is restored at start (from shm, else the node-local disk, else
the shared tier) and training resumes at the restored step on the tokens
it would have drawn there; every step is saved to memory, and every
``--save-every``-th save is persisted to disk. Without it (the default)
nothing is saved.

Under the elastic agent (``run/elastic_run.py``, which sets
``DLROVER_TPU_MASTER_ADDR``), the run first bootstraps the worker
(``train/bootstrap.py::init``), as examples/llama_pretrain.py does: each
step is reported to the master, throttled, with a window of the trainer's
step-time digest and the seconds the steps waited for their batches, and
each save's step through the checkpoint's master client. ``--device
cuda`` then means the card of the worker's local rank. With more than one
process (``--nproc_per_node``), the processes train one global batch
data-parallel (``train/trainer.py``): each takes its rows, the gradients
are all-reduced. ``--zero1`` (or ``DLROVER_TPU_ZERO1``, which overrides it
in both directions, as in the JAX example) shards the weight update over
dp (train/zero1.py) on the worker's pure-dp mesh, which the trainer
builds (``bootstrap.worker_mesh``): the gradients are reduce-scattered,
adam's moments hold 1/dp each, the params are all-gathered. At dp 1 the
update runs replicated (mode ``off``), and the run says so.
``--fsdp N``, the JAX example's flag, trains on the mesh
``MeshConfig(dp=-1, fsdp=N)`` (dp absorbs the rest of the world;
``bootstrap.worker_mesh``): the params are born sharded (each rank holds
``1/N`` of every matrix, models/llama.py), gathered layer by layer, and
their gradients reduce-scattered; with ``--zero1`` and dp above 1 the
update is also sharded over dp (mode ``gspmd``). The run logs its mesh.
``--tp N``, the JAX example's other flag, splits the heads, the ffn
columns and the vocabulary over N ranks (Megatron's recipe,
models/llama.py) on ``MeshConfig(dp=-1, fsdp=F, tp=N)``, beside
``--fsdp F``: ``--fsdp 2 --tp 2`` on four processes is the JAX example's
layout; the ranks of a tp group train the same rows. With ``--zero1`` and
dp above 1 the update is sharded over dp (mode ``gspmd``).
``--sp N``, the JAX example's third model axis, splits every row's
positions over N ranks (``MeshConfig(dp=-1, fsdp=F, sp=N, tp=T)``): each
trains its contiguous chunk of ``--seq / N`` positions of the same rows,
its attention running ring attention over the sp group, or ulysses with
``--attn-impl ulysses`` (the config's ``attn_impl``; models/llama.py).
``--model 8b --layers 0`` is the preset's whole depth, 32 layers.
Run bare, it trains alone.

The result's ``tokens_per_s`` is the global batch's tokens a second of
step wall after the first step, each token counted once whatever the
ranks it is split over; ``tokens_per_s_per_card`` divides it over every
card of the world, tp and sp ranks included, and ``mfu`` is
``6 · params · tokens_per_s_per_card`` over the card's bf16 dense peak
(``profiler/tpu_timer.py::peak_bf16_tflops``; None on the CPU).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.parallel.mesh import DP, MeshConfig, axis_sizes
from dlrover_tpu_torch.profiler.tpu_timer import peak_bf16_tflops
from dlrover_tpu_torch.train import bootstrap, zero1
from dlrover_tpu_torch.train.data import (
    ElasticDataLoader,
    ElasticDistributedSampler,
    prefetch_to_device,
)
from dlrover_tpu_torch.train.datasets import TokenFileDataset
from dlrover_tpu_torch.train.trainer import (
    ElasticTrainer,
    TrainConfig,
    batch_leaves,
)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("llama_pretrain")
    p.add_argument("--model", default="tiny", choices=["tiny", "8b"])
    p.add_argument("--layers", type=int, default=0,
                   help="0 = the preset's depth")
    p.add_argument("--seq", type=int, default=0,
                   help="0 = min(2048, the preset's max_seq_len)")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup-steps", type=int,
                   default=TrainConfig.warmup_steps,
                   help="linear lr warmup steps (0 = none)")
    p.add_argument("--micro-batch", type=int, default=1)
    p.add_argument("--global-batch", type=int, default=0,
                   help="0 = one microbatch per step")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default="",
                   help="flash checkpoint directory; empty = no checkpoint")
    p.add_argument("--save-every", type=int, default=10,
                   help="persist every Nth memory save to disk, and write "
                   "the loader's sidecar at those steps (0 = never)")
    p.add_argument("--data", default="",
                   help="flat binary token file (train/datasets.py); "
                   "empty = synthetic tokens")
    p.add_argument("--data-dtype", default="uint16",
                   choices=["uint16", "uint32", "int32"])
    p.add_argument("--zero1", action="store_true",
                   help="ZeRO-1 weight-update sharding across dp "
                   "(train/zero1.py; DLROVER_TPU_ZERO1 overrides)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp (ZeRO-3) size of the mesh; dp absorbs the "
                   "rest of the world")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel size of the mesh (heads, ffn "
                   "columns and vocabulary split over it)")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel size of the mesh (each row's "
                   "positions split over it)")
    p.add_argument("--attn-impl", default="auto", choices=llama.ATTN_IMPLS,
                   help="the model's attention: auto is ring on an sp mesh, "
                   "else flash")
    return p.parse_args(argv)


def model_config(name: str, layers: int,
                 attn_impl: str = "auto") -> llama.LlamaConfig:
    cfg = (llama.LlamaConfig.tiny() if name == "tiny"
           else llama.LlamaConfig.llama3_8b())
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, attn_impl=attn_impl)


def build(args: argparse.Namespace, device=None, worker_ctx=None):
    """The trainer, its state and a synthetic batch maker for ``args``;
    returns ``(cfg, trainer, state, next_batch, tokens_per_step)``.
    ``next_batch`` draws the global batch (the same on every process) and
    returns this process's rows; ``tokens_per_step`` counts the global
    batch's tokens. ``device``: ``args.device`` when None. ``worker_ctx``:
    the worker's bootstrap context, through which the trainer polls the
    runtime config and the planner's hint."""
    device = resolve_device(args.device if device is None else device)
    cfg = model_config(args.model, args.layers, args.attn_impl)
    seq = args.seq or min(2048, cfg.max_seq_len)
    tc = TrainConfig(
        global_batch_size=args.global_batch or args.micro_batch,
        micro_batch_size=args.micro_batch,
        total_steps=args.steps,
        warmup_steps=args.warmup_steps,
        zero1=args.zero1,
    )
    mesh = None
    if args.fsdp > 1 or args.sp > 1 or args.tp > 1:
        mesh = bootstrap.worker_mesh(
            device.type, MeshConfig(fsdp=args.fsdp, sp=args.sp, tp=args.tp))
        if mesh is None:
            raise ValueError(
                f"--fsdp {args.fsdp} --sp {args.sp} --tp {args.tp} needs a "
                "process group of a multiple of their product; this world "
                "has one process")
    trainer = ElasticTrainer(lambda p, t: llama.loss_fn(p, t, cfg, mesh), tc,
                             lambda p, t: llama.loss_sums(p, t, cfg, mesh),
                             worker_ctx=worker_ctx, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = trainer.init_state(llama.init_params(cfg, gen, mesh))
    a, b = trainer.step_batch_shape
    data_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    def next_batch():
        return trainer.local_rows(torch.randint(
            0, cfg.vocab_size, (a, b, seq), generator=data_gen,
            device=device))

    return cfg, trainer, state, next_batch, a * b * seq


def timed_step(trainer, state, batch):
    """One step, timed on the host clock up to the loss reaching the host
    (which waits for the device); returns ``(state, loss, seconds)``.
    ``batch`` is a tensor or a tree of tensors."""
    leaf = batch_leaves(batch)[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    t0 = time.perf_counter()
    state, loss = trainer.step(state, batch)
    loss = float(loss)
    return state, loss, time.perf_counter() - t0


def open_checkpoint(args: argparse.Namespace, state: dict, next_batch,
                    log=print):
    """The run's ``Checkpointer`` (None without ``--ckpt-dir``), the step
    to start at, and the restore's ``{"step", "tier", "seconds", ...}``
    (None when nothing was restored). A restore overwrites ``state``'s
    tensors in place, and the synthetic stream ``next_batch`` skips the
    batches the restored steps consumed, so a resumed run sees what an
    uninterrupted one would (None: a token file's loader, which its
    sidecar positions instead)."""
    if not args.ckpt_dir:
        return None, 0, None
    ckpt = Checkpointer(args.ckpt_dir, save_storage_interval=args.save_every)
    restored = ckpt.load(target=state)
    if restored is None:
        return ckpt, 0, None
    start = restored[0]
    for _ in range(start if next_batch is not None else 0):
        next_batch()
    info = {"step": start, **ckpt.last_restore_stats}
    log(f"restored step {start} (tier {info['tier']}, "
        f"{info['seconds']:.3f}s)")
    return ckpt, start, info


def sidecar_path(ckpt_dir: str, rank: int) -> str:
    """The loader position's sidecar of process ``rank`` (the JAX
    example's name and JSON: ``{"step", "loader": {"epoch",
    "completed_samples"}}``)."""
    return os.path.join(ckpt_dir, f"loader_state-{rank}.json")


def write_sidecar(path: str, step: int, loader_pos: dict):
    """Atomically (a temporary file, then a rename) record the loader's
    position after ``step``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"step": step, "loader": loader_pos}, f)
    os.replace(tmp, path)


def read_sidecar(path: str, restored_step: int,
                 global_batch: int = 0) -> Optional[dict]:
    """The sidecar to resume the loader from, or None: a torn or missing
    file, or processes that disagree (every process must load the same
    position or none, as each draws the identical global batch) give None.
    A sidecar ahead of the restored step (the persist is async: a crash
    inside that window must replay data, never skip it) is rewound by the
    ``global_batch`` samples of each step in between when they lie in its
    epoch (every step consumes one global batch of the one-replica
    sampler, whatever the dp), else, or without ``global_batch``, gives
    None, as the JAX example does."""
    side = None
    if os.path.exists(path):
        try:
            with open(path) as f:
                side = json.load(f)
        except ValueError:
            side = None  # torn write: fall back to the epoch's start
    if side is not None and side.get("step", 0) > restored_step:
        ahead = int(side["step"]) - restored_step
        loader = dict(side.get("loader") or {})
        done = int(loader.get("completed_samples", 0)) - ahead * global_batch
        if global_batch > 0 and done >= 0:
            side = {"step": restored_step,
                    "loader": {**loader, "completed_samples": done}}
        else:
            side = None
    steps = bootstrap.process_allgather(
        side["step"] if side is not None else -1)
    if any(s != steps[0] for s in steps) or steps[0] < 0:
        return None
    return side


def open_data(args: argparse.Namespace, cfg, trainer, seq: int, device,
              restored_step: Optional[int], log=print):
    """The token file's loader flow of examples/llama_pretrain.py: returns
    ``(batches, positions, loader_restored)``. ``batches`` yields each
    step's batch, this process's rows, on ``device`` (two in flight);
    ``positions`` holds the loader's position after each produced batch
    (prefetch pulls ahead, so the step pops the position of the batch it
    trains); ``loader_restored`` is the sidecar's step, or None."""
    a, b = trainer.step_batch_shape
    dataset = TokenFileDataset(args.data, seq_len=seq, dtype=args.data_dtype)
    dataset.validate_vocab(cfg.vocab_size)
    if len(dataset) < a * b:
        raise SystemExit(
            f"--data has only {len(dataset)} sequences of seq={seq}; need "
            f"at least one global batch of {a * b}")
    # every process draws the IDENTICAL global batch (num_replicas=1) and
    # takes its rows of it
    sampler = ElasticDistributedSampler(
        dataset_size=len(dataset), batch_size=a * b, num_replicas=1,
        rank=0, shuffle=True, seed=1)
    loader = ElasticDataLoader(
        dataset, batch_size=a * b, sampler=sampler,
        collate=lambda xs: np.stack(xs).reshape(a, b, seq))
    loader_restored = None
    if restored_step is not None:
        path = sidecar_path(args.ckpt_dir, bootstrap.process_index())
        if not os.path.exists(path):
            # a process the world grew by has no sidecar of its own; every
            # process draws the identical global batch, so process 0's
            # position is this one's too (the JAX example replays the
            # epoch from its start there)
            path = sidecar_path(args.ckpt_dir, 0)
        side = read_sidecar(path, restored_step, a * b)
        if side is not None:
            loader.load_state_dict(side["loader"])
            loader_restored = side["step"]
            log(f"loader position restored (step {loader_restored})")
    positions = collections.deque()

    def host_batches():
        while True:  # loop epochs; the step budget bounds the run
            for batch in loader:
                positions.append(loader.state_dict())
                yield batch

    rows = trainer.rows if trainer.dp > 1 else None
    return (prefetch_to_device(host_batches(), 2, device, rows=rows),
            positions, loader_restored)


def run(args: argparse.Namespace, log=print) -> dict:
    """Train up to step ``args.steps``; returns the losses, per-step
    seconds, each step's wait for its batch (``data_wait_s``), at dp above
    1 on the card each step's gradient all-reduce in device ms
    (``reduce_ms``, from the compute stream reaching it to its end),
    tokens/s of the global batch over the steps after the first, and peak
    device memory; with ``--ckpt-dir`` also the restore (``None`` when nothing
    was restored) and each save's step, blocking seconds, stage mode and
    background stage stats (``CheckpointEngine.last_stage_stats``); with
    ``--data`` the step of the sidecar the loader resumed from
    (``loader_restored``, None when it started at the epoch's start)."""
    ctx = bootstrap.init() if flags.MASTER_ADDR.get() else None
    device = args.device
    if ctx is not None and device == "cuda":
        device = f"cuda:{ctx.local_rank}"
    cfg, trainer, state, next_batch, tokens = build(args, device, ctx)
    if trainer.mesh is not None:
        log(f"mesh {trainer.world_descriptor().spec}")
    if zero1.enabled(trainer.tc):
        dp = (axis_sizes(trainer.mesh).get(DP, 1) if trainer.mesh is not None
              else trainer.dp)
        log(f"zero-1 mode {trainer.zero1_mode} at dp {dp}")
    seq = args.seq or min(2048, cfg.max_seq_len)
    if args.data:
        ckpt, start, restore = open_checkpoint(args, state, None, log)
        batches, positions, loader_restored = open_data(
            args, cfg, trainer, seq, device,
            None if restore is None else start, log)
        next_batch = batches.__next__
    else:
        ckpt, start, restore = open_checkpoint(args, state, next_batch, log)
        positions, loader_restored = None, None
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, step_s, waits, saves, reduce_ms = [], [], [], [], []
    for step in range(start, args.steps):
        t0 = time.perf_counter()
        batch = next_batch()
        waits.append(time.perf_counter() - t0)
        loader_pos = positions.popleft() if positions is not None else None
        state, loss, seconds = timed_step(trainer, state, batch)
        losses.append(loss)
        step_s.append(seconds)
        reduce = ""
        if trainer.reduce_events is not None:
            begin, end = trainer.reduce_events
            reduce_ms.append(begin.elapsed_time(end))
            reduce = f", gradient all-reduce {reduce_ms[-1]:.2f} ms"
        log(f"step {step + 1} loss {loss:.4f} ({seconds:.3f}s{reduce})")
        if ctx is not None:
            ctx.add_input_wait(waits[-1])
            ctx.report_step(step + 1, force=step + 1 == args.steps,
                            digest=trainer.step_digest)
        if ckpt is not None:
            blocking = ckpt.save(step + 1, state)
            saves.append({"step": step + 1, "blocking_s": blocking,
                          "mode": ckpt.last_stage_mode})
            if (loader_pos is not None and args.save_every
                    and (step + 1) % args.save_every == 0):
                write_sidecar(sidecar_path(args.ckpt_dir,
                                           bootstrap.process_index()),
                              step + 1, loader_pos)
    if ckpt is not None:
        ckpt.close()
        stages = {s["step"]: s for s in ckpt.stage_log}
        for save in saves:
            save["stage"] = stages.get(save["step"])
    steady = step_s[1:] or step_s
    rate = tokens * len(steady) / sum(steady) if steady else None
    per_card = None if rate is None else rate / bootstrap.process_count()
    peak = peak_bf16_tflops(torch.cuda.get_device_name(
        torch.device(device))) if cuda else 0.0
    return {
        "params": llama.param_count(cfg),
        "tokens_per_step": tokens,
        "start_step": start,
        "losses": losses,
        "step_s": step_s,
        "data_wait_s": waits,
        "reduce_ms": reduce_ms,
        "tokens_per_s": rate,
        "tokens_per_s_per_card": per_card,
        "mfu": (6 * llama.param_count(cfg) * per_card / (peak * 1e12)
                if per_card is not None and peak > 0 else None),
        "max_memory_bytes": (torch.cuda.max_memory_allocated()
                             if cuda else None),
        "restore": restore,
        "saves": saves,
        "loader_restored": loader_restored,
        "zero1_mode": trainer.zero1_mode,
    }


def main(argv: Optional[List[str]] = None) -> None:
    result = run(parse_args(argv))
    rate = result["tokens_per_s"]
    print(f"params {result['params']} tokens/s "
          f"{'-' if rate is None else f'{rate:.1f}'} "
          f"max_memory_bytes {result['max_memory_bytes']} "
          f"losses {result['losses']}", flush=True)


if __name__ == "__main__":
    main()
