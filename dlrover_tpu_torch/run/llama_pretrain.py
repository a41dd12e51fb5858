"""Llama pretraining on one card: the port's counterpart of
examples/llama_pretrain.py.

    python -m dlrover_tpu_torch.run.llama_pretrain --model 8b --layers 4 \\
        --seq 2048 --micro-batch 1 --global-batch 2 --steps 4

Synthetic tokens and random weights, both drawn from ``--seed``. Prints the
loss of each step. ``--device cpu`` runs the plain PyTorch path in place of
the kernels (use ``--model tiny`` there).

With ``--ckpt-dir``, flash checkpoint as examples/llama_pretrain.py runs it:
the state is restored at start (from shm, else the node-local disk, else
the shared tier) and training resumes at the restored step on the tokens
it would have drawn there; every step is saved to memory, and every
``--save-every``-th save is persisted to disk. Without it (the default)
nothing is saved.

Under the elastic agent (``run/elastic_run.py``, which sets
``DLROVER_TPU_MASTER_ADDR``), the run first bootstraps the worker
(``train/bootstrap.py::init``), as examples/llama_pretrain.py does: each
step is reported to the master, throttled, and each save's step through
the checkpoint's master client. Run bare, it trains alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import torch

from dlrover_tpu_torch.checkpoint.checkpointer import Checkpointer
from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.train import bootstrap
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
    p.add_argument("--micro-batch", type=int, default=1)
    p.add_argument("--global-batch", type=int, default=0,
                   help="0 = one microbatch per step")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default="",
                   help="flash checkpoint directory; empty = no checkpoint")
    p.add_argument("--save-every", type=int, default=10,
                   help="persist every Nth memory save to disk (0 = never)")
    return p.parse_args(argv)


def model_config(name: str, layers: int) -> llama.LlamaConfig:
    cfg = (llama.LlamaConfig.tiny() if name == "tiny"
           else llama.LlamaConfig.llama3_8b())
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return cfg


def build(args: argparse.Namespace):
    """The trainer, its state and a batch maker for ``args``; returns
    ``(cfg, trainer, state, next_batch, tokens_per_step)``."""
    device = resolve_device(args.device)
    cfg = model_config(args.model, args.layers)
    seq = args.seq or min(2048, cfg.max_seq_len)
    tc = TrainConfig(
        global_batch_size=args.global_batch or args.micro_batch,
        micro_batch_size=args.micro_batch,
        total_steps=args.steps,
    )
    trainer = ElasticTrainer(lambda p, t: llama.loss_fn(p, t, cfg), tc)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = trainer.init_state(llama.init_params(cfg, gen))
    a, b = trainer.step_batch_shape
    data_gen = torch.Generator(device=device).manual_seed(args.seed + 1)

    def next_batch():
        return torch.randint(0, cfg.vocab_size, (a, b, seq),
                             generator=data_gen, device=device)

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
    tensors in place, and the token stream skips the batches the restored
    steps consumed, so a resumed run sees what an uninterrupted one
    would."""
    if not args.ckpt_dir:
        return None, 0, None
    ckpt = Checkpointer(args.ckpt_dir, save_storage_interval=args.save_every)
    restored = ckpt.load(target=state)
    if restored is None:
        return ckpt, 0, None
    start = restored[0]
    for _ in range(start):
        next_batch()
    info = {"step": start, **ckpt.last_restore_stats}
    log(f"restored step {start} (tier {info['tier']}, "
        f"{info['seconds']:.3f}s)")
    return ckpt, start, info


def run(args: argparse.Namespace, log=print) -> dict:
    """Train up to step ``args.steps``; returns the losses, per-step
    seconds, tokens/s over the steps after the first, and peak device
    memory; with ``--ckpt-dir`` also the restore (``None`` when nothing
    was restored) and each save's step, blocking seconds, stage mode and
    background stage stats (``CheckpointEngine.last_stage_stats``)."""
    ctx = bootstrap.init() if flags.MASTER_ADDR.get() else None
    cfg, trainer, state, next_batch, tokens = build(args)
    ckpt, start, restore = open_checkpoint(args, state, next_batch, log)
    cuda = args.device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, step_s, saves = [], [], []
    for step in range(start, args.steps):
        state, loss, seconds = timed_step(trainer, state, next_batch())
        losses.append(loss)
        step_s.append(seconds)
        log(f"step {step + 1} loss {loss:.4f} ({seconds:.3f}s)")
        if ctx is not None:
            ctx.report_step(step + 1, force=step + 1 == args.steps)
        if ckpt is not None:
            blocking = ckpt.save(step + 1, state)
            saves.append({"step": step + 1, "blocking_s": blocking,
                          "mode": ckpt.last_stage_mode})
    if ckpt is not None:
        ckpt.close()
        stages = {s["step"]: s for s in ckpt.stage_log}
        for save in saves:
            save["stage"] = stages.get(save["step"])
    steady = step_s[1:] or step_s
    return {
        "params": llama.param_count(cfg),
        "tokens_per_step": tokens,
        "start_step": start,
        "losses": losses,
        "step_s": step_s,
        "tokens_per_s": (tokens * len(steady) / sum(steady) if steady
                         else None),
        "max_memory_bytes": (torch.cuda.max_memory_allocated()
                             if cuda else None),
        "restore": restore,
        "saves": saves,
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
