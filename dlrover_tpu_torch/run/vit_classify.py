"""ViT image classification on one card: the port's counterpart of
examples/vit_classify.py.

    python -m dlrover_tpu_torch.run.vit_classify --model b16 \\
        --micro-batch 64 --global-batch 128 --steps 4

Synthetic NHWC images and labels and random weights, all drawn from
``--seed``. Prints the loss of each step. ``--device cpu`` runs the plain
PyTorch path in place of the kernels (use ``--model tiny`` there). No
checkpointing: the flash checkpoint is not ported yet.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from dlrover_tpu_torch.common.device import resolve_device
from dlrover_tpu_torch.models import vit
from dlrover_tpu_torch.run.llama_pretrain import timed_step
from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("vit_classify")
    p.add_argument("--model", default="tiny", choices=["tiny", "b16"])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--micro-batch", type=int, default=4)
    p.add_argument("--global-batch", type=int, default=0,
                   help="0 = one microbatch per step")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def build(args: argparse.Namespace):
    """The trainer, its state and a batch maker for ``args``; returns
    ``(cfg, trainer, state, next_batch, images_per_step)``."""
    device = resolve_device(args.device)
    cfg = vit.ViTConfig.tiny() if args.model == "tiny" else \
        vit.ViTConfig.base_16()
    tc = TrainConfig(
        global_batch_size=args.global_batch or args.micro_batch,
        micro_batch_size=args.micro_batch,
        total_steps=args.steps, learning_rate=1e-3,
    )
    trainer = ElasticTrainer(lambda p, b: vit.loss_fn(p, b, cfg), tc)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = trainer.init_state(vit.init_params(cfg, gen))
    a, b = trainer.step_batch_shape
    data_gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    shape = (a, b, cfg.image_size, cfg.image_size, cfg.channels)

    def next_batch():
        images = torch.randn(shape, generator=data_gen, device=device)
        labels = torch.randint(0, cfg.n_classes, (a, b), generator=data_gen,
                               device=device)
        return images, labels

    return cfg, trainer, state, next_batch, a * b


def run(args: argparse.Namespace, log=print) -> dict:
    """Train ``args.steps`` steps; returns the losses, per-step seconds,
    images/s over the steps after the first, and peak device memory."""
    cfg, trainer, state, next_batch, images = build(args)
    cuda = args.device != "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for step in range(args.steps):
        state, loss, seconds = timed_step(trainer, state, next_batch())
        losses.append(loss)
        step_s.append(seconds)
        log(f"step {step + 1} loss {loss:.4f} ({seconds:.3f}s)")
    steady = step_s[1:] or step_s
    return {
        "params": vit.param_count(cfg),
        "images_per_step": images,
        "losses": losses,
        "step_s": step_s,
        "images_per_s": images * len(steady) / sum(steady),
        "max_memory_bytes": (torch.cuda.max_memory_allocated()
                             if cuda else None),
    }


def main(argv: Optional[List[str]] = None) -> None:
    result = run(parse_args(argv))
    print(f"params {result['params']} images/s {result['images_per_s']:.1f} "
          f"max_memory_bytes {result['max_memory_bytes']}", flush=True)


if __name__ == "__main__":
    main()
