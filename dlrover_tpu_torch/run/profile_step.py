"""Where the device time of a training step goes.

    python -m dlrover_tpu_torch.run.profile_step --model 8b --layers 4 \\
        --seq 2048 --micro-batch 1 --global-batch 2 --steps 3 \\
        --out chiprun_out/profile_step.json

Builds the trainer of ``run/llama_pretrain.py``, takes one warm-up step
(library load, cuBLAS heuristics), then profiles ``--steps - 1`` steps
with ``torch.profiler`` and reports, per step:

- device time inside each scope the port names (``attention_fwd``,
  ``attention_bwd``, ``fused_ce_fwd``, ``fused_ce_bwd``, and
  ``chunked_ce_fwd`` / ``chunked_ce_bwd`` under ``DLROVER_TPU_FUSED_CE=0``,
  ``optimizer_update``) and the rest (layer matmuls, norms, rope,
  embedding, gradient accumulation);
- device time by kernel family (the port's flash and fused-CE kernels,
  cuBLAS GEMMs, everything else) and the top kernels by name;
- for each of the port's kernels (by name, a template by its head dim),
  its device ms and launches a step and its mean device ms a launch;
- the device's busy share of the profiled host wall time (the union of
  kernel and copy intervals), and so its idle share; and the busy time
  against the median wall time of as many steps again taken without the
  profiler, which slows the host.

Needs the card: the profiler's device timeline is the point.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import statistics
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dlrover_tpu_torch.run import llama_pretrain

SCOPES = ("attention_fwd", "attention_bwd", "fused_ce_fwd", "fused_ce_bwd",
          "chunked_ce_fwd", "chunked_ce_bwd", "optimizer_update")
GEMM_MARKERS = ("gemm", "nvjet", "cutlass", "xmma", "cublas")


def _device_us(evt) -> float:
    total = getattr(evt, "device_time_total", None)
    return total if total is not None else evt.cuda_time_total


def _family(name: str) -> str:
    low = name.lower()
    if "flash_" in low and "kernel" in low:
        return "flash kernels (port)"
    if "fused_ce_" in low and "kernel" in low:
        return "fused-CE kernels (port)"
    if any(m in low for m in GEMM_MARKERS):
        return "cuBLAS GEMM"
    return "other (elementwise, reductions, copies)"


def _busy_us(intervals: List[tuple]) -> float:
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def _scope_of(start: float, spans: List[tuple]) -> str:
    """The scope whose device-side span holds a kernel starting at
    ``start`` (spans sorted by start), or the rest of the step."""
    i = bisect.bisect_right(spans, (start, float("inf"), "")) - 1
    while i >= 0:
        s0, s1, name = spans[i]
        if s0 <= start < s1:
            return name
        if s1 <= start and s0 < start - 1e6:
            break
        i -= 1
    return "rest of the step"


def summarize(prof, steps: int, wall_s: float, top: int = 12) -> dict:
    """Device time by scope, by kernel family and by kernel. The profiler
    also lays each ``record_function`` range on the device timeline; those
    spans only attribute kernels and are never summed themselves."""
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in device if e.name in SCOPES)
    kernels = [e for e in device if e.name not in SCOPES
               and not getattr(e, "is_user_annotation", False)]
    kernel_us = sum(e.time_range.elapsed_us() for e in kernels)
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    by_name: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    families: Dict[str, float] = {}
    scopes: Dict[str, float] = {key: 0.0 for key in SCOPES}
    scopes["rest of the step"] = 0.0
    by_scope_kernel: Dict[str, Dict[str, float]] = {k: {} for k in scopes}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        launches[e.name] = launches.get(e.name, 0) + 1
        fam = _family(e.name)
        families[fam] = families.get(fam, 0.0) + us
        scope = _scope_of(e.time_range.start, spans)
        scopes[scope] += us
        inner = by_scope_kernel[scope]
        inner[e.name] = inner.get(e.name, 0.0) + us

    def per_step(us: float) -> float:  # microseconds in total -> ms a step
        return us / steps / 1e3

    def top_of(table: Dict[str, float], n: int):
        return [(name[:100], per_step(us)) for name, us in
                sorted(table.items(), key=lambda kv: -kv[1])[:n]]

    port = {}
    for name, us in by_name.items():
        m = re.search(r"((?:flash|fused_ce)_\w+?_kernel(?:<\d+>)?)", name)
        if m and _family(name).endswith("(port)"):
            port[m.group(1)] = {
                "ms_per_step": per_step(us),
                "launches_per_step": launches[name] / steps,
                "ms_per_launch": us / launches[name] / 1e3,
            }

    return {
        "steps_profiled": steps,
        "wall_ms_per_step": wall_s / steps * 1e3,
        "device_kernel_ms_per_step": per_step(kernel_us),
        "device_busy_ms_per_step": per_step(busy_us),
        "device_idle_share": 1.0 - busy_us / (wall_s * 1e6),
        "scopes_ms_per_step": {k: per_step(v) for k, v in scopes.items()},
        "families_ms_per_step": {k: per_step(v) for k, v in families.items()},
        "top_kernels_ms_per_step": top_of(by_name, top),
        "port_kernels": dict(sorted(port.items())),
        "top_kernels_by_scope_ms_per_step": {
            k: top_of(v, 4) for k, v in by_scope_kernel.items()},
    }


def main(argv: Optional[List[str]] = None) -> dict:
    parser = argparse.ArgumentParser("profile_step")
    parser.add_argument("--out", default="",
                        help="also write the summary to this JSON file")
    ours, rest = parser.parse_known_args(argv)
    args = llama_pretrain.parse_args(rest)
    if args.steps < 2:
        raise SystemExit("--steps must be >= 2 (one warm-up step)")
    _, trainer, state, next_batch, tokens = llama_pretrain.build(args)
    state, loss, seconds = llama_pretrain.timed_step(
        trainer, state, next_batch())
    print(f"warm-up step loss {loss:.4f} ({seconds:.3f}s)", flush=True)
    batches = [next_batch() for _ in range(args.steps - 1)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            state, loss = trainer.step(state, batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    summary = summarize(prof, len(batches), wall_s)
    # the profiler slows the host; as many steps again without it give
    # the wall the device's busy time should be read against (median)
    walls = []
    for batch in batches:
        state, loss, seconds = llama_pretrain.timed_step(trainer, state, batch)
        walls.append(seconds * 1e3)
    unprofiled = statistics.median(walls)
    summary["unprofiled_step_ms"] = unprofiled
    summary["device_busy_share_of_unprofiled_step"] = (
        summary["device_busy_ms_per_step"] / unprofiled)
    summary["tokens_per_step"] = tokens
    summary["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(summary, indent=1), flush=True)
    if ours.out:
        with open(ours.out, "w") as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
