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
   head dim 64) and one of group 8 (s 300: every dk/dv tile takes the
   most query heads, and both the 64- and 128-row tiles are cut); each
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
   power draw are printed after it. Last, the whole forward and backward
   of the fused CE against the chunked CE at the main-path shape.
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
   run's inline persist. Under a second saver, a child trains 2 steps,
   saves step 2 to memory, prints the CRC32 of every leaf it staged and
   is SIGKILLed; the saver's breakpoint persist (``save_shm_to_storage``)
   must commit step 2 with every manifest CRC equal to the killed
   child's; a child must restore step 2 from shm with every CRC equal and
   train steps 3-4 to the losses of the uninterrupted runs (phase 4's and
   the save run's) within ``CKPT_RESUME_SPREAD_FACTOR`` times their
   spread; and, with the segment unlinked, a child must restore step 2
   from the breakpoint persist on disk with every leaf's CRC32 equal to
   what the killed child staged. The phase's shm segment and socket are
   named for this run (pid and a random suffix), so two runs on one
   machine never share them. Bounds are printed beside the times.
5. reference: a small Llama (head dim 128) and a small ViT (head dim 64,
   100 patches, 300 classes) on the card, bf16 with the kernels, against
   the same weights on the CPU in f32 with the plain versions: loss and
   every gradient (Llama under remat "all" and "mlp").
6. output: one JSON line of the kernels, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Exits with code 2 and prints no result when CUDA is not available.
``--ckpt-child ROLE DIR`` runs one of phase 4c's children (it is not run
by hand).
"""

import dataclasses
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
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
]


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


# flash checkpoint (phase 4c). The resumed run's steps 3-4 against an
# uninterrupted run's: not bitwise, since flash dk/dv add a GQA group's
# heads by atomics in an order that varies, so the tolerance is this factor
# times the largest difference between two uninterrupted runs of the same
# call at steps 3-4, and never under the floor (about ten f32 ulps of a
# loss of 12.6), since one pair's spread may come out zero
CKPT_RESUME_SPREAD_FACTOR = 4.0
CKPT_RESUME_LOSS_FLOOR = 1e-5
CKPT_CHILD_TIMEOUT_S = 600
# seconds the saver gets to copy, fan out and commit a persisted step (at
# the disk's 0.7-0.9 GB/s, two tiers of 23.1 GB take about a minute)
CKPT_COMMIT_TIMEOUT_S = 600
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


# the kernels that run wgmma with TMA loads (HGMMA and UTMALDG in their
# SASS), and those that must show neither; every kernel is in one of them
WGMMA_KERNELS = ("fused_ce_fwd", "fused_ce_bwd_q", "fused_ce_bwd_dx",
                 "fused_ce_bwd_dw", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dkv")
NO_WGMMA_KERNELS = ("fused_ce_merge",)


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
    """Each kernel of KERNELS and CE_KERNELS is in the SASS; every instance
    of a WGMMA_KERNELS kernel has HGMMA and UTMALDG, every instance of a
    NO_WGMMA_KERNELS kernel has neither."""
    for kname in [k for k, _, _ in KERNELS + CE_KERNELS]:
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


def phase_kernels(torch, attention):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    errors = {}
    timing = None
    for label, case in CASES:
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
        for name, outs in results.items():
            worst = 0.0
            for tag, got, ref in outs:
                err, peak, fro = compare(got, ref)
                worst = max(worst, err)
                print(f"  [{label}] {name} {tag}: max_abs_err {err:.3e} "
                      f"(max|ref| {peak:.3e}, tol {REL_MAX_TOL * peak:.3e}) "
                      f"rel_fro {fro:.3e} (tol {REL_FRO_TOL})", flush=True)
                check(math.isfinite(err) and err <= REL_MAX_TOL * peak,
                      f"{label}: {name} {tag} max error {err} > "
                      f"{REL_MAX_TOL} * {peak}")
                check(fro <= REL_FRO_TOL,
                      f"{label}: {name} {tag} relative error {fro}")
            if label == "main":
                errors[name] = worst
                timing = (q, k, v, do, lse_p, delta)
    return errors, timing


def phase_timing(torch, F, attention, inputs):
    q, k, v, do, lse, delta = inputs
    c = MAIN_CASE["causal"]
    runs = {
        "flash_fwd": (lambda: attention.flash_fwd(q, k, v, c),
                      lambda: attention.mha_reference_with_lse(q, k, v, c)),
        "flash_bwd_dq": (
            lambda: attention.flash_bwd_dq(q, k, v, do, lse, delta, c),
            lambda: attention.flash_bwd_dq_plain(q, k, v, do, lse, delta, c)),
        "flash_bwd_dkv": (
            lambda: attention.flash_bwd_dkv(q, k, v, do, lse, delta, c),
            lambda: attention.flash_bwd_dkv_plain(q, k, v, do, lse, delta, c)),
    }
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


def state_crcs(torch, state):
    """The CRC32 of every leaf of a train state under its JAX name, the
    device tensors copied to the host in CRC_CHUNK pieces through a pinned
    buffer of each worker's."""
    from dlrover_tpu_torch.checkpoint.shm_handler import as_bytes, flatten_state

    local = threading.local()

    def crc(value):
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

    return crc_table({leaf.name: leaf.value
                      for leaf in flatten_state(state)}, crc)


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


def unlink_segment(job):
    from dlrover_tpu_torch.checkpoint.shm_handler import (
        SharedMemoryHandler, shm_name)

    h = SharedMemoryHandler(shm_name(job, 0, 0))
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


def _run_child(role, ckpt_dir, job, kill_on=None):
    """Run ``chip_smoke.py --ckpt-child role ckpt_dir`` under the job name
    ``job``, echoing its output; returns its JSON result. With ``kill_on``, SIGKILL it at the
    line that starts with that word. Fails on a child that fails."""
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
            if kill_on and line.startswith(kill_on):
                proc.send_signal(signal.SIGKILL)
    finally:
        timer.cancel()
        proc.kill()
        proc.wait(timeout=60)
    want = -signal.SIGKILL if kill_on else 0
    check(proc.returncode == want,
          f"child {role} exited {proc.returncode}, not {want}")
    check(result is not None, f"child {role} printed no result")
    return result


def ckpt_child(role, ckpt_dir):
    """One child of phase 4c, on the card; prints its result as one JSON
    line. agent: trains steps 1-3, saving each to memory and step 2 to
    storage, and prints its saves. crash: trains steps 1-2 saving each to
    memory, prints the staged leaves' CRC32 and waits to be killed. resume:
    restores (it must find step 2 in shm), prints the restored leaves'
    CRC32, trains steps 3-4. disk: restores (from disk, the segment gone)
    and prints the CRC32s. The job name, and so the segment and the
    saver's socket, is ``DLROVER_TPU_JOB_NAME``'s."""
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
    if role == "crash":
        result = llama_pretrain.run(_ckpt_args(2, ckpt_dir, 0))
        print(f"step_s {result['step_s']}", flush=True)
        _print_saves("crash", result["saves"], ckpt_state_bytes(
            result["params"]))
        step, crcs = segment_crcs(os.environ["DLROVER_TPU_JOB_NAME"])
        print("CKPT_CHILD_JSON " + json.dumps({
            "losses": result["losses"], "staged_step": step, "crc": crcs,
            "modes": [s["mode"] for s in result["saves"]]}), flush=True)
        print("READY to be killed", flush=True)
        time.sleep(CKPT_CHILD_TIMEOUT_S)
        return 1  # not killed
    args = _ckpt_args(4, ckpt_dir, 0)
    _, trainer, state, next_batch, _ = llama_pretrain.build(args)
    torch.cuda.synchronize()
    ckpt, start, restore = llama_pretrain.open_checkpoint(args, state,
                                                          next_batch)
    check(restore is not None, f"child {role} restored nothing")
    crcs = state_crcs(torch, state)
    losses, step_s = [], []
    if role == "resume":
        for _ in range(start, args.steps):
            state, loss, seconds = llama_pretrain.timed_step(
                trainer, state, next_batch())
            losses.append(loss)
            step_s.append(seconds)
    ckpt.close()
    print("CKPT_CHILD_JSON " + json.dumps({
        "restore": restore, "crc": crcs, "losses": losses,
        "step_s": step_s}), flush=True)
    return 0


def _wait_persisted(saver, step):
    """Wait until the saver has logged its persist of ``step``: it logs one
    once the persist has ended, its commit included."""
    deadline = time.time() + CKPT_COMMIT_TIMEOUT_S
    while not any(e["step"] == step for e in list(saver.persist_log)):
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
        print(f"  agent leg: {time.perf_counter() - t_leg:.1f}s", flush=True)

        # a crash under the saver: the child is SIGKILLed once step 2 is
        # staged to memory, and the saver persists it at the breakpoint
        t_leg = time.perf_counter()
        d_crash = os.path.join(workdir, "crash")
        host = AsyncCheckpointSaver(job_name=job, node_id=0)
        host.start()
        crash = _run_child("crash", d_crash, job, kill_on="READY")
        check(crash["staged_step"] == 2 and crash["modes"] == [
            "device_snapshot"] * 2, f"crash child staged {crash}")
        t_bp = time.perf_counter()
        ok = host.save_shm_to_storage(d_crash)
        bp_s = time.perf_counter() - t_bp
        committed = host.persister.committed_step(d_crash)
        print(f"  breakpoint persist of the killed child's step: {ok}, "
              f"{bp_s:.3f}s for two tiers of {nbytes} bytes "
              f"({2 * nbytes / bp_s / 1e9:.2f} GB/s written), committed "
              f"step {committed}", flush=True)
        check(ok, "the breakpoint persist returned False")
        check(committed == 2, f"the breakpoint persist committed {committed}")
        resume = _run_child("resume", d_crash, job)
        restore = resume["restore"]
        print(f"  restore after SIGKILL: step {restore['step']}, tier "
              f"{restore['tier']}, {restore['seconds']:.3f}s (register "
              f"{restore['register_s']:.3f}s, host-to-device "
              f"{restore['bytes'] / (restore['seconds'] - restore['register_s']) / 1e9:.2f}"
              f" GB/s over the rest)", flush=True)
        check(restore["tier"] == "shm" and restore["step"] == 2,
              f"the resumed child restored {restore}, not step 2 from shm")
        compare_crcs(crash["crc"], resume["crc"], "shm restore")
        print(f"  every leaf's CRC32 equal ({len(resume['crc'])} leaves)",
              flush=True)
        runs = [main_result["losses"][2:4], losses[2:4]]
        spread = max(abs(a - b) for a, b in zip(*runs))
        tol = max(CKPT_RESUME_SPREAD_FACTOR * spread, CKPT_RESUME_LOSS_FLOOR)
        diff = max(abs(a - b) for a, b in zip(resume["losses"], runs[0]))
        print(f"  resumed steps 3-4 (step_s {resume['step_s']}) losses "
              f"{resume['losses']} vs phase 4's "
              f"{runs[0]} and the save run's {runs[1]}: diff {diff:.3e}, "
              f"uninterrupted spread {spread:.3e}, tol {tol:.3e} (max of "
              f"{CKPT_RESUME_SPREAD_FACTOR} x spread, "
              f"{CKPT_RESUME_LOSS_FLOOR})", flush=True)
        check(diff <= tol, f"resumed losses differ by {diff} > {tol}")

        # the segment lost: step 2 from the breakpoint persist on disk
        unlink_segment(job)
        disk = _run_child("disk", d_crash, job)
        restore = disk["restore"]
        print(f"  restore of the breakpoint step from disk: step "
              f"{restore['step']}, tier {restore['tier']}, "
              f"{restore['seconds']:.3f}s for {restore['bytes']} bytes "
              f"(CRC-verified)", flush=True)
        check(restore["tier"] == "disk" and restore["step"] == 2,
              f"the disk child restored {restore}, not step 2 from disk")
        check_breakpoint_step(crash["crc"], manifest_crcs(d_crash, 2),
                              disk["crc"])
        print(f"  every leaf's CRC32, in the breakpoint manifest and "
              f"restored from disk, equal to what the killed child staged "
              f"({len(disk['crc'])} leaves)", flush=True)
        host.stop()
        host = None
        print(f"  breakpoint leg: {time.perf_counter() - t_leg:.1f}s",
              flush=True)
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

    print("== phase 3: kernels against their plain versions", flush=True)
    errors, inputs = phase_kernels(torch, attention)
    times, sdpa_fwd, sdpa_bwd = phase_timing(torch, F, attention, inputs)
    del inputs
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
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
