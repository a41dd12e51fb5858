#!/usr/bin/env python3
"""Drive the PyTorch port (dlrover_tpu_torch) on one Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

1. device: CUDA with compute capability 9.0; prints the card's name and
   power limit as nvidia-smi reports them. TF32 is switched off for
   matmuls and cuDNN, so every f32 product in the references is full f32.
2. build: compiles every kernel of the main path from the sources in this
   checkout (``dlrover_tpu_torch/ops/csrc``), one nvcc per source, in
   parallel.
3. kernels: each flash-attention kernel (fwd, dq, dk/dv) against its plain
   PyTorch version on the same bf16 inputs on the card, for the main-path
   shape and for non-causal, ragged, group-1 and head-dim-64 cases, with
   the tolerances below; then each kernel's time, its plain version's
   time, the least time the card could take (bound), and the time of
   ``F.scaled_dot_product_attention(..., enable_gqa=True)`` as the
   library yardstick (timed only; the port never calls it).
4. main path: 4 training steps of the Llama-3-8B-width model cut to 4 of
   32 layers (seq 2048, micro-batch 1, global batch 2) through the port's
   ``ElasticTrainer``, with every kernel launch counter at 0 just before
   and read just after; checks the losses and that every kernel ran.
5. reference: a small Llama (head dim 128) on the card, bf16 with the
   kernels, against the same weights on the CPU in f32 with the plain
   versions: loss and every gradient, under remat "all" and "mlp".
6. output: one JSON line of the kernels, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Exits with code 2 and prints no result when CUDA is not available.
"""

import dataclasses
import json
import math
import subprocess
import sys
import time

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
]


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
    """[(kernel<D>, "registers, spills")] from nvcc's -Xptxas -v output."""
    import re

    out, kernel, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*?\d(flash_(?:fwd|bwd_dq|bwd_dkv)"
                      r"_kernel)ILi(\d+)E", line)
        if m:
            kernel = f"{m.group(1)}<{m.group(2)}>"
        elif "spill" in line:
            spills = line.strip()
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers; {spills}"))
            kernel = None
    return out


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
        # plain, kernel, kernel, plain: the two orders average out drift
        p1 = cuda_ms(torch, plain, iters=5)
        k1 = cuda_ms(torch, kernel)
        k2 = cuda_ms(torch, kernel)
        p2 = cuda_ms(torch, plain, iters=5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)

    # library yardstick: SDPA in (b, h, s, d), timed only
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=c, enable_gqa=True))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=c,
                                         enable_gqa=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    return times, sdpa_fwd, sdpa_bwd


def phase_main_path(torch, attention):
    from dlrover_tpu_torch.run import llama_pretrain

    args = llama_pretrain.parse_args([
        "--model", "8b", "--layers", "4", "--seq", "2048",
        "--micro-batch", "1", "--global-batch", "2", "--steps", "4",
        "--device", "cuda", "--seed", "0",
    ])
    attention.reset_launch_counts()
    result = llama_pretrain.run(args, log=lambda m: print("  " + m,
                                                          flush=True))
    counts = dict(attention.launch_counts)
    losses = result["losses"]
    print(f"  params {result['params']}, tokens/step "
          f"{result['tokens_per_step']}, step_s {result['step_s']}, "
          f"tokens/s (steps 2-4) {result['tokens_per_s']:.1f}, "
          f"max_memory_allocated {result['max_memory_bytes']} bytes",
          flush=True)
    print(f"  kernel launches on the main path: {counts}", flush=True)
    check(all(math.isfinite(x) for x in losses), f"non-finite loss {losses}")
    # at random init the final-norm hidden state has norm sqrt(dim), so the
    # logits are ~N(0, sigma^2) with sigma = 0.02 sqrt(4096) = 1.28, and the
    # expected loss is ln(vocab) + sigma^2 / 2 = 11.76 + 0.82
    expected = math.log(128256) + 0.5 * (0.02 ** 2) * 4096
    print(f"  step-1 loss {losses[0]:.4f}, expected {expected:.4f} "
          f"(ln(128256) + sigma^2/2), tol 0.5", flush=True)
    check(abs(losses[0] - expected) < 0.5,
          f"step-1 loss {losses[0]} not within 0.5 of {expected}")
    for _, key, _ in KERNELS:
        check(counts[key] > 0, f"kernel {key} never launched on the main path")
    return counts, result


def phase_reference(torch, remat_policy):
    """A small Llama with head dim 128: bf16 + kernels on the card against
    f32 + plain versions on the CPU, same weights, same tokens."""
    from dlrover_tpu_torch.common.tree import flatten, map_tree
    from dlrover_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(
        vocab_size=512, dim=256, n_heads=2, n_kv_heads=1, ffn_dim=512,
        n_layers=2, remat=True, remat_policy=remat_policy,
    )
    gen = torch.Generator(device="cpu").manual_seed(7)
    params_cpu = llama.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 320), generator=gen)
    params_gpu = map_tree(lambda t: t.cuda(), params_cpu)

    def loss_and_grads(params, tokens, cfg):
        leaves = [p.requires_grad_(True) for _, p in flatten(params)]
        loss = llama.loss_fn(params, tokens, cfg)
        return loss, torch.autograd.grad(loss, leaves)

    loss_c, grads_c = loss_and_grads(params_cpu, tokens, cfg)
    cfg_bf16 = dataclasses.replace(cfg, dtype=torch.bfloat16)
    loss_g, grads_g = loss_and_grads(params_gpu, tokens.cuda(), cfg_bf16)
    diff = abs(loss_g.item() - loss_c.item())
    print(f"  remat {remat_policy!r}: loss card(bf16) {loss_g.item():.5f} "
          f"cpu(f32) {loss_c.item():.5f}"
          f" diff {diff:.2e} (tol {E2E_LOSS_TOL})", flush=True)
    check(diff <= E2E_LOSS_TOL, f"reference loss differs by {diff}")
    worst = 0.0
    for (path, _), gg, gc in zip(flatten(params_cpu), grads_g, grads_c):
        fro = ((gg.float().cpu() - gc).norm() / gc.norm().clamp_min(1e-30))
        worst = max(worst, fro.item())
        check(fro.item() <= E2E_GRAD_REL_FRO_TOL,
              f"reference grad {path} relative error {fro.item()}")
    print(f"  every grad within rel_fro {worst:.3e} "
          f"(tol {E2E_GRAD_REL_FRO_TOL})", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from dlrover_tpu_torch.ops import attention, cuda_build

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
    seconds = cuda_build.build(["flash_attn"])
    print(f"  nvcc seconds: {seconds}", flush=True)
    log = cuda_build.library_path("flash_attn").with_suffix(".log")
    for kernel, usage in ptxas_usage(log.read_text()):
        print(f"  ptxas {kernel}: {usage}", flush=True)

    print("== phase 3: kernels against their plain versions", flush=True)
    errors, inputs = phase_kernels(torch, attention)
    times, sdpa_fwd, sdpa_bwd = phase_timing(torch, F, attention, inputs)
    bound = bounds(MAIN_CASE)
    for kname, (k_ms, p_ms) in times.items():
        print(f"  {kname}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
              f"{bound[kname][0]:.4f} ms ({bound[kname][1]})", flush=True)
    print(f"  library: sdpa fwd {sdpa_fwd:.4f} ms, sdpa bwd (dq, dk, dv "
          f"together) {sdpa_bwd:.4f} ms", flush=True)

    print("== phase 4: main path (Llama-3-8B width, 4 of 32 layers)",
          flush=True)
    counts, _ = phase_main_path(torch, attention)

    print("== phase 5: small-model reference (card bf16 vs cpu f32)",
          flush=True)
    for policy in ("all", "mlp"):
        phase_reference(torch, policy)

    kernels = []
    for kname, key, replaces in KERNELS:
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": counts[key],
            "max_abs_err": errors[kname], "ms": times[kname][0],
            "plain_ms": times[kname][1], "bound_ms": bound[kname][0],
            "bound_by": bound[kname][1],
            "library_ms": sdpa_fwd if kname == "flash_fwd" else None,
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
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
