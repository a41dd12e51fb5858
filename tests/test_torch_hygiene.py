"""The port stands alone: no JAX, no optax, nothing of dlrover_tpu.

An AST scan of every file of dlrover_tpu_torch/ and chip_smoke.py, a
subprocess that trains nothing but computes a tiny CPU loss and then
finds no jax module loaded, and the entry points' refusal to fall back to
the CPU on their own.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "dlrover_tpu"}


def _port_files():
    root = os.path.join(REPO_ROOT, "dlrover_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(REPO_ROOT, "chip_smoke.py")


def _imported_roots(src):
    """Top-level names of every module the source imports."""
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_optax_or_jax_package():
    files = list(_port_files())
    assert len(files) > 10
    bad = []
    for f in files:
        with open(f) as fh:
            roots = _imported_roots(fh.read())
        bad += [(os.path.relpath(f, REPO_ROOT), r) for r in roots
                if r in FORBIDDEN]
    assert not bad, bad


def test_scan_matches_whole_names():
    """``dlrover_tpu_torch`` itself is allowed; ``dlrover_tpu`` is not."""
    src = ("import dlrover_tpu_torch.ops\nfrom dlrover_tpu_torch import x\n"
           "from dlrover_tpu.ops import y\nimport jax.numpy as jnp\n")
    roots = list(_imported_roots(src))
    assert [r for r in roots if r in FORBIDDEN] == ["dlrover_tpu", "jax"]


def test_port_runs_without_loading_jax():
    code = (
        "import sys, torch\n"
        "from dlrover_tpu_torch.models import llama, vit\n"
        "from dlrover_tpu_torch.train.trainer import ElasticTrainer, TrainConfig\n"
        "from dlrover_tpu_torch.checkpoint import (checkpointer, engine,\n"
        "    ownership, replica, saver, shm_handler)\n"
        "from dlrover_tpu_torch.common import constants, flags, ipc, storage\n"
        "from dlrover_tpu_torch.models import convert\n"
        "cfg = llama.LlamaConfig.tiny()\n"
        "params = llama.init_params(cfg, torch.Generator().manual_seed(0))\n"
        "toks = torch.randint(0, cfg.vocab_size, (2, 8))\n"
        "loss = llama.loss_fn(params, toks, cfg)\n"
        "assert torch.isfinite(loss)\n"
        "vcfg = vit.ViTConfig.tiny()\n"
        "vparams = vit.init_params(vcfg, torch.Generator().manual_seed(0))\n"
        "images = torch.randn(2, 32, 32, 3)\n"
        "labels = torch.tensor([1, -1])\n"
        "assert torch.isfinite(vit.loss_fn(vparams, (images, labels), vcfg))\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'dlrover_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "OK"


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    from dlrover_tpu_torch.common.device import resolve_device
    from dlrover_tpu_torch.run import llama_pretrain, vit_classify

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_pretrain.run(llama_pretrain.parse_args([]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vit_classify.run(vit_classify.parse_args([]))
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_to_run_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
