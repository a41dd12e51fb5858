"""Builds the port's CUDA sources into shared libraries at first use.

Each source under ``ops/csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, loaded with ``ctypes``. Builds
land in ``build/torch_kernels/`` at the root of the checkout, named with a
hash of the source, the headers beside it (``csrc/*.cuh``) and the flags,
so an edited kernel or header rebuilds and an unchanged one loads at once.
Several sources build in parallel, one ``nvcc`` each. Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from dlrover_tpu_torch.common.log import logger

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def toolkit_binary(tool: str) -> str:
    """The path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): under
    ``CUDA_HOME`` or ``CUDA_PATH``, else on ``PATH``, else under
    ``/usr/local/cuda``."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / tool).exists():
        return str(Path(cuda_home) / "bin" / tool)
    found = shutil.which(tool)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / tool
    if default.exists():
        return str(default)
    raise RuntimeError(f"{tool} not found (set CUDA_HOME or put it on PATH)")


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives: named by a
    hash of the source, of every header under ``csrc/`` and of the flags,
    so an edited header rebuilds too."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every named source whose library is missing, all at once.
    Returns the seconds each compile took (0.0 for a cached library); the
    compiler's resource report is kept beside each library as ``.log``.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    seconds: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or toolkit_binary("nvcc")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        logger.info("built %s in %.1fs", out.name, seconds[name])
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def sources():
    """The name of every CUDA source under ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``. The first load builds
    every missing library of ``csrc/`` at once, so a training step's kernel
    families compile in parallel rather than one at each first launch."""
    lib = _loaded.get(name)
    if lib is None:
        build(sources())
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
