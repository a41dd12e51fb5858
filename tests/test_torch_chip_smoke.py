"""chip_smoke.py's tables against the CUDA sources, on the CPU.

Every ``__global__`` kernel in ``dlrover_tpu_torch/ops/csrc/*.cu`` is held
against its plain version by ``chip_smoke.py`` (``KERNELS`` or
``CE_KERNELS``) and has one SASS expectation (wgmma + TMA, or neither),
and the bounds that the kernels' times are read against stay where they
were computed, so the yardstick of a comparison cannot drift unnoticed.
"""

import os
import re
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

import chip_smoke  # noqa: E402
from dlrover_tpu_torch.ops import cuda_build  # noqa: E402
from dlrover_tpu_torch.ops import fused_ce as fce  # noqa: E402


def _global_kernels():
    """{kernel name without ``_kernel``: source} over every csrc/*.cu."""
    found = {}
    for name in cuda_build.sources():
        text = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        for kernel in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)_kernel\s*\(", text):
            found[kernel] = name
    return found


def test_every_kernel_is_held_and_has_one_sass_expectation():
    kernels = _global_kernels()
    held = {name for name, _, _ in chip_smoke.KERNELS + chip_smoke.CE_KERNELS}
    assert len(kernels) == 8
    assert set(kernels) == held
    wgmma = set(chip_smoke.WGMMA_KERNELS)
    plain = set(chip_smoke.NO_WGMMA_KERNELS)
    assert not wgmma & plain
    assert wgmma | plain == held
    assert wgmma == {"fused_ce_bwd_q", "fused_ce_bwd_dx", "fused_ce_bwd_dw",
                     "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    # each table's source is the file the kernel is defined in
    for name, _, _ in chip_smoke.KERNELS:
        assert chip_smoke.SOURCE.endswith(f"/{kernels[name]}.cu")
    for name, _, _ in chip_smoke.CE_KERNELS:
        assert chip_smoke.CE_SOURCE.endswith(f"/{kernels[name]}.cu")


def test_sass_check_holds_each_kernel_instance():
    """check_sass fails a wgmma kernel instance without HGMMA or UTMALDG, a
    plain one with either, and a kernel missing from the SASS."""
    good = {"flash_fwd<64>": (12, 3), "flash_fwd<128>": (16, 6),
            "flash_bwd_dq<64>": (24, 4), "flash_bwd_dq<128>": (40, 8),
            "flash_bwd_dkv<64>": (16, 4), "flash_bwd_dkv<128>": (24, 8),
            "fused_ce_fwd": (0, 0), "fused_ce_merge": (0, 0),
            "fused_ce_bwd_q": (4, 5), "fused_ce_bwd_dx": (4, 2),
            "fused_ce_bwd_dw": (4, 6)}
    chip_smoke.check_sass(good)
    for inst, bad in (("flash_fwd<64>", (12, 0)),
                      ("fused_ce_bwd_dw", (0, 6)),
                      ("flash_bwd_dkv<128>", (24, 0)),
                      ("flash_bwd_dq<64>", (0, 4)),
                      ("fused_ce_fwd", (1, 0))):
        with pytest.raises(chip_smoke.SmokeFailure, match=re.escape(inst)):
            chip_smoke.check_sass({**good, inst: bad})
    missing = {k: v for k, v in good.items() if k != "fused_ce_merge"}
    with pytest.raises(chip_smoke.SmokeFailure, match="fused_ce_merge"):
        chip_smoke.check_sass(missing)


@pytest.mark.parametrize("kernel,ms", [
    ("flash_fwd", 0.0348), ("flash_bwd_dq", 0.0521), ("flash_bwd_dkv", 0.0695),
])
def test_flash_bounds_at_the_main_case(kernel, ms):
    """Causal b=1 s=2048 h=32 d=128: 4 d (or 6 d, 8 d) FLOPs a visible
    (q, k) pair over 989 TFLOP/s."""
    bound_ms, by = chip_smoke.bounds(chip_smoke.MAIN_CASE)[kernel]
    assert by == "operations"
    assert bound_ms == pytest.approx(ms, abs=5e-5)


def test_bwd_dw_bound_at_the_main_chunk():
    """2 d n cw FLOPs of one 8192-column chunk over 989 TFLOP/s."""
    bounds = chip_smoke.ce_bounds(2048, 4096, 128256, 8192, fce.FWD_TILE)
    bound_ms, by = bounds["fused_ce_bwd_dw"]
    assert by == "operations"
    assert bound_ms == pytest.approx(0.1390, abs=5e-5)
    assert fce.BWD_CHUNK == 8192
