"""Fused lm-head cross-entropy: hand-written Hopper kernels for the forward
and the dx / dw backward (port of dlrover_tpu/ops/fused_ce.py).

``cross_entropy_sums`` is the models' entry. With ``DLROVER_TPU_FUSED_CE``
on (the default, re-read at every call) it runs ``fused_cross_entropy``;
with ``DLROVER_TPU_FUSED_CE=0`` it runs ``chunked_cross_entropy``. Both
return ``(nll_sum, n_valid)`` in f32 and ignore ``targets < 0``.

``fused_cross_entropy`` is a `torch.autograd.Function`:

- **forward** (scope ``fused_ce_fwd``): the ``fwd`` kernel writes, for each
  ``FWD_TILE``-column vocab tile and each token, the tile's max, sum of exp
  and gold logit (partials ``(3, ntiles, n)``, token-minor); the ``merge``
  kernel folds them into per-token ``logz`` and ``gold``. ``nll_sum`` and
  ``n_valid`` are two reductions outside.
- **backward** (scope ``fused_ce_bwd``): ``row_scale = valid * g_nll`` is
  computed outside the kernels, as in the JAX package. Then, for each vocab
  chunk of ``BWD_CHUNK`` columns, the ``bwd_q`` kernel recomputes the
  chunk's logits and writes ``q = (exp(l - logz) - onehot) * row_scale``,
  the ``bwd_dx`` kernel adds ``q @ w_chunk^T`` into an f32 dx, and the
  ``bwd_dw`` kernel writes ``x^T @ q`` into the chunk's dw columns. The
  logits are recomputed once, and no (tokens, vocab) f32 tensor exists.

Precision contract. The lm-head is rounded to the compute dtype (x's) once
per call, and the copy is kept for the backward. The products take
compute-dtype operands and accumulate in f32; ``m``, ``s``, ``logz``,
``gold``, ``nll_sum`` and the dx accumulator are f32; ``q`` is rounded to
the compute dtype before its products, as the chunked path and the flash
kernels' ``p`` are. The TPU kernel upcasts both operands to f32 and keeps
``q`` in f32 instead (``fused_ce.py:186-187, :297``). ``dx`` comes back in
x's dtype, ``dw`` in w's. The plain versions below repeat this rounding, so
a kernel and its plain version differ only in the order of their sums.

Kernels (``csrc/fused_ce.cu``). ``fwd``, ``bwd_q``, ``bwd_dx`` and
``bwd_dw`` run one Hopper main loop, that of ``csrc/sm90_gemm.cuh``: TMA
loads into a 4-stage mbarrier ring, ``wgmma`` from shared memory, one
producer and two consumer warpgroups on a 128 x 256 tile, so the forward's
vocab tile is 256 columns; the C entry points build the operands' tensor
maps at each launch (a backward chunk's lm-head map starts at column ``c0``
and is ``cw`` wide; ``bwd_dw`` reads x and q token-major, as wgmma's
transposed operands). ``merge`` is no GEMM.
``chip_smoke.py`` checks each kernel against its plain version below and
counts the wgmma (``HGMMA``) and TMA (``UTMALDG``) instructions in each
kernel's SASS.

Edges: the kernels mask ragged token and vocab edges themselves. The one
padded copy is the rounded lm-head, whose rows are padded with zero columns
to a multiple of 8 so that every row starts 16-byte aligned.

Dispatch is by the tensor's device: a CPU tensor runs the plain PyTorch
version of each kernel (kept beside it here); a CUDA tensor launches the
kernel, or raises. There is no fallback from a CUDA tensor to the plain or
the chunked path. Each kernel launch adds one to its entry in
``launch_counts``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
from torch.profiler import record_function

from dlrover_tpu_torch.common import flags
from dlrover_tpu_torch.ops.chunked_ce import (
    DEFAULT_CHUNK_SIZE,
    chunked_cross_entropy,
    matmul_f32,
)

_NEG_INF = -1e30

#: vocab columns of one forward block (FWD_TILE in csrc/fused_ce.cu, the
#: main loop's N tile)
FWD_TILE = 256
#: vocab columns per backward chunk: the (tokens, BWD_CHUNK) q buffer is
#: 33.5 MB at 2048 tokens
BWD_CHUNK = 8192

#: kernel launches since the last ``reset_launch_counts()``
launch_counts: Dict[str, int] = {
    "fwd": 0, "merge": 0, "bwd_q": 0, "bwd_dx": 0, "bwd_dw": 0,
}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def fused_ce_enabled() -> bool:
    """``DLROVER_TPU_FUSED_CE=0`` takes the chunked cross-entropy instead
    of the fused kernels; read at every call."""
    return flags.FUSED_CE.get()


def cross_entropy_sums(
    x: torch.Tensor,
    w_unembed: torch.Tensor,
    targets: torch.Tensor,
    *,
    chunk_size: int = DEFAULT_CHUNK_SIZE,
):
    """The models' CE entry: the fused kernels when ``DLROVER_TPU_FUSED_CE``
    is on, else the chunked path (same ``(nll_sum, n_valid)`` contract).
    ``chunk_size`` parameterizes the chunked path only."""
    if fused_ce_enabled():
        return fused_cross_entropy(x, w_unembed, targets)
    return chunked_cross_entropy(x, w_unembed, targets, chunk_size=chunk_size)


def fused_cross_entropy(x: torch.Tensor, w_unembed: torch.Tensor,
                        targets: torch.Tensor):
    """Fused ``softmax_ce(x @ w_unembed, targets)``.

    Args:
      x: ``(..., d)`` hidden states (post final-norm, pre-unembed).
      w_unembed: ``(d, v)`` lm-head / classifier weights.
      targets: ``(...)`` integer class ids; ``targets < 0`` are ignored.

    Returns:
      ``(nll_sum, n_valid)``: the f32 sum of per-token negative
      log-likelihoods over valid targets, and the f32 count of valid
      targets (not differentiable).
    """
    if tuple(x.shape[:-1]) != tuple(targets.shape):
        raise ValueError(
            f"x leading dims {tuple(x.shape[:-1])} != targets shape "
            f"{tuple(targets.shape)}"
        )
    if x.shape[-1] != w_unembed.shape[0]:
        raise ValueError(
            f"x feature dim {x.shape[-1]} != w_unembed rows "
            f"{w_unembed.shape[0]}"
        )
    return _FusedCE.apply(x, w_unembed, targets)


def compute_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` (d, v) rounded to ``dtype``, contiguous, with zero columns up
    to a multiple of 8: the lm-head operand of every kernel."""
    d, v = w.shape
    vp = -(-v // 8) * 8
    if vp == v:
        return w.to(dtype).contiguous()
    out = torch.zeros((d, vp), dtype=dtype, device=w.device)
    out[:, :v] = w
    return out


def _chunks(vp: int):
    for c0 in range(0, vp, BWD_CHUNK):
        yield c0, min(BWD_CHUNK, vp - c0)


# ---------------------------------------------------------------------------
# plain versions of the kernels: the CPU path, and what the card's kernels
# are held to. x (n, d) and wc (d, vp) in the compute dtype, tgt (n,) ints
# ---------------------------------------------------------------------------


def fused_ce_fwd_plain(x, wc, tgt, v: int) -> torch.Tensor:
    """Per-tile partials ``(3, ntiles, n)`` f32: each FWD_TILE-column
    vocab tile's row max, sum of exp(l - max) over its real columns, and the
    gold logit where the target falls in it (else 0)."""
    n, vp = x.shape[0], wc.shape[1]
    ntiles = -(-v // FWD_TILE)
    logits = torch.full((n, ntiles * FWD_TILE), _NEG_INF, dtype=torch.float32,
                        device=x.device)
    logits[:, :v] = matmul_f32(x, wc)[:, :v]
    tiles = logits.view(n, ntiles, FWD_TILE)
    m = tiles.max(dim=-1).values
    s = torch.exp(tiles - m[..., None]).sum(dim=-1)  # a -1e30 column adds 0
    hit = (tgt >= 0) & (tgt < v)
    safe = torch.where(hit, tgt, 0).long()
    g = torch.zeros((n, ntiles), dtype=torch.float32, device=x.device)
    rows = torch.arange(n, device=x.device)
    g[rows, safe // FWD_TILE] = torch.where(hit, logits[rows, safe], 0.0)
    return torch.stack([m, s, g]).transpose(1, 2).contiguous()


def fused_ce_merge_plain(part):
    """``(logz, gold)`` (n,) f32 from the per-tile partials."""
    m, s, g = part
    mx = m.max(dim=0).values
    total = (s * torch.exp(m - mx)).sum(dim=0)
    logz = mx + torch.log(torch.where(total == 0, 1.0, total))
    return logz, g.sum(dim=0)


def fused_ce_bwd_q_plain(x, wc, tgt, logz, row_scale, v: int, c0: int,
                         cw: int):
    """``q`` (n, cw) in the compute dtype for vocab columns [c0, c0+cw)."""
    logits = matmul_f32(x, wc[:, c0:c0 + cw])
    col = c0 + torch.arange(cw, device=x.device)
    p = torch.where(col < v, torch.exp(logits - logz[:, None]), 0.0)
    p = p - (col[None, :] == tgt[:, None].long()).float()
    return (p * row_scale[:, None]).to(x.dtype)


def fused_ce_bwd_dx_plain(q, wc, c0: int, dx) -> None:
    """``dx (n, d) f32 += q @ wc[:, c0:c0+cw]^T``, in place."""
    dx += matmul_f32(q, wc[:, c0:c0 + q.shape[1]].t())


def fused_ce_bwd_dw_plain(x, q, v: int, c0: int, dw) -> None:
    """``dw[:, c0:c0+cw] = x^T @ q`` (f32, real columns only), in place."""
    width = min(q.shape[1], v - c0)
    dw[:, c0:c0 + width] = matmul_f32(x.t(), q)[:, :width]


# ---------------------------------------------------------------------------
# kernel wrappers: CPU tensor -> plain version, CUDA tensor -> kernel
# ---------------------------------------------------------------------------


def _kernels():
    global _lib
    if _lib is None:
        from dlrover_tpu_torch.ops import cuda_build

        lib = cuda_build.load("fused_ce")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.dlrover_ce_fwd.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.dlrover_ce_merge.argtypes = [p] * 3 + [i] * 2 + [p]
        lib.dlrover_ce_bwd_q.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.dlrover_ce_bwd_dx.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.dlrover_ce_bwd_dw.argtypes = [p] * 3 + [i] * 5 + [p]
        lib.dlrover_ce_tile.argtypes = []
        for fn in (lib.dlrover_ce_fwd, lib.dlrover_ce_merge,
                   lib.dlrover_ce_bwd_q, lib.dlrover_ce_bwd_dx,
                   lib.dlrover_ce_bwd_dw, lib.dlrover_ce_tile):
            fn.restype = i
        if lib.dlrover_ce_tile() != FWD_TILE:
            raise RuntimeError(
                f"fused_ce.cu's vocab tile {lib.dlrover_ce_tile()} != "
                f"FWD_TILE {FWD_TILE}"
            )
        _lib = lib
    return _lib


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"fused CE: unsupported device {t.device}")
    return False


def _check(dev, **tensors):
    """Each ``name=(tensor, dtype, shape)`` lies contiguous on ``dev`` with
    that dtype and shape, 16-byte aligned; the card is sm_90."""
    cap = torch.cuda.get_device_capability(dev)
    if cap != (9, 0):
        raise RuntimeError(f"fused CE kernels are built for sm_90a; {dev} is "
                           f"sm_{cap[0]}{cap[1]}")
    for name, (t, dtype, shape) in tensors.items():
        if (t.device != dev or t.dtype != dtype
                or tuple(t.shape) != tuple(shape)):
            raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_dims(d: int, vp: int, c0: int = 0, cw: int = 0):
    """The kernels read 16-byte rows: d and the padded vocab width vp are
    multiples of 8, and so are a backward chunk's start c0 and width cw."""
    if d % 8 or vp % 8 or c0 % 8 or cw % 8 or c0 + cw > vp:
        raise ValueError(f"fused CE needs d, vp, c0 and cw multiples of 8 with "
                         f"c0 + cw <= vp; got d={d} vp={vp} c0={c0} cw={cw}")


def _raise_on(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f"fused CE {kernel} launch failed: cudaError {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_ce_fwd(x, wc, tgt, v: int) -> torch.Tensor:
    """Per-tile partials ``(3, ntiles, n)``: the forward kernel on the card."""
    if _on_cpu(x):
        return fused_ce_fwd_plain(x, wc, tgt, v)
    n, d = x.shape
    vp = wc.shape[1]
    _check_dims(d, vp)
    if not 0 < v <= vp:
        raise ValueError(f"vocab width {v} outside (0, {vp}]")
    _check(x.device, x=(x, torch.bfloat16, (n, d)),
           wc=(wc, torch.bfloat16, (d, vp)), tgt=(tgt, torch.int32, (n,)))
    ntiles = -(-v // FWD_TILE)
    part = torch.empty((3, ntiles, n), dtype=torch.float32, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = _kernels().dlrover_ce_fwd(
                x.data_ptr(), wc.data_ptr(), tgt.data_ptr(), part.data_ptr(),
                n, d, vp, v, _stream(x))
        _raise_on(rc, "fwd")
        launch_counts["fwd"] += 1
    return part


def fused_ce_merge(part):
    """``(logz, gold)``: the merge kernel on the card."""
    if _on_cpu(part):
        return fused_ce_merge_plain(part)
    _, ntiles, n = part.shape
    _check(part.device, part=(part, torch.float32, (3, ntiles, n)))
    logz = torch.empty(n, dtype=torch.float32, device=part.device)
    gold = torch.empty(n, dtype=torch.float32, device=part.device)
    if n:
        with torch.cuda.device(part.device):
            rc = _kernels().dlrover_ce_merge(
                part.data_ptr(), logz.data_ptr(), gold.data_ptr(), n, ntiles,
                _stream(part))
        _raise_on(rc, "merge")
        launch_counts["merge"] += 1
    return logz, gold


def fused_ce_bwd_q(x, wc, tgt, logz, row_scale, v: int, c0: int, cw: int):
    """``q`` of vocab columns [c0, c0+cw): the q kernel on the card."""
    if _on_cpu(x):
        return fused_ce_bwd_q_plain(x, wc, tgt, logz, row_scale, v, c0, cw)
    n, d = x.shape
    vp = wc.shape[1]
    _check_dims(d, vp, c0, cw)
    _check(x.device, x=(x, torch.bfloat16, (n, d)),
           wc=(wc, torch.bfloat16, (d, vp)), tgt=(tgt, torch.int32, (n,)),
           logz=(logz, torch.float32, (n,)),
           row_scale=(row_scale, torch.float32, (n,)))
    q = torch.empty((n, cw), dtype=torch.bfloat16, device=x.device)
    if n:
        with torch.cuda.device(x.device):
            rc = _kernels().dlrover_ce_bwd_q(
                x.data_ptr(), wc.data_ptr(), tgt.data_ptr(), logz.data_ptr(),
                row_scale.data_ptr(), q.data_ptr(), n, d, vp, v, c0, cw,
                _stream(x))
        _raise_on(rc, "bwd_q")
        launch_counts["bwd_q"] += 1
    return q


def fused_ce_bwd_dx(q, wc, c0: int, dx) -> None:
    """``dx += q @ wc[:, c0:c0+cw]^T`` in place: the dx kernel on the card."""
    if _on_cpu(q):
        fused_ce_bwd_dx_plain(q, wc, c0, dx)
        return
    n, cw = q.shape
    d, vp = wc.shape
    _check_dims(d, vp, c0, cw)
    _check(q.device, q=(q, torch.bfloat16, (n, cw)),
           wc=(wc, torch.bfloat16, (d, vp)), dx=(dx, torch.float32, (n, d)))
    if n:
        with torch.cuda.device(q.device):
            rc = _kernels().dlrover_ce_bwd_dx(
                q.data_ptr(), wc.data_ptr(), dx.data_ptr(), n, d, vp, c0, cw,
                _stream(q))
        _raise_on(rc, "bwd_dx")
        launch_counts["bwd_dx"] += 1


def fused_ce_bwd_dw(x, q, v: int, c0: int, dw) -> None:
    """``dw[:, c0:c0+cw] = x^T @ q`` in place: the dw kernel on the card."""
    if _on_cpu(x):
        fused_ce_bwd_dw_plain(x, q, v, c0, dw)
        return
    n, d = x.shape
    cw = q.shape[1]
    _check_dims(d, -(-v // 8) * 8, c0, cw)
    _check(x.device, x=(x, torch.bfloat16, (n, d)),
           q=(q, torch.bfloat16, (n, cw)), dw=(dw, torch.float32, (d, v)))
    with torch.cuda.device(x.device):
        rc = _kernels().dlrover_ce_bwd_dw(
            x.data_ptr(), q.data_ptr(), dw.data_ptr(), n, d, v, c0, cw,
            _stream(x))
    _raise_on(rc, "bwd_dw")
    launch_counts["bwd_dw"] += 1


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, targets):
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        tgt = targets.reshape(-1).to(torch.int32).contiguous()
        v = w.shape[1]
        with record_function("fused_ce_fwd"):
            wc = compute_weight(w, x2.dtype)
            logz, gold = fused_ce_merge(fused_ce_fwd(x2, wc, tgt, v))
            vf = (tgt >= 0).float()
            nll_sum = torch.sum((logz - gold) * vf)
            n_valid = torch.sum(vf)
        ctx.save_for_backward(x2, wc, tgt, logz)
        ctx.v = v
        ctx.w_dtype = w.dtype
        ctx.x_shape = x.shape
        ctx.mark_non_differentiable(n_valid)
        return nll_sum, n_valid

    @staticmethod
    def backward(ctx, g_nll, _g_n_valid):
        x2, wc, tgt, logz = ctx.saved_tensors
        v = ctx.v
        with record_function("fused_ce_bwd"):
            row_scale = ((tgt >= 0).float() * g_nll.float()).contiguous()
            dx = torch.zeros(x2.shape, dtype=torch.float32, device=x2.device)
            dw = torch.empty((x2.shape[1], v), dtype=torch.float32,
                             device=x2.device)
            for c0, cw in _chunks(wc.shape[1]):
                q = fused_ce_bwd_q(x2, wc, tgt, logz, row_scale, v, c0, cw)
                fused_ce_bwd_dx(q, wc, c0, dx)
                fused_ce_bwd_dw(x2, q, v, c0, dw)
        return (dx.to(x2.dtype).reshape(ctx.x_shape), dw.to(ctx.w_dtype),
                None)
