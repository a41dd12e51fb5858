"""Concrete pretraining datasets for the elastic data pipeline: the
port's own copy of dlrover_tpu/train/datasets.py, the same file format and
the same samples.

- :class:`TokenFileDataset`: a memory-mapped flat binary of token ids
  (the nanoGPT/Megatron ``.bin`` convention — uint16/uint32, no
  framing), sliced into fixed-length sequences. ``np.memmap`` keeps
  the host RSS independent of corpus size and the page cache does the
  read-ahead; `__getitem__` is a zero-copy slice + dtype cast, so the
  loader feeds `prefetch_to_device` at memory bandwidth.
- :func:`pack_tokens` / :func:`pack_text_file`: corpus writers for the
  same format.

A sample is int32, which the port's embedding gather and kernels take as it
is; Llama-3's vocabulary of 128256 needs a ``uint32`` corpus.

Composes with everything already here: `ElasticDistributedSampler`
(elastic epoch iteration), `ElasticDataLoader` (runtime-tunable batch
size), `ShardingClient` (master-issued shard ranges with exactly-once
resume), and `prefetch_to_device`.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional

import numpy as np

__all__ = ["TokenFileDataset", "pack_tokens", "pack_text_file"]

_DTYPES = {"uint16": np.uint16, "uint32": np.uint32, "int32": np.int32}


class TokenFileDataset:
    """Fixed-length sequences out of a flat binary token file.

    ``sample i = tokens[i*stride : i*stride + seq_len]`` as int32 (what
    the model families take); ``stride`` defaults to ``seq_len``
    (non-overlapping). The LM families derive next-token targets by
    shifting internally, so samples are exactly ``seq_len`` long.
    """

    def __init__(
        self,
        path: str,
        seq_len: int,
        dtype: str = "uint16",
        stride: Optional[int] = None,
    ):
        if dtype not in _DTYPES:
            raise ValueError(
                f"dtype={dtype!r}: expected one of {sorted(_DTYPES)}"
            )
        self.path = path
        self.seq_len = int(seq_len)
        self.stride = int(stride or seq_len)
        if self.seq_len <= 0 or self.stride <= 0:
            raise ValueError("seq_len and stride must be positive")
        self._tokens = np.memmap(path, dtype=_DTYPES[dtype], mode="r")
        n_tok = len(self._tokens)
        self._n = max(0, (n_tok - self.seq_len) // self.stride + 1)

    @property
    def n_tokens(self) -> int:
        return len(self._tokens)

    def validate_vocab(self, vocab_size: int, sample: int = 1 << 20):
        """Raise if any of the first ``sample`` tokens is >= vocab_size.

        An out-of-range token id reaches the embedding gather as an
        out-of-bounds index and trains on garbage (nan loss at best,
        silent corruption at worst); a truncated scan catches the common
        corpus/tokenizer-vs-model mismatch for the cost of one page-in."""
        head = self._tokens[: min(sample, len(self._tokens))]
        if not len(head):
            return
        lo, hi = int(head.min()), int(head.max())
        if hi >= vocab_size or lo < 0:  # signed dtypes can go negative
            raise ValueError(
                f"corpus {self.path} has token ids in [{lo}, {hi}], "
                f"outside the model vocab [0, {vocab_size}) (checked first "
                f"{len(head)} tokens): wrong tokenizer or wrong --data-dtype?"
            )

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < self._n:
            raise IndexError(i)
        off = i * self.stride
        return np.asarray(
            self._tokens[off:off + self.seq_len], dtype=np.int32
        )


def pack_tokens(
    path: str, tokens: Iterable[int], dtype: str = "uint16"
) -> int:
    """Append token ids to ``path`` in the flat-binary format; returns
    the number of tokens written. Streams in chunks so corpora larger
    than RAM pack fine."""
    if dtype not in _DTYPES:
        raise ValueError(f"dtype={dtype!r}")
    np_dtype = _DTYPES[dtype]
    limit = np.iinfo(np_dtype).max
    written = 0
    buf = []
    with open(path, "ab") as f:
        for t in tokens:
            if not 0 <= t <= limit:
                raise ValueError(
                    f"token {t} out of range for {dtype} (max {limit})"
                )
            buf.append(t)
            if len(buf) >= 1 << 20:
                np.asarray(buf, dtype=np_dtype).tofile(f)
                written += len(buf)
                buf.clear()
        if buf:
            np.asarray(buf, dtype=np_dtype).tofile(f)
            written += len(buf)
    return written


def pack_text_file(
    text_path: str,
    bin_path: str,
    tokenize: Optional[Callable[[str], Iterable[int]]] = None,
    dtype: str = "uint16",
    chunk_bytes: int = 1 << 20,
) -> int:
    """Tokenize a text file into the binary format, streaming in
    chunks extended to the next newline (a subword tokenizer applied to
    a mid-word split produces different ids than contiguous text;
    newline boundaries are far more stable, though tokenizers that
    merge runs of newlines can still differ by a token per boundary).
    Memory stays bounded: a "line" longer than ``chunk_bytes`` is split
    mid-line rather than buffered whole. Default tokenizer is raw UTF-8
    bytes (vocab 256) — a real run passes e.g. a ``transformers``
    tokenizer's encode.

    Atomicity: output goes to ``bin_path + '.tmp'`` and replaces
    ``bin_path`` only on success, so a failed re-pack never destroys an
    existing corpus and a partial pack is never mistaken for a complete
    one (``pack_tokens`` itself appends, for multi-file packing)."""
    tmp_path = bin_path + ".tmp"
    open(tmp_path, "wb").close()  # truncate the temp
    total = 0

    def flush(text: str) -> int:
        ids = (
            list(text.encode("utf-8")) if tokenize is None
            else list(tokenize(text))
        )
        return pack_tokens(tmp_path, ids, dtype=dtype)

    with open(text_path, "r", encoding="utf-8", errors="replace") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            if not chunk.endswith("\n"):
                # extend to the next newline for tokenizer stability,
                # but never past another chunk_bytes (single-huge-line
                # corpora must not buffer unboundedly)
                tail = f.readline(chunk_bytes)
                chunk += tail
            total += flush(chunk)
    os.replace(tmp_path, bin_path)
    return total
