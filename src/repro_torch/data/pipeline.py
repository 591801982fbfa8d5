"""LM token pipeline: synthetic corpus → packed sequences → batches on a
device, ported from ``repro.data.pipeline``.

The stream is the reference's bit for bit (same ``default_rng`` seeding,
draw order, EOS packing, codebook offsets and embeddings stub), so a batch
drawn here equals the reference's batch with the same seed and index.

* :class:`SyntheticLMDataset` — deterministic stream of "documents"
  (variable length): Zipf unigram frequencies + first-order Markov
  structure, so a model's loss visibly falls.
* packing — documents are concatenated with EOS separators and cut into
  fixed ``seq_len+1`` windows (inputs = [:-1], labels = [1:]), never
  padding.
* :class:`TokenBatcher` — yields {tokens, labels} numpy batches;
  :func:`make_batch_iterator` puts them on a device as tensors (the card
  unless told otherwise).
* each data-parallel rank seeds its own stream (``shard_id``/``num_shards``).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.models.transformer import default_device


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab_size: int = 32_000
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    doc_len_mean: int = 512
    zipf_a: float = 1.2
    n_codebooks: int = 1          # musicgen-style multi-codebook streams

    def __post_init__(self):
        self._rng = np.random.default_rng(
            (self.seed * 1_000_003 + self.shard_id) & 0x7FFFFFFF)
        v = self.vocab_size
        # Zipf unigram distribution over the vocab (token 0 reserved = EOS)
        ranks = np.arange(1, v, dtype=np.float64)
        p = 1.0 / ranks ** self.zipf_a
        self._unigram = p / p.sum()
        # cheap first-order structure: each token deterministically biases
        # the next draw towards a "successor band" of the vocab
        self._band = 64

    def _sample_doc(self) -> np.ndarray:
        n = max(8, int(self._rng.exponential(self.doc_len_mean)))
        toks = np.empty((n,), np.int32)
        t = 1 + self._rng.choice(self.vocab_size - 1, p=self._unigram)
        for i in range(n):
            toks[i] = t
            if self._rng.random() < 0.7:       # stay in successor band
                lo = (t * 7919) % (self.vocab_size - self._band - 1) + 1
                t = lo + int(self._rng.integers(self._band))
            else:                               # re-draw from unigram
                t = 1 + self._rng.choice(self.vocab_size - 1,
                                         p=self._unigram)
        return toks

    def token_stream(self) -> Iterator[int]:
        while True:
            yield from self._sample_doc()
            yield 0                              # EOS separator


class TokenBatcher:
    """Packs the stream into (batch, seq_len) {tokens, labels} batches."""

    def __init__(self, dataset: SyntheticLMDataset, batch: int,
                 seq_len: int):
        self.ds = dataset
        self.batch = batch
        self.seq_len = seq_len
        self._stream = dataset.token_stream()

    def _window(self) -> np.ndarray:
        n = self.seq_len + 1
        return np.fromiter(self._stream, np.int32, count=n)

    def __iter__(self):
        return self

    def __next__(self):
        rows = np.stack([self._window() for _ in range(self.batch)])
        tokens, labels = rows[:, :-1], rows[:, 1:]
        if self.ds.n_codebooks > 1:
            k = self.ds.n_codebooks
            tokens = np.stack([(tokens + i) % self.ds.vocab_size
                               for i in range(k)], axis=-1)
            labels = np.stack([(labels + i) % self.ds.vocab_size
                               for i in range(k)], axis=-1)
        return {"tokens": tokens, "labels": labels}


def make_batch_iterator(cfg, batch: int, seq_len: int, *, seed: int = 0,
                        device=None, shard_id: int = 0, num_shards: int = 1):
    """Arch-aware iterator: emits the right input structure per config
    (tokens / codebook tokens / embedding stubs) as tensors on ``device``
    (``cuda:0`` unless another is named)."""
    device = default_device(device)
    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seed=seed,
                            shard_id=shard_id, num_shards=num_shards,
                            n_codebooks=cfg.n_codebooks)
    batcher = TokenBatcher(ds, batch, seq_len)
    rng = np.random.default_rng(seed + 17)

    def gen():
        for b in batcher:
            if cfg.input_mode == "embeddings":
                # vlm stub frontend: patch embeddings + M-RoPE positions
                b = {
                    "embeds": rng.standard_normal(
                        (batch, seq_len, cfg.d_model)).astype(np.float32),
                    "positions": np.tile(
                        np.arange(seq_len, dtype=np.int32)[None, None],
                        (3, batch, 1)),
                    "labels": b["labels"],
                }
            yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in b.items()}

    return gen()
