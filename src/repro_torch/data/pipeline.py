"""Deterministic synthetic LM data pipeline (numpy only).

Port of ``src/repro/data/pipeline.py``: ``SyntheticTextDataset`` and
``DataLoader``, copied so that the port feeds its trainer the same batches
as the reference without importing it.  Fine-tuning-shaped workloads without
external corpora: a seeded Markov-ish token generator with document
boundaries, packed into fixed-length training sequences (labels shifted,
cross-document positions masked with -100), with per-process sharding for
data parallelism.  Deterministic given (seed, step) so multi-host shards
never overlap and runs are reproducible.  ``make_batch_specs`` gives the
resident train step's batch shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticTextDataset:
    """Synthetic 'domain corpus' with zipfian unigrams + local structure."""

    vocab: int
    seed: int = 0
    mean_doc_len: int = 512
    bos: int = 1
    eos: int = 2

    def doc(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 20) ^ index)
        length = max(8, int(rng.exponential(self.mean_doc_len)))
        # zipf-ish unigram + a local repeat process (compressible structure)
        base = rng.zipf(1.3, size=length) % (self.vocab - 8) + 4
        out = base.copy()
        repeat = rng.random(length) < 0.3
        out[1:][repeat[1:]] = out[:-1][repeat[1:]]
        out[0] = self.bos
        out[-1] = self.eos
        return out.astype(np.int32)


class DataLoader:
    """Packs documents into (tokens, labels) batches, sharded per process."""

    def __init__(self, dataset: SyntheticTextDataset, *, batch: int,
                 seq_len: int, process_index: int = 0,
                 process_count: int = 1) -> None:
        self.ds = dataset
        self.batch = batch
        self.seq_len = seq_len
        self.process_index = process_index
        self.process_count = process_count
        self._next_doc = process_index
        self._buffer = np.empty(0, np.int32)

    def _fill(self, n_tokens: int) -> np.ndarray:
        parts = [self._buffer]
        total = self._buffer.size
        while total < n_tokens:
            doc = self.ds.doc(self._next_doc)
            self._next_doc += self.process_count   # disjoint host shards
            parts.append(doc)
            total += doc.size
        flat = np.concatenate(parts)
        self._buffer = flat[n_tokens:]
        return flat[:n_tokens]

    def next_batch(self) -> dict[str, np.ndarray]:
        n = self.batch * (self.seq_len + 1)
        flat = self._fill(n).reshape(self.batch, self.seq_len + 1)
        tokens = flat[:, :-1]
        labels = flat[:, 1:].astype(np.int32)
        # never train across a document boundary: mask positions whose
        # target is the BOS of the next document
        labels = np.where(labels == self.ds.bos, -100, labels)
        return {"tokens": np.ascontiguousarray(tokens),
                "labels": np.ascontiguousarray(labels)}



def make_batch_specs(batch: int, seq_len: int):
    """The (tokens, labels) batch as :class:`~repro_torch.models.registry.
    TensorSpec` records (shape, dtype), allocation-free."""
    import torch
    from repro_torch.models.registry import TensorSpec
    return {"tokens": TensorSpec((batch, seq_len), torch.int32),
            "labels": TensorSpec((batch, seq_len), torch.int32)}
