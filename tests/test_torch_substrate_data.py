"""The reference's ``tests/test_data.py`` on the port: its ``repro``
imports read ``repro_torch``.
"""

import numpy as np
import torch

from repro_torch.data import DataLoader, SyntheticTextDataset

torch.set_num_threads(2)


def test_deterministic():
    a = DataLoader(SyntheticTextDataset(vocab=128, seed=7), batch=4,
                   seq_len=16).next_batch()
    b = DataLoader(SyntheticTextDataset(vocab=128, seed=7), batch=4,
                   seq_len=16).next_batch()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_shapes_and_ranges():
    dl = DataLoader(SyntheticTextDataset(vocab=128, seed=0), batch=4,
                    seq_len=16)
    for _ in range(3):
        b = dl.next_batch()
        assert b["tokens"].shape == (4, 16)
        assert b["tokens"].min() >= 0 and b["tokens"].max() < 128
        valid = b["labels"][b["labels"] >= 0]
        assert valid.max() < 128


def test_boundary_masking():
    dl = DataLoader(SyntheticTextDataset(vocab=64, seed=0, mean_doc_len=8),
                    batch=2, seq_len=64)
    b = dl.next_batch()
    # labels never train into a BOS (document start)
    assert not (b["labels"] == dl.ds.bos).any()


def test_host_shards_disjoint():
    ds = SyntheticTextDataset(vocab=128, seed=3)
    d0 = DataLoader(ds, batch=2, seq_len=32, process_index=0,
                    process_count=2)
    d1 = DataLoader(ds, batch=2, seq_len=32, process_index=1,
                    process_count=2)
    b0, b1 = d0.next_batch(), d1.next_batch()
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    # doc indices are interleaved: 0,2,4,... vs 1,3,5,...
    assert d0._next_doc % 2 == 0 and d1._next_doc % 2 == 1
