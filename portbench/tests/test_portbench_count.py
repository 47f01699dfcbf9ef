"""The frozen FLOP and byte arithmetic against counts made by hand."""

from __future__ import annotations

import json
import sys

import pytest

from conftest import REPO

sys.path.insert(0, str(REPO / "portbench"))

import count  # noqa: E402
import weights  # noqa: E402


def config(name: str) -> dict:
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_qwen3_4b_by_hand():
    cfg = config("qwen3-4b")
    # q 2560x4096, k and v 2560x1024, o 4096x2560; gate, up, down 2560x9728
    assert count.block_matmul_params(cfg) == \
        2560 * 4096 * 2 + 2560 * 1024 * 2 + 3 * 2560 * 9728 == 100_925_440
    assert count.token_matmul_params(cfg) == 100_925_440 + 2560 * 151_936
    # QK^T and PV: 2 x 2 x 128 FLOPs a (query, key) pair a head, 32 heads,
    # 2 rows of 512 * 513 / 2 causal pairs, one layer
    assert count.attention_flops(cfg, 2, 512) == \
        4 * 128 * 32 * 2 * 131_328 == 4_303_355_904
    assert count.train_step_flops(cfg, 2, 512) == \
        6 * 489_881_600 * 1024 + 3 * 4_303_355_904 == 3_022_742_618_112
    leaves = weights.layout(cfg)
    # embed and head 151936 x 2560 each, the block, five norm vectors
    assert weights.n_params(leaves) == 878_845_696 == \
        2 * 388_956_160 + 100_925_440 + 3 * 2560 + 2 * 128
    assert len(leaves) == 14


def test_qwen3_30b_a3b_by_hand():
    cfg = config("qwen3-30b-a3b")
    # attention 2048x4096 twice, 2048x512 twice; router 2048x128; 8 of the
    # 128 experts, each 3 x 2048 x 768
    assert count.block_matmul_params(cfg) == \
        2 * 2048 * 4096 + 2 * 2048 * 512 + 2048 * 128 + 8 * 3 * 2048 * 768
    paged = weights.layout(cfg, "routed")
    stacked = weights.layout(cfg, "off")
    assert weights.n_params(paged) == weights.n_params(stacked) == \
        1_245_452_544 == 2 * 311_164_928 + 18_874_368 + 262_144 + \
        603_979_776 + 3 * 2048 + 2 * 128
    assert len(paged) == 3 + 9 + 3 * 128 and len(stacked) == 3 + 12


@pytest.mark.parametrize("sizes, want", [
    ([1], 8), ([10, 20], 4 * 30 + 8),
    ([388_956_160, 2560], 4 * 388_958_720 + 8)])
def test_overflow_screen_bytes(sizes, want):
    assert count.overflow_screen_bytes(sizes) == want
