"""The whole training step's share of the H100's dense bf16 peak
(989e12 FLOP/s), in %: the model FLOPs of the window's steps
(``count.py``: 6 x matrix parameters a token passes through x tokens,
plus causal attention; no recompute) over the window's seconds."""

import count


def read(record: dict):
    steps = record.get("steps")
    if not steps or "step_flops" not in record:
        return None
    return 100.0 * steps * record["step_flops"] / (
        record["window_s"] * count.H100_BF16_FLOPS)
