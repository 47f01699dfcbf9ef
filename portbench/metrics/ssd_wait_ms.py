"""Swapper and SSD store: the swapper's blocked time in the window
(``swapper.stats.wait_seconds``) a token step (a prefill or a decode
step of the batch), in ms."""


def read(record: dict):
    steps = record.get("token_steps")
    return 1e3 * record["swap_wait_s"] / steps if steps else None
