"""Pinned allocator and buffer pool: the share of the pinned bytes
reserved at the peak that no caller asked for, 100 x (1 - requested /
reserved), in %."""


def read(record: dict):
    comp = record["tracker"].get("pinned")
    if not comp or not comp["peak_allocated"]:
        return None
    return 100.0 * (1.0 - comp["peak_requested"] / comp["peak_allocated"])
