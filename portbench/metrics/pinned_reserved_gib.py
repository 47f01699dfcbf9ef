"""Pinned allocator and buffer pool: the tracker's ``pinned`` component
(the pool arena, the gradient flat buffer) at its peak, reserved bytes,
in GiB."""

GIB = 1 << 30


def read(record: dict):
    comp = record["tracker"].get("pinned")
    return comp["peak_allocated"] / GIB if comp else None
