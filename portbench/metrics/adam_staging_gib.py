"""Host Adam's staging arena: the tracker's ``optimizer_stream``
component at its peak, in GiB."""

GIB = 1 << 30


def read(record: dict):
    comp = record["tracker"].get("optimizer_stream")
    return comp["peak_allocated"] / GIB if comp else None
