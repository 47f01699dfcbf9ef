"""Expert paging: the GiB of expert pages read back from the store into
host page slots (the page cache's ``PageStats.refill_bytes`` over the
window), a step.  Nothing to read where the driver records no page
statistics."""

GIB = 1 << 30


def read(record: dict):
    steps = record.get("steps")
    refill = record.get("pages", {}).get("refill_bytes")
    if not steps or refill is None:
        return None
    return refill / GIB / steps
