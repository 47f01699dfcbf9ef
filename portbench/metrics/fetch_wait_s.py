"""Plan executor and streams: the compute thread's wait for device
weights at the plan's fetches (the session's ``fetch_wait_s``), summed
over the window's steps, a step."""


def read(record: dict):
    steps = record.get("steps")
    return record["sums"]["fetch_wait_s"] / steps if steps else None
