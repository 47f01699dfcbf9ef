"""The KDA mixer: the device seconds of its chunked forwards (the
backward's recompute included) and of their backwards, a step: the
session's ``kda_device_seconds`` over the window (CUDA events around
the spans ``kda.fwd`` and ``kda.bwd``).  Nothing to read from a port
without that counter, or on the CPU, where it stays 0."""


def read(record: dict):
    steps = record.get("steps")
    seconds = record.get("counters", {}).get("kda_device_seconds")
    if not steps or not seconds:
        return None
    return seconds / steps
