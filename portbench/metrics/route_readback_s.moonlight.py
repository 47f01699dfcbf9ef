"""Expert paging: the executor's wait to read each MoE route stage's
expert ids back to the host (the session's
``expert_route_readback_seconds`` over the window), a step.  Nothing to
read from a port without that counter."""


def read(record: dict):
    steps = record.get("steps")
    seconds = record.get("counters", {}).get(
        "expert_route_readback_seconds")
    if not steps or seconds is None:
        return None
    return seconds / steps
