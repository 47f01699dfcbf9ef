"""Router: the share of the forward routing's (token, choice) pairs past
their expert's capacity, in %: 100 x the session's
``expert_dropped_pairs`` over its ``expert_routed_pairs`` over the window
(the pairs the source, which is dropless, would keep).  Nothing to read
from a port without those counters."""


def read(record: dict):
    counters = record.get("counters", {})
    routed = counters.get("expert_routed_pairs")
    dropped = counters.get("expert_dropped_pairs")
    if not routed or dropped is None:
        return None
    return 100.0 * dropped / routed
