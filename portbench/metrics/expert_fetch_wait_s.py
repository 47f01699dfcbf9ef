"""Expert paging: the executor's wait at the expert fetch gates (the
session's ``expert_fetch_wait_s``), summed over the window's steps, a
step.  Nothing to read where the experts are not paged."""


def read(record: dict):
    steps = record.get("steps")
    if not steps or not record.get("expert_paging"):
        return None
    return record["sums"]["expert_fetch_wait_s"] / steps
