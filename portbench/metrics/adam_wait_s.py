"""Host Adam: the trainer's wait for the optimizer stage, a step: the
session's ``optim_gate_s`` summed over the window's steps, plus the final
``synchronize()`` that drains the last step's Adam stage."""


def read(record: dict):
    steps = record.get("steps")
    if not steps:
        return None
    return (record["sums"]["optim_gate_s"] + record["sync_tail_s"]) / steps
