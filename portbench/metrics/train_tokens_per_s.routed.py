"""The routed MoE cell's training rate, kept per layer: every token of
every step in the traced window over the window's seconds, as
``train_tokens_per_s`` takes it.  In that cell the host's memory speed
moves the rate by more than an end-to-end bound can hold (``PERF.md``),
so it is recorded here and bounds nothing."""


def read(record: dict):
    if not record.get("steps") or record["window_s"] <= 0:
        return None
    return record["tokens"] / record["window_s"]
