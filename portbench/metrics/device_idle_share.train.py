"""The device's idle share of the traced training window, in %: 100 x
(1 - the union of kernel, copy and fill intervals / the window)."""


def read(record: dict):
    reduced = record.get("trace")
    if not reduced or reduced["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - reduced["busy_s"] / reduced["window_s"])
