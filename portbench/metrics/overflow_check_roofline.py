"""Kernels: the overflow screen's share of its roofline, in %.  The
least time the screen can take, every gradient leaf read once in fp32
at the H100's 3.35e12 B/s (``count.py``), over the device time of the
``overflow_kernel`` launches in the traced window.  Nothing to read
without a device trace or where the launches are not one a leaf a
step."""

import count
import tracing


def read(record: dict):
    reduced = record.get("trace")
    steps = record.get("steps")
    if not reduced or not steps or \
            record["screen_launches"] != steps * record["leaves"]:
        return None
    seconds = tracing.kernel_seconds(reduced, "overflow_kernel")
    if seconds <= 0:
        return None
    bound = steps * record["screen_bytes_per_step"] / count.H100_HBM_BYTES_S
    return 100.0 * bound / seconds
