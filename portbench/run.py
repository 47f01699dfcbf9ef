"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout.  One process on the card: it loads,
warms up, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output.  See ``bench.py``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# every build and kernel cache at a fixed place inside the checkout
_CACHE = os.path.join(ROOT, "build", "portbench")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = os.path.join(_CACHE, _sub)

if HERE not in sys.path:
    sys.path.insert(0, HERE)
_SRC = os.path.join(ROOT, "src")
if _SRC not in sys.path:
    sys.path.insert(1, _SRC)

from rss import RssPeak  # noqa: E402

if __name__ == "__main__":
    rss = RssPeak().start()
    import bench  # noqa: E402
    sys.exit(bench.main(sys.argv[1:], t_start=T_START, rss=rss))
