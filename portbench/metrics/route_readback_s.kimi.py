"""``route_readback_s.moonlight``, read the same way in the Kimi Linear
cell: the route stages' readback of the expert ids a step."""

from pathlib import Path

from bench import load_module

read = load_module(Path(__file__).with_name("route_readback_s.moonlight.py"),
                   "portbench_metric_route_readback_s.moonlight").read
