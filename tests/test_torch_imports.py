"""The PyTorch port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX, ``ml_dtypes`` or the reference package —
the machine with the card has none of them.  And ``repro_torch.core``
exports the public names ``repro.core`` does, less those that have no
counterpart by decision."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_port_has_modules():
    assert len(FILES) > 20


@pytest.mark.parametrize("module", [
    "core/loss_scale.py", "core/overflow.py", "core/optimizer.py",
    "core/session.py", "kernels/overflow_check.py", "kernels/ops.py",
    "kernels/fused_adam.py", "serve/request.py", "serve/spec.py",
    "serve/scheduler.py", "core/checkpoint.py", "data/pipeline.py",
    "models/moe.py", "core/paged.py"])
def test_training_slice_modules_are_scanned(module):
    assert ROOT / "src" / "repro_torch" / module in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


# the jnp overflow screens have no counterpart by decision (ROADMAP.md,
# Queue 1); the port's host bf16 bridge has none in the reference, which
# keeps host bf16 as ml_dtypes arrays
NO_COUNTERPART = {"baseline_overflow_check_jnp", "fused_overflow_check_jnp"}
PORT_ONLY = {"dtypes"}


def test_core_exports_the_reference_names():
    import repro.core
    import repro_torch.core
    ref = set(repro.core.__all__) - NO_COUNTERPART
    port = set(repro_torch.core.__all__) - PORT_ONLY
    assert port == ref, (f"missing {sorted(ref - port)}, "
                         f"extra {sorted(port - ref)}")
