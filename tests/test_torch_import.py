"""The port stands alone: importing every ``repro_torch`` module, or any
of the port's examples (``examples_torch/``), pulls in neither jax nor
any module of the reference package, and no source file of the port
(its examples, or ``chip_smoke.py``) names one."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))",
    re.MULTILINE)


def _port_modules():
    import repro_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_has_every_subpackage():
    names = set(_port_modules())
    for sub in ("configs", "data", "core", "kernels", "models",
                "sampling", "serving", "teamllm"):
        assert f"repro_torch.{sub}" in names, sub


def _imports_leave_jax_and_repro_unimported(load: str) -> None:
    """Run ``load`` (python statements importing port code) in a fresh
    interpreter with only ``src`` on the path, then require that no
    module of jax or of the reference package was imported."""
    snippet = (
        "import importlib, importlib.util, sys\n" + load +
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", snippet], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_importing_the_port_leaves_jax_and_repro_unimported():
    _imports_leave_jax_and_repro_unimported(
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n")


def test_importing_the_examples_leaves_jax_and_repro_unimported():
    paths = sorted(str(p) for p in EXAMPLES.glob("*.py"))
    assert len(paths) == 4, paths
    _imports_leave_jax_and_repro_unimported(
        f"for i, p in enumerate({paths!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'ex{i}', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + [str(p.relative_to(ROOT)) for p in EXAMPLES.glob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax_or_repro(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from repro.models import params", "import repro",
                 "    from jax import lax"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.kernels import ops",
                 "# a comment about jax"):
        assert not _FORBIDDEN.search(line), line
