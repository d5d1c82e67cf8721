"""The port stands alone: importing every ``repro_torch`` module pulls in
neither jax nor any module of the reference package, and no source file
of the port (or ``chip_smoke.py``) names one."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

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
                "sampling", "serving"):
        assert f"repro_torch.{sub}" in names, sub


def test_importing_the_port_leaves_jax_and_repro_unimported():
    mods = _port_modules()
    snippet = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run([sys.executable, "-c", snippet], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
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
