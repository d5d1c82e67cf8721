"""Nothing the benchmark loads is JAX or the JAX package: a fresh
process imports ``perfbench.run``, runs a tiny cell through the harness
on the CPU and lists every loaded module whose top-level name, compared
whole, is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (``repro_torch``
begins with ``repro`` and is allowed)."""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

SCRIPT = """
import json, sys, tempfile, time
from pathlib import Path
sys.path[:0] = [{src!r}, {root!r}]
import perfbench.run
import torch
torch.set_num_threads(2)
from perfbench.harness import cell
from perfbench.tests import tiny
root = Path(tempfile.mkdtemp())
pkg = tiny.layout(root)
for w in ("tiny-dense.tiny", "tiny-mamba.tiny"):
    cell.run_cell(root, w, 5, 0.5, False, "cpu", time.perf_counter(), pkg,
                  log=lambda *_: None)
print(json.dumps({{"forbidden": cell.forbidden_modules(),
                  "torch_port": "repro_torch" in sys.modules}}))
"""


def test_nothing_loaded_is_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c",
         SCRIPT.format(src=str(ROOT / "src"), root=str(ROOT))],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "torch_port": True}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from perfbench.harness import cell
    monkeypatch.setitem(sys.modules, "repro_torchlike.x", sys)
    assert "repro_torchlike.x" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.serving", sys)
    assert "repro.serving" in cell.forbidden_modules()
