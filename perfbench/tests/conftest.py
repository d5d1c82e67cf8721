"""The benchmark's tests run from the checkout's root on the CPU (those
that need a card say so inside the test and skip): the checkout and
its ``src`` go on the import path."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
