"""The benchmark's CPU tests: the checkout's root (for ``fedbench``) and its
``src`` (for the port, which some tests hold the frozen copies against) on
``sys.path``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src"), str(ROOT / "fedbench")):
    if p not in sys.path:
        sys.path.insert(0, p)
