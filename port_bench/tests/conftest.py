"""The benchmark's CPU tests: `python -m pytest port_bench/tests -q` from
the repository's root. Nothing here needs a card."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
