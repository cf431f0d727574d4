"""Tests of the benchmark harness.  Run from the repository root:

    python -m pytest portbench/tests -q

``cuda``-marked tests decide inside the test whether a card is there and
skip without one; on the card run them with ``-m cuda``."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
