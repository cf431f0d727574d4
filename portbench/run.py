"""Run one cell of the port's benchmark on the card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout; see ``portbench/harness/bench.py``."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness.bench import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
