"""The benchmark of `redisson_tpu_torch`: one run of one cell.

    python3 gridbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output; see `harness/runner.py`.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gridbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
