"""Run one benchmark cell once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints the cell's metrics as one JSON line,
last on standard output; see ``portbench/README.md``.
"""

import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent)]
    from pbench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
