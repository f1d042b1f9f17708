"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``); the numbers compared
against the reference, each beside its limit, end standard error and the
line (``checks``).  Without the cards the cell asks for, or with JAX or
the JAX package loaded, it prints no result and exits with 2.
"""

import sys
import time

T0 = time.perf_counter()  # set-up is timed from here

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
