"""The benchmark's command: one run of one cell.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
                           --trace <0|1>

from the root of a checkout holding the program (``src/repro_torch``) on
a machine with the cell's CUDA devices. It prints the result as the last
line of standard output, each checked number beside its limit as the
last lines of standard error, and exits 0; without the devices, the
program or with JAX loaded it prints no result and exits 2.
"""

import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

# The checkout root in place of this script's directory, whose module
# names (trace, generate) would shadow others.
sys.path[0] = str(pathlib.Path(__file__).resolve().parents[1])

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
