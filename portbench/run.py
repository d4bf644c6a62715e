"""Run one cell of the port's benchmark on this machine's card:

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output, and each
number that decides ``correct`` beside its limit, last on standard error.
Exits 2, printing no result, where the machine has fewer CUDA devices than
the cell asks for or the checkout lacks the program.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for numpy's and torch's CPU pools: the cells' host work
# is small operations, and a run is one process with few threads
for _v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_v] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
