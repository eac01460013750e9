"""A run of a cell with a fault planted in the program (``faults.py``),
for the control's readings on the card:

    python3 flixbench/control.py --fault control --workload <cell> --seed <n> --seconds <s> --trace 0
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parent.parent)
    from flixbench import run

    argv = sys.argv[1:]
    i = argv.index("--fault")
    fault = argv[i + 1]
    del argv[i : i + 2]
    sys.exit(run.main(argv, fault=fault))
