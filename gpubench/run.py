"""Run one cell of the port's benchmark once:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
"""

import os
import sys

# the checkout's root, in place of this script's directory, whose module
# names (trace, ...) would shadow the standard library's
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from gpubench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
