"""Host seconds a pass in the program's ``validator.graphs.capture`` spans
(``ChainGraphs._capture``: the unit's buffer, the step that loads its
kernels and the capture), the mean over the passes the profiler did not
record; None where no graph ran (the CPU)."""
from gpubench import program_spans

UNIT, BETTER = "s", "lower"


def read(obs):
    return program_spans.mean_seconds(obs, "validator.graphs.capture")
