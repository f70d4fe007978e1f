"""Host seconds a pass in the program's ``validator.graphs.release`` spans
(``ChainGraphs.close``: every graph reset, the pools handed back to the
device by ``torch.cuda.empty_cache``), the mean over the passes the
profiler did not record; None where no graph ran (the CPU)."""
from gpubench import program_spans

UNIT, BETTER = "s", "lower"


def read(obs):
    return program_spans.mean_seconds(obs, "validator.graphs.release")
