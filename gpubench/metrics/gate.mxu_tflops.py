"""The tensor-core reading the perf gate wrote to ``perf-report``
(``mxu_tflops``), median over the passes: the program's output, not the
benchmark's clock."""
import statistics

UNIT, BETTER = "TFLOP/s", "higher"


def read(obs):
    values = [float(r["perf-report"]["mxu_tflops"]) for r in obs.reports
              if "mxu_tflops" in r.get("perf-report", {})]
    return statistics.median(values) if values else None
