"""How far the escalation overshoots its target: per pass, the largest
``hi_s`` (the long chain's best seconds) of a final
``validator.escalation`` level over that level's ``target_s`` (the
program's window as read at run time); the median over the passes the
profiler did not record."""
import statistics

from gpubench import program_spans

UNIT, BETTER = "x", "lower"


def read(obs):
    ratios = []
    for spans in program_spans.per_pass(obs).values():
        finals = [s["attrs"] for s in spans
                  if s["name"] == "validator.escalation"
                  and s["attrs"].get("final")]
        if finals:
            ratios.append(max(a["hi_s"] / a["target_s"] for a in finals))
    return statistics.median(ratios) if ratios else None
