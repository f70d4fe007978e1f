"""% of the seconds of the program's ``validator.chain`` spans that entered
no number the validator reports: the untimed warm-up call of each point
(``role`` ``warm``) and every call under a ``validator.escalation`` level
that was not the last (``final`` false).  Over the passes the profiler did
not record."""
from gpubench import program_spans

UNIT, BETTER = "%", "lower"


def _untimed(span, spans) -> bool:
    if span["attrs"].get("role") == "warm":
        return True
    return any(s["name"] == "validator.escalation"
               and not s["attrs"].get("final")
               for s in program_spans.ancestors(span, spans))


def read(obs):
    untimed = total = 0.0
    for spans in program_spans.per_pass(obs).values():
        for span in spans:
            if span["name"] == "validator.chain":
                seconds = program_spans.seconds(span)
                total += seconds
                if _untimed(span, spans):
                    untimed += seconds
    return 100.0 * untimed / total if total > 0 else None
