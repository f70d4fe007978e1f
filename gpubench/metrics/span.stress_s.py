"""Host seconds per pass inside ``workloads.hbm_stress``,
timed by the taps."""
UNIT, BETTER = "s", "lower"


def read(obs):
    return obs.span_per_pass_s("stress")
