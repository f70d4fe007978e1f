"""Host seconds per pass inside ``workloads.matmul_burn_in``,
timed by the taps."""
UNIT, BETTER = "s", "lower"


def read(obs):
    return obs.span_per_pass_s("burn_in")
