"""Host seconds per pass inside ``microbench.run_microbench``,
timed by the taps."""
UNIT, BETTER = "s", "lower"


def read(obs):
    return obs.span_per_pass_s("probes")
