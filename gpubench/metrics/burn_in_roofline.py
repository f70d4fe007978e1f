"""% of the burn_in chains' roofline in the traced passes: the least time of
the steps they ran (``roofline``) over the device seconds launched inside
those chain calls, whatever kernels ran."""
UNIT, BETTER = "%", "higher"


def read(obs):
    return obs.roofline("burn_in")
