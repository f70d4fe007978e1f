"""Process start to window start: import, kernel library, the cell's
objects and the untimed pass."""
UNIT, BETTER = "s", "lower"


def read(obs):
    return obs.setup_s
