"""Seconds to validate a node: the window over the passes it completed."""
UNIT, BETTER = "s", "lower"


def read(obs):
    return obs.window_s / len(obs.passes) if obs.passes else None
