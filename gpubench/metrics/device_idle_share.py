"""Share of the traced window in which nothing ran on the card."""
UNIT, BETTER = "%", "lower"


def read(obs):
    if obs.trace is None or obs.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - obs.trace.busy_s / obs.trace.window_s)
