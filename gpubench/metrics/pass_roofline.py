"""% of the whole pass's roofline: the least time of all the work of every
kind the passes ran (chain steps, memory passes, FMA checks), over their
wall time (passes the profiler did not record)."""
UNIT, BETTER = "%", "higher"


def read(obs):
    passes = obs.untraced()
    wall = sum(t1 - t0 for i, (t0, t1) in enumerate(obs.passes)
               if i in passes)
    least = sum(obs.least_s(k, passes) for k in obs.kinds)
    if wall <= 0 or least <= 0:
        return None
    return 100.0 * least / wall
