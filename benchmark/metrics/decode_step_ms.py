"""Model step: device milliseconds per decode step, from the flight
recorder's samples of the window (CUDA events around every Nth dispatch's
graph replay): total seconds over steps of phase ``step``."""


def read(r):
    s = [x for x in r.flight if x.phase == "step"]
    steps = sum(x.steps for x in s)
    return 1e3 * sum(x.seconds for x in s) / steps if steps else None
