"""Model step: device milliseconds per prefill chunk, from the flight
recorder's samples of the window (phase ``prefill``)."""


def read(r):
    s = [x for x in r.flight if x.phase == "prefill"]
    return 1e3 * sum(x.seconds for x in s) / len(s) if s else None
