"""Process start to the window's opening (the first due arrival): imports,
the weights, the engine, kernel builds and graph captures, and any set-up
the traffic needs (a session's prefill)."""


def read(r):
    return r.win["setup_s"]
