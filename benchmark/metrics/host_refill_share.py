"""Engine host: the share of the window, in percent, that the engine's host
spent refilling the device (the ``host`` counters of ``engine.payload()``:
each stretch from a blocking fetch's return to the return of the next chunk
or step launch, in which the device can only idle for the host), read when
the window opened and closed. Same unit as ``device_idle_share``. None
where the program counts no refills."""


def read(r):
    h0, h1 = r.counters0.get("host"), r.counters1.get("host")
    if not h0 or not h1:
        return None
    t0, t1 = r.win["t0"], r.win["t1"]
    return 100.0 * (h1["refill_s"] - h0["refill_s"]) / (t1 - t0)
