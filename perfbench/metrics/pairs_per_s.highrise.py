"""``pairs_per_s`` of the high-rise cell, under a bound of its own: pairs
completed in the window over the window's time, the window ending at the
end of the last whole pair."""


def read(run):
    return run.units / run.window_s if run.requests else None
