"""Share of the traced window in which no operation ran on the device (the
union of the device operations' intervals against the window)."""


def read(run):
    if not run.device_ops or not run.window_s > 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.window_s)
