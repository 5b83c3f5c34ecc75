"""device_idle_share.sem: the share of the traced window in which no
operation (kernel, copy or memset) ran on the card."""
NAME, UNIT = "device_idle_share.sem", "%"
LAYER, MOVES = "device", "sem_iter_s"


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
