"""im_iter_s: the window's wall time over the application iterations it
completed, over the IM operator."""
NAME, UNIT = "im_iter_s", "s"
LAYER = MOVES = None


def read(run):
    if run.operator != "im" or not run.iterations:
        return None
    return run.window_s / run.iterations
