"""app_ms_per_iter.im: an iteration's wall time outside its products
(the solve spans less their ``dot`` spans, over the iterations): the
application's self time."""
NAME, UNIT = "app_ms_per_iter.im", "ms"
LAYER, MOVES = "apps", "im_iter_s"


def read(run):
    if run.trace is None or not run.iterations:
        return None
    solve = sum(run.trace.span_s("gb.solve"))
    dots = sum(run.trace.span_s("gb.dot.im"))
    return 1e3 * (solve - dots) / run.iterations
