"""app_ms_per_iter.sem: an iteration's wall time outside its products
(the solve spans less their ``dot`` spans, over the iterations): the
application's self time."""
NAME, UNIT = "app_ms_per_iter.sem", "ms"
LAYER, MOVES = "apps", "sem_iter_s"


def read(run):
    if run.trace is None or not run.iterations:
        return None
    solve = sum(run.trace.span_s("gb.solve"))
    dots = sum(run.trace.span_s("gb.dot.sem"))
    return 1e3 * (solve - dots) / run.iterations
