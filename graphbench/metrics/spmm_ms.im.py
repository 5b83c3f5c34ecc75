"""spmm_ms.im: the mean wall time of one IM product (a ``dot`` span:
``IMOperator.dot``, its copies to and from the host included)."""
NAME, UNIT = "spmm_ms.im", "ms"
LAYER, MOVES = "engine", "im_iter_s"


def read(run):
    spans = [] if run.trace is None else run.trace.span_s("gb.dot.im")
    return 1e3 * sum(spans) / len(spans) if spans else None
