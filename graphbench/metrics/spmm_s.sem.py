"""spmm_s.sem: the mean wall time of one SEM product (a ``dot`` span:
``SEMOperator.dot`` through ``SEMSpMM._stream_pass``)."""
NAME, UNIT = "spmm_s.sem", "s"
LAYER, MOVES = "engine", "sem_iter_s"


def read(run):
    spans = [] if run.trace is None else run.trace.span_s("gb.dot.sem")
    return sum(spans) / len(spans) if spans else None
