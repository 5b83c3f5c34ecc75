"""link_share.sem: the bytes the SEM products streamed from the store
(``IOStats.bytes_read``) at the host link's peak, as a share of those
products' summed wall time.  Every pass must bring the whole store across
the link, so no pass can read over 100%."""
from graphbench import roofline

NAME, UNIT = "link_share.sem", "%"
LAYER, MOVES = "storage, staging", "sem_iter_s"


def read(run):
    if run.trace is None or not run.counters["bytes_read"]:
        return None
    spans = run.trace.span_s("gb.dot.sem")
    if not spans:
        return None
    return 100.0 * roofline.link_s(run.counters["bytes_read"]) / sum(spans)
