"""spmm_roofline.sem: the summed least time of the window's SEM products
(roofline.py: the live lanes of the stored planes, the operand read once
and the output written once, against HBM and float32 peaks) as a share of
the device time of every kernel launched inside their ``dot`` spans."""
from graphbench import roofline

NAME, UNIT = "spmm_roofline.sem", "%"
LAYER, MOVES = "kernels", "sem_iter_s"
SPAN = "gb.dot.sem"


def read(run):
    if run.trace is None:
        return None
    kernel_s = run.trace.kernel_s_in(SPAN)
    work = [(b, f) for span, b, f in run.products if span == SPAN]
    if not work or kernel_s <= 0:
        return None
    return 100.0 * sum(roofline.bound_s(b, f) for b, f in work) / kernel_s
