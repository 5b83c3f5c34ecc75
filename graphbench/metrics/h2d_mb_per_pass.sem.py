"""h2d_mb_per_pass.sem: megabytes the engine staged host to device
(``IOStats.h2d_bytes``) a SEM pass, over the window: a count."""
NAME, UNIT = "h2d_mb_per_pass.sem", "MB"
LAYER, MOVES = "storage, staging", "sem_iter_s"


def read(run):
    if not run.counters["passes"]:
        return None
    return run.counters["h2d_bytes"] / run.counters["passes"] / 1e6
