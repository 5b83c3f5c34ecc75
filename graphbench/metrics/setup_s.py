"""setup_s: seconds from the process's start to the window's start
(imports, CUDA init, kernel load or build, input generation, the port's
ingest, the warm-up iteration)."""
NAME, UNIT = "setup_s", "s"
LAYER = MOVES = None


def read(run):
    return run.setup_s
