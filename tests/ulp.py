"""One-ulp moves for the port's tests: half of the entries of an array (or
of every array of a dict tree) moved by one float32 ulp, up or down at
random.  These are rounding-sized changes at every product, as another
summation order makes, so a float32 computation run on them shows its own
spread.  Imports neither JAX nor the port, so that the card's tests can use
it."""
import numpy as np


def one_ulp(a, seed: int):
    """``a``, an array or a dict tree of arrays, moved (draws from
    ``seed``; a tree's keys in sorted order)."""
    rng = np.random.default_rng(seed)

    def move(a):
        if isinstance(a, dict):
            return {k: move(a[k]) for k in sorted(a)}
        up = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
        moved = np.nextafter(a, up.astype(np.float32))
        return np.where(rng.random(a.shape) < 0.5, moved, a)
    return move(a)
