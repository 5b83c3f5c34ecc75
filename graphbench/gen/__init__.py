"""Input generators of the benchmark (frozen: the program never supplies
its own inputs)."""
