"""The semi-external storage tier (on-disk format shared with the JAX package)."""
