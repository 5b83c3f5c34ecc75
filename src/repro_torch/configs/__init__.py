"""Architecture configurations, copied as data from the JAX package."""
