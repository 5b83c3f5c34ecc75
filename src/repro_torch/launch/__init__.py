"""Launchers: the batched serving loop and the training loop."""
