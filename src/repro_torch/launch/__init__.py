"""Launchers: the batched serving loop."""
