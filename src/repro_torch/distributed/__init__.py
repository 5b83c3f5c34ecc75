"""Sharded scans: one store's tile rows split across executors, on one
card or several."""
