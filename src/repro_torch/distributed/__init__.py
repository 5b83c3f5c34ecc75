"""Sharded scans (one store's tile rows split across executors, on one
card or several) and the training loop's fault handling (straggler
detection, heartbeats, elastic re-mesh plans)."""
