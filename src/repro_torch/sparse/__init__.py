"""Seeded graph generators and graph-matrix utilities."""
