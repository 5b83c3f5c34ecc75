"""Core formats, semirings, SpMM paths and the semi-external engine."""
