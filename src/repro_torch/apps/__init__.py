"""Applications over the SpMM operator (PageRank)."""
