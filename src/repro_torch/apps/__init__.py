"""Applications over the SpMM operator (PageRank, NMF, the eigensolver,
label propagation)."""
