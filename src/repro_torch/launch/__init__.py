"""Launchers: the batched serving loop, the training loop, the production
meshes and per-cell sharding policy (``mesh``), the dry run over
placeholder ranks (``dryrun``), its roofline report (``roofline``) and the
per-rank op-cost counter they read (``cost_analysis``, which stands for
the JAX package's ``hlo_analysis.py``: PyTorch produces no HLO text)."""
