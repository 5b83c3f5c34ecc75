"""Sharded scans (one store's tile rows split across executors, on one
card or several), the training loop's fault handling (straggler
detection, heartbeats, elastic re-mesh plans), and the distributed
tooling over ``torch.distributed``: logical sharding rules and their
DTensor placements (``sharding``), hierarchical, bucketed and int8
gradient reductions (``collectives``), all-to-all MoE dispatch
(``moe_a2a``) and GPipe pipelining (``pipeline``).

The JAX package's ``distributed/compat.py`` is not ported: it papers over
``shard_map``'s move and renamed keyword across JAX releases, and PyTorch
has no ``shard_map`` to shim."""
