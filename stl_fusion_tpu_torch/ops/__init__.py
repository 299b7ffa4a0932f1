"""Device ops of the invalidation wave: bit packing, the ``or_popcount``
finalizer, the BFS level (``wave_expand``: pure, merged, and for every shard
of a mesh at once) and the ring all-gather, each hand-written kernel beside
its plain PyTorch version."""
