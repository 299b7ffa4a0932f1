"""Device ops of the invalidation wave: bit packing, the ``or_popcount``
finalizer and the dense BFS wave (``wave_expand``), each hand-written
kernel beside its plain PyTorch version."""
