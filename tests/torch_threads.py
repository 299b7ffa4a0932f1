"""One intra-op torch thread for every test process that runs the port.

The parity cases run small tensors on the CPU, where a pool of threads a
process buys nothing: the port's files run faster on one. Under the tier-1
run's six xdist workers the default pools (one thread a core, a pool a
worker) oversubscribe the CPU, and the stretched event-loop turns break the
wall-clock schedules that the reference's chaos and breaker cases rely on,
in whichever package's worker runs them. Imported by every
``tests/test_torch_*.py`` but the card-only file."""
import torch

torch.set_num_threads(1)
