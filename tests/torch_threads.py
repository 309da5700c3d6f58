"""Caps torch's intra-op threads in the port's test modules.

torch starts as many intra-op threads as the machine has cores in every
process. The tier-1 run spreads the suite over several pytest-xdist
workers on one machine, so a worker running the port's tests could take
every core while another worker's wall-clock-bounded tests (the semester
sim's budgets, the lint run's) wait. Every `tests/test_torch_*.py`
imports this module first; the cap holds for the whole worker process.
"""

import torch

# Intra-op threads a test process may use.
THREADS = 2

torch.set_num_threads(THREADS)
