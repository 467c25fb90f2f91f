"""Torch's CPU thread count in the port's tests.

The suite's usual command runs the tests in six xdist workers on the
machine's cores (ROADMAP.md, "Tier-1 verify").  With torch's default, an
OpenMP thread a core in every worker, the workers' threads outnumber the
cores several times over and wait on each other at every parallel region:
two port tests that take 12 s alone took 463 s each as six copies ran
together, and 11-14 s each at two threads a process.  Every port test
module calls :func:`limit` when it is imported."""

import torch

THREADS = 2


def limit() -> None:
    torch.set_num_threads(THREADS)
