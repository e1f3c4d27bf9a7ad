"""Test configuration for every test directory: one share of the cores per
pytest-xdist worker.

torch's intra-op pool defaults to one thread a core. Under `-n N` that is N
pools on the same cores, and the port's small CPU ops then spend most of
their time waiting for each other at the pool's barriers. Each worker keeps
`cpu_count // N` threads instead (at least one). Outside xdist nothing
changes: a single-process run keeps every core.

torch is imported in the hook, not here, so that `tests/conftest.py` still
imports and configures JAX first. Environment variables (`OMP_NUM_THREADS`
and the like) are left as they are: they would also set numpy's BLAS
threads under the JAX package's tests. No port test sets torch's thread
count itself; this file owns it.
"""

import os


def pytest_configure():
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
