"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` is the entry point; ``BENCHMARK.json`` at the repository's
root names the cells. Everything a cell needs is found by name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and ``limits/<workload>.json``. ``counts/``
holds the operation and byte counts and the table of peaks,
``reference/`` the plain PyTorch reference that decides ``correct``.
Nothing here imports ``jax`` or the JAX package ``repro``.
"""
