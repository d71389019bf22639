"""The benchmark of the PyTorch and CUDA port, ``kajo_tpu_torch``.

Run one cell (a configuration under a traffic mix, as ``BENCHMARK.json``
names them) on the CUDA device::

    python3 benchmark/run.py --workload caustics.progressive --seed 7 --seconds 15 --trace 0

Everything is found by name under this folder: a configuration in
``configs/<name>.json`` (its scene in ``scenes/``), a traffic mix in
``traffic/<name>.json``, a cell's engine and correctness limits in
``workloads/<name>.json``, the job that drives a traffic kind in
``jobs/<job>.py``, an engine's batch entry in ``engines/<engine>.json``,
and each metric's reader in ``metrics/<metric>.py``. ``reference/`` is the
plain reference that decides ``correct``. Nothing here imports ``jax`` or
the JAX package.
"""
