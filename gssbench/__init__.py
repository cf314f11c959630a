"""The benchmark of ``repro_torch``, the PyTorch/CUDA port of pdGRASS.

One command runs one cell (a graph configuration under one traffic mix)
once and prints one JSON line::

    python3 gssbench/run.py --workload mesh2d-1024.solve-b32 --seed 7 \
        --seconds 51 --trace 0

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json`` (the graph and the solver settings),
``traffic/<traffic>.json`` (the kind of loop and its parameters),
``graphs/<family>.py`` (the generator of the graph family) and
``metrics/<metric>.py`` (one reader a metric).  The yardstick lives here
too: the frozen copies of the program's generators and byte formulas, and
the plain reference that decides ``correct``.
Nothing in this package imports ``jax`` or the JAX package ``repro``;
the reference imports nothing of ``repro_torch``.
"""
