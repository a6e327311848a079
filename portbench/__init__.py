"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``run.py`` is the command ``BENCHMARK.json`` names.  Everything a cell is
made of is data found by name: ``configs/<config>.json`` (the model as it
is run), ``mixes/<traffic>.json`` (strategy, batch, sequence, ranks, lr),
``limits/<workload>.json`` (the limits of the ``correct`` comparison),
``metrics/<metric>.py`` (one reader a per-layer metric) and
``reference/<family>.py`` (the plain fp32 model a configuration names).
The yardstick (token generator, operation and byte counts, peaks, trace
arithmetic) lives here too, frozen, so a change to the program cannot
move it.  Nothing here imports ``jax`` or the JAX package.
"""
