"""The benchmark's harness: the yardstick that measures ``rpst_torch``.

``run.py`` resolves a cell of ``BENCHMARK.json`` to its configuration,
traffic mix, limits and per-layer readers (``manifest``), builds the port's
objects from seeded weights (``program``), drives the mix's kind
(``serve``: a closed loop of clients on ``DynamicBatcher``; ``train``:
``train_step`` at the mix's batch), traces a sub-window with
``torch.profiler`` when asked (``trace``), and judges the timed path's
outputs against the configuration's plain reference (``check``). Nothing
here imports ``jax`` or the JAX package ``rpst``.
"""
