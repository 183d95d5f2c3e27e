"""The benchmark of the PyTorch port (``sgg_torch``): see ``run.py`` for a
run, ``BENCHMARK.json`` at the repository's root for its cells and
metrics."""
