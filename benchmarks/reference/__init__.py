"""The plain reference of the benchmark: the training step and the eval
forward of the cells' configurations written out again in plain PyTorch
and numpy, with no kernel, no cache and no batching trick (no pair
ladder, no union dedup), and a data pipeline that decodes the cells'
JPEG files itself.

It imports nothing of the program (the package under test) nor of JAX:
``benchmarks/tests`` scans it. What the program derives from the shared
inputs (the canvases, the sampled edges, the dropout masks, the
perturbation) it works out again from the seed and the files.
"""
