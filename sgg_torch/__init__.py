"""PyTorch port of ``sgg_tpu`` for one NVIDIA H100.

The package mirrors ``sgg_tpu``'s module paths so each part has an obvious
counterpart. It imports ``torch`` and numpy and nothing of JAX or of
``sgg_tpu``; the framework-neutral modules it needs are its own copies.
Importing it builds nothing: the CUDA kernels under ``csrc/`` are compiled
at their first launch (``ops/_cuda.py``).
"""
