"""PyTorch/CUDA port of stcd_tpu for one NVIDIA H100.

The layout mirrors ``stcd_tpu/``: a module's counterpart lives under the
same path. The package imports torch, numpy and (lazily) PIL, and never JAX
or ``stcd_tpu``. Importing it builds nothing: the CUDA kernels are compiled
at their first launch (``ops/_build.py``).
"""
