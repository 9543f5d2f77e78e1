"""DFL-DDS on PyTorch + CUDA: the port of the ``repro`` JAX package.

Same sub-package layout as ``repro`` (``core/ fed/ data/ models/ optim/
kernels/``); plain functions over tensors and dictionaries of stacked
``[K, ...]`` tensors. Imports ``torch`` and numpy only.
"""
