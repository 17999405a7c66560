"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the dispatch from the framework's layouts (``ops.py``)."""
