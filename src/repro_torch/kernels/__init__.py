"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the dispatch from the framework's layouts (``ops.py``).

``KERNELS`` lists every kernel wrapper of the port, each with its
``.launches`` count: the decode kernels #1-#11
(``bifurcated_decode.KERNELS``), flash prefill #12 and chunked linear
attention #13."""
from repro_torch.kernels import bifurcated_decode as _bd
from repro_torch.kernels.chunked_linear import chunked_linear_attention
from repro_torch.kernels.flash_prefill import flash_prefill_attention

KERNELS = _bd.KERNELS + (flash_prefill_attention, chunked_linear_attention)
