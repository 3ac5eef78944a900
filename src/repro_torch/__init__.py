"""PyTorch/CUDA port of the TiM-DNN ternary serving stack.

Mirrors the layout and names of the JAX package ``repro`` (the
reference): ``core`` (ternary codes, 2-bit packing, TernaryWeight),
``nn`` (layers, paged attention), ``kernels`` (the TiM matmul and
paged-attention dispatch, each a hand-written Hopper CUDA kernel in
``csrc/`` beside a plain PyTorch version), ``models.transformer`` (the
dense decoder), ``serve`` (block pool and the chunked-prefill engine).

The package imports only ``torch`` and ``numpy``.  Entry points default
to ``device="cuda"`` and raise when CUDA is absent; they run on the CPU
only when the caller passes ``device="cpu"``.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
