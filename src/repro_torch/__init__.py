"""PyTorch/CUDA port of the streaming similarity self-join (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
layout module by module and imports nothing of it.  Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``; on a CPU tensor each
kernel wrapper runs its plain PyTorch version, on a CUDA tensor it
launches the hand-written kernel (``kernels/csrc``) or raises.
"""
