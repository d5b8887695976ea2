"""PyTorch/CUDA port of the DYAD serving path.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``core``, ``configs``, ``kernels``, ``layers``,
``models``, ``serve``, ``launch``, ``checkpoint``) and imports nothing of
it.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written kernels live in ``kernels/csrc``.
"""
