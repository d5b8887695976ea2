"""PyTorch/CUDA port of the DYAD training and serving paths.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``core``, ``configs``, ``kernels``, ``layers``,
``models``, ``optim``, ``data``, ``train``, ``serve``, ``launch``,
``checkpoint``, ``obs``) and imports nothing of it.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; the hand-written
kernels live in ``kernels/csrc``.
"""
