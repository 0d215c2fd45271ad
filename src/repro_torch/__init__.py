"""PyTorch/CUDA port of the ITQ3_S serving stack.

The layout mirrors the JAX package ``repro`` module for module
(``configs``, ``core``, ``kernels``, ``models``, ``serve``, ``checkpoint``,
``launch``) so each port module sits where its reference counterpart does.
This package imports ``torch`` and numpy only: never ``jax`` and nothing
of ``repro``.

Every entry point takes a ``device`` and defaults to ``"cuda"``; the CPU is
used only when a caller asks for it (the parity tests do). The eight
hand-written Hopper kernels (the float and W3A8 serving paths, the paged
KV cache's attention and the offline quantizer) live in ``csrc/`` and are
bound through ``kernels/`` (see ``kernels/_build.py``).
"""
