"""PyTorch/CUDA port of the Pilot-Edge reproduction.

The JAX package ``repro`` beside this one is the reference: this package
mirrors its layout and module names, imports ``torch`` and never ``jax``
or anything of ``repro``, and is held against it on the same numpy
inputs by ``tests/test_torch_*.py``.  Its entry points run on a CUDA card
unless the caller passes ``device="cpu"`` (``KMeans``, ``init_params``,
``BatchServer``, ``--device cpu`` for ``launch.serve``) or ``devices=()``
(``PilotManager``); the hand-written Hopper kernels live in
:mod:`repro_torch.kernels`.
"""
