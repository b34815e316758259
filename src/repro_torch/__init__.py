"""PyTorch/CUDA port of the RADS subgraph-enumeration system.

Mirrors the reference package's layout (``configs``, ``obs``, ``graph``,
``core``, ``kernels``, ``launch``) module for module.  The port imports
``torch`` and never ``jax`` or anything of the reference package; its
parity tests import both and feed them the same numpy inputs
(:mod:`repro_torch.convert` hands one partition and one cache state to
both).
"""
