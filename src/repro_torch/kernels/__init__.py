"""Hand-written Hopper kernels of the port, one package per kernel.

Each package holds the CUDA source (``csrc/``), the ctypes binding
(``kernel.py``), the plain PyTorch version (``ref.py``) and the wrapper
the engine calls (``ops.py``).  The wrapper picks the path from the
tensor's device: a CUDA tensor launches the kernel (or raises), a CPU
tensor runs the plain version.  :mod:`.build` compiles the sources with
``nvcc`` at first use.
"""
