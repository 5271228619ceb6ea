"""Hand-written Hopper kernels and their plain torch versions.

``ops`` holds the public wrappers; a CPU tensor runs the plain version, a
CUDA tensor launches the kernel built from ``csrc/`` by ``_build``.
"""
