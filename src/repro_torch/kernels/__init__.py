"""Hand-written Hopper kernels, one package each (``ops`` wrapper, ``ref``
plain version, ``csrc`` CUDA source); ``_build`` compiles them on first use."""
