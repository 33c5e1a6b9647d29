"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``ops`` holds the wrappers (kernel on CUDA tensors, plain version on CPU
tensors), ``ref`` the plain versions, ``build`` the nvcc build, and
``csrc/`` the CUDA sources.  Importing this package builds nothing.
"""
