"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``ops`` is the entry point; ``ref`` holds the plain PyTorch versions;
``csrc/`` the CUDA C++ sources, built by ``_build`` at first use.
"""
