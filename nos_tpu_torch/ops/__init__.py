"""The port's kernels (CUDA C++ under `csrc/`, built by `_build`) and their
plain PyTorch versions."""
