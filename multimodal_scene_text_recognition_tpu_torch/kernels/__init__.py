"""CUDA sources of the kernels and the builder that compiles them."""
