"""Hand-written Hopper kernels of the main path, their plain PyTorch
versions (``ref``) and the padding ops wrappers (``ops``)."""
