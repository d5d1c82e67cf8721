"""Hand-written Hopper kernels of the port (``csrc/``), their plain
PyTorch versions, and the dispatch the model code calls (``ops``)."""
