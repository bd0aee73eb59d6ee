"""Hand-written Hopper kernels (``csrc/``), their plain PyTorch versions and
the model-layout wrappers.  Importing this package builds nothing."""
