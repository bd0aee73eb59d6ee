"""Model stack for every kind of the 10 archs (PyTorch): dense and
sliding-window attention, SSM, hybrid, MoE and the cross-attention kinds."""
