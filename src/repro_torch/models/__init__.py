"""Model stack for the dense and sliding-window kinds (PyTorch)."""
