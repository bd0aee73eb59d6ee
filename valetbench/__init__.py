"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
of ``BENCHMARK.json`` per run, driven by the files under this folder."""
