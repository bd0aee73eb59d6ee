"""Plain float32 PyTorch forwards of the benchmark's configurations: the
reference that decides ``correct``.  They import neither the port nor JAX,
and read only the configuration file, the weights and the tokens.

One module per family of models, found by the configuration's
``reference`` key (``of``).  Besides ``forward`` it lays out the family's
weights, one run of like layers at a time (``run_leaves``), and states
what one layer does per token (``layer_work``): the harness makes the
weights and counts the work from these, so a new family is a new module
here and a configuration file that names it.
"""
import importlib


def of(config):
    """The reference module of ``config``'s family."""
    return importlib.import_module(f"valetbench.reference.{config['reference']}")
