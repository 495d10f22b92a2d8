"""Nothing the benchmark runs may load JAX or the JAX package: the program
measured is the PyTorch port alone. Module names are compared by their
top-level name, the part before the first dot, whole: the port's name
begins with the JAX package's."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pysdm_tpu")


def forbidden_modules(modules=None):
    """the loaded modules whose top-level name is forbidden, sorted"""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
