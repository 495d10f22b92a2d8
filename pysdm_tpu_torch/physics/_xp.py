"""Array-namespace dispatch for the formula bodies.

One body per formula serves three kinds of input: Python floats (set-up),
NumPy arrays (host-side initialisation such as ``equilibrate_wet_radii``)
and torch tensors (the step). Each helper takes torch's function when any
argument is a tensor and NumPy's otherwise, so a formula written with these
helpers keeps the dtype and device of its tensor arguments.
"""

import numpy as np
import torch


def exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


def log(x):
    return torch.log(x) if isinstance(x, torch.Tensor) else np.log(x)


def sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else np.sqrt(x)


def power(x, y):
    if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
        return torch.pow(x, y)
    return np.power(x, y)
