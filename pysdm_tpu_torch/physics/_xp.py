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


def where(cond, x, y):
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, x, y)
    return np.where(cond, x, y)


def _unary(torch_fn, np_fn):
    def fn(x):
        return torch_fn(x) if isinstance(x, torch.Tensor) else np_fn(x)

    return fn


log10 = _unary(torch.log10, np.log10)
sinh = _unary(torch.sinh, np.sinh)
tanh = _unary(torch.tanh, np.tanh)
log1p = _unary(torch.log1p, np.log1p)
arcsinh = _unary(torch.asinh, np.arcsinh)
arctanh = _unary(torch.atanh, np.arctanh)


def maximum(x, bound):
    """the larger of ``x`` and the scalar ``bound``, elementwise"""
    if isinstance(x, torch.Tensor):
        return x.clamp(min=bound)
    return np.maximum(x, bound)


def minimum(x, bound):
    """the smaller of ``x`` and the scalar ``bound``, elementwise"""
    if isinstance(x, torch.Tensor):
        return x.clamp(max=bound)
    return np.minimum(x, bound)


def integer_power(x, n):
    """x ** n for an integer n >= 1 by the multiplications, in the order,
    of XLA's ``integer_pow`` (binary exponentiation), so that a polynomial
    in x rounds as the JAX package's does"""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc
