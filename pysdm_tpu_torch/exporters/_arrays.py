"""host arrays for the writers"""

import numpy as np
import torch


def host_array(values, dtype=None):
    """``values`` (a tensor, an array, or a sequence of either) as one NumPy
    array on the host: each tensor goes through ``.cpu().numpy()``"""
    if torch.is_tensor(values):
        values = values.detach().cpu().numpy()
    elif isinstance(values, (list, tuple)):
        values = [
            v.detach().cpu().numpy() if torch.is_tensor(v) else v
            for v in values
        ]
    return np.asarray(values, dtype=dtype)
