"""Terminal velocity (port of ``pysdm_tpu/dynamics/terminal_velocity.py``):
the Gunn & Kinzer 1949 table interpolation (reference
``PySDM/dynamics/terminal_velocity/gunn_and_kinzer.py``) and
``PowerSeries``.

The 601-point table over [0, 0.6 cm] is built once on the host (a SciPy
RBF through the published Table 2, Beard's small-radius branch below
40 um) and held in float32, as the JAX package holds it even in float64
runs. A step reads it by a gather, ``table[idx]``: the JAX package's
one-hot matmul exists because TPU gathers are slow, and in TF32 a matmul
would not select exactly.
"""

from functools import lru_cache

import numpy as np
import torch

# Gunn & Kinzer 1949, Table 2: drop diameter [mm] -> terminal velocity [cm/s]
_GK_DIAMETERS_MM = np.array(
    [0.078, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.2, 1.4, 1.6,
     1.8, 2.0, 2.2, 2.4, 2.6, 2.8, 3.0, 3.2, 3.4, 3.6, 3.8, 4.0, 4.2, 4.4,
     4.6, 4.8, 5.0, 5.2, 5.4, 5.6, 5.8]
)
_GK_VELOCITIES_CM_S = np.array(
    [18, 27, 72, 117, 162, 206, 247, 287, 327, 367, 403, 464, 517, 565, 609,
     649, 690, 727, 757, 782, 806, 826, 844, 860, 872, 883, 892, 898, 903,
     907, 909, 912, 914, 916, 917]
)

_FACTOR = 100000  # inverse grid step (1e-5 m), reference gunn_and_kinzer.py:118
_MAX_RADIUS = 0.6e-2  # 0.6 cm


def _beard_small_r_velocity(radius_m):
    """Beard 1976-style small-drop terminal velocity (reference
    ``gunn_and_kinzer.py`` TpDependent.make, small-radius branch at
    T = 293.15 K, p = 1000 hPa)"""
    si_cm = 1e-2
    T = 293.15
    p = 1000e2
    p0 = 1013.25e2
    rho0 = 1.204
    n = 1.832e-5
    rho = 0.348 * p / T
    l0 = 6.62e-6 * si_cm
    n0 = 1.818e-5
    l = l0 * (n / n0) * (p0 * rho0 / p * rho) ** 0.5
    c4 = np.array([10.5035, 1.08750, -0.133245, -0.00659969])
    r = radius_m / si_cm
    f4 = (n0 / n) * (1 + 1.255 * l / r) / (1 + 1.255 * l0 / r)
    log2r = np.log(2 * r)
    sum_r = sum(c4[j] * log2r**j for j in range(4))
    return f4 * np.exp(sum_r) * si_cm


@lru_cache(maxsize=4)
def _gk_table(small_r_limit=40e-6):
    """(velocity, slope) at the table's 601 radii, float64 NumPy"""
    from scipy.interpolate import Rbf

    ir = _GK_DIAMETERS_MM * 1e-3 / 2  # radius in metres
    iu = _GK_VELOCITIES_CM_S / 100  # m/s
    rbf = Rbf(ir, iu)
    num = 6 * _FACTOR // 1000 + 1
    space, step = np.linspace(0.0, _MAX_RADIUS, num, retstep=True)
    u = rbf(space)
    u[0] = 0.0
    small = (space < small_r_limit) & (space > 0)
    u[small] = _beard_small_r_velocity(space[small])
    b = np.append(np.diff(u), [u[-1] - u[-2]]) / step
    return u, b


@lru_cache(maxsize=4)
def _gk_table_on(device):
    """the table as a float32 (2, 601) tensor on ``device``, copied there
    once"""
    return torch.as_tensor(np.stack(_gk_table()), dtype=torch.float32).to(device)


def gunn_kinzer_v_term(radius):
    """linear interpolation in the Gunn-Kinzer table [m/s] (reference
    ``terminal_velocity_methods.py:16-25``: r_id = int(factor r), value =
    a[r_id] + ((factor r) % 1) / factor * b[r_id]); 0 for a negative
    radius"""
    tab = _gk_table_on(radius.device)
    scaled = radius.clamp(0.0, _MAX_RADIUS) * _FACTOR
    idx = scaled.to(torch.int32).clamp(0, tab.shape[1] - 1)
    r_rest = (scaled - idx) / _FACTOR
    ab = tab[:, idx.long()].to(radius.dtype)
    value = ab[0] + r_rest * ab[1]
    return torch.where(radius < 0, 0.0, value)


class PowerSeries:
    """a user-specified power law in the radius (reference
    ``power_series.py``; ``pysdm_tpu/dynamics/terminal_velocity.py:94-115``):
    sum of prefactor * (volume in um^3)^power, by default 0.2 (v /
    um^3)^(1/6), in the radius as prefactor * (4/3 pi)^p / 1e-6^(3p) *
    r^(3p)"""

    def __init__(self, *, prefactors=None, powers=None):
        prefactors = np.array(prefactors or [2.0e-1])
        self.powers = np.array(powers or [1 / 6])
        assert len(prefactors) == len(self.powers)
        pi43 = 4 / 3 * np.pi
        self.prefactors = np.array([
            pref * pi43**p / (1e-6) ** (3 * p)
            for pref, p in zip(prefactors, self.powers)
        ])

    def __call__(self, radius):
        v = 0.0
        for pref, p in zip(self.prefactors, self.powers):
            v = v + float(pref) * torch.pow(radius, float(3 * p))
        return v
