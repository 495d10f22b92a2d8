"""Plain PyTorch reference of the Shima et al. 2009 Golovin box.

It imports no module of the program. From the configuration and the seed
alone it builds the box's initial state, draws each step's mirror-croupier
scalars from its own host generator, and steps the SDM coalescence with the
Golovin kernel, one substep a step, in float32 attributes and int64
multiplicities, the precision the configuration states.

Frozen copies, each named at its definition:
- the initial state: ``initialisation/sampling/spectral_sampling.py``
  ``ConstantMultiplicity`` over ``initialisation/spectra.py``
  ``Exponential``, ``discretise_multiplicities``, and the builder's
  volume-to-mass step (``rho_w * volume`` in float64, then float32);
- the draws: ``dynamics/collisions/collision.py`` ``Collision._draw_mirror``
  (K uniform in [0, n), then a uint32 PRF seed);
- the pair update: ``ops/cuda/collision.py`` ``_mirror_update`` with
  ``coalesce_mirror_reference``'s kernel value and pair-keyed u01
  (``_u01_hash``), the plain twin of K1, here evaluated once a pair and not
  once a slot; the float32 operations of a pair are the same;
- the normalization: ``ops/collisions.py`` ``mirror_normalization_factor``
  (dt / dv x n, rounded to float32).

``dv_dlnr`` is the mass-density spectrum of ``shima_et_al_2009.run``
(``ParticleVolumeVersusRadiusLogarithmSpectrum`` times rho), summed here in
float64 over the same float32 bin test.
"""

import numpy as np
import torch
from scipy import stats

_BIG = float(2**31 - 128)
_M32 = 0xFFFFFFFF
RHO_W = 1000.0
PI_4_3 = np.pi * 4.0 / 3.0
CDF_RANGE = (0.00001, 0.99999)


def volume_of_radius(radius):
    return PI_4_3 * np.asarray(radius, dtype=np.float64) ** 3.0


def initial_state(n_sd, n_part, dv, x0):
    """(multiplicity int64, water mass float64) of ConstantMultiplicity over
    the exponential spectrum of scale ``x0`` and ``n_part * dv`` droplets"""
    norm = n_part * dv
    size_range = stats.expon.ppf(np.asarray(CDF_RANGE), 0, x0)
    cdf_range = (
        norm * stats.expon.cdf(size_range[0], 0, x0),
        norm * stats.expon.cdf(size_range[1], 0, x0),
    )
    cdf_arg = np.linspace(cdf_range[0], cdf_range[1], num=2 * n_sd + 1)
    cdf_arg /= norm
    grid = stats.expon.ppf(np.asarray(cdf_arg), 0, x0)
    volume = grid[1:-1:2]
    cdf = norm * stats.expon.cdf(grid[0::2], 0, x0)
    y_float = cdf[1:] - cdf[0:-1]
    multiplicity = np.where(np.isnan(y_float), 0, y_float).round().astype(np.int64)
    if not (multiplicity > 0).all():
        raise ValueError("a multiplicity rounds to zero")
    return multiplicity, RHO_W * volume


def mirror_pairs(n, K, device):
    """(leaders, partners) of the mirror croupier: slot o pairs with
    (K - o) mod n, the leader the smaller slot"""
    first = (K + 1) // 2
    p = torch.arange(first + (n - K - 1) // 2, dtype=torch.int64, device=device)
    leaders = torch.where(p < first, p, K + 1 + (p - first))
    partners = torch.where(p < first, K - p, n + K - leaders)
    return leaders, partners


def _mul_u32(h, c):
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def u01_hash(seed, pair_id):
    """murmur3 fmix32 twice over seed ^ pair_id * 0x9E3779B9, top 24 bits"""
    h = _mul_u32(pair_id.to(torch.int64), 0x9E3779B9) ^ (int(seed) & _M32)
    for _ in range(2):
        h = h ^ (h >> 16)
        h = _mul_u32(h, 0x85EBCA6B)
        h = h ^ (h >> 13)
        h = _mul_u32(h, 0xC2B2AE35)
        h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * 2.0**-24


def _u32_to_f32(x):
    return (x >> 1).to(torch.float32) * 2.0 + (x & 1).to(torch.float32)


def _u64_to_f32(x):
    return _u32_to_f32(x >> 32) * 2.0**32 + _u32_to_f32(x & _M32)


def substep(mult, mass, K, seed, b, scale):
    """one Golovin substep under the mirror croupier; returns new tensors"""
    n = mult.shape[0]
    o, po = mirror_pairs(n, K, mult.device)
    a, bb = mult[o], mult[po]
    in_pair = (a != 0) & (bb != 0)
    lead_is_j = a >= bb
    mj = torch.where(lead_is_j, a, bb)
    mk = torch.where(lead_is_j, bb, a)
    j = torch.where(lead_is_j, o, po)
    k = torch.where(lead_is_j, po, o)
    volume = mass / RHO_W
    p0 = torch.tensor(b, dtype=torch.float32, device=mult.device)
    kn = p0 * (volume[o] + volume[po]) * scale
    u = u01_hash(seed, o)
    gamma_f = torch.ceil(_u64_to_f32(mj) * kn - u).clamp_min(0.0)
    gamma_f = torch.where(in_pair, gamma_f, 0.0)
    cap = gamma_f.clamp_max(_BIG).to(torch.int64)
    g = torch.minimum(cap, mj // mk.clamp_min(1))
    g = torch.where(in_pair, g, 0)
    gf = _u32_to_f32(g)
    nn = mj - g * mk
    split = in_pair & (nn == 0) & (g > 0)
    half = mk // 2
    mj_new = torch.where(split, half, nn)
    mk_new = torch.where(split, mk - half, mk)
    ej, ek = mass[j], mass[k]
    merged = ek + gf.to(mass.dtype) * ej
    ej_new = torch.where(split, merged, ej)
    mult_new, mass_new = mult.clone(), mass.clone()
    sel = in_pair
    mult_new[j[sel]] = mj_new[sel]
    mult_new[k[sel]] = mk_new[sel]
    mass_new[j[sel]] = ej_new[sel]
    mass_new[k[sel]] = merged[sel]
    return mult_new, mass_new


class Box:
    """the reference box, stepped on ``device``; ``store`` rounds the water
    mass after every step (the control: ``torch.bfloat16``)"""

    def __init__(self, *, n_sd, n_part, dv, dt, b, x0_radius, seed, device,
                 store=None):
        x0 = float(volume_of_radius(x0_radius))
        mult, mass = initial_state(n_sd, n_part, dv, x0)
        self.mult = torch.as_tensor(mult, dtype=torch.int64, device=device)
        self.mass = torch.as_tensor(mass, dtype=torch.float32, device=device)
        self.store = store
        if store is not None:
            self.mass = self.mass.to(store).to(torch.float32)
        self.gen = torch.Generator(device="cpu").manual_seed(seed)
        self.scale = torch.full((1,), dt / dv * n_sd, dtype=torch.float32, device=device)
        self.b, self.n_sd, self.dv = b, n_sd, dv
        self.steps = 0

    def step(self):
        K = int(torch.randint(0, self.n_sd, (), generator=self.gen))
        seed = int(torch.randint(0, 2**32, (), generator=self.gen))
        self.mult, self.mass = substep(self.mult, self.mass, K, seed, self.b, self.scale)
        if self.store is not None:
            self.mass = self.mass.to(self.store).to(torch.float32)
        self.steps += 1

    def run(self, steps):
        for _ in range(steps):
            self.step()


def dv_dlnr(mult, mass, radius_bins_edges, dv, rho, store=None):
    """the mass density per unit ln r in each radius bin [kg/m3], float64
    sums over the drops whose float32 volume lies in the bin (numpy).
    ``store`` rounds each drop's volume first (the control)"""
    edges = np.asarray(radius_bins_edges, dtype=np.float64)
    volume_edges = torch.as_tensor(volume_of_radius(edges), dtype=torch.float32,
                                   device=mass.device)
    volume = mass / RHO_W
    if store is not None:
        volume = volume.to(store).to(torch.float32)
    k = torch.searchsorted(volume_edges, volume, right=True) - 1
    n_bins = len(edges) - 1
    valid = (k >= 0) & (k < n_bins) & (mult > 0)
    sums = torch.zeros(n_bins, dtype=torch.float64, device=mass.device)
    sums.index_add_(0, k[valid], mult[valid].to(torch.float64) * volume[valid].to(torch.float64))
    return sums.cpu().numpy() / np.diff(np.log(edges)) / dv * rho


def relative_gap(got, want):
    """max |got - want| over the largest |want|"""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
