"""Srivastava 1982, "A Simple Model of Particle Coalescence and Breakup"
(port of ``pysdm_tpu/models/srivastava_1982.py``; reference
``examples/PySDM_examples/Srivastava_1982/{equations,settings,simulation,
example}.py``): a monodisperse box under a constant collision kernel with
constant fragment mass, against the paper's analytic mean-mass evolution.
The collision substep is K5 (``ops/cuda/breakup.py``): ``ConstantK``,
``ConstEc``, ``ConstEb`` and ``ConstantMass`` are all evaluated in its
body.

The analytic solution (eq. 13) gives the dimensionless mean drop mass
m(tau)/m_frag under coalescence (rate c) and collisional breakup (rate
beta) as m0 exp(-beta* tau) + (1 + 1/(2 beta*))(1 - exp(-beta* tau)), with
tau = c M t and beta* = beta/c.

``Settings`` takes the ``GPU`` backend unless the caller passes
``backend_class=CPU`` (the JAX package defaults to its ``CPU``)."""

import numpy as np

from ..backends import GPU
from ..builder import Builder
from ..dynamics.collisions.breakup_efficiencies import ConstEb
from ..dynamics.collisions.breakup_fragmentations import ConstantMass
from ..dynamics.collisions.coalescence_efficiencies import ConstEc
from ..dynamics.collisions.collision import Collision
from ..dynamics.collisions.collision_kernels import ConstantK
from ..environments import Box
from ..physics.formulae import Formulae
from ..products import (
    SuperDropletCountPerGridbox,
    VolumeFirstMoment,
    ZerothMoment,
)


class Equations:
    """Srivastava 1982 analytic results, constant fragment mass
    (reference ``Srivastava_1982/equations.py``)"""

    def __init__(self, *, M, c, beta):
        self.M = M  # total mass / fragment mass
        self.c = c  # coalescence rate constant
        self.beta = beta  # collisional-breakup rate constant

    @property
    def beta_star(self):
        """eq. 6"""
        return self.beta / self.c

    def tau(self, t):
        """eq. 6: dimensionless time"""
        return self.c * self.M * t

    def eq13(self, m0, tau):
        """mean mass / fragment mass against scaled time under coalescence
        and collisional breakup (no spontaneous breakup)"""
        ebt = np.exp(-self.beta_star * tau)
        return m0 * ebt + (1 + 0.5 / self.beta_star) * (1 - ebt)

    def eq14(self):
        """the equilibrium (tau -> inf) limit of eq. 13"""
        return 1 + 0.5 / self.beta_star


class Settings:
    """reference ``Srivastava_1982/settings.py:45-80``"""

    def __init__(
        self,
        *,
        n_sds,
        dt,
        dv,
        total_number,
        drop_mass_0,
        srivastava_c,
        srivastava_beta,
        frag_mass,
        rho=1000.0,
        backend_class=GPU,
    ):
        self.backend_class = backend_class
        self.rho = rho
        self.total_number_0 = total_number
        self.total_volume = total_number * drop_mass_0 / rho
        self.dt = dt
        self.dv = dv
        self.frag_mass = frag_mass
        self.n_sds = n_sds
        self.srivastava_c = srivastava_c
        self.srivastava_beta = srivastava_beta


class Simulation:
    """reference ``Srivastava_1982/simulation.py``: a monodisperse start;
    the total number, the total volume and the super-droplet count after
    every step"""

    def __init__(self, *, n_steps, settings, collision_dynamic):
        self.n_steps = n_steps
        self.settings = settings
        self.collision_dynamic = collision_dynamic

    def build(self, n_sd, seed):
        settings = self.settings
        builder = Builder(
            n_sd=n_sd,
            backend=settings.backend_class(
                Formulae(
                    constants={"rho_w": settings.rho},
                    fragmentation_function="ConstantMass",
                    seed=seed,
                )
            ),
            environment=Box(dt=settings.dt, dv=settings.dv),
        )
        builder.add_dynamic(self.collision_dynamic)
        return builder.build(
            attributes={
                "multiplicity": np.full(n_sd, settings.total_number_0 / n_sd),
                "volume": np.full(
                    n_sd, settings.total_volume / settings.total_number_0
                ),
            },
            products=(
                SuperDropletCountPerGridbox(name="super-particle count"),
                VolumeFirstMoment(name="total volume"),
                ZerothMoment(name="total numer"),
            ),
        )

    def run(self, n_sd, seed=44):
        """per-step arrays of the total number, the total volume, the
        super-droplet count and the mean drop mass over the fragment mass"""
        particulator = self.build(n_sd, seed)
        settings = self.settings
        out = {
            "total numer": np.empty(self.n_steps + 1),
            "total volume": np.empty(self.n_steps + 1),
            "super-particle count": np.empty(self.n_steps + 1),
        }
        for step in range(self.n_steps + 1):
            if step != 0:
                particulator.run(1)
            for prod in out:
                out[prod][step] = float(particulator.products[prod].get()[0])
        np.testing.assert_allclose(
            out["total volume"], settings.total_volume, rtol=1e-3
        )
        out["mean mass to frag mass"] = (
            settings.total_volume
            * settings.rho
            / out["total numer"]
            / settings.frag_mass
        )
        return out


def coalescence_and_breakup_eq13(
    *, settings, n_steps=256, seed=44, warn_overflows=False
):
    """reference ``Srivastava_1982/example.py:18-63``: the SDM box and the
    eq.-13 analytic curve on the same time grid"""
    collision_rate = settings.srivastava_c + settings.srivastava_beta
    simulation = Simulation(
        n_steps=n_steps,
        settings=settings,
        collision_dynamic=Collision(
            collision_kernel=ConstantK(a=collision_rate),
            coalescence_efficiency=ConstEc(
                settings.srivastava_c / collision_rate
            ),
            breakup_efficiency=ConstEb(1),
            fragmentation_function=ConstantMass(c=settings.frag_mass),
            warn_overflows=warn_overflows,
            adaptive=False,
        ),
    )
    results = {}
    for n_sd in settings.n_sds:
        results[n_sd] = simulation.run(n_sd, seed=seed)

    equations = Equations(
        M=settings.total_volume * settings.rho / settings.frag_mass,
        c=settings.srivastava_c,
        beta=settings.srivastava_beta,
    )
    t = np.arange(n_steps + 1, dtype=float) * settings.dt
    m0 = (
        settings.total_volume
        * settings.rho
        / settings.total_number_0
        / settings.frag_mass
    )
    analytic = equations.eq13(m0, equations.tau(t))
    return {
        "pysdm": results,
        "analytic_mean_mass_to_frag_mass": analytic,
        "equilibrium": equations.eq14(),
        "time": t,
    }
