"""Eulerian advection dynamic and the MPDATA coupling of the 2D prescribed
flow (port of ``pysdm_tpu/dynamics/eulerian_advection.py``; reference
``PySDM/dynamics/eulerian_advection.py`` and
``examples/.../utils/kinematic_2d/mpdata_2d.py``).

Per-step dataflow (the reference's buffer shuttling):
- sync (AmbientThermodynamics): ``pred_qv <- mpdata_qv``,
  ``pred_thd <- mpdata_thd``;
- Condensation updates ``pred_qv``/``pred_thd``;
- EulerianAdvection: ``mpdata_* <- mpdata_step(pred_*)``, and the particle
  courant fields (``courant_d = GC_d / rhod at faces``) for Displacement;
- commit: ``qv <- pred_qv`` and so on.

The 2D flow is fixed at construction, so the advector, the g-factor and
the courant fields become tensors once, when the step is built.
"""

import numpy as np
import torch

from ..ops.mpdata import PERIODIC, mpdata_step


class EulerianAdvection:
    """runs the coupled solver inside the composed step (reference
    ``dynamics/eulerian_advection.py``)"""

    def __init__(self, solvers):
        self.solvers = solvers
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator

    def make_step(self, particulator):
        return self.solvers.make_step(particulator)


class MPDATA_2D:
    """2D prescribed-flow coupling (reference ``mpdata_2d.py``): advects thd
    and the water-vapour mixing ratio with a stream-function-derived,
    discretely nondivergent advector; periodic boundaries; g-factor =
    rhod(z). Also publishes the particle courant fields (advector / rhod at
    the faces)."""

    def __init__(
        self,
        *,
        advectees,
        stream_function,
        rhod_of_zZ,
        dt,
        grid,
        size,
        n_iters=2,
        infinite_gauge=True,
        nonoscillatory=True,
        third_order_terms=False,
    ):
        from ..impl import arakawa_c

        self.advectees = advectees
        self.grid = tuple(grid)
        self.dt = dt
        gc = arakawa_c.nondivergent_vector_field_2d(
            grid, size, dt, stream_function, t=0.0
        )
        self.gc = tuple(np.asarray(c, dtype=float) for c in gc)
        for c in self.gc:
            if not (np.abs(c) < 1.0).all():
                raise ValueError("advector courant number >= 1")
        self.g_factor = arakawa_c.make_rhod(grid, rhod_of_zZ)
        g_vec = (
            rhod_of_zZ(arakawa_c.x_vec_coord(grid)[-1]),
            rhod_of_zZ(arakawa_c.z_vec_coord(grid)[-1]),
        )
        # particle courant = GC / rhod at the faces (reference
        # ``mpdata_2d.py:refresh_advector``)
        self.courant = tuple(self.gc[d] / g_vec[d] for d in range(2))
        self.opts = dict(
            n_iters=n_iters,
            infinite_gauge=infinite_gauge,
            nonoscillatory=nonoscillatory,
            third_order_terms=third_order_terms,
            bcs=(PERIODIC, PERIODIC),
        )

    def make_step(self, particulator):
        grid = self.grid
        opts = self.opts

        def tensor(a):
            return torch.as_tensor(
                np.asarray(a), dtype=particulator.dtype,
                device=particulator.device,
            )

        g = tensor(self.g_factor)
        gc = tuple(tensor(c) for c in self.gc)
        courant = tuple(tensor(c).reshape(-1) for c in self.courant)

        def step(sim):
            env = dict(sim["env"])
            for name in ("thd", "qv"):
                env[f"mpdata_{name}"] = mpdata_step(
                    env[f"pred_{name}"].reshape(grid), gc, g, **opts
                ).reshape(-1)
            env["courant_0"], env["courant_1"] = courant
            return {**sim, "env": env}

        return step


class MPDATA_1D:
    """the single-column coupling of config #4 (Shipway and Hill 2012)"""

    def __init__(self, **_):
        raise NotImplementedError(
            "MPDATA_1D comes with config #4 (the Shipway and Hill 2012"
            " column, ROADMAP queue 1)"
        )
