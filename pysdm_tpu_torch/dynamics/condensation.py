"""Condensation dynamic (port of ``pysdm_tpu/dynamics/condensation.py``;
reference ``PySDM/dynamics/condensation.py``): implicit-in-size
condensational growth with per-cell adaptive substepping.

Failure handling as in the JAX package: the reference raises on any
per-cell failure; here the success flag is AND-accumulated in the
``condensation_success`` counter and checked on the host with
``Condensation.check_success()``.

The solver needs the drops sorted by cell. With one cell they trivially
are; with many, the step sorts the state (stable, by cell) unless the
builder's shared-sort analysis has shown that it enters the step sorted
(``_assume_sorted``: the previous step's collision shuffle sorted it), and
then it only finds the segment starts.

Spans (while a profiler records): ``Condensation.prepare`` (the segment
starts, the attributes, the solver's predicted rates and entry liquid),
``Condensation.adapt_substeps``, ``Condensation.substep`` (each lockstep
substep) with ``Condensation.solve`` (the per-drop solve, K3) and
``Condensation.coupling`` (the per-cell trapezoidal coupling) inside every
substep, fake or real, ``Condensation.read`` and ``Condensation.commit``
(the new masses, the predicted thermodynamics, the counters).
"""

from collections import namedtuple

import numpy as np
import torch

from ..environments.impl.moist import recalc_thermo
from ..ops.condensation import CondensationSolver
from ..ops.segments import cell_start_of_sorted, sort_state_by_cell
from ..utils.profiling import span

DEFAULTS = namedtuple("_", ("rtol_x", "rtol_thd", "cond_range", "schedule"))(
    rtol_x=1e-6,
    rtol_thd=1e-6,
    cond_range=(1e-4, 1.0),
    schedule="dynamic",
)

_EVENT_COUNTERS = (
    "condensation_activating",
    "condensation_deactivating",
    "condensation_ripening",
)


class Condensation:
    # asks the builder's shared-sort analysis for the cell-sorted state
    wants_cell_sort = True

    def __init__(
        self,
        *,
        rtol_x=DEFAULTS.rtol_x,
        rtol_thd=DEFAULTS.rtol_thd,
        substeps: int = 1,
        adaptive: bool = True,
        dt_cond_range: tuple = DEFAULTS.cond_range,
        schedule: str = DEFAULTS.schedule,
        max_iters: int = 16,
        update_thd: bool = True,
        failure_doubling_cap: int = 64,
    ):
        if adaptive and substeps != 1:
            raise ValueError(
                "if specifying substeps count manually, adaptivity must be disabled"
            )
        self.particulator = None
        self.enable = True
        self.rtol_x = rtol_x
        self.rtol_thd = rtol_thd
        self.substeps = substeps
        self.adaptive = adaptive
        self.dt_cond_range = dt_cond_range
        self.schedule = schedule
        self.max_iters = max_iters
        self.update_thd = update_thd
        self.failure_doubling_cap = failure_doubling_cap
        # the step's solver, built by make_step
        self.solver = None
        # set by the builder when the state provably enters the step sorted
        self._assume_sorted = False

    def register(self, builder):
        self.particulator = builder.particulator
        n_cell = self.particulator.mesh.n_cell
        builder.request_attribute("critical volume")
        builder.request_attribute("kappa")
        builder.request_attribute("dry volume organic fraction")
        builder.request_attribute("Reynolds number")
        init_n = self.substeps if not self.adaptive else 1
        builder.add_counter(
            "condensation_n_substeps", n_cell, torch.int32, fill=init_n
        )
        builder.add_counter("condensation_success", n_cell, torch.bool, fill=True)
        builder.add_counter("condensation_RH_max", n_cell, None, fill=0.0)
        # activation-event counters (reference n_activating / n_deactivating
        # / n_ripening, condensation_methods.py:19) as float64 running totals
        for name in _EVENT_COUNTERS:
            builder.add_counter(name, n_cell, torch.float64, fill=0.0)

    def check_success(self):
        if not np.asarray(
            self.particulator.get_counter("condensation_success")
        ).all():
            raise RuntimeError("Condensation failed")

    def make_step(self, particulator):
        formulae = particulator.formulae
        resolver = particulator._resolver
        solver = CondensationSolver(
            formulae,
            n_cell=particulator.mesh.n_cell,
            dt=particulator.dt,
            rtol_x=self.rtol_x,
            rtol_thd=self.rtol_thd,
            dt_range=self.dt_cond_range,
            adaptive=self.adaptive,
            max_iters=self.max_iters,
            failure_doubling_cap=self.failure_doubling_cap,
        )
        self.solver = solver
        update_thd = self.update_thd
        mesh = particulator.mesh
        n_cell = mesh.n_cell
        assume_sorted = self._assume_sorted

        def step(sim):
            with span("Condensation.prepare"):
                particles = sim["particles"]
                cell_start = None
                if n_cell > 1 and assume_sorted:
                    cell_start = cell_start_of_sorted(particles.cell_id, n_cell)
                elif n_cell > 1:
                    particles, _, cell_start = sort_state_by_cell(
                        particles, n_cell, mesh
                    )
                env = dict(sim["env"])
                counters = dict(sim["counters"])
                attrs = {
                    "water_mass": particles.ext("signed water mass"),
                    "vdry": particles.ext("dry volume"),
                    "kappa": resolver.get(particles, "kappa"),
                    "f_org": resolver.get(particles, "dry volume organic fraction"),
                    "reynolds_number": resolver.get(
                        particles, "Reynolds number", env=env
                    ),
                    "v_cr": resolver.get(particles, "critical volume", env=env),
                }
            water_mass, pthd, pqv, n_substeps, RH_max, success, events = solver(
                attrs=attrs,
                multiplicity=particles.multiplicity,
                cell_of_drop=particles.cell_id,
                cell_start=cell_start,
                n_substeps=counters["condensation_n_substeps"],
                thd=env["thd"], qv=env["qv"], rhod=env["rhod"],
                pthd=env["pred_thd"], pqv=env["pred_qv"],
                prhod=env["pred_rhod"],
                m_d=env["m_d"],
                air_density=env["air_density"],
                air_viscosity=env["air_viscosity"],
            )
            with span("Condensation.commit"):
                particles = particles.set_ext("signed water mass", water_mass)
                if update_thd:
                    env["pred_thd"] = pthd
                env["pred_qv"] = pqv
                # update_TpRH (reference particulator mediator): predicted
                # T/p/RH from the post-condensation predicted triplet
                (env["T"], env["p"], env["RH"], env["air_density"],
                 env["air_viscosity"]) = recalc_thermo(
                    formulae, env["pred_thd"], env["pred_qv"], env["pred_rhod"]
                )
                counters["condensation_n_substeps"] = n_substeps
                counters["condensation_success"] = (
                    counters["condensation_success"] & success
                )
                counters["condensation_RH_max"] = torch.maximum(
                    counters["condensation_RH_max"], RH_max
                )
                for name, ev in zip(_EVENT_COUNTERS, events):
                    counters[name] = counters[name] + ev
            return {**sim, "particles": particles, "env": env,
                    "counters": counters}

        return step
