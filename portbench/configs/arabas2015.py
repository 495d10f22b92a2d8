"""Arabas et al. 2015: the 2D kinematic warm rain, as the port's
``arabas_et_al_2015.make_simulation`` builds it (AmbientThermodynamics,
Condensation with K3, EulerianAdvection with MPDATA, Displacement with
sedimentation, Coalescence on the sort croupier with K2 and K4's per-cell
sums, all adaptive), spun up for the configuration's spin-up time with
collisions and sedimentation off as the model's ``SpinUp`` does, then
stepped by ``Particulator.run``. The seed draws the initial state and
seeds both of the particulator's generators, so it draws the collisions
too.

Correct: the reference (``reference/warm_rain.py``) follows the program
step by step. At a step of the episode drawn from the seed it takes the
program's state before that step (the drops and the evolving cell fields)
and the state of the device generator the step's collisions draw from,
computes the step in float64 from the configuration, and the program's
cell fields after the step must lie within the traffic's limits of the
reference's: th and qv after the step and as advected for the next, the
droplet number and the liquid water of every cell.
"""

import torch

from portbench.harness import episodes
from portbench.reference import warm_rain

# the model's values that the configuration file states; a program whose
# defaults differ is not running this configuration
STATED = (
    "th_std0", "initial_water_vapour_mixing_ratio", "p0", "kappa",
    "coalescence_adaptive", "condensation_adaptive", "mpdata_iters",
    "mpdata_iga", "mpdata_fct",
)


def settings_of(config, traffic, seed):
    """the port's ``Settings`` at the configuration's values, checked
    against them; its ``Formulae`` seed draws the initial state and seeds
    the generators"""
    from pysdm_tpu_torch.models import arabas_et_al_2015 as model
    from pysdm_tpu_torch.physics import Formulae

    settings = model.Settings(
        Formulae(seed=seed),
        grid=tuple(config["grid"]),
        size=tuple(config["size"]),
        dt=config["dt"],
        n_sd_per_gridbox=int(traffic["n_sd_per_gridbox"]),
        rhod_w_max=config["rhod_w_max"],
        simulation_time=config["simulation_time"],
        spin_up_time=config["spin_up_time"],
    )
    actual = {name: getattr(settings, name) for name in STATED}
    expected = {name: config[name] for name in STATED}
    kernel = settings.kernel
    actual["kernel"] = (type(kernel).__name__, kernel.collection_efficiency)
    expected["kernel"] = (config["kernel"], config["collection_efficiency"])
    if actual != expected:
        raise ValueError(f"the model's settings {actual} are not the configuration's {expected}")
    return settings


class Case:
    """the warm rain built and spun up from the seed; the reference follows
    step k + 1 of each episode, k = seed mod the episode's steps"""

    def __init__(self, config, traffic, seed, backend_class=None):
        from pysdm_tpu_torch.backends import GPU
        from pysdm_tpu_torch.models import arabas_et_al_2015 as model

        self.config, self.traffic, self.seed = config, traffic, seed
        s = self.settings = settings_of(config, traffic, seed)
        p, spin_up = model.make_simulation(s, backend_class=backend_class or GPU)
        p.run(s.n_spin_up)
        spin_up.finish()
        self.particulator = p
        self.n_sd = s.n_sd
        self.n_cell = s.grid[0] * s.grid[1]
        self.episode_steps = int(traffic["episode_steps"])
        # the state before step k + 1 of the episode, and after it
        self.k = seed % self.episode_steps
        self.stops = [self.k, self.k + 1]
        self.limits = dict(traffic["limits"])
        # the kept state's buffer, filled in place: the harness adds no
        # allocation to the window
        self.kept = {"before": episodes.clone_tree(p.sim_state)}

    def at(self, step, episode):
        """before step k + 1: a device copy of the state and the device
        generator's state (the collision's draws of the step follow from
        it); after it: the cell fields, on the device"""
        p = self.particulator
        if step == self.k:
            self.kept["before"] = episodes.copy_tree_(self.kept["before"], p.sim_state)
            self.kept["gen_state"] = p.device_rng.get_state()
        else:
            self.kept["after"] = cell_fields(p.sim_state, self.n_cell)

    def after_episode(self):
        """the episode's steps if its condensation reported a failure or its
        end state has a negative multiplicity or a non-finite value, else 0"""
        sim = self.particulator.sim_state
        particles = sim["particles"]
        ok = bool(
            sim["counters"]["condensation_success"].all()
            & (particles.multiplicity >= 0).all()
            & torch.isfinite(particles.extensive).all()
            & torch.isfinite(sim["env"]["thd"]).all()
            & torch.isfinite(sim["env"]["qv"]).all()
        )
        return 0 if ok else self.episode_steps

    def shapes(self):
        particles = self.particulator.sim_state["particles"]
        return {"n_sd": self.n_sd, "extensive_rows": int(particles.extensive.shape[0])}

    def outputs(self):
        """the program's cell fields after the kept step"""
        return {k: v.cpu().numpy() for k, v in self.kept["after"].items()}

    def reference(self, device, store=None):
        """the reference's cell fields after the kept step, from the
        program's state before it; with ``store`` the control's. A solve
        that did not converge gives no fields."""
        before = state_of(self.kept["before"])
        if not all(before["flags"].values()):
            raise ValueError(f"the kept step ran with {before['flags']}")
        fields, converged = warm_rain.step(
            self.config, before, self.kept["gen_state"],
            self.particulator.dtype, device, store=store,
        )
        return fields if converged else None

    def compare(self, got, want):
        if want is None or got is None:
            return {name: (float("inf"), limit) for name, limit in self.limits.items()}
        gaps = warm_rain.gaps(got, want)
        return {name: (value, self.limits[name]) for name, value in gaps.items()}


def state_of(sim):
    """host arrays of the program's state as the reference takes them: the
    drops' multiplicities, cell origins, positions in cell and extensive
    rows (by name), the evolving cell fields, the step's flags"""
    particles = sim["particles"]
    return {
        "xi": particles.multiplicity.cpu().numpy(),
        "origin": particles.cell_origin.cpu().numpy(),
        "position": particles.position_in_cell.cpu().numpy(),
        "ext": particles.extensive.cpu().numpy(),
        "ext_names": tuple(particles.ext_names),
        "env": {k: sim["env"][k].cpu().numpy() for k in warm_rain.STATE_ENV},
        "flags": dict(sim["flags"]),
    }


def cell_fields(sim, n_cell):
    """the program's cell fields (``warm_rain.cell_fields``), float64 on
    the state's device"""
    particles, env = sim["particles"], sim["env"]
    return warm_rain.cell_fields(
        particles.multiplicity, particles.cell_id, particles.ext("signed water mass"),
        env["thd"], env["qv"], env["mpdata_thd"], env["mpdata_qv"], n_cell,
    )


def build(config, traffic, seed, backend_class=None):
    return Case(config, traffic, seed, backend_class)
