"""Shima et al. 2009 Fig. 2: the Golovin box, as the port's
``shima_et_al_2009.run`` builds it (``Builder``, ``Box``,
``Coalescence(Golovin)`` on the mirror croupier, K1), stepped by
``Particulator.run``, its dv/dlnr product read at the traffic's read steps.

Correct: the plain reference (``reference/shima_box.py``) builds the same
box from the configuration and the seed and steps it with its own draws.
At a step of the episode drawn from the seed among the traffic's
``compare_steps`` it must hold every multiplicity and every water mass to
the bit (K1 is the reference's pair update, rounded the same way), and each
episode's dv/dlnr read there must lie within ``dvdlnr_gap`` of the
reference's, summed in float64.
"""

import numpy as np
import torch

from portbench.reference import shima_box


def settings_of(config, traffic, seed):
    """the port's ``Settings`` at the configuration's values, checked
    against them"""
    from pysdm_tpu_torch.models import shima_et_al_2009 as model
    from pysdm_tpu_torch.physics import Formulae

    settings = model.Settings(formulae=Formulae(seed=seed), seed=seed)
    settings.n_sd = int(traffic["n_sd"])
    bins = config["radius_bins_um"]
    expected = {
        "b": config["b_per_s"],
        "X0": float(shima_box.volume_of_radius(config["X0_radius_um"] * 1e-6)),
        "n_part": config["n_part_per_m3"],
        "dv": config["dv_m3"],
        "dt": config["dt_s"],
        "adaptive": config["adaptive"],
        "rho": config["rho_kg_per_m3"],
    }
    actual = {
        "b": settings.kernel.b, "X0": settings.X0, "n_part": settings.n_part,
        "dv": settings.dv, "dt": settings.dt, "adaptive": settings.adaptive,
        "rho": settings.rho,
    }
    if actual != expected or type(settings.kernel).__name__ != config["kernel"]:
        raise ValueError(f"the model's settings {actual} are not the configuration's {expected}")
    edges = np.logspace(np.log10(bins["from"] * 1e-6), np.log10(bins["to"] * 1e-6),
                        num=bins["num"], endpoint=True)
    if not np.array_equal(edges, settings.radius_bins_edges):
        raise ValueError("the model's radius bins are not the configuration's")
    return settings


class Case:
    def __init__(self, config, traffic, seed, backend_class=None):
        from pysdm_tpu_torch.backends import GPU
        from pysdm_tpu_torch.builder import Builder
        from pysdm_tpu_torch.dynamics import Coalescence
        from pysdm_tpu_torch.environments import Box
        from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
            ConstantMultiplicity,
        )
        from pysdm_tpu_torch.products import (
            ParticleVolumeVersusRadiusLogarithmSpectrum,
        )

        self.config, self.traffic, self.seed = config, traffic, seed
        s = self.settings = settings_of(config, traffic, seed)
        builder = Builder(
            n_sd=s.n_sd,
            backend=(backend_class or GPU)(formulae=s.formulae),
            environment=Box(dv=s.dv, dt=s.dt),
        )
        attributes = {}
        attributes["volume"], attributes["multiplicity"] = ConstantMultiplicity(
            s.spectrum
        ).sample(s.n_sd)
        builder.add_dynamic(
            Coalescence(collision_kernel=s.kernel, adaptive=s.adaptive)
        )
        product = ParticleVolumeVersusRadiusLogarithmSpectrum(
            s.radius_bins_edges, name="dv/dlnr"
        )
        self.particulator = builder.build(attributes, (product,))
        self.n_sd = s.n_sd
        self.episode_steps = int(traffic["episode_steps"])
        self.stops = sorted(int(k) for k in traffic["read_steps"])
        compare = sorted(int(k) for k in traffic["compare_steps"])
        self.compare_step = compare[seed % len(compare)]
        if self.compare_step not in self.stops:
            raise ValueError("a compare step has to be a read step")
        self.limits = dict(traffic["limits"])
        self.reads = {k: [] for k in self.stops}
        self.kept = None
        self.start_totals = self._totals()

    def _totals(self):
        particles = self.particulator.sim_state["particles"]
        mult = particles.multiplicity
        mass = particles.ext("signed water mass")
        return (
            float((mult.to(torch.float64) * mass.to(torch.float64)).sum()),
            int(mult.sum()),
        )

    def at(self, step, episode):
        """a read of dv/dlnr, as ``shima_et_al_2009.run`` reads it; at the
        compare step also the state"""
        p = self.particulator
        if episode < 0:  # the warm-up's reads are no answers of the window
            p.products["dv/dlnr"].get()
            return
        self.reads[step].append(
            np.asarray(p.products["dv/dlnr"].get()[0]) * self.settings.rho
        )
        if step == self.compare_step:
            particles = p.sim_state["particles"]
            self.kept = (
                particles.multiplicity.clone(),
                particles.ext("signed water mass").clone(),
            )

    def after_episode(self):
        """the episode's steps if its end state fails the checks of
        ``chip_smoke.py`` ``_totals`` and ``_check_conserved`` (no negative
        multiplicity, finite masses, water mass to 1e-6, fewer droplets),
        else 0"""
        particles = self.particulator.sim_state["particles"]
        mass = particles.ext("signed water mass")
        ok = bool(
            (particles.multiplicity >= 0).all() & torch.isfinite(mass).all()
        )
        water, count = self._totals()
        water0, count0 = self.start_totals
        ok = ok and abs(water - water0) <= 1e-6 * water0 and count < count0
        return 0 if ok else self.episode_steps

    def shapes(self):
        particles = self.particulator.sim_state["particles"]
        # Golovin reads one attribute row, the volume
        return {
            "n_sd": self.n_sd,
            "extensive_rows": int(particles.extensive.shape[0]),
            "k1_attribute_rows": 1,
        }

    def outputs(self):
        """what the timed path produced, for the comparison"""
        mult, mass = self.kept
        return {"mult": mult, "mass": mass, "dvdlnr": self.reads[self.compare_step]}

    def reference(self, device, store=None):
        """the reference's outputs at the compare step; with ``store`` the
        control's: the water mass kept in that precision"""
        s = self.settings
        box = shima_box.Box(
            n_sd=s.n_sd, n_part=s.n_part, dv=s.dv, dt=s.dt, b=s.kernel.b,
            x0_radius=self.config["X0_radius_um"] * 1e-6, seed=self.seed,
            device=device, store=store,
        )
        box.run(self.compare_step)
        return {
            "mult": box.mult, "mass": box.mass,
            "dvdlnr": [shima_box.dv_dlnr(
                box.mult, box.mass, s.radius_bins_edges, s.dv, s.rho, store=store
            )],
        }

    def compare(self, got, want):
        """{number: (value, limit)}"""
        mult, mass = got["mult"].to(want["mult"].device), got["mass"].to(want["mass"].device)
        return {
            "xi_slots_differing": (
                int((mult != want["mult"]).sum()), self.limits["xi_slots_differing"]),
            "mass_slots_differing": (
                int((mass != want["mass"]).sum()), self.limits["mass_slots_differing"]),
            "dvdlnr_gap": (
                max(shima_box.relative_gap(g, want["dvdlnr"][0]) for g in got["dvdlnr"]),
                self.limits["dvdlnr_gap"]),
        }


def build(config, traffic, seed, backend_class=None):
    return Case(config, traffic, seed, backend_class)
