"""Freezing dynamic (port of ``pysdm_tpu/dynamics/freezing.py``; reference
``PySDM/dynamics/freezing.py``): immersion freezing in the singular
(freezing-temperature spectrum) or the time-dependent (J_het) form,
homogeneous freezing (J_hom), and thaw.

The water activity of ice and the RH over ice come from the cell's T and
RH (``ops/freezing.py`` ``a_w_ice_and_rh_ice``); the environment gives
neither. Time-dependent freezing draws one u01 row per form and step from
``particulator.device_rng`` on the state's device, or, under u01
injection, reads ``sim["u01"]["freezing_immersion"]`` and
``["freezing_homogeneous"]``. A step reads nothing back from the device.
"""

import torch

from ..ops import freezing as frz_ops


class Freezing:
    def __init__(
        self,
        *,
        singular=True,
        homogeneous_freezing=False,
        immersion_freezing=True,
        thaw=False,
    ):
        self.singular = singular
        self.homogeneous_freezing = homogeneous_freezing
        self.immersion_freezing = immersion_freezing
        self.thaw = thaw
        self.enable = True
        self.particulator = None
        self.u01_injection = False

    def register(self, builder):
        self.particulator = builder.particulator
        formulae = self.particulator.formulae
        if not formulae.particle_shape_and_density.supports_mixed_phase():
            raise ValueError(
                "Freezing needs a mixed-phase particle_shape_and_density"
            )
        builder.request_attribute("signed water mass")
        if self.singular:
            builder.request_attribute("freezing temperature")
        if not self.singular and self.immersion_freezing:
            if formulae.heterogeneous_ice_nucleation_rate.variant == "Null":
                raise ValueError("time-dependent immersion freezing needs J_het")
            builder.request_attribute("immersed surface area")
        if self.homogeneous_freezing:
            if formulae.homogeneous_ice_nucleation_rate.variant == "Null":
                raise ValueError("homogeneous freezing needs J_hom")
            builder.request_attribute("volume")
        self.u01_injection = builder.u01_injection
        if self.u01_injection:
            if not self.singular and self.immersion_freezing:
                builder.add_u01_purpose("freezing_immersion")
            if self.homogeneous_freezing:
                builder.add_u01_purpose("freezing_homogeneous")

    def make_step(self, particulator):
        formulae = particulator.formulae
        dt = particulator.dt
        singular = self.singular
        immersion = self.immersion_freezing
        homogeneous = self.homogeneous_freezing
        thaw = self.thaw
        u01_injection = self.u01_injection
        # the freezing temperature of a fragment is undefined in the
        # reference too
        for dyn in particulator.dynamics.values():
            if getattr(dyn, "enable_breakup", False):
                raise NotImplementedError(
                    "handling T_fz during breakup not implemented"
                    " (undefined in the reference as well)"
                )

        def u01(sim, purpose, like):
            if u01_injection:
                return sim["u01"][purpose].to(like.dtype)
            return torch.rand(
                like.shape, generator=particulator.device_rng,
                dtype=like.dtype, device=like.device,
            )

        def step(sim):
            particles = sim["particles"]
            env = sim["env"]
            cell = particles.cell_id.long()
            signed_mass = particles.ext("signed water mass")
            T_drop = env["T"][cell]
            RH_drop = env["RH"][cell]
            a_w_ice_c, RH_ice_c = frz_ops.a_w_ice_and_rh_ice(
                formulae, env["T"], env["RH"]
            )

            if immersion and singular:
                signed_mass = frz_ops.freeze_singular(
                    formulae=formulae,
                    signed_mass=signed_mass,
                    freezing_temperature=particles.max_attr(
                        "freezing temperature"
                    ),
                    T_drop=T_drop,
                    RH_drop=RH_drop,
                    thaw=thaw,
                )
            elif immersion:
                signed_mass = frz_ops.freeze_time_dependent(
                    formulae=formulae,
                    rand=u01(sim, "freezing_immersion", signed_mass),
                    signed_mass=signed_mass,
                    immersed_surface_area=particles.ext("immersed surface area"),
                    T_drop=T_drop,
                    RH_drop=RH_drop,
                    a_w_ice_drop=a_w_ice_c[cell],
                    dt=dt,
                    thaw=thaw,
                )
            if homogeneous:
                rand = u01(sim, "freezing_homogeneous", signed_mass)
                signed_mass = frz_ops.freeze_time_dependent_homogeneous(
                    formulae=formulae,
                    rand=rand,
                    signed_mass=signed_mass,
                    volume=formulae.particle_shape_and_density.mass_to_volume(
                        signed_mass.abs()
                    ),
                    T_drop=T_drop,
                    RH_ice_drop=RH_ice_c[cell],
                    a_w_ice_drop=a_w_ice_c[cell],
                    dt=dt,
                    thaw=thaw,
                )
            particles = particles.set_ext("signed water mass", signed_mass)
            if particles.has_max("temperature of last freezing"):
                # the ambient T at the freezing event, NaN again on thaw
                # (reference ``freezing_methods.py``
                # record_freezing_temperatures)
                record = particles.max_attr("temperature of last freezing")
                record = torch.where(
                    formulae.trivia.unfrozen(signed_mass),
                    torch.nan,
                    torch.where(record.isnan(), T_drop, record),
                )
                particles = particles.set_max(
                    "temperature of last freezing", record
                )
            return {**sim, "particles": particles}

        return step
