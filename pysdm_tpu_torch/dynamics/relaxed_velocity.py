"""RelaxedVelocity dynamic (port of ``pysdm_tpu/dynamics/relaxed_velocity.py``;
reference ``PySDM/dynamics/relaxed_velocity.py``): relaxes each drop's fall
momentum toward its terminal velocity times its mass, with the timescale
tau = c * sqrt(radius) (or the constant c). The "relative fall velocity"
then reads momentum / mass (``impl/attributes.py``)."""

import math

import torch


class RelaxedVelocity:
    def __init__(self, c: float = 8, constant: bool = False):
        self.c = c
        self.constant = constant
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator
        builder.request_attribute("relative fall momentum")
        builder.request_attribute("terminal velocity")
        builder.request_attribute("water mass")
        builder.request_attribute("sqrt radius")

    def make_step(self, particulator):
        resolver = particulator._resolver
        dt = particulator.dt
        c = self.c
        constant = self.constant

        def step(sim):
            particles = sim["particles"]
            momentum = particles.ext("relative fall momentum")
            water_mass = resolver.get(particles, "water mass")
            # the target momentum takes the bare terminal velocity, not the
            # momentum-derived relative fall velocity
            v_term = resolver.terminal_velocity(particles)
            if constant:
                scale = 1.0 - math.exp(-dt / c)
            else:
                tau = c * resolver.get(particles, "sqrt radius")
                scale = 1.0 - torch.exp(-dt / tau)
            new_momentum = momentum + (v_term * water_mass - momentum) * scale
            particles = particles.set_ext("relative fall momentum", new_momentum)
            return {**sim, "particles": particles}

        return step
