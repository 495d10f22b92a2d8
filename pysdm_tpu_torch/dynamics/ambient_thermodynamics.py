"""AmbientThermodynamics dynamic (port of
``pysdm_tpu/dynamics/ambient_thermodynamics.py``): runs the environment's
predictor sync at the start of each step."""


class AmbientThermodynamics:
    def __init__(self):
        self.particulator = None

    def register(self, builder):
        self.particulator = builder.particulator

    def make_step(self, particulator):
        return particulator.environment.make_sync_step(particulator)
