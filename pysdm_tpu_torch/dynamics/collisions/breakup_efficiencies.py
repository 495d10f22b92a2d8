"""Breakup efficiencies (parity: reference
``PySDM/dynamics/collisions/breakup_efficiencies/``), port of
``pysdm_tpu/dynamics/collisions/breakup_efficiencies.py``: ``ConstEb``,
which K5 (``ops/cuda/breakup.py``) evaluates in its body."""

from ...ops.cuda.breakup import EB_CONST


class ConstEb:
    required_attributes = ()
    kernel_id = EB_CONST

    def __init__(self, Eb=1.0):
        self.Eb = Eb

    @property
    def cuda_params(self):
        return (self.Eb,)

    def register(self, builder):
        pass

    def pairwise(self, formulae, attrs_a, attrs_b):
        return self.Eb
