"""The multi-device layer over ``torch.distributed`` (port of
``pysdm_tpu/parallel/``): halo exchange, particle migration, and the
x-slab (or tile) decomposed 2D simulation, one rank per slab"""
from . import halo, migration
from .distributed_2d import DistributedSimulation2D
