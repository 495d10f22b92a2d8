"""pysdm_tpu_torch — the PyTorch/CUDA port of the super-droplet engine.

A port of ``pysdm_tpu`` (JAX, TPU) to PyTorch with hand-written CUDA
kernels for NVIDIA Hopper, laid out module for module like the JAX package,
which stays beside it as the reference. It imports ``torch``, ``numpy`` and
``scipy``, never JAX. Every tensor is created with an explicit dtype and
device (see ``backends``).

Ported so far: the 0D box coalescence (Shima et al. 2009) under the mirror
croupier, the adiabatic parcel, the Shipway and Hill 2012 1D column
(``models/shipway_and_hill_2012.py``), the Arabas et al. 2015 2D warm rain
(``models/arabas_et_al_2015.py``) and the de Jong/Mackay et al. 2023
breakup box (``models/dejong_mackay_et_al_2023.py``), with five
hand-written CUDA kernels in ``csrc/``: mirror coalescence, sort-croupier
coalescence, mirror collision with breakup, the per-drop condensation
solve and the prefix sum under every per-cell sum.
"""

from .physics import Formulae, si
from .builder import Builder
from .particulator import Particulator

__version__ = "0.1.0"
