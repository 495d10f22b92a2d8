"""The mirror croupier's substep builds a ``MirrorPairing`` only where it
reads one (``Collision._needs_pairing``): the adaptive substeps, the float64
path and K1a with the kernel's values given (a kernel with no body in K1,
here Golovin's without its id). On a fixed K1, K5 or in-body K1a substep
the kernel pairs slot o with (K - o) mod N itself.

On each route a few steps of a small box (CPU, the kernels' plain twins)
leave the multiplicities, the extensive rows and every counter bit-equal to
the same steps with the pairing built on every substep, as it was before
(the condition replaced here, in the test); and ``pairings_built`` reads 0
on the fixed in-kernel routes and one a substep on the others.
"""

import numpy as np
import pytest
import torch

import pysdm_tpu_torch
from pysdm_tpu_torch.backends import CPU
from pysdm_tpu_torch.dynamics import Coalescence, Collision
from pysdm_tpu_torch.dynamics.collisions import collision as collision_module
from pysdm_tpu_torch.dynamics.collisions.breakup_efficiencies import ConstEb
from pysdm_tpu_torch.dynamics.collisions.breakup_fragmentations import (
    AlwaysN,
    Exponential,
)
from pysdm_tpu_torch.dynamics.collisions.coalescence_efficiencies import (
    Berry1967,
    ConstEc,
)
from pysdm_tpu_torch.dynamics.collisions.collision_kernels import (
    Geometric,
    Golovin,
    Hydrodynamic,
)
from pysdm_tpu_torch.environments import Box
from pysdm_tpu_torch.physics import si

N_SD = 2**9
STEPS = 4


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """eager torch on small tensors: one intra-op thread, so that the test
    workers running beside this one keep their cores"""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _k5_functions():
    return {
        "collision_kernel": Geometric(),
        "coalescence_efficiency": Berry1967(),
        "breakup_efficiency": ConstEb(Eb=1.0),
        "fragmentation_function": Exponential(
            scale=4 / 3 * np.pi * (100 * si.um) ** 3
        ),
    }


class GolovinWithoutBody(Golovin):
    """Golovin's kernel as a kernel with no body in K1: K1a takes its
    values as a row"""

    kernel_id = None


# route: (the dynamic, its Formulae options, whether a substep builds the
# pairing); "rows" is K1a's Parameterized form, "rows.values" K1a with the
# kernel's values given
ROUTES = {
    "k1": (lambda: Coalescence(collision_kernel=Golovin(b=1.5e3), adaptive=False,
                               substeps=2), {}, False),
    "k1.adaptive": (lambda: Coalescence(collision_kernel=Golovin(b=1.5e3)), {}, True),
    "k5": (lambda: Collision(**_k5_functions(), adaptive=False),
           {"fragmentation_function": "Exponential"}, False),
    "rows": (lambda: Coalescence(collision_kernel=Hydrodynamic(), adaptive=False),
             {"terminal_velocity": "GunnKinzer1949"}, False),
    "rows.adaptive": (lambda: Coalescence(collision_kernel=Hydrodynamic()),
                      {"terminal_velocity": "GunnKinzer1949"}, True),
    "rows.values": (lambda: Coalescence(collision_kernel=GolovinWithoutBody(b=1.5e3),
                                        adaptive=False), {}, True),
    "float64": (lambda: Collision(
        collision_kernel=Geometric(), coalescence_efficiency=ConstEc(Ec=0.5),
        breakup_efficiency=ConstEb(Eb=1.0), fragmentation_function=AlwaysN(n=2),
        adaptive=False,
    ), {"handle_all_breakups": True}, True),
}


def _run(route, seed=17):
    """a box of ``N_SD`` drops of 10-40 um under the route's dynamic after
    ``STEPS`` steps: (particulator, its Collision)"""
    make, options, _ = ROUTES[route]
    rng = np.random.default_rng(seed)
    builder = pysdm_tpu_torch.Builder(
        n_sd=N_SD,
        backend=CPU(pysdm_tpu_torch.Formulae(seed=seed, **options)),
        environment=Box(dt=1 * si.s, dv=1 * si.m**3),
    )
    builder.add_dynamic(make())
    multiplicity = rng.integers(1, 10**9, N_SD)
    multiplicity[::37] = 0  # dead slots, which the pairing masks out
    particulator = builder.build(
        {
            "multiplicity": multiplicity,
            "volume": 4 / 3 * np.pi * (rng.uniform(10, 40, N_SD) * si.um) ** 3,
        },
        products=(),
    )
    particulator.run(STEPS)
    return particulator, particulator.dynamics["Collision"]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_substep_builds_the_pairing_only_where_it_reads_it(route, monkeypatch):
    particulator, collision = _run(route)
    assert collision.route() == route.split(".")[0]
    assert collision.adaptive == route.endswith(".adaptive")
    assert collision.substeps_run >= STEPS
    builds = ROUTES[route][2]
    assert collision.pairings_built == (collision.substeps_run if builds else 0)
    assert (
        particulator.counts()["Collision.pairings_built"]
        == collision.pairings_built
    )

    monkeypatch.setattr(
        collision_module.Collision, "_needs_pairing", lambda *_: True
    )
    forced, forced_collision = _run(route)
    assert forced_collision.pairings_built == forced_collision.substeps_run
    assert forced_collision.substeps_run == collision.substeps_run
    got, want = particulator.sim_state, forced.sim_state
    assert torch.equal(
        got["particles"].multiplicity, want["particles"].multiplicity
    )
    assert torch.equal(got["particles"].extensive, want["particles"].extensive)
    assert got["counters"].keys() == want["counters"].keys()
    for name, counter in got["counters"].items():
        assert torch.equal(counter, want["counters"][name]), name
    assert float(particulator.get_counter("collision_rate").sum()) > 0


def _golovin_box_on_card(n_sd, steps, seed=2009):
    """Shima et al. 2009's Golovin box at ``n_sd`` on the card after
    ``steps`` fixed steps (one K1 substep each)"""
    from pysdm_tpu_torch.backends import GPU
    from pysdm_tpu_torch.initialisation.sampling.spectral_sampling import (
        ConstantMultiplicity,
    )
    from pysdm_tpu_torch.models import shima_et_al_2009 as model

    s = model.Settings(seed=seed)
    builder = pysdm_tpu_torch.Builder(
        n_sd=n_sd, backend=GPU(formulae=s.formulae),
        environment=Box(dv=s.dv, dt=s.dt),
    )
    volume, multiplicity = ConstantMultiplicity(s.spectrum).sample(n_sd)
    builder.add_dynamic(Coalescence(collision_kernel=s.kernel, adaptive=False))
    particulator = builder.build(
        {"volume": volume, "multiplicity": multiplicity}, products=()
    )
    particulator.run(steps)
    particulator.block_until_ready()
    return particulator, particulator.dynamics["Collision"]


@pytest.mark.cuda
def test_the_golovin_box_on_the_card_builds_no_pairing(monkeypatch):
    """K1 at 2^20 on the card, 10 fixed substeps: the slots bit-equal to
    the same substeps with the pairing built, and no pairing built"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pysdm_tpu_torch.ops.cuda import collision as kern

    launches = kern.coalesce_mirror.launches
    particulator, collision = _golovin_box_on_card(2**20, 10)
    assert collision.route() == "k1"
    assert kern.coalesce_mirror.launches - launches == collision.substeps_run == 10
    assert collision.pairings_built == 0

    monkeypatch.setattr(
        collision_module.Collision, "_needs_pairing", lambda *_: True
    )
    forced, forced_collision = _golovin_box_on_card(2**20, 10)
    assert forced_collision.pairings_built == 10
    got = particulator.sim_state["particles"]
    want = forced.sim_state["particles"]
    assert torch.equal(got.multiplicity, want.multiplicity)
    assert torch.equal(
        got.ext("signed water mass"), want.ext("signed water mass")
    )
    assert float(particulator.get_counter("coalescence_rate").sum()) > 0
    for name, counter in particulator.sim_state["counters"].items():
        assert torch.equal(counter, forced.sim_state["counters"][name]), name
