"""The port's cell bucketing (``pysdm_tpu_torch/ops/segments.py``) against
the JAX package's (``pysdm_tpu/ops/segments.py``) on the same state and the
same injected u01: ``bucket_shuffle_state`` (the sort croupier) and
``sort_state_by_cell`` must give the same rows, cell starts and pair
leaders. The u01 draws are tie-free in the packed key, so the JAX
package's unstable sort and the port's stable one agree exactly; with ties
each orders a tie its own way (ROADMAP.md, queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysdm_tpu.impl.state import make_particle_state
from pysdm_tpu.ops import segments as jax_segments
from pysdm_tpu_torch.impl.mesh import Mesh
from pysdm_tpu_torch.impl.state import ParticleState
from pysdm_tpu_torch.ops import segments

GRID = (4, 5)
N_SD = 300


def _states(seed):
    """the same random 2D state in both packages, 10% dead"""
    rng = np.random.default_rng(seed)
    mesh = Mesh(GRID, (400.0, 500.0))
    positions = rng.uniform(0, 1, (2, N_SD)) * np.array(GRID)[:, None]
    cell_id, cell_origin, position_in_cell = mesh.cellular_attributes(positions)
    mult = rng.integers(1, 10**6, N_SD)
    mult[rng.uniform(size=N_SD) < 0.1] = 0
    ext = {"signed water mass": rng.uniform(1e-15, 1e-12, N_SD),
           "dry volume": rng.uniform(1e-21, 1e-18, N_SD)}
    jax_state = make_particle_state(
        multiplicity=mult, extensive=ext, cell_id=cell_id,
        cell_origin=cell_origin, position_in_cell=position_in_cell,
    )
    port_state = ParticleState.from_numpy(
        multiplicity=mult, extensive=np.stack(list(ext.values())),
        ext_names=tuple(ext), cell_id=cell_id, cell_origin=cell_origin,
        position_in_cell=position_in_cell,
    )
    return mesh, jax_state, port_state, rng


def _tie_free_u01(rng, n_cell):
    """u01 whose packed-key bits are all distinct: k / 2^20 + 2^-22 is exact
    in float32 and maps to bits k * 2^(nbits - 20) + 2^(nbits - 22)"""
    assert segments.rand_bits_for(n_cell) >= 22
    k = rng.permutation(2**20)[:N_SD]
    return (k / 2**20 + 2**-22).astype(np.float32)


def _assert_same_state(jax_state, port_state):
    for name in ("multiplicity", "extensive", "cell_id", "cell_origin",
                 "position_in_cell"):
        np.testing.assert_array_equal(
            getattr(port_state, name).numpy(),
            np.asarray(getattr(jax_state, name)), err_msg=name,
        )


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_bucket_shuffle_state_matches_jax_package(seed):
    mesh, jax_state, port_state, rng = _states(seed)
    n_cell = mesh.n_cell
    u01 = _tie_free_u01(rng, n_cell)
    j_state, j_cell, j_start, j_first = jax_segments.bucket_shuffle_state(
        jax_state, jnp.asarray(u01), n_cell, mesh
    )
    t_state, t_cell, t_start, t_first = segments.bucket_shuffle_state(
        port_state, torch.from_numpy(u01), n_cell, mesh
    )
    _assert_same_state(j_state, t_state)
    np.testing.assert_array_equal(t_cell.numpy(), np.asarray(j_cell))
    np.testing.assert_array_equal(t_start.numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(t_first.numpy(), np.asarray(j_first))
    assert t_first.any()


def test_integer_bits_order_as_the_float_draws():
    mesh, _, port_state, rng = _states(5)
    u01 = _tie_free_u01(rng, mesh.n_cell)
    bits = segments.shuffle_bits(torch.from_numpy(u01), mesh.n_cell)
    from_bits = segments.bucket_shuffle_state(port_state, bits, mesh.n_cell, mesh)
    from_u01 = segments.bucket_shuffle_state(
        port_state, torch.from_numpy(u01), mesh.n_cell, mesh
    )
    for a, b in zip(from_bits[1:], from_u01[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", (3, 4))
def test_sort_state_by_cell_matches_jax_package(seed):
    mesh, jax_state, port_state, _ = _states(seed)
    j_state, j_cell, j_start = jax_segments.sort_state_by_cell(
        jax_state, mesh.n_cell, mesh
    )
    t_state, t_cell, t_start = segments.sort_state_by_cell(
        port_state, mesh.n_cell, mesh
    )
    _assert_same_state(j_state, t_state)
    np.testing.assert_array_equal(t_cell.numpy(), np.asarray(j_cell))
    np.testing.assert_array_equal(t_start.numpy(), np.asarray(j_start))
    np.testing.assert_array_equal(
        segments.cell_start_of_sorted(t_state.cell_id, mesh.n_cell).numpy(),
        np.asarray(j_start)[:-1].tolist() + [N_SD],
    )


def test_segment_min_and_counts_match_jax_package():
    rng = np.random.default_rng(9)
    n_cell = 7
    cell = np.sort(rng.integers(0, n_cell + 1, 200))
    cell[cell == 3] = 4  # an empty cell
    start = np.searchsorted(cell, np.arange(n_cell + 1))
    values = rng.uniform(size=200)
    segment_min = jax.jit(jax_segments.sorted_segment_min, static_argnums=3)
    expected = np.asarray(segment_min(
        jnp.asarray(values), jnp.asarray(cell), jnp.asarray(start), n_cell
    ))
    got = segments.sorted_segment_min(
        torch.from_numpy(values), torch.from_numpy(cell), n_cell
    ).numpy()
    np.testing.assert_array_equal(got, expected)
    assert got[3] == np.inf
    np.testing.assert_array_equal(
        segments.cell_counts(torch.from_numpy(start)).numpy(),
        np.asarray(jax_segments.cell_counts(jnp.asarray(start))),
    )
