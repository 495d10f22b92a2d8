"""Collision dynamic: SDM Monte-Carlo coalescence and breakup (port of
``pysdm_tpu/dynamics/collisions/collision.py``).

Two croupiers, chosen as the JAX package chooses them:
- one cell (box, parcel), not injected, ``croupier`` not "sort": the mirror
  croupier; a substep draws K, pairs slot o with (K - o) mod N and needs no
  sort. Only the substeps that read partner values build that matching as
  ``ops/pairing.py`` ``MirrorPairing``: the adaptive ones, the float64
  path and K1a with the kernel's values given. K1, K5 and K1a's
  Parameterized form on a fixed substep pair the slots in their body and
  take K alone (``pairings_built`` counts the pairings built);
- many cells, u01 injection, or ``croupier="sort"``: a substep sorts the
  whole state by (cell, random bits) (``ops/segments.py``
  ``bucket_shuffle_state``) and pairs neighbouring slots of a cell
  (``AdjacentPairing``). The state stays cell-sorted afterwards.

The pair update, in the JAX package's order of dispatch (``:240-457``):
- coalescence alone on the mirror croupier, with no max-merged rows: K1
  (``coalesce_mirror``), which evaluates the collision kernels of
  ``ops/cuda/collision.py`` ``MIRROR_KERNELS`` in its body and draws u01
  from a pair-keyed PRF, or, for the others (``Parameterized``,
  ``Hydrodynamic``, ``Electric``), K1a: in the non-adaptive substep its
  Parameterized form (``coalesce_mirror_parameterized``), which evaluates
  those kernels in its body and takes the u01 draws as a row; in the
  adaptive one, which computes the kernel's values for its substep choice
  anyway, or for a kernel with neither body, ``coalesce_mirror_rows``,
  which takes the kernel x norm values and the u01 draws as rows;
- coalescence alone on the sort croupier, with no max-merged rows: K2
  (``coalesce_adjacent``), with the rates summed per cell through K4;
- bounce, coalescence and breakup on the mirror croupier, with the
  functions K5 evaluates, ``handle_all_breakups`` False and no max-merged
  rows: K5 (``coalesce_breakup_mirror``);
- everything else (breakup on the sort croupier or under injection, other
  functions, ``handle_all_breakups``, a state with max-merged rows): the
  float64 path, plain tensor ops on either pairing, ``ops/collisions.py``
  ``compute_gamma``, then ``coalesce`` (max-merging those rows) or
  ``ops/breakup.py`` ``collision_coalescence_breakup``, with three u01 rows
  per substep (gamma, process, fragment).
The adaptive variant first picks each cell's substep length with plain
tensor ops (``ops.collisions.scale_prob_adaptive``), as the JAX package
does with XLA ops ahead of its Pallas kernels. On CPU tensors each kernel
wrapper runs its plain twin.

Random numbers: a mirror substep's draws all come from ``_draw_mirror``:
(K, seed) from the particulator's host-side ``torch.Generator``, the u01
rows of K1a and of the float64 path from its generator on the state's
device (``device_rng``). The sort croupier's shuffle bits and u01 rows come
from ``device_rng``, never from the host. Under u01 injection
(``Builder.enable_u01_injection``) the ``collision_shuffle``,
``collision_gamma``, ``collision_process`` and ``collision_fragmentation``
rows come from ``sim["u01"]`` instead.

Host syncs: none in the non-adaptive step, but for ``handle_all_breakups``,
whose loop reads one boolean from the device after each of its first 32
iterations and then about every 32 (``ops/breakup.py``;
``breakup_iterations`` counts the iterations). The adaptive loop ``while dt_left > 0`` reads one boolean per
substep. ``host_reads`` counts both.

Spans (while a profiler records, ``utils/profiling.py``): a step's
reading of its state is ``Collision.prepare``, its handing on of the
state ``Collision.commit``, each substep ``Collision.substep``; inside it,
on either croupier ``Collision.draws`` (its random numbers) and
``Collision.gamma`` (the kernel's values, the probabilities, the mirror
croupier's adaptive scale, where a substep computes them); on the sort
croupier ``Collision.sort``,
``Collision.pairs``, ``Collision.cell_min`` (the per-cell adaptive
substep) and ``Collision.coalescence`` (K2 and the per-cell rates); on the
mirror croupier ``Collision.pairing`` (the ``MirrorPairing`` where the
substep builds one, and the attributes; on a fixed K1, K5 or in-body K1a
substep the attributes alone) and ``Collision.kernel`` (K1, K1a, K5 or the
float64 update); each read is ``Collision.read``.
"""

from collections import namedtuple

import torch

from ...impl.attributes import AttributeResolver
from ...ops import breakup as breakup_ops
from ...ops import collisions as coll_ops
from ...ops import segments as seg_ops
from ...ops.cuda.breakup import (
    BREAKUP_KERNELS,
    EB_CONST,
    EC_BERRY1967,
    EC_CONST,
    FRAG_ALWAYS_N,
    FRAG_CONSTANT_MASS,
    FRAG_EXPONENTIAL,
    PairFunctions,
    coalesce_breakup_mirror,
    required_rows,
)
from ...ops.cuda.collision import (
    KERNEL_ROWS,
    MIRROR_KERNELS,
    coalesce_adjacent,
    coalesce_mirror,
    coalesce_mirror_parameterized,
    coalesce_mirror_rows,
)
from ...ops.pairing import AdjacentPairing, MirrorPairing
from ...utils.profiling import span
from .breakup_efficiencies import ConstEb
from .breakup_fragmentations import AlwaysN
from .coalescence_efficiencies import ConstEc
from .collision_kernels import Parameterized

DEFAULTS = namedtuple(
    "_", ("dt_coal_range", "adaptive", "substeps", "max_multiplicity")
)(
    dt_coal_range=(0.1, 100.0),
    adaptive=True,
    substeps=1,
    max_multiplicity=2**63 // int(2e5),
)

_RATE_COUNTERS = ("collision_rate", "collision_rate_deficit", "coalescence_rate")
_BREAKUP_COUNTERS = _RATE_COUNTERS + ("breakup_rate", "breakup_rate_deficit")
# the functions K5 evaluates in its body, by role: (attribute, ids)
_K5_FUNCTIONS = (
    ("collision_kernel", BREAKUP_KERNELS),
    ("compute_coalescence_efficiency", (EC_CONST, EC_BERRY1967)),
    ("compute_breakup_efficiency", (EB_CONST,)),
    (
        "compute_number_of_fragments",
        (FRAG_ALWAYS_N, FRAG_CONSTANT_MASS, FRAG_EXPONENTIAL),
    ),
)
U01_PURPOSES = (
    "collision_shuffle", "collision_gamma", "collision_process",
    "collision_fragmentation",
)


class Collision:
    # the sort croupier leaves the state cell-sorted, which a following
    # Condensation can use (the builder's shared-sort analysis)
    restores_cell_sort = True
    # the host counters ``Particulator.counts`` gives
    COUNTERS = (
        "host_reads", "substeps_run", "breakup_iterations", "pairings_built",
    )

    def __init__(
        self,
        *,
        collision_kernel,
        coalescence_efficiency,
        breakup_efficiency,
        fragmentation_function,
        croupier=None,
        optimized_random=False,
        substeps: int = DEFAULTS.substeps,
        adaptive: bool = DEFAULTS.adaptive,
        dt_coal_range=DEFAULTS.dt_coal_range,
        enable_breakup: bool = True,
        warn_overflows: bool = True,  # accepted for API parity
    ):
        if not (substeps == 1 or adaptive is False):
            raise ValueError("substeps > 1 requires adaptive=False")
        if not dt_coal_range[0] > 0:
            raise ValueError("dt_coal_range must start above 0")
        self.particulator = None
        self.enable = True
        self.enable_breakup = enable_breakup
        self.max_multiplicity = DEFAULTS.max_multiplicity
        self.collision_kernel = collision_kernel
        self.compute_coalescence_efficiency = coalescence_efficiency
        self.compute_breakup_efficiency = breakup_efficiency
        self.compute_number_of_fragments = fragmentation_function
        self.croupier = croupier
        self.optimized_random = optimized_random
        self.substeps = substeps
        self.adaptive = adaptive
        self.dt_coal_range = tuple(dt_coal_range)
        self.u01_injection = False
        # set by the builder when a consumer relies on the sorted state even
        # while collisions are switched off (spin-up)
        self._sort_when_disabled = False
        # device values read back to steer the adaptive loop and the
        # handle_all_breakups loop, and the substeps run (one K1, K1a, K2
        # or K5 launch each on CUDA tensors where that route is taken)
        self.host_reads = 0
        self.substeps_run = 0
        self.breakup_iterations = 0
        # the ``MirrorPairing``s the mirror substeps built (none on a fixed
        # substep whose kernel pairs the slots itself)
        self.pairings_built = 0

    def _uses_mirror(self):
        return (
            self.particulator.mesh.n_cell == 1
            and not self.u01_injection
            and self.croupier != "sort"
        )

    def register(self, builder):
        self.particulator = builder.particulator
        if self.particulator.n_sd < 2:
            raise ValueError("No one to collide with!")
        self.u01_injection = builder.u01_injection
        if self.u01_injection:
            if self.adaptive or self.substeps != 1:
                raise ValueError(
                    "u01 injection requires adaptive=False, substeps=1"
                    " (one injected stream per purpose per step)"
                )
            for purpose in U01_PURPOSES:
                builder.add_u01_purpose(purpose)
        if self.dt_coal_range[1] > self.particulator.dt:
            self.dt_coal_range = (self.dt_coal_range[0], self.particulator.dt)
        self.collision_kernel.register(builder)
        if self.enable_breakup:
            self.compute_coalescence_efficiency.register(builder)
            self.compute_breakup_efficiency.register(builder)
            self.compute_number_of_fragments.register(builder)
        n_cell = self.particulator.mesh.n_cell
        rate_dtype = self.particulator.mult_dtype
        builder.add_flag("collision_enable", self.enable)
        builder.add_counter("collision_rate", n_cell, rate_dtype)
        # running totals accumulate in f64; the per-substep sums are f32
        builder.add_counter("collision_rate_deficit", n_cell, torch.float64)
        builder.add_counter("coalescence_rate", n_cell, rate_dtype)
        builder.add_counter("collision_n_substep", n_cell, torch.int32)
        # precision sentinel: largest single-substep rate sum observed (sums
        # beyond 2^24 are no longer exact in float32)
        builder.add_counter("rate_step_sum_max", 1, torch.float32)
        if self.enable_breakup:
            builder.add_counter("breakup_rate", n_cell, torch.float64)
            builder.add_counter("breakup_rate_deficit", n_cell, torch.float64)

    def route(self, particles=None):
        """the kernels a substep takes: "k1" (K1), "rows" (K1a), "k2" (K2),
        "k5" (K5) or "float64" (the plain float64 path), as the JAX package
        dispatches (``pysdm_tpu/dynamics/collisions/collision.py:
        364-457``): a state with max-merged rows takes the float64 path"""
        if particles is None:
            particles = self.particulator.sim_state["particles"]
        if particles.max_names:
            return "float64"
        if not self.enable_breakup:
            if not self._uses_mirror():
                return "k2"
            kernel_id = getattr(self.collision_kernel, "kernel_id", None)
            return "k1" if kernel_id in MIRROR_KERNELS else "rows"
        k5 = self._uses_mirror() and not (
            self.particulator.formulae.handle_all_breakups
        ) and all(
            getattr(getattr(self, role), "kernel_id", None) in ids
            for role, ids in _K5_FUNCTIONS
        )
        return "k5" if k5 else "float64"

    def _u01_rows(self, route):
        """the u01 rows a substep of ``route`` draws: none for K1 and K5
        (their PRF), gamma's for K1a and K2, and on the float64 path also
        the process and fragment rows where it breaks up"""
        if route in ("k1", "k5"):
            return 0
        return 3 if route == "float64" and self.enable_breakup else 1

    def _draw_mirror(self, n_sd, n_rows=0):
        """every draw of one mirror substep: K uniform in [0, n_sd) and a
        uint32 seed (K1's and K5's PRF key) from the particulator's
        host-side generator, and ``n_rows`` u01 rows on the state's device
        from its device generator (gamma; then process and fragment).
        Returns (K, seed, rows)."""
        particulator = self.particulator
        gen = particulator.rng
        K = int(torch.randint(0, n_sd, (), generator=gen))
        seed = int(torch.randint(0, 2**32, (), generator=gen))
        rows = [
            torch.rand(
                n_sd, generator=particulator.device_rng,
                device=particulator.device, dtype=particulator.dtype,
            )
            for _ in range(n_rows)
        ]
        return K, seed, rows

    def _draw_sorted(self, sim, n_rows):
        """every draw of one sort-croupier substep: the shuffle's random
        bits (integers in [0, 2^nbits), ``ops/segments.py``
        ``rand_bits_for``) and ``n_rows`` u01 rows (gamma; then process and
        fragment), from the device generator, or, under u01 injection, the
        injected rows of ``sim["u01"]``. Returns (shuffle, rows)."""
        purposes = U01_PURPOSES[1 : 1 + n_rows]
        if self.u01_injection:
            injected = sim["u01"]
            return (
                injected["collision_shuffle"],
                [injected[purpose] for purpose in purposes],
            )
        particulator = self.particulator
        gen, device = particulator.device_rng, particulator.device
        nbits = seg_ops.rand_bits_for(particulator.mesh.n_cell)
        bits = torch.randint(
            0, 2**nbits, (particulator.n_sd,), generator=gen, device=device,
            dtype=torch.int64,
        )
        rows = [
            torch.rand(
                particulator.n_sd, generator=gen, device=device,
                dtype=particulator.dtype,
            )
            for _ in purposes
        ]
        return bits, rows

    def _read(self, tensor):
        """a device value the host branches on (counted)"""
        self.host_reads += 1
        with span("Collision.read"):
            return tensor.item()

    def _tally(self, iterations):
        self.breakup_iterations += iterations

    def make_step(self, particulator):
        if self._uses_mirror():
            return self._make_mirror_step(particulator)
        return self._make_sorted_step(particulator)

    def _adaptive_loop(self, particles, counters, n_cell, substep):
        """run ``substep(particles, counters, dt_left)`` until every cell
        has spent its dt (one host read per substep)"""
        particulator = self.particulator
        dt_left = torch.full(
            (n_cell,), particulator.dt, dtype=particulator.dtype,
            device=particulator.device,
        )
        while self._read((dt_left > 0).any()):
            particles, dt_left = substep(particles, counters, dt_left)
        return particles

    def _needs_pairing(self, route, in_body):
        """whether a mirror substep of ``route`` reads a ``MirrorPairing``:
        the adaptive substep choice, the float64 update and K1a with the
        kernel's values given do; K1, K5 and K1a's Parameterized form
        (``in_body``) on a fixed substep pair slot o with (K - o) mod N in
        their body"""
        return (
            self.adaptive or route == "float64"
            or (route == "rows" and not in_body)
        )

    def _attr_names(self):
        """the attributes a substep reads: the collision kernel's, and with
        breakup those of Ec, Eb and the fragmentation function"""
        names = set(self.collision_kernel.required_attributes)
        if self.enable_breakup:
            for role in (
                "compute_coalescence_efficiency", "compute_breakup_efficiency",
                "compute_number_of_fragments",
            ):
                names |= set(getattr(getattr(self, role), "required_attributes", ()))
        return names

    def _float64_update(
        self, particles, counters, pairing, attrs_a, attrs_b, prob, rows,
        cell_start, n_cell,
    ):
        """the float64 path's pair update: gamma, then coalescence (with the
        max-merged rows) or bounce, coalescence and breakup"""
        formulae = self.particulator.formulae
        self.substeps_run += 1
        gamma = coll_ops.compute_gamma(
            prob, rows[0], particles.multiplicity, pairing, counters,
            cell_start, n_cell,
        )
        if not self.enable_breakup:
            has_max = bool(particles.max_names)
            mult, ext, maximum = coll_ops.coalesce(
                particles.multiplicity, particles.extensive, gamma, pairing,
                counters=counters, cell_start=cell_start, n_cell=n_cell,
                max_s=particles.maximum if has_max else None,
            )
            return particles.replace(
                multiplicity=mult, extensive=ext,
                maximum=maximum if has_max else particles.maximum,
            )
        _, fragment_mass = self.compute_number_of_fragments.pairwise(
            formulae, attrs_a, attrs_b, rows[2]
        )
        mult, ext = breakup_ops.collision_coalescence_breakup(
            mult_s=particles.multiplicity,
            ext_s=particles.extensive,
            ext_names=particles.ext_names,
            gamma=gamma,
            rand=rows[1],
            Ec=self.compute_coalescence_efficiency.pairwise(
                formulae, attrs_a, attrs_b
            ),
            Eb=self.compute_breakup_efficiency.pairwise(
                formulae, attrs_a, attrs_b
            ),
            fragment_mass=fragment_mass,
            pairing=pairing,
            counters=counters,
            max_multiplicity=self.max_multiplicity,
            handle_all_breakups=formulae.handle_all_breakups,
            cell_start=cell_start,
            n_cell=n_cell,
            read=self._read,
            tally=self._tally,
        )
        return particles.replace(multiplicity=mult, extensive=ext)

    def _make_mirror_step(self, particulator):
        n_sd = particulator.n_sd
        dt = particulator.dt
        ftype = particulator.dtype
        formulae = particulator.formulae
        resolver = AttributeResolver(formulae)
        kernel = self.collision_kernel
        dt_range = self.dt_coal_range
        route = self.route(particulator.sim_state["particles"])
        n_rows = self._u01_rows(route)
        # the rows route of a fixed substep evaluates Parameterized's kernel
        # in K1a's body; the adaptive one reads its values for the substep
        # choice first
        in_body = (
            route == "rows" and not self.adaptive
            and isinstance(kernel, Parameterized)
        )
        needs_pairing = self._needs_pairing(route, in_body)
        norm = coll_ops.mirror_normalization_factor(
            dt, particulator.mesh.dv, n_sd, ftype, particulator.device
        )
        fixed_scale = norm * (1.0 / self.substeps)
        if route == "k5":
            functions = PairFunctions.of(*(
                getattr(self, role) for role, _ in _K5_FUNCTIONS
            ))
            row_names = required_rows(functions)
            counter_names = _BREAKUP_COUNTERS
        elif route == "k1":
            row_names = KERNEL_ROWS[kernel.kernel_id]
            counter_names = _RATE_COUNTERS
        else:
            row_names = ()
            counter_names = _RATE_COUNTERS
        # every attribute a substep reads: the kernel's rows and the
        # collision kernel's own (the adaptive substep choice), or on K1a
        # and the float64 path every collision function's
        if route in ("k1", "k5"):
            attr_names = set(row_names) | set(kernel.required_attributes)
        else:
            attr_names = self._attr_names()
        attr_names = sorted(attr_names)

        def kernel_launch(particles, counters, draws, scale, attrs, values):
            """one substep through K1, K1a or K5; ``values``: the collision
            kernel at every slot's pair (K1a with the values given),
            ``scale``: the normalization times the probability scale"""
            K, seed, rows = draws
            self.substeps_run += 1
            if in_body:
                mult, ext, *rates = coalesce_mirror_parameterized(
                    particles.multiplicity, particles.extensive,
                    attrs["radius"], attrs["relative fall velocity"],
                    kernel.params, scale, rows[0].to(torch.float32), K,
                )
            elif route == "rows":
                mult, ext, *rates = coalesce_mirror_rows(
                    particles.multiplicity, particles.extensive,
                    (values * scale[0]).to(torch.float32),
                    rows[0].to(torch.float32), K,
                )
            else:
                rows32 = {name: attrs[name].to(torch.float32) for name in row_names}
                scale32 = scale.to(torch.float32)
                if route == "k5":
                    mult, ext, *rates = coalesce_breakup_mirror(
                        particles.multiplicity, particles.extensive,
                        particles.ext_names.index("signed water mass"), rows32,
                        functions, scale32, K, seed, self.max_multiplicity,
                    )
                else:
                    # one row (Golovin, ConstantK, Linear) as a view, not
                    # a copy
                    attr = (
                        rows32[row_names[0]].unsqueeze(0)
                        if len(row_names) == 1
                        else torch.stack([rows32[name] for name in row_names])
                    )
                    mult, ext, *rates = coalesce_mirror(
                        particles.multiplicity, particles.extensive, attr,
                        kernel.kernel_id, kernel.cuda_params, scale32, K, seed,
                    )
            for name, total in zip(counter_names, rates):
                counters[name] = coll_ops.accumulate_counter(
                    counters[name], total, counters
                )
            return particles.replace(multiplicity=mult, extensive=ext)

        def attributes(particles):
            return {name: resolver.get(particles, name) for name in attr_names}

        def gamma(particles, counters, dt_left, pairing, attrs):
            """the kernel's values at the pairs where the substep built a
            pairing to read them, the probabilities, and the substep's
            scale: (dt_left, scale, attrs_b, values, prob)"""
            values = attrs_b = prob = None
            if pairing is not None:
                attrs_b = {name: pairing.partner(v) for name, v in attrs.items()}
                values = kernel.pairwise(formulae, attrs, attrs_b).to(ftype)
            if dt_left is not None or route == "float64":
                prob = coll_ops.collision_probability(
                    values, particles.multiplicity, norm, pairing
                )
            if dt_left is None:
                scale = fixed_scale
                if prob is not None:
                    prob = prob * (1.0 / self.substeps)
            else:
                (
                    dt_left, counters["collision_n_substep"], dt_todo,
                ) = coll_ops.scale_prob_adaptive(
                    prob=prob,
                    mult_s=particles.multiplicity,
                    dt_left=dt_left,
                    dt=dt,
                    dt_range=dt_range,
                    stats_n_substep=counters["collision_n_substep"],
                    pairing=pairing,
                )
                scale = norm * (dt_todo / dt)
                prob = prob * dt_todo[0] / dt
            return dt_left, scale, attrs_b, values, prob

        def substep(particles, counters, dt_left):
            """one substep; ``dt_left`` None: the fixed substep"""
            with span("Collision.substep"):
                with span("Collision.draws"):
                    draws = self._draw_mirror(n_sd, n_rows)
                with span("Collision.pairing"):
                    pairing = None
                    if needs_pairing:
                        pairing = MirrorPairing(draws[0], n_sd, particles.alive)
                        self.pairings_built += 1
                    attrs = attributes(particles)
                with span("Collision.gamma"):
                    dt_left, scale, attrs_b, values, prob = gamma(
                        particles, counters, dt_left, pairing, attrs
                    )
                with span("Collision.kernel"):
                    if route == "float64":
                        particles = self._float64_update(
                            particles, counters, pairing, attrs, attrs_b,
                            prob, draws[2], None, 1,
                        )
                    else:
                        particles = kernel_launch(
                            particles, counters, draws, scale, attrs, values
                        )
                return particles, dt_left

        def step(sim):
            # spin-up gate (reference Arabas-2015 SpinUp flips enable)
            if not sim["flags"]["collision_enable"]:
                return sim
            with span("Collision.prepare"):
                particles = sim["particles"]
                counters = dict(sim["counters"])
            if not self.adaptive:
                for _ in range(self.substeps):
                    particles, _ = substep(particles, counters, None)
            else:
                particles = self._adaptive_loop(
                    particles, counters, 1, substep
                )
            with span("Collision.commit"):
                return {**sim, "particles": particles, "counters": counters}

        return step

    def _make_sorted_step(self, particulator):
        mesh = particulator.mesh
        n_cell = mesh.n_cell
        dt = particulator.dt
        ftype = particulator.dtype
        formulae = particulator.formulae
        resolver = AttributeResolver(formulae)
        kernel = self.collision_kernel
        attr_names = sorted(self._attr_names())
        dt_range = self.dt_coal_range
        prob_scale = 1.0 / self.substeps
        sort_when_disabled = self._sort_when_disabled
        route = self.route(particulator.sim_state["particles"])
        n_rows = self._u01_rows(route)

        def substep(particles, counters, dt_left, shuffle, rows):
            with span("Collision.sort"):
                (
                    particles, sorted_cell, cell_start, is_first,
                ) = seg_ops.bucket_shuffle_state(particles, shuffle, n_cell, mesh)
            with span("Collision.pairs"):
                pairing = AdjacentPairing(is_first)
                attrs_a = {
                    name: resolver.get(particles, name) for name in attr_names
                }
                attrs_b = {
                    name: seg_ops.pair_roll(v) for name, v in attrs_a.items()
                }
            with span("Collision.gamma"):
                kernel_values = kernel.pairwise(
                    formulae, attrs_a, attrs_b
                ).to(ftype)
                norm = coll_ops.normalization_factor(
                    cell_start, dt, mesh.dv, ftype
                )
                prob = None
                if self.adaptive or route == "float64":
                    prob = coll_ops.collision_probability(
                        kernel_values, particles.multiplicity, norm, pairing,
                        sorted_cell,
                    )
            if self.adaptive:
                with span("Collision.cell_min"):
                    (
                        dt_left, counters["collision_n_substep"], dt_todo,
                    ) = coll_ops.scale_prob_adaptive(
                        prob=prob,
                        mult_s=particles.multiplicity,
                        dt_left=dt_left,
                        dt=dt,
                        dt_range=dt_range,
                        stats_n_substep=counters["collision_n_substep"],
                        pairing=pairing,
                        sorted_cell=sorted_cell,
                        n_cell=n_cell,
                    )
                    cell_scale = norm * (dt_todo / dt)
                    if prob is not None:
                        prob = (
                            prob * coll_ops.at_slots(dt_todo, sorted_cell) / dt
                        )
            else:
                cell_scale = norm * prob_scale
                if prob is not None:
                    prob = prob * prob_scale
            with span("Collision.coalescence"):
                if route == "float64":
                    particles = self._float64_update(
                        particles, counters, pairing, attrs_a, attrs_b, prob,
                        rows, cell_start, n_cell,
                    )
                    return particles, dt_left
                kernnorm = kernel_values * coll_ops.at_slots(
                    cell_scale, sorted_cell
                )
                self.substeps_run += 1
                mult, ext, rate, deficit, _ = coalesce_adjacent(
                    particles.multiplicity, particles.extensive, kernnorm,
                    rows[0], is_first,
                )
                # the coalescence rate equals the collision rate in a
                # coalescence-only substep: one per-cell sum serves both,
                # and one scan both rows
                rate_c, deficit_c = coll_ops.per_cell_rates(
                    torch.stack([rate, deficit]), cell_start, n_cell
                )
                totals = (rate_c, deficit_c, rate_c)
                for name, total in zip(_RATE_COUNTERS, totals):
                    counters[name] = coll_ops.accumulate_counter(
                        counters[name], total, counters
                    )
                particles = particles.replace(multiplicity=mult, extensive=ext)
            return particles, dt_left

        def draws(sim):
            with span("Collision.draws"):
                return self._draw_sorted(sim, n_rows)

        def adaptive_substep(particles, counters, dt_left):
            with span("Collision.substep"):
                return substep(particles, counters, dt_left, *draws(None))

        def step(sim):
            if not sim["flags"]["collision_enable"]:
                # a consumer downstream (this step's or the next step's
                # Condensation) relies on the sorted state: sort, no physics
                if not sort_when_disabled or n_cell == 1:
                    return sim
                with span("Collision.sort"):
                    particles, _, _ = seg_ops.sort_state_by_cell(
                        sim["particles"], n_cell, mesh
                    )
                return {**sim, "particles": particles}
            with span("Collision.prepare"):
                particles = sim["particles"]
                counters = dict(sim["counters"])
            if not self.adaptive:
                for _ in range(self.substeps):
                    with span("Collision.substep"):
                        particles, _ = substep(
                            particles, counters, None, *draws(sim)
                        )
            else:
                particles = self._adaptive_loop(
                    particles, counters, n_cell, adaptive_substep
                )
            with span("Collision.commit"):
                return {**sim, "particles": particles, "counters": counters}

        return step


class Coalescence(Collision):
    def __init__(
        self,
        *,
        collision_kernel,
        coalescence_efficiency=None,
        croupier=None,
        optimized_random=False,
        substeps: int = DEFAULTS.substeps,
        adaptive: bool = DEFAULTS.adaptive,
        dt_coal_range=DEFAULTS.dt_coal_range,
    ):
        super().__init__(
            collision_kernel=collision_kernel,
            coalescence_efficiency=coalescence_efficiency or ConstEc(Ec=1),
            breakup_efficiency=ConstEb(Eb=0),
            fragmentation_function=AlwaysN(n=1),
            croupier=croupier,
            optimized_random=optimized_random,
            substeps=substeps,
            adaptive=adaptive,
            dt_coal_range=dt_coal_range,
            enable_breakup=False,
        )


class Breakup(Collision):
    def __init__(
        self,
        *,
        collision_kernel,
        fragmentation_function,
        croupier=None,
        optimized_random=False,
        substeps: int = DEFAULTS.substeps,
        adaptive: bool = DEFAULTS.adaptive,
        dt_coal_range=DEFAULTS.dt_coal_range,
        warn_overflows=True,
    ):
        super().__init__(
            collision_kernel=collision_kernel,
            coalescence_efficiency=ConstEc(Ec=0.0),
            breakup_efficiency=ConstEb(Eb=1.0),
            fragmentation_function=fragmentation_function,
            croupier=croupier,
            optimized_random=optimized_random,
            substeps=substeps,
            adaptive=adaptive,
            dt_coal_range=dt_coal_range,
            enable_breakup=True,
            warn_overflows=warn_overflows,
        )
