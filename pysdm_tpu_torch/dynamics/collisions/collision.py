"""Collision dynamic: SDM Monte-Carlo coalescence and breakup (port of
``pysdm_tpu/dynamics/collisions/collision.py``).

Two croupiers, chosen as the JAX package chooses them:
- one cell (box, parcel): a substep draws (K, seed), pairs slot o with
  (K - o) mod N (the mirror croupier, ``ops/pairing.py``) and hands the
  whole pair update to one kernel: K1 (``coalesce_mirror``) for
  coalescence alone, which evaluates the collision kernel in its body, K5
  (``coalesce_breakup_mirror``) for bounce, coalescence and breakup
  (``Collision`` with ``enable_breakup``, ``Breakup``), which evaluates the
  collision kernel, Ec, Eb and the fragment mass in its body. Both take the
  kernels of ``ops/cuda/collision.py`` ``MIRROR_KERNELS``, as the JAX
  package's Pallas kernels take its ``pallas_safe`` ones; the others
  (``Parameterized``, ``Hydrodynamic``, ``Electric``), which the JAX package
  runs on its K1a with kernel values given as a row, raise in ``register``
  (ROADMAP: K1 with kernel rows given);
- many cells, u01 injection, or ``croupier="sort"``: a substep sorts the
  whole state by (cell, random bits) (``ops/segments.py``
  ``bucket_shuffle_state``), pairs neighbouring slots of a cell, computes
  the collision kernel and the per-cell normalization with torch ops and
  hands the pair update to K2 (``coalesce_adjacent``); the per-slot rates
  are summed per cell through K4. The state stays cell-sorted afterwards.
The adaptive variant first picks each cell's substep length with plain
tensor ops (``ops.collisions.scale_prob_adaptive``), as the JAX package
does with XLA ops ahead of its Pallas kernels. On CPU tensors each kernel
wrapper runs its plain twin.

Breakup runs only where the JAX package takes its Pallas kernel: one cell,
the mirror croupier, ``handle_all_breakups`` False, and the functions K5
evaluates. Everything else needs the JAX package's float64 breakup path
(``ops/breakup.py``), which is not ported: ``register`` raises
``NotImplementedError`` for it on any device.

Random numbers: (K, seed) come from the particulator's host-side
``torch.Generator``; the sort croupier's per-slot shuffle bits and gamma
draws from its generator on the state's device (``device_rng``), never
from the host. Under u01 injection (``Builder.enable_u01_injection``) the
``collision_shuffle`` and ``collision_gamma`` streams come from
``sim["u01"]`` instead.

Host syncs: none in the non-adaptive step. The adaptive loop ``while
dt_left > 0`` reads one boolean from the device per substep
(``host_reads`` counts them).
"""

from collections import namedtuple

import torch

from ...impl.attributes import AttributeResolver
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
)
from ...ops.pairing import AdjacentPairing, MirrorPairing
from .breakup_efficiencies import ConstEb
from .breakup_fragmentations import AlwaysN
from .coalescence_efficiencies import ConstEc

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
_NOT_PORTED = (
    "needs the JAX package's float64 breakup path (ops/breakup.py), which"
    " is not ported (ROADMAP: the float64 breakup path)"
)
U01_PURPOSES = ("collision_shuffle", "collision_gamma")


class Collision:
    # the sort croupier leaves the state cell-sorted, which a following
    # Condensation can use (the builder's shared-sort analysis)
    restores_cell_sort = True

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
        # device values read back to steer the adaptive loop, and the
        # substeps run (one K1, K2 or K5 launch each on CUDA tensors)
        self.host_reads = 0
        self.substeps_run = 0

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
        if self.enable_breakup:
            self._check_breakup(builder)
        if (
            not self.enable_breakup
            and self._uses_mirror()
            and getattr(self.collision_kernel, "kernel_id", None)
            not in MIRROR_KERNELS
        ):
            raise NotImplementedError(
                f"{type(self.collision_kernel).__name__} has no K1 body: the"
                " mirror croupier's kernel evaluates Golovin, ConstantK,"
                " Linear, Geometric and SimpleGeometric (croupier='sort'"
                " takes any kernel; ROADMAP: K1 with kernel rows given)"
            )
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

    def _check_breakup(self, builder):
        """breakup only where the JAX package takes its Pallas kernel K5
        (``pysdm_tpu/dynamics/collisions/collision.py:344-360``)"""
        if builder.formulae.handle_all_breakups:
            raise NotImplementedError(
                f"Formulae(handle_all_breakups=True) {_NOT_PORTED}"
            )
        if not self._uses_mirror():
            raise NotImplementedError(
                "breakup on the sort croupier (many cells, u01 injection or"
                f" croupier='sort') {_NOT_PORTED}"
            )
        for role, ids in _K5_FUNCTIONS:
            function = getattr(self, role)
            if getattr(function, "kernel_id", None) not in ids:
                raise NotImplementedError(
                    f"{type(function).__name__} has no body in K5, the"
                    f" mirror breakup kernel; it {_NOT_PORTED}"
                )

    def _draw_mirror(self, n_sd):
        """(K, seed) for one substep from the particulator's host-side
        generator: K uniform in [0, n_sd), seed a uint32"""
        gen = self.particulator.rng
        K = int(torch.randint(0, n_sd, (), generator=gen))
        seed = int(torch.randint(0, 2**32, (), generator=gen))
        return K, seed

    def _read(self, tensor):
        """a device value the host branches on (counted)"""
        self.host_reads += 1
        return tensor.item()

    def make_step(self, particulator):
        max_names = particulator.sim_state["particles"].max_names
        if max_names:
            # the JAX package max-merges these rows in its XLA coalescence
            # (``pysdm_tpu/ops/collisions.py:252``, ``coalesce(max_s=...)``)
            raise NotImplementedError(
                f"collisions of a state with max-merged rows {max_names} are"
                " not ported yet: they come with coalescence with max-merged"
                " rows (ROADMAP; morrison_and_grabowski_2007,"
                " arabas_et_al_2025)"
            )
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

    def _make_mirror_step(self, particulator):
        n_sd = particulator.n_sd
        dt = particulator.dt
        ftype = particulator.dtype
        formulae = particulator.formulae
        resolver = AttributeResolver(formulae)
        kernel = self.collision_kernel
        dt_range = self.dt_coal_range
        norm = coll_ops.mirror_normalization_factor(
            dt, particulator.mesh.dv, n_sd, ftype, particulator.device
        )
        fixed_scale = (norm * (1.0 / self.substeps)).to(torch.float32)
        if self.enable_breakup:
            functions = PairFunctions.of(*(
                getattr(self, role) for role, _ in _K5_FUNCTIONS
            ))
            row_names = required_rows(functions)
            counter_names = _BREAKUP_COUNTERS
        else:
            row_names = KERNEL_ROWS[kernel.kernel_id]
            counter_names = _RATE_COUNTERS
        # every attribute a substep reads: the kernel's rows, and the
        # collision kernel's own for the adaptive substep choice
        attr_names = sorted(set(row_names) | set(kernel.required_attributes))

        def collide(particles, counters, K, seed, scale, attrs):
            self.substeps_run += 1
            rows = {name: attrs[name].to(torch.float32) for name in row_names}
            if self.enable_breakup:
                mult, ext, *rates = coalesce_breakup_mirror(
                    particles.multiplicity, particles.extensive,
                    particles.ext_names.index("signed water mass"), rows,
                    functions, scale, K, seed, self.max_multiplicity,
                )
            else:
                mult, ext, *rates = coalesce_mirror(
                    particles.multiplicity, particles.extensive,
                    torch.stack([rows[name] for name in row_names]),
                    kernel.kernel_id, kernel.cuda_params, scale, K, seed,
                )
            for name, total in zip(counter_names, rates):
                counters[name] = coll_ops.accumulate_counter(
                    counters[name], total, counters
                )
            return particles.replace(multiplicity=mult, extensive=ext)

        def attributes(particles):
            return {name: resolver.get(particles, name) for name in attr_names}

        def adaptive_substep(particles, counters, dt_left):
            K, seed = self._draw_mirror(n_sd)
            pairing = MirrorPairing(K, n_sd, particles.alive)
            attrs = attributes(particles)
            kernel_values = kernel.pairwise(
                formulae, attrs,
                {name: pairing.partner(v) for name, v in attrs.items()},
            )
            prob = coll_ops.collision_probability(
                kernel_values, particles.multiplicity, norm, pairing
            )
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
            scale = (norm * (dt_todo / dt)).to(torch.float32)
            return collide(particles, counters, K, seed, scale, attrs), dt_left

        def step(sim):
            # spin-up gate (reference Arabas-2015 SpinUp flips enable)
            if not sim["flags"]["collision_enable"]:
                return sim
            particles = sim["particles"]
            counters = dict(sim["counters"])
            if not self.adaptive:
                for _ in range(self.substeps):
                    K, seed = self._draw_mirror(n_sd)
                    particles = collide(
                        particles, counters, K, seed, fixed_scale,
                        attributes(particles),
                    )
            else:
                particles = self._adaptive_loop(
                    particles, counters, 1, adaptive_substep
                )
            return {**sim, "particles": particles, "counters": counters}

        return step

    def _make_sorted_step(self, particulator):
        mesh = particulator.mesh
        n_cell = mesh.n_cell
        n_sd = particulator.n_sd
        dt = particulator.dt
        ftype = particulator.dtype
        device = particulator.device
        formulae = particulator.formulae
        resolver = AttributeResolver(formulae)
        kernel = self.collision_kernel
        attr_names = sorted(kernel.required_attributes)
        dt_range = self.dt_coal_range
        nbits = seg_ops.rand_bits_for(n_cell)
        prob_scale = 1.0 / self.substeps
        sort_when_disabled = self._sort_when_disabled

        def draws(sim):
            """(shuffle bits or u01, gamma u01) for one substep"""
            if self.u01_injection:
                injected = sim["u01"]
                return injected["collision_shuffle"], injected["collision_gamma"]
            gen = particulator.device_rng
            bits = torch.randint(
                0, 2**nbits, (n_sd,), generator=gen, device=device,
                dtype=torch.int64,
            )
            rand = torch.rand(n_sd, generator=gen, device=device, dtype=ftype)
            return bits, rand

        def substep(particles, counters, dt_left, shuffle, rand):
            (
                particles, sorted_cell, cell_start, is_first,
            ) = seg_ops.bucket_shuffle_state(particles, shuffle, n_cell, mesh)
            pairing = AdjacentPairing(is_first)
            attrs_a = {name: resolver.get(particles, name) for name in attr_names}
            attrs_b = {name: seg_ops.pair_roll(v) for name, v in attrs_a.items()}
            kernel_values = kernel.pairwise(formulae, attrs_a, attrs_b).to(ftype)
            norm = coll_ops.normalization_factor(cell_start, dt, mesh.dv, ftype)
            if self.adaptive:
                prob = coll_ops.collision_probability(
                    kernel_values, particles.multiplicity, norm, pairing,
                    sorted_cell,
                )
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
            else:
                cell_scale = norm * prob_scale
            kernnorm = kernel_values * coll_ops.at_slots(cell_scale, sorted_cell)
            self.substeps_run += 1
            mult, ext, rate, deficit, _ = coalesce_adjacent(
                particles.multiplicity, particles.extensive, kernnorm, rand,
                is_first,
            )
            # the coalescence rate equals the collision rate in a
            # coalescence-only substep: one per-cell sum serves both, and
            # one scan both rows
            rate_c, deficit_c = coll_ops.per_cell_rates(
                torch.stack([rate, deficit]), cell_start, n_cell
            )
            for name, total in zip(_RATE_COUNTERS, (rate_c, deficit_c, rate_c)):
                counters[name] = coll_ops.accumulate_counter(
                    counters[name], total, counters
                )
            return particles.replace(multiplicity=mult, extensive=ext), dt_left

        def adaptive_substep(particles, counters, dt_left):
            return substep(particles, counters, dt_left, *draws(None))

        def step(sim):
            if not sim["flags"]["collision_enable"]:
                # a consumer downstream (this step's or the next step's
                # Condensation) relies on the sorted state: sort, no physics
                if not sort_when_disabled or n_cell == 1:
                    return sim
                particles, _, _ = seg_ops.sort_state_by_cell(
                    sim["particles"], n_cell, mesh
                )
                return {**sim, "particles": particles}
            particles = sim["particles"]
            counters = dict(sim["counters"])
            if not self.adaptive:
                for _ in range(self.substeps):
                    particles, _ = substep(
                        particles, counters, None, *draws(sim)
                    )
            else:
                particles = self._adaptive_loop(
                    particles, counters, n_cell, adaptive_substep
                )
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
