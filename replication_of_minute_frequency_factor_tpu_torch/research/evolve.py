"""The evolutionary loop around the fused generation fitness.

The port of the JAX package's ``research/evolve.py``.
``DiscoveryEngine`` owns the per-generation callable (:mod:`.fitness`) as
a warm entry of the serving layer's
:class:`..serve.executables.ExecutableCache` and runs the host-side GA
around it: selection, mutation and crossover stay on the host on the int
genome matrix and consume ONLY the fetched ``[P, 4]`` stats matrix.

Sync budget: each generation waits for the device exactly once — the
fetch of the generation's stats matrix, counted at the call site in
``research.host_blocking_syncs{point=generation_fetch}``. The genome
plan goes up in one non-blocking copy from pinned memory, and nothing
else crosses the boundary until the next generation's fetch.

Build budget: torch compiles nothing. ``compiles_during_loop`` counts
what the process builds during the generation loop
(:func:`..kernels.build_count`: ``nvcc`` runs and kernel-library loads),
where the JAX package counts ``xla.compiles``; a generation loads no
kernel library, so it reads 0. The executable cache's
``serve.executables{outcome=miss}`` counts the callables' keys, and
after :meth:`DiscoveryEngine.warmup` the loop adds none.

With ``mesh`` (an in-process tickers mesh, ``parallel.resident_mesh(n,
devices=[...])``) the population is sharded over the mesh's devices
(:func:`.fitness.generation_fitness_sharded`): the day tensors and the
feature bank go to every device once a job, the population is padded to
a multiple of the shard count, and the end-of-generation top-k is the
one collective. The sync budget is the same: one fetch a generation.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import search

#: named skeletons a service request can address without shipping slot
#: lists over the wire (the genome record persists the resolved ints)
SKELETONS = {"default": search.DEFAULT_SKELETON,
             "rich": search.RICH_SKELETON}

def resolve_skeleton(skeleton) -> Tuple[int, ...]:
    """A skeleton argument as the canonical int tuple: a name from
    :data:`SKELETONS` or an explicit slot sequence."""
    if isinstance(skeleton, str):
        try:
            return SKELETONS[skeleton]
        except KeyError:
            raise ValueError(
                f"unknown skeleton {skeleton!r} (one of "
                f"{tuple(SKELETONS)})") from None
    return tuple(int(s) for s in skeleton)


@dataclasses.dataclass
class DiscoveryData:
    """Device-resident day tensor, its feature bank and the forward
    returns for one search job: put once in
    :meth:`DiscoveryEngine.prepare`, reused by every generation (the
    loop ships only genome plans). On a mesh each device field is a list
    of the shards' copies, in shard order."""
    bars: torch.Tensor
    mask: torch.Tensor
    fwd_ret: torch.Tensor
    fwd_valid: torch.Tensor
    feats: torch.Tensor             # search._features of (bars, mask)
    shape: Tuple[int, ...]          # mask shape [D, T, S]
    fingerprint: str                # data provenance (registry record)
    horizon: int = 1

    @property
    def device_args(self) -> tuple:
        return (self.feats, self.mask, self.fwd_ret, self.fwd_valid)


@dataclasses.dataclass
class DiscoveryResult:
    """One bounded-generations search: the best genome with its full
    backtest stats, plus the loop's measured evidence (sync budget,
    build count, per-generation walls)."""
    genome: np.ndarray              # [L] int32
    skeleton: Tuple[int, ...]
    fitness: float                  # |mean IC| of the best genome
    mean_ic: float
    mean_rank_ic: float
    spread: float
    history: np.ndarray             # best fitness per generation
    generations: int
    pop: int
    occupancy: float                # pop / padded population
    n_shards: int
    syncs_per_generation: float     # measured counter delta / gens
    #: kernel-library builds and loads during the generation loop
    #: (``kernels.build_count`` delta; the JAX package counts
    #: ``xla.compiles`` here, and torch compiles nothing)
    compiles_during_loop: int
    gen_walls_s: Sequence[float]
    fingerprint: str
    #: the final generation's on-device top-k (values, indices) — still
    #: device tensors; tests fetch them to cross-check the device
    #: selection against the host argsort
    device_topk: tuple = ()


class DiscoveryEngine:
    """Bounded evolutionary search with a warm generation callable.

    Runs on ``device`` (default ``cuda``, which must be present;
    ``device='cpu'`` runs on the CPU), or with ``mesh`` shards the
    population over the mesh's devices. The engine shares an
    :class:`..serve.executables.ExecutableCache` with its caller (the
    serving layer passes its own, so a server's discovery jobs and its
    query graphs live under one build-count ground truth).
    """

    def __init__(self, skeleton="default", group_num: int = 5,
                 device_batch: int = 1024, telemetry=None,
                 executables=None, mesh=None, device=None):
        from ..pipeline import resolve_device
        from ..serve.executables import ExecutableCache
        #: the in-process tickers mesh the population is sharded over
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            if self.device.type == "cuda" and self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
        else:
            from ..parallel.local import lead_device
            #: the lead device: where each generation's stats land
            self.device = lead_device(mesh, device, "DiscoveryEngine")
        self.skeleton = resolve_skeleton(skeleton)
        self.group_num = int(group_num)
        self.device_batch = int(device_batch)
        self.telemetry = telemetry
        self.executables = (executables if executables is not None
                            else ExecutableCache(telemetry=telemetry))
        #: host-side progress mirrors: what the SLO plane's timeline
        #: sampler reads through :meth:`progress` — updated from values
        #: the loop already holds, never a device read
        self.generations_done = 0
        self.last_candidates_per_s = 0.0
        self._last_gen_t: Optional[float] = None

    def progress(self) -> dict:
        """Derived throughput signals for the timeline sampler
        (``gauge:discover.*`` series) — host mirrors only.
        ``discover.stall_s`` (seconds since the last completed
        generation) is the discovery freshness signal."""
        out = {"discover.generations_done": float(self.generations_done),
               "discover.candidates_per_s":
                   float(self.last_candidates_per_s)}
        if self._last_gen_t is not None:
            out["discover.stall_s"] = round(
                max(0.0, time.monotonic() - self._last_gen_t), 6)
        return out

    def _tel(self):
        if self.telemetry is not None:
            return self.telemetry
        from ..telemetry import get_telemetry
        return get_telemetry()

    @property
    def n_shards(self) -> int:
        if self.mesh is None:
            return 1
        from ..parallel.mesh import TICKERS_AXIS
        return int(self.mesh.shape[TICKERS_AXIS])

    # --- data placement -------------------------------------------------
    def prepare(self, bars, mask, fwd_ret, fwd_valid,
                horizon: int = 1) -> DiscoveryData:
        """Put the job's day tensor + forward returns on the device (host
        numpy in, device tensors out) and build its feature bank there; on
        a mesh, on every shard's device. One put per job; generations
        reuse the tensors."""
        from .registry import data_fingerprint
        bars = np.ascontiguousarray(bars, np.float32)
        mask = np.ascontiguousarray(mask, bool)
        fwd_ret = np.ascontiguousarray(fwd_ret, np.float32)
        fwd_valid = np.ascontiguousarray(fwd_valid, bool)
        fp = data_fingerprint(bars, mask)

        def put_on(device):
            d = [torch.from_numpy(x).to(device)
                 for x in (bars, mask, fwd_ret, fwd_valid)]
            return d + [search._features(d[0], d[1])]

        if self.mesh is None:
            fields = put_on(self.device)
        else:  # each shard puts its copy on its device, on its stream
            fields = [list(f) for f in zip(*self.mesh.run(
                lambda view: put_on(view.device)))]
        return DiscoveryData(bars=fields[0], mask=fields[1],
                             fwd_ret=fields[2], fwd_valid=fields[3],
                             feats=fields[4], shape=mask.shape,
                             fingerprint=fp, horizon=int(horizon))

    # --- the generation callable ----------------------------------------
    def _generation_exe(self, data: DiscoveryData, pop: int,
                        n_elite: int):
        """The warm per-generation callable for ``(data shape, pop,
        n_elite)``, keyed as the JAX package keys its executable (the
        padded population, the chunk of a shard's block, and the
        placement: the mesh's devices, or the one device). A build binds
        it and runs it once on a fixed-seed probe population, so the first
        use of each device kernel (CUDA loads them lazily) lands here and
        not in the first generation."""
        from . import fitness as F
        p_pad = self._pad_pop(pop)
        chunk = min(self.device_batch, max(1, p_pad // self.n_shards),
                    search.auto_chunk(data.shape))
        place = str(self.device) if self.mesh is None else self.mesh.key()
        key = ("discover_generation", self.skeleton, self.group_num,
               chunk, int(n_elite), pop, p_pad, tuple(data.shape), place)

        def build():
            if self.mesh is None:
                fn = functools.partial(
                    F.generation_fitness, skeleton=self.skeleton,
                    group_num=self.group_num, chunk=chunk,
                    n_elite=int(n_elite))
            else:
                fn = functools.partial(
                    F.generation_fitness_sharded, mesh=self.mesh,
                    skeleton=self.skeleton, group_num=self.group_num,
                    chunk=chunk, n_elite=int(n_elite), n_pop=pop)
            probe = search.random_population(np.random.default_rng(0),
                                             p_pad, self.skeleton)
            fn(probe, *data.device_args)
            return fn

        return self.executables.get("discover_generation", key, build)

    def warmup(self, data: DiscoveryData, pop: int,
               elite_frac: float = 0.1) -> None:
        """Build the generation callable for this (data, pop) shape —
        after this the generation loop builds NOTHING
        (``compiles_during_loop`` == 0)."""
        self._generation_exe(data, pop, self._n_elite(pop, elite_frac))

    def _pad_pop(self, pop: int) -> int:
        return pop + (-pop % self.n_shards)

    @staticmethod
    def _n_elite(pop: int, elite_frac: float) -> int:
        return max(2, min(pop, int(pop * elite_frac)))

    # --- the loop -------------------------------------------------------
    def evolve(self, data: DiscoveryData, pop: int = 256,
               generations: int = 8, elite_frac: float = 0.1,
               mutate_p: float = 0.15,
               rng: Optional[np.random.Generator] = None,
               seed: int = 0) -> DiscoveryResult:
        """Run a bounded-generations GA over ``data``.

        Reproducibility contract: the search is a pure function of
        ``(data, pop, generations, elite_frac, mutate_p, rng state,
        skeleton)`` — ``rng`` is the EXPLICIT generator threaded through
        every random draw (``seed`` seeds a fresh one when absent).
        """
        tel = self._tel()
        reg = tel.registry
        if rng is None:
            rng = np.random.default_rng(seed)
        pop = int(pop)
        generations = int(generations)
        n_elite = self._n_elite(pop, elite_frac)
        exe = self._generation_exe(data, pop, n_elite)
        p_pad = self._pad_pop(pop)
        occupancy = pop / p_pad
        tel.gauge("discover.population_occupancy", occupancy)
        if self.mesh is not None:
            tel.meshplane.record_occupancy(occupancy,
                                           boundary="discover.population")

        bounds = search._gene_bounds(self.skeleton)
        genomes = search.random_population(rng, pop, self.skeleton)
        pad_rows = np.zeros((p_pad - pop, len(self.skeleton)), np.int32)

        best_g = genomes[0].copy()
        best_stats = np.full(4, np.nan, np.float32)
        best_stats[0] = -1.0
        history = []
        gen_walls = []
        device_topk: tuple = ()

        def syncs():
            return reg.counter_value("research.host_blocking_syncs",
                                     point="generation_fetch")

        from .. import kernels
        built = kernels.build_count
        syncs_before = syncs()
        built_before = built()
        t_loop = time.perf_counter()
        for _ in range(generations):
            t0 = time.perf_counter()
            gp = (genomes if not len(pad_rows)
                  else np.concatenate([genomes, pad_rows]))
            if self.mesh is not None:
                # the one collective of the generation: the top-k gather
                tel.meshplane.note_collective("discover_topk")
            stats_dev, top_vals, top_idx = exe(gp, *data.device_args)
            with tel.tracer("research.generation_fetch"):
                # the ONE host-blocking sync of the generation: everything
                # below is numpy on the fetched [P, 4] matrix
                stats = stats_dev.detach().cpu().numpy()[:pop]
            tel.counter("research.host_blocking_syncs",
                        point="generation_fetch")
            device_topk = (top_vals, top_idx)

            fits = np.nan_to_num(stats[:, 0], nan=-1.0)
            order = np.argsort(-fits, kind="stable")
            if fits[order[0]] > best_stats[0]:
                best_stats = stats[order[0]].copy()
                best_stats[0] = fits[order[0]]
                best_g = genomes[order[0]].copy()
            history.append(float(fits[order[0]]))
            tel.counter("discover.generations")
            self.generations_done += 1
            self._last_gen_t = time.monotonic()
            tel.gauge("discover.best_ic", float(best_stats[1]))
            # refill: uniform crossover of random elite pairs +
            # per-gene mutation — search.evolve's operators, threaded
            # through THIS loop's explicit rng
            elite = genomes[order[:n_elite]]
            pa = elite[rng.integers(0, n_elite, pop - n_elite)]
            pb = elite[rng.integers(0, n_elite, pop - n_elite)]
            take = rng.random(pa.shape) < 0.5
            children = np.where(take, pa, pb)
            mut = rng.random(children.shape) < mutate_p
            children = np.where(
                mut,
                (rng.random(children.shape) * bounds).astype(np.int32),
                children)
            genomes = np.concatenate([elite, children])
            gen_walls.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t_loop
        cps = (pop * generations / wall) if wall > 0 else 0.0
        tel.gauge("discover.candidates_per_s", cps)
        self.last_candidates_per_s = cps
        n_syncs = syncs() - syncs_before
        return DiscoveryResult(
            genome=best_g, skeleton=self.skeleton,
            fitness=float(best_stats[0]),
            mean_ic=float(best_stats[1]),
            mean_rank_ic=float(best_stats[2]),
            spread=float(best_stats[3]),
            history=np.asarray(history), generations=generations,
            pop=pop, occupancy=occupancy, n_shards=self.n_shards,
            syncs_per_generation=(n_syncs / generations
                                  if generations else 0.0),
            compiles_during_loop=int(built() - built_before),
            gen_walls_s=[round(w, 6) for w in gen_walls],
            fingerprint=data.fingerprint,
            device_topk=device_topk)
