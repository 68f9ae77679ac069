"""research/ — the factor-discovery engine.

The port of the JAX package's ``research/``: it
mass-produces candidate factors by evolutionary search over
:mod:`..search`'s genome space, with each generation's fitness a fused
backtest on the device (per-candidate exposures -> per-date Pearson/rank
IC + decile long-short spread, :mod:`.fitness`), a host GA around it
(:mod:`.evolve`), and every discovered genome registered as a stable,
serveable factor name (:mod:`.registry`). ``serve/`` has a
``research=True`` mode that runs discovery jobs on the request queue and
serves the results live. On one device, or with the population sharded
over an in-process mesh's devices (``DiscoveryEngine(mesh=)``,
:func:`.fitness.generation_fitness_sharded`), as a server with
``ServeConfig.discover_sharded`` and several devices runs it.
"""

from .evolve import DiscoveryEngine, DiscoveryResult
from .fitness import host_forward_returns
from .registry import (DiscoveredFactor, discovered_names, genome_name,
                       load_record, register_genome)

__all__ = [
    "DiscoveryEngine", "DiscoveryResult", "DiscoveredFactor",
    "discovered_names", "genome_name", "host_forward_returns",
    "load_record", "register_genome",
]
