"""Discovered factors: stable names, persisted genomes, live kernels.

The port of the JAX package's ``research/registry.py``. A genome that
survives a search becomes a first-class factor:

* a STABLE name ``disc_<hash>`` derived from ``(skeleton, genome)``
  alone (the same genome discovered twice, anywhere, gets the same
  name — registration is idempotent); the hash is the JAX package's,
  byte for byte, so both packages name a genome alike;
* a persisted record (JSON): the genome ints, the skeleton, the
  backtest stats it was selected on, the data fingerprint of the slab it
  was searched over, and its ``search.describe`` rendering — the JAX
  package's format, so a record either package writes loads in the
  other;
* a kernel registered into the factor universe
  (``models.registry.register_alias``, so its finalize class is
  ``batch_only``), so every ``DayContext``-driven path — the serve block
  graph, ``compute_factors`` — computes it next to the 58 built-ins by
  name.

Host-side module: numpy on numpy, plus the kernel's torch evaluation.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .. import search

#: name -> record of every factor registered in THIS process
DISCOVERED: Dict[str, "DiscoveredFactor"] = {}

_LOCK = threading.Lock()

#: genome-record schema version (bump on layout change)
RECORD_VERSION = 1


def genome_name(genome, skeleton=search.DEFAULT_SKELETON) -> str:
    """``disc_<10-hex>`` from ``(skeleton, genome)`` alone — content
    addressing, so names are stable across processes/hosts and
    re-registration is a no-op."""
    skeleton = tuple(int(s) for s in skeleton)
    g = np.ascontiguousarray(genome, np.int32)
    h = hashlib.blake2b(digest_size=5)
    h.update(np.ascontiguousarray(skeleton, np.int32).tobytes())
    h.update(g.tobytes())
    return f"disc_{h.hexdigest()}"


def data_fingerprint(bars, mask) -> str:
    """Provenance stamp of the slab a genome was searched over: a
    blake2b over the raw day-tensor bytes + shapes. Two records with
    equal fingerprints were selected on identical data; the stamp is
    NOT part of the factor name."""
    bars = np.ascontiguousarray(bars, np.float32)
    mask = np.ascontiguousarray(mask, bool)
    h = hashlib.blake2b(digest_size=8)
    h.update(repr(bars.shape).encode())
    h.update(bars.tobytes())
    h.update(mask.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class DiscoveredFactor:
    """One registered discovery — the persisted record's in-memory
    twin (field names == JSON keys)."""
    name: str
    genome: Tuple[int, ...]
    skeleton: Tuple[int, ...]
    fitness: float
    mean_ic: float
    mean_rank_ic: float
    spread: float
    generations: int
    pop: int
    data_fingerprint: Optional[str]
    description: str
    version: int = RECORD_VERSION

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["genome"] = [int(g) for g in self.genome]
        d["skeleton"] = [int(s) for s in self.skeleton]
        return d


def make_kernel(genome, skeleton=search.DEFAULT_SKELETON):
    """A ``fn(ctx) -> [..., T]`` factor kernel evaluating the genome
    over the context's day tensor — ``search.eval_programs`` on a
    population of one, on the context's device, so the serving path
    and the search path share one evaluator. Handles both the batched
    ``[D, T, S, 5]`` and the single-day ``[T, S, 5]`` context layouts
    (the cross-day features need a day axis; a single day gets a
    length-1 one)."""
    skeleton = tuple(int(s) for s in skeleton)
    g = np.ascontiguousarray(genome, np.int32)[None]  # [1, L]

    def kernel(ctx):
        bars, mask = ctx.bars, ctx.mask
        batched = bars.dim() == 4
        if not batched:
            bars, mask = bars[None], mask[None]
        vals = search.eval_programs(g, bars, mask, skeleton)[0]  # [D, T]
        return vals if batched else vals[0]
    return kernel


def register_genome(genome, skeleton=search.DEFAULT_SKELETON, *,
                    fitness: float = float("nan"),
                    mean_ic: float = float("nan"),
                    mean_rank_ic: float = float("nan"),
                    spread: float = float("nan"),
                    generations: int = 0, pop: int = 0,
                    data_fingerprint: Optional[str] = None,
                    save_dir: Optional[str] = None,
                    telemetry=None) -> DiscoveredFactor:
    """Name + record + kernel registration in one step (idempotent on
    the content-addressed name). With ``save_dir`` the record persists
    as ``<name>.json`` (atomic write+rename). Returns the record."""
    skeleton = tuple(int(s) for s in skeleton)
    genome = tuple(int(x) for x in np.ascontiguousarray(genome,
                                                        np.int32))
    name = genome_name(genome, skeleton)
    rec = DiscoveredFactor(
        name=name, genome=genome, skeleton=skeleton,
        fitness=float(fitness), mean_ic=float(mean_ic),
        mean_rank_ic=float(mean_rank_ic), spread=float(spread),
        generations=int(generations), pop=int(pop),
        data_fingerprint=data_fingerprint,
        description=search.describe(genome, skeleton))
    from ..models import registry as models_registry
    with _LOCK:
        fresh = name not in DISCOVERED
        DISCOVERED[name] = rec
        models_registry.register_alias(name, make_kernel(genome,
                                                         skeleton))
    if telemetry is not None:
        telemetry.counter("discover.registered",
                          outcome="fresh" if fresh else "repeat")
    if save_dir:
        save_record(rec, save_dir)
    return rec


def discovered_names() -> Tuple[str, ...]:
    with _LOCK:
        return tuple(DISCOVERED)


def get(name: str) -> DiscoveredFactor:
    with _LOCK:
        return DISCOVERED[name]


def save_record(rec: DiscoveredFactor, out_dir: str) -> str:
    """Persist one genome record as ``<name>.json`` (atomic)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec.name}.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(rec.to_json(), fh, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def load_record(path: str) -> DiscoveredFactor:
    """Load a persisted record; the round-trip is verified — the
    stored name and description must re-derive from the stored
    ``(skeleton, genome)`` (a corrupted or hand-edited record fails
    loudly instead of serving the wrong factor under a trusted
    name)."""
    with open(path) as fh:
        doc = json.load(fh)
    genome = tuple(int(g) for g in doc["genome"])
    skeleton = tuple(int(s) for s in doc["skeleton"])
    name = genome_name(genome, skeleton)
    if name != doc["name"]:
        raise ValueError(
            f"genome record {path!r} names {doc['name']!r} but its "
            f"genome hashes to {name!r} — corrupted record")
    desc = search.describe(genome, skeleton)
    if desc != doc["description"]:
        raise ValueError(
            f"genome record {path!r} description does not round-trip "
            f"through search.describe — corrupted record")
    return DiscoveredFactor(
        name=name, genome=genome, skeleton=skeleton,
        fitness=float(doc.get("fitness", float("nan"))),
        mean_ic=float(doc.get("mean_ic", float("nan"))),
        mean_rank_ic=float(doc.get("mean_rank_ic", float("nan"))),
        spread=float(doc.get("spread", float("nan"))),
        generations=int(doc.get("generations", 0)),
        pop=int(doc.get("pop", 0)),
        data_fingerprint=doc.get("data_fingerprint"),
        description=desc,
        version=int(doc.get("version", RECORD_VERSION)))
