"""One frozen config tree for the whole sparsification pipeline.

The paper frames pdGRASS and feGRASS as the *same* two-step pipeline
(spanning tree -> off-tree edge recovery) that differ only in how recovery
is organized.  :class:`PipelineConfig` makes that literal: a sparsifier is
described by three named, pluggable stages

  * ``tree``     — which spanning tree seeds the sparsifier
                   (``low_stretch`` effective-weight Boruvka / plain
                   ``boruvka`` max-weight ST),
  * ``score``    — how off-tree edges are ranked (``w_times_r`` spectral
                   criticality / raw ``r`` resistance / ``er_sample``
                   Gumbel-top-k effective-resistance sampling / ``er_exact``
                   true leverage scores via batched Laplacian solves),
  * ``recovery`` — which engine walks the ranked edges (``rounds``
                   round engine / ``serial`` numpy oracle / ``distributed``
                   mesh engine / ``multipass`` loose-similarity feGRASS),

plus the scalar knobs they share (``alpha``, ``c``, ``chunk``).  Stage
implementations live in :mod:`repro_torch.pipeline.stages` and are looked up by
name, so pdGRASS-vs-feGRASS is a config diff:

    >>> config_diff(pdgrass_config(), fegrass_config())
    {'recovery.kind': ('rounds', 'multipass'),
     'recovery.stop_at_target': (True, False)}

Configs serialize losslessly (``to_dict``/``from_dict``) and canonically
(``fingerprint``), which is what the solver cache keys and
``SolverService`` requests consume.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TreeConfig:
    """Stage 1: the spanning tree seeding the sparsifier."""

    kind: str = "low_stretch"   # low_stretch | boruvka


@dataclasses.dataclass(frozen=True)
class ScoreConfig:
    """Stage 2: the off-tree edge ranking rule."""

    kind: str = "w_times_r"     # w_times_r | r | er_sample | er_exact
    seed: int = 0               # er_sample: Gumbel-top-k sampling seed
    tol: float = 1e-6           # er_exact: exact-resistance solve tolerance


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Stage 3: the engine that walks the ranked off-tree edges."""

    kind: str = "rounds"        # rounds | serial | distributed | multipass
    block_size: int = 16        # rounds/distributed: candidates per subtask
    max_candidates: int = 128   # rounds: global per-round candidate cap
    stop_at_target: bool = True  # rounds: stop once target edges recovered
    max_passes: int = 200_000   # multipass (feGRASS): pass-count safety cap
    cutoff: Optional[int] = None  # distributed: giant-subtask edge cutoff
    axis: str = "data"          # distributed: mesh axis name


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """The full sparsification pipeline: shared knobs + one config per stage."""

    alpha: float = 0.02         # off-tree edge budget: ceil(alpha * |V|)
    c: int = 8                  # similarity BFS cap (beta <= c)
    chunk: int = 2048           # padding / marking-pass tile rows
    tree: TreeConfig = dataclasses.field(default_factory=TreeConfig)
    score: ScoreConfig = dataclasses.field(default_factory=ScoreConfig)
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        return validate(_from_dict(cls, d))

    def fingerprint(self) -> str:
        """Canonical serialization — feeds ``solver.cache`` content hashes."""
        return json.dumps(self.to_dict(), sort_keys=True)

    def digest(self, n: int = 12) -> str:
        """Short stable hash of :meth:`fingerprint` — a human-sized label
        for per-config stats keys and log lines."""
        return hashlib.sha256(self.fingerprint().encode()).hexdigest()[:n]

    def replace(self, **overrides) -> "PipelineConfig":
        return dataclasses.replace(self, **overrides)


_SUBCONFIGS = {"tree": TreeConfig, "score": ScoreConfig,
               "recovery": RecoveryConfig}


def _from_dict(cls, d):
    if not isinstance(d, dict):
        raise TypeError(f"{cls.__name__} wants a dict, got {type(d).__name__}")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys {sorted(unknown)}; "
            f"valid: {sorted(fields)}")
    kw = {}
    for name, value in d.items():
        sub = _SUBCONFIGS.get(name) if cls is PipelineConfig else None
        kw[name] = _from_dict(sub, value) if sub is not None else value
    return cls(**kw)


def validate(cfg: PipelineConfig) -> PipelineConfig:
    """Check every stage name against its registry; raise on unknowns."""
    from repro_torch.pipeline import stages  # late import: stages imports configs

    for label, kind, registry in (
            ("tree", cfg.tree.kind, stages.TREE_STAGES),
            ("score", cfg.score.kind, stages.SCORE_STAGES),
            ("recovery", cfg.recovery.kind, stages.RECOVERY_ENGINES)):
        if kind not in registry:
            raise ValueError(
                f"unknown {label} stage {kind!r}; registered: "
                f"{sorted(registry)}")
    if not cfg.alpha > 0:
        raise ValueError(f"alpha must be positive, got {cfg.alpha}")
    if cfg.c < 1:
        raise ValueError(f"c must be >= 1, got {cfg.c}")
    if cfg.chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {cfg.chunk}")
    return cfg


def config_diff(a: PipelineConfig, b: PipelineConfig) -> dict:
    """Flat ``{"stage.field": (a_value, b_value)}`` of differing leaves."""
    def flatten(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flatten(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out

    fa, fb = flatten(a.to_dict()), flatten(b.to_dict())
    return {k: (fa[k], fb[k]) for k in fa if fa[k] != fb[k]}


# ---------------------------------------------------------------------------
# The two named family members, as config factories
# ---------------------------------------------------------------------------

def pdgrass_config(alpha: float = 0.02, *, c: int = 8, chunk: int = 2048,
                   engine: str = "rounds", score_mode: str = "w_times_r",
                   tree: str = "low_stretch", seed: int = 0,
                   block_size: int = 16, max_candidates: int = 128,
                   stop_at_target: bool = True,
                   cutoff: Optional[int] = None,
                   axis: str = "data") -> PipelineConfig:
    """The paper's Algorithm 1: strict similarity, single-pass engines."""
    return validate(PipelineConfig(
        alpha=alpha, c=c, chunk=chunk,
        tree=TreeConfig(kind=tree),
        score=ScoreConfig(kind=score_mode, seed=seed),
        recovery=RecoveryConfig(
            kind=engine, block_size=block_size,
            max_candidates=max_candidates, stop_at_target=stop_at_target,
            cutoff=cutoff, axis=axis),
    ))


def fegrass_config(alpha: float = 0.02, *, c: int = 8, chunk: int = 2048,
                   score_mode: str = "w_times_r", tree: str = "low_stretch",
                   max_passes: int = 200_000) -> PipelineConfig:
    """The baseline (paper Table II): loose similarity, multi-pass recovery.

    Same tree and score stages as :func:`pdgrass_config` — the paper shares
    steps 1-2 for an apples-to-apples recovery comparison — so the entire
    pdGRASS-vs-feGRASS story is the ``recovery`` stage diff.
    """
    return validate(PipelineConfig(
        alpha=alpha, c=c, chunk=chunk,
        tree=TreeConfig(kind=tree),
        score=ScoreConfig(kind=score_mode),
        recovery=RecoveryConfig(kind="multipass", stop_at_target=False,
                                max_passes=max_passes),
    ))
