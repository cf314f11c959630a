"""The paper's own workload config: distributed pdGRASS edge recovery.

The port's copy of ``repro.configs.pdgrass_graph``, every field and value
unchanged.  Not an LM architecture: it describes the graph-sparsification
production job, a power-grid-scale graph whose off-tree edges are sharded
across the full mesh and recovered with the inner (cross-shard) round
engine.  Run by :mod:`repro_torch.launch.dryrun_pdgrass`.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PdGrassConfig:
    name: str = "pdgrass-graph"
    n_vertices: int = 16_000_000          # |V| ~ 1.6e7 (power-grid scale)
    m_offtree: int = 2 ** 25              # 33.5M off-tree edges
    c: int = 8                            # BFS cap (beta <= c)
    block_size: int = 64                  # candidates per round per shard
    chunk: int = 4096                     # marking-pass tile rows


CONFIG = PdGrassConfig()
