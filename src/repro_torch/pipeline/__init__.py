"""repro_torch.pipeline: the staged sparsification API of the port.

    from repro_torch.pipeline import Pipeline, pdgrass_config
    sp = Pipeline(pdgrass_config(alpha=0.05)).run(graph, device="cuda")
"""
from repro_torch.pipeline.api import Pipeline, run_pipeline
from repro_torch.pipeline.config import (PipelineConfig, RecoveryConfig,
                                         ScoreConfig, TreeConfig,
                                         config_diff, fegrass_config,
                                         pdgrass_config, validate)
from repro_torch.pipeline.stages import (RECOVERY_ENGINES, SCORE_STAGES,
                                         TREE_STAGES, register)

__all__ = [
    "Pipeline", "run_pipeline",
    "PipelineConfig", "TreeConfig", "ScoreConfig", "RecoveryConfig",
    "pdgrass_config", "fegrass_config", "config_diff", "validate",
    "TREE_STAGES", "SCORE_STAGES", "RECOVERY_ENGINES", "register",
]
