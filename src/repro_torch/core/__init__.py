"""The paper's planner in PyTorch: channel and cost models, the batched
P1/P2/P3 primitives (``batch``), the planning tick and fleet rollout
(``rollout``), the scalar planner (``power``, ``positions``,
``placement``, ``planner``) and the pipeline-stage planner
(``pipeline_opt``).  The pipeline planner's names are exported here, as
the reference's ``repro.core`` exports them; import the other submodules
directly."""
from repro_torch.core.channel import ICIChannel, ICIParams
from repro_torch.core.cost_model import arch_cost, model_flops
from repro_torch.core.pipeline_opt import (ChipParams, StagePlan,
                                           pipeline_efficiency, plan_pipeline,
                                           stage_devices)
from repro_torch.core.placement import solve_chain_dp_minmax
from repro_torch.core.positions import assign_stages_to_torus

__all__ = ["ICIChannel", "ICIParams", "arch_cost", "model_flops",
           "ChipParams", "StagePlan", "pipeline_efficiency", "plan_pipeline",
           "stage_devices", "solve_chain_dp_minmax", "assign_stages_to_torus"]
