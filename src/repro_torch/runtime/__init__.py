"""``repro_torch.runtime`` — plan → compile → serve (port of
``repro.runtime``: the CNN and the quantized MoE workloads).

  plan     a ``DeploymentPlan`` JSON artifact written by either package's
           planner (``load_plan``), or ``plan_moe_deployment``
  compile  ``compile_plan(plan)`` → the plan's ``CompiledModel`` backend
           (``CompiledCNN``: batch-bucketed prepared kernel launches;
           ``CompiledMoE``: batch-bucketed residual MoE layers)
  serve    ``repro_torch.serve.CNNEngine`` / ``AsyncCNNGateway``
"""

from repro_torch.core.deploy import (DeploymentError, DeploymentPlan,
                                     PLAN_SCHEMA_VERSION)
from repro_torch.runtime.compiled import (CompiledCNN, CompiledModel,
                                          DispatchAborted, ExecutableCache,
                                          LayerLaunch, bucket_ladder,
                                          validate_container_input)
from repro_torch.runtime.plan_io import atomic_write_text, load_plan, save_plan
from repro_torch.runtime.workloads import (
    MOE_BLOCK_NAME, CNNWorkloadSpec, CompiledMoE, MoELayerSpec,
    MoEPlanValidation, MoEWorkloadSpec, WorkloadSpec, compile_plan,
    get_workload, list_workloads, moe_layer_demand, moe_plan_spec,
    moe_quantization_error, moe_workload_from_config, plan_moe_deployment,
    register_workload, validate_moe_plan, workload_spec)

__all__ = [
    "CNNWorkloadSpec", "CompiledCNN", "CompiledModel", "CompiledMoE",
    "DeploymentError", "DeploymentPlan", "DispatchAborted",
    "ExecutableCache", "LayerLaunch", "MOE_BLOCK_NAME", "MoELayerSpec",
    "MoEPlanValidation", "MoEWorkloadSpec", "PLAN_SCHEMA_VERSION",
    "WorkloadSpec", "atomic_write_text", "bucket_ladder", "compile_plan",
    "get_workload", "list_workloads", "load_plan", "moe_layer_demand",
    "moe_plan_spec", "moe_quantization_error", "moe_workload_from_config",
    "plan_moe_deployment", "register_workload", "save_plan",
    "validate_container_input", "validate_moe_plan", "workload_spec",
]
