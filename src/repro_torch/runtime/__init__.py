"""``repro_torch.runtime`` — plan → compile → serve (port of
``repro.runtime``, CNN workload).

  plan     a ``DeploymentPlan`` JSON artifact written by the reference's
           planner (``load_plan``)
  compile  ``compile_plan(plan)`` → the plan's ``CompiledModel`` backend
           (``CompiledCNN``): batch-bucketed prepared kernel launches
  serve    ``repro_torch.serve.CNNEngine``
"""

from repro_torch.core.deploy import (DeploymentError, DeploymentPlan,
                                     PLAN_SCHEMA_VERSION)
from repro_torch.runtime.compiled import (CompiledCNN, CompiledModel,
                                          DispatchAborted, ExecutableCache,
                                          LayerLaunch, bucket_ladder,
                                          validate_container_input)
from repro_torch.runtime.plan_io import atomic_write_text, load_plan, save_plan
from repro_torch.runtime.workloads import (CNNWorkloadSpec, WorkloadSpec,
                                           compile_plan, get_workload,
                                           list_workloads, register_workload,
                                           workload_spec)

__all__ = [
    "CNNWorkloadSpec", "CompiledCNN", "CompiledModel", "DeploymentError",
    "DeploymentPlan", "DispatchAborted", "ExecutableCache", "LayerLaunch",
    "PLAN_SCHEMA_VERSION", "WorkloadSpec", "atomic_write_text",
    "bucket_ladder", "compile_plan", "get_workload", "list_workloads",
    "load_plan", "register_workload", "save_plan",
    "validate_container_input", "workload_spec",
]
