from repro_torch.serve.slots import GatewayStats, SlotPool
from repro_torch.serve.policy import (DeadlinePolicy, FifoPolicy,
                                      SchedulingPolicy, get_policy,
                                      list_policies)
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.serve.cnn_engine import (CNNEngine, CNNServeConfig,
                                          ImageRequest)
from repro_torch.serve.async_engine import (AdmissionQueue, AsyncCNNGateway,
                                            AsyncRequest, AsyncServeConfig,
                                            DeadlineExpired, GatewayBacklog,
                                            PlanUnavailable,
                                            RequestCancelled)

__all__ = ["SlotPool", "GatewayStats", "Engine", "Request", "ServeConfig",
           "CNNEngine", "CNNServeConfig", "ImageRequest",
           "SchedulingPolicy", "FifoPolicy", "DeadlinePolicy",
           "get_policy", "list_policies",
           "AdmissionQueue", "AsyncCNNGateway", "AsyncRequest",
           "AsyncServeConfig", "DeadlineExpired", "GatewayBacklog",
           "PlanUnavailable", "RequestCancelled"]
