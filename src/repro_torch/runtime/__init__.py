from .fault_tolerance import (ElasticPlan, HeartbeatRegistry,
                              StragglerMonitor, TrainSupervisor,
                              plan_elastic_mesh)
from .faults import (FAULT_EXC_TYPES, RETRY_SITES, SITES, STEP_FAULT_TYPES,
                     FaultSchedule, SiteSpec, UnknownSiteError, arm, current,
                     disarm, injecting, is_armed, is_injected, site)
from .retry import DEFAULT_POLICY, IO_POLICY, RetryPolicy, retry_call

__all__ = ["STEP_FAULT_TYPES", "ElasticPlan", "HeartbeatRegistry",
           "StragglerMonitor", "TrainSupervisor", "plan_elastic_mesh",
           "FAULT_EXC_TYPES", "SITES", "RETRY_SITES", "FaultSchedule",
           "SiteSpec", "UnknownSiteError", "arm", "current",
           "disarm", "injecting", "is_armed", "is_injected", "site",
           "DEFAULT_POLICY", "IO_POLICY", "RetryPolicy", "retry_call"]
