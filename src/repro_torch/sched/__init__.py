"""Scheduler layer: the paper's partitioner wired into the runtime."""
from .balancer import (InstanceHeads, UncertaintyAwareBalancer,
                       WorkflowBalancer, integerize)
from .straggler import StragglerPolicy

__all__ = ["InstanceHeads", "StragglerPolicy", "UncertaintyAwareBalancer",
           "WorkflowBalancer", "integerize"]
