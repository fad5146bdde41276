"""Scheduler layer: the paper's partitioner wired into the runtime."""
from .balancer import (InstanceHeads, UncertaintyAwareBalancer,
                       WorkflowBalancer, integerize)

__all__ = ["InstanceHeads", "UncertaintyAwareBalancer", "WorkflowBalancer",
           "integerize"]
