"""Scheduler layer: the paper's partitioner wired into the runtime."""
from .balancer import UncertaintyAwareBalancer, WorkflowBalancer, integerize

__all__ = ["UncertaintyAwareBalancer", "WorkflowBalancer", "integerize"]
