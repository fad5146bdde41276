"""Scheduler layer: the paper's partitioner wired into the runtime."""
from .balancer import UncertaintyAwareBalancer, integerize

__all__ = ["UncertaintyAwareBalancer", "integerize"]
