"""Serving: the greedy engine, the paper-partitioned request batcher and
the continuous-batching workflow engine."""
from .engine import (PartitionedBatcher, ReplicaGroup, ServeEngine,
                     WorkflowEngine, row_pgd_step)

__all__ = ["PartitionedBatcher", "ReplicaGroup", "ServeEngine",
           "WorkflowEngine", "row_pgd_step"]
