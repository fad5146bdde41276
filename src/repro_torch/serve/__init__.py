"""Serving: the greedy engine and the paper-partitioned request batcher."""
from .engine import PartitionedBatcher, ReplicaGroup, ServeEngine

__all__ = ["PartitionedBatcher", "ReplicaGroup", "ServeEngine"]
