"""Cluster simulator: stochastic channels, draw for draw with the JAX
package's simulator."""
from .cluster import Channel, ClusterSim

__all__ = ["Channel", "ClusterSim"]
