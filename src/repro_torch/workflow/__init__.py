"""repro_torch.workflow — stage-DAG workflows over uncertain channel fleets.

The paper's single split-join lifted to fork-join graphs: every stage is a
workload with its own fleet and family, moments compose along the graph
(series sums, Clark joins), and all stage splits are optimized jointly for
the end-to-end makespan through one stacked kernel call per family group
(``workflow.solve``). The scheduler's side is ``sched.WorkflowBalancer``;
the simulated ground truth is ``sim.WorkflowSim``.
"""
from .dag import (DAGValidationError, Stage, StageDAG, compose_structure,
                  linear_edges)
from .solve import DAGDecision, evaluate_dag, solve_dag, solve_dag_greedy

__all__ = [
    "DAGValidationError",
    "Stage",
    "StageDAG",
    "compose_structure",
    "linear_edges",
    "DAGDecision",
    "evaluate_dag",
    "solve_dag",
    "solve_dag_greedy",
]
