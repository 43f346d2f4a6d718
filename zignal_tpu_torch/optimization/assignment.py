"""Hungarian (Kuhn-Munkres) assignment solver
(reference: src/optimization/assignment.zig).

Potential-based O(n^3) formulation; rectangular matrices are handled by
padding, min/max policies by negation.

Copied from zignal_tpu/optimization/assignment.py (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import enum

import numpy as np

__all__ = ["OptimizationPolicy", "Assignment", "solve_assignment_problem"]


class OptimizationPolicy(enum.IntEnum):
    MIN = 0
    MAX = 1


class Assignment:
    """Result: per-row column assignment (None = unassigned) + total cost."""

    __slots__ = ("assignments", "total_cost")

    def __init__(self, assignments, total_cost):
        self.assignments = assignments
        self.total_cost = float(total_cost)

    def __repr__(self):
        return (f"Assignment(assignments={self.assignments}, "
                f"total_cost={self.total_cost})")


def _hungarian_square(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost perfect matching of a square matrix -> col per row.
    Potential-based shortest augmenting path formulation."""
    n = cost.shape[0]
    INF = float("inf")
    u = np.zeros(n + 1)
    v = np.zeros(n + 1)
    p = np.zeros(n + 1, dtype=int)      # p[j] = row matched to column j
    way = np.zeros(n + 1, dtype=int)
    for i in range(1, n + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n + 1, INF)
        used = np.zeros(n + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            delta = INF
            j1 = 0
            for j in range(1, n + 1):
                if used[j]:
                    continue
                cur = cost[i0 - 1, j - 1] - u[i0] - v[j]
                if cur < minv[j]:
                    minv[j] = cur
                    way[j] = j0
                if minv[j] < delta:
                    delta = minv[j]
                    j1 = j
            for j in range(n + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    row_to_col = np.full(n, -1, dtype=int)
    for j in range(1, n + 1):
        if p[j] > 0:
            row_to_col[p[j] - 1] = j - 1
    return row_to_col


def solve_assignment_problem(costs, policy=OptimizationPolicy.MIN) -> Assignment:
    """Optimal row->column assignment of a zignal Matrix
    (reference: assignment.zig:31)."""
    from ..matrix import Matrix

    if not isinstance(costs, Matrix):
        raise TypeError("solve_assignment_problem expects a zignal Matrix")
    if isinstance(policy, str):
        raise TypeError("policy must be an OptimizationPolicy")
    policy = OptimizationPolicy(policy)

    c = costs.to_numpy().astype(np.float64)
    rows, cols = c.shape
    work = -c if policy == OptimizationPolicy.MAX else c.copy()
    n = max(rows, cols)
    pad_value = work.max() + 1 if work.size else 0
    padded = np.full((n, n), pad_value, dtype=np.float64)
    padded[:rows, :cols] = work
    row_to_col = _hungarian_square(padded)

    assignments = []
    total = 0.0
    for r in range(rows):
        col = int(row_to_col[r])
        if col >= cols:
            assignments.append(None)
        else:
            assignments.append(col)
            total += float(c[r, col])
    return Assignment(assignments, total)
