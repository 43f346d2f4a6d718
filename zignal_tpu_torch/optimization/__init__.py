"""Optimization: global MaxLIPO+TR search and the Hungarian assignment
solver (reference: src/optimization/).

Copied from zignal_tpu/optimization/__init__.py.
"""

from .assignment import Assignment, OptimizationPolicy, solve_assignment_problem
from .global_search import GlobalOptimizer, Step, optimize

__all__ = ["OptimizationPolicy", "Assignment", "solve_assignment_problem",
           "optimize", "GlobalOptimizer", "Step"]
