"""Global optimizer: MaxLIPO-style surrogate exploration alternating with
trust-region quadratic exploitation (reference:
src/optimization/global_search.zig, lipschitz.zig, trust_region.zig —
a port of dlib's find_global_* strategy).

The surrogate search is fully vectorized: the Lipschitz upper bound over
all evaluated points is computed for `num_random_samples` candidates at
once. Objectives are plain Python callables (the reference evaluates
objectives in parallel via async groups; batched/vmapped objectives can
exploit the same vectorized candidate set).

Copied from zignal_tpu/optimization/global_search.py; ``tell`` also takes
torch tensors on any device (a batched objective evaluated on the card
returns a CUDA tensor), and ``step`` a 0-d tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .assignment import OptimizationPolicy

__all__ = ["optimize", "GlobalOptimizer", "Step"]


def _host_f64(v) -> np.ndarray:
    """numpy f64 of a number, a sequence, a numpy array or a torch tensor
    on any device (copied to the host)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu").numpy()
    return np.asarray(v, dtype=np.float64)


def _validate_bounds(bounds, is_integer):
    if not bounds:
        raise ValueError("bounds must not be empty")
    lo = []
    hi = []
    for b in bounds:
        if len(b) != 2:
            raise ValueError("each bound must be a (lower, upper) pair")
        low, high = float(b[0]), float(b[1])
        if not low < high:
            raise ValueError("each bound needs lower < upper")
        lo.append(low)
        hi.append(high)
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    if is_integer is not None:
        if len(is_integer) != len(bounds):
            raise ValueError("is_integer length must match bounds")
        for i, flag in enumerate(is_integer):
            if flag and (lo[i] != int(lo[i]) or hi[i] != int(hi[i])):
                raise ValueError("integer variables need integral bounds")
    return lo, hi


def optimize(objective, bounds, max_evals=100, policy=OptimizationPolicy.MIN,
             is_integer=None, seed=None, target=None, patience=None,
             pure_random_probability=0.02, num_random_samples=5000,
             trust_region_eps=0.0, relative_noise_magnitude=0.001,
             solver_eps=1e-4):
    """Find the global optimum of `objective` within box `bounds`
    (reference: global_search.zig:624 findGlobalOptimum).

    Returns (best_x: list[float], best_y: float).
    """
    if not callable(objective):
        raise TypeError("objective must be callable")
    max_evals = int(max_evals)
    if max_evals < 1:
        raise ValueError("max_evals must be positive")
    policy = OptimizationPolicy(policy)
    lo, hi = _validate_bounds(bounds, is_integer)
    dim = len(bounds)
    int_mask = np.array([bool(v) for v in (is_integer or [False] * dim)])
    rng = np.random.default_rng(seed)
    span = hi - lo

    def snap(x):
        x = np.clip(x, lo, hi)
        if int_mask.any():
            x = np.where(int_mask, np.round(x), x)
        return x

    def evaluate(x):
        val = objective([float(v) for v in x])
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            raise TypeError("objective must return a number")
        return float(val)

    maximize = policy == OptimizationPolicy.MAX

    xs = []
    ys = []

    def better(a, b):
        return a > b if maximize else a < b

    def record(x, y):
        xs.append(np.asarray(x, dtype=np.float64))
        ys.append(y)

    # initial sample: center + random
    first = snap((lo + hi) / 2.0)
    record(first, evaluate(first))
    n_init = min(max(2 * dim, 3), max(1, max_evals - 1))
    for _ in range(n_init):
        if len(ys) >= max_evals:
            break
        x = snap(lo + rng.random(dim) * span)
        record(x, evaluate(x))

    stall = 0
    while len(ys) < max_evals:
        best_i = int(np.argmax(ys) if maximize else np.argmin(ys))
        if target is not None and (
            ys[best_i] >= target if maximize else ys[best_i] <= target
        ):
            break
        if patience is not None and stall >= patience:
            break

        explore = (len(ys) % 2 == 0)
        if rng.random() < pure_random_probability:
            cand = snap(lo + rng.random(dim) * span)
        elif explore:
            cand = _surrogate_candidate(np.stack(xs), np.asarray(ys), lo, hi,
                                        span, maximize, rng,
                                        int(num_random_samples), snap)
        else:
            cand = _trust_region_candidate(np.stack(xs), np.asarray(ys),
                                           best_i, lo, hi, maximize, rng,
                                           snap, trust_region_eps)
            if cand is None:
                cand = snap(lo + rng.random(dim) * span)
        y = evaluate(cand)
        prev_best = ys[best_i]
        record(cand, y)
        stall = 0 if better(y, prev_best) else stall + 1

    best_i = int(np.argmax(ys) if maximize else np.argmin(ys))
    return [float(v) for v in xs[best_i]], float(ys[best_i])


@dataclasses.dataclass(frozen=True)
class Step:
    """Result of one ask+evaluate+tell iteration (reference:
    global_search.zig:125 `Step` — point, value, and whether it improved)."""

    x: list
    y: float
    improved: bool
    move: str  # 'init' | 'random' | 'explore' | 'exploit'


class GlobalOptimizer:
    """Incremental ask-tell engine for MaxLIPO+TR global search (reference:
    src/optimization/global_search.zig:155 `GlobalOptimizer` — init/step/
    best/addEvaluation; its pooled `optimize` at :276-341 evaluates several
    outstanding asks concurrently).

    The counterpart of the reference's async evaluation pool:
    `ask(k)` proposes k distinct candidates per round — subsequent picks see
    the earlier ones as pending points with a pessimistic "liar" value so the
    surrogate is lowered near them (the reference's rule at
    global_search.zig:383: outstanding asks lower the surrogate near
    themselves, and at most one trust-region ask is outstanding at a time).
    Evaluate the whole batch with one vectorized objective call (numpy, or
    torch on any device) and feed the results back via `tell`.

    >>> opt = GlobalOptimizer([(-5, 5)] * 2, seed=0)
    >>> for _ in range(20):
    ...     X = opt.ask(8)                       # (8, 2) candidates
    ...     Y = ((np.asarray(X) - 1) ** 2).sum(1)  # vectorized objective
    ...     opt.tell(X, Y)
    >>> x, y = opt.best()
    """

    def __init__(self, bounds, policy=OptimizationPolicy.MIN, is_integer=None,
                 seed=None, pure_random_probability=0.02,
                 num_random_samples=5000, trust_region_eps=0.0):
        self._policy = OptimizationPolicy(policy)
        self._lo, self._hi = _validate_bounds(bounds, is_integer)
        self._dim = len(bounds)
        self._int_mask = np.array(
            [bool(v) for v in (is_integer or [False] * self._dim)])
        self._rng = np.random.default_rng(seed)
        self._span = self._hi - self._lo
        self._num_random_samples = int(num_random_samples)
        self._pure_random_probability = float(pure_random_probability)
        self._trust_region_eps = float(trust_region_eps)
        self._xs: list[np.ndarray] = []
        self._ys: list[float] = []
        self._pending: list[tuple[np.ndarray, bool]] = []  # (x, is_exploit)
        self._asked = 0            # total asks ever issued (drives init phase)
        self._explore_next = True
        self._n_init = max(2 * self._dim, 3) + 1  # center + random seeds

    # -- internals ---------------------------------------------------------

    @property
    def _maximize(self):
        return self._policy == OptimizationPolicy.MAX

    def _snap(self, x):
        x = np.clip(np.asarray(x, dtype=np.float64), self._lo, self._hi)
        if self._int_mask.any():
            x = np.where(self._int_mask, np.round(x), x)
        return x

    def _better(self, a, b):
        return a > b if self._maximize else a < b

    def _augmented(self):
        """Observed points plus pending asks carrying a pessimistic value, so
        batched asks spread out instead of re-picking the same region."""
        X = np.stack(self._xs)
        Y = np.asarray(self._ys, dtype=np.float64)
        if self._pending:
            liar = float(Y.min() if self._maximize else Y.max())
            X = np.concatenate([X, np.stack([p for p, _ in self._pending])])
            Y = np.concatenate([Y, np.full(len(self._pending), liar)])
        return X, Y

    def _propose_one(self):
        """One candidate + its move label, honoring the init schedule, the
        pure-random floor, and the explore/exploit alternation."""
        if self._asked < self._n_init:
            if self._asked == 0:
                return self._snap((self._lo + self._hi) / 2.0), "init"
            return (self._snap(self._lo + self._rng.random(self._dim)
                               * self._span), "init")
        if not self._xs or self._rng.random() < self._pure_random_probability:
            return (self._snap(self._lo + self._rng.random(self._dim)
                               * self._span), "random")
        X, Y = self._augmented()
        explore = self._explore_next
        self._explore_next = not self._explore_next
        exploit_outstanding = any(flag for _, flag in self._pending)
        if not explore and not exploit_outstanding:
            best_i = int(np.argmax(self._ys) if self._maximize
                         else np.argmin(self._ys))
            cand = _trust_region_candidate(
                np.stack(self._xs), np.asarray(self._ys), best_i, self._lo,
                self._hi, self._maximize, self._rng, self._snap,
                self._trust_region_eps)
            if cand is not None:
                return cand, "exploit"
        cand = _surrogate_candidate(X, Y, self._lo, self._hi, self._span,
                                    self._maximize, self._rng,
                                    self._num_random_samples, self._snap)
        return cand, "explore"

    # -- public API --------------------------------------------------------

    def ask(self, k=1):
        """Propose k candidate points to evaluate. Returns a list of k
        float lists; evaluate them (in any order, e.g. one vectorized call)
        and report results with `tell`."""
        k = int(k)
        if k < 1:
            raise ValueError("k must be positive")
        out = []
        for _ in range(k):
            cand, move = self._propose_one()
            self._asked += 1
            self._pending.append((np.asarray(cand, dtype=np.float64),
                                  move == "exploit"))
            out.append([float(v) for v in cand])
        return out

    def _ask_one_with_move(self):
        cand, move = self._propose_one()
        self._asked += 1
        self._pending.append((np.asarray(cand, dtype=np.float64),
                              move == "exploit"))
        return [float(v) for v in cand], move

    def tell(self, x, y):
        """Report objective value(s). Accepts one point (`x` a length-dim
        sequence, `y` a number) or a batch (`x` a (k, dim) array / list of
        points, `y` length-k); either may be a torch tensor on any device.
        Points need not come from `ask` — unasked
        points are accepted as warm starts (reference addEvaluation,
        global_search.zig:250)."""
        X = _host_f64(x)
        if X.ndim == 1:
            X = X[None, :]
            Y = [y]
        else:
            Y = _host_f64(y).ravel()
            if len(Y) != len(X):
                raise ValueError("tell: x and y lengths differ")
        if X.shape[1] != self._dim:
            raise ValueError("tell: point dimension mismatch")
        for xi, yi in zip(X, Y):
            yi = float(yi)
            if not np.isfinite(yi):
                raise ValueError("objective value must be finite")
            self._xs.append(self._snap(xi))
            self._ys.append(yi)
            # retire the matching pending ask, if any
            for j, (p, _) in enumerate(self._pending):
                if np.array_equal(p, self._xs[-1]):
                    self._pending.pop(j)
                    break

    def add_evaluation(self, x, y):
        """Warm-start with an already-evaluated point (reference:
        global_search.zig:250 addEvaluation)."""
        self.tell(x, y)

    def step(self, objective):
        """One ask+evaluate+tell transaction (reference:
        global_search.zig:257 step). Returns a `Step`."""
        if not callable(objective):
            raise TypeError("objective must be callable")
        prev_best = None
        if self._ys:
            prev_best = (max(self._ys) if self._maximize else min(self._ys))
        x, move = self._ask_one_with_move()
        val = objective(list(x))
        # accept any real scalar (incl. np.float32 / 0-d tensors) but
        # reject bools and non-numerics
        if isinstance(val, bool):
            raise TypeError("objective must return a number")
        try:
            y = float(val)
        except (TypeError, ValueError):
            raise TypeError("objective must return a number") from None
        self.tell(x, y)
        improved = prev_best is None or self._better(y, prev_best)
        return Step(x=x, y=y, improved=improved, move=move)

    def best(self):
        """Current best (x, y); raises if nothing has been told yet
        (reference: global_search.zig:244 best)."""
        if not self._ys:
            raise ValueError("no evaluations yet")
        best_i = int(np.argmax(self._ys) if self._maximize
                     else np.argmin(self._ys))
        return [float(v) for v in self._xs[best_i]], float(self._ys[best_i])

    @property
    def num_evaluations(self):
        return len(self._ys)


def _surrogate_candidate(X, Y, lo, hi, span, maximize, rng, n_samples, snap):
    """MaxLIPO step: pick the candidate with the best Lipschitz bound
    (reference: lipschitz.zig upper-bound surrogate)."""
    n_samples = max(64, n_samples)
    cand = lo + rng.random((n_samples, len(lo))) * span
    # Lipschitz constant estimate from observed pairwise slopes
    scale = np.maximum(span, 1e-12)
    Xn = X / scale
    d2 = ((Xn[:, None, :] - Xn[None, :, :]) ** 2).sum(-1)
    dy = np.abs(Y[:, None] - Y[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = dy / np.sqrt(np.maximum(d2, 1e-18))
    np.fill_diagonal(slopes, 0.0)
    k = float(np.nanmax(slopes)) * 1.1 + 1e-9

    Cn = cand / scale
    dist = np.sqrt(((Cn[:, None, :] - Xn[None, :, :]) ** 2).sum(-1))
    if maximize:
        bound = (Y[None, :] + k * dist).min(axis=1)
        idx = int(np.argmax(bound))
    else:
        bound = (Y[None, :] - k * dist).max(axis=1)
        idx = int(np.argmin(bound))
    return snap(cand[idx])


def _trust_region_candidate(X, Y, best_i, lo, hi, maximize, rng, snap, tr_eps):
    """Quadratic-model step around the incumbent (reference:
    trust_region.zig Nocedal-Wright subproblem via least-squares fit)."""
    dim = X.shape[1]
    n_needed = (dim + 1) * (dim + 2) // 2
    if len(Y) < n_needed:
        return None
    best = X[best_i]
    # fit on the nearest points
    d = ((X - best) ** 2).sum(-1)
    order = np.argsort(d)[: max(n_needed + 2, 2 * dim + 3)]
    P = X[order] - best
    t = Y[order]
    cols = [np.ones(len(P))]
    for i in range(dim):
        cols.append(P[:, i])
    for i in range(dim):
        for j in range(i, dim):
            cols.append(P[:, i] * P[:, j])
    A = np.stack(cols, axis=1)
    coef, *_ = np.linalg.lstsq(A, t, rcond=None)
    g = coef[1:1 + dim]
    H = np.zeros((dim, dim))
    k = 1 + dim
    for i in range(dim):
        for j in range(i, dim):
            H[i, j] += coef[k] / (1 if i == j else 2)
            H[j, i] = H[i, j]
            k += 1
    H = H + H.T
    # solve model stationary point; fall back to a gradient step
    radius = max(np.sqrt(d[order[-1]]), 1e-6)
    try:
        step = np.linalg.solve(H + 1e-9 * np.eye(dim), -g)
    except np.linalg.LinAlgError:
        step = -g
    # check curvature direction for min/max
    model_second = float(step @ H @ step)
    wrong_curvature = (model_second < 0) if not maximize else (model_second > 0)
    if wrong_curvature or not np.all(np.isfinite(step)):
        step = (g if maximize else -g)
        norm = np.linalg.norm(step)
        if norm > 0:
            step = step / norm * radius * 0.5
    nstep = np.linalg.norm(step)
    if nstep > radius:
        step = step / nstep * radius
    cand = snap(best + step)
    if np.linalg.norm(cand - best) <= max(tr_eps, 1e-12):
        cand = snap(best + rng.normal(0, radius * 0.1, dim))
    return cand
