"""Global optimization (reference: examples/src/global_optimization.zig):
Himmelblau's function by ``optimize``, then by ask-tell with a batched
objective evaluated on the device, and an assignment problem."""

import torch

from zignal_tpu_torch.examples._common import parse, zignal


def main(argv=None):
    args = parse(argv, __doc__)

    def himmelblau(v):  # four global minima at value 0
        x, y = v
        return (x * x + y - 11) ** 2 + (x + y * y - 7) ** 2

    x, y = zignal.optimize(himmelblau, bounds=[(-5, 5), (-5, 5)],
                           max_evals=400, seed=3)
    print(f"himmelblau minimum near ({x[0]:.3f}, {x[1]:.3f}) value {y:.5f}")

    # ask-tell with a batched objective: 8 candidates a round, evaluated
    # in one call on the device (the analogue of the reference's
    # concurrent evaluation pool, global_search.zig:276-341)
    opt = zignal.GlobalOptimizer([(-5, 5), (-5, 5)], seed=3)
    for _ in range(50):
        cand = torch.tensor(opt.ask(8), dtype=torch.float64,
                            device=args.device)
        opt.tell(cand, himmelblau(cand.T))
    bx, by = opt.best()
    print(f"batched ask-tell minimum near ({bx[0]:.3f}, {bx[1]:.3f}) "
          f"value {by:.5f} after {opt.num_evaluations} evals")
    assert by < 1e-3  # one of the four global minima

    costs = zignal.Matrix([[4.0, 1.0, 3.0], [2.0, 0.0, 5.0], [3.0, 2.0, 2.0]])
    print("assignment:", zignal.solve_assignment_problem(costs))


if __name__ == "__main__":
    main()
