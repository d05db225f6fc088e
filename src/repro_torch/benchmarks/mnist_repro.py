"""Paper §3 / Fig. 3 reproduction: non-parallel vs parallel dropout on
MNIST, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.mnist_repro [--quick]

The port of ``benchmarks/mnist_repro.py``.  Paper numbers (real MNIST, 10k
iterations): non-parallel 0.9535, parallel (20 workers x batch 5,
AllReduce, the same global batch 100) 0.9713: parallel *trains better*.
The comparison runs at equal hyperparameters, the JAX benchmark's: eta
0.005 and mu 0.98 for both arms (the paper's eta 0.3 diverges with this
init and the synthetic fallback data: with momentum 0.98 its effective
step is 0.3 / (1 - 0.98) = 15).  Both arms run on ``device`` (the card by
default).  The first two rows' second column is each arm's own host wall
per step in microseconds.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.collective_trainer import paper_comparison


def run(num_steps: int = 2000, eval_every: int = 500, quick: bool = False,
        device="cuda"):
    if quick:
        num_steps, eval_every = 600, 300
    res = paper_comparison(num_steps=num_steps, eval_every=eval_every,
                           lr=0.005, momentum=0.98, n_train=10000,
                           device=device)
    npar, par = res["non_parallel"], res["parallel"]
    np_acc, p_acc = npar.final_accuracy, par.final_accuracy
    rows = [
        ("mnist_nonparallel_dropout", npar.wall_s * 1e6 / num_steps,
         f"acc={np_acc:.4f}"),
        ("mnist_parallel_dropout_20x5", par.wall_s * 1e6 / num_steps,
         f"acc={p_acc:.4f}"),
        ("mnist_parallel_minus_nonparallel", 0.0,
         f"delta={p_acc - np_acc:+.4f} (paper: +0.0178)"),
    ]
    detail = {k: v.row() for k, v in res.items()}
    return rows, detail


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.mnist_repro")
    ap.add_argument("--quick", action="store_true",
                    help="600 steps, evaluated every 300")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows, detail = run(quick=args.quick, device=args.device)
    for r in rows:
        print(",".join(str(x) for x in r))
    print(json.dumps(detail, indent=1))


if __name__ == "__main__":
    main()
