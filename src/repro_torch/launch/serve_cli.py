"""CLI for the elastic serving layer: run a query trace, print metrics.

The port of :mod:`repro.launch.serve_cli`. Launches an
:class:`~repro_torch.serve.ElasticServer` over an exact integer demo matrix
on the card, pushes a seeded synthetic request trace (matvec/matmat mix,
Poisson-ish arrivals) through it — optionally with a mid-trace churn event —
and prints the structured metrics snapshot (p50/p99 latency, goodput,
queue/reject/deadline counters) as JSON. The deterministic synthetic clocks
make two runs with the same arguments print identical numbers, and the same
numbers as the JAX package's CLI.

``--paper`` serves the paper's §V fleet instead of the 4-worker demo fleet
(:mod:`repro_torch.configs.usec_paper`: N = 6, J = 3, speeds 1000 * s rows/s,
``block_rows`` 20, a 6000 x 6000 matrix unless ``--dim`` is given).

Run (on a machine with an NVIDIA GPU; ``--device cpu`` runs the plain
PyTorch versions on the host):
  python -m repro_torch.launch.serve_cli --requests 32 --churn-at 8 \\
      --deadline 2.0
"""

from __future__ import annotations

import argparse
import json

N_WORKERS = 4
BASE_SPEEDS = (1000.0, 1400.0, 1900.0, 2600.0)
BLOCK_ROWS = 16


def fleet(args):
    """(n_workers, base speeds, block_rows, dim) of the served fleet."""
    if not args.paper:
        return (N_WORKERS, BASE_SPEEDS, args.block_rows or BLOCK_ROWS,
                args.dim)
    from repro_torch.configs import usec_paper as paper

    return (paper.N_MACHINES, paper.BASE_SPEEDS,
            args.block_rows or paper.BLOCK_ROWS,
            args.dim if args.dim is not None else paper.MATRIX_DIM)


def mapreduce_rows():
    """The mapreduce lane's workload: each row's sum of squares, folded on
    the host. The fold sums in float64: every per-row value is an exact
    float32 integer on the exact grid, so the answer is the exact float64
    sum at any size (a float32 fold would round past 2^24)."""
    import numpy as np

    from repro_torch.api import MapReduceRows

    return MapReduceRows(
        row_fn=lambda xb, w2: (xb.float() ** 2).sum(1, keepdim=True),
        reduce_fn=lambda mapped: float(mapped.sum(dtype=np.float64)),
        out_cols=1,
        ref_row_fn=lambda x64, _w: np.sum(x64 ** 2, axis=1, keepdims=True),
        name="rows_sumsq",
    )


def build_server(args):
    from repro_torch.api import EngineConfig, Policy
    from repro_torch.runtime.elastic_runner import (
        SyntheticSpeedClock,
        make_exact_matrix,
    )
    from repro_torch.serve import ElasticServer, ServeConfig, SyntheticClock

    n_workers, speeds, block_rows, dim = fleet(args)
    x = make_exact_matrix(dim, args.seed)

    fault_injector = None
    verify_results = "off"
    if args.corruption_rate > 0:
        from repro_torch.faults import ChaosPlan, FaultInjector

        # One step index per potential window: a seeded schedule of
        # silent result corruptions for the linear lane's runner, audited
        # end-to-end by the server — detected windows requeue and retry
        # clean, and the snapshot's integrity counters record the whole
        # story deterministically. The matrix and every operand are on
        # the integer grid, so the audit compares exactly (the float
        # tolerance of verify_results="always" misses the injected shift
        # at the paper's size).
        n_faults = max(1, round(args.corruption_rate * args.requests))
        plan = ChaosPlan.generate(
            max(args.requests, 1), n_workers, n_faults=n_faults,
            kinds=("result_corruption",), seed=args.seed + 13)
        fault_injector = FaultInjector(plan)
        verify_results = "exact"

    server = ElasticServer(
        x,
        Policy(placement="cyclic", replication=3,
               stragglers=args.stragglers),
        EngineConfig(block_rows=block_rows, arrival=args.arrival,
                     fuse_steps=args.fuse_steps, verify=args.verify,
                     segmented=args.segmented, initial_speeds=speeds),
        ServeConfig(batch_cols=args.batch_cols, max_queue=args.max_queue,
                    default_deadline=args.deadline,
                    verify_results=verify_results),
        mapreduce=mapreduce_rows(),
        clock=SyntheticClock(),
        engine_clock=SyntheticSpeedClock(speeds, jitter_sigma=0.0,
                                         seed=args.seed),
        n_machines=n_workers,
        fault_injector=fault_injector,
        device=args.device,
    )
    return server, x


def run_trace(server, args, record=None):
    """Seeded request trace: exponential inter-arrival gaps advance the
    synthetic clock, the server polls between arrivals, churn (one
    preemption, later re-arrival) lands mid-trace. ``record`` (a dict), when
    given, receives ``rid -> (kind, operand)`` for every admitted request."""
    import numpy as np

    rng = np.random.default_rng(args.seed + 7)
    q = server.operand_rows
    responses = []
    for i in range(args.requests):
        if args.churn_at is not None and i == args.churn_at:
            server.feed_event(preempted=(1,))
        if args.churn_at is not None and i == args.churn_at + 4:
            server.feed_event(arrived=(1,))
        kind = ("matmat" if i % 5 == 4 else
                "mapreduce" if args.mapreduce_every and
                i % args.mapreduce_every == 2 else "matvec")
        if kind == "matvec":
            operand = rng.integers(-3, 4, size=q).astype(np.float32)
        elif kind == "matmat":
            c = int(rng.integers(2, max(3, args.batch_cols // 2 + 1)))
            operand = rng.integers(-3, 4, size=(q, c)).astype(np.float32)
        else:
            operand = None
        ticket = server.submit(kind, operand)
        if not ticket.admitted:
            continue
        if record is not None:
            record[ticket.rid] = (kind, operand)
        server.clock.advance(float(rng.exponential(args.mean_gap)))
        responses.extend(server.poll())
    responses.extend(server.drain())
    return responses


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dim", type=int, default=None,
                    help="matrix dim (default: 4 * 96, or 6000 with --paper)")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch-cols", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=32)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline (clock units from enqueue)")
    ap.add_argument("--mean-gap", type=float, default=0.05,
                    help="mean synthetic inter-arrival gap")
    ap.add_argument("--churn-at", type=int, default=None,
                    help="preempt worker 1 before this request index "
                         "(returns 4 requests later)")
    ap.add_argument("--stragglers", type=int, default=1)
    ap.add_argument("--arrival", choices=("barrier", "first"),
                    default="barrier")
    ap.add_argument("--fuse-steps", type=int, default=1)
    ap.add_argument("--verify", choices=("exact", "allclose"), default=None)
    ap.add_argument("--segmented", choices=("auto", "cuda", "ref"),
                    default=None,
                    help="run each window as one usec_segmented launch "
                         "(default: one usec_matvec launch per block)")
    ap.add_argument("--mapreduce-every", type=int, default=0,
                    help="every Nth request is a mapreduce query (0 = none)")
    ap.add_argument("--corruption-rate", type=float, default=0.0,
                    help="fraction of the trace hit by seeded silent "
                         "result corruption (>0 turns the server's "
                         "Freivalds window audit on; detected windows "
                         "requeue and retry clean)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--block-rows", type=int, default=None,
                    help="executor work unit (default: 16, or 20 with "
                         "--paper); must divide the rows of a tile")
    ap.add_argument("--paper", action="store_true",
                    help="serve the paper's Sec. V fleet "
                         "(configs/usec_paper.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain PyTorch versions)")
    args = ap.parse_args(argv)
    if not 0.0 <= args.corruption_rate <= 1.0:
        ap.error(f"--corruption-rate must be in [0, 1], "
                 f"got {args.corruption_rate}")
    if args.dim is None and not args.paper:
        args.dim = N_WORKERS * 96
    return args


def snapshot(server, responses):
    snap = server.metrics_snapshot()
    snap["responses"] = {
        "ok": sum(r.status == "ok" for r in responses),
        "expired": sum(r.status == "expired" for r in responses),
    }
    return snap


def main(argv=None):
    args = parse_args(argv)
    server, _ = build_server(args)
    snap = snapshot(server, run_trace(server, args))
    print(json.dumps(snap, indent=2, sort_keys=True))
    return snap


if __name__ == "__main__":
    main()
