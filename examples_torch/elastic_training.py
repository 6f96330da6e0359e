"""End-to-end elastic training of a ~100M-parameter LM under USEC (the
PyTorch port's twin of ``examples/elastic_training.py``).

Four data-parallel workers on one device (``repro_torch.launch.train``; run
it under ``python -m torch.distributed.run`` for one process a rank),
cyclic 2-fold tile replication, S=1 straggler tolerance with one dropped
worker per step, 5% per-step preemption churn, EWMA speed adaptation, and
periodic checkpoints: the whole Algorithm-1 loop end to end.

Run:  PYTHONPATH=src python examples_torch/elastic_training.py [--steps 200]
      [--device cpu] [--ckpt-dir DIR]
(``--layers``, ``--d-model`` and ``--seq-len`` shrink the model and its
sequences for a quick host run.)
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default="checkpoints/usec_demo")
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the CUDA card)")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    args = ap.parse_args(argv)

    from repro_torch import configs
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch import train

    # ~100M params: 2*32k*512 embeddings + 8 layers of d=512/ff=2048.
    d = args.d_model
    cfg_100m = ArchConfig(
        name="usec-demo-100m", family="dense", n_layers=args.layers,
        d_model=d, n_heads=8, n_kv_heads=4, head_dim=d // 8, d_ff=4 * d,
        vocab_size=32768, attn_chunk=512, loss_chunk=256,
    )
    real = configs.get_config
    configs.get_config = (lambda n: cfg_100m if n == "usec-demo-100m"
                          else real(n))
    try:
        return train.main([
            "--arch", "usec-demo-100m",
            "--workers", "4",
            "--steps", str(args.steps),
            "--seq-len", str(args.seq_len),
            "--tile-samples", "2",
            "--straggler-tolerance", "1",
            "--drop-stragglers", "1",
            "--churn", "0.05",
            "--lr", "1e-3",
            "--ckpt-dir", args.ckpt_dir,
            "--ckpt-every", "50",
            "--log-every", "10",
        ] + ([] if args.device is None else ["--device", args.device]))
    finally:
        configs.get_config = real


if __name__ == "__main__":
    main()
