"""Batched serving with prefill + decode on a sub-quadratic arch (the
PyTorch port's twin of ``examples/straggler_serving.py``).

Serves a reduced mamba2-370m (constant-state decode: the family for which
the 500k-context cell runs) with sampled decoding, through the
prefill -> cache-restage -> decode-loop path the dry-run traces at scale
(``repro_torch.launch.serve``).

Run:  PYTHONPATH=src python examples_torch/straggler_serving.py [--device cpu]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.launch import serve

    return serve.main([
        "--arch", "mamba2-370m", "--reduced",
        "--batch", "8", "--prompt-len", "48", "--gen-len", "24",
        "--temperature", "0.8",
    ] + ([] if args.device is None else ["--device", args.device]))


if __name__ == "__main__":
    main()
