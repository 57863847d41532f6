"""Batched serving example on the PyTorch/CUDA port: continuous-batching
decode over a fixed-slot batch on a Mixtral-family (MoE + SWA) model.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

The port's counterpart of ``examples/serve_lm.py``, with its settings;
it runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse

from repro_torch.launch.serve import main as serve_main

SERVE_ARGS = ["--arch", "mixtral-8x7b", "--reduced", "--batch", "4",
              "--requests", "8", "--gen-len", "12", "--max-len", "64"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    return serve_main(SERVE_ARGS + ["--device", args.device])


if __name__ == "__main__":
    main()
