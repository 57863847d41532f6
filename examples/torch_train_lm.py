"""End-to-end training example on the PyTorch/CUDA port: train a
TinyLlama-family model for a few hundred steps with checkpointing.

    PYTHONPATH=src python examples/torch_train_lm.py [--full] [--device cpu]

The port's counterpart of ``examples/train_lm.py``, with its flags and
settings; it runs on the CUDA card unless ``--device cpu`` is given.
``--full`` trains the ~100M-param variant (d=768, 12 layers, vocab kept)
instead of the reduced config. Checkpoints go under the temporary
directory, and a second run resumes from the last one.
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params (d=768, 12L) instead of the smoke "
                         "config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a card)")
    args = ap.parse_args(argv)
    tmp = tempfile.gettempdir()

    if args.full:
        # ~100M: the full config scaled down to 12 x 768 (vocab kept),
        # trained through --reduced: launch.train builds its config from
        # get_config, which reads the module's reduced_config when called
        import repro_torch.configs.tinyllama_1_1b as t
        cfg = t.config().scaled(name="tinyllama-100m", n_layers=12,
                                d_model=768, n_heads=12, n_kv_heads=4,
                                d_ff=2048)
        reduced = t.reduced_config
        t.reduced_config = lambda: cfg
        try:
            return train_main([
                "--arch", "tinyllama-1.1b", "--reduced",
                "--steps", str(args.steps), "--batch", "8", "--seq", "512",
                "--microbatches", "2",
                "--ckpt-dir", os.path.join(tmp, "repro_torch_ckpt_100m"),
                "--device", args.device])
        finally:
            t.reduced_config = reduced
    return train_main([
        "--arch", "tinyllama-1.1b", "--reduced", "--steps", str(args.steps),
        "--batch", "16", "--seq", "128",
        "--ckpt-dir", os.path.join(tmp, "repro_torch_ckpt_smoke"),
        "--device", args.device])


if __name__ == "__main__":
    main()
