"""End-to-end driver on the PyTorch port: train a reduced qwen3-MoE for a
few hundred steps with the fractal dispatch (K1 and K2 on the card) on the
hot path, checkpointing and journal on.  The twin of ``train_moe.py``.

    PYTHONPATH=src python examples/torch_train_moe.py [--steps 300]
        [--device cpu] [--ckpt-dir DIR]

Without ``--device cpu`` it runs on the card and raises where there is
none.
"""

import argparse
import os
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_moe_ckpt"))
    args = ap.parse_args()
    main(["--arch", "qwen3-moe-30b-a3b", "--smoke",
          "--steps", str(args.steps), "--global-batch", "8",
          "--seq-len", "64", "--ckpt-dir", args.ckpt_dir,
          "--ckpt-every", "50"]
         + (["--device", args.device] if args.device else []))
