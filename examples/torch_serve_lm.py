"""Serving example on the PyTorch port: batched decode with the
fractal-sort request scheduler.

    PYTHONPATH=src python examples/torch_serve_lm.py            # on the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""

import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(["--arch", "llama3.2-1b", "--smoke", "--num-requests", "10",
          "--batch-slots", "4", *sys.argv[1:]])
