#!/usr/bin/env python
"""GAN training with the PyTorch/CUDA port.

Usage:
    python train_torch.py [key=value ...]
e.g.
    python train_torch.py training.batch_size=40 data.patch_size=64
    python train_torch.py training.accelerator=cpu training.max_steps=2

Same overrides as ``train.py``; see ``patch_toon_tpu_torch/train_cli.py``.
"""

import sys

from patch_toon_tpu_torch.train_cli import main

if __name__ == "__main__":
    sys.exit(main())
