#!/usr/bin/env python
"""Video stylization with the PyTorch/CUDA port (tiled, full-frame, temporal).

Usage:
    python generator_torch.py paths.checkpoint=run/torch_train.ckpt \
        paths.input_dir=video/input paths.mask_dir=video/mask \
        paths.output_dir=video/stylized [inference.precision=32]

Same overrides as ``generator.py``; see ``patch_toon_tpu_torch/cli.py``.
"""

import sys

from patch_toon_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
