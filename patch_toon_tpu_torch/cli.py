"""Command line: stylization of a directory of frames (tiled or full-frame,
alone or with the temporal guide chain).

    python generator_torch.py paths.checkpoint=... paths.input_dir=... \
        paths.mask_dir=... paths.output_dir=... [key=value ...]

The same ``paths.*`` / ``inference.*`` dotlist overrides as the JAX
package's ``generator.py``, composed over ``config/inference.yaml``.
``inference.use_gpu=false`` runs on the CPU; otherwise a CUDA device is
required. Reading the YAML needs PyYAML and reading frames needs Pillow.
"""

from __future__ import annotations

import logging
import sys
from pathlib import Path

from patch_toon_tpu_torch.config.compose import compose

CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    cfg = compose(CONFIG_DIR, "inference", overrides=list(argv))
    from patch_toon_tpu_torch.infer.engine import StyleTransferInference

    n = StyleTransferInference(cfg).process_directory()
    print(f"Inference completed: {n} frames written to "
          f"{cfg.paths.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
