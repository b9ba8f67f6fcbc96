"""Command line: stylization of a directory of frames (tiled or full-frame,
alone or with the temporal guide chain, one video or a subdirectory per
video), once or as a watched service.

    python generator_torch.py paths.checkpoint=... paths.input_dir=... \
        paths.mask_dir=... paths.output_dir=... [key=value ...]

The same ``paths.*`` / ``inference.*`` dotlist overrides and config-group
choices (``model=name``) as the JAX package's ``generator.py``, composed
over ``config/inference.yaml`` by the port's own YAML reader
(``config/yamlio.py``), so PyYAML is not needed. With
``inference.watch.enabled`` the CLI serves the input directory until its
idle timeout or an interrupt, and SIGTERM takes Ctrl-C's path, so every
dispatched frame reaches disk (JAX ``generator.py:56-72``).
``inference.use_gpu=false`` runs on the CPU; otherwise a CUDA device is
required.

With ``parallel.dcn.enabled=true`` the process first joins the cluster
(``coordinator_address``, ``num_processes``, ``process_id``, or torchrun's
environment when all three are null; JAX ``generator.py:38-52``) over
gloo: the processes exchange nothing but their rank, and each serves its
share of the frames (``inference.file_shard`` by rank), of the streams, or
of the watched names, on its own devices.
"""

from __future__ import annotations

import logging
import signal
import sys
from pathlib import Path

from patch_toon_tpu_torch.config.compose import compose
from patch_toon_tpu_torch.utils.logging import configure_logging

CONFIG_DIR = Path(__file__).resolve().parents[1] / "config"
logger = logging.getLogger("patch_toon_tpu_torch.cli")


def load_config(argv):
    """The inference config: ``config/inference.yaml`` composed with the
    overrides."""
    return compose(CONFIG_DIR, "inference", overrides=list(argv))


def _sigterm(signum, frame):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    configure_logging(logging.INFO)
    cfg = load_config(argv)
    if bool(cfg["inference"].get("debug_mode", False)):
        configure_logging(logging.DEBUG)
    dcn = (cfg.get("parallel") or {}).get("dcn") or {}
    if bool(dcn.get("enabled", False)):
        from patch_toon_tpu_torch.parallel import initialize_distributed

        initialize_distributed(dcn.get("coordinator_address"),
                               dcn.get("num_processes"),
                               dcn.get("process_id"), backend="gloo")
    from patch_toon_tpu_torch.infer.engine import StyleTransferInference

    engine = StyleTransferInference(cfg)
    if not bool((cfg["inference"].get("watch") or {}).get("enabled", False)):
        n = engine.process_directory()
        print(f"Inference completed: {n} frames written to "
              f"{cfg['paths']['output_dir']}")
        return 0
    # a service: a stop request (SIGTERM from systemd or kubernetes) takes
    # the path of Ctrl-C, which flushes every dispatched frame
    try:
        previous = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:  # not the main thread (embedded use): Ctrl-C only
        previous = None
    try:
        engine.watch_directory()
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    print(f"Watch stopped; outputs in {cfg['paths']['output_dir']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
