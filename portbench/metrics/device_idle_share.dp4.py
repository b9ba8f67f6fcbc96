"""``device_idle_share.train`` over the four-card cell, kept apart from the one-card
cell's (its own end-to-end metric, ``train_patches_per_s.dp4``, has its
own bound): the same reader."""

from pathlib import Path

from pbench.harness import load_file_module

read = load_file_module(Path(__file__).with_name("device_idle_share.train.py"),
                        "portbench_metric_device_idle_share_train_shared").read
