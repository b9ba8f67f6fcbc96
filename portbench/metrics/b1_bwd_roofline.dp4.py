"""``b1_bwd_roofline.train`` over the four-card cell, kept apart from the one-card
cell's (its own end-to-end metric, ``train_patches_per_s.dp4``, has its
own bound): the same reader."""

from pathlib import Path

from pbench.harness import load_file_module

read = load_file_module(Path(__file__).with_name("b1_bwd_roofline.train.py"),
                        "portbench_metric_b1_bwd_roofline_train_shared").read
