"""Patches a second of the four-card cell, read as ``train_patches_per_s``
reads them: an end-to-end metric of its own, so that its wider bound
(four spawned ranks on one host spread more) leaves the one-card cell's
alone."""

from pathlib import Path

from pbench.harness import load_file_module

read = load_file_module(Path(__file__).with_name("train_patches_per_s.py"),
                        "portbench_metric_train_patches_per_s_shared").read
