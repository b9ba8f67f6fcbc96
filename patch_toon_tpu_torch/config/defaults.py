"""The composed defaults of ``config/inference.yaml`` and
``config/config.yaml`` as plain dicts.

What ``compose(<repo>/config, "inference")`` gives with no overrides, kept
as Python so that a machine without PyYAML (the GPU machine that runs
``chip_smoke.py``) can build the engine, and what ``compose(<repo>/config,
"config")`` gives (less the timestamped ``run`` directory), so that it can
train. ``tests/test_torch_tiling.py`` and ``tests/test_torch_train.py``
hold them equal to what :func:`compose` gives for the YAML files.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

from patch_toon_tpu_torch.config.compose import ConfigNode, _wrap

INFERENCE: Dict[str, Any] = {
    'model': {
        'generator': {
            'type': 'GeneratorJ',
            'args': {
                'use_bias': True,
                'tanh': True,
                'append_smoothers': True,
                'resnet_blocks': 7,
                'filters': [32, 64, 128, 128, 128, 64],
                'norm_layer': 'instance_norm',
                'input_size': 256,
                'input_channels': 'auto',
            },
        },
        'discriminator': {
            'type': 'DiscriminatorN_IN',
            'args': {
                'num_filters': 12,
                'n_layers': 2,
                'use_noise': False,
                'noise_sigma': 0.2,
                'norm_layer': 'instance_norm',
                'use_bias': True,
                'input_channels': 3,
            },
        },
        'perception_loss': {
            'weight': 6.0,
            'perception_model': {
                'type': 'PerceptualVGG19',
                'args': {
                    'feature_layers': [0, 3, 5],
                    'use_normalization': False,
                    'path': None,
                },
            },
        },
    },
    'training': {
        'output_dir': 'outputs',
        'max_epochs': 50,
        'batch_size': 80,
        'num_workers': 5,
        'reconstruction_weight': 4.0,
        'adversarial_weight': 0.5,
        'use_image_loss': True,
        'reconstruction_criterion': 'L1Loss',
        'adversarial_criterion': 'MSELoss',
        'learning_rate': 0.0004,
        'use_gradient_clipping': True,
        'gradient_clip_val': 0.5,
        'early_stopping': True,
        'early_stopping_patience': 2,
        'accelerator': 'auto',
        'devices': 1,
        'precision': 32,
        'accumulate_grad_batches': 1,
        'deterministic': False,
        'log_every_n_steps': 10,
        'image_log_freq': 100,
        'save_interval': 100,
        'checkpoint_score': 'last_step',
        'guide_dropout_p': 0.0,
        'guide_dropout_depth': 3,
        'two_forward': False,
        'xla_options': 'auto',
    },
    'optimizer': {
        'generator': {
            'lr': 0.0004,
            'betas': [0.9, 0.999],
            'weight_decay': 1e-05,
        },
        'discriminator': {
            'lr': 0.0004,
            'betas': [0.9, 0.999],
            'weight_decay': 1e-05,
        },
    },
    'parallel': {
        'mesh': {
            'data': -1,
            'model': 1,
        },
        'dcn': {
            'enabled': False,
            'slices': -1,
            'coordinator_address': None,
            'num_processes': None,
            'process_id': None,
        },
    },
    'paths': {
        'checkpoint': 'outputs/checkpoints/last.ckpt',
        'input_dir': 'test_dataset/PlatinumChan_x0.5_gen/input',
        'mask_dir': 'test_dataset/PlatinumChan_x0.5_gen/mask',
        'output_dir': 'test_dataset/PlatinumChan_x0.5_gen/output',
        'additional_channels': {
            'point_vector': {
                'path': 'test_dataset/PlatinumChan_x0.5_gen/tracking',
                'depth': 3,
            },
        },
    },
    'inference': {
        'use_gpu': True,
        'devices': 1,
        'file_shard': None,
        'debug_mode': False,
        'mode': 'tiled',
        'overlap_percent': 30.0,
        'precision': 'bf16',
        'quantize': False,
        'xla_options': 'auto',
        'crop_readback': 'auto',
        'crop_upload': 'auto',
        'readback_streams': 6,
        'upload': 'auto',
        'mask_upload': 'packed',
        'temporal': {
            'enabled': False,
            'flow_dir': None,
            'flow_source': 'files',
            'flow_scale': 1,
            'flow_batch': 'auto',
            'depth': 3,
            'file_format': '%03d',
            'flow_upload': 'auto',
        },
        'watch': {
            'enabled': False,
            'poll_seconds': 1.0,
            'idle_timeout_seconds': None,
        },
        'tile_batch': 512,
    },
    'data': {
        'dir_pre': 'test_dataset/PlatinumChan_x0.5_gen/input',
        'dir_mask': 'test_dataset/PlatinumChan_x0.5_gen/mask',
        'dir_post': None,
        'patch_size': 80,
        'additional_channels': {},
        'augmentation_factor': 1,
    },
}


# config/data/default.yaml: the training scene; the other groups of
# config/config.yaml are those of INFERENCE
TRAINING_DATA: Dict[str, Any] = {
    'dir_pre': 'test_dataset/PlatinumChan_x0.5_train/input',
    'dir_post': 'test_dataset/PlatinumChan_x0.5_train/output',
    'dir_mask': 'test_dataset/PlatinumChan_x0.5_train/mask',
    'patch_size': 80,
    'additional_channels': {
        'point_vector': {
            'path': 'test_dataset/PlatinumChan_x0.5_train/tracking',
            'depth': 3,
        },
    },
    'augmentation_factor': 1,
}


def training_config(**sections: Dict[str, Any]) -> ConfigNode:
    """The composed ``config/config.yaml`` (without ``run``) with each given
    section's keys replaced, e.g. ``training_config(training={...})``."""
    cfg = {k: copy.deepcopy(INFERENCE[k])
           for k in ("model", "optimizer", "training", "parallel")}
    cfg["data"] = copy.deepcopy(TRAINING_DATA)
    for name, values in sections.items():
        cfg.setdefault(name, {}).update(copy.deepcopy(values))
    return _wrap(cfg)


def inference_config(**sections: Dict[str, Any]) -> ConfigNode:
    """A fresh copy of :data:`INFERENCE` with each given section's keys
    replaced, e.g. ``inference_config(paths={"checkpoint": p})``."""
    cfg = copy.deepcopy(INFERENCE)
    for name, values in sections.items():
        cfg.setdefault(name, {}).update(copy.deepcopy(values))
    return _wrap(cfg)
