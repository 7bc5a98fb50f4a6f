"""Name-keyed config registry, copied from ``vision_transformers_tpu/utils/args.py``.

The port keeps its own copy (it imports nothing of the JAX package); the
presets must stay identical to the JAX package's, which
``tests/test_torch_port_vit.py`` checks.

Same public surface as the reference's
``get_args`` (utils/args.py:1-79): ``get_args('<model>_<size>[distil]_<dataset>')``
returns a dict of constructor kwargs with ``num_classes`` set from the
dataset suffix.

Defect fixes vs the reference (SURVEY.md §2.9.9): the can't-fail try/except
is gone and unknown model names raise a clear KeyError instead of crashing on
an undefined variable. Preset *values* are kept bit-identical to the
reference (including the vit tiny…huge presets all sharing one config —
changing them would break the recorded accuracy anchors in BASELINE.md).

TPU extension: presets for the benchmark configs (vit_b16, vit_l16 at
224px) and per-dataset entries for imagenet-style inputs.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

_VIT_CIFAR = {
    "image_size": 32, "patch_size": 4, "num_layers": 7, "num_heads": 4,
    "hidden_dim": 256, "mlp_dim": 512, "dropout": 0.1, "attention_dropout": 0.1,
}

_SWIN_BASE = {
    "image_size": 32, "patch_size": [2, 2], "mlp_ratio": 4.0,
    "dropout": 0.0, "attention_dropout": 0.0, "window_size": [4, 4],
}


def _swin(embed_dim, depths, num_heads, sd_prob):
    cfg = dict(_SWIN_BASE)
    cfg.update(
        embed_dim=embed_dim, depths=depths, num_heads=num_heads,
        stochastic_depth_prob=sd_prob,
    )
    return cfg


def _deit(embed_dim, num_heads, distilled):
    return {
        "image_size": 32, "patch_size": 16, "num_layers": 12,
        "num_heads": num_heads, "embed_dim": embed_dim, "mlp_ratio": 4.0,
        "dropout": 0.0, "attention_dropout": 0.0, "num_classes": 100,
        "distilled_training": distilled,
    }


def _vit_224(num_layers, num_heads, hidden_dim, mlp_dim, patch=16):
    return {
        "image_size": 224, "patch_size": patch, "num_layers": num_layers,
        "num_heads": num_heads, "hidden_dim": hidden_dim, "mlp_dim": mlp_dim,
        "dropout": 0.0, "attention_dropout": 0.0,
    }


_REGISTRY: Dict[str, Dict[str, Any]] = {
    # ViT CIFAR presets — identical on purpose, mirroring utils/args.py:6-15.
    "vit_tiny": _VIT_CIFAR,
    "vit_small": _VIT_CIFAR,
    "vit_base": _VIT_CIFAR,
    "vit_large": _VIT_CIFAR,
    "vit_huge": _VIT_CIFAR,
    # Swin presets (utils/args.py:17-41); v2 keys kept for name parity.
    "swin_tiny": _swin(96, [2, 2, 6, 2], [3, 6, 12, 24], 0.2),
    "swin_small": _swin(96, [2, 2, 18, 2], [3, 6, 12, 24], 0.3),
    "swin_base": _swin(128, [2, 2, 18, 2], [4, 8, 16, 32], 0.5),
    "swin_tinv2": _swin(96, [2, 2, 6, 2], [3, 6, 12, 24], 0.2),
    "swin_smallv2": _swin(96, [2, 2, 18, 2], [3, 6, 12, 24], 0.3),
    "swin_basev2": _swin(128, [2, 2, 18, 2], [4, 8, 16, 32], 0.5),
    # DeiT presets (utils/args.py:43-61).
    "deit_tiny": _deit(192, 3, False),
    "deit_small": _deit(384, 6, False),
    "deit_base": _deit(768, 12, False),
    "deit_tinydistil": _deit(192, 3, True),
    "deit_smalldistil": _deit(384, 6, True),
    "deit_basedistil": _deit(768, 12, True),
    # TPU benchmark presets (BASELINE.json): standard
    # ViT-B/16, ViT-L/16, ViT-Ti/16 at 224px.
    "vitb16_224": _vit_224(12, 12, 768, 3072),
    "vitl16_224": _vit_224(24, 16, 1024, 4096),
    "vitti16_224": _vit_224(12, 3, 192, 768),
    # ImageNet-scale Swin presets (torchvision swin_t / swin_v2_t shapes:
    # patch 4, window 7 for V1 / 8 for V2) — hierarchical-model benchmarks.
    "swint_224": {
        "image_size": 224, "patch_size": [4, 4], "embed_dim": 96,
        "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24],
        "window_size": [7, 7], "mlp_ratio": 4.0, "dropout": 0.0,
        "attention_dropout": 0.0, "stochastic_depth_prob": 0.2,
    },
    "swinv2t_224": {
        "image_size": 224, "patch_size": [4, 4], "embed_dim": 96,
        "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24],
        "window_size": [8, 8], "mlp_ratio": 4.0, "dropout": 0.0,
        "attention_dropout": 0.0, "stochastic_depth_prob": 0.2,
    },
    # ImageNet-scale PVT-Tiny / Twins-SVT-S (paper shapes) — hierarchical
    # benchmark configs; field names follow each model's constructor.
    "pvt_tiny224": {
        "image_size": 224, "patch_size": 4,
        "embed_dims": [64, 128, 320, 512], "num_heads": [1, 2, 5, 8],
        "mlp_ratios": [8, 8, 4, 4], "qkv_bias": True,
        "depths": [2, 2, 2, 2], "sr_ratios": [8, 4, 2, 1],
    },
    "twins_svts224": {
        "img_size": 224, "patch_size": 4,
        "embed_dims": [64, 128, 256, 512], "num_heads": [2, 4, 8, 16],
        "mlp_ratios": [4, 4, 4, 4], "qkv_bias": True,
        "depths": [2, 2, 10, 4], "sr_ratios": [8, 4, 2, 1],
        "wss": [7, 7, 7, 7],
    },
}

_DATASET_CLASSES = {
    "cifar100": 100,
    "cifar10": 10,
    "imagenet100": 100,
    "imagenet1000": 1000,
    "imagenet": 1000,
}


def get_args(model_name: str) -> Dict[str, Any]:
    """'swin_tiny_cifar100' → swin_tiny preset with num_classes=100."""
    parts = model_name.split("_")
    model = "_".join(parts[:-1])
    dataset_name = parts[-1].lower()

    if model not in _REGISTRY:
        raise KeyError(
            f"Unknown model name: {model_name} (model key {model!r}; "
            f"known: {sorted(_REGISTRY)})"
        )
    if dataset_name not in _DATASET_CLASSES:
        raise ValueError(f"Unknown dataset name: {dataset_name}")

    final_args = copy.deepcopy(_REGISTRY[model])
    final_args["num_classes"] = _DATASET_CLASSES[dataset_name]
    return final_args
