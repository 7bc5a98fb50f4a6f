"""Training CLI / experiment runner.

Counterpart of ``vision_transformers_tpu/cli.py``: an argparse CLI over the
args registry, ``run_reference_main`` (the reference's per-model
``__main__`` recipe: loaders → args → model → train_model) and
``run_detection_main`` (DETR on a COCO folder).

    python -m vision_transformers_tpu_torch.cli vit_tiny_cifar100 \\
        --epochs 100 --batch-size 256 --data-root ./data [--device cpu]

Everything runs on the CUDA device unless ``--device`` (``device=``) names
another; the CPU runs the kernels' plain versions. ``--init-from-torch``
starts from a reference torch checkpoint (``utils/port_torch.py``);
``--export-int8`` quantizes the trained model to w8a8 before the export
(``serving.quantize_classifier``).
"""

from __future__ import annotations

import argparse
from typing import Optional

from vision_transformers_tpu_torch.core.dtypes import DeviceLike
from vision_transformers_tpu_torch.utils.port_torch import parse_model_key


def _model_for(name: str):
    """Map an args-registry key like 'swin_tiny_cifar100' to a model class."""
    from vision_transformers_tpu_torch.models import image_classification as ic

    family, swin_v2 = parse_model_key(name)
    if swin_v2:
        # preset names with no model behind them in the reference: the
        # real SwinV2
        return ic.SwinTransformerV2
    table = {
        "vit": ic.ViT, "vitb16": ic.ViT, "vitl16": ic.ViT, "vitti16": ic.ViT,
        "swin": ic.SwinTransformer, "deit": ic.DeiT, "cpevit": ic.CPEViT,
        "cpvt": ic.CPVT, "cpvtgap": ic.CPVTGAP, "pvt": ic.PVT,
        "t2t": ic.T2T_ViT, "tnt": ic.TNT, "twins": ic.TwinSVT,
    }
    if family not in table:
        raise SystemExit(f"unknown model family {family!r} in {name!r}")
    return table[family]


def run_reference_main(model_name: str, epochs: int = 100,
                       batch_size: int = 256, val_split: float = 0.2,
                       num_workers: int = 4, data_root: str = "./data",
                       lr: float = 1e-4, on_device: bool = False,
                       bf16: bool = False,
                       init_from_torch: Optional[str] = None,
                       export_dir: Optional[str] = None,
                       export_buckets=(1, 8, 32),
                       export_int8: bool = False,
                       device: DeviceLike = None, **fit_kwargs):
    """The reference's per-model __main__ recipe (vanilla_vit.py:311-324):
    loaders → args → model → train_model, on ``device`` (CUDA by default).
    ``on_device=True`` (CIFAR only) keeps the dataset on the device
    (``training.device_data``). ``init_from_torch``: a reference torch
    checkpoint (``.pt`` or ``.npz``) loaded into the model before training
    (``utils.port_torch.load_torch_checkpoint``); the trainer then builds the
    optimizer with the same kwargs as a fresh run. ``export_dir``: a serving
    artifact of the trained model (``serving.export_classifier``), int8
    with ``export_int8`` (``serving.quantize_classifier``)."""
    import torch

    from vision_transformers_tpu_torch.utils.args import (
        _DATASET_CLASSES,
        get_args,
    )
    from vision_transformers_tpu_torch.utils.load_data import (
        get_train_test_loaders,
    )

    dataset = model_name.split("_")[-1]
    train_loader, val_loader, test_loader = get_train_test_loaders(
        dataset_name=dataset, batch_size=batch_size,
        val_split=val_split, num_workers=num_workers, root_dir=data_root,
    )
    family = model_name.split("_")[0].lower()
    try:
        args = get_args(model_name)
    except KeyError:
        if family in ("cpevit", "cpvt", "cpvtgap", "t2t"):
            # these reuse the ViT-tiny preset in the reference __main__s
            args = get_args(f"vit_tiny_{dataset}")
        else:
            # PVT/TNT/Twins use constructor defaults in the reference
            args = {"num_classes": _DATASET_CLASSES[dataset.lower()]}
    cls = _model_for(model_name)
    if bf16:
        args["dtype"] = torch.bfloat16
    if args.pop("distilled_training", False):
        raise SystemExit(
            "distilled DeiT training needs an injected teacher — use "
            "DeiT.train_model_with_distillation(...) directly")
    model = cls(**args, device=device)
    print(model)
    if init_from_torch:
        # continue from a torch reference checkpoint: the weights go into
        # the model, and fit / fit_on_device build the optimizer from the
        # same kwargs as a fresh run
        from vision_transformers_tpu_torch.utils.port_torch import (
            load_torch_checkpoint,
        )

        model.load_state_dict(
            load_torch_checkpoint(init_from_torch, model_name, args))
    if on_device and dataset.lower().startswith("cifar"):
        import numpy as np

        from vision_transformers_tpu_torch.training.device_data import (
            fit_on_device,
        )
        from vision_transformers_tpu_torch.utils.load_data import (
            _STATS,
            _load_cifar,
        )

        train = _load_cifar(data_root, dataset.lower(), train=True)
        test = _load_cifar(data_root, dataset.lower(), train=False)
        val = None
        if val_split:
            n = len(train[1])
            n_val = int(n * val_split)
            perm = np.random.RandomState(0).permutation(n)
            val = (train[0][perm[:n_val]], train[1][perm[:n_val]])
            train = (train[0][perm[n_val:]], train[1][perm[n_val:]])
        metrics = fit_on_device(
            model, train, test, epochs, val_data=val,
            batch_size=batch_size, normalize=_STATS[dataset.lower()],
            lr=lr, **fit_kwargs,
        )
    else:
        metrics = model.train_model(
            model, train_loader, test_loader, epochs, val_loader,
            lr=lr, **fit_kwargs,
        )
    if export_dir:
        from vision_transformers_tpu_torch import serving

        export_model = (serving.quantize_classifier(model) if export_int8
                        else model)
        img = args.get("image_size") or 32
        serving.export_classifier(export_model, (img, img, 3), export_dir,
                                  buckets=export_buckets)
        print(f"exported serving artifact to {export_dir}")
    return metrics


def run_detection_main(coco_path: str, epochs: int = 300,
                       batch_size: int = 8, num_classes: int = 91,
                       masks: bool = False,
                       init_from_torch: Optional[str] = None,
                       device: DeviceLike = None, **kwargs):
    """DETR-on-COCO entry point: ``coco_path`` holds ``train2017/``,
    ``val2017/`` and ``annotations/instances_{train,val}2017.json``; trains
    ``Detr(num_classes, aux_loss=True)`` on ``device`` (CUDA by default)
    through ``fit_detection``. ``init_from_torch``: a facebook-DETR
    (detr-r50) checkpoint to start from
    (``utils.port_torch.port_detr_state_dict``)."""
    from vision_transformers_tpu_torch.models.object_detection import Detr
    from vision_transformers_tpu_torch.training.detection import (
        DetectionLoader,
        fit_detection,
    )
    from vision_transformers_tpu_torch.utils.coco.build_coco import build

    train_ds = build("train", coco_path, return_masks=masks)
    val_ds = build("val", coco_path, return_masks=masks)
    train = DetectionLoader(train_ds, batch_size, shuffle=True)
    val = DetectionLoader(val_ds, batch_size)
    model = Detr(num_classes=num_classes, aux_loss=True, device=device)
    if init_from_torch:
        import torch

        from vision_transformers_tpu_torch.utils.port_torch import (
            port_detr_state_dict,
        )

        sd = torch.load(init_from_torch, map_location="cpu",
                        weights_only=True)
        kwargs["init_params"] = port_detr_state_dict(sd)
    return fit_detection(model, train, epochs, val_loader=val,
                         num_classes=num_classes, **kwargs)


def main(argv: Optional[list] = None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model", help="args-registry key, e.g. vit_tiny_cifar100")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--data-root", default="./data")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "adamw", "sgd", "rmsprop"])
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--on-device", action="store_true",
                   help="device-resident dataset + on-device augmentation "
                        "(CIFAR)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (fp32 master weights)")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="batches per call of the step function "
                        "(host-loader path)")
    p.add_argument("--init-from-torch", default=None, metavar="CKPT",
                   help="torch reference state_dict (.pt/.npz) to port and "
                        "continue training from (utils/port_torch.py)")
    p.add_argument("--export", default=None, metavar="DIR",
                   help="after training, export a serving artifact "
                        "(serving.export_classifier) to DIR")
    p.add_argument("--export-buckets", default="1,8,32",
                   help="serving batch buckets, csv (with --export)")
    p.add_argument("--export-int8", action="store_true",
                   help="post-training int8 w8a8 quantization before export")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    a = p.parse_args(argv)
    extra = {"bf16": a.bf16, "init_from_torch": a.init_from_torch,
             "device": a.device, "export_int8": a.export_int8}
    if a.export:
        extra.update(
            export_dir=a.export,
            export_buckets=tuple(
                int(b) for b in a.export_buckets.split(",")),
        )
    if a.on_device:
        extra["on_device"] = True
    else:
        extra.update(
            optimizer=a.optimizer, checkpoint_dir=a.checkpoint_dir,
            checkpoint_every=a.checkpoint_every,
            steps_per_call=a.steps_per_call,
        )
    return run_reference_main(
        a.model, epochs=a.epochs, batch_size=a.batch_size,
        val_split=a.val_split, num_workers=a.num_workers,
        data_root=a.data_root, lr=a.lr, seed=a.seed, **extra,
    )


if __name__ == "__main__":
    main()
