"""The port's training CLI end to end on the CPU (``--device cpu``, the
kernels' plain versions) on a tiny synthetic CIFAR-100 in the real pickle
format: the host-loader path with checkpoints and an export, the on-device
path, TNT and CPVT; the family table against the JAX CLI's; and
``--init-from-torch`` and ``--export-int8``. (``run_detection_main`` resizes
COCO images to 480-800 pixels: it trains on the card, in ``chip_smoke.py``;
here its ``init_from_torch`` wiring only.)
"""

import numpy as np
import pytest
import torch

from tests.test_torch_port_data import write_cifar
from vision_transformers_tpu import cli as jcli
from vision_transformers_tpu.utils import port_torch as jport
from vision_transformers_tpu_torch import cli, serving
from vision_transformers_tpu_torch.utils import checkpoint as tck


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_cifar(str(root), "cifar100", 80, 20)
    return str(root)


def _run(cifar, model, *extra):
    return cli.main([model, "--epochs", "2", "--batch-size", "16",
                     "--data-root", cifar, "--lr", "1e-3", "--device", "cpu",
                     *extra])


def test_cli_trains_checkpoints_and_exports(cifar, tmp_path):
    ckpt, art = str(tmp_path / "ckpt"), str(tmp_path / "art")
    hist = _run(cifar, "vit_tiny_cifar100", "--checkpoint-dir", ckpt,
                "--checkpoint-every", "1", "--export", art,
                "--export-buckets", "1,4")
    assert set(hist) >= {"train_loss", "val_loss", "test_loss",
                         "train_accuracy", "val_accuracy", "test_accuracy"}
    assert len(hist["train_loss"]) == 2
    assert all(np.isfinite(v) for v in hist["train_loss"])
    state = hist["final_state"]
    assert tck.available_checkpoints(ckpt) == [1, 2]
    model = state.model
    target = type(state)(model=type(model)(**model.config, device="cpu",
                                           seed=9),
                         optimizer=type(state.optimizer)(
                             "adam", 1e-3, weight_decay=0.0, momentum=None,
                             grad_clip_norm=None, accumulate_steps=1))
    target.optimizer.init(target.model.parameters())
    tck.restore_checkpoint(ckpt, target)
    assert target.step == state.step
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              target.model.state_dict().items()):
        assert torch.equal(a, b), k
    clf = serving.load_classifier(art, device="cpu")
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x))
    torch.testing.assert_close(clf.predict(x), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("model", ["tnt_cifar100", "cpvtgap_cifar100"])
def test_cli_trains_the_new_families(cifar, model):
    hist = _run(cifar, model, "--epochs", "1")
    assert type(hist["final_state"].model).__name__ == \
        cli._model_for(model).__name__
    assert np.isfinite(hist["train_loss"][0])


def test_cli_on_device_path(cifar):
    hist = _run(cifar, "cpvt_cifar100", "--on-device")
    # 64 train images after the 0.2 split: 4 steps of 16 an epoch
    assert hist["final_state"].step == 8
    assert all(np.isfinite(v) for v in hist["test_loss"])


def test_model_table_matches_the_jax_cli():
    keys = ["vit_tiny_cifar100", "vitb16_224_imagenet", "swin_tiny_cifar100",
            "swin_tinv2_cifar100", "deit_tiny_cifar100", "cpevit_cifar100",
            "cpvt_cifar100", "cpvtgap_cifar100", "pvt_cifar100",
            "t2t_cifar100", "tnt_cifar100", "twins_cifar100"]
    for key in keys:
        assert cli.parse_model_key(key) == jport.parse_model_key(key)
        assert cli._model_for(key).__name__ == jcli._model_for(key).__name__
    with pytest.raises(SystemExit, match="unknown model family"):
        cli._model_for("resnet_cifar100")


def test_unported_options_raise(cifar, tmp_path, monkeypatch):
    """The options once refused as not ported, end to end on the CPU:
    ``--init-from-torch`` starts training from a reference-layout torch
    checkpoint (the first forward sees exactly the ported weights),
    ``--export-int8`` exports the trained model's w8a8 serving model, and
    ``run_detection_main(init_from_torch=)`` hands ``fit_detection`` a
    facebook-DETR checkpoint's weights that load into its ``Detr``."""
    from tests.test_port_torch import RefViT, _fake_detr_state_dict
    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.utils import port_torch
    from vision_transformers_tpu_torch.utils.args import get_args

    a = get_args("vit_tiny_cifar100")
    torch.manual_seed(0)
    ref = RefViT(a["image_size"], a["patch_size"], a["num_layers"],
                 a["num_heads"], a["hidden_dim"], a["mlp_dim"],
                 a["num_classes"])
    ckpt, art = str(tmp_path / "ref.pt"), str(tmp_path / "art")
    torch.save({"state_dict": ref.state_dict()}, ckpt)
    first = []

    def snapshot(module, _inputs):
        if isinstance(module, ViT) and not first:
            first.append({k: v.clone() for k, v in
                          module.state_dict().items()})

    hook = torch.nn.modules.module.register_module_forward_pre_hook(snapshot)
    try:
        hist = _run(cifar, "vit_tiny_cifar100", "--epochs", "1",
                    "--init-from-torch", ckpt, "--export", art,
                    "--export-int8", "--export-buckets", "4")
    finally:
        hook.remove()
    hand = ViT(**a, device="cpu")
    hand.load_state_dict(port_torch.port_vit_state_dict(ref.state_dict()))
    for k, v in hand.state_dict().items():
        assert torch.equal(first[0][k], v), k
    model = hist["final_state"].model
    assert not torch.equal(model.head.weight, hand.head.weight)  # it trained
    clf = serving.load_classifier(art, device="cpu")
    assert clf.manifest["model_kwargs"]["quant8"] is True
    assert clf.model.encoder.encoder_layer_0.mlp.fc1.kernel_q.dtype == \
        torch.int8
    x = np.random.RandomState(1).rand(3, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        want = serving.quantize_classifier(model)(torch.from_numpy(x))
    torch.testing.assert_close(clf.predict(x), want, rtol=0, atol=1e-6)

    sd = {k: torch.from_numpy(v) for k, v in _fake_detr_state_dict(
        d=256, heads=8, enc=6, dec=6, ffn=2048, classes=91, queries=100,
        stage_sizes=(3, 4, 6, 3)).items()}
    det_ckpt = str(tmp_path / "detr.pt")
    torch.save(sd, det_ckpt)
    seen = {}

    def fake_fit_detection(model, train, epochs, **kw):
        seen.update(kw, model=model)
        return "trained"

    from vision_transformers_tpu_torch.training import detection
    from vision_transformers_tpu_torch.utils.coco import build_coco
    monkeypatch.setattr(build_coco, "build", lambda *a_, **k: [])
    monkeypatch.setattr(detection, "DetectionLoader", lambda *a_, **k: None)
    monkeypatch.setattr(detection, "fit_detection", fake_fit_detection)
    assert cli.run_detection_main("coco", init_from_torch=det_ckpt,
                                  device="cpu") == "trained"
    seen["model"].load_state_dict(seen["init_params"])  # strict
    assert torch.equal(seen["init_params"]["query_embed"],
                       sd["query_embed.weight"])
