"""The port's parallel paths across processes, against the JAX package.

The parent test computes the JAX references in-process, on the 8-device
CPU mesh of ``conftest.py``, and writes the inputs, the weights (through
``utils.port_jax``) and the outputs to ``tmp_path`` as ``.npz``. It then
runs this file as the worker script of a gloo group of 2 and one of 4
processes (``python tests/test_torch_port_multiprocess.py rank world port
dir``; a worker imports no JAX and runs one torch thread), and compares
what rank 0 writes back. Each group runs all its checks in one go:

- the host helpers (``shard_for_process``, ``reduce_dict``,
  ``SmoothedValue`` and ``MetricLogger`` sync, ``all_gather_objects``,
  ``save_on_master``), as JAX ``tests/_multihost_worker.py`` checks them;
- ``fit`` on meshes (2, 1) and (1, 2), or (2, 2) with a checkpoint, against
  JAX ``fit`` on its (4, 2) mesh at dropout 0 (rtol 1e-4, atol 1e-5, the
  tolerances of JAX ``tests/test_parallel.py``), ``steps_per_call`` 2 on
  (2, 1) bit-equal to 1; at rate 0.1 the ranks draw different masks and
  the loss falls;
- Swin and PVT DP×TP steps against JAX's on its (4, 2) mesh; at 2,
  ``shard_params`` shards exactly what the rules name for ViT, Swin, PVT,
  Twins, TNT and DETR, and the Twins, SwinV2 and clipped ViT steps over a
  model axis of 2 equal the steps without a mesh;
- ``fit_detection`` with a batch that does not split over 4 ranks (run
  whole, bit-equal to the run without a mesh); its data-parallel trajectory
  is held against JAX's in ``test_torch_port_detection_train.py``, which
  runs this file's "detr" workers;
- data-parallel serving (JAX ``test_serving_spmd.py``), and its int8 twin
  against the port's int8 model without a mesh;
- ring attention on the sequence axis (and data × seq at 4), with a key
  mask, fully masked rows, dq/dk/dv, the DETR encoder under
  ``sequence_sharding`` and its fallback (JAX ``test_sequence_parallel.py``);
- GPipe on toy stages, with more microbatches than stages, the ViT pipeline
  and DP×PP at 4 (JAX ``test_pipeline_parallel.py``);
- top-1 MoE, fewer ranks than experts, and its gradients (JAX
  ``test_expert_parallel.py``).

``test_nccl_world_one_paths`` (marker ``cuda``) runs the world-1 NCCL paths
on the card.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VIT_FIT = dict(image_size=16, patch_size=4, num_layers=2, num_heads=4,
               hidden_dim=32, mlp_dim=64, num_classes=10)
SWIN = dict(patch_size=[2, 2], embed_dim=16, depths=[1, 1], num_heads=[2, 4],
            window_size=[2, 2], num_classes=10, stochastic_depth_prob=0.0)
PVT_CFG = dict(image_size=16, patch_size=4, embed_dims=[16, 32],
               num_heads=[2, 4], depths=[1, 1], sr_ratios=[2, 1],
               num_stages=2, num_classes=10)
SERVE = dict(image_size=32, patch_size=8, num_layers=2, num_heads=2,
             hidden_dim=64, mlp_dim=128, dropout=0.0, attention_dropout=0.0,
             num_classes=10)
PIPE = dict(image_size=16, patch_size=4, num_layers=8, num_heads=4,
            hidden_dim=32, mlp_dim=64, num_classes=10)
ENC = dict(d_model=32, nhead=4, num_layers=2, dim_feedforward=64,
           dropout=0.0)
DETR = dict(num_classes=5, num_queries=8, hidden_dim=32, nheads=4,
            num_encoder_layers=1, num_decoder_layers=2, dim_feedforward=64,
            dropout=0.0, aux_loss=True)
RTOL, ATOL = 1e-4, 1e-5


class FitLoader:
    """16 float NHWC images in batches of 8, seeded."""

    def __init__(self, n=16, batch=8, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 16, 16, 3).astype(np.float32)
        self.y = rng.randint(0, 10, n).astype(np.int32)
        self.batch = batch

    def __iter__(self):
        for i in range(0, len(self.y), self.batch):
            yield self.x[i:i + self.batch], self.y[i:i + self.batch]


class Detection:
    """Four images of unequal sizes (so the batch pads) with 1-3 boxes."""

    def __init__(self, n=4, seed=0):
        rng = np.random.RandomState(seed)
        self.items = []
        for i in range(n):
            h, w = 50 + 7 * i, 90 - 5 * i
            k = 1 + i % 3
            boxes = np.concatenate([rng.rand(k, 2) * 0.6 + 0.2,
                                    rng.rand(k, 2) * 0.3 + 0.05], axis=1)
            self.items.append((
                rng.rand(h, w, 3).astype(np.float32),
                {"labels": rng.randint(0, 5, k),
                 "boxes": boxes.astype(np.float32),
                 "image_id": np.asarray([i]),
                 "orig_size": np.asarray([h, w])}))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _qkv(b=2, h=2, s=64, d=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))


def _moe(e, d=16, h=32, seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *sh: (rng.randn(*sh) * 0.3).astype(np.float32)  # noqa: E731
    return (f(d, e), f(e, d, h), f(e, h), f(e, h, d), f(e, d))


def _stages(n_stages, d, seed):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n_stages, d, d) * 0.3).astype(np.float32),
            (rng.randn(n_stages, d) * 0.1).astype(np.float32))


# ======================================================================
# the worker (no JAX)
# ======================================================================


def _worker(rank, world, port, tmp, mode):
    import torch

    torch.set_num_threads(1)
    torch.manual_seed(0)
    sys.path.insert(0, ROOT)
    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.parallel import mesh as pmesh

    info = parallel.init_distributed_mode(
        coordinator_address=f"localhost:{port}", num_processes=world,
        process_id=rank, device="cpu")
    assert info == {"rank": rank, "world_size": world,
                    "distributed": True}, info
    if mode == "detr":
        _detr_worker(rank, world, tmp)
        parallel.destroy_distributed_mode()
        print(f"PARALLEL_OK rank={rank}", flush=True)
        return
    refs = dict(np.load(os.path.join(tmp, "refs.npz")))
    out = {}
    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731

    def weights(prefix):
        n = len(prefix)
        return {k[n:]: T(v) for k, v in refs.items() if k.startswith(prefix)}

    def put(key, t):
        out[key] = t.detach().float().numpy() if torch.is_tensor(t) \
            else np.asarray(t)

    _host_helpers(rank, world, tmp)

    # --- fit on meshes against JAX fit on its (4, 2) mesh
    from vision_transformers_tpu_torch.models.image_classification import (
        PVT, SwinTransformer, ViT)
    from vision_transformers_tpu_torch.training import trainer

    shapes = [(2, 1), (1, 2)] if world == 2 else [(2, 2)]
    for shape in shapes:
        mesh = parallel.make_mesh(shape, ("data", "model"))
        model = ViT(**VIT_FIT, device="cpu")
        model.load_state_dict(weights("vit/w/"))
        ckpt = os.path.join(tmp, "ckpt") if shape == (2, 2) else None
        hist = trainer.fit(model, FitLoader(), FitLoader(), 2, lr=1e-3,
                           mesh=mesh, verbose=False, seed=0,
                           checkpoint_dir=ckpt, checkpoint_every=2 if ckpt
                           else 0)
        tag = f"fit{shape[0]}{shape[1]}"
        for k in ("train_loss", "train_accuracy", "test_loss",
                  "test_accuracy"):
            put(f"{tag}/{k}", hist[k])
        whole = pmesh.gather_state_dict(model)
        for k, v in whole.items():
            put(f"{tag}/w/{k}", v)
        # every rank holds the same metrics
        assert parallel.all_gather_objects(hist["train_loss"]) == \
            [hist["train_loss"]] * world
        if shape[1] > 1:
            qkv = model.encoder.encoder_layer_0.self_attention.qkv
            assert qkv.weight.shape == (3 * 32 // shape[1], 32)
        if ckpt:
            _check_checkpoint(ckpt, whole, hist["final_state"])
        if shape == (2, 1):
            # steps_per_call 2 splits the batch axis of the stacked (2, B,
            # ...) chunk, not the chunk axis: the same run, bit for bit
            model2 = ViT(**VIT_FIT, device="cpu")
            model2.load_state_dict(weights("vit/w/"))
            hist2 = trainer.fit(model2, FitLoader(), FitLoader(), 2, lr=1e-3,
                                mesh=mesh, verbose=False, seed=0,
                                steps_per_call=2)
            assert hist2["train_loss"] == hist["train_loss"]
            for k, v in model2.state_dict().items():
                assert torch.equal(v, whole[k]), k

    # --- dropout 0.1 under the mesh: different masks per rank, loss falls
    if world == 4:
        _dropout_ranks(parallel.make_mesh((2, 2), ("data", "model")))

    # --- Swin and PVT DP×TP steps
    tp_shape = (1, 2) if world == 2 else (2, 2)
    mesh = parallel.make_mesh(tp_shape, ("data", "model"))
    x, y = refs["step/x"], refs["step/y"]
    w = np.ones(len(y), np.float32)
    for name, cls, cfg, xs in (
            ("swin", SwinTransformer, SWIN, x[:, :8, :8, :]),
            ("pvt", PVT, PVT_CFG, x)):
        model = cls(**cfg, device="cpu")
        model.load_state_dict(weights(f"{name}/w/"))
        pmesh.shard_params(model, mesh)
        state = trainer.make_train_state(model, lr=1e-3)
        step = trainer.train_step_fn(model, mesh=mesh)
        state, loss_n, correct, n = step(state, xs, y, w)
        put(f"{name}/loss", loss_n)
        for k, v in pmesh.gather_state_dict(model).items():
            put(f"{name}/new/{k}", v)

    if world == 4:
        _detr_replicated()
    else:
        _tp_follows_the_rules()
        _tp_steps_match_one_rank()

    _serving(rank, world, tmp, refs, weights, put)
    _ring(world, refs, weights, put)
    _pipeline(world, refs, weights, put)
    _experts(world, refs, put)

    if rank == 0:
        np.savez(os.path.join(tmp, f"out_world{world}.npz"), **out)
    parallel.destroy_distributed_mode()
    print(f"PARALLEL_OK rank={rank}", flush=True)


def _fit_detection(mesh, batches, weights, **kw):
    from vision_transformers_tpu_torch.models.object_detection import Detr
    from vision_transformers_tpu_torch.training import detection as tdet

    model = Detr(**DETR, device="cpu")
    hist = tdet.fit_detection(
        model, tdet.DetectionLoader(Detection(2 * batches), 2), 1,
        num_classes=5, max_targets=4, verbose=False, init_params=weights,
        mesh=mesh, **kw)
    return hist["loss"], model.state_dict()


def _detr_replicated():
    """A batch of 2 does not split over 4 ranks: it runs whole on every
    rank, unsplit, and the step is the one without a mesh, bit for bit."""
    import torch

    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.models.object_detection import Detr

    weights = Detr(**DETR, device="cpu").state_dict()
    loss, got = _fit_detection(parallel.make_mesh((4,), ("data",)), 1,
                               weights)
    want_loss, want = _fit_detection(None, 1, weights)
    assert loss == want_loss, (loss, want_loss)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _detr_worker(rank, world, tmp):
    """``fit_detection`` over a data axis of 2, each rank one image of each
    batch of 2, from the weights of the JAX trajectory
    (tests/test_torch_port_detection_train.py) that it is held against."""
    import torch

    from vision_transformers_tpu_torch import parallel

    refs = np.load(os.path.join(tmp, "detr_refs.npz"))
    weights = {k: torch.from_numpy(refs[k]) for k in refs.files}
    loss, state = _fit_detection(parallel.make_mesh((world,), ("data",)), 3,
                                 weights, lr_drop=1)
    if rank == 0:
        np.savez(os.path.join(tmp, "detr_out.npz"), loss=np.asarray(loss),
                 **{k: v.numpy() for k, v in state.items()})


def _tp_follows_the_rules():
    """``shard_params`` over a model axis of 2 shards a parameter exactly
    where ``param_partition_spec`` names the axis, along that dim, for every
    family; a parameter with a spec stays whole only in a module whose heads
    the axis does not divide (the guard)."""
    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.models.image_classification import (
        PVT, TNT, SwinTransformer, TwinSVT, ViT)
    from vision_transformers_tpu_torch.models.object_detection import Detr
    from vision_transformers_tpu_torch.parallel import mesh as pmesh

    mesh = parallel.make_mesh((1, 2), ("data", "model"))
    for model in (ViT(**VIT_FIT, device="cpu"),
                  SwinTransformer(**dict(SWIN, embed_dim=24, num_heads=[3, 4]),
                                  device="cpu"),
                  PVT(**PVT_CFG, device="cpu"),
                  TwinSVT(img_size=32, num_classes=10, device="cpu"),
                  TNT(image_size=16, patch_size=8, outer_dim=64, inner_dim=24,
                      outer_num_heads=4, inner_num_heads=2, num_layers=1,
                      num_classes=10, device="cpu"),
                  Detr(**DETR, device="cpu")):
        names = [n for n, _ in model.named_parameters()]
        attn = pmesh.attention_prefixes(names)
        specs = {n: pmesh.param_partition_spec(n, attn) for n in names}
        parallel.shard_params(model, mesh)
        owner = {}  # parameter → the innermost module that shards it
        for mname, m in model.named_modules():
            if hasattr(m, "tp_shard"):
                for pname, _ in m.named_parameters():
                    owner[f"{mname}.{pname}"] = m
        n_sharded = 0
        for name, p in model.named_parameters():
            layout = getattr(p, "_tp_layout", None)
            if layout is not None:
                assert specs[name][layout[0]] == "model", (name, specs[name])
                n_sharded += 1
            elif any(specs[name]):
                m = owner.get(name)
                assert m is not None and m.tp is None \
                    and not m.tp_divides(2), (type(model).__name__, name)
        assert n_sharded > 0, type(model).__name__


def _nonzero_head(model):
    """The ViT's head is zero at init, which stops every other gradient."""
    import torch

    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        model.head.weight.copy_(torch.randn(model.head.weight.shape,
                                            generator=g) * 0.2)
    return model


def _tp_steps_match_one_rank():
    """Over a model axis of 2, one optimizer step equals the step without
    a mesh (which the single-process tests hold against the JAX package):
    Adam for Twins-SVT (LSA and GSA blocks) and SwinV2 (its per-head
    temperature, position-bias MLP and q/v biases read per rank), SGD for
    ViT with gradient
    clipping active, the clip taking the whole model's norm, shards summed
    over the axis."""
    import torch

    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.models.image_classification import (
        SwinTransformerV2, TwinSVT, ViT)
    from vision_transformers_tpu_torch.parallel import mesh as pmesh
    from vision_transformers_tpu_torch.training import trainer

    twins = dict(img_size=32, patch_size=4, embed_dims=[16, 32],
                 num_heads=[2, 4], mlp_ratios=[4, 4], depths=[2, 2],
                 sr_ratios=[2, 1], wss=[4, 4], qkv_bias=True, num_classes=10)
    cases = ((lambda: TwinSVT(**twins, device="cpu", seed=5),
              {"lr": 1e-3}, 32),
             (lambda: SwinTransformerV2(**SWIN, device="cpu", seed=6),
              {"lr": 1e-3}, 8),
             # SGD: Adam's first step does not see the gradient's scale; a
             # large rate, so the clipped step is far above the tolerance
             (lambda: _nonzero_head(ViT(**VIT_FIT, device="cpu", seed=2)),
              {"optimizer": "sgd", "lr": 100.0, "grad_clip_norm": 0.01}, 16))
    for build, opt, side in cases:
        x = _rand(30, 4, side, side, 3)
        y, w = np.arange(4) % 10, np.ones(4, np.float32)
        results = []
        for mesh in (None, parallel.make_mesh((1, 2), ("data", "model"))):
            model = build()
            if mesh is not None:
                parallel.shard_params(model, mesh)
            state = trainer.make_train_state(model, **opt)
            _, loss_n, _, _ = trainer.train_step_fn(model, mesh=mesh)(
                state, x, y, w)
            norm = torch.linalg.vector_norm(torch.stack(
                [p.grad.norm() for p in state.optimizer.params]))
            results.append((float(loss_n), float(norm),
                            pmesh.gather_state_dict(model)))
        (l0, n0, w0), (l1, _, w1) = results
        assert abs(l0 - l1) <= RTOL * abs(l0), (l0, l1)
        if "grad_clip_norm" in opt:
            assert n0 > 10 * opt["grad_clip_norm"], n0  # the clip acts
        for k, v in w0.items():
            torch.testing.assert_close(w1[k], v, rtol=RTOL, atol=ATOL,
                                       msg=k)


def _host_helpers(rank, world, tmp):
    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.utils.coco.util import misc
    from vision_transformers_tpu_torch.utils.load_data import (
        shard_for_process)
    from vision_transformers_tpu_torch.utils.metrics import (
        MetricLogger, SmoothedValue)

    # shard_for_process: JAX's permutation, index for index; disjoint cover
    images = np.arange(32, dtype=np.float32).reshape(32, 1)
    labels = np.arange(32, dtype=np.int64)
    xs, ys = shard_for_process(images, labels, seed=0)
    want = np.random.RandomState(0).permutation(32)[rank::world]
    assert (ys == want).all() and (xs[:, 0].astype(np.int64) == ys).all()
    merged = np.sort(np.concatenate(parallel.all_gather_objects(ys)))
    assert (merged == np.arange(32)).all(), "shards overlap or drop examples"

    out = misc.reduce_dict({"loss": float(rank + 1), "acc": float(rank)})
    assert abs(out["loss"] - (world + 1) / 2) < 1e-12, out
    assert abs(out["acc"] - (world - 1) / 2) < 1e-12, out
    summed = misc.reduce_dict({"loss": float(rank + 1)}, average=False)
    assert abs(summed["loss"] - world * (world + 1) / 2) < 1e-12, summed
    assert misc.get_rank() == rank and misc.get_world_size() == world

    sv = SmoothedValue()
    sv.update(float(rank + 1), n=2)
    sv.synchronize_between_processes()
    assert sv.count == 2 * world, sv.count
    assert abs(sv.global_avg - (world + 1) / 2) < 1e-12, sv.global_avg
    logger = MetricLogger()
    logger.update(loss=float(rank))
    logger.synchronize_between_processes()
    assert logger.meters["loss"].count == world
    assert abs(logger.meters["loss"].global_avg - (world - 1) / 2) < 1e-12

    got = misc.all_gather({"r": np.asarray([rank], np.int32)})
    assert [int(g["r"][0]) for g in got] == list(range(world))

    marker = os.path.join(tmp, f"saved_by_{rank}_of_{world}.txt")
    parallel.save_on_master(lambda: open(marker, "w").write("x"))
    assert os.path.exists(marker) == parallel.is_main_process()


def _check_checkpoint(ckpt, whole, state):
    """The checkpoint under a TP mesh is the file of a run without one:
    the whole model, and optimizer leaves of the unsharded shapes."""
    import torch

    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.training import trainer
    from vision_transformers_tpu_torch.utils.checkpoint import (
        restore_checkpoint)

    torch.distributed.barrier()  # rank 0 has written it
    plain = ViT(**VIT_FIT, device="cpu")
    target = trainer.make_train_state(plain, lr=1e-3)
    restore_checkpoint(ckpt, target, step=2)
    for k, v in plain.state_dict().items():
        assert torch.equal(v, whole[k]), k
    assert target.optimizer.count == state.optimizer.count == 4
    assert target.step == state.step == 4


def _dropout_ranks(mesh):
    """At rate 0.1 each rank's attention draws its own mask (the data
    coordinate folds into the step's seeds, the model coordinate into the
    seeds of the rank's heads): the kernels' Philox masks (the same-mask
    oracle, ``dropout_keep_mask``) differ between all four ranks; the loss
    falls."""
    import torch

    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.ops import attention
    from vision_transformers_tpu_torch.ops.flash_attention import (
        dropout_keep_mask)
    from vision_transformers_tpu_torch.training import trainer

    seeds = []
    kernel = attention.packed_flash_attention

    def recording(qkv, heads, **kw):
        seeds.append(kw.get("seed"))
        return kernel(qkv, heads, **kw)

    attention.packed_flash_attention = recording
    try:
        model = ViT(**VIT_FIT, dropout=0.1, attention_dropout=0.1,
                    device="cpu")
        hist = trainer.fit(model, FitLoader(), FitLoader(), 4, lr=3e-3,
                           mesh=mesh, verbose=False, seed=0)
    finally:
        attention.packed_flash_attention = kernel
    assert hist["train_loss"][-1] < hist["train_loss"][0], hist["train_loss"]
    # local heads 2 over 4 local examples, 17 tokens
    mask = dropout_keep_mask(seeds[0], 0.1, 4 * 2, 17, 17)
    masks = parallel.all_gather_objects(mask.numpy())
    for i in range(4):
        for j in range(i):
            assert not np.array_equal(masks[i], masks[j]), (i, j)
    assert torch.is_tensor(mask)


def _serving(rank, world, tmp, refs, weights, put):
    import torch

    from vision_transformers_tpu_torch import parallel, serving
    from vision_transformers_tpu_torch.models.image_classification import ViT

    mesh = parallel.make_mesh((world,), ("data",))
    model = ViT(**SERVE, device="cpu")
    model.load_state_dict(weights("serve/w/"))
    shape = (32, 32, 3)
    bad = os.path.join(tmp, f"bad{world}")
    try:
        serving.export_classifier(model, shape, bad, buckets=(8, 9),
                                  mesh=mesh)
        raise AssertionError("an indivisible bucket was exported")
    except ValueError as e:
        assert "not divisible" in str(e)
    art = os.path.join(tmp, f"spmd{world}")
    serving.export_classifier(model, shape, art, buckets=(8, 16), mesh=mesh)
    with open(os.path.join(art, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["nr_devices"] == world
    assert manifest["data_axis"] == "data"
    # refused: no mesh, and a mesh of another size than the artifact's
    other = os.path.join(tmp, f"other{world}")
    if rank == 0:
        import shutil

        shutil.copytree(art, other, dirs_exist_ok=True)
        manifest["nr_devices"] = 2 * world
        with open(os.path.join(other, "manifest.json"), "w") as f:
            json.dump(manifest, f)
    torch.distributed.barrier()
    for path, mesh_, n_want in ((art, None, world), (other, mesh, 2 * world)):
        try:
            serving.load_classifier(path, device="cpu", mesh=mesh_)
            raise AssertionError(f"{path} loaded with mesh {mesh_}")
        except RuntimeError as e:
            assert f"{n_want}-device mesh" in str(e), e
    clf = serving.load_classifier(art, device="cpu", mesh=mesh)
    x = refs["serve/x"]
    for n in (5, 8, 16, 20):  # pad to 8, exact, exact, 16 + pad(4 to 8)
        got = clf.predict(x[:n])
        assert tuple(got.shape) == (n, 10)
        put(f"serve/n{n}", got)
    qmodel = serving.quantize_classifier(model)
    qart = os.path.join(tmp, f"spmd_int8_{world}")
    serving.export_classifier(qmodel, shape, qart, buckets=(8,), mesh=mesh)
    put("serve/int8", serving.load_classifier(qart, device="cpu",
                                              mesh=mesh).predict(x[:8]))
    with torch.no_grad():  # the int8 model without a mesh, on every row
        put("serve/int8_whole", qmodel(torch.from_numpy(x[:8])))
    assert torch.distributed.get_world_size() == world


def _ring(world, refs, weights, put):
    import torch

    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.models.object_detection.transformer \
        import TransformerEncoder

    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    seq = parallel.make_mesh((world,), ("seq",))
    q, k, v = (T(refs[f"ring/{n}"]) for n in "qkv")
    put("ring/out", parallel.sequence_parallel_attention(q, k, v, seq))
    mask = T(refs["ring/mask"])
    put("ring/masked", parallel.sequence_parallel_attention(
        q, k, v, seq, kv_mask=mask))
    q1, k1, v1 = (T(refs[f"ring/{n}1"]) for n in "qkv")
    zero = parallel.sequence_parallel_attention(
        q1, k1, v1, seq, kv_mask=torch.zeros(1, 16, dtype=torch.bool))
    assert torch.isfinite(zero).all() and float(zero.abs().max()) == 0.0
    qg, kg, vg = (T(refs[f"ring/{n}g"]).requires_grad_() for n in "qkv")
    o = parallel.sequence_parallel_attention(qg, kg, vg, seq)
    (o * o).sum().backward()
    for n, t in zip("qkv", (qg, kg, vg)):
        put(f"ring/d{n}", t.grad)
    if world == 4:
        ds = parallel.make_mesh((2, 2), ("data", "seq"))
        q4, k4, v4 = (T(refs[f"ring/{n}4"]) for n in "qkv")
        put("ring/data_seq", parallel.sequence_parallel_attention(
            q4, k4, v4, ds, data_axis="data"))

    enc = TransformerEncoder(**ENC)
    enc.load_state_dict(weights("enc/w/"))
    enc.eval()
    src, pos, pad = T(refs["enc/src"]), T(refs["enc/pos"]), T(refs["enc/pad"])
    with parallel.sequence_sharding(seq, "seq"):
        put("enc/out", enc(src, pad, pos))
    # the fallback: 31 tokens do not divide the axis
    src31 = T(refs["enc/src31"])
    with parallel.sequence_sharding(seq, "seq"):
        put("enc/out31", enc(src31))


def _pipeline(world, refs, weights, put):
    import torch

    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.models.image_classification import ViT

    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    stage = parallel.make_mesh((world,), ("stage",))
    ws, bs = (T(a) for a in _stages(world, 16, seed=0))
    x = T(refs[f"pipe/x{world}"])
    put("pipe/toy", parallel.pipeline_apply(
        lambda p, a: torch.tanh(a @ p[0] + p[1]), (ws, bs), x, stage))
    if world == 2:
        ws6, _ = (T(a) for a in _stages(2, 8, seed=1))
        x12 = T(refs["pipe/x12"])
        put("pipe/micro6", parallel.pipeline_apply(
            lambda w_, a: torch.tanh(a @ w_), ws6, x12, stage, n_micro=6))
    model = ViT(**PIPE, device="cpu")
    model.load_state_dict(weights("pipe/w/"))
    images = T(refs["pipe/images"])
    put("pipe/vit", parallel.vit_pipeline_forward(model, None, images, stage))
    if world == 4:
        dpp = parallel.make_mesh((2, 2), ("data", "stage"))
        put("pipe/vit_dp", parallel.vit_pipeline_forward(
            model, None, images, dpp, data_axis="data", n_micro=4))


def _experts(world, refs, put):
    import torch

    from vision_transformers_tpu_torch import parallel

    T = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    mesh = parallel.make_mesh((world,), ("expert",))
    rk, w1, b1, w2, b2 = (T(a) for a in _moe(8))
    x = T(refs["moe/x"])
    put("moe/out", parallel.expert_parallel_mlp(x, rk, w1, b1, w2, b2, mesh))
    rk, w1, b1, w2, b2 = (T(a) for a in _moe(4, seed=3))
    w1.requires_grad_()
    xg = T(refs["moe/xg"]).requires_grad_()
    (parallel.expert_parallel_mlp(xg, rk, w1, b1, w2, b2, mesh) ** 2).sum() \
        .backward()
    put("moe/dw1", w1.grad)
    put("moe/dx", xg.grad)


# ======================================================================
# the parent (JAX references)
# ======================================================================


def _flat(prefix, state_dict, into):
    for k, v in state_dict.items():
        into[prefix + k] = v.detach().numpy() if hasattr(v, "detach") \
            else np.asarray(v)


def _references(tmp):
    """Every JAX reference the two groups compare with. Weights are numpy
    draws into ``jax.eval_shape`` shapes (``seeded_params``: eager flax
    ``init`` costs seconds a model on the CPU) and the JAX functions run
    jitted."""
    import jax
    import jax.numpy as jnp
    import optax

    from tests.test_torch_port_detr import seeded_params
    from vision_transformers_tpu.models.image_classification import (
        PVT, SwinTransformer, ViT)
    from vision_transformers_tpu.models.object_detection.transformer import (
        TransformerEncoder)
    from vision_transformers_tpu.ops.attention import mha_reference
    from vision_transformers_tpu.parallel import (
        batch_sharding, make_mesh, shard_params)
    from vision_transformers_tpu.parallel.expert import moe_mlp_reference
    from vision_transformers_tpu.training import optimizers as jopt
    from vision_transformers_tpu.training import trainer as jtrainer
    from vision_transformers_tpu_torch.utils.port_jax import (
        pvt_state_dict_from_jax, swin_state_dict_from_jax,
        vit_state_dict_from_jax)

    refs, want = {}, {}
    get = jax.device_get
    mesh42 = make_mesh((4, 2), ("data", "model"))

    def params_of(module, *args, seed=0, **kw):
        return seeded_params(jax.eval_shape(lambda: module.init(
            {"params": jax.random.PRNGKey(0)}, *args, **kw))["params"], seed)

    # fit on the (4, 2) mesh, from the state JAX's fit builds there: the
    # parameters TP-sharded, then the optimizer
    model = ViT(**VIT_FIT)
    loader = FitLoader()
    params = params_of(model, loader.x[:1], seed=1)
    _flat("vit/w/", vit_state_dict_from_jax(params), refs)
    state = jtrainer.TrainState.create(
        apply_fn=model.apply, params=shard_params(params, mesh42),
        tx=jopt.make_optimizer("adam", 1e-3))
    hist = jtrainer.fit(model, loader, loader, 2, lr=1e-3, mesh=mesh42,
                        state=state, verbose=False, seed=0)
    for k in ("train_loss", "train_accuracy", "test_loss", "test_accuracy"):
        want[f"fit/{k}"] = np.asarray(hist[k])
    _flat("fit/w/", vit_state_dict_from_jax(
        get(hist["final_state"].params)), want)

    # one DP×TP step of Swin and PVT on the (4, 2) mesh
    x = np.random.RandomState(2).randn(8, 16, 16, 3).astype(np.float32)
    y = np.arange(8, dtype=np.int32) % 10
    refs["step/x"], refs["step/y"] = x, y
    bs = batch_sharding(mesh42)
    for name, cls, cfg, xs, port in (
            ("swin", SwinTransformer, SWIN, x[:, :8, :8, :],
             swin_state_dict_from_jax),
            ("pvt", PVT, PVT_CFG, x, pvt_state_dict_from_jax)):
        jm = cls(**cfg)
        p = params_of(jm, xs[:1], seed=3)
        _flat(f"{name}/w/", port(p), refs)
        state = jtrainer.TrainState.create(
            apply_fn=jm.apply, params=shard_params(p, mesh42),
            tx=optax.adam(1e-3))
        new, loss_sum, _, _ = jax.jit(jtrainer.train_step_fn(jm))(
            state, jax.device_put(jnp.asarray(xs), bs),
            jax.device_put(jnp.asarray(y), bs),
            jax.device_put(jnp.ones(8, jnp.float32), bs),
            jax.random.PRNGKey(42))
        want[f"{name}/loss"] = np.asarray(loss_sum)
        _flat(f"{name}/new/", port(get(new.params)), want)

    # serving: the float model and its int8 twin
    jm = ViT(**SERVE)
    p = params_of(jm, np.zeros((1, 32, 32, 3), np.float32), seed=4)
    _flat("serve/w/", vit_state_dict_from_jax(p), refs)
    xs = np.random.RandomState(0).randn(20, 32, 32, 3).astype(np.float32)
    refs["serve/x"] = xs
    want["serve/logits"] = np.asarray(jax.jit(jm.apply)({"params": p}, xs))

    # ring attention against the oracle (jitted: eager JAX compiles each
    # primitive on its own)
    mha = jax.jit(mha_reference)
    q, k, v = _qkv()
    refs.update({"ring/q": q, "ring/k": k, "ring/v": v})
    want["ring/out"] = np.asarray(mha(q, k, v))
    mask = np.broadcast_to(np.arange(64)[None] < 40, (2, 64)).copy()
    refs["ring/mask"] = mask
    want["ring/masked"] = np.asarray(mha(
        q, k, v, mask=jnp.asarray(mask)[:, None, None, :]))
    for n, t in zip("qkv", _qkv(b=1, s=16, seed=5)):
        refs[f"ring/{n}1"] = t
    qg, kg, vg = _qkv(b=1, h=1, s=16, d=4, seed=7)
    refs.update({"ring/qg": qg, "ring/kg": kg, "ring/vg": vg})
    grads = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(mha_reference(a, b, c) ** 2),
        argnums=(0, 1, 2)))(qg, kg, vg)
    for n, g in zip("qkv", grads):
        want[f"ring/d{n}"] = np.asarray(g)
    q4, k4, v4 = _qkv(b=4, s=32)
    refs.update({"ring/q4": q4, "ring/k4": k4, "ring/v4": v4})
    want["ring/data_seq"] = np.asarray(mha(q4, k4, v4))

    enc = TransformerEncoder(**ENC)
    rng = np.random.RandomState(0)
    src = rng.randn(2, 64, 32).astype(np.float32)
    pos = (rng.randn(2, 64, 32) * 0.1).astype(np.float32)
    pad = np.zeros((2, 64), bool)
    pad[:, 60:] = True  # the last 4 keys padded
    p = params_of(enc, src, src_key_padding_mask=pad, pos=pos, seed=5)
    _flat("enc/w/", vit_state_dict_from_jax(p), refs)
    refs.update({"enc/src": src, "enc/pos": pos, "enc/pad": pad})
    apply = jax.jit(enc.apply)
    want["enc/out"] = np.asarray(apply({"params": p}, src,
                                       src_key_padding_mask=pad, pos=pos))
    src31 = np.random.RandomState(1).randn(2, 31, 32).astype(np.float32)
    refs["enc/src31"] = src31
    want["enc/out31"] = np.asarray(apply({"params": p}, src31))

    # GPipe against the sequential stack
    for n_stages in (2, 4):
        xw = _rand(10 + n_stages, 8, 16)
        refs[f"pipe/x{n_stages}"] = xw
        ws, bs_ = _stages(n_stages, 16, seed=0)
        seq = xw
        for i in range(n_stages):
            seq = np.tanh(seq @ ws[i] + bs_[i])
        want[f"pipe/toy{n_stages}"] = seq
    x12 = _rand(20, 12, 8)
    refs["pipe/x12"] = x12
    ws6, _ = _stages(2, 8, seed=1)
    want["pipe/micro6"] = np.tanh(np.tanh(x12 @ ws6[0]) @ ws6[1])
    jm = ViT(**PIPE)
    images = _rand(6, 8, 16, 16, 3)
    p = params_of(jm, images[:1], seed=6)
    _flat("pipe/w/", vit_state_dict_from_jax(p), refs)
    refs["pipe/images"] = images
    want["pipe/vit"] = np.asarray(jax.jit(jm.apply)({"params": p}, images))

    # MoE against the dense oracle, and its gradients
    x = _rand(1, 24, 16)
    refs["moe/x"] = x
    want["moe/out"] = np.asarray(jax.jit(moe_mlp_reference)(x, *_moe(8)))
    rk, w1, b1, w2, b2 = _moe(4, seed=3)
    xg = _rand(4, 64, 16)
    refs["moe/xg"] = xg
    dw1, dx = jax.jit(jax.grad(
        lambda w, xx: jnp.sum(moe_mlp_reference(xx, rk, w, b1, w2, b2) ** 2),
        argnums=(0, 1)))(w1, xg)
    want["moe/dw1"], want["moe/dx"] = np.asarray(dw1), np.asarray(dx)
    assert len(np.unique(np.argmax(xg @ rk, -1))) == 4  # every expert wins

    np.savez(os.path.join(tmp, "refs.npz"), **refs)
    return want


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def spawn(world, tmp, mode="all"):
    """Run the workers of ``mode`` ("all": this file's checks, "detr": the
    data-parallel DETR trajectory) as a gloo group of ``world`` processes;
    raises with a rank's output when one fails."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         str(port), str(tmp), mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=ROOT) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=400)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"PARALLEL_OK rank={r}" in out, \
            f"rank {r} of {world} failed:\n{out[-6000:]}"


def _nccl_world_one(tmp):
    """The world-1 NCCL paths on the card (``cuda`` test below): a tiny
    bf16 ViT's ``fit`` under a (1, 1) mesh bit-equal to ``mesh=None``, a
    data-parallel artifact serving the plain one's bits, and one ring hop
    against ``mha_reference``."""
    import torch

    from vision_transformers_tpu_torch import parallel, serving
    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.ops.attention import mha_reference
    from vision_transformers_tpu_torch.training import trainer

    info = parallel.init_distributed_mode(
        coordinator_address=f"localhost:{_free_port()}", num_processes=1,
        process_id=0)
    try:
        assert info["world_size"] == 1
        assert torch.distributed.get_backend() == "nccl"
        cfg = dict(VIT_FIT, num_heads=2, dtype="bfloat16",
                   attention_dropout=0.1)
        runs = []
        for mesh in (None, parallel.make_mesh((1, 1), ("data", "model"))):
            model = ViT(**cfg)
            model.load_state_dict(ViT(**cfg, seed=3).state_dict())
            hist = trainer.fit(model, FitLoader(), FitLoader(), 2, lr=1e-3,
                               mesh=mesh, verbose=False, seed=1, fused=True)
            runs.append((hist["train_loss"], model.state_dict()))
        assert runs[0][0] == runs[1][0]
        for k, v in runs[0][1].items():
            assert torch.equal(v, runs[1][1][k]), k

        d1 = parallel.make_mesh((1,), ("data",))
        art, dp_art = os.path.join(tmp, "plain"), os.path.join(tmp, "dp")
        serving.export_classifier(model, (16, 16, 3), art, buckets=(4, 8))
        serving.export_classifier(model, (16, 16, 3), dp_art, buckets=(4, 8),
                                  mesh=d1)
        x = FitLoader().x[:11]
        assert torch.equal(serving.load_classifier(art).predict(x),
                           serving.load_classifier(dp_art, mesh=d1).predict(x))

        seq = parallel.make_mesh((1,), ("seq",))
        q, k, v = (torch.from_numpy(t).cuda() for t in _qkv(s=300, d=32))
        keep = (torch.arange(300, device="cuda") < 280)[None].expand(2, 300)
        torch.testing.assert_close(
            parallel.sequence_parallel_attention(q, k, v, seq, kv_mask=keep),
            mha_reference(q, k, v, mask=keep[:, None, None, :]),
            rtol=1e-5, atol=1e-5)
    finally:
        parallel.destroy_distributed_mode()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])
else:
    import pytest

    @pytest.fixture(scope="module")
    def refs(tmp_path_factory):
        tmp = tmp_path_factory.mktemp("parallel")
        return tmp, _references(str(tmp))

    def _close(got, want, name, rtol=RTOL, atol=ATOL):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), rtol=rtol,
                                   atol=atol, err_msg=name)

    def _params_close(got, want, prefix, skip=(), **tol):
        n = 0
        for key, w in want.items():
            if not key.startswith(prefix):
                continue
            name = key[len(prefix):]
            if any(name.endswith(s) for s in skip):
                continue
            g = got[f"{prefix}{name}"]
            if name.endswith("self_attention.qkv.bias"):
                # the key third's true gradient is 0: each package's Adam
                # turns its own rounding noise into steps of size lr
                third = g.shape[0] // 3
                keep = np.r_[0:third, 2 * third:3 * third]
                g, w = g[keep], w[keep]
            _close(g, w, key, **tol)
            n += 1
        assert n > 10, prefix

    def _compare(world, got, want):
        for shape in ([(2, 1), (1, 2)] if world == 2 else [(2, 2)]):
            tag = f"fit{shape[0]}{shape[1]}"
            for k in ("train_loss", "train_accuracy", "test_loss",
                      "test_accuracy"):
                _close(got[f"{tag}/{k}"], want[f"fit/{k}"], f"{tag}/{k}")
            _params_close({k.replace(tag, "fit", 1): v
                           for k, v in got.items()}, want, "fit/w/")
        for name in ("swin", "pvt"):
            _close(got[f"{name}/loss"], want[f"{name}/loss"], name)
            _params_close(got, want, f"{name}/new/")
        for n in (5, 8, 16, 20):
            _close(got[f"serve/n{n}"], want["serve/logits"][:n], f"serve {n}",
                   rtol=2e-5, atol=2e-5)
        # int8 composes with the split: the rows of the whole int8 forward
        # (the port's int8 against JAX's: test_torch_port_quant.py)
        _close(got["serve/int8"], got["serve/int8_whole"], "int8",
               rtol=2e-5, atol=2e-5)
        for k in ("ring/out", "ring/masked", "enc/out", "enc/out31"):
            _close(got[k], want[k], k)
        for n in "qkv":
            _close(got[f"ring/d{n}"], want[f"ring/d{n}"], n)
        _close(got["pipe/toy"], want[f"pipe/toy{world}"], "toy", rtol=1e-5,
               atol=1e-6)
        _close(got["pipe/vit"], want["pipe/vit"], "vit pipeline", rtol=1e-5,
               atol=1e-5)
        _close(got["moe/out"], want["moe/out"], "moe", rtol=1e-5, atol=1e-6)
        for k in ("moe/dw1", "moe/dx"):
            _close(got[k], want[k], k)
        per_expert = np.abs(got["moe/dw1"]).sum(axis=(1, 2))
        assert (per_expert > 0).all()
        if world == 2:
            _close(got["pipe/micro6"], want["pipe/micro6"], "micro6",
                   rtol=1e-5, atol=1e-6)
        else:
            _close(got["ring/data_seq"], want["ring/data_seq"], "data×seq")
            _close(got["pipe/vit_dp"], want["pipe/vit"], "DP×PP", rtol=1e-5,
                   atol=1e-5)

    @pytest.mark.cuda
    def test_nccl_world_one_paths(tmp_path):
        import torch

        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device (NCCL and the kernels)")
        torch.backends.cuda.matmul.allow_tf32 = False
        _nccl_world_one(str(tmp_path))

    @pytest.mark.parametrize("world", [2, 4])
    def test_process_group_matches_jax(refs, world):
        tmp, want = refs
        spawn(world, tmp)
        got = dict(np.load(os.path.join(tmp, f"out_world{world}.npz")))
        _compare(world, got, want)
        assert (tmp / f"saved_by_0_of_{world}.txt").exists()
        assert not (tmp / f"saved_by_1_of_{world}.txt").exists()
