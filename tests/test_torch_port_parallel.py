"""The port's parallel module in one process, against the JAX package.

- The tensor-parallel rules and ``audit_tp_coverage`` against JAX's, for
  every parameter of ViT, Swin, PVT, Twins-SVT, TNT and DETR (the JAX
  package's ``tests/test_parallel.py:218-300`` configurations): a Dense
  ``weight`` takes the transpose of its JAX ``kernel``'s spec, every other
  parameter the spec as it is, and the audits name the same parameters.
- The host helpers without a process group, and the refusals.
- A one-rank gloo group: every parallel path at world 1 equals the path
  without a mesh (``fit`` bit for bit, dropout included), as
  ``chip_smoke.py`` holds them under NCCL on the card.

The multi-rank runs are ``tests/test_torch_port_multiprocess.py``.
"""

import json
import socket

import jax
import numpy as np
import pytest
import torch

from vision_transformers_tpu.models.image_classification import (
    PVT as JPVT, TNT as JTNT, SwinTransformer as JSwin, TwinSVT as JTwins,
    ViT as JViT)
from vision_transformers_tpu.models.object_detection import Detr as JDetr
from vision_transformers_tpu.parallel import mesh as jmesh
from vision_transformers_tpu_torch import parallel
from vision_transformers_tpu_torch.models.image_classification import (
    PVT, TNT, SwinTransformer, TwinSVT, ViT)
from vision_transformers_tpu_torch.models.object_detection import Detr
from vision_transformers_tpu_torch.parallel import mesh as pmesh

FAMILIES = {
    "vit": (dict(image_size=32, patch_size=4, num_layers=2, num_heads=4,
                 hidden_dim=256, mlp_dim=512, num_classes=100),
            JViT, ViT, ((1, 32, 32, 3),)),
    "swin": (dict(patch_size=[2, 2], embed_dim=96, depths=[1, 1],
                  num_heads=[3, 6], window_size=[4, 4], num_classes=100),
             JSwin, SwinTransformer, ((1, 32, 32, 3),)),
    "pvt": (dict(image_size=32, patch_size=4, embed_dims=[64, 128],
                 num_heads=[2, 4], depths=[1, 1], sr_ratios=[2, 1],
                 num_stages=2, num_classes=100),
            JPVT, PVT, ((1, 32, 32, 3),)),
    "twins": (dict(img_size=32, num_classes=100), JTwins, TwinSVT,
              ((1, 32, 32, 3),)),
    "tnt": (dict(image_size=32, patch_size=8, outer_dim=128, inner_dim=24,
                 outer_num_heads=4, inner_num_heads=2, num_layers=2,
                 num_classes=100),
            JTNT, TNT, ((1, 32, 32, 3),)),
    "detr": (dict(num_classes=5, num_queries=8, hidden_dim=64, nheads=4,
                  num_encoder_layers=1, num_decoder_layers=1,
                  dim_feedforward=128, dropout=0.0, backbone_norm="group"),
             JDetr, Detr, ((1, 64, 64, 3), (1, 64, 64))),
}


def _port_name(jax_path: str, port_names) -> str:
    """A JAX params path → the port's parameter name: dots for slashes, a
    Dense or conv ``kernel`` → ``weight``, a norm's ``scale`` →
    ``weight``."""
    name = jax_path.replace("/", ".")
    for leaf in ("kernel", "scale"):
        if name.endswith("." + leaf) and name not in port_names:
            name = name[: -len(leaf)] + "weight"
    return name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_partition_rules_and_audit_match_jax(family):
    cfg, jcls, tcls, sample_shapes = FAMILIES[family]
    samples = [np.zeros(s, np.float32 if len(s) == 4 else bool)
               for s in sample_shapes]
    shapes = jax.eval_shape(lambda: jcls(**cfg).init(
        {"params": jax.random.PRNGKey(0)}, *samples))["params"]
    jpaths = jmesh.tree_paths(shapes)
    jattn = jmesh.attention_prefixes(jpaths)
    model = tcls(**cfg, device="cpu")
    params = dict(model.named_parameters())
    tattn = pmesh.attention_prefixes(params)
    leaves = jax.tree_util.tree_leaves(shapes)
    seen, sharded = set(), 0
    for path, leaf in zip(jpaths, leaves):
        name = _port_name(path, params)
        jspec = tuple(jmesh.param_partition_spec(path, jattn))
        if name not in params:
            # buffers in the port (FrozenBatchNorm statistics): replicated
            assert not any(jspec), path
            continue
        seen.add(name)
        tspec = pmesh.param_partition_spec(name, tattn)
        # torch's (out, in) Dense weight: the transposed spec
        transposed = path.endswith("/kernel") and len(leaf.shape) == 2
        want = tuple(reversed(jspec)) if transposed and jspec else jspec
        assert tspec == want, (path, name, jspec, tspec)
        sharded += any(a is not None for a in tspec)
    assert seen == set(params), sorted(set(params) - seen)
    assert sharded > 0
    for min_bytes in (1 << 18, 1):  # JAX's threshold, then every leaf
        want = [_port_name(p, params) for p in jmesh.audit_tp_coverage(
            shapes, min_bytes=min_bytes)]
        got = pmesh.audit_tp_coverage(model, min_bytes=min_bytes)
        assert sorted(got) == sorted(w for w in want if w in params)
        if min_bytes > 1:
            assert got == []


def test_partition_rules_by_name():
    """JAX's rule examples (test_parallel.py:25-33, 218-245), on port
    names: Dense weights transposed, raw window kernels as they are."""
    spec = pmesh.param_partition_spec
    assert spec("encoder.layer0.self_attention.qkv.weight") == ("model", None)
    assert spec("a.b.out.weight") == (None, "model")
    assert spec("x.mlp.fc1.bias") == ("model",)
    assert spec("x.mlp.fc2.weight") == (None, "model")
    assert spec("pos_embedding") == () and spec("head.weight") == ()
    assert spec("stage0_block0.attn.qkv_kernel") == (None, "model")
    assert spec("stage0_block0.attn.qkv_bias") == ("model",)
    assert spec("s.attn.kv.weight") == ("model", None)
    assert spec("enc.layer0.linear2.weight") == (None, "model")
    names = ["s.attn.q.weight", "s.attn.proj.weight",
             "s.patch_embed.proj.weight", "w.qkv_kernel", "w.proj_kernel"]
    attn = pmesh.attention_prefixes(names)
    assert spec("s.attn.proj.weight", attn) == (None, "model")
    assert spec("s.patch_embed.proj.weight", attn) == ()
    assert spec("w.proj_kernel", attn) == ("model", None)


def test_packed_heads_per_rank():
    """A packed [q | k | v] projection gives rank r heads [r·H/tp,
    (r+1)·H/tp) of all three: the local projection is again [q | k | v]."""
    tp = pmesh.TensorParallel(group=None, size=2, rank=1)
    assert tp.blocks(8, 3).tolist() == [4, 5, 6, 7, 12, 13, 14, 15, 20, 21,
                                        22, 23]
    assert tp.blocks(6).tolist() == [3, 4, 5]
    assert pmesh.fold_seed(123, 0) == 123
    assert len({pmesh.fold_seed(123, r) for r in range(8)}) == 8
    assert tp.seed(None) is None and tp.seed(5) == pmesh.fold_seed(5, 1)


def test_one_process_helpers_and_refusals(tmp_path):
    """Without a process group the helpers are the one-process answers
    (JAX's), ``make_mesh`` says what it needs, and a JAX mesh is refused
    wherever a mesh is taken."""
    from vision_transformers_tpu_torch.utils.coco.util import misc
    from vision_transformers_tpu_torch.utils.load_data import (
        shard_for_process)
    from vision_transformers_tpu_torch.utils.metrics import SmoothedValue

    assert not torch.distributed.is_initialized()
    assert parallel.init_distributed_mode() == {
        "rank": 0, "world_size": 1, "distributed": False}
    assert parallel.get_rank() == 0 and parallel.get_world_size() == 1
    assert parallel.is_main_process()
    assert parallel.all_gather_objects({"a": 1}) == [{"a": 1}]
    assert misc.reduce_dict({"x": 2.0}) == {"x": 2.0}
    x, y = np.arange(6), np.arange(6)
    assert shard_for_process(x, y)[1] is y
    sv = SmoothedValue()
    sv.update(3.0, n=2)
    sv.synchronize_between_processes()
    assert (sv.count, sv.total) == (2, 6.0)
    with pytest.raises(ValueError, match="rank"):
        parallel.init_distributed_mode(num_processes=2, device="cpu")
    with pytest.raises(RuntimeError, match="init_distributed_mode"):
        parallel.make_mesh()
    jax_mesh = jmesh.make_mesh((8,), ("data",))
    model = ViT(image_size=16, patch_size=4, num_layers=1, num_heads=2,
                hidden_dim=16, mlp_dim=32, num_classes=4, device="cpu")
    from vision_transformers_tpu_torch import serving

    for call in (lambda: parallel.shard_params(model, jax_mesh),
                 lambda: serving.export_classifier(
                     model, (16, 16, 3), str(tmp_path), mesh=jax_mesh),
                 lambda: parallel.sequence_parallel_attention(
                     *(torch.zeros(1, 1, 4, 2),) * 3, jax_mesh)):
        with pytest.raises(TypeError, match="make_mesh's Mesh"):
            call()


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world_one():
    """A one-rank gloo group for this module; destroyed after it, so that
    no group leaks into the other tests of the process."""
    parallel.init_distributed_mode(
        coordinator_address=f"localhost:{_free_port()}", num_processes=1,
        process_id=0, device="cpu")
    yield
    parallel.destroy_distributed_mode()


_VIT = dict(image_size=16, patch_size=4, num_layers=2, num_heads=2,
            hidden_dim=32, mlp_dim=64, num_classes=4, dropout=0.1,
            attention_dropout=0.1, device="cpu")


class _Loader:
    def __init__(self, n=12, batch=4):
        rng = np.random.RandomState(0)
        self.x = rng.randint(0, 255, (n, 16, 16, 3)).astype(np.uint8)
        self.y = rng.randint(0, 4, n)
        self.batch = batch

    def __iter__(self):
        for i in range(0, len(self.y), self.batch):
            yield self.x[i:i + self.batch], self.y[i:i + self.batch]


def test_world_one_fit_is_the_fit_without_a_mesh(world_one, tmp_path):
    """At one rank the mesh step is the step without one, bit for bit
    (dropout at 0.1 included: a one-rank axis keeps the seeds), and its
    checkpoint is the same file's content."""
    from vision_transformers_tpu_torch.training import trainer
    from vision_transformers_tpu_torch.utils.checkpoint import (
        _payload, restore_checkpoint)

    runs = []
    for mesh in (None, parallel.make_mesh((1, 1), ("data", "model"))):
        model = ViT(**_VIT)
        hist = trainer.fit(model, _Loader(), _Loader(), 2, lr=1e-3,
                           mesh=mesh, verbose=False, seed=3,
                           checkpoint_dir=str(tmp_path / str(mesh is None)),
                           checkpoint_every=2)
        runs.append((hist, model.state_dict()))
    (h0, w0), (h1, w1) = runs
    for k in ("train_loss", "test_loss", "train_accuracy"):
        assert h0[k] == h1[k], k
    for k, v in w0.items():
        assert torch.equal(v, w1[k]), k
    target = trainer.make_train_state(ViT(**_VIT), lr=1e-3)
    restore_checkpoint(str(tmp_path / "False"), target)
    saved = _payload(target)
    want = _payload(h0["final_state"])
    for k, v in want["model"].items():
        assert torch.equal(saved["model"][k], v), k
    assert saved["step"] == want["step"] == 6


def test_world_one_serving_parallel_paths(world_one, tmp_path):
    """A data-parallel artifact at one rank serves the bits of the plain
    one; one pipeline stage is the forward; one ring hop is the oracle
    (and its gradients); one expert rank is the dense MoE."""
    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.ops.attention import mha_reference

    mesh = parallel.make_mesh((1,), ("data",))
    model = ViT(**dict(_VIT, dropout=0.0, attention_dropout=0.0))
    serving.export_classifier(model, (16, 16, 3), str(tmp_path / "a"),
                              buckets=(1, 4))
    serving.export_classifier(model, (16, 16, 3), str(tmp_path / "b"),
                              buckets=(1, 4), mesh=mesh)
    manifest = json.loads((tmp_path / "b" / "manifest.json").read_text())
    assert manifest["nr_devices"] == 1 and manifest["data_axis"] == "data"
    x = np.random.RandomState(1).rand(6, 16, 16, 3).astype(np.float32)
    plain = serving.load_classifier(str(tmp_path / "a"), device="cpu")
    spmd = serving.load_classifier(str(tmp_path / "b"), device="cpu",
                                   mesh=mesh)
    assert torch.equal(plain.predict(x), spmd.predict(x))

    stage = parallel.make_mesh((1,), ("stage",))
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    got = parallel.vit_pipeline_forward(model, None, torch.from_numpy(x),
                                        stage, n_micro=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    seq = parallel.make_mesh((1,), ("seq",))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 8, 4, generator=g).requires_grad_()
               for _ in range(3))
    keep = torch.arange(8)[None].expand(2, 8) < 6
    out = parallel.sequence_parallel_attention(q, k, v, seq, kv_mask=keep)
    ref = mha_reference(q, k, v, mask=keep[:, None, None, :])
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad((out ** 2).sum(), (q, k, v))
    want_g = torch.autograd.grad((ref ** 2).sum(), (q, k, v))
    for a, b in zip(grads, want_g):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)

    expert = parallel.make_mesh((1,), ("expert",))
    shapes = ((8, 4), (4, 8, 16), (4, 16), (4, 16, 8), (4, 8))
    w = [torch.randn(*s, generator=g) * 0.3 for s in shapes]
    xe = torch.randn(10, 8, generator=g)
    torch.testing.assert_close(
        parallel.expert_parallel_mlp(xe, *w, expert),
        parallel.moe_mlp_reference(xe, *w), rtol=1e-6, atol=1e-6)


def test_world_one_model_axis_changes_nothing(world_one):
    """``shard_params`` over a model axis of 1 leaves the model as it is
    (plain DP), as JAX's does; JAX's ``batch_sharding`` and ``replicated``
    name the batch split over ``data`` and the whole tensor."""
    mesh = parallel.make_mesh((1, 1), ("data", "model"))
    split, whole = parallel.batch_sharding(mesh), parallel.replicated(mesh)
    t = torch.arange(6.0)
    assert torch.equal(split.gather(split.local(t)), t) and split.size == 1
    assert whole.local(t) is t and whole.gather(t) is t
    model = ViT(**_VIT)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert parallel.shard_params(model, mesh) is model
    assert not pmesh.is_tp_sharded(model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
