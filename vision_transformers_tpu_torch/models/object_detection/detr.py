"""DETR: backbone → position encoding → input projection → transformer →
class and box heads.

Counterpart of ``vision_transformers_tpu/models/object_detection/detr.py``:
``Joiner`` (backbone ⊕ positional encoding over padded batches),
``AbsolutePositionalEncoding`` (learned row/col embeddings),
``SinePositionalEncoding`` (the DETR paper's default, mask-aware), the box
``MLP`` head, ``Detr`` and ``PostProcess`` (COCO-style scored xyxy boxes).

Module names mirror the JAX params tree (``joiner.backbone.conv1``,
``transformer.encoder.layer0.self_attn.q_proj``, ``query_embed``, ...), so
``utils.port_jax.detr_state_dict_from_jax`` is a rename and a transpose.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import (
    PARAM_DTYPE,
    DeviceLike,
    DtypeLike,
    as_dtype,
    resolve_device,
)
from vision_transformers_tpu_torch.core.initializers import normal_
from vision_transformers_tpu_torch.models.object_detection.backbone import (
    Conv,
    build_backbone,
)
from vision_transformers_tpu_torch.models.object_detection.transformer import (
    Transformer,
)
from vision_transformers_tpu_torch.ops.layers import Dense
from vision_transformers_tpu_torch.utils.coco.util.box_ops import (
    box_cxcywh_to_xyxy,
)


class AbsolutePositionalEncoding(nn.Module):
    """Learned row/col embeddings, U[0, 1) init. Emits
    (B, H, W, 2·positional_features) NHWC."""

    def __init__(self, positional_features: int = 256, max_size: int = 50, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.positional_features = positional_features
        self.row_embed = nn.Parameter(torch.empty(
            max_size, positional_features, dtype=PARAM_DTYPE).uniform_(
                0.0, 1.0, generator=generator))
        self.col_embed = nn.Parameter(torch.empty(
            max_size, positional_features, dtype=PARAM_DTYPE).uniform_(
                0.0, 1.0, generator=generator))

    def forward(self, feature_map: torch.Tensor, mask=None) -> torch.Tensor:
        b, h, w, _ = feature_map.shape
        f = self.positional_features
        x_emb = self.col_embed[None, :w, :].expand(h, w, f)
        y_emb = self.row_embed[:h, None, :].expand(h, w, f)
        pos = torch.cat([x_emb, y_emb], dim=-1)
        return pos[None].expand(b, h, w, 2 * f)


class SinePositionalEncoding(nn.Module):
    """Fixed sine position encoding normalised by the unpadded extent (the
    DETR default): padded pixels get no phantom positions. fp32."""

    def __init__(self, num_pos_feats: int = 128,
                 temperature: float = 10000.0):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature

    def forward(self, feature_map: torch.Tensor, mask=None) -> torch.Tensor:
        b, h, w, _ = feature_map.shape
        dev = feature_map.device
        if mask is None:
            not_mask = torch.ones((b, h, w), dtype=torch.float32, device=dev)
        else:
            not_mask = (~mask).float()
        y_embed = torch.cumsum(not_mask, dim=1)
        x_embed = torch.cumsum(not_mask, dim=2)
        eps = 1e-6
        scale = 2 * math.pi
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale

        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32,
                             device=dev)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                     / self.num_pos_feats)
        pos_x = x_embed[..., None] / dim_t
        pos_y = y_embed[..., None] / dim_t
        pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                            dim=-1).reshape(b, h, w, -1)
        pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                            dim=-1).reshape(b, h, w, -1)
        return torch.cat([pos_y, pos_x], dim=-1)


class Joiner(nn.Module):
    """backbone ⊕ positional encoding: per level ((features, mask), pos),
    the padding mask resized to each feature map. A missing mask is
    all-False, so every level has one (and the DETR attention always takes
    its key-padding route)."""

    def __init__(self, backbone: nn.Module, position_embedding: nn.Module):
        super().__init__()
        self.backbone = backbone
        self.position_embedding = position_embedding

    def forward(self, images: torch.Tensor, mask=None):
        xs = self.backbone(images)
        out, pos = [], []
        for name in sorted(xs):
            x = xs[name]
            if mask is not None:
                # jax.image.resize "nearest" samples pixel centres:
                # F.interpolate's nearest-exact, not its nearest
                m = F.interpolate(mask[:, None].float(), size=x.shape[1:3],
                                  mode="nearest-exact")[:, 0].bool()
            else:
                m = torch.zeros(x.shape[:3], dtype=torch.bool, device=x.device)
            out.append((x, m))
            pos.append(self.position_embedding(x, m).to(x.dtype))
        return out, pos


class MLP(nn.Module):
    """ReLU MLP head; layers registered as ``layer{i}``."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, *, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layer{i}", Dense(dims[i], dims[i + 1],
                                               dtype=dtype,
                                               generator=generator))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class Detr(nn.Module):
    """DETR with the JAX package's constructor arguments, plus ``device``
    (default CUDA; raises without one unless ``device="cpu"``) and ``seed``
    for the initial weights and the dropout generator.

    ``forward(images NHWC, pixel_mask (B, H, W) True = pad)`` →
    {'pred_logits' (B, Q, num_classes + 1), 'pred_boxes' (B, Q, 4) cxcywh
    in [0, 1], 'aux_outputs': [...] with ``aux_loss``}. Dropout acts in
    training mode (``model.train()``), its seeds drawn from
    ``dropout_generator``; the model starts in eval mode."""

    def __init__(self, num_classes: int, num_queries: int = 100,
                 hidden_dim: int = 256, nheads: int = 8,
                 num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, dropout: float = 0.1,
                 aux_loss: bool = False, backbone_arch: str = "resnet50",
                 backbone_norm: str = "frozen_bn",
                 position_embedding: str = "sine",
                 dtype: DtypeLike = torch.float32, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        if position_embedding not in ("sine", "learned"):
            raise ValueError(
                f"position_embedding {position_embedding!r}: 'sine' or "
                "'learned'")
        self.aux_loss = aux_loss
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        backbone, num_channels = build_backbone(
            arch=backbone_arch, norm=backbone_norm, return_interm_layers=True,
            dtype=dtype, generator=gen)
        pos = (AbsolutePositionalEncoding(hidden_dim // 2, generator=gen)
               if position_embedding == "learned"
               else SinePositionalEncoding(hidden_dim // 2))
        self.joiner = Joiner(backbone, pos)
        self.input_proj = Conv(num_channels, hidden_dim, 1, dtype=dtype,
                               generator=gen)
        self.transformer = Transformer(
            d_model=hidden_dim, nhead=nheads,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=dim_feedforward, dropout=dropout,
            return_intermediate_dec=aux_loss, dtype=dtype, generator=gen,
            dropout_generator=self.dropout_generator)
        self.class_embed = Dense(hidden_dim, num_classes + 1, dtype=dtype,
                                 generator=gen)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3, dtype=dtype,
                              generator=gen)
        self.query_embed = nn.Parameter(normal_(
            torch.empty(num_queries, hidden_dim, dtype=PARAM_DTYPE), 1.0, gen))
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward(self, images: torch.Tensor,
                pixel_mask: Optional[torch.Tensor] = None) -> Dict:
        features, pos = self.joiner(images, pixel_mask)
        src, mask = features[-1]          # C5 (dilated stride-16) level
        hs, _ = self.transformer(self.input_proj(src), mask, self.query_embed,
                                 pos[-1])
        logits = self.class_embed(hs)     # (L|1, B, Q, C+1)
        boxes = torch.sigmoid(self.bbox_embed(hs))
        out = {"pred_logits": logits[-1], "pred_boxes": boxes[-1]}
        if self.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": logits[i], "pred_boxes": boxes[i]}
                for i in range(logits.shape[0] - 1)]
        return out


class PostProcess:
    """Outputs → per-image COCO-style {scores, labels, boxes xyxy abs}."""

    def __call__(self, outputs: Dict, target_sizes: torch.Tensor
                 ) -> List[Dict[str, torch.Tensor]]:
        logits = outputs["pred_logits"]
        prob = torch.softmax(logits, dim=-1)
        scores, labels = prob[..., :-1].max(dim=-1)
        xyxy = box_cxcywh_to_xyxy(outputs["pred_boxes"])
        sizes = target_sizes.to(xyxy.device, xyxy.dtype)
        h, w = sizes[:, 0], sizes[:, 1]
        xyxy = xyxy * torch.stack([w, h, w, h], dim=1)[:, None, :]
        return [{"scores": scores[i], "labels": labels[i], "boxes": xyxy[i]}
                for i in range(logits.shape[0])]


def set_model_and_positional_embeddings(num_classes: int,
                                        num_queries: int = 100,
                                        **kwargs) -> Detr:
    """Reference-surface factory."""
    return Detr(num_classes=num_classes, num_queries=num_queries, **kwargs)
