"""Vanilla Vision Transformer.

Counterpart of ``vision_transformers_tpu/models/image_classification/
vanilla_vit.py``: patch embed as a matmul, learnable class token, learned
absolute positional embedding N(0, .02), pre-LN encoder blocks
(LN → MHA → dropout → residual; LN → GELU-MLP → residual), final LN and a
zero-initialised CLS head. Inputs are NHWC.

Module names mirror the JAX params tree (``conv_proj.proj``,
``encoder.encoder_layer_{i}.self_attention.qkv``, ...), so
``utils.port_jax.vit_state_dict_from_jax`` is a rename and a transpose.

Dropout randomness is explicit. The model owns one host
``torch.Generator`` (``ViT.dropout_generator``, which
``training.trainer.fit(seed=...)`` seeds). In training mode the encoder
draws from it one integer per block and forward, on the host, outside any
``torch.utils.checkpoint``; every mask of the block (the attention kernel's
and the elementwise dropouts') is a function of that integer, so a block
recomputed under ``remat`` replays its masks.

``USE_FUSED_BLOCK`` (False, as in the JAX package) sends each block's
LN → attention → residual in eval mode through ``fused_attention_block``,
one kernel launch per layer (``csrc/fused_block.cu``; its plain version on
the CPU), reading the same ``ln_1`` and ``self_attention`` parameters as the
modular branch. ``EncoderBlock._use_fused_block`` is the JAX guard less its
two TPU facts: no device test (the JAX package fuses only on a TPU) and the
port's own size rule (``fused_block_supported``) in place of the VMEM budget.

``quant8`` (serving only): every encoder block's ``qkv``, ``out``, ``fc1`` and
``fc2`` are ``ops.quant.QuantDense`` (int8 weights, activations quantized per
row at run time); the patch embedding and the head stay float, and the fused
block stays off (it reads float weights). ``serving.quantize_classifier``
makes such a model from a trained one; ``fit`` refuses it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from vision_transformers_tpu_torch.core.dtypes import (
    DeviceLike,
    DtypeLike,
    as_dtype,
    dtype_name,
    resolve_device,
)
from vision_transformers_tpu_torch.core.initializers import normal_, zeros_
from vision_transformers_tpu_torch.models.image_classification.base import (
    TrainableModel,
)
from vision_transformers_tpu_torch.ops.attention import SelfAttention
from vision_transformers_tpu_torch.ops.flash_attention import (
    fused_attention_block,
    fused_block_supported,
)
from vision_transformers_tpu_torch.ops.layers import Dense, Dropout, LayerNorm
from vision_transformers_tpu_torch.ops.mlp import MLPBlock
from vision_transformers_tpu_torch.ops.patch_embed import PatchEmbed


# The JAX package's switch (vanilla_vit.py:42): the fused attention
# sub-block for inference, off by default there and here.
USE_FUSED_BLOCK = False


class EncoderBlock(nn.Module):
    """Pre-LN transformer encoder block."""

    def __init__(self, num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0, *,
                 dtype: torch.dtype = torch.float32, quant8: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.hidden_dim = hidden_dim
        self.quant8 = quant8
        self.ln_1 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)
        self.self_attention = SelfAttention(
            hidden_dim, num_heads, attention_dropout=attention_dropout,
            dtype=dtype, quant8=quant8, generator=generator)
        self.drop = Dropout(dropout)
        self.ln_2 = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)
        self.mlp = MLPBlock(hidden_dim, mlp_dim, dropout=dropout, dtype=dtype,
                            quant8=quant8, generator=generator)

    def _use_fused_block(self, x: torch.Tensor, return_weights: bool) -> bool:
        """The JAX guard (vanilla_vit.py:56-67): the flag, not ``quant8``
        (the fused kernel reads float weights), eval mode (its
        ``deterministic``), no attention weights asked for and a 3-D input,
        within the port's size rule; and whole weights (not sharded by
        ``parallel.shard_params``: the kernel reads all heads)."""
        return (USE_FUSED_BLOCK and not self.quant8 and not self.training
                and self.self_attention.tp is None
                and not return_weights and x.ndim == 3
                and fused_block_supported(self.hidden_dim, self.num_heads))

    def forward(self, x: torch.Tensor, return_weights: bool = False,
                seed: Optional[int] = None):
        """``seed``: the block's dropout seed for this forward (training
        only); its masks are made from seed .. seed + 3."""
        weights = None
        sub = (lambda i: None) if seed is None else (lambda i: seed + i)
        if self._use_fused_block(x, return_weights):
            # one launch for LN + QKV + attention + out-projection +
            # residual; the weights are cast per call, as the modular
            # branch's Dense casts them, and read in torch's (out, in)
            # layout through a transposed view
            attn = self.self_attention
            dt = attn.qkv.dtype
            x = fused_attention_block(
                x.to(dt), self.ln_1.weight.float(), self.ln_1.bias.float(),
                attn.qkv.weight.to(dt).t(), attn.qkv.bias.float(),
                attn.out.weight.to(dt).t(), attn.out.bias.float(),
                self.num_heads, (self.hidden_dim // self.num_heads) ** -0.5,
                self.ln_1.eps)
        else:
            y = self.ln_1(x)
            if return_weights:
                y, weights = self.self_attention(y, return_weights=True,
                                                 seed=sub(0))
            else:
                y = self.self_attention(y, seed=sub(0))
            x = x + self.drop(y, sub(1))
        out = x + self.mlp(self.ln_2(x), sub(2))
        if return_weights:
            return out, weights
        return out


class Encoder(nn.Module):
    """Stack of encoder blocks with a learned absolute position embedding.
    Blocks are registered as ``encoder_layer_{i}`` (the JAX names)."""

    def __init__(self, seq_length: int, num_layers: int, num_heads: int,
                 hidden_dim: int, mlp_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, remat: bool = False, *,
                 dtype: torch.dtype = torch.float32, quant8: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None):
        super().__init__()
        self.remat = remat
        self.has_dropout = dropout > 0.0 or attention_dropout > 0.0
        self.dropout_generator = (torch.Generator() if dropout_generator is None
                                  else dropout_generator)
        self.pos_embedding = nn.Parameter(normal_(
            torch.empty(1, seq_length, hidden_dim), 0.02, generator))
        self.drop = Dropout(dropout)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"encoder_layer_{i}", EncoderBlock(
                num_heads, hidden_dim, mlp_dim, dropout, attention_dropout,
                dtype=dtype, quant8=quant8, generator=generator))
        self.ln = LayerNorm(hidden_dim, eps=1e-6, dtype=dtype)

    def forward(self, x: torch.Tensor, return_weights: bool = False):
        seeds = [None] * (self.num_layers + 1)
        if self.training and self.has_dropout:
            # one host draw per forward: no device synchronisation
            seeds = torch.randint(0, 2 ** 62, (self.num_layers + 1,),
                                  generator=self.dropout_generator).tolist()
        x = self.drop(x + self.pos_embedding.to(x.dtype), seeds[-1])
        all_weights = []
        for i in range(self.num_layers):
            block = getattr(self, f"encoder_layer_{i}")
            if return_weights:
                x, w = block(x, True, seeds[i])
                all_weights.append(w)
            elif self.remat and self.training:
                # recompute blocks in the backward: FLOPs for activation
                # memory; the seed goes in, so the recompute replays it
                x = torch.utils.checkpoint.checkpoint(
                    block, x, False, seeds[i], use_reentrant=False)
            else:
                x = block(x, False, seeds[i])
        x = self.ln(x)
        if return_weights:
            return x, all_weights
        return x


class ViT(nn.Module, TrainableModel):
    """ViT classifier with the JAX package's constructor arguments, plus
    ``device`` (default CUDA; raises without one unless ``device="cpu"``)
    and ``seed`` for the initial weights. ``dtype`` is the compute dtype;
    parameters are fp32. ``quant8`` builds the int8 serving model (the
    module's docstring). ``config`` holds the constructor kwargs that
    rebuild the model (serving's manifest stores them).
    ``train_model(model, train_loader, test_loader, epochs, val_loader)``
    trains it through ``training.trainer.fit``."""

    def __init__(self, image_size: int, patch_size: int, num_layers: int,
                 num_heads: int, hidden_dim: int, mlp_dim: int,
                 dropout: float = 0.0, attention_dropout: float = 0.0,
                 num_classes: int = 1000, remat: bool = False,
                 dtype: DtypeLike = torch.float32, quant8: bool = False,
                 in_channels: int = 3, *, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        if image_size % patch_size:
            raise ValueError("Input shape indivisible by patch size!")
        device = resolve_device(device)
        dtype = as_dtype(dtype)
        self.config: Dict[str, Any] = dict(
            image_size=image_size, patch_size=patch_size,
            num_layers=num_layers, num_heads=num_heads,
            hidden_dim=hidden_dim, mlp_dim=mlp_dim, dropout=dropout,
            attention_dropout=attention_dropout, num_classes=num_classes,
            remat=remat, dtype=dtype_name(dtype), in_channels=in_channels)
        if quant8:  # a float model's config (and manifest) stays as it was
            self.config["quant8"] = True
        self.hidden_dim = hidden_dim
        self.quant8 = quant8
        gen = torch.Generator().manual_seed(seed)
        self.dropout_generator = torch.Generator().manual_seed(seed)
        seq_length = (image_size // patch_size) ** 2 + 1
        self.conv_proj = PatchEmbed(hidden_dim, patch_size, in_channels,
                                    dtype=dtype, generator=gen)
        self.class_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.encoder = Encoder(
            seq_length, num_layers, num_heads, hidden_dim, mlp_dim, dropout,
            attention_dropout, remat, dtype=dtype, quant8=quant8,
            generator=gen, dropout_generator=self.dropout_generator)
        self.head = Dense(hidden_dim, num_classes, dtype=dtype,
                          weight_init=zeros_, bias_init=zeros_)
        self.to(device)
        self.eval()  # the JAX package's default is deterministic=True

    def forward_features(self, images: torch.Tensor,
                         return_weights: bool = False):
        tokens, _ = self.conv_proj(images)
        cls = self.class_token.to(tokens.dtype).expand(
            tokens.shape[0], 1, self.hidden_dim)
        tokens = torch.cat([cls, tokens], dim=1)
        return self.encoder(tokens, return_weights)

    def forward(self, images: torch.Tensor, return_weights: bool = False):
        if return_weights:
            feats, weights = self.forward_features(images, True)
            return self.head(feats[:, 0]), weights
        return self.head(self.forward_features(images)[:, 0])
