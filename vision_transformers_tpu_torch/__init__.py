"""PyTorch/CUDA port of ``vision_transformers_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's paths and names, so each module's
counterpart is easy to find. The JAX package stays the numerical
reference; this one imports nothing from it (nor JAX itself).

What is ported so far is the ViT serving path:

- ``models.image_classification.ViT``: patch embed, class token, learned
  position embedding, pre-LN encoder blocks, CLS head; inputs are NHWC.
- ``ops``: LayerNorm, GELU-MLP, patch embedding, and attention through two
  hand-written CUDA kernels (``csrc/``): self attention read in place from
  the packed QKV projection, and split-head attention with an additive bias.
  Each kernel has a plain PyTorch version beside it, used for CPU tensors.
- ``serving``: export to an artifact directory, ``load_classifier``, static
  batch buckets and a request micro-batcher.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of running on
the CPU quietly.
"""

__version__ = "0.1.0"
