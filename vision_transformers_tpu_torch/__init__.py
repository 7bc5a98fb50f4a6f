"""PyTorch/CUDA port of ``vision_transformers_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's paths and names, so each module's
counterpart is easy to find. The JAX package stays the numerical
reference; this one imports nothing from it (nor JAX itself).

What is ported so far is the ViT main path, served and trained:

- ``models.image_classification.ViT``: patch embed, class token, learned
  position embedding, pre-LN encoder blocks, CLS head; inputs are NHWC;
  ``train_model`` through the shared trainer.
- ``ops``: LayerNorm, GELU-MLP, seeded dropout, patch embedding, and
  attention through hand-written CUDA kernels (``csrc/``), forward and
  backward: self attention read in place from the packed QKV projection
  with in-kernel dropout, split-head attention with dropout and a
  key-padding mask, and split-head attention with an additive bias. Each
  kernel has a plain PyTorch version beside it, used for CPU tensors.
- ``training``: ``make_optimizer`` and ``cosine_schedule`` with optax's
  arithmetic, and ``trainer.fit`` with its train and eval steps.
- ``serving``: export to an artifact directory, ``load_classifier``, static
  batch buckets and a request micro-batcher.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of running on
the CPU quietly.
"""

__version__ = "0.1.0"
