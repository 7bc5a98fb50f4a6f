"""PyTorch/CUDA port of ``vision_transformers_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's paths and names, so each module's
counterpart is easy to find. The JAX package stays the numerical
reference; this one imports nothing from it (nor JAX itself).

It covers what the JAX package does: the classification zoo and DETR,
each served and trained, the training CLI, and the parallel paths:

- ``models.image_classification.ViT``: patch embed, class token, learned
  position embedding, pre-LN encoder blocks, CLS head; inputs are NHWC;
  ``train_model`` through the shared trainer.
- ``models.image_classification.SwinTransformer`` and
  ``SwinTransformerV2``: patch embedding, four stages of shifted-window
  attention blocks with patch merging, pooled head.
- ``models.image_classification.PVT`` and ``TwinSVT``: pyramid stages of
  spatial-reduction attention (``ops.sra``), Twins alternating it with
  locally-grouped window attention and a depthwise-conv position encoding.
- ``ops``: LayerNorm, GELU-MLP, seeded dropout, patch embedding, and
  attention through hand-written CUDA kernels (``csrc/``), forward and
  backward: self attention read in place from the packed QKV projection
  with in-kernel dropout, split-head attention with dropout and a
  key-padding mask, split-head attention with an additive bias, and four
  window-attention kernels with their shared backward behind
  ``ops.windows.shifted_window_attention``. Each kernel has a plain PyTorch
  version beside it, used for CPU tensors.
- ``training``: ``make_optimizer`` and ``cosine_schedule`` with optax's
  arithmetic, the opt-in single-pass Adam kernel (``ops.fused_adam``,
  ``make_optimizer(fused=True)``), and ``trainer.fit`` with its train and
  eval steps.
- ``parallel``: ``torch.distributed`` initialization (NCCL on CUDA, gloo
  on the CPU), a mesh of ranks with named axes (``make_mesh``), DP and
  Megatron TP in ``fit`` and DP in ``fit_detection``, ring attention
  (``sequence_parallel_attention``), GPipe (``pipeline_apply``,
  ``vit_pipeline_forward``) and a top-1 MoE over an expert axis.
- ``serving``: export to an artifact directory, ``load_classifier``, static
  batch buckets, data-parallel artifacts over a mesh and a request
  micro-batcher.
- The rest of the zoo (``DeiT``, ``CPEViT``, ``T2T_ViT``, ``CPVT``,
  ``CPVTGAP``, ``TNT``) and DETR-R50 (``models.object_detection``,
  ``training.detection``, the COCO dataset in ``utils.coco``).
- ``cli``: the training CLI (``python -m vision_transformers_tpu_torch.cli
  <preset>``) over ``utils.load_data`` (local CIFAR and image folders, the
  fused C++ augmentation of ``native``), ``utils.checkpoint``,
  ``utils.distillation_loss`` and ``training.device_data`` (on-device
  epochs).
- int8 (w8a8) serving of the ViT (``ops.quant``,
  ``serving.quantize_classifier``, ``--export-int8``); reference and
  torchvision checkpoints (``utils.port_torch``, ``--init-from-torch``);
  superleaf Adam (``training.superleaf``), the hyperparameter search
  (``utils.optimization``) and the plots (``utils.visualization``).

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise instead of running on
the CPU quietly.
"""

__version__ = "0.1.0"
