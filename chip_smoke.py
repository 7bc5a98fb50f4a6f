#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vision_transformers_tpu_torch``) on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a nonzero
exit, and without the final result line:

1. Device and build: the card's name and power limit, then every CUDA
   kernel of the port built from ``vision_transformers_tpu_torch/csrc``
   (one ``nvcc`` per source, all in parallel), and the registers, shared
   memory, stack and spills ``-Xptxas -v`` gives the kernels of rows 1-15;
   the kernels of rows 1-8 and 14, on both routes, and the window kernels
   whose text did not change when rows 9-13 took the tensor cores (rows
   9-13 in fp32, and rows 9 and 10's tensor-core kernels, which rows 11-13
   joined on their tile), must keep their
   registers (``KEPT_REGISTERS``), and the fp32 fused sub-block (row 8's
   CUDA-core route) must read its workspaces through L2 (``cuobjdump
   -sass``: its .CONSTANT loads, beside their count before the repair, and
   its .STRONG.GPU ones).
2. Kernels against their plain PyTorch versions, on the card, in bf16 and
   fp32, at the shapes the serving and training paths give them; the
   dropout and backward kernels at rate 0 and 0.1 under one seed (so both
   sides drop the same probabilities), the measured keep rate, the
   gradient through forward and backward of one seed against autograd of
   the plain forward, and bit-equal gradients from two runs. The four
   window kernels at the shapes of Swin-T's and SwinV2-T's stages at batch
   32 and of a CIFAR window, with a shared and a per-window bias, the
   packed one also at N 100 and 128, dh 64; the two
   fused ones with and without a shift into an output pre-filled with NaN
   (every element must be written), reruns bit-equal, and against each
   other on one map; in
   bf16 each is also bit-equal to its plain version but for a small share
   of elements, since both round the probabilities where the TPU kernels do.
   The window backward kernel at the same stage shapes (shared, per-window
   and no bias, with and without the bias gradient, dh 16/32/64, N 100 and
   128) against
   its plain version and, in fp32, against autograd of the plain forward,
   into a dqkv pre-filled with NaN, twice for equal bits; gradients through
   the two fused kernels' autograd function against autograd of their plain
   version, each fused check beside a planted fault (the plain output with
   key 0 of the last window of the map hidden) that must exceed its limit;
   the multi-tensor Adam kernel (one launch a step) over leaves on both
   sides of 65 536 elements, one not 16-byte aligned, more leaves than one
   launch's table, and over the parameter lists of Swin-T and ViT-B/16,
   against its plain version, in place, bit-equal. The streaming forward
   (``flash_attention_large``) at the DETR-R50 encoder's eval shape (batch
   4 at the 896 x 1344 bucket: G 32, S 4704, D 32, the key masks of four
   unequal COCO images), the decoder's cross shape (Sq 100, Sk 4704) and a
   bias-free, mask-free ViT-B shape at S 1297, with ``kv_valid`` < Sk, into
   an output pre-filled with NaN, twice for equal bits, and an image whose
   keys are all masked against ``mha_reference``; the small-S backward
   (``flash_attention_bwd``) at the DETR decoder's self attention, at
   ViT-B/16's S 197 and at ragged, cross and ``kv_valid`` shapes against its
   plain version (bf16 on the tensor cores by name in the launch log, to
   ``MMA_GRAD_TOL``), the row-6 kernel at rate 0 and, in fp32, autograd of
   the plain forward, into NaN-filled gradients, twice for equal bits. The
   fused LayerNorm + Dense (``ln_dense``) at benchmarks/ln_fused.py's ViT-B
   shapes at batch 32 ([ln_1 + QKV] and
   [ln_2 + fc1 + GELU], ragged R and N without a bias, erf GELU), in bf16
   and fp32, each beside a planted fault (the plain output with one 16-wide
   k slice left out) that must exceed its limit, torch's (out, in) weight
   bit-equal to the (in, out) one, and the fused attention sub-block
   (``fused_attention_block``) at ViT-B/16, DeiT-B, T2T-ViT-14 and bucket
   1, into NaN-filled outputs, twice for equal bits, torch's (out, in)
   weights bit-equal to the (in, out) ones, beside a planted fault (one
   16-wide k slice of Wout left out); gradients through both autograd
   functions in fp32. Rows 1-14: bf16 launches go
   through the tensor-core kernels and fp32 ones through the CUDA-core
   kernels, by the kernels' names in the libraries' launch logs (here, and
   rows 9-13 on the Swin-T,
   SwinV2-T and Twins-SVT-S served forwards of phases 5 and 6 and their
   train steps of phase 6, each row its forwards launch, row 10 in every
   step, and
   on the served ViT-B/16 forward of phase 3, the split-head forward of
   phase 4, the ViT-B/16 train step (rows 1 and 7) and the split-head train
   steps of phase 6, every flag-on forward of the ViT family (row 8) and the
   ln_fused chain in phase 6g, and the DETR eval forwards and train steps
   of phase 7, row 4 in the step at dropout 0); rows 1 and 7 in bf16 at the
   ViT paths' shapes (ViT-B/16 and
   T2T-ViT-14 at batch 32, vit_tiny at 64; rate 0 and 0.1) into NaN-filled
   outputs, reruns bit-equal, beside a planted fault (the plain output, or
   gradients, under the next seed's mask); the bf16
   kernels at the paths' own shapes (row 2 at the DETR decoder's self
   attention, G 32, S 100, D 32, with and without a bias; row 6 at the DETR
   encoder, G 16, S 4704, D 32, with the key masks of two COCO images at
   rate 0.1, and at PVT stage 1, G 32, Sq 3136, Sk 49, D 64; row 5 at the
   DETR encoder and cross shapes in training, G 16, Sk 4704, two COCO masks,
   rate 0.1; row 3 also at T2T-ViT_t-14's token transformer, G 32, S 3136,
   D 64) against their plain versions, twice for equal bits, each beside a
   planted fault (the plain output with one live key tile hidden) that must
   exceed its limit; and the skipped key tiles of rows 3 and 5: keys hidden
   from a 64-key boundary on give out and lse bit-equal to the call on K/V
   truncated there, and the kernel's own tile counters show it walked only
   the tiles below the boundary. Rows 2, 5 and 6 at TNT's two attentions at
   batch 256 (inner G 16384, S 4, D 12, a padded tile; outer G 1024, S 17,
   D 128), bf16 and fp32, rates 0 and 0.1, row 2 with and without a bias,
   into outputs, lse and gradients pre-filled with NaN, lse against the
   plain version, reruns bit-equal, every launch by kernel name.
3. Main path: ViT-B/16 @224 (``vitb16_224_imagenet``, full width, weights
   from a seeded numpy draw, head included) served in bf16 through
   ``export_classifier`` → ``load_classifier`` → ``warmup`` → ``predict``
   (n = 1, 5, 8, 40) → 16 concurrent ``Microbatcher.submit`` calls. The
   packed kernel must launch 12 times per forward. Served logits are held
   against the same weights run on the CPU through the plain versions.
3b. int8 serving: the same float model through ``quantize_classifier`` →
   ``export_classifier`` → ``load_classifier`` → ``predict`` at buckets 1,
   8 and 32 with ``USE_FUSED_BLOCK`` on: per forward 12 row-1 launches (by
   name), no row-8 launch and 48 int8 products (``ops/quant.py``,
   ``torch._int_mm``); reruns bit-equal; logits against the same artifact
   served on the CPU (``INT8_CPU_TOL_REL``) and features against the float
   model on the card (``INT8_FEATURE_REL``); ``int8_matmul`` on the card
   bit-equal to the CPU at 5 rows (padded to 17), at ViT-B's fc1 and at K
   100, N 36 (zero-padded to multiples of 8); ms per request at each
   bucket, images/s at 32, forward device time and idle share, int8 and
   bf16 in turns.
4. Split-head path: a 2-layer ViT-B-width model at 512 px (S = 1025, where
   ``packed_flash_supported`` is false), through the split-head kernel.
5. Window path: ``swint_224_imagenet`` and ``swinv2t_224_imagenet`` (full
   width and depth, seeded weights) served in bf16 through the same entry
   points at buckets 1, 8 and 32. Per forward Swin-T must launch the
   batched window kernel 4 times, the fused slab kernel once and the fused
   flat kernel 7 times; SwinV2-T the batched kernel 4 times and the packed
   kernel 8 times; at every bucket, and no other attention kernel. Logits
   against the same weights on the CPU (bf16 served, and an fp32 model).
6. Training paths. ``ViT.train_model`` on ``vit_tiny_cifar100`` (full size,
   fp32, dropout 0.1, a seeded colour-class loader with a ragged last
   batch) for 3 epochs; 3 Adam steps of ViT-B/16 @224 in bf16 at batch 32
   with ``attention_dropout=0.1`` and the step's split into forward,
   backward and optimizer, and the tensor-core packed backward (row 7) fed
   the tensor-core forward's out and lse on the first layer's projection of
   the batch, against its plain version at rate 0.1; 3 superleaf Adam steps
   (``training/superleaf.py``) of the same model and batch, one row-15
   launch a step, the flat buffers bit-equal to ``fused_adam_reference`` on
   the step's flat gradient and the parameters bit-equal to
   ``make_optimizer(fused=True)`` under the same dropout seeds, with host
   clock, optimizer device time and idle share beside the per-leaf step's;
   one step each with and without dropout of the
   2-layer model at 512 px (the split-head kernels); and fp32 gradients of
   a 2-layer model on the card against the CPU run of the same weights.
   Then the windowed models' training: ``swint_224_imagenet`` and
   ``swinv2t_224_imagenet`` (full width and depth, bf16, batch 32) through
   ``make_train_state`` and ``train_step_fn`` with
   ``make_optimizer("adam", fused=True)`` and with ``fused=False``: per step
   the 12 forward window launches of phase 5, 12 ``window_attention_bwd``
   launches, one ``fused_adam`` launch (``adam_multi_kernel``), and no other kernel
   of the table; the loss of the batch in eval mode must fall; the step's
   split and a profile; fp32 gradients of narrow 2-stage Swin and SwinV2
   models on the card against the CPU; ``train_model`` on
   ``swin_tiny_cifar100``. ``pvt_tiny224_imagenet`` and
   ``twins_svts224_imagenet`` served in bf16 (buckets 1 and 32, logits
   against the CPU) and trained for a few steps, with the kernels they
   launch and Twins' window routes. Then the ViT family on the
   ``USE_FUSED_BLOCK`` path: ViT-B/16, DeiT-B, CPE-ViT-B, T2T-ViT-14 and
   T2T-ViT_t-14 @224 (weights drawn into the JAX params layout, loaded
   through ``utils/port_jax.py``'s converters) served in bf16 at buckets 1,
   8 and 32 with the flag on (exactly 12, 12, 12, 14 and 14
   ``fused_attention_block`` launches per forward, no packed launch; the
   T2T_t one also 1 streaming and 1 split-head launch for its token
   transformer), then off (the packed kernel per layer), logits against
   each other and the CPU, fp32 on the card against the CPU; the three new
   models trained for 3 Adam steps in bf16 at batch 32 with the flag on (no
   fused launch in training mode, the batch's eval loss falls); and
   benchmarks/ln_fused.py's fused chain (12 layers, ``ln_dense`` twice per
   layer) against its library chain.
7. Detection: ``Detr(num_classes=91, aux_loss=True)`` (DETR-R50 DC5, full
   width and depth, weights drawn from a seed into the JAX package's params
   layout and loaded through ``detr_state_dict_from_jax``) on synthetic
   COCO-sized images. Eval in bf16 and fp32, batch 4 at the 896 x 1344
   bucket (4704 C5 tokens), through ``DetectionLoader`` → ``evaluate_model``
   with ``PostProcess``: exactly 12 streaming and 6 split-head launches per
   forward and no other kernel; forward time, images/s and a profile; fp32
   outputs against the CPU run of the same weights on one image padded to
   512 x 640. Training through ``fit_detection``, 3 steps at batch 2 on the
   same bucket, bf16: at dropout 0.1 18 dropout forward and 18 dropout
   backward launches per step; at dropout 0 with ``USE_PALLAS_BWD`` 12
   streaming, 6 split-head, 6 small-S backward and 12 row-6 backward
   launches per step; in both the batch's eval-mode loss must fall; the
   step's split and a profile. fp32 parameter gradients of a narrow DETR
   (hidden 32, 1 + 2 layers, full ResNet-50, 128 x 160) on the card against
   the CPU, with the diagnosis of their largest difference (the
   pre-activations of the ReLU after ``layer4_block2.conv1`` within rounding
   of 0 and on opposite sides on the two devices, and that weight gradient
   recomputed on the card with each device's ReLU mask); the auction's
   assignment on the step's cost against scipy's.
   One forward of the ViT-B backbone variant at the same bucket (24
   streaming launches: 12 unmasked in the backbone at S 4704, 12 masked).
7b. The training CLI (``vision_transformers_tpu_torch.cli.main``) on a
   synthetic CIFAR-100 in the real pickle format (4096 + 1024 images of
   colour classes), batch 256, 2 epochs, each run by kernel name over the
   whole run and its train loss falling: ``vit_tiny_cifar100`` in fp32 with
   a checkpoint each epoch (the latest restored bit-equal to the final
   state) and an ``--export-int8`` export (served, equal to the quantized
   trained model); ``vit_tiny_cifar100`` and ``swin_tiny_cifar100`` with
   ``--init-from-torch`` from reference-layout checkpoints written from a
   seed (the first forward's weights equal to the checkpoint loaded by
   hand); ``utils.optimization.run_study`` with 2 trials of ``objective``;
   ``vit_tiny_cifar100`` with ``--on-device`` and with ``--bf16``;
   ``cpvt_cifar100``, ``cpvtgap_cifar100`` (rows 1 and 7) and ``tnt_cifar100`` (rows 2 and 6 at
   D 128 and, padded, at D 12; 14 row-2 launches a forward, 14 row-2 and 14
   row-6 a step) in fp32 and bf16; ``swin_tiny_cifar100`` (rows 9-13);
   ``run_reference_main(fused=True)`` (row 15, one launch a step); DeiT-Ti
   distilled from a seeded ViT teacher; ViT-Ti/16 on an image folder of PNGs
   (``ImageFolderLoader``); ``run_detection_main`` (DETR-R50, 2 steps at
   batch 2 on a COCO folder with boxes, polygons and both RLE forms). The
   fused C++ augmentation must have built.
7c. Parallel at one rank: ``parallel.init_distributed_mode`` under
   torchrun's environment (set by the phase) joins an NCCL group of 1, and
   every mesh path runs its collectives there with the kernels on, each
   run's launch counts zeroed before and read after it: ``fit`` of
   ViT-B/16 @224 (bf16, batch 32, 3 steps and an eval batch, attention
   dropout 0.1, fused Adam) on a (1, 1) data × model mesh, its losses and
   weights bit-equal to ``mesh=None`` (rows 1, 7 and 15 by name); the step
   with and without the mesh by the host clock and the gradient all-reduce
   alone; ``fit_detection`` of DETR-R50 (one step at batch 2, 896 x 1344,
   dropout 0.1 and 0 with ``USE_PALLAS_BWD``: rows 5, 6 and 2, 3, 4, 6)
   on a (1,) data mesh, bit-equal to ``mesh=None``; data-parallel serving
   artifacts of ViT-B/16 and its int8 twin at buckets 1, 8 and 32, predict
   bit-equal to the artifacts without a mesh; ``vit_pipeline_forward`` with
   one stage, bit-equal to the forward; ring attention at the DETR
   encoder's shape (B 2, H 8, S 4704, D 32, COCO key masks, one hop)
   against ``mha_reference`` with its time beside row 3's; the MoE against
   its dense oracle. The multi-rank runs are the CPU tests' (NCCL takes no
   two ranks on one card).
7d. Rows 1-7 at every head dim, and ViT-H/14 (Dosovitskiy et al. 2020,
   Table 1: 32 layers, hidden 1280, MLP 5120, 16 heads of dh 80, patch 14;
   built from ``ViT`` keyword arguments, seeded weights). Each row's kernel
   against its plain version in bf16 and fp32 (``KERNEL_TOL``, gradients
   ``MMA_GRAD_TOL`` / ``GRAD_TOL`` times max(1, max|ref|)), into outputs
   pre-filled with NaN, reruns bit-equal, the route by kernel name (rows 1
   and 7 at any dh but 16, 32 and 64 and rows 3 and 4 at any D but 16, 32,
   64 and 128 in their ``*_padded_kernel`` kernels): rows 1 and 7 at
   ViT-H/14 @224 (B 32, S 257, H 16, dh 80) and at dh 12, 96, 128 and 77,
   rate 0 and 0.1 (same-mask oracle, beside a planted fault: the next
   seed's mask); rows 2, 5 and 6 at ViT-H/14 @336 (B 4, H 16, S 577, D 80;
   384 px is no multiple of the patch, 336 px gives the same S 577) and at
   D 77 with a key mask; row 3 at ViT-H/14 @518 (S 1370, D 80, no mask), at
   the DETR encoder's masked shape (B 4, H 8, S 4704, COCO masks) with D 80
   and at D 12, 128 and 77; row 4 at ViT-H/14 @224's split-head shape (B 2,
   H 16, S 257, D 80, the fp32 kernel's K and V resident) and at D 12, 128
   and 77. Each row's time at dh 80 (bf16) beside its bound, its plain
   version and SDPA. Then ViT-H/14 at full width and depth in bf16 through
   ``export_classifier`` → ``load_classifier`` → ``predict``: @224 at
   buckets 1 and 32 (32 row-1 launches a forward), @336 and @518 at bucket 4
   (32 row-2 and 32 row-3 launches), each route by name, ms per request,
   forward device time and idle share; 2 layers at full width in fp32 on the
   card against the CPU's plain versions (``LOGIT_TOL_FP32``); the
   full-depth bf16 forward finite and its argmax against the full-depth fp32
   card forward on 64 seeded images (``VITH_ARGMAX_FLOOR``); 3 fused-Adam
   steps at 224 px, batch 8, attention dropout 0.1 on one batch, the loss
   falling (32 row-1 and 32 row-7 launches a step, row 15), the step's ms
   and idle share; one step at 336 px, batch 2, at rate 0 (rows 2 and 6)
   and 0.1 (rows 5 and 6).
7e. Rows 1-7 above head dim 128 and rows 9-13 at dh 1, 2, 4 and 8. Rows
   1-7 (their ``*_wide_kernel`` kernels, the head dim split across the
   grid) against their plain versions as in 7d (``RowChecks``) at D 129,
   160, 200, 256 and 512 in bf16 and fp32, rates 0 and 0.1, row 3 with key
   masks, row 4 at S 256 (its route, the JAX score budget, admits it at
   every D), and at the shapes of ViT-B/16's widths at 3 heads (dh 256): B
   32, S 197 (rows 1, 7), B 4, S 785 (rows 2, 5, 6), B 2, S 1297 (row 3), B
   32, S 64 (row 4; phase 7f takes S 197). Rows 9-13 (their tensor-core
   kernels in bf16, dh 1-8 in the 16 tile, and the CUDA-core ones in fp32)
   at dh 1, 2, 4 and 8 at Swin-T's stage shapes with heads C / dh (batch 4): the packed and batched forwards and the backward
   with dbias (dqkv NaN-filled) at stages 1 and 4, the slab and flat fused
   forwards at stages 1 and 2 (NaN-filled), reruns bit-equal, routes by
   name. Each row's time at those model shapes (bf16) beside its bound, its
   plain version and SDPA. Then ViT-B/16's widths at 3 heads
   (``VITB3``, seeded weights) in bf16: served @224 at buckets 1 and 32
   (12 row-1 launches a forward), trained @224 at batch 32 with attention
   dropout 0.1 (3 fused-Adam steps, the loss falling; rows 1, 7, 15),
   served @448 at bucket 4 (row 2) and trained at batch 2, rate 0.1 (rows 5,
   6; the loss falling), served @576 cut to 2 layers at bucket 2 (row 3), 2
   layers in fp32 against the CPU; Swin-T's widths at 4x its heads
   (``SWIN_T4_HEADS``, dh 8) served at buckets 1 and 32 (4 batched, 1 slab,
   1 packed window forward and 6 split-head launches a forward, the JAX
   package's routes), trained at batch 32 (3 fused-Adam steps, the loss
   falling; row 10 six times a step), in fp32 against the CPU; ms per
   request, forward device time, step ms and idle shares.
7f. Row 8 at every head dim and row 4 at every shape its route sends it
   (``fused_phase``). Row 8 at dh 12, 48, 80, 96, 160 and 256
   (``BLOCK_HEAD_DIMS``: the 16, 64 and 128 tiles and the wide one) at B 8,
   S 197 and at ViT-B3's B 32, in bf16 (``fused_block_mma_padded_kernel``,
   ``fused_block_mma_wide_kernel``) and fp32 (``fused_block_padded_kernel``,
   ``fused_block_wide_kernel``), by kernel name: into NaN-filled outputs
   against the plain version, reruns and torch's (out, in) weights
   bit-equal, the tensor-core route's four phases bit-equal to its one
   launch, beside a planted fault (a 16-wide k slice of Wout inside the
   width left out). Row 4 at ``ROW4_SHAPES`` (G 96, S 197, D 256; G 16, S
   512, D 128 and 256) in both dtypes as in 7d (fp32 at S 512, D 128: the
   streaming passes), and ``flash_attention``'s autograd backward at
   ViT-B3's split heads under ``USE_PALLAS_BWD`` by name (row 4, no row
   6). Times (bf16; row 4 also fp32) beside bound, plain and library: row 8
   at B 32, S 197 at dh 256 (with its phases' device times), 48, 96 and 80,
   row 4 at the three shapes. ViT-B3 served @224 at buckets 1 and 32 with
   ``USE_FUSED_BLOCK`` on (12 row-8 launches a forward on
   ``fused_block_mma_wide_kernel``, no row 1) and off (12 row-1), the
   flag-on logits within ``LOGIT_TOL_BF16_REL`` of max|logit| of flag off,
   ms per request, device ms and idle share of both in one process; 2
   layers in fp32 flag on against the CPU (``FUSED_LOGIT_TOL_FP32``); the
   2-layer probes of ``FUSED_PROBES`` (dh 48 and 96) at batch 8, flag on
   against off by the same bound, their route by name.
7g. Rows 11 and 10 at every head dim the JAX batched plan admits
   (``window_head_dims_phase``): the batched forward and the backward with
   and without dbias at ``WINDOW_OTHER_SHAPES`` (dh 12, 24, 48, 80, 96,
   128, 192 and 256 at N 49; N 16, 64 and 128 at a dh of each tile; ragged
   G; dh 12's sections 8-byte aligned only) and at the largest dh the plan
   admits at one head (``WINDOW_LARGEST``: 1534 and 532 in bf16, 919 and
   318 in fp32, one more refused), in bf16 (the padded tiles 16-64, the
   64-column chunks above) and fp32 (the 32-column chunks), by kernel name:
   against the plain versions, every element written (dqkv NaN-filled, the
   forward's out in a freed NaN-filled block it must take, by address),
   reruns bit-equal, each
   beside a planted fault (key 0 of the last window hidden from its
   queries). At H·dh 2176 (68 heads of 32, N 49, bf16) the batched plan
   refuses and the block takes the packed kernel, at 2144 the batched one,
   as the JAX plans decide. Times (bf16 at Swin-T's stage 1, G 2048, H·dh 96
   at dh 48 and 96, and dh 192; fp32 at dh 48) beside bound, plain and SDPA
   (its backward with the mask). Swin-T's widths at 2 heads a stage
   (``SWIN_T_FEWER_HEADS``, dh 48) served @224 at buckets 1 and 32 (4
   batched and 8 split-head launches a forward, the JAX routes), trained
   at batch 32 (3 fused-Adam steps, the loss falling; row 10 four times a
   step), in fp32 at batch 2 against the CPU; at 1 head a stage (dh 96)
   served at bucket 32; ms per request, device ms, step ms, idle shares.
7h. Row 16, the biased split-head backward (``bias_bwd_phase``, callable
   alone: ``python -c 'import chip_smoke as c; c.bias_bwd_phase()'``) at
   SwinV2-B @256 w16's stage 1 at batch 128 (G 2048 windows of 4 heads, N
   256, dh 32), the bias shared by the windows (bias_g = H) and, shifted,
   one a window (16·H): its route by kernel name, bit-equal reruns, its
   error against the plain version held to the card tests' limits (one
   bf16 step at the largest element, at most 1e-3 of the elements over one
   step of their own, dbias 1e-5 of its largest), beside a planted fault (p
   and dS rounded once to bf16) that those limits must fail, and its time
   beside its bound, the plain version's and SDPA's autograd backward with
   the bias as a mask that takes a gradient (the library yardstick, timed
   here alone); then one bf16 train step of SwinV2-B @256 w16 at batch 8,
   whose 22 biased backwards must each launch the kernel (none plain on the
   card): row 16's launches on the main path.
8. Times: serving latency per bucket (the ViT family with the flag on and
   off), and each of the fifteen kernels beside its bound, its plain version
   and the PyTorch library call (or chain) for the same function (rows 9-13:
   the median of five timings of the library); row 9 also in fp32 and at
   N 49 against N 64 over the same tokens (the cost of padding 49 keys to
   64), row 11 also in fp32 and with its tensor-core kernel's run of windows
   and blocks an SM, row 12 also in fp32 and at Swin-T's stage 3 (B 32,
   14 x 14, H 12, shifted with nW' 4 and unshifted with nW' 1), row 10 also
   without the bias gradient and beside SDPA's backward with
   the bias's gradient (the mask a leaf, its gradient summed over the
   windows that share a bias row); rows 1,
   7, 8 and 14 with their TFLOP/s, fp32 (row 8: CUDA-core) route and (row 1)
   S 192 against S 197, (row 14) torch's weight layout; row 8 also its
   device time in one launch and in four ordered launches of one phase each
   (the wait at its grid barriers; ``_measure_fused_block_phases``), and
   rows 14 and 1 alone at its shapes; rows 2, 3, 5 and 6 also at the path
   shapes of phase 2, with their TFLOP/s and SDPA's time (rows 3 and 5 also
   the share of key tiles they skip); row 4 at the DETR decoder's shape and
   ViT-B's with its TFLOP/s and device time beside SDPA's backward and row
   6 at rate 0; row 15 on one 768 x 3072 leaf (device time with L2 cold
   and warm) and over the parameter lists of Swin-T and ViT-B/16: the fused
   optimizer step's device time (L2 warm and cold), back-to-back time and
   host enqueue time beside the unfused one's and
   ``torch.optim.Adam(fused=True)``'s on the same tensors.

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and tensor-core
# bf16 FLOP/s; fp32 work on the CUDA cores peaks at 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# |kernel - plain| on the same card inputs. fp32: summation order only.
# bf16: the plain version rounds the unnormalised probabilities to bf16
# before PV (as the TPU kernel does) while the kernel keeps them fp32, plus
# one bf16 rounding of outputs of magnitude <= 4 (2^-7 per ulp there).
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LSE_TOL = 1e-4
# The window kernels against their plain versions. fp32: summation order and
# expf against torch.exp on outputs of magnitude <= 5. bf16: kernels and plain
# versions round the normalised probabilities to bf16 before PV, as the TPU
# kernels do, so what is left is fp32 summation order moving a rounding (of a
# probability or of the output) by one step: one bf16 step at |out| in
# [2, 4), 2^-6, where all but a few of the largest outputs of these shapes
# lie (max|ref| is printed with each check, at most 4.31 on an H100; measured
# error at most 7.8e-3), and at
# most WINDOW_DIFFERING_MAX of the output elements differ from the plain
# version's bits at all (at most 0.051% on an H100). Rounding the
# probabilities elsewhere (after P·V, or not at all) moves far more.
WINDOW_TOL = {"float32": 5e-6, "bfloat16": 1.6e-2}
WINDOW_DIFFERING_MAX = 5e-3
# The library chain (roll, partition, SDPA, reverse, roll) against the window
# plain version in bf16: SDPA rounds its probabilities at its own points.
LIBRARY_WINDOW_TOL = 2e-2
# Gradients of a kernel against its plain version, relative to the largest
# reference element (gradients grow with S). fp32: summation order and expf
# against torch.exp. bf16: the looser bound, for kernels that round at other
# points than the plain version they are held against (row 4 against row 6,
# which rounds ds·scale where row 4 rounds ds), plus one bf16 rounding of
# the result.
GRAD_TOL = {"float32": 5e-5, "bfloat16": 2e-2}
# The bf16 window backward (row 10) against its plain version, relative to
# the largest reference element: both round p (for dv) and ds·scale (for dq
# and dk) to bf16 before their products, as _window_pack_bwd_kernel does, so
# what is left is summation order and one rounding of the result, at most one
# bf16 step at the largest element, 2^-7 relative (3.2e-3 measured on an
# H100, a step of 2^-6 beside max|ref| 4.9); and at most WINDOW_DIFFERING_MAX
# of dqkv's elements differ from the plain version's bits (0.025% at most on
# an H100).
WINDOW_GRAD_TOL = 8e-3
# The bf16 tensor-core backwards of rows 4, 6 and 7 against their plain
# versions, relative to the largest reference element: each rounds pd and ds
# to bf16 before their products where its TPU kernel does (row 4 ds before
# the scale, rows 6 and 7 ds·scale), and so does its plain version, so what
# is left is summation order and one rounding of the result (up to 3.1e-3 at
# PVT stage 1 on an H100).
MMA_GRAD_TOL = 5e-3
# The bf16 kernels of rows 3 and 5 against their plain versions at the
# paths' shapes (Sk in the thousands, so |out| stays well below 1), times
# max(1, max|ref|): summation order and one bf16 rounding of the output, up
# to 9.8e-4 at |out| in [0.125, 0.25) on an H100. Each such check also reads
# a planted fault on the plain version, the output of a kernel that skipped
# live key tile 10, and requires it above this limit.
MASKED_FWD_TOL = 3e-3
# The CUDA kernels' names, as their launch sites log them
# (csrc/launch_log.cuh), that tell the routes of rows 1-14 apart
# (csrc/packed_attention.cu,
# csrc/flash_attention.cu, csrc/flash_attention_large.cu,
# csrc/flash_attention_bwd.cu, csrc/dropout_attention.cu,
# csrc/fused_block.cu, csrc/ln_dense.cu, csrc/window_attention.cu,
# csrc/window_attention_bwd.cu, csrc/window_fused_attention.cu): bf16 on
# the tensor cores, fp32 on the CUDA cores (row 14 by
# ops/fused_dense.py::ln_dense_route, its tensor-core route after the
# statistics launch, row 8 by ops/flash_attention.py::fused_block_route and
# rows 9-13 by ops/flash_attention.py::window_route; every bf16 width and
# weight layout of the repo's models takes the tensor cores).
ROUTE_NAMES = {
    ("row 1", "bfloat16"): ("packed_fwd_mma_kernel",),
    ("row 1", "float32"): ("packed_fwd_kernel",),
    ("row 7", "bfloat16"): ("packed_bwd_dq_mma_kernel",
                            "packed_bwd_dkv_mma_kernel"),
    ("row 7", "float32"): ("packed_bwd_dq_kernel", "packed_bwd_dkv_kernel"),
    ("row 8", "bfloat16"): ("fused_block_mma_kernel",),
    ("row 8", "float32"): ("fused_block_kernel",),
    ("row 14", "bfloat16"): ("ln_stats_kernel", "ln_dense_mma_kernel"),
    ("row 14", "float32"): ("ln_dense_kernel",),
    ("row 2", "bfloat16"): ("flash_fwd_mma_kernel",),
    ("row 2", "float32"): ("flash_fwd_kernel",),
    ("row 3", "bfloat16"): ("flash_large_mma_kernel",),
    ("row 3", "float32"): ("flash_large_kernel",),
    ("row 5", "bfloat16"): ("drop_fwd_mma_kernel",),
    ("row 5", "float32"): ("drop_fwd_kernel",),
    ("row 6", "bfloat16"): ("drop_bwd_dq_mma_kernel", "drop_bwd_dkv_mma_kernel"),
    ("row 6", "float32"): ("drop_bwd_dq_kernel", "drop_bwd_dkv_kernel"),
    # rows 2, 5 and 6 at a head dim below 64 other than 16 and 32 (TNT's
    # inner D 12): the next tile width with the columns past D zero
    ("row 2 padded", "bfloat16"): ("flash_fwd_mma_padded_kernel",),
    ("row 2 padded", "float32"): ("flash_fwd_padded_kernel",),
    ("row 5 padded", "bfloat16"): ("drop_fwd_mma_padded_kernel",),
    ("row 5 padded", "float32"): ("drop_fwd_padded_kernel",),
    ("row 6 padded", "bfloat16"): ("drop_bwd_dq_mma_padded_kernel",
                                   "drop_bwd_dkv_mma_padded_kernel"),
    ("row 6 padded", "float32"): ("drop_bwd_dq_padded_kernel",
                                  "drop_bwd_dkv_padded_kernel"),
    # row 16, the biased backward: the kernel in bf16, the plain version
    # (no kernel) in fp32
    ("row 16", "bfloat16"): ("bias_bwd_dq_mma_kernel",
                             "bias_bwd_dkv_mma_kernel"),
    ("row 16", "float32"): (),
    ("row 4", "bfloat16"): ("flash_bwd_dq_mma_kernel",
                            "flash_bwd_dkv_mma_kernel"),
    ("row 4", "float32"): ("flash_bwd_kernel",),
    # rows 1 and 7 at any dh but 16, 32 and 64, rows 3 and 4 at any D but
    # 16, 32, 64 and 128 (ViT-H/14's 80): the next tile, columns past D zero
    ("row 1 padded", "bfloat16"): ("packed_fwd_mma_padded_kernel",),
    ("row 1 padded", "float32"): ("packed_fwd_padded_kernel",),
    ("row 7 padded", "bfloat16"): ("packed_bwd_dq_mma_padded_kernel",
                                   "packed_bwd_dkv_mma_padded_kernel"),
    ("row 7 padded", "float32"): ("packed_bwd_dq_padded_kernel",
                                  "packed_bwd_dkv_padded_kernel"),
    ("row 3 padded", "bfloat16"): ("flash_large_mma_padded_kernel",),
    ("row 3 padded", "float32"): ("flash_large_padded_kernel",),
    ("row 4 padded", "bfloat16"): ("flash_bwd_dq_mma_padded_kernel",
                                   "flash_bwd_dkv_mma_padded_kernel"),
    ("row 4 padded", "float32"): ("flash_bwd_padded_kernel",),
    # rows 1-7 above head dim 128 (ViT-B/16's widths at 3 heads: 256): the
    # head dim split across the grid (csrc/attention_wide_tile.cuh)
    ("row 1 wide", "bfloat16"): ("packed_fwd_mma_wide_kernel",),
    ("row 1 wide", "float32"): ("packed_fwd_wide_kernel",),
    ("row 7 wide", "bfloat16"): ("packed_bwd_dq_mma_wide_kernel",
                                 "packed_bwd_dkv_mma_wide_kernel"),
    ("row 7 wide", "float32"): ("packed_bwd_dq_wide_kernel",
                                "packed_bwd_dkv_wide_kernel"),
    ("row 2 wide", "bfloat16"): ("flash_fwd_mma_wide_kernel",),
    ("row 2 wide", "float32"): ("flash_fwd_wide_kernel",),
    ("row 3 wide", "bfloat16"): ("flash_large_mma_wide_kernel",),
    ("row 3 wide", "float32"): ("flash_large_wide_kernel",),
    ("row 4 wide", "bfloat16"): ("flash_bwd_dq_mma_wide_kernel",
                                 "flash_bwd_dkv_mma_wide_kernel"),
    ("row 4 wide", "float32"): ("flash_bwd_dq_wide_kernel",
                                "flash_bwd_dkv_wide_kernel"),
    ("row 5 wide", "bfloat16"): ("drop_fwd_mma_wide_kernel",),
    ("row 5 wide", "float32"): ("drop_fwd_wide_kernel",),
    ("row 6 wide", "bfloat16"): ("drop_bwd_dq_mma_wide_kernel",
                                 "drop_bwd_dkv_mma_wide_kernel"),
    ("row 6 wide", "float32"): ("drop_bwd_dq_wide_kernel",
                                "drop_bwd_dkv_wide_kernel"),
    # row 8 at any other head dim up to 128 (the next tile) and above 128
    ("row 8 padded", "bfloat16"): ("fused_block_mma_padded_kernel",),
    ("row 8 padded", "float32"): ("fused_block_padded_kernel",),
    ("row 8 wide", "bfloat16"): ("fused_block_mma_wide_kernel",),
    ("row 8 wide", "float32"): ("fused_block_wide_kernel",),
    # row 4 in fp32 past the resident kernel's shared memory (S 512 at D
    # 128): the streaming passes, attention_wide_tile.cuh's fp32 bodies;
    # bf16 streams in its own two passes at every shape
    ("row 4 streamed", "bfloat16"): ("flash_bwd_dq_mma_kernel",
                                     "flash_bwd_dkv_mma_kernel"),
    ("row 4 streamed", "float32"): ("flash_bwd_dq_wide_kernel",
                                    "flash_bwd_dkv_wide_kernel"),
    ("row 9", "bfloat16"): ("window_packed_mma_kernel",),
    ("row 9", "float32"): ("window_packed_kernel",),
    ("row 10", "bfloat16"): ("window_bwd_mma_kernel",),
    ("row 10", "float32"): ("window_bwd_kernel",),
    ("row 11", "bfloat16"): ("window_batched_mma_kernel",),
    ("row 11", "float32"): ("window_batched_kernel",),
    ("row 12", "bfloat16"): ("window_fused_flat_mma_kernel",),
    ("row 12", "float32"): ("window_fused_flat_kernel",),
    ("row 13", "bfloat16"): ("window_fused_slab_mma_kernel",),
    ("row 13", "float32"): ("window_fused_slab_kernel",),
    # rows 11 and 10 at a head dim outside the pack and fused plans': bf16
    # the padded tiles 16-128 or the 64-column chunks, fp32 the 32-column
    # chunks (ops/flash_attention.py's window_route)
    ("row 11 padded", "bfloat16"): ("window_batched_mma_padded_kernel",),
    ("row 11 padded", "float32"): ("window_batched_chunked_kernel",),
    ("row 11 chunked", "bfloat16"): ("window_batched_mma_chunked_kernel",),
    ("row 11 chunked", "float32"): ("window_batched_chunked_kernel",),
    ("row 10 padded", "bfloat16"): ("window_bwd_mma_padded_kernel",),
    ("row 10 padded", "float32"): ("window_bwd_chunked_kernel",),
    ("row 10 chunked", "bfloat16"): ("window_bwd_mma_chunked_kernel",),
    ("row 10 chunked", "float32"): ("window_bwd_chunked_kernel",),
}
# The window wrappers' launch counters and their rows of the kernel table:
# a path that launches one requires its route by name.
WINDOW_ROWS = {"window_packed_attention": "row 9",
               "window_batched_attention": "row 11",
               "window_fused_flat_attention": "row 12",
               "window_fused_slab_attention": "row 13"}
# fp32 parameter gradients of a 2-layer model, card against CPU: summation
# order through two blocks, relative to the largest reference gradient.
MODEL_GRAD_TOL = 1e-4
# Served logits (magnitude ~1) against the CPU fp32 run of the same weights:
# fp32 differs by summation order through 12 layers; bf16 rounds every
# activation and weight (8 significant bits), so it is held to 5% of the
# largest reference logit.
LOGIT_TOL_FP32 = 1e-3
LOGIT_TOL_BF16_REL = 5e-2
# The flag-on fp32 forward of ViT-B3 at 2 layers, card against the CPU's
# plain version: summation order through two blocks (phase 7e saw 5.1e-6 at
# max|ref| 3.8 on the unfused path).
FUSED_LOGIT_TOL_FP32 = 1e-4
# int8 (w8a8) serving, ViT-B/16 @224 in bf16. The card's logits against the
# same artifact served on the CPU: both quantize the same way and their int8
# products are exact, so they differ only where the bf16 float parts (LN,
# attention, GELU) round differently on the two devices, the bf16 path's
# difference, which an activation on an int8 rounding boundary can move by one
# int8 step of its row (1/127 of the row's max): the bf16 limit,
# LOGIT_TOL_BF16_REL x max|ref|. Against the float bf16 model on the card:
# the JAX test's limit, 5% relative (Frobenius) feature error
# (tests/test_quant.py:81).
INT8_CPU_TOL_REL = LOGIT_TOL_BF16_REL
INT8_FEATURE_REL = 5e-2
# Swin logits of an fp32 model on the card against the CPU run: summation
# order through 12 blocks on logits of magnitude ~1.
SWIN_LOGIT_TOL_FP32 = 1e-4
# The single-pass Adam kernel against its plain version after 3 steps: both
# round every operation to fp32 in the same order, so 0 is expected.
ADAM_TOL = 1e-6
# Window kernel launches per forward that the routing of ops/windows.py
# implies for the 12 blocks of each preset (every other counter stays 0).
SWIN_LAUNCHES_PER_FORWARD = {
    "swint_224_imagenet": {"window_batched_attention": 4,
                           "window_fused_slab_attention": 1,
                           "window_fused_flat_attention": 7},
    "swinv2t_224_imagenet": {"window_batched_attention": 4,
                             "window_packed_attention": 8},
}


# Twins-SVT-S @224: 9 LSA blocks (stages 1, 2, 4 batched: 64, 16 and 1
# windows; stage 3's 4 windows fused flat, 14 % 8 != 0) and 9 GSA blocks
# (split-head kernel); PVT-Tiny: 8 SRA blocks.
HIER_LAUNCHES_PER_FORWARD = {
    "pvt_tiny224_imagenet": {"flash_attention": 8},
    "twins_svts224_imagenet": {"flash_attention": 9,
                               "window_batched_attention": 4,
                               "window_fused_flat_attention": 5},
}
TWINS_ROUTES = (["batched", "batched"] + ["fused_flat"] * 5
                + ["batched"] * 2)

# DETR-R50 outputs of an fp32 model on the card against the CPU run of the
# same weights: summation order through 53 convolutions and 9 attention
# layers; logits held relative to their largest magnitude, boxes (sigmoid
# outputs in [0, 1]) absolutely.
DETR_LOGIT_TOL_REL = 1e-3
DETR_BOX_TOL = 1e-3
# fp32 parameter gradients of the narrow DETR, card against CPU, relative to
# the largest reference gradient (21): the two devices sum the convolutions
# in different orders through 53 layers of random weights, and a
# pre-activation within rounding of 0 can fall on either side of a ReLU,
# which moves a whole gradient term. Measured on an H100 80GB HBM3: 2.0e-3
# (9.6e-5 of max|ref|) in layer4_block2.conv1.weight; of the 81 920
# pre-activations of the ReLU after it, 2 (CPU) and 1 (card) lie within
# 1e-6·max|z| of 0 and 1 falls on opposite sides on the two devices, and
# that weight gradient recomputed on the card with the CPU's ReLU mask is
# 2.1e-7 (9.9e-9 relative) from the CPU's. narrow_detr_gradients prints
# these counts each run and requires the masked recompute within
# RELU_MASK_TOL.
DETR_GRAD_TOL = 5e-4
RELU_MASK_TOL = 1e-4
# Launches per DETR-R50 forward at eval (6 encoder self and 6 decoder cross
# attentions take the streaming kernel with their key-padding mask; the
# mask-free 100 x 100 decoder self attention the split-head kernel), and
# per train step at dropout 0.1 and at dropout 0 under USE_PALLAS_BWD.
DETR_EVAL_LAUNCHES = {"flash_attention_large": 12, "flash_attention": 6}
DETR_TRAIN_LAUNCHES = {
    0.1: {"dropout_attention_fwd": 18, "dropout_attention_bwd": 18},
    0.0: {"flash_attention_large": 12, "flash_attention": 6,
          "flash_attention_bwd": 6, "dropout_attention_bwd": 12},
}
# The ViT family on the USE_FUSED_BLOCK path, @224: (class name, kwargs, the
# converter in utils/port_jax.py, encoder layers = fused launches per
# forward, other attention launches per forward). DeiT-B: Touvron et al.
# 2021 (arXiv:2012.12877); T2T-ViT-14 and T2T-ViT_t-14: Yuan et al. 2021
# (arXiv:2101.11986) Table 1, whose token transformer takes the streaming
# kernel at 3136 tokens and the split-head kernel at 784.
_T2T14 = dict(image_size=224, patch_size=16, num_layers=14, num_heads=6,
              hidden_dim=384, mlp_dim=1152, num_classes=1000, token_dim=64)
FAMILY_CONFIGS = {
    "vitb16_224_imagenet": ("ViT", None, "vit_state_dict_from_jax", 12, {}),
    "deit-b@224": ("DeiT", dict(image_size=224, patch_size=16, num_layers=12,
                                num_heads=12, embed_dim=768,
                                num_classes=1000),
                   "deit_state_dict_from_jax", 12, {}),
    "cpe-vit-b@224": ("CPEViT", None, "cpevit_state_dict_from_jax", 12, {}),
    "t2t-vit-14@224": ("T2T_ViT", _T2T14, "t2t_state_dict_from_jax", 14, {}),
    "t2t-vit_t-14@224": ("T2T_ViT", dict(_T2T14, token_type="transformer"),
                         "t2t_state_dict_from_jax", 14,
                         {"flash_attention_large": 1, "flash_attention": 1}),
}
# Four COCO-sized images (shorter side 800 or less, longer up to 1333): one
# batch at the 896 x 1344 bucket, each with its own padding.
COCO_SIZES = [(800, 1333), (800, 1199), (800, 1066), (752, 1333)]


class SyntheticCoco:
    """Map-style detection dataset: (H, W, 3) float images as DETR's
    transforms leave them (normalised, so N(0, 1) here) and targets with 1-6
    boxes (rel-cxcywh), labels in [1, 90], ``image_id`` and ``orig_size``,
    all drawn from ``seed``."""

    def __init__(self, sizes, seed):
        rng = np.random.RandomState(seed)
        self.items = []
        for i, (h, w) in enumerate(sizes):
            k = 1 + rng.randint(6)
            boxes = np.concatenate([rng.rand(k, 2) * 0.6 + 0.2,
                                    rng.rand(k, 2) * 0.3 + 0.05], axis=1)
            self.items.append((
                rng.standard_normal((h, w, 3)).astype(np.float32),
                {"labels": rng.randint(1, 91, k),
                 "boxes": boxes.astype(np.float32),
                 "image_id": np.asarray([i]),
                 "orig_size": np.asarray([h, w])}))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def jax_shaped_weights(model, seed: int):
    """The model's parameters as the JAX package's params tree holds them —
    nested dicts of numpy arrays, conv kernels (kh, kw, in, out), Dense
    kernels (in, out), norm scales named ``scale`` — drawn from one numpy
    stream: kernels N(0, 1/fan_in), scales 1 + N(0, 0.1), FrozenBN
    variances 1 + |N(0, 0.1)|, query embeddings N(0, 1), the rest
    N(0, 0.02)."""
    rng = np.random.RandomState(seed)
    tree = {}
    for name, p in model.state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(p.shape)
        if leaf == "weight" and len(shape) == 4:
            leaf, shape = "kernel", shape[2:] + (shape[1], shape[0])
        elif leaf == "weight" and len(shape) == 2:
            leaf, shape = "kernel", shape[::-1]
        elif leaf == "weight":
            leaf = "scale"
        if leaf == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf == "scale":
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        elif leaf == "var":
            a = 1.0 + 0.1 * np.abs(rng.standard_normal(shape))
        elif leaf == "query_embed":
            a = rng.standard_normal(shape)
        else:
            a = 0.02 * rng.standard_normal(shape)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a.astype(np.float32)
    return tree


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def differing_share(a, b) -> float:
    """The share of elements of a whose bits differ from b's."""
    return (a != b).float().mean().item()


def into_freed_nan(call, shape, dtype, dev):
    """call()'s output, for a wrapper that allocates it itself and makes no
    other tensor on the card before it: run on a stream of its own, whose
    caching-allocator pool then holds one free block alone, a NaN-filled
    one of the output's size. The output must take that block (same
    address, or the check fails), so any element the kernel leaves
    unwritten reads NaN."""
    import torch

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        nan = torch.full(shape, float("nan"), dtype=dtype, device=dev)
        ptr = nan.data_ptr()
        del nan
        out = call()
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    require(out.data_ptr() == ptr, "the output took the freed NaN block "
            f"({out.data_ptr():#x} against {ptr:#x})")
    return out


def seeded_state_dict(model, seed: int):
    """Every parameter from one numpy stream: Dense weights with xavier
    scale, LayerNorm scales 1 + N(0, 0.1), SwinV2's ``logit_scale``
    log 10 + N(0, 0.1), Twins' depthwise conv kernels N(0, 1/9),
    everything else N(0, 0.02)."""
    import torch

    rng = np.random.RandomState(seed)
    out = {}
    for name, p in model.state_dict().items():
        shape = tuple(p.shape)
        if name.endswith("logit_scale"):  # SwinV2's temperature, init log 10
            a = np.log(10.0) + 0.1 * rng.standard_normal(shape)
        elif name.endswith("weight") and len(shape) == 2:
            a = rng.standard_normal(shape) * (2.0 / sum(shape)) ** 0.5
        elif name.endswith("weight") and len(shape) == 4:  # depthwise 3x3
            a = rng.standard_normal(shape) / 3.0
        elif name.endswith("weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.02 * rng.standard_normal(shape)
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def reference_state_dict(shapes, seed: int):
    """Tensors for ``shapes`` (name → shape) from one numpy stream: a 1-D
    ``weight`` (a norm's scale) 1 + N(0, 0.1), a weight of two or more
    dimensions N(0, 2 / (fan out + fan in)), everything else N(0, 0.02)."""
    import torch

    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in shapes.items():
        a = rng.standard_normal(shape)
        if name.endswith("weight") and len(shape) == 1:
            a = 1.0 + 0.1 * a
        elif name.endswith("weight"):
            a *= (2.0 / (shape[0] + int(np.prod(shape[1:])))) ** 0.5
        else:
            a *= 0.02
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


def reference_vit_state_dict(a, seed: int):
    """A ViT ``state_dict`` in the reference's (torchvision's) layout for
    the preset kwargs ``a``: what ``--init-from-torch`` reads."""
    d, m, p = a["hidden_dim"], a["mlp_dim"], a["patch_size"]
    shapes = {"conv_proj.weight": (d, 3, p, p), "conv_proj.bias": (d,),
              "class_token": (1, 1, d),
              "encoder.pos_embedding": (1, (a["image_size"] // p) ** 2 + 1,
                                        d)}
    for i in range(a["num_layers"]):
        q = f"encoder.layers.encoder_layer_{i}."
        shapes.update({
            q + "ln_1.weight": (d,), q + "ln_1.bias": (d,),
            q + "self_attention.in_proj_weight": (3 * d, d),
            q + "self_attention.in_proj_bias": (3 * d,),
            q + "self_attention.out_proj.weight": (d, d),
            q + "self_attention.out_proj.bias": (d,),
            q + "ln_2.weight": (d,), q + "ln_2.bias": (d,),
            q + "mlp.0.weight": (m, d), q + "mlp.0.bias": (m,),
            q + "mlp.3.weight": (d, m), q + "mlp.3.bias": (d,)})
    shapes.update({"encoder.ln.weight": (d,), "encoder.ln.bias": (d,),
                   "heads.head.weight": (a["num_classes"], d),
                   "heads.head.bias": (a["num_classes"],)})
    return reference_state_dict(shapes, seed)


def reference_swin_state_dict(a, seed: int):
    """A Swin ``state_dict`` in torchvision's ``features`` layout for the
    preset kwargs ``a`` (bias-free patch-merging reductions, as
    torchvision's)."""
    e, p = a["embed_dim"], a["patch_size"][0]
    wh, ww = a["window_size"]
    shapes = {"features.0.0.weight": (e, 3, p, p), "features.0.0.bias": (e,),
              "features.0.2.weight": (e,), "features.0.2.bias": (e,)}
    depths = a["depths"]
    for i, (depth, heads) in enumerate(zip(depths, a["num_heads"])):
        d = e * 2 ** i
        h = int(d * a["mlp_ratio"])
        for j in range(depth):
            q = f"features.{2 * i + 1}.{j}."
            shapes.update({
                q + "norm1.weight": (d,), q + "norm1.bias": (d,),
                q + "attn.qkv.weight": (3 * d, d),
                q + "attn.qkv.bias": (3 * d,),
                q + "attn.proj.weight": (d, d), q + "attn.proj.bias": (d,),
                q + "attn.relative_position_bias_table":
                    ((2 * wh - 1) * (2 * ww - 1), heads),
                q + "norm2.weight": (d,), q + "norm2.bias": (d,),
                q + "mlp.0.weight": (h, d), q + "mlp.0.bias": (h,),
                q + "mlp.3.weight": (d, h), q + "mlp.3.bias": (d,)})
        if i < len(depths) - 1:
            q = f"features.{2 * i + 2}."
            shapes.update({q + "norm.weight": (4 * d,),
                           q + "norm.bias": (4 * d,),
                           q + "reduction.weight": (2 * d, 4 * d)})
    n = e * 2 ** (len(depths) - 1)
    shapes.update({"norm.weight": (n,), "norm.bias": (n,),
                   "head.weight": (a["num_classes"], n),
                   "head.bias": (a["num_classes"],)})
    return reference_state_dict(shapes, seed)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, top: int = 8):
    """One warm call of ``fn`` under ``torch.profiler`` → (wall ms, device
    busy ms, device activities, [(name, ms, count)] by device time), or
    busy None if the profiler recorded no device activity. One stream, so
    kernel times do not overlap and their sum is the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        return wall, None, 0, []
    busy = sum(ms for ms, _ in by_name.values())
    count = sum(n for _, n in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall, busy, count, [(k[:90], ms, n) for k, (ms, n) in ranked]


def queued_ms(fns, reps: int = 10):
    """Device ms of each of ``fns`` (each a call that launches a few
    kernels), by CUDA events recorded around it while the stream is kept
    full: a ``torch.cuda._sleep`` kernel ahead of them holds the card while
    the host enqueues every call, so no host gap falls between an event
    pair. Mean of ``reps`` rounds."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    ev = [[(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in fns]
          for _ in range(reps)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clocks
    for row in ev:
        for (start, end), f in zip(row, fns):
            start.record()
            f()
            end.record()
    torch.cuda.synchronize()
    return [float(np.mean([row[i][0].elapsed_time(row[i][1]) for row in ev]))
            for i in range(len(fns))]


def cold_ms(fn, reps: int = 10) -> float:
    """Device ms of ``fn`` with the L2 cache cold: a 256 MB write before
    each call, outside the pair of CUDA events around it, while a sleep
    kernel ahead keeps the stream full (as ``queued_ms``). What a caller
    that streams more than the 50 MB of L2 between two calls sees, as an
    optimizer step over all of a model's leaves does. Mean of ``reps``."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(200_000_000)  # ~0.1 s at the H100's clocks
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.mean([start.elapsed_time(end) for start, end in ev]))


def window_routes(launches):
    """The bf16 routes of the window forwards that a path's launch counts
    (per forward) name."""
    return [(row, "bfloat16") for k, row in WINDOW_ROWS.items()
            if launches.get(k)]


def require_route(label, fn, routes):
    """One call of ``fn`` launches, for each (row, dtype) of ``routes``, the
    kernels of ROUTE_NAMES[(row, dtype)] and none of that row's other
    route, by the kernel libraries' launch logs (``_build.launched``: each
    launch site counts its kernel by name once it has launched). Not by a
    profiler: runs on an H100 saw the port's kernels missing from
    ``torch.profiler`` sessions at random, some tens of sessions into a
    process, while the kernels had run."""
    import torch
    from vision_transformers_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launched()
    fn()
    torch.cuda.synchronize()
    got = _build.launched()
    for row, dtype in routes:
        other = "float32" if dtype == "bfloat16" else "bfloat16"
        new = ROUTE_NAMES[(row, dtype)]
        old = tuple(x for x in ROUTE_NAMES[(row, other)] if x not in new)
        require(all(got.get(x, 0) > 0 for x in new)
                and not any(x in got for x in old),
                f"{label}: {row} in {dtype} launches {new}, none of {old}; "
                f"the launch logs saw {got}")
        log(f"route {label}: {row} {dtype} through "
            f"{', '.join(f'{x} x{got[x]}' for x in new)}")


class ColorClassLoader:
    """Re-iterable loader of (uint8 NHWC images, labels): each class is a
    colour plus noise, so a small model learns it in a few steps (the recipe
    of tests/synthetic_data.py). Class colours come from one fixed seed, so
    every split shares them; labels and noise come from ``seed``."""

    def __init__(self, num_samples, batch_size, image_size=32, num_classes=10,
                 seed=0):
        base = np.random.RandomState(1234).randint(0, 255, (num_classes, 3))
        rng = np.random.RandomState(seed)
        self.labels = rng.randint(0, num_classes, num_samples).astype(np.int32)
        noise = rng.randint(-20, 20, (num_samples, image_size, image_size, 3))
        self.images = np.clip(base[self.labels][:, None, None, :] + noise,
                              0, 255).astype(np.uint8)
        self.batch_size = batch_size
        self.normalize = ((0.5, 0.5, 0.5), (0.25, 0.25, 0.25))

    def __iter__(self):
        for i in range(0, len(self.labels), self.batch_size):
            yield (self.images[i:i + self.batch_size],
                   self.labels[i:i + self.batch_size])

    def __len__(self):
        return -(-len(self.labels) // self.batch_size)


def write_cifar100(root, n_train, n_test, seed):
    """A synthetic CIFAR-100 in the real python-pickle format under
    root/cifar-100-python: ``train`` and ``test``, each a dict of uint8
    ``data`` (N, 3072; the three 32 x 32 planes of an image in a row) and
    ``fine_labels``. Each class is a colour plus noise (learnable in a few
    steps); the colours come from one fixed seed, labels and noise from
    ``seed``."""
    import pickle

    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base, exist_ok=True)
    colours = np.random.RandomState(1234).randint(0, 256, (100, 3))
    rng = np.random.RandomState(seed)
    for name, n in (("train", n_train), ("test", n_test)):
        labels = rng.randint(0, 100, n)
        img = colours[labels][:, :, None, None] + rng.randint(
            -20, 21, (n, 3, 32, 32))
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": np.clip(img, 0, 255).astype(np.uint8)
                         .reshape(n, 3072),
                         b"fine_labels": labels.tolist()}, fh)


def write_image_folder(root, classes, per_class, side, seed):
    """root/{train,val}/class{c}/{i}.png: colour classes, as
    ``write_cifar100``'s, at ``side`` pixels (the imagenet-style layout
    ``get_train_test_loaders`` reads with ``ImageFolderLoader``)."""
    from PIL import Image

    colours = np.random.RandomState(1234).randint(0, 256, (classes, 3))
    rng = np.random.RandomState(seed)
    for split in ("train", "val"):
        for c in range(classes):
            d = os.path.join(root, split, f"class{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                img = colours[c] + rng.randint(-20, 21, (side, side, 3))
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    os.path.join(d, f"{i}.png"))


def rle_counts(mask):
    """Uncompressed COCO RLE counts of a 0/1 mask (column-major, from a run
    of zeros)."""
    flat = mask.T.reshape(-1)
    edges = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], edges, [flat.size]]))
    return ([0] if flat[0] else []) + runs.tolist()


def rle_string(counts):
    """pycocotools' compressed RLE string of ``counts``."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if c & 0x10 else (x != 0)
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def write_coco_folder(root, sizes, seed):
    """A COCO folder (train2017/, val2017/,
    annotations/instances_{train,val}2017.json) of ``sizes`` (h, w) random
    JPEG images per split, each with four objects: a box with a polygon, one
    with an uncompressed and one with a compressed RLE mask, and a crowd
    one."""
    import json as js

    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    for split in ("train", "val"):
        os.makedirs(os.path.join(root, f"{split}2017"), exist_ok=True)
        images, anns = [], []
        for i, (h, w) in enumerate(sizes):
            name = f"{i + 1:012d}.jpg"
            Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
                np.uint8)).save(os.path.join(root, f"{split}2017", name))
            images.append({"id": i + 1, "file_name": name, "height": h,
                           "width": w})
            for j in range(4):
                bw, bh = rng.randint(w // 8, w // 2), rng.randint(h // 8,
                                                                  h // 2)
                x0, y0 = rng.randint(0, w - bw), rng.randint(0, h - bh)
                m = np.zeros((h, w), np.uint8)
                m[y0:y0 + bh, x0:x0 + bw] = 1
                seg = ([[x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0,
                         y0 + bh]] if j == 0
                       else {"counts": rle_counts(m) if j == 1
                             else rle_string(rle_counts(m)), "size": [h, w]})
                anns.append({"id": len(anns) + 1, "image_id": i + 1,
                             "bbox": [x0, y0, bw, bh],
                             "category_id": int(rng.randint(1, 91)),
                             "area": float(bw * bh), "iscrowd": int(j == 3),
                             "segmentation": seg})
        with open(os.path.join(root, "annotations",
                               f"instances_{split}2017.json"), "w") as fh:
            js.dump({"images": images, "annotations": anns,
                     "categories": [{"id": c, "name": str(c)}
                                    for c in range(1, 91)]}, fh)


# The sources of rows 1-15, whose kernels' registers and shared memory
# phase 1 prints.
PTXAS_SOURCES = ("fused_adam", "packed_attention", "flash_attention",
                 "flash_attention_large",
                 "flash_attention_bwd", "dropout_attention", "fused_block",
                 "ln_dense", "window_attention", "window_attention_bwd",
                 "window_fused_attention", "flash_attention_bias_bwd")
# The registers `nvcc -Xptxas -v` (CUDA 12.9, sm_90a) gives the kernels of
# rows 1-7 and 14 on both routes, and the window kernels that kept their
# text (read from the parent's build on the card when rows 9 and 10 took the
# tensor cores, and rows 9 and 10's tensor-core kernels when rows 11 and 12
# joined their tile; row 13's bf16 CUDA-core kernel went when row 13 took
# the tensor cores), which phase 1 checks. The tiles' policies
# (a row layout, a dropout flag and a scale placement for the backward, a
# thread policy and a load policy for the forwards) default to the code the
# older rows had, so a new row on a shared tile leaves theirs alone: the
# tensor-core kernels of rows 1, 2, 3, 5, 6, 7 and 14 and the CUDA-core ones
# of rows 1-7 and 14 as they were before row 4 joined row 6's tiles and the
# fp32 fused block took the tiles' L2 loads, and row 4's own.
KEPT_REGISTERS = {
    "packed_fwd_mma_kernel<16, false>": 123,
    "packed_fwd_mma_kernel<16, true>": 139,
    "packed_fwd_mma_kernel<32, false>": 142,
    "packed_fwd_mma_kernel<32, true>": 187,
    "packed_fwd_mma_kernel<64, false>": 144,
    "packed_fwd_mma_kernel<64, true>": 165,
    "packed_bwd_dq_mma_kernel<16, false>": 72,
    "packed_bwd_dq_mma_kernel<16, true>": 96,
    "packed_bwd_dq_mma_kernel<32, false>": 96,
    "packed_bwd_dq_mma_kernel<32, true>": 128,
    "packed_bwd_dq_mma_kernel<64, false>": 164,
    "packed_bwd_dq_mma_kernel<64, true>": 167,
    "packed_bwd_dkv_mma_kernel<16, false>": 95,
    "packed_bwd_dkv_mma_kernel<16, true>": 104,
    "packed_bwd_dkv_mma_kernel<32, false>": 127,
    "packed_bwd_dkv_mma_kernel<32, true>": 138,
    "packed_bwd_dkv_mma_kernel<64, false>": 209,
    "packed_bwd_dkv_mma_kernel<64, true>": 251,
    "flash_fwd_mma_kernel<16>": 110,
    "flash_fwd_mma_kernel<32>": 141,
    "flash_fwd_mma_kernel<64>": 148,
    "flash_large_mma_kernel<16>": 111,
    "flash_large_mma_kernel<32>": 156,
    "flash_large_mma_kernel<64>": 128,
    "drop_fwd_mma_kernel<16>": 126,
    "drop_fwd_mma_kernel<32>": 164,
    "drop_fwd_mma_kernel<64>": 128,
    "drop_bwd_dq_mma_kernel<16>": 96,
    "drop_bwd_dq_mma_kernel<32>": 125,
    "drop_bwd_dq_mma_kernel<64>": 168,
    "drop_bwd_dkv_mma_kernel<16>": 96,
    "drop_bwd_dkv_mma_kernel<32>": 128,
    "drop_bwd_dkv_mma_kernel<64>": 168,
    "drop_bwd_dkv_sum_kernel": 32,
    "ln_dense_mma_kernel<false>": 128,
    "ln_dense_mma_kernel<true>": 128,
    "ln_stats_kernel": 32,
    "flash_bwd_dq_mma_kernel<16>": 72,
    "flash_bwd_dq_mma_kernel<32>": 96,
    "flash_bwd_dq_mma_kernel<64>": 155,
    "flash_bwd_dkv_mma_kernel<16>": 95,
    "flash_bwd_dkv_mma_kernel<32>": 128,
    "flash_bwd_dkv_mma_kernel<64>": 177,
    # the CUDA-core route (fp32; row 14 also in bf16)
    "packed_fwd_kernel<float, 16>": 64,
    "packed_fwd_kernel<float, 32>": 91,
    "packed_fwd_kernel<float, 64>": 91,
    "packed_bwd_dq_kernel<float, 16>": 126,
    "packed_bwd_dq_kernel<float, 32>": 126,
    "packed_bwd_dq_kernel<float, 64>": 120,
    "packed_bwd_dkv_kernel<float, 16>": 96,
    "packed_bwd_dkv_kernel<float, 32>": 96,
    "packed_bwd_dkv_kernel<float, 64>": 120,
    "flash_fwd_kernel<float, 16>": 64,
    "flash_fwd_kernel<float, 32>": 72,
    "flash_fwd_kernel<float, 64>": 88,
    "flash_large_kernel<float, 16>": 68,
    "flash_large_kernel<float, 32>": 72,
    "flash_large_kernel<float, 64>": 80,
    "flash_bwd_kernel<float, 16>": 64,
    "flash_bwd_kernel<float, 32>": 72,
    "flash_bwd_kernel<float, 64>": 96,
    "drop_fwd_kernel<float, 16>": 72,
    "drop_fwd_kernel<float, 32>": 72,
    "drop_fwd_kernel<float, 64>": 89,
    "drop_bwd_dq_kernel<float, 16>": 96,
    "drop_bwd_dq_kernel<float, 32>": 122,
    "drop_bwd_dq_kernel<float, 64>": 120,
    "drop_bwd_dkv_kernel<float, 16>": 84,
    "drop_bwd_dkv_kernel<float, 32>": 96,
    "drop_bwd_dkv_kernel<float, 64>": 124,
    "ln_dense_kernel<float>": 80,
    "ln_dense_kernel<__nv_bfloat16>": 80,
    # rows 2, 5 and 6 at D 128 (dynamic shared memory) and in the padded
    # tiles (any other D up to 64), both routes: the first build's counts
    # (the D 128 tensor-core backward passes at 253 and 255, the dk/dv one
    # with 120 bytes spilled; the padded dk/dv at tile 64 at 255, 28 spilled)
    "flash_fwd_mma_kernel<128>": 228,
    "flash_fwd_mma_padded_kernel<16>": 138,
    "flash_fwd_mma_padded_kernel<32>": 142,
    "flash_fwd_mma_padded_kernel<64>": 154,
    "flash_fwd_kernel<float, 128>": 142,
    "flash_fwd_padded_kernel<float, 16>": 64,
    "flash_fwd_padded_kernel<float, 32>": 72,
    "flash_fwd_padded_kernel<float, 64>": 80,
    "drop_fwd_mma_kernel<128>": 230,
    "drop_bwd_dq_mma_kernel<128>": 253,
    "drop_bwd_dkv_mma_kernel<128>": 255,
    "drop_fwd_mma_padded_kernel<16>": 128,
    "drop_fwd_mma_padded_kernel<32>": 172,
    "drop_fwd_mma_padded_kernel<64>": 183,
    "drop_bwd_dq_mma_padded_kernel<16>": 92,
    "drop_bwd_dq_mma_padded_kernel<32>": 128,
    "drop_bwd_dq_mma_padded_kernel<64>": 176,
    "drop_bwd_dkv_mma_padded_kernel<16>": 131,
    "drop_bwd_dkv_mma_padded_kernel<32>": 176,
    "drop_bwd_dkv_mma_padded_kernel<64>": 255,
    "drop_fwd_kernel<float, 128>": 128,
    "drop_bwd_dq_kernel<float, 128>": 148,
    "drop_bwd_dkv_kernel<float, 128>": 140,
    "drop_fwd_padded_kernel<float, 16>": 72,
    "drop_fwd_padded_kernel<float, 32>": 80,
    "drop_fwd_padded_kernel<float, 64>": 91,
    "drop_bwd_dq_padded_kernel<float, 16>": 96,
    "drop_bwd_dq_padded_kernel<float, 32>": 126,
    "drop_bwd_dq_padded_kernel<float, 64>": 96,
    "drop_bwd_dkv_padded_kernel<float, 16>": 80,
    "drop_bwd_dkv_padded_kernel<float, 32>": 80,
    "drop_bwd_dkv_padded_kernel<float, 64>": 128,
    # rows 1-7 at every other head dim up to 128 (PR 18): the padded tiles
    # of rows 1, 3, 4 and 7 and rows 2, 5 and 6's 128 one, rows 3 and 4's
    # D 128, both routes; the first build's counts (the padded 128 tiles on
    # PaddedStrided copies, GroupPad: forwards 187-230 registers without
    # spill, backward passes 250-255 with 0-212 bytes spilled)
    "flash_fwd_mma_padded_kernel<128>": 224,
    "drop_fwd_mma_padded_kernel<128>": 228,
    "drop_bwd_dq_mma_padded_kernel<128>": 255,
    "drop_bwd_dkv_mma_padded_kernel<128>": 255,
    "flash_large_mma_padded_kernel<128>": 230,
    "flash_bwd_dq_mma_padded_kernel<128>": 250,
    "flash_bwd_dkv_mma_padded_kernel<128>": 255,
    "drop_bwd_dkv_padded_kernel<float, 128>": 140,
    "drop_bwd_dq_padded_kernel<float, 128>": 156,
    "drop_fwd_padded_kernel<float, 128>": 138,
    "flash_bwd_dkv_mma_kernel<128>": 255,
    "flash_bwd_dkv_mma_padded_kernel<16>": 96,
    "flash_bwd_dkv_mma_padded_kernel<32>": 139,
    "flash_bwd_dkv_mma_padded_kernel<64>": 255,
    "flash_bwd_dq_mma_kernel<128>": 243,
    "flash_bwd_dq_mma_padded_kernel<16>": 67,
    "flash_bwd_dq_mma_padded_kernel<32>": 96,
    "flash_bwd_dq_mma_padded_kernel<64>": 175,
    "flash_bwd_kernel<float, 128>": 128,
    "flash_bwd_padded_kernel<float, 128>": 167,
    "flash_bwd_padded_kernel<float, 16>": 128,
    "flash_bwd_padded_kernel<float, 32>": 128,
    "flash_bwd_padded_kernel<float, 64>": 128,
    "flash_fwd_padded_kernel<float, 128>": 142,
    "flash_large_kernel<float, 128>": 137,
    "flash_large_mma_kernel<128>": 223,
    "flash_large_mma_padded_kernel<16>": 146,
    "flash_large_mma_padded_kernel<32>": 193,
    "flash_large_mma_padded_kernel<64>": 158,
    "flash_large_padded_kernel<float, 128>": 142,
    "flash_large_padded_kernel<float, 16>": 64,
    "flash_large_padded_kernel<float, 32>": 72,
    "flash_large_padded_kernel<float, 64>": 80,
    "packed_bwd_dkv_mma_padded_kernel<128, false>": 255,
    "packed_bwd_dkv_mma_padded_kernel<128, true>": 255,
    "packed_bwd_dkv_mma_padded_kernel<16, false>": 105,
    "packed_bwd_dkv_mma_padded_kernel<16, true>": 101,
    "packed_bwd_dkv_mma_padded_kernel<32, false>": 143,
    "packed_bwd_dkv_mma_padded_kernel<32, true>": 168,
    "packed_bwd_dkv_mma_padded_kernel<64, false>": 182,
    "packed_bwd_dkv_mma_padded_kernel<64, true>": 182,
    "packed_bwd_dkv_padded_kernel<float, 128>": 146,
    "packed_bwd_dkv_padded_kernel<float, 16>": 120,
    "packed_bwd_dkv_padded_kernel<float, 32>": 120,
    "packed_bwd_dkv_padded_kernel<float, 64>": 120,
    "packed_bwd_dq_mma_padded_kernel<128, false>": 254,
    "packed_bwd_dq_mma_padded_kernel<128, true>": 255,
    "packed_bwd_dq_mma_padded_kernel<16, false>": 66,
    "packed_bwd_dq_mma_padded_kernel<16, true>": 90,
    "packed_bwd_dq_mma_padded_kernel<32, false>": 110,
    "packed_bwd_dq_mma_padded_kernel<32, true>": 136,
    "packed_bwd_dq_mma_padded_kernel<64, false>": 133,
    "packed_bwd_dq_mma_padded_kernel<64, true>": 135,
    "packed_bwd_dq_padded_kernel<float, 128>": 194,
    "packed_bwd_dq_padded_kernel<float, 16>": 126,
    "packed_bwd_dq_padded_kernel<float, 32>": 140,
    "packed_bwd_dq_padded_kernel<float, 64>": 126,
    "packed_fwd_mma_padded_kernel<128, false>": 187,
    "packed_fwd_mma_padded_kernel<128, true>": 230,
    "packed_fwd_mma_padded_kernel<16, false>": 92,
    "packed_fwd_mma_padded_kernel<16, true>": 110,
    "packed_fwd_mma_padded_kernel<32, false>": 153,
    "packed_fwd_mma_padded_kernel<32, true>": 190,
    "packed_fwd_mma_padded_kernel<64, false>": 128,
    "packed_fwd_mma_padded_kernel<64, true>": 136,
    "packed_fwd_padded_kernel<float, 128>": 180,
    "packed_fwd_padded_kernel<float, 16>": 72,
    "packed_fwd_padded_kernel<float, 32>": 91,
    "packed_fwd_padded_kernel<float, 64>": 92,
    # the window kernels on the CUDA cores whose text did not change when
    # rows 9-13 took the tensor cores: rows 9-13 in fp32
    "window_packed_kernel<float, 16>": 76,
    "window_packed_kernel<float, 32>": 123,
    "window_packed_kernel<float, 64>": 176,
    "window_bwd_kernel<float, 16>": 74,
    "window_bwd_kernel<float, 32>": 112,
    "window_bwd_kernel<float, 64>": 174,
    "window_batched_kernel<float, 16>": 80,
    "window_batched_kernel<float, 32>": 128,
    "window_batched_kernel<float, 64>": 211,
    "window_fused_slab_kernel<float, 16>": 80,
    "window_fused_slab_kernel<float, 32>": 128,
    "window_fused_slab_kernel<float, 64>": 213,
    "window_fused_flat_kernel<float, 16>": 64,
    "window_fused_flat_kernel<float, 32>": 125,
    "window_fused_flat_kernel<float, 64>": 175,
    # rows 9 and 10 on the tensor cores, as before rows 11-13 joined their
    # tile (window_mma_tile.cuh's row-map paths default to their code; dh
    # 1-8 run in the 16 tile under a head-dim parameter that defaults to it)
    "window_packed_mma_kernel<16, 16>": 40,
    "window_packed_mma_kernel<16, 32>": 40,
    "window_packed_mma_kernel<16, 64>": 63,
    "window_packed_mma_kernel<16, 128>": 127,
    "window_packed_mma_kernel<32, 16>": 40,
    "window_packed_mma_kernel<32, 32>": 40,
    "window_packed_mma_kernel<32, 64>": 64,
    "window_packed_mma_kernel<32, 128>": 127,
    "window_packed_mma_kernel<64, 16>": 48,
    "window_packed_mma_kernel<64, 32>": 53,
    "window_packed_mma_kernel<64, 64>": 78,
    "window_packed_mma_kernel<64, 128>": 128,
    "window_bwd_mma_kernel<16, 16>": 64,
    "window_bwd_mma_kernel<16, 32>": 64,
    "window_bwd_mma_kernel<16, 64>": 102,
    "window_bwd_mma_kernel<16, 128>": 222,
    "window_bwd_mma_kernel<32, 16>": 64,
    "window_bwd_mma_kernel<32, 32>": 72,
    "window_bwd_mma_kernel<32, 64>": 96,
    "window_bwd_mma_kernel<32, 128>": 210,
    "window_bwd_mma_kernel<64, 16>": 102,
    "window_bwd_mma_kernel<64, 32>": 128,
    "window_bwd_mma_kernel<64, 64>": 127,
    "window_bwd_mma_kernel<64, 128>": 207,
    # rows 11 and 10 at every other head dim their JAX plan admits:
    # the padded tiles 16-64, the 64-column chunks above and the fp32
    # 32-column chunks; the first build's counts (no spill)
    "window_batched_chunked_kernel": 71,
    "window_batched_mma_chunked_kernel<16>": 58,
    "window_batched_mma_chunked_kernel<32>": 64,
    "window_batched_mma_chunked_kernel<64>": 80,
    "window_batched_mma_chunked_kernel<128>": 128,
    "window_batched_mma_padded_kernel<16, 16>": 77,
    "window_batched_mma_padded_kernel<16, 32>": 64,
    "window_batched_mma_padded_kernel<16, 64>": 112,
    "window_batched_mma_padded_kernel<16, 128>": 128,
    "window_batched_mma_padded_kernel<32, 16>": 64,
    "window_batched_mma_padded_kernel<32, 32>": 76,
    "window_batched_mma_padded_kernel<32, 64>": 110,
    "window_batched_mma_padded_kernel<32, 128>": 130,
    "window_batched_mma_padded_kernel<64, 16>": 70,
    "window_batched_mma_padded_kernel<64, 32>": 80,
    "window_batched_mma_padded_kernel<64, 64>": 128,
    "window_batched_mma_padded_kernel<64, 128>": 184,
    "window_bwd_chunked_kernel": 107,
    "window_bwd_mma_chunked_kernel<16>": 128,
    "window_bwd_mma_chunked_kernel<32>": 163,
    "window_bwd_mma_chunked_kernel<64>": 166,
    "window_bwd_mma_chunked_kernel<128>": 253,
    "window_bwd_mma_padded_kernel<16, 16>": 64,
    "window_bwd_mma_padded_kernel<16, 32>": 80,
    "window_bwd_mma_padded_kernel<16, 64>": 100,
    "window_bwd_mma_padded_kernel<16, 128>": 219,
    "window_bwd_mma_padded_kernel<32, 16>": 73,
    "window_bwd_mma_padded_kernel<32, 32>": 73,
    "window_bwd_mma_padded_kernel<32, 64>": 99,
    "window_bwd_mma_padded_kernel<32, 128>": 208,
    "window_bwd_mma_padded_kernel<64, 16>": 130,
    "window_bwd_mma_padded_kernel<64, 32>": 130,
    "window_bwd_mma_padded_kernel<64, 64>": 130,
    "window_bwd_mma_padded_kernel<64, 128>": 209,
    # row 8 at every head dim, both routes: the cooperative kernels
    # and the measurement-only phase kernels (Tile 0 exact, 1 padded, 2
    # wide); the first build's counts (ptxas: the 16-64 tiles at the 128
    # registers of two 256-thread blocks an SM, 28-64 bytes spilled as the
    # dh-64 kernel before them; the 128 and wide tiles at one block an SM
    # without spill; fp32 at 128 and the wide tile 40 and 28 bytes)
    "fused_block_kernel<float, 16>": 92,
    "fused_block_kernel<float, 32>": 91,
    "fused_block_kernel<float, 64>": 106,
    "fused_block_padded_kernel<float, 16>": 92,
    "fused_block_padded_kernel<float, 32>": 91,
    "fused_block_padded_kernel<float, 64>": 106,
    "fused_block_padded_kernel<float, 128>": 168,
    "fused_block_wide_kernel<float>": 128,
    "fused_block_kernel<__nv_bfloat16, 16>": 92,
    "fused_block_kernel<__nv_bfloat16, 32>": 91,
    "fused_block_kernel<__nv_bfloat16, 64>": 106,
    "fused_block_padded_kernel<__nv_bfloat16, 16>": 92,
    "fused_block_padded_kernel<__nv_bfloat16, 32>": 91,
    "fused_block_padded_kernel<__nv_bfloat16, 64>": 106,
    "fused_block_padded_kernel<__nv_bfloat16, 128>": 168,
    "fused_block_wide_kernel<__nv_bfloat16>": 128,
    "fused_block_mma_kernel<16, false>": 128,
    "fused_block_mma_kernel<32, false>": 128,
    "fused_block_mma_kernel<64, false>": 128,
    "fused_block_mma_padded_kernel<16, false>": 128,
    "fused_block_mma_padded_kernel<32, false>": 128,
    "fused_block_mma_padded_kernel<64, false>": 128,
    "fused_block_mma_padded_kernel<128, false>": 228,
    "fused_block_mma_wide_kernel<false>": 246,
    "fused_block_mma_phase_kernel<(Tile)0, 16, false>": 128,
    "fused_block_mma_phase_kernel<(Tile)0, 32, false>": 128,
    "fused_block_mma_phase_kernel<(Tile)0, 64, false>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 16, false>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 32, false>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 64, false>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 128, false>": 226,
    "fused_block_mma_phase_kernel<(Tile)2, 0, false>": 246,
    "fused_block_mma_kernel<16, true>": 128,
    "fused_block_mma_kernel<32, true>": 128,
    "fused_block_mma_kernel<64, true>": 128,
    "fused_block_mma_padded_kernel<16, true>": 128,
    "fused_block_mma_padded_kernel<32, true>": 128,
    "fused_block_mma_padded_kernel<64, true>": 128,
    "fused_block_mma_padded_kernel<128, true>": 228,
    "fused_block_mma_wide_kernel<true>": 246,
    "fused_block_mma_phase_kernel<(Tile)0, 16, true>": 128,
    "fused_block_mma_phase_kernel<(Tile)0, 32, true>": 128,
    "fused_block_mma_phase_kernel<(Tile)0, 64, true>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 16, true>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 32, true>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 64, true>": 128,
    "fused_block_mma_phase_kernel<(Tile)1, 128, true>": 226,
    "fused_block_mma_phase_kernel<(Tile)2, 0, true>": 246,
}
# The global loads of fused_block_kernel<float, D> (row 8's CUDA-core route)
# that took the non-coherent path (SASS .CONSTANT) before its phases read the
# QKV and attention workspaces through L2, by cuobjdump -sass: none (the
# kernel takes its pointers in a struct, which nvcc did not treat as
# read-only); the L2 loads make that hold by construction, not by the
# compiler's choice.
FUSED_BLOCK_NC_LOADS_BEFORE = {16: 0, 32: 0, 64: 0}


def ptxas_usage(build_log):
    """[(source, kernel, registers, smem bytes, spill store bytes, stack
    bytes)] of every kernel ``nvcc -Xptxas -v`` compiled, from its output;
    the kernel named as ``c++filt`` reads its mangled name, without the
    argument list."""
    found = []
    for src, out in build_log.items():
        kernel, spill, stack = None, 0, 0
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel, spill, stack = m.group(1), 0, 0
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                          line)
            if m:
                stack, spill = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                          line)
            if m and kernel is not None:
                found.append([src, kernel, int(m.group(1)),
                              int(m.group(2) or 0), spill, stack])
                kernel = None
    if shutil.which("c++filt") is None:  # the mangled names, then
        return [tuple(f) for f in found]
    names = subprocess.run(["c++filt"], input="\n".join(f[1] for f in found),
                           capture_output=True, text=True, timeout=60,
                           check=True).stdout.splitlines()
    for f, name in zip(found, names):
        f[1] = _kernel_name(name.replace("(anonymous namespace)::", ""))
    return [tuple(f) for f in found]


def _kernel_name(demangled):
    """``void k<T, 16>(Params)`` → ``k<T, 16>``: the name up to its
    argument list, template arguments kept whole (an enum argument prints
    as ``(Tile)1``)."""
    depth = 0
    for i, ch in enumerate(demangled):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            demangled = demangled[:i]
            break
    return demangled.removeprefix("void ")


def sass_global_loads(lib, kernel_re):
    """{D: (global loads, of them .CONSTANT, of them .STRONG.GPU)} of the
    kernels of the library ``lib`` whose mangled names match ``kernel_re``
    (its group 1 the head dim; 0 for a pattern without a group), from
    ``cuobjdump -sass``: .CONSTANT is the
    non-coherent path (ld.global.nc), .STRONG.GPU the loads through L2
    (ld.global.cg, ``__ldcg``)."""
    from vision_transformers_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    found, d = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(kernel_re, m.group(1))
            d = (int(k.group(1)) if k.lastindex else 0) if k else None
            if d is not None:
                found[d] = [0, 0, 0]
            continue
        if d is not None and re.search(r"\bLDG\b|\bLDG\.", line):
            found[d][0] += 1
            found[d][1] += ".CONSTANT" in line
            found[d][2] += ".STRONG.GPU" in line
    return {k: tuple(v) for k, v in sorted(found.items())}


def bound_ms(bytes_moved: float, flops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_chain_weights(randn, dtype):
    """The weights of benchmarks/ln_fused.py's ViT-B/16 layer (D 768, MLP
    3072): LN scale and shift, QKV, out, fc1 and fc2 kernels (in, out) and
    their biases; fp32 rows, kernels in ``dtype``."""
    import torch

    d, mlp = 768, 3072
    f32 = torch.float32
    ones = torch.ones(d, device="cuda")
    zeros = lambda n: torch.zeros(n, device="cuda")  # noqa: E731
    kernel = lambda seed, k, n: (0.02 * randn(seed, k, n, dtype=f32)).to(  # noqa: E731
        dtype)
    return dict(gamma=ones, beta=zeros(d), wqkv=kernel(141, d, 3 * d),
                bqkv=zeros(3 * d), wout=kernel(142, d, d), bout=zeros(d),
                w1=kernel(143, d, mlp), b1=zeros(mlp), w2=kernel(144, mlp, d),
                b2=zeros(d))


def base_ln_dense(x, gamma, beta, w, bias=None, *, eps=1e-6, activation=None):
    """``ln_dense`` from library calls: ``F.layer_norm`` → ``F.linear``
    (+ ``F.gelu``), in x's dtype (the ln_fused benchmark's "base" layer)."""
    import torch.nn.functional as F

    xn = F.layer_norm(x, (x.shape[-1],), gamma.to(x.dtype), beta.to(x.dtype),
                      eps)
    y = F.linear(xn, w.t(), None if bias is None else bias.to(x.dtype))
    if activation is not None:
        y = F.gelu(y, approximate="tanh" if activation == "gelu_tanh"
                   else "none")
    return y


def ln_fused_chain(x, c, dense, attention, layers=12, heads=12):
    """benchmarks/ln_fused.py's layer, ``layers`` times: x + out(attn(
    dense(ln_1, QKV))); x + fc2(dense(ln_2, fc1, GELU))."""
    import torch.nn.functional as F

    for _ in range(layers):
        y = attention(dense(x, c["gamma"], c["beta"], c["wqkv"], c["bqkv"]),
                      heads)
        x = x + F.linear(y, c["wout"].t(), c["bout"].to(x.dtype))
        y = dense(x, c["gamma"], c["beta"], c["w1"], c["b1"],
                  activation="gelu_tanh")
        x = x + F.linear(y, c["w2"].t(), c["b2"].to(x.dtype))
    return x


def narrow_detr_gradients():
    """fp32 parameter gradients of a narrow DETR (hidden 32, 1 + 2 layers,
    full ResNet-50, two images at 128 x 160) on the CPU and on the card from
    the same weights, held to ``DETR_GRAD_TOL``; then the diagnosis of the
    ReLU after ``layer4_block2.conv1`` (see ``relu_mask_diagnosis``). Returns
    the card run's kernel launches."""
    import torch

    from vision_transformers_tpu_torch.models.object_detection import (
        Detr,
        HungarianMatcher,
        SetCriterion,
        prepare_targets,
    )
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.utils.coco.util.misc import (
        nested_tensor_from_tensor_list,
    )
    from vision_transformers_tpu_torch.utils.port_jax import (
        detr_state_dict_from_jax,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    narrow = dict(num_classes=91, hidden_dim=32, nheads=2,
                  num_encoder_layers=1, num_decoder_layers=2,
                  dim_feedforward=64, dropout=0.0, aux_loss=True)
    nds = SyntheticCoco([(128, 150), (100, 160)], seed=16)
    ntn = nested_tensor_from_tensor_list([nds[i][0] for i in range(2)],
                                         size_bucket=32)
    require(ntn.tensors.shape == (2, 128, 160, 3), "narrow batch 128 x 160")
    ncrit = SetCriterion(num_classes=91,
                         matcher=HungarianMatcher(method="scipy"))
    nweights, launches = None, None
    grads, taps = {}, {}
    fa.USE_PALLAS_BWD = True
    for device in ("cpu", "cuda"):
        m = Detr(**narrow, device=device)
        if nweights is None:
            nweights = detr_state_dict_from_jax(jax_shaped_weights(m, 17))
        m.load_state_dict(nweights, strict=True)
        m.train()
        taps[device] = tap_relu_after_conv1(
            m.get_submodule("joiner.backbone.layer4_block2"))
        fa.reset_launch_counts()
        b = ntn.to(device)
        labels, boxes, valid = prepare_targets([nds[i][1] for i in range(2)],
                                               64, 91, device)
        loss = ncrit.total_loss(ncrit(m(b.tensors, b.mask), labels, boxes,
                                      valid))
        loss.backward()
        grads[device] = (loss.item(), {n: p.grad.detach().cpu()
                                       for n, p in m.named_parameters()
                                       if p.grad is not None})
        if device == "cuda":
            launches = {k: v for k, v in fa.LAUNCHES.items() if v}
            require(launches == {"flash_attention_large": 3,
                                 "flash_attention": 2,
                                 "flash_attention_bwd": 2,
                                 "dropout_attention_bwd": 3},
                    f"narrow DETR gradients went through rows 3, 2, 4, 6; "
                    f"got {launches}")
    fa.USE_PALLAS_BWD = False
    g_ref = max(g.abs().max().item() for g in grads["cpu"][1].values())
    require(set(grads["cpu"][1]) == set(grads["cuda"][1]),
            "the same parameters take gradients on both devices")
    e_grad, worst = max((max_err(grads["cuda"][1][n], g), n)
                        for n, g in grads["cpu"][1].items())
    log(f"fp32 gradients of a narrow DETR (hidden 32, 1 + 2 layers, "
        f"ResNet-50, 128 x 160), card vs CPU: loss {grads['cuda'][0]:.6f} vs "
        f"{grads['cpu'][0]:.6f}, max|dgrad| {e_grad:.3e} over "
        f"{len(grads['cpu'][1])} tensors, at {worst} (its max|ref| "
        f"{grads['cpu'][1][worst].abs().max().item():.3e}; max|ref| "
        f"{g_ref:.3e}, tol {DETR_GRAD_TOL} x max(1, max|ref|))")
    diag = relu_mask_diagnosis(
        taps, grads["cpu"][1]["joiner.backbone.layer4_block2.conv1.weight"],
        grads["cuda"][1]["joiner.backbone.layer4_block2.conv1.weight"], g_ref)
    require(diag["CPU mask, card dy"] <= RELU_MASK_TOL * max(1.0, g_ref),
            "layer4_block2.conv1's gradient with the CPU's ReLU mask matches "
            "the CPU's: the gap is the ReLU's flipped pre-activations")
    require(abs(grads["cuda"][0] - grads["cpu"][0])
            <= 1e-4 * max(1.0, abs(grads["cpu"][0]))
            and e_grad <= DETR_GRAD_TOL * max(1.0, g_ref),
            "narrow DETR gradients on the card against the CPU")
    return launches


def tap_relu_after_conv1(block):
    """Hooks on a ResNet bottleneck that keep, from one forward and
    backward: conv1's input x, the pre-activation z = bn1(conv1(x)) of the
    first ReLU, the gradient dy arriving at that ReLU's output (conv2's
    input) and bn1's per-channel scale."""
    import torch

    tap = {}

    def keep_dy(_, args):
        args[0].register_hook(lambda g: tap.__setitem__("dy", g.detach()))

    block.conv1.register_forward_pre_hook(
        lambda _, args: tap.__setitem__("x", args[0].detach()))
    block.bn1.register_forward_hook(
        lambda _, args, out: tap.__setitem__("z", out.detach()))
    block.conv2.register_forward_pre_hook(keep_dy)
    bn = block.bn1
    tap["inv"] = (bn.weight * torch.rsqrt(bn.var + bn.epsilon)).detach()
    tap["w_shape"] = block.conv1.weight.shape
    return tap


def relu_mask_diagnosis(taps, grad_cpu, grad_card, g_ref):
    """The hypothesis for the card-vs-CPU gradient gap of
    ``layer4_block2.conv1.weight``: pre-activations within fp32 rounding of
    0 take opposite sides of the ReLU on the two devices. Counts them, then
    recomputes that weight gradient on the card from the card's x and dy
    with each device's ReLU mask (and, to attribute the rest, with the
    CPU's dy), against the CPU's gradient. Logs and returns the numbers."""
    import torch

    cpu, card = taps["cpu"], taps["cuda"]
    z_cpu, z_card = cpu["z"], card["z"].cpu()
    near = {d: int((t["z"].abs() <= 1e-6 * t["z"].abs().max()).sum().item())
            for d, t in taps.items()}
    flips = int(((z_cpu > 0) != (z_card > 0)).sum().item())
    dev = card["x"].device

    def weight_grad(mask, dy):
        """d loss / d conv1.weight of a 1x1 conv: Σ x ⊗ (dy·mask·inv)."""
        dz = (dy.to(dev) * mask.to(dev) * card["inv"]).permute(0, 3, 1, 2)
        return torch.nn.grad.conv2d_weight(card["x"].permute(0, 3, 1, 2),
                                           card["w_shape"], dz).cpu()

    mask_cpu, mask_card = z_cpu > 0, z_card > 0
    rows = {
        "card mask, card dy (autograd's)": weight_grad(mask_card, card["dy"]),
        "CPU mask, card dy": weight_grad(mask_cpu, card["dy"]),
        "card mask, CPU dy": weight_grad(mask_card, cpu["dy"]),
        "CPU mask, CPU dy": weight_grad(mask_cpu, cpu["dy"]),
    }
    out = {"near_zero_cpu": near["cpu"], "near_zero_card": near["cuda"],
           "opposite_signs": flips, "elements": z_cpu.numel(),
           "autograd_gap": max_err(grad_card, grad_cpu),
           "recompute_vs_autograd": max_err(
               rows["card mask, card dy (autograd's)"], grad_card),
           "dy_diff": max_err(card["dy"].cpu(), cpu["dy"]),
           "g_ref": g_ref}
    log(f"layer4_block2 ReLU after conv1: {z_cpu.numel()} pre-activations, "
        f"{near['cpu']} (CPU) / {near['cuda']} (card) within 1e-6 x max|z| of "
        f"0, {flips} on opposite sides of 0 on the two devices; "
        f"max|dy card - dy CPU| {out['dy_diff']:.3e}")
    log(f"  conv1.weight gradient, card autograd vs CPU: "
        f"{out['autograd_gap']:.3e} ({out['autograd_gap'] / g_ref:.2e} of "
        f"max|ref| {g_ref:.3e}); the recompute vs card autograd "
        f"{out['recompute_vs_autograd']:.3e}")
    for label, g in rows.items():
        e = max_err(g, grad_cpu)
        out[label] = e
        log(f"  recomputed on the card with {label}: vs CPU {e:.3e} "
            f"({e / g_ref:.2e} relative)")
    return out


# ViT-H/14 (Dosovitskiy et al. 2020, "An Image is Worth 16x16 Words",
# Table 1): 32 layers, hidden 1280, MLP 5120, 16 heads (dh 80), patch 14;
# 1000 classes. Built from ViT's keyword arguments (the JAX package's
# ``vit_huge`` preset is its CIFAR configuration), seeded weights.
VITH14 = dict(patch_size=14, num_layers=32, num_heads=16, hidden_dim=1280,
              mlp_dim=5120, num_classes=1000)
# The share of a seeded batch whose full-depth bf16 argmax equals the
# full-depth fp32 one on the card. bf16 rounds every activation through 32
# layers, which moves the logits by a few percent of their spread, and the
# top two of 1000 seeded logits lie closer than that in some rows; a floor
# far above chance (1/1000) that a wrong function cannot reach.
VITH_ARGMAX_FLOOR = 0.5


class RowChecks:
    """Rows 1-7 against their plain versions on the card, at a head dim and
    shape of the caller's: into outputs pre-filled with NaN (every element
    must be written), reruns bit-equal, the route by kernel name
    (``route(row, d)`` names the ROUTE_NAMES row a head dim takes), each
    largest error into ``errs``. Phases 7d and 7e; ``tag`` starts their log
    lines."""

    def __init__(self, tag, route, errs):
        import torch

        self.tag, self.route, self.errs = tag, route, errs
        self.dev = torch.device("cuda")

    def randn(self, seed, *shape, dtype):
        import torch

        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn(*shape, generator=g).to(self.dev, dtype)

    @staticmethod
    def nan_like(t):
        import torch

        return torch.full_like(t, float("nan"))

    @staticmethod
    def grad_tol(name, ref):
        tol = MMA_GRAD_TOL if name == "bfloat16" else GRAD_TOL[name]
        return tol * max(1.0, ref.float().abs().max().item())

    @staticmethod
    def fwd_tol(name, sk, ref):
        # bf16 at Sk >= 1000: |out| stays well below 1 (rows 3 and 5)
        if name == "bfloat16" and sk >= 1000:
            return MASKED_FWD_TOL * max(1.0, ref.float().abs().max().item())
        return KERNEL_TOL[name]

    # ---- rows 1 and 7 ------------------------------------------------------
    def check_packed(self, label, b, s, h, dh, dtype, rate):
        import torch

        from vision_transformers_tpu_torch.ops import flash_attention as fa

        name = str(dtype).removeprefix("torch.")
        qkv = self.randn(200 + dh, b, s, 3 * h * dh, dtype=dtype)
        do = self.randn(300 + dh, b, s, h * dh, dtype=dtype)
        kw = dict(dropout_rate=rate, seed=9090 + (dh << 36) if rate else None)
        got = []
        require_route(
            f"{self.tag} {label} {name} rate {rate} fwd", lambda: got.append(
            fa.packed_flash_attention_fwd(
                qkv, h, **kw, out=torch.full((b, s, h * dh), float("nan"),
                                             dtype=dtype, device=self.dev),
                lse=torch.full((b, s, h), float("nan"), device=self.dev))),
            [(self.route("row 1", dh), name)])
        out, lse = got[0]
        ref, ref_lse = fa.packed_flash_attention_reference(qkv, h, **kw)
        again = fa.packed_flash_attention_fwd(qkv, h, **kw)
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        require(bool(torch.isfinite(out.float()).all())
                and bool(torch.isfinite(lse).all())
                and e <= KERNEL_TOL[name] and el <= LSE_TOL
                and torch.equal(again[0], out) and torch.equal(again[1], lse),
                f"{self.tag} {label} {name} rate {rate}: row 1 against its plain "
                f"version ({e:.3e}, lse {el:.3e}), every element written, "
                "rerun bit-equal")
        gotb = []
        require_route(
            f"{self.tag} {label} {name} rate {rate} bwd", lambda: gotb.append(
            fa.packed_flash_attention_bwd(qkv, do, out, lse, h, **kw,
                                          dqkv=self.nan_like(qkv))),
            [(self.route("row 7", dh), name)])
        dref = fa.packed_flash_attention_bwd_reference(qkv, do, out, lse, h,
                                                       **kw)
        eg, tol = max_err(gotb[0], dref), self.grad_tol(name, dref)
        againb = fa.packed_flash_attention_bwd(qkv, do, out, lse, h, **kw)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(gotb[0].float()).all()) and eg <= tol
                and torch.equal(againb, gotb[0]),
                f"{self.tag} {label} {name} rate {rate}: row 7 against its plain "
                f"version ({eg:.3e} > {tol:.3e}?), every element written, "
                "rerun bit-equal")
        msg = ""
        if rate:  # the next seed's mask is far off: the oracle sees masks
            other = fa.packed_flash_attention_reference(
                qkv, h, dropout_rate=rate, seed=kw["seed"] + 1)[0]
            fault = max_err(other, ref)
            require(fault > KERNEL_TOL[name], f"{self.tag} {label} {name}: the "
                    f"planted fault (the next seed's mask) {fault:.3e} "
                    f"exceeds {KERNEL_TOL[name]}")
            msg = f", planted fault (next seed's mask) {fault:.3e}"
        log(f"{self.tag} packed {label} {name} rate {rate}: row 1 max|out-plain| "
            f"{e:.3e} (tol {KERNEL_TOL[name]}), max|lse-plain| {el:.3e}; "
            f"row 7 max|dqkv-plain| {eg:.3e} (tol {tol:.3e}){msg}; every "
            "element written, reruns bit-equal")
        self.errs[("row 1", label, name, rate)] = e
        self.errs[("row 7", label, name, rate)] = eg

    # ---- rows 2, 5 and 6 ---------------------------------------------------
    def check_split(self, label, b, h, s, d, dtype, rate, masked=False):
        import torch

        from vision_transformers_tpu_torch.ops import flash_attention as fa

        name = str(dtype).removeprefix("torch.")
        q, k, v, do = (self.randn(400 + 4 * d + i, b, h, s, d, dtype=dtype)
                       for i in range(4))
        key_mask = None
        if masked:
            m = np.random.RandomState(d).rand(b, s) > 0.3
            m[:, 0] = True
            key_mask = torch.from_numpy(m).to(self.dev)
        kw = dict(dropout_rate=rate, seed=7070 + (d << 36) if rate else None,
                  key_mask=key_mask)
        got = []
        if rate == 0.0 and key_mask is None:
            row = "row 2"
            fwd = lambda **o: fa.flash_attention_fwd(q, k, v, **o)  # noqa: E731
            ref, ref_lse = fa.flash_attention_reference(q, k, v)
        else:
            row = "row 5"
            fwd = lambda **o: fa.flash_dropout_attention_fwd(  # noqa: E731
                q, k, v, **kw, **o)
            ref, ref_lse = fa.flash_dropout_attention_reference(q, k, v, **kw)
        require_route(
            f"{self.tag} {label} {name} rate {rate} fwd", lambda: got.append(
            fwd(out=self.nan_like(q), lse=torch.full((b, h, s), float("nan"),
                                                device=self.dev))),
            [(self.route(row, d), name)])
        (out, lse), again = got[0], fwd()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        tol = self.fwd_tol(name, s, ref)
        require(bool(torch.isfinite(out.float()).all())
                and bool(torch.isfinite(lse).all()) and e <= tol
                and el <= LSE_TOL and torch.equal(again[0], out)
                and torch.equal(again[1], lse),
                f"{self.tag} {label} {name} rate {rate}: {row} against its plain "
                f"version ({e:.3e} > {tol}?), every element written, rerun "
                "bit-equal")
        gotb = []
        require_route(
            f"{self.tag} {label} {name} rate {rate} bwd", lambda: gotb.append(
            fa.flash_dropout_attention_bwd(
                q, k, v, do, ref, ref_lse, **kw,
                grads=tuple(self.nan_like(t) for t in (q, k, v)))),
            [(self.route("row 6", d), name)])
        want = fa.flash_dropout_attention_bwd_reference(q, k, v, do, ref,
                                                        ref_lse, **kw)
        againb = fa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
        torch.cuda.synchronize()
        eg = 0.0
        for n, g_, w_, a_ in zip("qkv", gotb[0], want, againb):
            eg_, tg = max_err(g_, w_), self.grad_tol(name, w_)
            require(bool(torch.isfinite(g_.float()).all()) and eg_ <= tg
                    and torch.equal(a_, g_),
                    f"{self.tag} {label} {name} rate {rate}: row 6 d{n} against its "
                    f"plain version ({eg_:.3e} > {tg:.3e}?), every element "
                    "written, rerun bit-equal")
            eg = max(eg, eg_)
        log(f"{self.tag} split {label} {name} rate {rate}: {row} max|out-plain| "
            f"{e:.3e} (tol {tol:.3e}), max|lse-plain| {el:.3e}; row 6 "
            f"max|grad-plain| {eg:.3e}; every element written, reruns "
            "bit-equal")
        self.errs[(row, label, name, rate)] = e
        self.errs[("row 6", label, name, rate)] = eg

    # ---- row 3 -------------------------------------------------------------
    def check_large(self, label, b, h, sq, sk, d, dtype, keep=None, kv_valid=None):
        import torch

        from vision_transformers_tpu_torch.ops import flash_attention as fa

        name = str(dtype).removeprefix("torch.")
        q = self.randn(500 + d, b, h, sq, d, dtype=dtype)
        k, v = (self.randn(501 + d + i, b, h, sk, d, dtype=dtype) for i in (0, 1))
        got = []
        require_route(f"{self.tag} {label} {name}", lambda: got.append(
            fa.flash_attention_large_fwd(q, k, v, kv_mask=keep,
                                         kv_valid=kv_valid,
                                         out=self.nan_like(q))),
            [(self.route("row 3", d), name)])
        out, lse = got[0]
        ref, ref_lse = fa.flash_attention_large_reference(
            q, k, v, kv_mask=keep, kv_valid=kv_valid)
        again = fa.flash_attention_large_fwd(q, k, v, kv_mask=keep,
                                             kv_valid=kv_valid)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        tol = self.fwd_tol(name, sk, ref)
        require(bool(torch.isfinite(out.float()).all()) and e <= tol
                and el <= LSE_TOL and torch.equal(again[0], out),
                f"{self.tag} {label} {name}: row 3 against its plain version "
                f"({e:.3e} > {tol:.3e}?), every element written, rerun "
                "bit-equal")
        log(f"{self.tag} large {label} {name}: row 3 max|out-plain| {e:.3e} (tol "
            f"{tol:.3e}), max|lse-plain| {el:.3e}; every element written, "
            "rerun bit-equal")
        self.errs[("row 3", label, name)] = e

    # ---- row 4 -------------------------------------------------------------
    def check_small_bwd(self, label, b, h, s, d, dtype):
        import torch

        from vision_transformers_tpu_torch.ops import flash_attention as fa

        name = str(dtype).removeprefix("torch.")
        require(fa.flash_bwd_supported(s, s, d), f"{self.tag} {label}: row 4's "
                "route admits the shape")
        q, k, v, do = (self.randn(600 + 4 * d + i, b, h, s, d, dtype=dtype)
                       for i in range(4))
        out, lse = fa.flash_attention_reference(q, k, v)
        got = []
        require_route(f"{self.tag} {label} {name}", lambda: got.append(
            fa.flash_attention_bwd(
                q, k, v, out, lse, do,
                grads=tuple(self.nan_like(t) for t in (q, k, v)))),
            [(self.route("row 4", d), name)])
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do)
        torch.cuda.synchronize()
        eg = 0.0
        for n, g_, w_, a_ in zip("qkv", got[0], want, again):
            eg_, tg = max_err(g_, w_), self.grad_tol(name, w_)
            require(bool(torch.isfinite(g_.float()).all()) and eg_ <= tg
                    and torch.equal(a_, g_),
                    f"{self.tag} {label} {name}: row 4 d{n} against its plain "
                    f"version ({eg_:.3e} > {tg:.3e}?), every element written, "
                    "rerun bit-equal")
            eg = max(eg, eg_)
        log(f"{self.tag} small-S bwd {label} {name}: row 4 max|grad-plain| {eg:.3e};"
            " every element written, rerun bit-equal")
        self.errs[("row 4", label, name)] = eg



# Row 16 at SwinV2-B @256 w16's stage 1 at batch 128: (label, bias lead);
# the lead 1 bias is shared by every window (bias_g = H), the lead 16 one
# (the shifted block's) by the same window of every image (bias_g = 16·H).
BIAS_BWD_STAGE1 = (("stage 1", 1), ("stage 1 shifted", 16))
# Row 16 against its plain version, the limits of the card tests
# (tests/test_torch_port_kernels.py, where each one's reason is): dq, dk, dv
# within one bf16 step at the largest element, at most BIAS_BWD_OFF_STEP of
# their elements more than one step of their own apart, dbias (fp32) within
# BIAS_BWD_DBIAS_TOL of its largest element.
BIAS_BWD_TOL = 8e-3
BIAS_BWD_OFF_STEP = 1e-3
BIAS_BWD_DBIAS_TOL = 1e-5


def off_step_share(got, ref) -> float:
    """Share of elements more than one bf16 step of ``ref`` apart."""
    import torch

    ref, got = ref.float(), got.float()
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                      - 7)
    return float(((got - ref).abs() > step * 1.001).float().mean())


def bias_bwd_one_rounding(q, k, v, bias, do, out, lse, *, scale, kv_valid):
    """The plain version with p and dS rounded once to bf16 before their
    products (a planted fault: the bias-free backward's numerics) → (dq, dk,
    dv)."""
    import torch
    from vision_transformers_tpu_torch.ops import flash_attention as fa

    p = torch.exp(fa._biased_scores(q, k, bias, scale, kv_valid)
                  - lse.unsqueeze(-1))
    dof = do.float()
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), dof).bfloat16()
    p.mul_(torch.matmul(dof, v.float().transpose(-1, -2))
           - (dof * out.float()).sum(-1, keepdim=True))
    ds = p.bfloat16().float()
    del p
    dq = (torch.matmul(ds, k.float()) * scale).bfloat16()
    dk = (torch.matmul(ds.transpose(-1, -2), q.float()) * scale).bfloat16()
    return dq, dk, dv


def bias_bwd_phase():
    """Phase 7h: row 16 at ``BIAS_BWD_STAGE1``, then a SwinV2-B @256 w16
    train step. Returns {label: numbers}, with the step's under
    "swinv2_b step"."""
    import torch
    import torch.nn.functional as F
    from vision_transformers_tpu_torch.models.image_classification import (
        SwinTransformerV2,
    )
    from vision_transformers_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    b, h, n, d = 2048, 4, 256, 32
    numbers = {}
    for label, lead in BIAS_BWD_STAGE1:
        gen = torch.Generator().manual_seed(27)
        q, k, v, do = (torch.randn(b, h, n, d, generator=gen).to(
            dev, torch.bfloat16) for _ in range(4))
        bias = (2 * torch.randn(lead, h, n, n, generator=gen)).to(dev)
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        kw = dict(scale=d ** -0.5, kv_valid=n)
        args = (q, k, v, bias, do, out, lse)

        def call():
            return fa.flash_attention_bias_bwd(*args, **kw)

        require_route(f"row 16 at SwinV2-B {label}", call,
                      [("row 16", "bfloat16")])
        got, again = call(), call()
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"row 16 {label}: two runs give equal bits")
        del again
        ref = fa.flash_attention_bias_bwd_reference(*args, **kw)
        errs, off, fault_off = {}, {}, {}
        for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
            top = float(r.float().abs().max())
            errs[name] = max_err(g, r) / top
            if name == "dbias":
                require(errs[name] <= BIAS_BWD_DBIAS_TOL,
                        f"row 16 {label}: dbias within {BIAS_BWD_DBIAS_TOL} "
                        f"of its largest element ({errs[name]:.3e})")
                continue
            off[name] = off_step_share(g, r)
            require(errs[name] <= BIAS_BWD_TOL and off[name]
                    <= BIAS_BWD_OFF_STEP,
                    f"row 16 {label}: {name} within {BIAS_BWD_TOL} of its "
                    f"largest element ({errs[name]:.3e}), at most "
                    f"{BIAS_BWD_OFF_STEP} of it over one step ({off[name]:.3e})")
        fault = bias_bwd_one_rounding(*args, **kw)
        for name, f_, r in zip(("dq", "dk", "dv"), fault, ref):
            fault_off[name] = off_step_share(f_, r)
            require(fault_off[name] > 10 * BIAS_BWD_OFF_STEP,
                    f"row 16 {label}: the planted one-rounding fault's {name} "
                    f"fails the limits ({fault_off[name]:.3e} over one step)")
        abs_err = max(max_err(g, r) for g, r in zip(got[:3], ref[:3]))
        del ref, fault
        kernel_ms = cuda_ms(call, iters=10)
        plain_ms = cuda_ms(
            lambda: fa.flash_attention_bias_bwd_reference(*args, **kw),
            iters=3, warmup=1)
        # the bias as a bf16 (B, H, N, N) mask whose gradient SDPA takes
        mask = bias.to(torch.bfloat16).repeat(b // lead, 1, 1, 1)
        leaves = [t.detach().requires_grad_() for t in (q, k, v, mask)]
        sdpa_out = F.scaled_dot_product_attention(*leaves[:3],
                                                  attn_mask=leaves[3])
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            sdpa_out, leaves, do, retain_graph=True), iters=5)
        del sdpa_out, leaves, mask
        flops = 10 * b * h * n * n * d
        moved = 8 * b * h * n * d * 2 + 2 * lead * h * n * n * 4
        bound, by = bound_ms(moved, flops, "bfloat16")
        numbers[label] = dict(
            kernel_ms=kernel_ms, bound_ms=bound, bound_by=by,
            plain_ms=plain_ms, library_ms=library_ms,
            tflops=flops / kernel_ms / 1e9, errors=errs,
            max_abs_err=abs_err,
            off_step=off, fault_off_step=fault_off, moved=moved, flops=flops,
            plan=fa.bias_bwd_plan(b * h, lead * h, n, n, d)._asdict())
        log(f"row 16 {label} (G {b}, H {h}, N {n}, dh {d}, bias_g "
            f"{lead * h}): kernel {kernel_ms:.3f} ms "
            f"({flops / kernel_ms / 1e9:.1f} TFLOP/s of 10·G·H·N²·dh), "
            f"bound {bound:.3f} ms ({by}), plain {plain_ms:.3f} ms, SDPA "
            f"autograd backward {library_ms:.3f} ms; max error over the "
            f"largest plain element {errs}, share over one step {off}, the "
            f"one-rounding fault's {fault_off}")
        del q, k, v, do, bias, out, lse, got, args

    # one bf16 train step of SwinV2-B @256 w16 (its published widths, no
    # stochastic depth) at batch 8: stages 1-3 are the split-head path, 22
    # biased backwards a step, each of which must launch row 16
    model = SwinTransformerV2(
        image_size=256, patch_size=[4, 4], embed_dim=128,
        depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32], window_size=[16, 16],
        mlp_ratio=4.0, dropout=0.0, attention_dropout=0.0,
        stochastic_depth_prob=0.0, num_classes=1000, clip_window=True,
        dtype=torch.bfloat16, device=dev)
    model.train()
    gen = torch.Generator().manual_seed(28)
    x = torch.randn(8, 256, 256, 3, generator=gen).to(dev)
    model(x).float().sum().backward()  # builds every kernel of the step
    torch.cuda.synchronize()
    fa.reset_launch_counts()
    model.zero_grad(set_to_none=True)
    model(x).float().sum().backward()
    torch.cuda.synchronize()
    step = dict(calls=fa.BIAS_BWD["calls"],
                launches=fa.LAUNCHES["flash_attention_bias_bwd"],
                plain_on_card=fa.BIAS_BWD["plain_on_card"])
    require(step["calls"] == 22 and step["launches"] == 22
            and step["plain_on_card"] == 0
            and all(bool(torch.isfinite(p_.grad).all())
                    for p_ in model.parameters() if p_.grad is not None),
            f"SwinV2-B @256 w16 bf16 train step at batch 8: 22 biased "
            f"backwards, each row 16's kernel, none plain on the card, finite "
            f"gradients ({step})")
    log(f"SwinV2-B @256 w16 bf16 train step, batch 8: BIAS_BWD calls "
        f"{step['calls']}, row 16 launches {step['launches']}, plain on the "
        f"card {step['plain_on_card']}")
    numbers["swinv2_b step"] = step
    del model, x
    return numbers


def vith_route(row: str, d: int) -> str:
    """The ROUTE_NAMES row that a head dim d takes: rows 1 and 7 run any d
    but 16, 32 and 64 in their padded kernels, rows 2-6 any d but 16, 32,
    64 and 128."""
    own = (16, 32, 64) if row in ("row 1", "row 7") else (16, 32, 64, 128)
    return row if d in own else f"{row} padded"


def vith_phase(det_keep):
    """Phase 7d: rows 1-7 at the head dims they took in this slice, and
    ViT-H/14 served and trained at full width and depth. Returns (the
    launches of its model runs by wrapper, the rows' times at dh 80 by
    wrapper name, the new checks' errors, the model numbers)."""
    import torch
    import torch.nn.functional as F

    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.training import trainer
    from vision_transformers_tpu_torch.training.optimizers import (
        make_optimizer,
    )

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    errs = {}

    def randn(seed, *shape, dtype):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn(*shape, generator=g).to(dev, dtype)

    chk = RowChecks("vith", vith_route, errs)
    det_b, det_sk = det_keep.shape
    for dtype in (bf16, fp32):
        for rate in (0.0, 0.1):
            chk.check_packed("ViT-H/14@224 B32 S257 H16 dh80", 32, 257, 16,
                             80, dtype, rate)
            chk.check_split("ViT-H/14@336 B4 H16 S577 D80", 4, 16, 577, 80,
                            dtype, rate)
            for dh in (12, 96, 128, 77):
                chk.check_packed(f"B4 S197 H4 dh{dh}", 4, 197, 4, dh, dtype,
                                 rate)
            chk.check_split("B2 H3 S150 D77", 2, 3, 150, 77, dtype, rate,
                            rate > 0)
        chk.check_large("ViT-H/14@518 B4 H16 S1370 D80", 4, 16, 1370, 1370,
                        80, dtype)
        chk.check_large("DETR-R50 encoder B4 H8 S4704 D80 COCO masks", det_b,
                        8, det_sk, det_sk, 80, dtype, keep=det_keep)
        for d in (12, 128, 77):
            chk.check_large(f"B2 H4 S1300 D{d} masked", 2, 4, 1300, 1300, d,
                            dtype, keep=det_keep[:2, :1300])
        chk.check_small_bwd("ViT-H/14@224 B2 H16 S257 D80", 2, 16, 257, 80,
                            dtype)
        for d, s in ((12, 257), (128, 100), (77, 150)):
            chk.check_small_bwd(f"B2 H4 S{s} D{d}", 2, 4, s, d, dtype)
    log(f"vith kernel checks in {time.perf_counter() - t_phase:.1f} s")

    # ---- the rows' times at ViT-H/14's dh 80 (bf16) -----------------------
    def sdpa_grad(q, k, v, do, p):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, dropout_p=p)
        return lambda: torch.autograd.grad(out, (q, k, v), do,
                                           retain_graph=True)

    times = {}

    def put(name, key, k_ms, p_ms, l_ms, nbytes, flops):
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        times.setdefault(name, {}).update({
            f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
            f"{key}_library_ms": l_ms, f"{key}_bound_ms": bnd,
            f"{key}_bound_by": by, f"{key}_tflops": flops / k_ms / 1e9})
        log(f"vith time {name} {key}: kernel {k_ms:.4f} ms, bound {bnd:.4f} "
            f"ms ({by}), plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms, "
            f"{flops / k_ms / 1e9:.1f} TFLOP/s")

    b, s, h, dh = 32, 257, 16, 80
    qkv = randn(700, b, s, 3 * h * dh, dtype=bf16)
    do = randn(701, b, s, h * dh, dtype=bf16)
    qv, kv, vv = (t.view(b, s, h, dh).transpose(1, 2)
                  for t in qkv.split(h * dh, dim=-1))
    io = b * s * h * dh * 2
    kw = dict(dropout_rate=0.1, seed=2026)
    put("packed_attention", "vith_s257_d80",
        cuda_ms(lambda: fa.packed_flash_attention_fwd(qkv, h)),
        cuda_ms(lambda: fa.packed_flash_attention_reference(qkv, h), iters=5),
        cuda_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv)),
        4 * io + b * s * h * 4, 4 * b * h * s * s * dh)
    out, lse = fa.packed_flash_attention_fwd(qkv, h, **kw)
    do_h = do.view(b, s, h, dh).transpose(1, 2)
    put("packed_attention_bwd", "vith_s257_d80",
        cuda_ms(lambda: fa.packed_flash_attention_bwd(qkv, do, out, lse, h,
                                                      **kw)),
        cuda_ms(lambda: fa.packed_flash_attention_bwd_reference(
            qkv, do, out, lse, h, **kw), iters=3),
        cuda_ms(sdpa_grad(qv, kv, vv, do_h, 0.1)),
        8 * io + b * s * h * 4, 10 * b * h * s * s * dh)
    # the same rows at dh 64 (a tile of its own) and 128 (the tile dh 80
    # runs in): what padding 80 to 128 costs against an exact tile
    for d_ in (64, 128):
        qkv_d = randn(702, b, s, 3 * h * d_, dtype=bf16)
        times["packed_attention"][f"vith_s257_d{d_}_ms"] = cuda_ms(
            lambda: fa.packed_flash_attention_fwd(qkv_d, h))
    del qkv, do, qv, kv, vv, out, lse, do_h, qkv_d
    b, h, s, d = 4, 16, 577, 80
    q, k, v, do = (randn(710 + i, b, h, s, d, dtype=bf16) for i in range(4))
    io = b * h * s * d * 2
    put("flash_attention", "vith_s577_d80",
        cuda_ms(lambda: fa.flash_attention_fwd(q, k, v)),
        cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=5),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        4 * io + b * h * s * 4, 4 * b * h * s * s * d)
    put("dropout_attention_fwd", "vith_s577_d80",
        cuda_ms(lambda: fa.flash_dropout_attention_fwd(q, k, v, **kw)),
        cuda_ms(lambda: fa.flash_dropout_attention_reference(q, k, v, **kw),
                iters=5),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                       dropout_p=0.1)),
        4 * io + b * h * s * 4, 4 * b * h * s * s * d)
    for d_ in (64, 128):
        q_d = randn(713, b, h, s, d_, dtype=bf16)
        times["flash_attention"][f"vith_s577_d{d_}_ms"] = cuda_ms(
            lambda: fa.flash_attention_fwd(q_d, q_d, q_d))
    del q_d
    out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
    put("dropout_attention_bwd", "vith_s577_d80",
        cuda_ms(lambda: fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                                       **kw)),
        cuda_ms(lambda: fa.flash_dropout_attention_bwd_reference(
            q, k, v, do, out, lse, **kw), iters=3),
        cuda_ms(sdpa_grad(q, k, v, do, 0.1)),
        8 * io + b * h * s * 4, 10 * b * h * s * s * d)
    del q, k, v, do, out, lse
    b, h, s, d = 4, 16, 1370, 80
    q, k, v = (randn(720 + i, b, h, s, d, dtype=bf16) for i in range(3))
    io = b * h * s * d * 2
    put("flash_attention_large", "vith_s1370_d80",
        cuda_ms(lambda: fa.flash_attention_large_fwd(q, k, v)),
        cuda_ms(lambda: fa.flash_attention_large_reference(q, k, v),
                iters=3),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        4 * io + b * h * s * 4, 4 * b * h * s * s * d)
    del q, k, v
    b, h, s, d = 2, 16, 257, 80
    q, k, v, do = (randn(730 + i, b, h, s, d, dtype=bf16) for i in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    io = b * h * s * d * 2
    put("flash_attention_bwd", "vith_s257_d80",
        cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do)),
        cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                                         do), iters=5),
        cuda_ms(sdpa_grad(q, k, v, do, 0.0)),
        8 * io + b * h * s * 4, 10 * b * h * s * s * d)
    del q, k, v, do, out, lse

    # ---- ViT-H/14 at full width and depth ----------------------------------
    t0 = time.perf_counter()
    model = ViT(image_size=224, **VITH14, dtype="bfloat16")
    weights = seeded_state_dict(model, seed=14)
    model.load_state_dict(weights)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"ViT-H/14 @224: {n_params} parameters, built and seeded in "
        f"{time.perf_counter() - t0:.1f} s")
    require(n_params > 6e8, "ViT-H/14 has about 632 M parameters")
    rng = np.random.RandomState(15)
    runs = []  # the launch counts of each model run, zeroed before it

    def counted(fn):
        fa.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        runs.append(dict(fa.LAUNCHES))
        return out, runs[-1]

    def weights_at(image):
        """weights at a resolution: the same tensors, at another than 224
        a seeded position embedding of its own length."""
        if image == 224:
            return weights
        w = dict(weights)
        shape = (1, (image // 14) ** 2 + 1, 1280)
        w["encoder.pos_embedding"] = torch.from_numpy(
            (0.02 * np.random.RandomState(image).standard_normal(shape))
            .astype(np.float32))
        return w

    served, numbers = {}, {}
    for image, buckets, row in ((224, (1, 32), "row 1"),
                                (336, (4,), "row 2"),
                                (518, (4,), "row 3")):
        shape = (image, image, 3)
        if image != 224:
            model = ViT(image_size=image, **VITH14, dtype="bfloat16")
            model.load_state_dict(weights_at(image))
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(model, shape, tmp, buckets=buckets,
                                      dtype=fp32)
            clf = serving.load_classifier(tmp)
        if image != 224:
            del model
        log(f"ViT-H/14 @{image}: exported and loaded in "
            f"{time.perf_counter() - t0:.1f} s")
        clf.warmup()
        x = rng.standard_normal((max(buckets), *shape)).astype(np.float32)
        name = {"row 1": "packed_attention", "row 2": "flash_attention",
                "row 3": "flash_attention_large"}[row]
        for bkt in buckets:
            logits, la = counted(lambda: clf.predict(x[:bkt]))
            require(tuple(logits.shape) == (bkt, 1000)
                    and bool(torch.isfinite(logits.float()).all())
                    and la[name] == 32
                    and sum(la.values()) == 32,
                    f"ViT-H/14 @{image} bucket {bkt}: finite logits, 32 "
                    f"{name} launches and no other kernel of the table: {la}")
            require_route(f"ViT-H/14 @{image} bucket {bkt} forward",
                          lambda: clf.predict(x[:bkt]),
                          [(vith_route(row, 80), "bfloat16")])
            for _ in range(2):
                clf.predict(x[:bkt]).float().cpu()
            t0 = time.perf_counter()
            for _ in range(5):
                clf.predict(x[:bkt]).float().cpu()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            with torch.inference_mode():
                xb = torch.from_numpy(x[:bkt]).to(dev)
                dev_ms = cuda_ms(lambda: clf.model(xb), iters=5, warmup=1)
            wall, busy, count, top = device_profile(
                lambda: clf.predict(x[:bkt]).float().cpu())
            idle = None if busy is None else 1 - busy / wall
            numbers[f"served_{image}_b{bkt}"] = dict(
                ms=ms, device_ms=dev_ms, idle=idle)
            log(f"ViT-H/14 @{image} bf16 served bucket {bkt}: {ms:.3f} ms per "
                f"request (host numpy in, logits out), forward device time "
                f"{dev_ms:.3f} ms, {bkt / ms * 1e3:.1f} images/s; profile "
                + ("saw no device activity" if busy is None else
                   f"wall {wall:.3f} ms, busy {busy:.3f} ms in {count} "
                   f"activities, idle share {idle:.3f}"))
        served[image] = clf
    clf224 = served.pop(224)
    del served

    # 2 layers at full width, fp32, card against the CPU's plain versions
    two = {k: v for k, v in weights.items()
           if not re.search(r"encoder_layer_([2-9]|[1-3]\d)\.", k)}
    kw2 = dict(VITH14, num_layers=2)
    card2 = ViT(image_size=224, **kw2)
    card2.load_state_dict(two)
    cpu2 = ViT(image_size=224, **kw2, device="cpu")
    cpu2.load_state_dict(two)
    x2 = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        (got2, la2) = counted(lambda: card2(torch.from_numpy(x2).to(dev)))
        want2 = cpu2(torch.from_numpy(x2))
        require_route("ViT-H/14 2 layers fp32 forward",
                      lambda: card2(torch.from_numpy(x2).to(dev)),
                      [("row 1 padded", "float32")])
    e2 = max_err(got2.cpu(), want2)
    log(f"ViT-H/14 2 layers fp32, card against the CPU's plain versions: "
        f"max|logit diff| {e2:.3e} (tol {LOGIT_TOL_FP32}, max|ref| "
        f"{want2.abs().max().item():.3f}), launches {la2}")
    require(e2 <= LOGIT_TOL_FP32 and la2["packed_attention"] == 2,
            "ViT-H/14 2 layers fp32 on the card against the CPU")
    del card2, cpu2, two

    # full depth: bf16 finite, and its argmax against fp32's on the card
    full32 = ViT(image_size=224, **VITH14)
    full32.load_state_dict(weights)
    xs = rng.standard_normal((64, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        l16, _ = counted(lambda: torch.cat([clf224.predict(xs[i:i + 32])
                                            for i in (0, 32)]))
        l32, _ = counted(lambda: torch.cat([
            full32(torch.from_numpy(xs[i:i + 32]).to(dev)) for i in (0, 32)]))
    agree = (l16.float().argmax(-1) == l32.argmax(-1)).float().mean().item()
    rel = max_err(l16, l32) / l32.abs().max().item()
    log(f"ViT-H/14 full depth, 64 seeded images: bf16 logits finite, argmax "
        f"agrees with the fp32 card forward on {agree:.4f} of them (floor "
        f"{VITH_ARGMAX_FLOOR}); max|bf16 - fp32| / max|fp32| {rel:.4f}")
    require(bool(torch.isfinite(l16.float()).all())
            and bool(torch.isfinite(l32).all()) and agree >= VITH_ARGMAX_FLOOR,
            "ViT-H/14 full-depth bf16 finite, its argmax agrees with fp32")
    numbers.update(argmax_agree=agree, bf16_fp32_rel=rel)
    del full32, l16, l32

    # training: 3 Adam steps (fused, row 15) at 224 px, batch 8, attention
    # dropout 0.1 (rows 1 and 7 with dropout), on one batch: the loss falls
    def train_run(image, bsz, rate, steps, label):
        m = ViT(image_size=image, **VITH14, attention_dropout=rate,
                dtype="bfloat16")
        m.load_state_dict(weights_at(image))
        state = trainer.make_train_state(
            m, tx=make_optimizer("adam", 3e-5, fused=True))
        step = trainer.train_step_fn(m)
        xb = rng.randint(0, 256, (bsz, image, image, 3)).astype(np.uint8)
        yb = rng.randint(0, 1000, bsz).astype(np.int32)
        wb = np.ones(bsz, np.float32)
        m.dropout_generator.manual_seed(image)
        losses = []

        def go():
            nonlocal state
            for _ in range(steps):
                state, loss_n, _, n = step(state, xb, yb, wb)
                losses.append((loss_n / n).item())

        t0 = time.perf_counter()
        _, la = counted(go)
        ms = (time.perf_counter() - t0) / steps * 1e3
        log(f"ViT-H/14 @{image} {label}: {steps} Adam steps at batch {bsz}, "
            f"attention dropout {rate}: loss {[round(x_, 4) for x_ in losses]}"
            f", {ms:.1f} ms a step (host clock, first steps), launches {la}")
        require(np.isfinite(losses).all(), f"ViT-H/14 @{image} {label}: "
                "finite losses")
        return state, step, (xb, yb, wb), losses, la

    del clf224
    state, step, batch, losses, la = train_run(224, 8, 0.1, 3, "train")
    require(losses[-1] < losses[0] and la["packed_attention"] == 96
            and la["packed_attention_bwd"] == 96 and la["fused_adam"] >= 3,
            "ViT-H/14 @224: the loss falls over 3 steps; 32 row-1 and 32 "
            f"row-7 launches and row 15 each step: {la}")

    def one_step():
        nonlocal state
        state, *_ = step(state, *batch)

    require_route("ViT-H/14 @224 bf16 train step, dropout 0.1", one_step,
                  [("row 1 padded", "bfloat16"), ("row 7 padded", "bfloat16")])
    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    wall, busy, count, _ = device_profile(one_step)
    idle = None if busy is None else 1 - busy / wall
    numbers["train_224_b8"] = dict(ms=step_ms, idle=idle, losses=losses)
    log(f"ViT-H/14 @224 bf16 train step, batch 8, attention dropout 0.1: "
        f"{step_ms:.3f} ms a step (host clock, synchronised; "
        f"{8 / step_ms * 1e3:.1f} images/s); profile "
        + ("saw no device activity" if busy is None else
           f"wall {wall:.3f} ms, busy {busy:.3f} ms in {count} activities, "
           f"idle share {idle:.3f}"))
    del state, step, batch

    # one step at 336 px, batch 2: rate 0 (rows 2 and 6), rate 0.1 (5 and 6)
    for rate, rows in ((0.0, ("row 2 padded", "row 6 padded")),
                       (0.1, ("row 5 padded", "row 6 padded"))):
        state, step, batch, _, la = train_run(336, 2, rate, 1,
                                              f"train rate {rate}")
        fwd = "flash_attention" if rate == 0.0 else "dropout_attention_fwd"
        require(la[fwd] == 32 and la["dropout_attention_bwd"] == 32,
                f"ViT-H/14 @336 rate {rate}: 32 {fwd} and 32 row-6 launches "
                f"a step: {la}")
        require_route(f"ViT-H/14 @336 bf16 train step, rate {rate}",
                      lambda: step(state, *batch),
                      [(r, "bfloat16") for r in rows])
        del state, step
    del weights
    for name, row in (("packed_attention", "row 1"),
                      ("packed_attention_bwd", "row 7"),
                      ("flash_attention", "row 2"),
                      ("flash_attention_large", "row 3"),
                      ("flash_attention_bwd", "row 4"),
                      ("dropout_attention_fwd", "row 5"),
                      ("dropout_attention_bwd", "row 6")):
        times[name]["vith_max_abs_err"] = max(
            v for k, v in errs.items() if k[0] == row and "bfloat16" in k)
    totals = {k: sum(r.get(k, 0) for r in runs) for k in fa.LAUNCHES}
    log(f"ViT-H/14 phase in {time.perf_counter() - t_phase:.1f} s, launches "
        f"{ {k: v for k, v in totals.items() if v} }")
    return totals, times, errs, numbers


# ViT-B/16's widths at 3 heads (hidden 768, dh 256) and Swin-T's at 4× its
# heads (dh 8): shape probes at published widths, not published models (no
# model of the repo's families goes above dh 128 or below 16), the head dims
# that rows 1-7 and 9-13 took in phase 7e's slice.
VITB3 = dict(patch_size=16, num_layers=12, num_heads=3, hidden_dim=768,
             mlp_dim=3072, num_classes=1000)
SWIN_T4_HEADS = [12, 24, 48, 96]
# Swin-T at 4× heads, batch 32: the routes the JAX package takes on a TPU
# (tests/test_torch_port_head_dims_wide.py): 4 batched, 1 slab, 1 packed
# window forward, and stage 3's 6 blocks on the split-head kernel (row 2)
SWIN_T4_LAUNCHES_PER_FORWARD = {"window_batched_attention": 4,
                                "window_fused_slab_attention": 1,
                                "window_packed_attention": 1,
                                "flash_attention": 6}
WINDOW_ROW_NAMES = ("row 9", "row 10", "row 11", "row 12", "row 13")


def split_heads(t, h):
    """The q, k, v of a partitioned (G, N, 3·H·dh) tensor as (G, H, N, dh)
    views."""
    g, n, three = t.shape
    return [x.reshape(g, n, h, three // (3 * h)).transpose(1, 2)
            for x in t.split(three // 3, dim=-1)]


def sdpa_grad(q, k, v, do, p=0.0, mask=None):
    """One call of SDPA's backward through autograd (graph kept): the
    library time of a backward."""
    import torch
    import torch.nn.functional as F

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                         dropout_p=p)
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


class ModelRuns:
    """The model runs of a phase (7e, 7g): each launch count of a run into
    ``runs``, the served and trained numbers into ``numbers``; inputs drawn
    from ``rng``."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.runs, self.numbers = [], {}

    def counted(self, fn):
        import torch
        from vision_transformers_tpu_torch.ops import flash_attention as fa

        fa.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        self.runs.append(dict(fa.LAUNCHES))
        return out, self.runs[-1]

    def serve(self, label, model, shape, buckets, want, routes):
        """Export, load and serve ``model``: per bucket finite logits, the
        launches ``want`` per forward and nothing else of the table, the
        routes by kernel name, ms per request, device ms, idle share."""
        import torch
        from vision_transformers_tpu_torch import serving

        dev, fp32 = torch.device("cuda"), torch.float32
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(model, shape, tmp, buckets=buckets,
                                      dtype=fp32)
            clf = serving.load_classifier(tmp)
        clf.warmup()
        log(f"{label}: exported, loaded and warmed up in "
            f"{time.perf_counter() - t0:.1f} s")
        x = self.rng.standard_normal((max(buckets), *shape)).astype(np.float32)
        for bkt in buckets:
            logits, la = self.counted(lambda: clf.predict(x[:bkt]))
            require(tuple(logits.shape) == (bkt, 1000)
                    and bool(torch.isfinite(logits.float()).all())
                    and {k: v for k, v in la.items() if v} == want,
                    f"{label} bucket {bkt}: finite logits, launches {want} "
                    f"per forward and no other kernel of the table: {la}")
            require_route(f"{label} bucket {bkt} forward",
                          lambda: clf.predict(x[:bkt]), routes)
            for _ in range(2):
                clf.predict(x[:bkt]).float().cpu()
            t0 = time.perf_counter()
            for _ in range(5):
                clf.predict(x[:bkt]).float().cpu()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            with torch.inference_mode():
                xb = torch.from_numpy(x[:bkt]).to(dev)
                dev_ms = cuda_ms(lambda: clf.model(xb), iters=5, warmup=1)
            wall, busy, count, _ = device_profile(
                lambda: clf.predict(x[:bkt]).float().cpu())
            idle = None if busy is None else 1 - busy / wall
            self.numbers[f"{label} served b{bkt}"] = dict(
                ms=ms, device_ms=dev_ms, idle=idle)
            log(f"{label} bf16 served bucket {bkt}: {ms:.3f} ms per request "
                f"(host numpy in, logits out), forward device time "
                f"{dev_ms:.3f} ms, {bkt / ms * 1e3:.1f} images/s; profile "
                + ("saw no device activity" if busy is None else
                   f"wall {wall:.3f} ms, busy {busy:.3f} ms in {count} "
                   f"activities, idle share {idle:.3f}"))

    def train(self, label, model, image, bsz, steps, lr, want, routes):
        """``steps`` fused Adam steps on one seeded batch: the loss falls;
        per step the launches ``want`` (at least), the routes by name; step
        ms and idle share of a warm step."""
        import torch
        from vision_transformers_tpu_torch.training import trainer
        from vision_transformers_tpu_torch.training.optimizers import (
            make_optimizer,
        )

        state = trainer.make_train_state(
            model, tx=make_optimizer("adam", lr, fused=True))
        step = trainer.train_step_fn(model)
        xb = self.rng.randint(0, 256, (bsz, image, image, 3)).astype(np.uint8)
        yb = self.rng.randint(0, 1000, bsz).astype(np.int32)
        wb = np.ones(bsz, np.float32)
        model.dropout_generator.manual_seed(image)
        losses = []

        def go():
            nonlocal state
            for _ in range(steps):
                state, loss_n, _, n = step(state, xb, yb, wb)
                losses.append((loss_n / n).item())

        _, la = self.counted(go)
        log(f"{label}: {steps} Adam steps at batch {bsz}: loss "
            f"{[round(x_, 4) for x_ in losses]}, launches {la}")
        require(np.isfinite(losses).all() and losses[-1] < losses[0]
                and all(la[k] >= steps * v for k, v in want.items()),
                f"{label}: finite losses that fall over {steps} steps, "
                f"{want} a step: {la}")

        def one_step():
            nonlocal state
            state, *_ = step(state, xb, yb, wb)

        require_route(f"{label} bf16 train step", one_step, routes)
        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            one_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 3 * 1e3
        wall, busy, count, _ = device_profile(one_step)
        idle = None if busy is None else 1 - busy / wall
        self.numbers[f"{label} train b{bsz}"] = dict(
            ms=step_ms, idle=idle, losses=losses)
        log(f"{label} bf16 train step, batch {bsz}: {step_ms:.3f} ms a step "
            f"(host clock, synchronised; {bsz / step_ms * 1e3:.1f} images/s)"
            "; profile " + ("saw no device activity" if busy is None else
                            f"wall {wall:.3f} ms, busy {busy:.3f} ms in "
                            f"{count} activities, idle share {idle:.3f}"))


def wide_route(row: str, d: int) -> str:
    """The ROUTE_NAMES row that head dim d takes: rows 1-7 above 128 their
    wide kernels (else as vith_route); the window rows their own kernels at
    every dh (dh 1-8 are instantiations in the 16 tile)."""
    if row in WINDOW_ROW_NAMES:
        return row
    return f"{row} wide" if d > 128 else vith_route(row, d)


def wide_phase(det_keep):
    """Phase 7e: rows 1-7 above head dim 128 and rows 9-13 at dh 1, 2, 4
    and 8 against their plain versions; their times at the model shapes;
    ViT-B/16's widths at 3 heads served and trained at 224 px, served and
    trained at 448 px, served at 576 px (2 layers), and Swin-T's widths at
    4× its heads served and trained. Returns (the launches of its model
    runs by wrapper, the rows' times by wrapper name, the checks' errors,
    the model numbers)."""
    import torch
    import torch.nn.functional as F

    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.models.image_classification import (
        SwinTransformer,
        ViT,
    )
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.ops import windows
    from vision_transformers_tpu_torch.training import trainer
    from vision_transformers_tpu_torch.training.optimizers import (
        make_optimizer,
    )
    from vision_transformers_tpu_torch.utils.args import get_args

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    errs = {}
    chk = RowChecks("wide", wide_route, errs)
    randn = chk.randn

    # ---- rows 1-7 above 128 ----------------------------------------------
    for dtype in (bf16, fp32):
        for d in (129, 160, 200, 256, 512):
            for rate in (0.0, 0.1):
                chk.check_packed(f"B2 S150 H2 dh{d}", 2, 150, 2, d, dtype,
                                 rate)
                chk.check_split(f"B2 H2 S150 D{d}", 2, 2, 150, d, dtype,
                                rate, rate > 0)
            chk.check_large(f"B2 H2 S1300 D{d} masked", 2, 2, 1300, 1300, d,
                            dtype, keep=det_keep[:2, :1300])
            # row 4's route is the JAX score budget at every D (phase 7f
            # holds it at the shapes the old shared-memory rule refused)
            fits = [s for s in range(16, 257, 16)
                    if fa.flash_bwd_supported(s, s, d)]
            require(fits[-1] == 256, f"row 4's route at D {d}: largest S "
                    f"{fits[-1]}")
            chk.check_small_bwd(f"B2 H2 S{fits[-1]} D{d}", 2, 2, fits[-1], d,
                                dtype)
        # the path shapes of ViT-B/16's widths at 3 heads
        for rate in (0.0, 0.1):
            chk.check_packed("ViT-B3@224 B32 S197 H3 dh256", 32, 197, 3, 256,
                             dtype, rate)
            chk.check_split("ViT-B3@448 B4 H3 S785 D256", 4, 3, 785, 256,
                            dtype, rate)
        chk.check_large("ViT-B3@576 B2 H3 S1297 D256", 2, 3, 1297, 1297, 256,
                        dtype)
        chk.check_small_bwd("ViT-B3 B32 H3 S64 D256", 32, 3, 64, 256, dtype)
    log(f"wide rows 1-7 checks in {time.perf_counter() - t_phase:.1f} s")

    # ---- rows 9-13 at dh 1, 2, 4 and 8 ------------------------------------
    def window_close(out, ref, name):
        e = max_err(out, ref)
        share = differing_share(out, ref)
        return e, share, e <= WINDOW_TOL[name] and (
            name == "float32" or share <= WINDOW_DIFFERING_MAX)

    def check_window(label, g, n, h, dh, nwp, dtype):
        name = str(dtype).removeprefix("torch.")
        qkv = randn(800 + dh, g, n, 3 * h * dh, dtype=dtype)
        bias = None if nwp == 0 else randn(801 + dh, nwp, h, n, n, dtype=fp32)
        do = randn(802 + dh, g, n, h * dh, dtype=dtype)
        ref = fa.window_attention_reference(qkv, bias, h)
        at = {}  # row 11's probe where the batched plan refuses this one
        for fn, row in (("window_packed_attention", "row 9"),
                        ("window_batched_attention", "row 11")):
            q_, b_, h_, ref_, label_ = qkv, bias, h, ref, label
            size = qkv.element_size()
            if fn == "window_batched_attention" and fa.window_batched_plan(
                    g, n, h, dh, max(nwp, 1), size) is None:
                # the JAX batched plan's VMEM budget refuses (H·dh 768 at
                # 768 heads of 1 in bf16; 192 of 4, 384 of 2 and 768 of 1
                # in fp32, and 96 of 1 at nW' 64): no launch
                fa.reset_launch_counts()
                try:
                    fa.window_batched_attention(qkv, bias, h)
                    refused = False
                except ValueError:
                    refused = True
                require(refused and not any(fa.LAUNCHES.values()),
                        f"wide {label} {name}: row 11 refused before any "
                        "launch where the batched plan is None")
                log(f"wide window {label} {name}: row 11 refused by the "
                    "batched plan (the JAX budget), no launch")
                # the same probe at half the heads, or a quarter, ..., the
                # first the plan admits: this dh's kernel, with this kind
                # of bias, is still held against its plain version
                while fa.window_batched_plan(g, n, h_, dh, max(nwp, 1),
                                             size) is None:
                    h_ //= 2
                label_ = f"{label} at H{h_}"
                q_ = randn(803 + dh, g, n, 3 * h_ * dh, dtype=dtype)
                b_ = None if nwp == 0 else randn(804 + dh, nwp, h_, n, n,
                                                  dtype=fp32)
                ref_ = fa.window_attention_reference(q_, b_, h_)
                at[row] = label_
            got = []
            require_route(f"wide {label_} {name} {fn}",
                          lambda: got.append(getattr(fa, fn)(q_, b_, h_)),
                          [(wide_route(row, dh), name)])
            e, share, ok = window_close(got[0], ref_, name)
            require(ok and torch.equal(getattr(fa, fn)(q_, b_, h_), got[0]),
                    f"wide {label_} {name}: {row} against its plain version "
                    f"({e:.3e}, {share:.4f} of elements differ), rerun "
                    "bit-equal")
            errs[(row, label_, name)] = e
        dref, db_ref = fa.window_attention_bwd_reference(qkv, bias, do, h)
        got = []
        require_route(f"wide {label} {name} row 10", lambda: got.append(
            fa.window_attention_bwd(qkv, bias, do, h,
                                    dqkv=chk.nan_like(qkv))),
            [(wide_route("row 10", dh), name)])
        (dqkv, db), again = got[0], fa.window_attention_bwd(qkv, bias, do, h)
        tol = (WINDOW_GRAD_TOL if name == "bfloat16" else GRAD_TOL[name]) \
            * max(1.0, dref.float().abs().max().item())
        eg = max_err(dqkv, dref)
        ok = bool(torch.isfinite(dqkv.float()).all()) and eg <= tol \
            and torch.equal(again[0], dqkv)
        if bias is not None:
            tol_b = tol / max(1.0, dref.float().abs().max().item()) * max(
                1.0, db_ref.float().abs().max().item())
            ok = ok and max_err(db, db_ref) <= tol_b \
                and torch.equal(again[1], db)
        require(ok, f"wide {label} {name}: row 10 against its plain version "
                f"({eg:.3e} > {tol:.3e}?), dbias too, every element written, "
                "rerun bit-equal")
        errs[("row 10", label, name)] = eg
        label11 = at.get("row 11", label)
        log(f"wide window {label} {name}: rows 9 and 11 max|out-plain| "
            f"{errs[('row 9', label, name)]:.3e}, "
            f"{errs[('row 11', label11, name)]:.3e}"
            + ("" if label11 == label else f" (row 11 {label11})")
            + f"; row 10 max|dqkv-plain| {eg:.3e} (tol {tol:.3e}); reruns "
            "bit-equal")

    def check_fused(label, b, hw, shift, h, dh, dtype):
        name = str(dtype).removeprefix("torch.")
        win, nwp = 7, (hw // 7) ** 2 if shift else 1
        qkv = randn(810 + dh, b, hw, hw, 3 * h * dh, dtype=dtype)
        bias = randn(811 + dh, nwp, h, 49, 49, dtype=fp32)
        geo = (b, hw, hw, win, win, h, dh, nwp)
        ref = fa.window_fused_reference(qkv, bias, h, (win, win),
                                        (shift, shift))
        for plan, row in ((fa.window_fused_plan(*geo), "row 13"),
                          (fa.window_fused_flat_plan(*geo), "row 12")):
            if plan is None:
                continue
            out = torch.full(ref.shape, float("nan"), dtype=dtype, device=dev)
            require_route(f"wide {label} {name} {plan[0]}",
                          lambda: fa.fused_window_attention(
                              qkv, bias, h, (win, win), (shift, shift),
                              plan=plan, out=out),
                          [(wide_route(row, dh), name)])
            e, share, ok = window_close(out, ref, name)
            again = fa.fused_window_attention(qkv, bias, h, (win, win),
                                              (shift, shift), plan=plan)
            require(ok and torch.equal(again, out),
                    f"wide {label} {name}: {row} against its plain version "
                    f"({e:.3e}, {share:.4f} differ), every element written, "
                    "rerun bit-equal")
            errs[(row, label, name)] = e
            log(f"wide fused {plan[0]} {label} {name}: {row} "
                f"max|out-plain| {e:.3e}, {share:.4f} of elements differ; "
                "every element written, rerun bit-equal")

    for dtype in (bf16, fp32):
        for dh in (8, 4, 2, 1):
            # Swin-T's stages 1 (shifted) and 4 at batch 4, heads C / dh
            check_window(f"Swin-T s1 B4 G256 N49 H{96 // dh} dh{dh} nW'64",
                         256, 49, 96 // dh, dh, 64, dtype)
            check_window(f"Swin-T s4 B4 G4 N49 H{768 // dh} dh{dh}",
                         4, 49, 768 // dh, dh, 1, dtype)
            check_fused(f"Swin-T s1 B4 56x56 H{96 // dh} dh{dh}", 4, 56, 3,
                        96 // dh, dh, dtype)
            check_fused(f"Swin-T s2 B4 28x28 H{192 // dh} dh{dh}", 4, 28, 3,
                        192 // dh, dh, dtype)
    log(f"wide window checks done at {time.perf_counter() - t_phase:.1f} s")

    # ---- the rows' times at the model shapes (bf16) -----------------------
    times = {}

    def put(name, key, k_ms, p_ms, l_ms, nbytes, flops):
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        times.setdefault(name, {}).update({
            f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
            f"{key}_library_ms": l_ms, f"{key}_bound_ms": bnd,
            f"{key}_bound_by": by, f"{key}_tflops": flops / k_ms / 1e9})
        log(f"wide time {name} {key}: kernel {k_ms:.4f} ms, bound {bnd:.4f} "
            f"ms ({by}), plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms, "
            f"{flops / k_ms / 1e9:.1f} TFLOP/s")

    kw = dict(dropout_rate=0.1, seed=2027)
    b, s, h, dh = 32, 197, 3, 256
    qkv = randn(900, b, s, 3 * h * dh, dtype=bf16)
    do = randn(901, b, s, h * dh, dtype=bf16)
    qv, kv, vv = (t.view(b, s, h, dh).transpose(1, 2)
                  for t in qkv.split(h * dh, dim=-1))
    do_h = do.view(b, s, h, dh).transpose(1, 2)
    io = b * s * h * dh * 2
    put("packed_attention", "vitb3_s197_d256",
        cuda_ms(lambda: fa.packed_flash_attention_fwd(qkv, h)),
        cuda_ms(lambda: fa.packed_flash_attention_reference(qkv, h), iters=5),
        cuda_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv)),
        4 * io + b * s * h * 4, 4 * b * h * s * s * dh)
    out, lse = fa.packed_flash_attention_fwd(qkv, h, **kw)
    put("packed_attention_bwd", "vitb3_s197_d256",
        cuda_ms(lambda: fa.packed_flash_attention_bwd(qkv, do, out, lse, h,
                                                      **kw)),
        cuda_ms(lambda: fa.packed_flash_attention_bwd_reference(
            qkv, do, out, lse, h, **kw), iters=3),
        cuda_ms(sdpa_grad(qv, kv, vv, do_h, 0.1)),
        8 * io + b * s * h * 4, 10 * b * h * s * s * dh)
    del qkv, do, qv, kv, vv, do_h, out, lse
    b, h, s, d = 4, 3, 785, 256
    q, k, v, do = (randn(910 + i, b, h, s, d, dtype=bf16) for i in range(4))
    io = b * h * s * d * 2
    put("flash_attention", "vitb3_s785_d256",
        cuda_ms(lambda: fa.flash_attention_fwd(q, k, v)),
        cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=5),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        4 * io + b * h * s * 4, 4 * b * h * s * s * d)
    put("dropout_attention_fwd", "vitb3_s785_d256",
        cuda_ms(lambda: fa.flash_dropout_attention_fwd(q, k, v, **kw)),
        cuda_ms(lambda: fa.flash_dropout_attention_reference(q, k, v, **kw),
                iters=5),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                       dropout_p=0.1)),
        4 * io + b * h * s * 4, 4 * b * h * s * s * d)
    out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
    put("dropout_attention_bwd", "vitb3_s785_d256",
        cuda_ms(lambda: fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                                       **kw)),
        cuda_ms(lambda: fa.flash_dropout_attention_bwd_reference(
            q, k, v, do, out, lse, **kw), iters=3),
        cuda_ms(sdpa_grad(q, k, v, do, 0.1)),
        8 * io + b * h * s * 4, 10 * b * h * s * s * d)
    del q, k, v, do, out, lse
    b, h, s, d = 2, 3, 1297, 256
    q, k, v = (randn(920 + i, b, h, s, d, dtype=bf16) for i in range(3))
    io = b * h * s * d * 2
    put("flash_attention_large", "vitb3_s1297_d256",
        cuda_ms(lambda: fa.flash_attention_large_fwd(q, k, v)),
        cuda_ms(lambda: fa.flash_attention_large_reference(q, k, v),
                iters=3),
        cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
        4 * io + b * h * s * 4, 4 * b * h * s * s * d)
    del q, k, v
    # row 4 at ViT-B3's split heads (G 96 at batch 32) at S 64 (phase 7f
    # times S 197)
    b, h, s, d = 32, 3, 64, 256
    q, k, v, do = (randn(930 + i, b, h, s, d, dtype=bf16) for i in range(4))
    out, lse = fa.flash_attention_fwd(q, k, v)
    io = b * h * s * d * 2
    put("flash_attention_bwd", "vitb3_g96_s64_d256",
        cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do)),
        cuda_ms(lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse,
                                                         do), iters=5),
        cuda_ms(sdpa_grad(q, k, v, do, 0.0)),
        8 * io + b * h * s * 4, 10 * b * h * s * s * d)
    del q, k, v, do, out, lse

    # the window rows at dh 8 at Swin-T's widths at 4× heads, batch 32
    def window_time(name, key, g, n, h_, d_, nwp, call, ref_call):
        qkv_ = randn(940, g, n, 3 * h_ * d_, dtype=bf16)
        bias_ = randn(941, nwp, h_, n, n, dtype=fp32)
        mask = bias_.to(bf16).repeat(g // nwp, 1, 1, 1)
        q_, k_, v_ = split_heads(qkv_, h_)
        io_ = g * n * h_ * d_ * 2
        put(name, key, cuda_ms(lambda: call(qkv_, bias_, h_)),
            cuda_ms(lambda: ref_call(qkv_, bias_, h_), iters=5),
            cuda_ms(lambda: F.scaled_dot_product_attention(q_, k_, v_,
                                                           attn_mask=mask)),
            4 * io_ + nwp * h_ * n * n * 2, 4 * g * h_ * n * n * d_)
        return qkv_, bias_, q_, k_, v_, mask

    window_time("window_packed_attention", "swint4_s2_g512_h24_dh8", 512, 49,
                24, 8, 16, fa.window_packed_attention,
                fa.window_attention_reference)
    qkv, bias, q, k, v, mask = window_time(
        "window_batched_attention", "swint4_s1_g2048_h12_dh8", 2048, 49, 12,
        8, 1, fa.window_batched_attention, fa.window_attention_reference)
    do = randn(942, 2048, 49, 12 * 8, dtype=bf16)
    do_h = do.view(2048, 49, 12, 8).transpose(1, 2)
    io = 2048 * 49 * 12 * 8 * 2
    put("window_attention_bwd", "swint4_s1_g2048_h12_dh8",
        cuda_ms(lambda: fa.window_attention_bwd(qkv, bias, do, 12)),
        cuda_ms(lambda: fa.window_attention_bwd_reference(qkv, bias, do, 12),
                iters=3),
        cuda_ms(sdpa_grad(q, k, v, do_h, 0.0, mask=mask)),
        7 * io + 12 * 49 * 49 * 2, 10 * 2048 * 12 * 49 * 49 * 8)
    del qkv, bias, q, k, v, mask, do, do_h
    for kind, hw, h_, row_name in (("slab", 56, 12, "window_fused_slab_attention"),
                                   ("flat", 28, 24,
                                    "window_fused_flat_attention")):
        b = 32
        nwp = (hw // 7) ** 2
        qkv = randn(950, b, hw, hw, 3 * h_ * 8, dtype=bf16)
        bias = randn(951, nwp, h_, 49, 49, dtype=fp32)
        geo = (b, hw, hw, 7, 7, h_, 8, nwp)
        plan = (fa.window_fused_plan(*geo) if kind == "slab"
                else fa.window_fused_flat_plan(*geo))
        g = b * nwp
        mask = bias.to(bf16).repeat(b, 1, 1, 1)

        def chain():
            x = torch.roll(qkv, shifts=(-3, -3), dims=(1, 2))
            q_, k_, v_ = split_heads(windows.window_partition(x, 7, 7), h_)
            o = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask)
            o = o.transpose(1, 2).reshape(g, 49, h_ * 8)
            o = windows.window_reverse(o, 7, 7, hw, hw)
            return torch.roll(o, shifts=(3, 3), dims=(1, 2))

        io = b * hw * hw * h_ * 8 * 2
        put(row_name, f"swint4_{kind}_b32_{hw}x{hw}_h{h_}_dh8",
            cuda_ms(lambda: fa.fused_window_attention(
                qkv, bias, h_, (7, 7), (3, 3), plan=plan)),
            cuda_ms(lambda: fa.window_fused_reference(qkv, bias, h_, (7, 7),
                                                      (3, 3)), iters=3),
            cuda_ms(chain), 4 * io + nwp * h_ * 49 * 49 * 2,
            4 * g * h_ * 49 * 49 * 8)
        del qkv, bias, mask
    log(f"wide times done at {time.perf_counter() - t_phase:.1f} s")

    # ---- the models -------------------------------------------------------
    mr = ModelRuns(19)
    rng, runs, numbers = mr.rng, mr.runs, mr.numbers
    counted, serve, train = mr.counted, mr.serve, mr.train

    # ViT-B/16's widths at 3 heads, dh 256
    t0 = time.perf_counter()
    vit = ViT(image_size=224, **VITB3, dtype="bfloat16")
    weights = seeded_state_dict(vit, seed=256)
    vit.load_state_dict(weights)

    def weights_at(image):
        w = dict(weights)
        shape = (1, (image // 16) ** 2 + 1, 768)
        w["encoder.pos_embedding"] = torch.from_numpy(
            (0.02 * np.random.RandomState(image).standard_normal(shape))
            .astype(np.float32))
        return w

    log(f"ViT-B/16 widths at 3 heads: built and seeded in "
        f"{time.perf_counter() - t0:.1f} s")
    serve("ViT-B3 @224", vit, (224, 224, 3), (1, 32),
          {"packed_attention": 12}, [("row 1 wide", "bfloat16")])
    del vit
    m = ViT(image_size=224, **VITB3, attention_dropout=0.1, dtype="bfloat16")
    m.load_state_dict(weights)
    train("ViT-B3 @224", m, 224, 32, 3, 1e-4,
          {"packed_attention": 12, "packed_attention_bwd": 12,
           "fused_adam": 1},
          [("row 1 wide", "bfloat16"), ("row 7 wide", "bfloat16")])
    del m
    m = ViT(image_size=448, **VITB3, dtype="bfloat16")
    m.load_state_dict(weights_at(448))
    serve("ViT-B3 @448", m, (448, 448, 3), (4,), {"flash_attention": 12},
          [("row 2 wide", "bfloat16")])
    del m
    m = ViT(image_size=448, **VITB3, attention_dropout=0.1, dtype="bfloat16")
    m.load_state_dict(weights_at(448))
    train("ViT-B3 @448", m, 448, 2, 3, 1e-4,
          {"dropout_attention_fwd": 12, "dropout_attention_bwd": 12},
          [("row 5 wide", "bfloat16"), ("row 6 wide", "bfloat16")])
    del m
    two = {k: v for k, v in weights_at(576).items()
           if not re.search(r"encoder_layer_([2-9]|1\d)\.", k)}
    m = ViT(image_size=576, **dict(VITB3, num_layers=2), dtype="bfloat16")
    m.load_state_dict(two)
    serve("ViT-B3 @576 2 layers", m, (576, 576, 3), (2,),
          {"flash_attention_large": 2}, [("row 3 wide", "bfloat16")])
    del m
    # 2 layers in fp32 at 224: the card against the CPU's plain versions
    two = {k: v for k, v in weights.items()
           if not re.search(r"encoder_layer_([2-9]|1\d)\.", k)}
    card2 = ViT(image_size=224, **dict(VITB3, num_layers=2))
    card2.load_state_dict(two)
    cpu2 = ViT(image_size=224, **dict(VITB3, num_layers=2), device="cpu")
    cpu2.load_state_dict(two)
    x2 = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        got2, la2 = counted(lambda: card2(torch.from_numpy(x2).to(dev)))
        require_route("ViT-B3 2 layers fp32 forward",
                      lambda: card2(torch.from_numpy(x2).to(dev)),
                      [("row 1 wide", "float32")])
        want2 = cpu2(torch.from_numpy(x2))
    e2 = max_err(got2.cpu(), want2)
    log(f"ViT-B3 2 layers fp32, card against the CPU's plain versions: "
        f"max|logit diff| {e2:.3e} (tol {LOGIT_TOL_FP32}, max|ref| "
        f"{want2.abs().max().item():.3f}), launches {la2}")
    require(e2 <= LOGIT_TOL_FP32 and la2["packed_attention"] == 2,
            "ViT-B3 2 layers fp32 on the card against the CPU")
    numbers["vitb3_2layers_fp32_err"] = e2
    del card2, cpu2, two, weights

    # Swin-T's widths at 4× heads, dh 8
    args = dict(get_args("swint_224_imagenet"), num_heads=SWIN_T4_HEADS,
                stochastic_depth_prob=0.0)
    swin = SwinTransformer(**args, dtype="bfloat16")
    sw = seeded_state_dict(swin, seed=8)
    swin.load_state_dict(sw)
    routes = [("row 11", "bfloat16"), ("row 13", "bfloat16"),
              ("row 9", "bfloat16"), ("row 2 padded", "bfloat16")]
    windows.ROUTE_LOG = []
    serve("Swin-T4 @224", swin, (224, 224, 3), (1, 32),
          SWIN_T4_LAUNCHES_PER_FORWARD, routes)
    taken = list(windows.ROUTE_LOG[:12])
    windows.ROUTE_LOG = None
    require(taken == ["batched", "fused_slab", "batched", "pack"]
            + ["split"] * 6 + ["batched", "batched"],
            f"Swin-T4 routes as the JAX package's plans: {taken}")
    del swin
    m = SwinTransformer(**args, dtype="bfloat16")
    m.load_state_dict(sw)
    train("Swin-T4 @224", m, 224, 32, 3, 1e-4,
          {"window_attention_bwd": 6, "fused_adam": 1},
          routes + [("row 10", "bfloat16")])
    del m
    # fp32 at batch 2: the card against the CPU's plain versions
    card = SwinTransformer(**args)
    card.load_state_dict(sw)
    cpu = SwinTransformer(**args, device="cpu")
    cpu.load_state_dict(sw)
    xs = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        got, _ = counted(lambda: card(torch.from_numpy(xs).to(dev)))
        want = cpu(torch.from_numpy(xs))
    e = max_err(got.cpu(), want)
    log(f"Swin-T4 fp32, card against the CPU's plain versions: max|logit "
        f"diff| {e:.3e} (tol {LOGIT_TOL_FP32}, max|ref| "
        f"{want.abs().max().item():.3f})")
    require(e <= LOGIT_TOL_FP32, "Swin-T4 fp32 on the card against the CPU")
    numbers["swint4_fp32_err"] = e
    del card, cpu, sw

    for name, row in (("packed_attention", "row 1"),
                      ("packed_attention_bwd", "row 7"),
                      ("flash_attention", "row 2"),
                      ("flash_attention_large", "row 3"),
                      ("flash_attention_bwd", "row 4"),
                      ("dropout_attention_fwd", "row 5"),
                      ("dropout_attention_bwd", "row 6"),
                      ("window_packed_attention", "row 9"),
                      ("window_attention_bwd", "row 10"),
                      ("window_batched_attention", "row 11"),
                      ("window_fused_flat_attention", "row 12"),
                      ("window_fused_slab_attention", "row 13")):
        times.setdefault(name, {})["wide_max_abs_err"] = max(
            v for k, v in errs.items() if k[0] == row and "bfloat16" in k)
    totals = {k: sum(r.get(k, 0) for r in runs) for k in fa.LAUNCHES}
    log(f"wide phase in {time.perf_counter() - t_phase:.1f} s, launches "
        f"{ {k: v for k, v in totals.items() if v} }")
    return totals, times, errs, numbers


def block_inputs(randn, seed, b, s, hd, dtype):
    """Row 8's operands from ``randn(seed, *shape, dtype=)``: x (B, S, hd)
    in dtype; fp32 rows gamma, beta, bqkv, bout; Wqkv and Wout (in, out) in
    dtype."""
    import torch

    fp32 = torch.float32
    x = randn(seed, b, s, hd, dtype=dtype)
    rows = [1 + 0.1 * randn(seed + 1, hd, dtype=fp32),
            0.1 * randn(seed + 2, hd, dtype=fp32),
            0.1 * randn(seed + 3, 3 * hd, dtype=fp32),
            0.1 * randn(seed + 4, hd, dtype=fp32)]
    w = [(randn(seed + 5, hd, 3 * hd, dtype=fp32) / hd ** 0.5).to(dtype),
         (randn(seed + 6, hd, hd, dtype=fp32) / hd ** 0.5).to(dtype)]
    return x, rows[0], rows[1], w[0], rows[2], w[1], rows[3]


def library_block(x, g, be, wqkv, bqkv, wout, bout, h):
    """Row 8's library chain: LN -> F.linear -> SDPA -> F.linear +
    residual (its yardstick; the port never calls it)."""
    import torch.nn.functional as F

    b, s, hd = x.shape
    xn = F.layer_norm(x, (hd,), g.to(x.dtype), be.to(x.dtype), 1e-6)
    qkv = F.linear(xn, wqkv.t(), bqkv.to(x.dtype))
    q, k, v = (t.view(b, s, h, hd // h).transpose(1, 2)
               for t in qkv.split(hd, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v)
    return x + F.linear(o.transpose(1, 2).reshape(b, s, hd), wout.t(),
                        bout.to(x.dtype))


# Row 8 at head dims other than 16, 32 and 64 (phase 7f): (dh, heads) at
# B 8, S 197, the card tests' dims (the 16, 64 and 128 tiles, the wide one);
# ViT-B3 (dh 256) also at its path shape, B 32.
BLOCK_HEAD_DIMS = ((12, 8), (48, 8), (80, 16), (96, 8), (160, 4), (256, 3))
# Row 4 at the shapes the shared-memory rule refused before its route became
# the JAX score budget: (G, S, D).
ROW4_SHAPES = ((96, 197, 256), (16, 512, 128), (16, 512, 256))
# Two 2-layer probes of the flag-on path at 224 px, flag on against off:
# CaiT-S's attention widths (arXiv:2103.17239; hidden 384, 8 heads, dh 48:
# the 64 tile) and ViT-B/16's widths at 8 heads (dh 96: the 128 tile).
FUSED_PROBES = {"dh48": dict(patch_size=16, num_layers=2, num_heads=8,
                             hidden_dim=384, mlp_dim=1536,
                             num_classes=1000),
                "dh96": dict(patch_size=16, num_layers=2, num_heads=8,
                             hidden_dim=768, mlp_dim=3072,
                             num_classes=1000)}


def block_route(dh: int) -> str:
    """The ROUTE_NAMES row that row 8 takes at head dim dh."""
    return "row 8" if dh in (16, 32, 64) else \
        "row 8 wide" if dh > 128 else "row 8 padded"


def row4_route(s: int, d: int, dtype: str) -> str:
    """The ROUTE_NAMES row that row 4 takes at a square S and head dim d:
    above 128 the wide passes; fp32 past the resident kernel's shared memory
    the streaming ones (bf16 streams in its own passes at every shape)."""
    from vision_transformers_tpu_torch.ops import flash_attention as fa

    if d > 128:
        return "row 4 wide"
    if dtype == "float32" and fa.flash_bwd_smem_bytes(s, s, d) > fa._SMEM_LIMIT:
        return "row 4 streamed"
    return vith_route("row 4", d)


def fused_phase():
    """Phase 7f: row 8 at head dims other than 16, 32 and 64 on both routes
    and row 4 at every shape its route (the JAX score budget) sends it,
    against their plain versions; their times beside bound, plain and
    library; the autograd backward of ``flash_attention`` at ViT-B3's
    split-head shape under ``USE_PALLAS_BWD`` (row 4, not row 6); ViT-B3
    served at 224 px with ``USE_FUSED_BLOCK`` on (row 8 twelve times a
    forward, row 1 never) and off, fp32 at 2 layers against the CPU, and
    the two probes of FUSED_PROBES, flag on against off. Returns (the
    launches of its model runs by wrapper, times by wrapper name, the
    checks' errors, the model numbers)."""
    import torch
    import torch.nn.functional as F

    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.models.image_classification import ViT
    from vision_transformers_tpu_torch.models.image_classification import (
        vanilla_vit as vv,
    )
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    errs, times, runs, numbers = {}, {}, [], {}
    randn = RowChecks("fused", vith_route, errs).randn

    # ---- row 8 at every head dim -------------------------------------------
    def check_block(label, b, s, h, dh, dtype):
        """Row 8 into a NaN-filled output against its plain version, the
        route by kernel name, a rerun and torch's (out, in) weights
        bit-equal, the tensor-core route's four phases bit-equal to its one
        launch; beside the limit a planted fault, the plain output with a
        16-wide k slice of Wout inside the width (k 368 .. 383, or the last
        16 of a narrower one) left out, which must exceed it."""
        name = str(dtype).removeprefix("torch.")
        hd = h * dh
        args = block_inputs(randn, 170 + dh, b, s, hd, dtype)
        x, g, be, wqkv, bqkv, wout, bout = args
        require(fa.fused_block_supported(hd, h), f"row 8 admits {label}")
        route = fa.fused_block_route(dtype, hd, h,
                                     (*wqkv.stride(), *wout.stride()))
        got = []
        require_route(f"fused {label} {name}", lambda: got.append(
            fa.fused_attention_block_fwd(
                *args, h, out=torch.full_like(x, float("nan")))),
            [(block_route(dh), name)])
        out = got[0]
        want = fa.fused_attention_block_reference(*args, h)
        again = fa.fused_attention_block_fwd(*args, h)
        out_in = fa.fused_attention_block_fwd(
            x, g, be, wqkv.t().contiguous().t(), bqkv,
            wout.t().contiguous().t(), bout, h)
        k0 = min(368, hd - 16)
        cut = wout.clone()
        cut[k0:k0 + 16] = 0
        e_fault = max_err(fa.fused_attention_block_reference(
            x, g, be, wqkv, bqkv, cut, bout, h), want)
        torch.cuda.synchronize()
        e = max_err(out, want)
        tol = KERNEL_TOL[name] * max(1.0, want.float().abs().max().item())
        errs[("fused_block", label, name)] = e
        log(f"fused fused_attention_block {label} {name} ({route}): "
            f"max|out-plain| {e:.3e} (tol {tol:.3e}, k {k0}..{k0 + 15} of "
            f"Wout left out {e_fault:.3e}), every element written, rerun "
            "and (out, in) weights bit-equal")
        require(e_fault > tol, f"fused_attention_block {label} {name}: a "
                f"16-wide k slice of Wout left out ({e_fault:.3e}) would "
                f"pass the limit {tol:.3e}")
        require(not bool(torch.isnan(out.float()).any())
                and torch.equal(again, out) and torch.equal(out_in, out)
                and e <= tol,
                f"fused_attention_block {label} {name}: every element "
                "written, reruns and the (out, in) layout bit-equal, within "
                "tolerance of the plain version")
        require(route == ("tensor_cores" if dtype == bf16 else "cuda_cores"),
                f"fused_attention_block {label} {name}: route {route}")
        if route == "tensor_cores":
            require(torch.equal(fa._measure_fused_block_phases(
                        *args, h, (0, 1, 2, 3)), out),
                    f"fused_attention_block {label}: the one cooperative "
                    "launch bit-equal to its four phases launched in order")

    for dtype in (bf16, fp32):
        for dh, h in BLOCK_HEAD_DIMS:
            check_block(f"B8 S197 H{h} dh{dh}", 8, 197, h, dh, dtype)
        check_block("ViT-B3 B32 S197 H3 dh256", 32, 197, 3, 256, dtype)
    log(f"fused row 8 checks in {time.perf_counter() - t_phase:.1f} s")

    # ---- row 4 at every routed shape ---------------------------------------
    for dtype in (bf16, fp32):
        name = str(dtype).removeprefix("torch.")
        for g, s, d in ROW4_SHAPES:
            chk = RowChecks("fused", lambda row, d_, s=s, name=name:
                            row4_route(s, d_, name), errs)
            chk.check_small_bwd(f"G{g} S{s} D{d}", 1, g, s, d, dtype)
    # flash_attention's autograd backward at ViT-B3's split heads under
    # USE_PALLAS_BWD: row 4, not row 6
    q, k, v = (randn(180 + i, 32, 3, 197, 256, dtype=bf16).requires_grad_()
               for i in range(3))
    fa.USE_PALLAS_BWD = True
    try:
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        _build.reset_launched()
        out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
        taken = _build.launched()
    finally:
        fa.USE_PALLAS_BWD = False
    require(set(ROUTE_NAMES[("row 4 wide", "bfloat16")]) <= set(taken)
            and not any(n.startswith("drop_bwd") for n in taken),
            f"flash_attention's backward at ViT-B3's split heads under "
            f"USE_PALLAS_BWD launches row 4, not row 6: {taken}")
    log(f"route fused flash_attention backward B32 H3 S197 D256 under "
        f"USE_PALLAS_BWD: {taken} (row 4, no row 6)")
    del q, k, v, out
    log(f"fused row 4 checks done at {time.perf_counter() - t_phase:.1f} s")

    # ---- times (bf16) -------------------------------------------------------
    def put(name, key, k_ms, p_ms, l_ms, nbytes, flops, dtype="bfloat16"):
        bnd, by = bound_ms(nbytes, flops, dtype)
        times.setdefault(name, {}).update({
            f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
            f"{key}_library_ms": l_ms, f"{key}_bound_ms": bnd,
            f"{key}_bound_by": by, f"{key}_tflops": flops / k_ms / 1e9})
        log(f"fused time {name} {key}: kernel {k_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}), plain {p_ms:.4f} ms, library "
            f"{l_ms:.4f} ms, {flops / k_ms / 1e9:.1f} TFLOP/s")

    for key, h, dh in (("vitb3_b32_s197_h3_dh256", 3, 256),
                       ("caits_b32_s197_h8_dh48", 8, 48),
                       ("b32_s197_h8_dh96", 8, 96),
                       ("vith14_b32_s197_h16_dh80", 16, 80)):
        hd = h * dh
        blk = block_inputs(randn, 190 + dh, 32, 197, hd, bf16)
        put("fused_attention_block", key,
            cuda_ms(lambda: fa.fused_attention_block_fwd(*blk, h)),
            cuda_ms(lambda: fa.fused_attention_block_reference(*blk, h),
                    iters=5),
            cuda_ms(lambda: library_block(*blk, h)),
            (2 * 32 * 197 * hd + 4 * hd * hd) * 2 + 6 * hd * 4,
            2 * 32 * 197 * hd * 4 * hd + 4 * 32 * 197 * 197 * hd)
        if key.startswith("vitb3"):
            dev_ms = queued_ms(
                [lambda: fa.fused_attention_block_fwd(*blk, h)]
                + [lambda p=p: fa._measure_fused_block_phases(*blk, h, (p,))
                   for p in range(4)])
            times["fused_attention_block"].update(
                {f"{key}_device_ms": dev_ms[0],
                 **{f"{key}_phase{i}_ms": t for i, t in
                    enumerate(dev_ms[1:])}})
            log(f"fused row 8 at ViT-B3 B 32, device time: one launch "
                f"{dev_ms[0]:.4f} ms; its phases launched alone "
                f"{', '.join(f'{t:.4f}' for t in dev_ms[1:])} ms (statistics, "
                f"LN + QKV, attention, out-projection)")
        del blk

    def sdpa_grad(q_, k_, v_, do_):
        leaves = [t.detach().requires_grad_() for t in (q_, k_, v_)]
        o = F.scaled_dot_product_attention(*leaves)
        return lambda: torch.autograd.grad(o, leaves, do_, retain_graph=True)

    for g, s, d in ROW4_SHAPES:
        for dtype in (bf16, fp32):
            name = str(dtype).removeprefix("torch.")
            q, k, v, do = (randn(200 + i, 1, g, s, d, dtype=dtype)
                           for i in range(4))
            out, lse = fa.flash_attention_fwd(q, k, v)
            io = g * s * d * dtype.itemsize
            key = f"g{g}_s{s}_d{d}" + ("" if dtype == bf16 else "_fp32")
            put("flash_attention_bwd", key,
                cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse,
                                                       do)),
                cuda_ms(lambda: fa.flash_attention_bwd_reference(
                    q, k, v, out, lse, do), iters=3),
                cuda_ms(sdpa_grad(q, k, v, do)),
                8 * io + g * s * 4, 10 * g * s * s * d, dtype=name)
            del q, k, v, do, out, lse
    log(f"fused times done at {time.perf_counter() - t_phase:.1f} s")

    # ---- the models ---------------------------------------------------------
    rng = np.random.RandomState(20)

    def counted(fn):
        fa.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        runs.append(dict(fa.LAUNCHES))
        return out, runs[-1]

    def nonzero(launches):
        return {k: v for k, v in launches.items() if v}

    vit = ViT(image_size=224, **VITB3, dtype="bfloat16")
    weights = seeded_state_dict(vit, seed=256)
    vit.load_state_dict(weights)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving.export_classifier(vit, (224, 224, 3), tmp, buckets=(1, 32),
                                  dtype=fp32)
        clf = serving.load_classifier(tmp)
    del vit
    clf.warmup()
    x = rng.standard_normal((32, 224, 224, 3)).astype(np.float32)
    try:
        for bkt in (1, 32):
            logits = {}
            for flag in (True, False):
                vv.USE_FUSED_BLOCK = flag
                logits[flag], la = counted(lambda: clf.predict(x[:bkt]))
                want = ({"fused_attention_block": 12} if flag
                        else {"packed_attention": 12})
                require(nonzero(la) == want
                        and bool(torch.isfinite(logits[flag].float()).all()),
                        f"ViT-B3 @224 bucket {bkt} USE_FUSED_BLOCK={flag}: "
                        f"finite logits, launches {want} a forward: {la}")
                require_route(
                    f"ViT-B3 @224 bucket {bkt} USE_FUSED_BLOCK={flag}",
                    lambda: clf.predict(x[:bkt]),
                    [("row 8 wide" if flag else "row 1 wide", "bfloat16")])
                for _ in range(2):
                    clf.predict(x[:bkt]).float().cpu()
                t0 = time.perf_counter()
                for _ in range(5):
                    clf.predict(x[:bkt]).float().cpu()
                ms = (time.perf_counter() - t0) / 5 * 1e3
                with torch.inference_mode():
                    xb = torch.from_numpy(x[:bkt]).to(dev)
                    dev_ms = cuda_ms(lambda: clf.model(xb), iters=5,
                                     warmup=1)
                wall, busy, count, _ = device_profile(
                    lambda: clf.predict(x[:bkt]).float().cpu())
                idle = None if busy is None else 1 - busy / wall
                numbers[f"ViT-B3 flag {'on' if flag else 'off'} b{bkt}"] = \
                    dict(ms=ms, device_ms=dev_ms, idle=idle)
                log(f"ViT-B3 @224 bf16 USE_FUSED_BLOCK={flag} served bucket "
                    f"{bkt}: {ms:.3f} ms per request (host numpy in, logits "
                    f"out), forward device time {dev_ms:.3f} ms; profile "
                    + ("saw no device activity" if busy is None else
                       f"wall {wall:.3f} ms, busy {busy:.3f} ms in {count} "
                       f"activities, idle share {idle:.3f}"))
            scale = logits[False].float().abs().max().item()
            e = max_err(logits[True], logits[False])
            numbers[f"ViT-B3 flag on vs off b{bkt}"] = dict(err=e, scale=scale)
            log(f"ViT-B3 @224 bucket {bkt}: flag on against off max|logit "
                f"diff| {e:.3e} (tol {LOGIT_TOL_BF16_REL} x max|ref| "
                f"{scale:.3f})")
            require(e <= LOGIT_TOL_BF16_REL * scale,
                    f"ViT-B3 @224 bucket {bkt}: flag-on logits within "
                    f"{LOGIT_TOL_BF16_REL} x max|logit| of flag off")
        del clf

        # 2 layers in fp32, flag on: the card's CUDA-core route against the
        # CPU's plain version
        vv.USE_FUSED_BLOCK = True
        two = {k: v_ for k, v_ in weights.items()
               if not re.search(r"encoder_layer_([2-9]|1\d)\.", k)}
        card2 = ViT(image_size=224, **dict(VITB3, num_layers=2))
        card2.load_state_dict(two)
        cpu2 = ViT(image_size=224, **dict(VITB3, num_layers=2), device="cpu")
        cpu2.load_state_dict(two)
        x2 = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
        with torch.no_grad():
            got2, la2 = counted(lambda: card2(torch.from_numpy(x2).to(dev)))
            require_route("ViT-B3 2 layers fp32 flag-on forward",
                          lambda: card2(torch.from_numpy(x2).to(dev)),
                          [("row 8 wide", "float32")])
            want2 = cpu2(torch.from_numpy(x2))
        e2 = max_err(got2.cpu(), want2)
        numbers["vitb3_2layers_fp32_flag_on_err"] = e2
        log(f"ViT-B3 2 layers fp32 USE_FUSED_BLOCK=True, card against the "
            f"CPU's plain version: max|logit diff| {e2:.3e} (tol "
            f"{FUSED_LOGIT_TOL_FP32}, max|ref| "
            f"{want2.abs().max().item():.3f}), launches {nonzero(la2)}")
        require(e2 <= FUSED_LOGIT_TOL_FP32
                and nonzero(la2) == {"fused_attention_block": 2},
                "ViT-B3 2 layers fp32 flag on, on the card against the CPU")
        del card2, cpu2, two, weights

        # the probes: 2 layers in bf16, flag on against off
        for label, cfg in FUSED_PROBES.items():
            m = ViT(image_size=224, **cfg, dtype="bfloat16")
            m.load_state_dict(seeded_state_dict(m, seed=cfg["hidden_dim"]))
            xp = torch.from_numpy(rng.standard_normal(
                (8, 224, 224, 3)).astype(np.float32)).to(dev)
            dh = cfg["hidden_dim"] // cfg["num_heads"]
            outs = {}
            with torch.no_grad():
                for flag in (True, False):
                    vv.USE_FUSED_BLOCK = flag
                    outs[flag], la = counted(lambda: m(xp))
                    attn = la["packed_attention"] + la["flash_attention"]
                    require(la["fused_attention_block"] == (2 if flag else 0)
                            and attn == (0 if flag else 2),
                            f"probe {label} flag {flag}: 2 row-8 launches "
                            f"(flag on) or 2 attention forwards (off): {la}")
                vv.USE_FUSED_BLOCK = True
                require_route(f"probe {label} dh{dh} flag-on forward",
                              lambda: m(xp), [(block_route(dh), "bfloat16")])
            scale = outs[False].float().abs().max().item()
            e = max_err(outs[True], outs[False])
            numbers[f"probe {label}"] = dict(err=e, scale=scale)
            log(f"probe {label} (hidden {cfg['hidden_dim']}, "
                f"{cfg['num_heads']} heads, dh {dh}, 2 layers, bf16, B 8): "
                f"flag on against off max|logit diff| {e:.3e} (tol "
                f"{LOGIT_TOL_BF16_REL} x max|ref| {scale:.3f})")
            require(e <= LOGIT_TOL_BF16_REL * scale,
                    f"probe {label}: flag-on logits within "
                    f"{LOGIT_TOL_BF16_REL} x max|logit| of flag off")
            del m, xp
    finally:
        vv.USE_FUSED_BLOCK = False

    times.setdefault("fused_attention_block", {})["head_dims_max_abs_err"] = \
        max(v for k, v in errs.items()
            if k[0] == "fused_block" and k[-1] == "bfloat16")
    times.setdefault("flash_attention_bwd", {})["routed_max_abs_err"] = max(
        v for k, v in errs.items() if k[0] == "row 4" and "bfloat16" in k)
    totals = {k: sum(r.get(k, 0) for r in runs) for k in fa.LAUNCHES}
    log(f"fused phase in {time.perf_counter() - t_phase:.1f} s, launches "
        f"{nonzero(totals)}")
    return totals, times, errs, numbers


# Row 11 and its backward (row 10) at head dims outside the pack and fused
# plans' (phase 7g): (label, G, N, H, dh, nW') at N 49 for dh 12-256 (the
# 16, 32 and 64 tiles and the chunks above 64), N 16, 64 and 128 at one dh
# a tile, ragged G (not a multiple of the windows a block takes at once).
WINDOW_OTHER_SHAPES = [
    ("dh12 G64 N49 H8", 64, 49, 8, 12, 1),   # 24-byte sections: 8-byte copies
    ("dh24 G64 N49 H4 nW'16", 64, 49, 4, 24, 16),
    ("dh48 G256 N49 H2", 256, 49, 2, 48, 1),
    ("dh80 G64 N49 H2", 64, 49, 2, 80, 1),
    ("dh96 G256 N49 H1", 256, 49, 1, 96, 1),
    ("dh128 G64 N49 H2 nW'4", 64, 49, 2, 128, 4),
    ("dh192 G64 N49 H2", 64, 49, 2, 192, 1),
    ("dh256 G64 N49 H2 nW'16", 64, 49, 2, 256, 16),
    ("dh12 G99 N16 H3 ragged", 99, 16, 3, 12, 1),
    ("dh24 G33 N64 H2 ragged", 33, 64, 2, 24, 1),
    ("dh48 G20 N128 H2 no bias", 20, 128, 2, 48, 0),
    ("dh96 G37 N64 H1 ragged", 37, 64, 1, 96, 1),
    ("dh96 G20 N128 H1", 20, 128, 1, 96, 1),
    ("dh192 G21 N16 H1 ragged", 21, 16, 1, 192, 1),
    ("dh192 G10 N128 H1", 10, 128, 1, 192, 1),
]
# The largest dh the batched plan admits at one head, by the JAX budget at
# its least block with the call's itemsize: (N, dh) in each dtype.
WINDOW_LARGEST = {"bfloat16": ((49, 1534), (128, 532)),
                  "float32": ((49, 919), (128, 318))}
# Swin-T's published widths (arXiv:2103.14030: C 96, depths 2-2-6-2, window
# 7) at 2 and at 1 heads a stage: dh 48 (the 64 tile) and 96 (the
# 64-column chunks), shape probes as phase 7e's Swin-T4. At batch 32 the JAX routes: the
# unshifted blocks of stages 1 and 2 and both of stage 4 batched, every
# other block the split-head kernel (no pack or fused plan takes these dh).
SWIN_T_FEWER_HEADS = {48: [2, 4, 8, 16], 96: [1, 2, 4, 8]}
SWIN_T_FEWER_LAUNCHES = {"window_batched_attention": 4, "flash_attention": 8}
SWIN_T_FEWER_ROUTES = ["batched", "split"] * 2 + ["split"] * 6 \
    + ["batched", "batched"]


def other_route(row: str, route: str) -> str:
    """The ROUTE_NAMES row of row 10 or 11 on ``window_route``'s route at a
    head dim outside WINDOW_HEAD_DIMS."""
    return f"{row} chunked" if route.endswith("chunked") else f"{row} padded"


def window_head_dims_phase():
    """Phase 7g: rows 11 and 10 at every head dim the JAX batched plan
    admits, against their plain versions; their times beside bound, plain
    and library; the route at H·dh 2176; Swin-T at 2 heads a stage (dh 48)
    served and trained, in fp32 against the CPU, and at 1 head a stage (dh
    96) served. Returns (the launches of its model runs by wrapper, times
    by wrapper name, the checks' errors, the model numbers)."""
    import torch
    import torch.nn.functional as F

    from vision_transformers_tpu_torch.models.image_classification import (
        SwinTransformer,
    )
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.ops import windows
    from vision_transformers_tpu_torch.utils.args import get_args

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32
    errs, times = {}, {}
    chk = RowChecks("head dims", vith_route, errs)
    randn = chk.randn

    # ---- rows 11 and 10 at every admitted head dim -------------------------
    def check(label, g, n, h, dh, nwp, dtype):
        """Row 11 into a freed NaN-filled block (``into_freed_nan``), row 10
        into a NaN-filled dqkv, with and without dbias: against the plain
        versions, every element written, reruns bit-equal, the kernels by
        name, each beside a planted fault (the plain result with key 0 of
        the last window hidden from its queries)."""
        name = str(dtype).removeprefix("torch.")
        qkv = randn(700 + dh, g, n, 3 * h * dh, dtype=dtype)
        bias = None if nwp == 0 else randn(701 + dh, nwp, h, n, n, dtype=fp32)
        do = randn(702 + dh, g, n, h * dh, dtype=dtype)
        hidden = (torch.zeros(g, h, n, n, device=dev) if bias is None
                  else bias.repeat(g // nwp, 1, 1, 1))
        hidden[-1, :, :, 0] = -1e9
        ref = fa.window_attention_reference(qkv, bias, h)
        fault = fa.window_attention_reference(qkv, hidden, h)
        got = []

        # the bias already rounded: the wrapper's first tensor is out
        bias_r = None if bias is None else bias.to(dtype)

        def forward():
            got.append(into_freed_nan(
                lambda: fa.window_batched_attention(qkv, bias_r, h),
                (g, n, h * dh), dtype, dev))

        route = fa.window_route(dtype, n, dh, "batched")
        require_route(f"row 11 {label} {name}", forward,
                      [(other_route("row 11", route), name)])
        out = got[0]
        e, share = max_err(out, ref), differing_share(out, ref)
        ef = max_err(out, fault)
        require(not bool(torch.isnan(out.float()).any())
                and e <= WINDOW_TOL[name]
                and (dtype == fp32 or share <= WINDOW_DIFFERING_MAX)
                and ef > WINDOW_TOL[name]
                and torch.equal(fa.window_batched_attention(qkv, bias, h),
                                out),
                f"row 11 {label} {name} ({route}): against its plain version "
                f"({e:.3e}, {share:.4f} of elements differ), every element "
                f"written, the planted fault {ef:.3e} above the limit, rerun "
                "bit-equal")
        errs[("row 11", label, name)] = e
        dref, db_ref = fa.window_attention_bwd_reference(qkv, bias, do, h)
        dfault, _ = fa.window_attention_bwd_reference(qkv, hidden, do, h)
        got = []
        broute = fa.window_route(dtype, n, dh, "bwd")
        require_route(f"row 10 {label} {name}", lambda: got.append(
            fa.window_attention_bwd(qkv, bias, do, h,
                                    dqkv=chk.nan_like(qkv))),
            [(other_route("row 10", broute), name)])
        (dqkv, db), again = got[0], fa.window_attention_bwd(qkv, bias, do, h)
        tol = (WINDOW_GRAD_TOL if dtype == bf16 else GRAD_TOL[name]) \
            * max(1.0, dref.float().abs().max().item())
        eg, efg = max_err(dqkv, dref), max_err(dqkv, dfault)
        no_db = fa.window_attention_bwd(qkv, bias, do, h, need_dbias=False)
        ok = (bool(torch.isfinite(dqkv.float()).all()) and eg <= tol
              and efg > tol and torch.equal(again[0], dqkv)
              and torch.equal(no_db[0], dqkv) and no_db[1] is None)
        eb = 0.0
        if bias is not None:
            tol_b = tol / max(1.0, dref.float().abs().max().item()) * max(
                1.0, db_ref.float().abs().max().item())
            eb = max_err(db, db_ref)
            ok = ok and eb <= tol_b and torch.equal(again[1], db)
        require(ok, f"row 10 {label} {name} ({broute}): against its plain "
                f"version ({eg:.3e} > {tol:.3e}?; dbias {eb:.3e}), every "
                f"element written, the planted fault {efg:.3e} above the "
                "limit, reruns and the run without dbias bit-equal")
        errs[("row 10", label, name)] = eg
        log(f"head dims {label} {name}: row 11 ({route}) max|out-plain| "
            f"{e:.3e} (tol {WINDOW_TOL[name]}), {share:.4f} differ, fault "
            f"{ef:.3e}; row 10 ({broute}) max|dqkv-plain| {eg:.3e} (tol "
            f"{tol:.3e}), dbias {eb:.3e}, fault {efg:.3e}; every element "
            "written, reruns bit-equal")

    for dtype in (bf16, fp32):
        name = str(dtype).removeprefix("torch.")
        for label, g, n, h, dh, nwp in WINDOW_OTHER_SHAPES:
            check(label, g, n, h, dh, nwp, dtype)
        size = torch.empty((), dtype=dtype).element_size()
        for n, dh in WINDOW_LARGEST[name]:
            require(fa.window_batched_plan(8, n, 1, dh, 1, size) is not None
                    and fa.window_batched_plan(8, n, 1, dh + 1, 1, size)
                    is None, f"the batched plan's largest dh at N {n}, H 1, "
                    f"{name}: {dh}")
            check(f"largest dh{dh} G8 N{n} H1", 8, n, 1, dh, 1, dtype)
    log(f"head dims checks in {time.perf_counter() - t_phase:.1f} s")

    # ---- H·dh 2176 at N 49: the JAX budget refuses the batched kernel ------
    require(fa.window_batched_plan(32, 49, 68, 32, 1, 2) is None
            and fa.window_batched_plan(32, 49, 67, 32, 1, 2) is not None,
            "the batched plan at N 49, dh 32, bf16: 67 heads admitted, 68 "
            "refused")
    runs = []
    for heads, want in ((67, "batched"), (68, "pack")):
        c = 32 * heads
        x = randn(710, 32, 7, 7, c, dtype=bf16)
        w_qkv, w_proj = (randn(711 + i, c, k * c, dtype=bf16) * 0.02
                         for i, k in enumerate((3, 1)))
        rel = randn(713, heads, 49, 49, dtype=fp32)
        windows.ROUTE_LOG = []
        fa.reset_launch_counts()
        with torch.no_grad():
            y = windows.shifted_window_attention(x, w_qkv, None, w_proj, None,
                                                 rel, (7, 7), heads, (0, 0))
        torch.cuda.synchronize()
        taken, la = list(windows.ROUTE_LOG), dict(fa.LAUNCHES)
        windows.ROUTE_LOG = None
        runs.append(la)
        require(taken == [want] and bool(torch.isfinite(y.float()).all())
                and la[f"window_{'batched' if want == 'batched' else 'packed'}"
                       "_attention"] == 1,
                f"H·dh {c} at N 49, bf16: the route {want} (the JAX plans')"
                f": {taken}, {la}")
        log(f"H·dh {c} (heads {heads}, dh 32) at N 49, batch 32, bf16: "
            f"route {taken[0]}, as the JAX plans decide")

    # ---- the rows' times (bf16; fp32 at dh 48) -----------------------------
    def put(name, key, k_ms, p_ms, l_ms, nbytes, flops, dtype="bfloat16"):
        bnd, by = bound_ms(nbytes, flops, dtype)
        times.setdefault(name, {}).update({
            f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
            f"{key}_library_ms": l_ms, f"{key}_bound_ms": bnd,
            f"{key}_bound_by": by})
        log(f"head dims time {name} {key}: kernel {k_ms:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}), plain {p_ms:.4f} ms, SDPA {l_ms:.4f} ms")

    g, n = 2048, 49  # Swin-T's stage 1 at batch 32, one shared bias
    for h, dh, dtype in ((2, 48, bf16), (1, 96, bf16), (1, 192, bf16),
                         (2, 48, fp32)):
        name = str(dtype).removeprefix("torch.")
        key = f"s1_g{g}_h{h}_dh{dh}" + ("_fp32" if dtype == fp32 else "")
        qkv = randn(720, g, n, 3 * h * dh, dtype=dtype)
        bias = randn(721, 1, h, n, n, dtype=fp32)
        do = randn(722, g, n, h * dh, dtype=dtype)
        mask = bias.to(dtype).expand(g, h, n, n)
        q, k, v = split_heads(qkv, h)
        do_h = do.view(g, n, h, dh).transpose(1, 2)
        item = torch.empty((), dtype=dtype).element_size()
        io = g * n * h * dh * item
        put("window_batched_attention", key,
            cuda_ms(lambda: fa.window_batched_attention(qkv, bias, h)),
            cuda_ms(lambda: fa.window_attention_reference(qkv, bias, h),
                    iters=3),
            cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                           attn_mask=mask)),
            4 * io + h * n * n * item, 4 * g * h * n * n * dh, name)
        put("window_attention_bwd", key,
            cuda_ms(lambda: fa.window_attention_bwd(qkv, bias, do, h)),
            cuda_ms(lambda: fa.window_attention_bwd_reference(qkv, bias, do,
                                                              h), iters=3),
            cuda_ms(sdpa_grad(q, k, v, do_h, mask=mask)),
            7 * io + g * h * n * n * item + h * n * n * item,
            10 * g * h * n * n * dh, name)
        del qkv, bias, do, mask, q, k, v, do_h
    log(f"head dims times done at {time.perf_counter() - t_phase:.1f} s")

    # ---- the models ---------------------------------------------------------
    mr = ModelRuns(21)
    mr.runs.extend(runs)
    base = dict(get_args("swint_224_imagenet"), stochastic_depth_prob=0.0)
    for dh, heads in SWIN_T_FEWER_HEADS.items():
        label = f"Swin-T dh{dh} @224"
        row11 = other_route("row 11", fa.window_route(bf16, 49, dh, "batched"))
        fwd_routes = [(row11, "bfloat16"), ("row 2 padded", "bfloat16")]
        args = dict(base, num_heads=heads)
        swin = SwinTransformer(**args, dtype="bfloat16")
        sw = seeded_state_dict(swin, seed=dh)
        swin.load_state_dict(sw)
        windows.ROUTE_LOG = []
        mr.serve(label, swin, (224, 224, 3), (1, 32) if dh == 48 else (32,),
                 SWIN_T_FEWER_LAUNCHES, fwd_routes)
        taken = list(windows.ROUTE_LOG[:12])
        windows.ROUTE_LOG = None
        require(taken == SWIN_T_FEWER_ROUTES,
                f"{label} routes as the JAX package's plans: {taken}")
        del swin
        if dh != 48:
            continue
        m = SwinTransformer(**args, dtype="bfloat16")
        m.load_state_dict(sw)
        mr.train(label, m, 224, 32, 3, 1e-4,
                 {"window_batched_attention": 4, "window_attention_bwd": 4,
                  "fused_adam": 1},
                 fwd_routes + [("row 10 padded", "bfloat16")])
        del m
        # fp32 at batch 2: the card against the CPU's plain versions
        card = SwinTransformer(**args)
        card.load_state_dict(sw)
        cpu = SwinTransformer(**args, device="cpu")
        cpu.load_state_dict(sw)
        xs = mr.rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
        with torch.no_grad():
            got, la = mr.counted(lambda: card(torch.from_numpy(xs).to(dev)))
            require_route(f"{label} fp32 forward",
                          lambda: card(torch.from_numpy(xs).to(dev)),
                          [("row 11 padded", "float32")])
            want = cpu(torch.from_numpy(xs))
        e = max_err(got.cpu(), want)
        log(f"{label} fp32, card against the CPU's plain versions: max|logit "
            f"diff| {e:.3e} (tol {LOGIT_TOL_FP32}, max|ref| "
            f"{want.abs().max().item():.3f}), launches "
            f"{ {k: v for k, v in la.items() if v} }")
        require(e <= LOGIT_TOL_FP32 and la["window_batched_attention"] == 4,
                f"{label} fp32 on the card against the CPU")
        mr.numbers[f"swint_dh{dh}_fp32_err"] = e
        del card, cpu, sw

    for name, row in (("window_attention_bwd", "row 10"),
                      ("window_batched_attention", "row 11")):
        times.setdefault(name, {})["head_dims_max_abs_err"] = max(
            v for k, v in errs.items() if k[0] == row and "bfloat16" in k)
    totals = {k: sum(r.get(k, 0) for r in mr.runs) for k in fa.LAUNCHES}
    log(f"head dims phase in {time.perf_counter() - t_phase:.1f} s, launches "
        f"{ {k: v for k, v in totals.items() if v} }")
    return totals, times, errs, mr.numbers


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from vision_transformers_tpu_torch import serving
    from vision_transformers_tpu_torch.models.image_classification import (
        PVT,
        SwinTransformer,
        SwinTransformerV2,
        TwinSVT,
        ViT,
    )
    from vision_transformers_tpu_torch.ops import _build
    from vision_transformers_tpu_torch.ops import flash_attention as fa
    from vision_transformers_tpu_torch.ops import fused_adam as fadam
    from vision_transformers_tpu_torch.ops import fused_dense as fdense
    from vision_transformers_tpu_torch.ops import windows
    from vision_transformers_tpu_torch.training import trainer
    from vision_transformers_tpu_torch.training.optimizers import make_optimizer
    from vision_transformers_tpu_torch.models.object_detection import (
        Detr,
        HungarianMatcher,
        SetCriterion,
        prepare_targets,
    )
    from vision_transformers_tpu_torch.models.object_detection.matcher import (
        _host_assign,
        auction_assign,
    )
    from vision_transformers_tpu_torch.ops import attention as attn
    from vision_transformers_tpu_torch.training.detection import (
        DetectionLoader,
        evaluate_model,
        fit_detection,
    )
    from vision_transformers_tpu_torch.utils.args import get_args
    from vision_transformers_tpu_torch.utils.coco.util.misc import (
        nested_tensor_from_tensor_list,
    )
    from vision_transformers_tpu_torch.utils.port_jax import (
        detr_state_dict_from_jax,
    )

    import vision_transformers_tpu_torch.models.image_classification as zoo
    from vision_transformers_tpu_torch.models.image_classification import (
        vanilla_vit as vv,
    )
    from vision_transformers_tpu_torch.utils import port_jax

    # ViT-B/16 widths for the ViT and CPE-ViT entries
    vitb = get_args("vitb16_224_imagenet")
    FAMILY = {label: (getattr(zoo, cls), kw if kw is not None else vitb,
                      convert, layers, extra)
              for label, (cls, kw, convert, layers, extra)
              in FAMILY_CONFIGS.items()}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bf16, fp32 = torch.bfloat16, torch.float32

    # ---- 1. device and build ---------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    build_s = _build.build()
    log(f"kernel build: {build_s:.2f} s for {list(_build.KERNELS)}")
    kept = {}
    for src, kernel, regs, smem, spill, stack in ptxas_usage(
            _build.build_log):
        if src in PTXAS_SOURCES:
            log(f"  ptxas {src}: {kernel}: {regs} registers, {smem} bytes "
                f"smem, {stack} bytes stack, {spill} bytes spilled")
        if kernel in KEPT_REGISTERS:
            kept[kernel] = regs
    require(kept == KEPT_REGISTERS, "the kernels of KEPT_REGISTERS keep "
            "their registers: "
            f"{ {k: (v, kept.get(k)) for k, v in KEPT_REGISTERS.items() if kept.get(k) != v} }")
    log(f"ptxas: the {len(kept)} kernels of KEPT_REGISTERS (rows 1-8 and 14, "
        "both routes; rows 9-13 in fp32, rows 9 and 10 on the tensor cores; "
        "rows 10 and 11 at other head dims) at their registers")
    # the fp32 fused block (row 8's CUDA-core route) reads the workspaces its
    # own phases wrote through L2, never by the non-coherent path
    loads = sass_global_loads(_build._lib_path("fused_block"),
                              r"fused_block_kernelIfLi(\d+)E")
    for d_, (n_ldg, n_nc, n_l2) in loads.items():
        log(f"sass fused_block_kernel<float, {d_}>: {n_ldg} global loads, "
            f"{n_nc} .CONSTANT (the non-coherent path; "
            f"{FUSED_BLOCK_NC_LOADS_BEFORE[d_]} before its workspace reads "
            f"went through L2), {n_l2} .STRONG.GPU (through L2)")
    require(sorted(loads) == [16, 32, 64]
            and all(n_l2 > 0 and n_nc <= FUSED_BLOCK_NC_LOADS_BEFORE[d_]
                    for d_, (_, n_nc, n_l2) in loads.items()),
            f"fused_block_kernel<float, D> reads its workspaces through L2: "
            f"{loads}")
    # and so do its instantiations at the other head dims (the padded tiles
    # and the wide one): no .CONSTANT load at all
    for kernel, pattern, dims in (
            ("fused_block_padded_kernel<float, {}>",
             r"fused_block_padded_kernelIfLi(\d+)E", [16, 32, 64, 128]),
            ("fused_block_wide_kernel<float>{}", r"fused_block_wide_kernelIfE",
             [0])):
        loads = sass_global_loads(_build._lib_path("fused_block"), pattern)
        for d_, (n_ldg, n_nc, n_l2) in loads.items():
            log(f"sass {kernel.format(d_ or '')}: {n_ldg} global loads, "
                f"{n_nc} .CONSTANT, {n_l2} .STRONG.GPU (through L2)")
        require(sorted(loads) == dims
                and all(n_l2 > 0 and n_nc == 0
                        for _, n_nc, n_l2 in loads.values()),
                f"{kernel.format('D')} reads its workspaces through L2, "
                f"never by the non-coherent path: {loads}")

    # ---- 2. kernels against their plain versions -------------------------
    def randn(seed, *shape, dtype):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randn(*shape, generator=g).to(dev, dtype)

    errs = {}

    def nan_filled(b, s, h, dh, dtype):
        """out and lse of a packed forward, filled with NaN."""
        return dict(out=torch.full((b, s, h * dh), float("nan"), dtype=dtype,
                                   device=dev),
                    lse=torch.full((b, s, h), float("nan"), device=dev))

    def check_packed(label, b, s, h, dh, kv_valid, dtype):
        qkv = randn(1, b, s, 3 * h * dh, dtype=dtype)
        out, lse = fa.packed_flash_attention_fwd(
            qkv, h, kv_valid=kv_valid, **nan_filled(b, s, h, dh, dtype))
        ref, ref_lse = fa.packed_flash_attention_reference(
            qkv, h, kv_valid=kv_valid)
        again = fa.packed_flash_attention_fwd(qkv, h, kv_valid=kv_valid)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        name = str(dtype).removeprefix("torch.")
        log(f"packed {label} {name}: max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL[name]}), max|lse-plain| {el:.3e}, every "
            "element written, rerun bit-equal")
        require(bool(torch.isfinite(out).all())
                and bool(torch.isfinite(lse).all()) and e <= KERNEL_TOL[name]
                and el <= LSE_TOL and torch.equal(again[0], out)
                and torch.equal(again[1], lse),
                f"packed {label} {name} against its plain version, every "
                "element written, rerun bit-equal")
        errs[("packed", label, name)] = e

    def check_flash(label, b, h, sq, sk, d, bias_lead, kv_valid, dtype):
        q = randn(2, b, h, sq, d, dtype=dtype)
        k = randn(3, b, h, sk, d, dtype=dtype)
        v = randn(4, b, h, sk, d, dtype=dtype)
        bias = (None if bias_lead is None
                else randn(5, bias_lead, h, sq, sk, dtype=fp32))
        out, lse = fa.flash_attention_fwd(q, k, v, bias, kv_valid=kv_valid)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, bias,
                                                    kv_valid=kv_valid)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        name = str(dtype).removeprefix("torch.")
        log(f"split {label} {name}: max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL[name]}), max|lse-plain| {el:.3e}")
        require(bool(torch.isfinite(out).all()) and e <= KERNEL_TOL[name]
                and el <= LSE_TOL, f"split {label} {name} against its plain version")
        errs[("flash", label, name)] = e

    for dtype in (bf16, fp32):
        check_packed("vitb16@224 B32 S197", 32, 197, 12, 64, None, dtype)
        check_packed("S208 kv_valid197", 32, 208, 12, 64, 197, dtype)
        check_packed("swin-head dh32", 8, 49, 3, 32, None, dtype)
        check_packed("dh16 S130 kv_valid120", 4, 130, 4, 16, 120, dtype)
        check_flash("vitb16@512 G96 S1025", 8, 12, 1025, 1025, 64, None,
                    None, dtype)
        for lead, what in ((1, "shared"), (4, "per-window"),
                           (8, "per-group")):
            check_flash(f"swin N49 bias {what}", 8, 3, 49, 49, 32, lead,
                        None, dtype)
        check_flash("cross Sq3136 Sk49", 2, 1, 3136, 49, 64, None, None,
                    dtype)
        check_flash("kv_valid 60/70", 4, 3, 70, 70, 32, 1, 60, dtype)

    def grad_err(label, got, ref, name, rel_tol=None):
        e = max_err(got, ref)
        tol = (GRAD_TOL[name] if rel_tol is None else rel_tol) \
            * max(1.0, ref.float().abs().max().item())
        require(bool(torch.isfinite(got.float()).all()) and e <= tol,
                f"{label} against its plain version ({e:.3e} > {tol:.3e})")
        return e, tol

    def check_packed_train(label, b, s, h, dh, kv_valid, dtype, rate):
        """Packed forward with dropout and packed backward against their
        plain versions under one seed, and the backward twice."""
        name = str(dtype).removeprefix("torch.")
        qkv = randn(11, b, s, 3 * h * dh, dtype=dtype)
        do = randn(12, b, s, h * dh, dtype=dtype)
        kw = dict(dropout_rate=rate, seed=20261016 + (5 << 40),
                  kv_valid=kv_valid)
        out, lse = fa.packed_flash_attention_fwd(qkv, h, **kw)
        ref, ref_lse = fa.packed_flash_attention_reference(qkv, h, **kw)
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        require(bool(torch.isfinite(out.float()).all())
                and e <= KERNEL_TOL[name] and el <= LSE_TOL,
                f"packed fwd {label} {name} rate {rate} against its plain version")
        # both backwards from the kernel's (out, lse), so only the backward
        # differs: the backward (either route) replays the forward's mask
        dqkv = fa.packed_flash_attention_bwd(qkv, do, out, lse, h, **kw)
        dref = fa.packed_flash_attention_bwd_reference(qkv, do, out, lse, h,
                                                       **kw)
        eg, tol = grad_err(f"packed bwd {label} {name} rate {rate}", dqkv,
                           dref, name)
        again = fa.packed_flash_attention_bwd(qkv, do, out, lse, h, **kw)
        torch.cuda.synchronize()
        require(torch.equal(dqkv, again),
                f"packed bwd {label} {name}: two runs give equal gradients")
        log(f"packed {label} {name} rate {rate}: fwd max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL[name]}), bwd max|dqkv-plain| {eg:.3e} "
            f"(tol {tol:.3e}), rerun bit-equal")
        errs[("packed_fwd", label, name, rate)] = e
        errs[("packed_bwd", label, name, rate)] = eg

    def check_drop(label, b, h, sq, sk, d, kv_valid, masked, dtype, rate):
        """Split-head dropout forward and backward (rows 5 and 6) against
        their plain versions under one seed, and the backward twice."""
        name = str(dtype).removeprefix("torch.")
        q = randn(13, b, h, sq, d, dtype=dtype)
        k = randn(14, b, h, sk, d, dtype=dtype)
        v = randn(15, b, h, sk, d, dtype=dtype)
        do = randn(16, b, h, sq, d, dtype=dtype)
        key_mask = None
        if masked:
            m = np.random.RandomState(17).rand(b, sk) > 0.3
            m[:, 0] = True
            key_mask = torch.from_numpy(m).to(dev)
        kw = dict(dropout_rate=rate, seed=777 + (9 << 35), kv_valid=kv_valid,
                  key_mask=key_mask)
        out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
        ref, ref_lse = fa.flash_dropout_attention_reference(q, k, v, **kw)
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        require(bool(torch.isfinite(out.float()).all())
                and e <= KERNEL_TOL[name] and el <= LSE_TOL,
                f"dropout fwd {label} {name} rate {rate} against its plain version")
        got = fa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
        want = fa.flash_dropout_attention_bwd_reference(q, k, v, do, ref,
                                                        ref_lse, **kw)
        eg = max(grad_err(f"dropout bwd {label} {name} rate {rate} d{n}", g,
                          w, name)[0] for n, g, w in zip("qkv", got, want))
        again = fa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"dropout bwd {label} {name}: two runs give equal gradients")
        log(f"dropout {label} {name} rate {rate}: fwd max|out-plain| {e:.3e}, "
            f"bwd max|grad-plain| {eg:.3e} (tol {GRAD_TOL[name]} x "
            f"max(1, max|ref|)), rerun bit-equal")
        errs[("drop_fwd", label, name, rate)] = e
        errs[("drop_bwd", label, name, rate)] = eg

    for dtype in (bf16, fp32):
        for rate in (0.0, 0.1):
            check_packed_train("vitb16@224 B32 S197", 32, 197, 12, 64, None,
                               dtype, rate)
            check_packed_train("S208 kv_valid197", 32, 208, 12, 64, 197,
                               dtype, rate)
            check_packed_train("vit_tiny B64 S65", 64, 65, 4, 64, None,
                               dtype, rate)
            check_drop("vitb16@512 G96 S1025", 8, 12, 1025, 1025, 64, None,
                       False, dtype, rate)
            check_drop("cross Sq3136 Sk49", 2, 1, 3136, 49, 64, None, False,
                       dtype, rate)
            check_drop("key mask S70", 4, 3, 70, 70, 32, None, True, dtype,
                       rate)
            check_drop("kv_valid 60/70 + key mask", 4, 3, 70, 70, 32, 60,
                       True, dtype, rate)

    # rows 2, 5 and 6 at TNT's two attentions at batch 256 (the CLI's
    # tnt_cifar100, the constructor defaults): inner (B·16 patches, 4 heads,
    # S 4, D 12: a padded tile) and outer (B, 4 heads, S 17, D 128), into
    # outputs, lse and gradients pre-filled with NaN, against the plain
    # versions (lse too), reruns bit-equal, each launch by kernel name
    def check_tnt(label, b, h, s, d, dtype, rate, bias_lead):
        name = str(dtype).removeprefix("torch.")
        q, k, v, do = (randn(40 + i, b, h, s, d, dtype=dtype)
                       for i in range(4))
        pad = "" if d in (16, 32, 64, 128) else " padded"
        kw = dict(dropout_rate=rate, seed=606 + (3 << 40) if rate else None)
        if rate == 0.0:
            bias = (None if bias_lead is None
                    else randn(45, bias_lead, h, s, s, dtype=fp32))
            fwd = lambda **o: fa.flash_attention_fwd(q, k, v, bias, **o)
            ref, ref_lse = fa.flash_attention_reference(q, k, v, bias)
            row = f"row 2{pad}"
        else:
            fwd = lambda **o: fa.flash_dropout_attention_fwd(q, k, v, **kw,
                                                             **o)
            ref, ref_lse = fa.flash_dropout_attention_reference(q, k, v, **kw)
            row = f"row 5{pad}"
        got = []
        require_route(f"tnt {label} {name} rate {rate}", lambda: got.append(
            fwd(out=torch.full_like(q, float("nan")),
                lse=torch.full((b, h, s), float("nan"), device=dev))),
            [(row, name)])
        (out, lse), again = got[0], fwd()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        # KERNEL_TOL in bf16 is 1.28 bf16 steps at |out| 2-4 (the kernel
        # rounds p before it normalises, the plain version after: one step
        # apart). At 4 keys with a bias a row's output is nearly one value
        # row, past 4 here, where the step doubles: 1.28 steps of max|ref|
        big = ref.float().abs().max().item()
        tol = KERNEL_TOL[name] if dtype == fp32 else max(
            KERNEL_TOL[name], 1.28 * 2.0 ** (np.floor(np.log2(big)) - 7))
        msg = (f"tnt {label} {name} rate {rate}: {row} max|out-plain| "
               f"{e:.3e} (tol {tol:.3e}), max|lse-plain| {el:.3e}")
        log(msg)
        require(bool(torch.isfinite(out.float()).all())
                and bool(torch.isfinite(lse).all()) and e <= tol
                and el <= LSE_TOL and torch.equal(again[0], out)
                and torch.equal(again[1], lse),
                f"tnt {label} {name} rate {rate}: {row} against its plain "
                "version, every element written, rerun bit-equal")
        errs[("tnt_fwd", label, name, rate)] = e
        if bias_lead is None:  # row 6 (a bias's backward is plain PyTorch)
            gotb = []
            require_route(
                f"tnt {label} {name} rate {rate} bwd",
                lambda: gotb.append(fa.flash_dropout_attention_bwd(
                    q, k, v, do, ref, ref_lse, **kw,
                    grads=tuple(torch.full_like(t, float("nan"))
                                for t in (q, k, v)))),
                [(f"row 6{pad}", name)])
            want = fa.flash_dropout_attention_bwd_reference(
                q, k, v, do, ref, ref_lse, **kw)
            eg = max(grad_err(f"tnt {label} {name} rate {rate} d{n}", g_, w_,
                              name)[0]
                     for n, g_, w_ in zip("qkv", gotb[0], want))
            againb = fa.flash_dropout_attention_bwd(q, k, v, do, ref, ref_lse,
                                                    **kw)
            torch.cuda.synchronize()
            require(all(torch.equal(a, g_) for a, g_ in zip(againb, gotb[0])),
                    f"tnt {label} {name} rate {rate}: row 6 reruns equal")
            errs[("tnt_bwd", label, name, rate)] = eg
            msg += (f"; row 6{pad} max|grad-plain| {eg:.3e} (tol "
                    f"{GRAD_TOL[name]} x max(1, max|ref|))")
        log(msg + ", every element written, reruns bit-equal")

    for dtype in (bf16, fp32):
        for rate in (0.0, 0.1):
            check_tnt("inner B256 G16384 S4 D12", 4096, 4, 4, 12, dtype, rate,
                      None)
            check_tnt("outer B256 G1024 S17 D128", 256, 4, 17, 128, dtype,
                      rate, None)
        check_tnt("inner + bias", 4096, 4, 4, 12, dtype, 0.0, 1)
        check_tnt("outer + bias", 256, 4, 17, 128, dtype, 0.0, 1)

    # the kernel's mask is the plain function's mask: with q = 0 and v the
    # identity, the output is the dropped probability matrix itself
    rate, seed = 0.1, 4242 + (3 << 33)
    zq = torch.zeros(8, 4, 64, 64, device=dev)
    eye = torch.eye(64, device=dev).expand(8, 4, 64, 64).contiguous()
    pd, _ = fa.flash_dropout_attention_fwd(zq, zq, eye, dropout_rate=rate,
                                           seed=seed)
    keep = fa.dropout_keep_mask(seed, rate, 32, 64, 64, dev)
    require(torch.equal(pd.reshape(32, 64, 64) > 0, keep),
            "the kernel drops exactly the probabilities the plain mask drops")
    big = fa.dropout_keep_mask(seed, rate, 96, 1025, 1025, dev)
    kept, n = big.float().mean().item(), big.numel()
    sigma = (rate * (1 - rate) / n) ** 0.5
    log(f"dropout keep rate over {n} bits: {kept:.6f} (1 - r = {1 - rate}, "
        f"3 sigma = {3 * sigma:.2e})")
    require(abs(kept - (1 - rate)) <= 3 * sigma, "keep rate within 3 sigma")
    require(not torch.equal(keep, fa.dropout_keep_mask(seed + 1, rate, 32, 64,
                                                       64, dev)),
            "another seed gives another mask")
    del big

    # forward and backward of one seed replay one mask: the gradient through
    # the two kernels against autograd of the plain forward (fp32)
    qkv = randn(18, 4, 197, 3 * 12 * 64, dtype=fp32).requires_grad_()
    do = randn(19, 4, 197, 12 * 64, dtype=fp32)
    fa.packed_flash_attention(qkv, 12, dropout_rate=0.1, seed=31).backward(do)
    oracle = qkv.detach().clone().requires_grad_()
    fa.packed_flash_attention_reference(oracle, 12, dropout_rate=0.1,
                                        seed=31)[0].backward(do)
    e_replay, _ = grad_err("packed fwd+bwd mask replay", qkv.grad,
                           oracle.grad, "float32")
    qs, ks_, vs_ = (randn(20 + i, 2, 12, 300, 64, dtype=fp32).requires_grad_()
                    for i in range(3))
    do = randn(23, 2, 12, 300, 64, dtype=fp32)
    fa.flash_dropout_attention(qs, ks_, vs_, dropout_rate=0.1,
                               seed=32).backward(do)
    oracles = [t.detach().clone().requires_grad_() for t in (qs, ks_, vs_)]
    fa.flash_dropout_attention_reference(*oracles, dropout_rate=0.1,
                                         seed=32)[0].backward(do)
    e_replay = max(e_replay, *(grad_err(
        "split-head fwd+bwd mask replay", t.grad, o.grad, "float32")[0]
        for t, o in zip((qs, ks_, vs_), oracles)))
    log(f"mask replay, kernels' gradient vs autograd of the plain forward "
        f"(fp32, rate 0.1): max|diff| {e_replay:.3e}")
    del qkv, oracle, qs, ks_, vs_, oracles, do, zq, eye


    # the four window kernels: Swin-T and SwinV2-T stage shapes at batch 32,
    # and swin_tiny_cifar's 4x4 window
    def window_inputs(g, n, h, dh, nwp, dtype):
        qkv = randn(30, g, n, 3 * h * dh, dtype=dtype)
        bias = None if nwp == 0 else randn(31, nwp, h, n, n, dtype=fp32)
        return qkv, bias

    def check_window(label, g, n, h, dh, nwp, dtype):
        """The packed and the batched kernel against the plain version,
        reruns bit-equal, and rows 9 and 11's kernels by name."""
        name = str(dtype).removeprefix("torch.")
        qkv, bias = window_inputs(g, n, h, dh, nwp, dtype)
        ref = fa.window_attention_reference(qkv, bias, h)
        for fn in ("window_packed_attention", "window_batched_attention"):
            out = getattr(fa, fn)(qkv, bias, h)
            torch.cuda.synchronize()
            e, share = max_err(out, ref), differing_share(out, ref)
            log(f"{fn} {label} {name}: max|out-plain| {e:.3e} "
                f"(tol {WINDOW_TOL[name]}), elements differing {share:.3e}, "
                f"max|ref| {ref.float().abs().max().item():.3f}")
            require(bool(torch.isfinite(out.float()).all())
                    and e <= WINDOW_TOL[name]
                    and (dtype == fp32 or share <= WINDOW_DIFFERING_MAX),
                    f"{fn} {label} {name} against its plain version")
            require(torch.equal(getattr(fa, fn)(qkv, bias, h), out),
                    f"{fn} {label} {name}: reruns bit-equal")
            errs[(fn, label, name)] = e
        require_route(f"window_packed_attention {label}",
                      lambda: fa.window_packed_attention(qkv, bias, h),
                      [("row 9", name)])
        require_route(f"window_batched_attention {label}",
                      lambda: fa.window_batched_attention(qkv, bias, h),
                      [("row 11", name)])

    def fused_inputs(b, hw, win, h, dh, per_window, dtype, biased=True):
        n = win * win
        nwp = (hw // win) ** 2 if per_window else 1
        return (randn(32, b, hw, hw, 3 * h * dh, dtype=dtype),
                randn(33, nwp, h, n, n, dtype=fp32) if biased else None, nwp)

    def fused_plans(b, hw, win, h, dh, nwp):
        """The plans a map has: flat always, slab where wp % 8 == 0."""
        geom = (b, hw, hw, win, win, h, dh, nwp)
        plans = {"slab": fa.window_fused_plan(*geom),
                 "flat": fa.window_fused_flat_plan(*geom)}
        return {k: p for k, p in plans.items() if p is not None}

    def check_fused(label, b, hw, win, shift, h, dh, dtype, biased=True):
        """The slab and the flat kernel (where the map has each) against the
        plain version, into NaN-filled outputs, reruns bit-equal, and rows
        12 and 13's kernels by name, each beside a planted fault: the plain
        output with key 0 of the map's last window (the one whose rows and
        columns wrap) hidden from its queries. A per-window bias where the
        map is shifted, else a shared one; none where ``biased`` is
        false."""
        name = str(dtype).removeprefix("torch.")
        qkv, bias, nwp = fused_inputs(b, hw, win, h, dh, shift > 0, dtype,
                                      biased)
        ref = fa.window_fused_reference(qkv, bias, h, (win, win),
                                        (shift, shift))
        n, nwin = win * win, (hw // win) ** 2
        hidden = (torch.zeros(nwin, h, n, n, device=dev) if bias is None
                  else bias.float().expand(nwin, h, n, n).clone())
        hidden[-1, :, :, 0] = -1e9
        fault = fa.window_fused_reference(qkv, hidden, h, (win, win),
                                          (shift, shift))
        outs = {}
        for kind, plan in fused_plans(b, hw, win, h, dh, nwp).items():
            out = torch.full((b, hw, hw, h * dh), float("nan"), device=dev,
                             dtype=dtype)
            fa.fused_window_attention(qkv, bias, h, (win, win),
                                      (shift, shift), plan=plan, out=out)
            torch.cuda.synchronize()
            require(not bool(torch.isnan(out.float()).any()),
                    f"fused {kind} {label} {name}: every output element is "
                    "written (none of the NaN fill is left)")
            e, share = max_err(out, ref), differing_share(out, ref)
            ef = max_err(out, fault)
            log(f"window_fused_{kind}_attention {label} shift {shift} {name}: "
                f"max|out-plain| {e:.3e} (tol {WINDOW_TOL[name]}), elements "
                f"differing {share:.3e}, max|ref| "
                f"{ref.float().abs().max().item():.3f}, no NaN left of the "
                f"fill; planted fault {ef:.3e}, its elements differing "
                f"{differing_share(out, fault):.3e}")
            require(e <= WINDOW_TOL[name]
                    and (dtype == fp32 or share <= WINDOW_DIFFERING_MAX),
                    f"fused {kind} {label} {name} against its plain version")
            require(ef > WINDOW_TOL[name],
                    f"fused {kind} {label} {name}: the planted fault exceeds "
                    "the limit")
            require(torch.equal(fa.fused_window_attention(
                qkv, bias, h, (win, win), (shift, shift), plan=plan), out),
                f"fused {kind} {label} {name}: reruns bit-equal")
            require_route(
                f"window_fused_{kind}_attention {label}",
                lambda: fa.fused_window_attention(
                    qkv, bias, h, (win, win), (shift, shift), plan=plan),
                [("row 12" if kind == "flat" else "row 13", name)])
            errs[(f"window_fused_{kind}_attention", label, shift, name)] = e
            outs[kind] = out
        if len(outs) == 2:
            e = max_err(outs["slab"], outs["flat"])
            log(f"  slab against flat on the same map: max|diff| {e:.3e}")
            require(e <= WINDOW_TOL[name],
                    f"slab against flat, {label} {name}")

    for dtype in (bf16, fp32):
        check_window("swin-t s1 G2048 N49 H3 shared", 2048, 49, 3, 32, 1, dtype)
        check_window("swin-t s1 G2048 N49 H3 nW'64", 2048, 49, 3, 32, 64, dtype)
        check_window("swin-t s2 G512 N49 H6 nW'16", 512, 49, 6, 32, 16, dtype)
        check_window("swin-t s3 G128 N49 H12 nW'4", 128, 49, 12, 32, 4, dtype)
        check_window("swin-t s4 G32 N49 H24 shared", 32, 49, 24, 32, 1, dtype)
        check_window("swinv2-t s1 G1568 N64 H3 nW'49", 1568, 64, 3, 32, 49,
                     dtype)
        check_window("cifar G1024 N16 H3 nW'16", 1024, 16, 3, 32, 16, dtype)
        check_window("no bias G33 N49 H3", 33, 49, 3, 32, 0, dtype)
        # Twins-SVT-S's LSA at batch 32 takes no bias: stages 1, 2 and 4
        check_window("twins s1 G2048 N49 H2 no bias", 2048, 49, 2, 32, 0,
                     dtype)
        check_window("twins s2 G512 N49 H4 no bias", 512, 49, 4, 32, 0, dtype)
        check_window("twins s4 G32 N49 H16 no bias", 32, 49, 16, 32, 0, dtype)
        check_window("N100 G64 H2 dh64 nW'4", 64, 100, 2, 64, 4, dtype)
        check_window("N128 G64 H2 dh64 shared", 64, 128, 2, 64, 1, dtype)
        for shift in (3, 0):
            check_fused("swin-t s1 B32 56x56 H3", 32, 56, 7, shift, 3, 32,
                        dtype)
            check_fused("swin-t s2 B32 28x28 H6", 32, 28, 7, shift, 6, 32,
                        dtype)
            check_fused("swin-t s3 B32 14x14 H12", 32, 14, 7, shift, 12, 32,
                        dtype)
        check_fused("swinv2-t s2 B32 32x32 win8 H6", 32, 32, 8, 4, 6, 32,
                    dtype)
        check_fused("cifar B64 16x16 win4 H3", 64, 16, 4, 2, 3, 32, dtype)
        # Twins-SVT-S's stage 3 LSA (5 flat launches a forward): no bias, no
        # shift
        check_fused("twins s3 B32 14x14 H8 no bias", 32, 14, 7, 0, 8, 32,
                    dtype, biased=False)

    # the window backward kernel (the four forward kernels share it)
    def check_window_bwd(label, g, n, h, dh, nwp, dtype, route=False):
        name = str(dtype).removeprefix("torch.")
        qkv, bias = window_inputs(g, n, h, dh, nwp, dtype)
        do = randn(34, g, n, h * dh, dtype=dtype)
        ref, ref_db = fa.window_attention_bwd_reference(qkv, bias, do, h)
        filled = torch.full_like(qkv, float("nan"))
        got, got_db = fa.window_attention_bwd(qkv, bias, do, h, dqkv=filled)
        again, again_db = fa.window_attention_bwd(qkv, bias, do, h)
        torch.cuda.synchronize()
        what = f"window_attention_bwd {label} {name}"
        require(got is filled and not bool(torch.isnan(got.float()).any()),
                f"{what}: every element of dqkv is written (none of the NaN "
                "fill is left)")
        rel_tol = WINDOW_GRAD_TOL if dtype == bf16 else None
        e, tol = grad_err(f"{what} dqkv", got, ref, name, rel_tol)
        share = differing_share(got, ref)
        require(dtype == fp32 or share <= WINDOW_DIFFERING_MAX,
                f"{what}: dqkv bit-equal to the plain version's but for "
                f"{share:.3e} of its elements")
        require(torch.equal(got, again), f"{what}: two runs give equal dqkv")
        if route:  # row 10's kernel by name, as check_window's route
            require_route(what, lambda: fa.window_attention_bwd(
                qkv, bias, do, h), [("row 10", name)])
        msg = (f"{what}: max|dqkv-plain| {e:.3e} (tol {tol:.3e}), elements "
               f"differing {share:.3e}")
        errs[("window_attention_bwd", label, name)] = e
        if bias is None:
            require(got_db is None, f"{what}: no bias, no dbias")
        else:
            # relative to its own scale: it sums G/nW' windows
            eb, tolb = grad_err(f"{what} dbias", got_db, ref_db, name,
                                rel_tol)
            require(got_db.dtype == bias.dtype and got_db.shape == bias.shape
                    and torch.equal(got_db, again_db),
                    f"{what}: dbias as the bias, equal from run to run")
            lean, none = fa.window_attention_bwd(qkv, bias, do, h,
                                                 need_dbias=False)
            require(none is None and torch.equal(lean, got),
                    f"{what}: the same dqkv without the bias gradient")
            msg += f", max|dbias-plain| {eb:.3e} (tol {tolb:.3e})"
        if dtype == fp32:  # the second oracle: autograd of the plain forward
            leaves = [qkv.clone().requires_grad_()] + (
                [] if bias is None else [bias.clone().requires_grad_()])
            auto = torch.autograd.grad(fa.window_attention_reference(
                leaves[0], None if bias is None else leaves[1], h), leaves, do)
            ea = max(grad_err(f"{what} against autograd", a, b, name)[0]
                     for a, b in zip([got, got_db], auto))
            msg += f", against autograd of the plain forward {ea:.3e}"
        log(msg + ", NaN fill overwritten, rerun bit-equal")

    def check_fused_grad(label, b, hw, win, shift, h, dh):
        """fp32 gradients through the fused wrappers' autograd function
        against autograd of their plain version."""
        qkv, bias, nwp = fused_inputs(b, hw, win, h, dh, shift > 0, fp32)
        do = randn(35, b, hw, hw, h * dh, dtype=fp32)
        window, sh = (win, win), (shift, shift)
        x, bb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        ref = torch.autograd.grad(
            fa.window_fused_reference(x, bb, h, window, sh), (x, bb), do)
        for kind, plan in fused_plans(b, hw, win, h, dh, nwp).items():
            x, bb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
            before = fa.LAUNCHES["window_attention_bwd"]
            got = torch.autograd.grad(fa.fused_window_attention(
                x, bb, h, window, sh, plan=plan), (x, bb), do)
            require(fa.LAUNCHES["window_attention_bwd"] == before + 1,
                    f"fused {kind} {label}: its backward launches the kernel")
            e = max(grad_err(f"fused {kind} {label} shift {shift} gradient",
                             a, r, "float32")[0] for a, r in zip(got, ref))
            log(f"fused_window_attention ({kind}) {label} shift {shift} fp32: "
                f"max|grad - autograd of plain| {e:.3e} (d map and dbias)")

    for dtype in (bf16, fp32):
        check_window_bwd("swin-t s1 G2048 N49 H3 shared", 2048, 49, 3, 32, 1,
                         dtype, route=True)
        check_window_bwd("swin-t s1 G2048 N49 H3 nW'64", 2048, 49, 3, 32, 64,
                         dtype)
        check_window_bwd("swin-t s2 G512 N49 H6 nW'16", 512, 49, 6, 32, 16,
                         dtype)
        check_window_bwd("swin-t s3 G128 N49 H12 nW'4", 128, 49, 12, 32, 4,
                         dtype)
        check_window_bwd("swin-t s4 G32 N49 H24 shared", 32, 49, 24, 32, 1,
                         dtype)
        check_window_bwd("swinv2-t s1 G1568 N64 H3 nW'49", 1568, 64, 3, 32,
                         49, dtype)
        check_window_bwd("cifar G1024 N16 H3 nW'16", 1024, 16, 3, 32, 16,
                         dtype)
        check_window_bwd("no bias G33 N49 H3", 33, 49, 3, 32, 0, dtype)
        check_window_bwd("dh16 G8 N49 H2 shared", 8, 49, 2, 16, 1, dtype)
        check_window_bwd("dh64 G8 N49 H2 nW'4", 8, 49, 2, 64, 4, dtype)
        check_window_bwd("N100 G64 H2 dh64 nW'4", 64, 100, 2, 64, 4, dtype)
        check_window_bwd("N128 G64 H2 dh64 shared", 64, 128, 2, 64, 1, dtype)
    for shift in (3, 0):
        check_fused_grad("swin-t s1 B8 56x56 H3", 8, 56, 7, shift, 3, 32)
        check_fused_grad("swin-t s2 B8 28x28 H6", 8, 28, 7, shift, 6, 32)

    # the multi-tensor Adam kernel (row 15), one launch a step (one more
    # past each table of leaves), 3 steps against its plain version: a mixed
    # list (leaves on both sides of 65 536 elements, ragged last vectors, one
    # leaf not 16-byte aligned, more leaves than one launch's table) with
    # and without weight decay, and the parameter lists of Swin-T and
    # ViT-B/16
    def adam_leaves(shapes, seed, scale=1.0):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.empty(sh_, device=dev).normal_(generator=gen) * scale
                for sh_ in shapes]

    def check_adam(label, shapes, wd, misaligned=False):
        params = adam_leaves(shapes, 36)
        if misaligned:  # a leaf 4 bytes past a 16-byte boundary
            params.insert(1, adam_leaves([(70001,)], 37)[0][1:])
        mu = [torch.zeros_like(p_) for p_ in params]
        nu = [torch.zeros_like(p_) for p_ in params]
        oracle = [[t.clone() for t in group] for group in (params, mu, nu)]
        ptrs = [t.data_ptr() for group in (params, mu, nu) for t in group]
        bound = fadam.FusedAdamLeaves(params, mu, nu)
        per_step = -(-len(params) // fadam._TABLE_LEAVES)
        fa.reset_launch_counts()
        torch.cuda.synchronize()
        _build.reset_launched()
        for t_step in range(1, 4):
            grads = adam_leaves([p_.shape for p_ in params], 50 + t_step, 0.1)
            bound.update(grads, t_step, 1e-3, weight_decay=wd)
            sc = fadam.adam_scalars(t_step, 1e-3, weight_decay=wd)
            for leaf in zip(*oracle, grads):
                fadam.fused_adam_reference(*leaf, sc)
        torch.cuda.synchronize()
        logged = _build.launched().get("adam_multi_kernel", 0)
        e = max(max_err(a, r) for got, want in zip((params, mu, nu), oracle)
                for a, r in zip(got, want))
        log(f"fused_adam {label}, weight decay {wd}: 3 steps over "
            f"{len(params)} leaves ({sum(p_.numel() for p_ in params)} "
            f"elements) in {logged} launches of adam_multi_kernel, max|p, m, "
            f"v - plain| {e:.3e} (tol {ADAM_TOL}), in place")
        require(e <= ADAM_TOL, f"fused_adam {label} against its plain version")
        require(fa.LAUNCHES["fused_adam"] == logged == 3 * per_step,
                f"fused_adam {label}: {per_step} launch(es) a step")
        require(ptrs == [t.data_ptr() for group in (params, mu, nu)
                         for t in group],
                f"fused_adam {label} updates p, m and v in place")
        errs[("fused_adam", label, wd)] = e

    adam_shapes = ([(300, 300), (65536,), (65539,), (768, 3072), (1000,),
                    (7, 9), (65535,), (3,), (1,)]
                   + [(i % 37 + 1,) for i in range(320)])
    for wd in (0.0, 0.05):
        check_adam("mixed", adam_shapes, wd, misaligned=True)
    for preset, cls in (("swint_224_imagenet", SwinTransformer),
                        ("vitb16_224_imagenet", ViT)):
        shapes = [p_.shape for p_ in cls(**get_args(preset)).parameters()]
        check_adam(preset, shapes, 0.05)

    # the streaming forward (row 3): the DETR-R50 encoder and cross shapes
    # at the 896 x 1344 bucket, with the key masks the Joiner makes for the
    # four COCO sizes, and a bias-free, mask-free ViT-B shape at S 1297
    def coco_keep(sizes, hp=896, wp=1344, stride=16):
        """(B, Hp/16 · Wp/16) keep-mask of the C5 tokens, resized as the
        Joiner resizes the pixel mask."""
        pix = torch.ones(len(sizes), 1, hp, wp)
        for i, (h, w) in enumerate(sizes):
            pix[i, 0, :h, :w] = 0.0
        c5 = F.interpolate(pix, size=(hp // stride, wp // stride),
                           mode="nearest-exact")[:, 0]
        return (c5 == 0).reshape(len(sizes), -1).to(dev)

    det_keep = coco_keep(COCO_SIZES)
    log(f"DETR C5 key masks at 896 x 1344: unmasked tokens per image "
        f"{det_keep.sum(dim=1).tolist()} of {det_keep.shape[1]}")

    def planted_fault(plain, keep, b, sk):
        """max|plain(mask) - plain(mask with keys 640..703 hidden too)|: how
        far the output of a kernel that skipped live key tile 10 (which
        every mask here attends) lies from the plain version."""
        base = (torch.ones(b, sk, dtype=torch.bool, device=dev)
                if keep is None else keep)
        fault = base.clone()
        fault[:, 640:704] = False
        return max_err(plain(base)[0], plain(fault)[0])

    def check_large(label, b, h, sq, sk, d, kv_valid, keep, dtype):
        name = str(dtype).removeprefix("torch.")
        q = randn(70, b, h, sq, d, dtype=dtype)
        k = randn(71, b, h, sk, d, dtype=dtype)
        v = randn(72, b, h, sk, d, dtype=dtype)
        filled = torch.full_like(q, float("nan"))
        out, lse = fa.flash_attention_large_fwd(q, k, v, kv_mask=keep,
                                                kv_valid=kv_valid, out=filled)
        e = el = top = 0.0
        for i in range(b):  # the plain version one image at a time
            ref, ref_lse = fa.flash_attention_large_reference(
                q[i:i + 1], k[i:i + 1], v[i:i + 1], kv_valid=kv_valid,
                kv_mask=None if keep is None else keep[i:i + 1])
            e = max(e, max_err(out[i:i + 1], ref))
            el = max(el, max_err(lse[i:i + 1], ref_lse))
            top = max(top, ref.float().abs().max().item())
        again, _ = fa.flash_attention_large_fwd(q, k, v, kv_mask=keep,
                                                kv_valid=kv_valid)
        torch.cuda.synchronize()
        tol, fault = KERNEL_TOL[name], ""
        if dtype == bf16:  # image 0's plain output with tile 10 hidden
            tol = MASKED_FWD_TOL * max(1.0, top)
            ef = planted_fault(lambda m: fa.flash_attention_large_reference(
                q[:1], k[:1], v[:1], kv_valid=kv_valid, kv_mask=m[:1]),
                keep, b, sk)
            require(ef > tol, f"flash_attention_large {label}: one skipped "
                    f"live tile ({ef:.3e}) would pass the limit {tol:.3e}")
            fault = f", one live tile skipped {ef:.3e}"
        log(f"flash_attention_large {label} {name}: max|out-plain| {e:.3e} "
            f"(tol {tol:.3e}{fault}), max|lse-plain| {el:.3e}, NaN fill "
            "overwritten, rerun bit-equal")
        require(not bool(torch.isnan(out.float()).any())
                and e <= tol and el <= LSE_TOL
                and torch.equal(out, again),
                f"flash_attention_large {label} {name} against its plain "
                "version")
        errs[("large", label, name)] = e

    for dtype in (bf16, fp32):
        check_large("detr-r50 encoder B4 G32 S4704 D32", 4, 8, 4704, 4704,
                    32, None, det_keep, dtype)
        check_large("detr-r50 cross B4 Sq100 Sk4704 D32", 4, 8, 100, 4704,
                    32, None, det_keep, dtype)
        check_large("vitb16@576 B2 G24 S1297 D64 no mask", 2, 12, 1297, 1297,
                    64, None, None, dtype)
        check_large("kv_valid 4600/4704 + mask", 2, 8, 300, 4704, 32, 4600,
                    det_keep[:2], dtype)
    # T2T-ViT_t-14's token transformer (one head of 64 at 3136 tokens)
    check_large("t2t-vit_t-14 tokens B32 G32 S3136 D64 no mask", 32, 1, 3136,
                3136, 64, None, None, bf16)
    # an image whose keys are all masked: the uniform average over its keys
    keep = det_keep[:3, :300].clone()
    keep[1] = False
    qm, km, vm = (randn(73 + i, 3, 2, 300, 32, dtype=fp32) for i in range(3))
    got, _ = fa.flash_attention_large_fwd(qm, km, vm, kv_mask=keep)
    want = attn.mha_reference(qm, km, vm, mask=keep[:, None, None, :])
    e_full = max_err(got, want)
    log(f"flash_attention_large fully masked image: max|out - mha_reference| "
        f"{e_full:.3e}")
    require(e_full <= KERNEL_TOL["float32"],
            "a fully masked image averages its keys, as mha_reference does")

    # the small-S backward (row 4) against its plain version, the row-6
    # kernel at rate 0 and, in fp32, autograd of the plain forward; in bf16
    # on the tensor cores (by name in the launch log), held to MMA_GRAD_TOL
    # against the plain version, which rounds where the kernel does
    def check_small_bwd(label, b, h, sq, sk, d, kv_valid, dtype):
        name = str(dtype).removeprefix("torch.")
        q, do = (randn(75 + i, b, h, sq, d, dtype=dtype) for i in (0, 3))
        k, v = (randn(75 + i, b, h, sk, d, dtype=dtype) for i in (1, 2))
        out, lse = fa.flash_attention_reference(q, k, v, kv_valid=kv_valid)
        filled = tuple(torch.full_like(t, float("nan")) for t in (q, k, v))
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, kv_valid=kv_valid,
                                     grads=filled)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                kv_valid=kv_valid)
        row6 = fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                              dropout_rate=0.0, seed=None,
                                              kv_valid=kv_valid)
        tol = MMA_GRAD_TOL if dtype == bf16 else GRAD_TOL[name]
        e = rel = 0.0
        for n, g, w in zip("qkv", got, want):
            e_n = max_err(g, w)
            ref_max = max(1.0, w.float().abs().max().item())
            require(bool(torch.isfinite(g.float()).all())
                    and e_n <= tol * ref_max,
                    f"flash_attention_bwd {label} {name} d{n} against its "
                    f"plain version ({e_n:.3e} > {tol * ref_max:.3e})")
            e, rel = max(e, e_n), max(rel, e_n / ref_max)
        e6 = max(grad_err(f"flash_attention_bwd {label} {name} d{n} vs row 6",
                          g, w, name)[0] for n, g, w in zip("qkv", got, row6))
        extra = ""
        if dtype == fp32:
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            fa.flash_attention_reference(*leaves,
                                         kv_valid=kv_valid)[0].backward(do)
            ea = max(grad_err(f"flash_attention_bwd {label} d{n} vs autograd",
                              g, t.grad, name)[0]
                     for n, g, t in zip("qkv", got, leaves))
            extra = f", vs autograd of the plain forward {ea:.3e}"
        again = fa.flash_attention_bwd(q, k, v, out, lse, do,
                                       kv_valid=kv_valid)
        torch.cuda.synchronize()
        require(not any(bool(torch.isnan(g.float()).any()) for g in got)
                and all(torch.equal(a, g) for a, g in zip(again, got)),
                f"flash_attention_bwd {label} {name}: every element written, "
                "reruns bit-equal")
        require_route(f"flash_attention_bwd {label}", lambda: (
            fa.flash_attention_bwd(q, k, v, out, lse, do, kv_valid=kv_valid)),
            [("row 4", name)])
        log(f"flash_attention_bwd {label} {name}: max|grad-plain| {e:.3e}, "
            f"/ max(1, max|ref|) {rel:.3e} (tol {tol}), vs row 6 at rate 0 "
            f"{e6:.3e} (tol "
            f"{GRAD_TOL[name]} x max(1, max|ref|)){extra}, NaN fill "
            "overwritten, rerun bit-equal")
        errs[("small_bwd", label, name)] = e

    for dtype in (bf16, fp32):
        check_small_bwd("detr decoder self B2 G16 S100 D32", 2, 8, 100, 100,
                        32, None, dtype)
        check_small_bwd("vitb16@224 B32 G384 S197 D64", 32, 12, 197, 197, 64,
                        None, dtype)
        check_small_bwd("kv_valid 90/100", 2, 8, 100, 100, 32, 90, dtype)
        check_small_bwd("G24 S197 D64", 2, 12, 197, 197, 64, None, dtype)
        check_small_bwd("Sq70 Sk45 D16 kv_valid 40", 2, 3, 70, 45, 16, 40,
                        dtype)
        check_small_bwd("Sq33 Sk300 D32 kv_valid 290", 1, 2, 33, 300, 32, 290,
                        dtype)
    del qm, km, vm, got, want


    # rows 1-8 and 14: bf16 on the tensor-core kernels, fp32 on the
    # CUDA-core ones, by the kernels' names in the launch logs; then the
    # bf16 kernels at the paths' own shapes against their plain versions,
    # reruns bit-equal
    for dtype in (bf16, fp32):
        name = str(dtype).removeprefix("torch.")
        q, k, v, do = (randn(80 + i, 2, 4, 150, 64, dtype=dtype)
                       for i in range(4))
        out, lse = fa.flash_attention_reference(q, k, v)
        keep = coco_keep(COCO_SIZES[:2])[:, :150]
        qkv_r = randn(90, 2, 150, 3 * 4 * 64, dtype=dtype)
        p_out, p_lse = fa.packed_flash_attention_reference(qkv_r, 4)
        do_r = randn(93, 2, 150, 4 * 64, dtype=dtype)
        x_r = randn(91, 300, 64, dtype=dtype)
        ones = torch.ones(64, device=dev)
        w_r = randn(92, 64, 128, dtype=dtype)
        blk_r = block_inputs(randn, 94, 2, 150, 256, dtype)
        blk_t = (*blk_r[:3], blk_r[3].t().contiguous().t(), blk_r[4],
                 blk_r[5].t().contiguous().t(), blk_r[6])
        require_route(f"wrappers {name}", lambda: (
            fa.packed_flash_attention_fwd(qkv_r, 4),
            fa.packed_flash_attention_fwd(qkv_r, 4, dropout_rate=0.1, seed=5),
            fa.packed_flash_attention_bwd(qkv_r, do_r, p_out, p_lse, 4),
            fa.packed_flash_attention_bwd(qkv_r, do_r, p_out, p_lse, 4,
                                          dropout_rate=0.1, seed=5),
            fa.fused_attention_block_fwd(*blk_r, 4),
            fa.fused_attention_block_fwd(*blk_t, 4),
            fdense.ln_dense_fwd(x_r, ones, ones, w_r),
            fdense.ln_dense_fwd(x_r, ones, ones, w_r.t().contiguous().t()),
            fa.flash_attention_fwd(q, k, v),
            fa.flash_attention_large_fwd(q, k, v, kv_mask=keep),
            fa.flash_dropout_attention_fwd(q, k, v, dropout_rate=0.1, seed=5,
                                           key_mask=keep),
            fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                           dropout_rate=0.1, seed=5),
            fa.flash_attention_bwd(q, k, v, out, lse, do)),
            [("row 1", name), ("row 2", name), ("row 3", name),
             ("row 4", name), ("row 5", name), ("row 6", name),
             ("row 7", name), ("row 8", name), ("row 14", name)])

    # row 1 (bf16, tensor cores) at the ViT paths' shapes: ViT-B/16 @224 at
    # batch 32 (served at rate 0, trained at 0.1), T2T-ViT-14's 6 heads and
    # vit_tiny's 4, into NaN-filled outputs, reruns bit-equal; beside the
    # limit, a planted fault: the plain output of the next seed at rate 0.1
    # (another dropout mask), which must exceed it
    def check_packed_path(label, b, s, h, dh, rate):
        qkv = randn(93, b, s, 3 * h * dh, dtype=bf16)
        kw = dict(dropout_rate=rate, seed=60606 + (1 << 36))
        out, lse = fa.packed_flash_attention_fwd(
            qkv, h, **kw, **nan_filled(b, s, h, dh, bf16))
        ref, ref_lse = fa.packed_flash_attention_reference(qkv, h, **kw)
        again = fa.packed_flash_attention_fwd(qkv, h, **kw)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        tol = KERNEL_TOL["bfloat16"]
        fault = ""
        if rate > 0:
            ef = max_err(fa.packed_flash_attention_reference(
                qkv, h, dropout_rate=rate, seed=kw["seed"] + 1)[0], ref)
            require(ef > tol, f"packed {label}: the next seed's mask "
                    f"({ef:.3e}) would pass the limit {tol:.3e}")
            fault = f", the next seed's mask {ef:.3e}"
        require(bool(torch.isfinite(out.float()).all())
                and bool(torch.isfinite(lse).all()) and e <= tol
                and el <= LSE_TOL and torch.equal(again[0], out)
                and torch.equal(again[1], lse),
                f"packed {label} bf16 rate {rate} against its plain version, "
                "every element written, rerun bit-equal")
        log(f"packed {label} bf16 rate {rate} (tensor cores): max|out-plain| "
            f"{e:.3e} (tol {tol}{fault}), max|lse-plain| {el:.3e}, every "
            "element written, rerun bit-equal")
        errs[("packed_path", label, rate)] = e
        del qkv, out, lse, ref, ref_lse, again

    # row 7 (bf16, tensor cores) at the same shapes, from the forward's out
    # and lse, into a NaN-filled dqkv, reruns bit-equal; beside the limit, a
    # planted fault at rate 0.1: the plain gradients under the next seed's
    # mask, which must exceed it
    def check_packed_bwd_path(label, b, s, h, dh, rate):
        qkv = randn(96, b, s, 3 * h * dh, dtype=bf16)
        do = randn(97, b, s, h * dh, dtype=bf16)
        kw = dict(dropout_rate=rate, seed=70707 + (3 << 36))
        out, lse = fa.packed_flash_attention_fwd(qkv, h, **kw)
        got = fa.packed_flash_attention_bwd(
            qkv, do, out, lse, h, **kw,
            dqkv=torch.full_like(qkv, float("nan")))
        ref = fa.packed_flash_attention_bwd_reference(qkv, do, out, lse, h,
                                                      **kw)
        again = fa.packed_flash_attention_bwd(qkv, do, out, lse, h, **kw)
        torch.cuda.synchronize()
        tol = MMA_GRAD_TOL * max(1.0, ref.float().abs().max().item())
        e = max_err(got, ref)
        fault = ""
        if rate > 0:
            ef = max_err(fa.packed_flash_attention_bwd_reference(
                qkv, do, out, lse, h, dropout_rate=rate,
                seed=kw["seed"] + 1), ref)
            require(ef > tol, f"packed bwd {label}: the next seed's mask "
                    f"({ef:.3e}) would pass the limit {tol:.3e}")
            fault = f", the next seed's mask {ef:.3e}"
        require(not bool(torch.isnan(got.float()).any()) and e <= tol
                and torch.equal(again, got),
                f"packed bwd {label} bf16 rate {rate} against its plain "
                "version, every element written, rerun bit-equal")
        log(f"packed bwd {label} bf16 rate {rate} (tensor cores): "
            f"max|dqkv-plain| {e:.3e} (tol {tol:.3e}{fault}), every element "
            "written, rerun bit-equal")
        errs[("packed_bwd_path", label, rate)] = e
        del qkv, do, out, lse, got, ref, again

    for rate in (0.0, 0.1):
        for label, b_, s_, h_ in (("vitb16@224 B32 S197 H12 dh64", 32, 197, 12),
                                  ("t2t-vit-14 B32 S197 H6 dh64", 32, 197, 6),
                                  ("vit_tiny B64 S65 H4 dh64", 64, 65, 4)):
            check_packed_path(label, b_, s_, h_, 64, rate)
            check_packed_bwd_path(label, b_, s_, h_, 64, rate)

    def check_flash_path(label, b, h, s, d, bias_lead):
        q, k, v = (randn(84 + i, b, h, s, d, dtype=bf16) for i in range(3))
        bias = (None if bias_lead is None
                else randn(87, bias_lead, h, s, s, dtype=fp32))
        out, lse = fa.flash_attention_fwd(q, k, v, bias)
        ref, ref_lse = fa.flash_attention_reference(q, k, v, bias)
        again = fa.flash_attention_fwd(q, k, v, bias)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        require(bool(torch.isfinite(out.float()).all())
                and e <= KERNEL_TOL["bfloat16"] and el <= LSE_TOL
                and torch.equal(again[0], out) and torch.equal(again[1], lse),
                f"split {label} bf16 against its plain version, rerun "
                "bit-equal")
        log(f"split {label} bf16 (tensor cores): max|out-plain| {e:.3e} "
            f"(tol {KERNEL_TOL['bfloat16']}), max|lse-plain| {el:.3e}, "
            "rerun bit-equal")
        errs[("flash_path", label)] = e

    def check_drop_path(label, b, h, sq, sk, d, key_mask, rate):
        q, k, v, do = (randn(88 + i, b, h, n, d, dtype=bf16)
                       for i, n in enumerate((sq, sk, sk, sq)))
        kw = dict(dropout_rate=rate, seed=4321 + (11 << 34),
                  key_mask=key_mask)
        out, lse = fa.flash_dropout_attention_reference(q, k, v, **kw)
        got = fa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
        want = fa.flash_dropout_attention_bwd_reference(q, k, v, do, out,
                                                        lse, **kw)
        again = fa.flash_dropout_attention_bwd(q, k, v, do, out, lse, **kw)
        torch.cuda.synchronize()
        e = 0.0
        for n, g, w in zip("qkv", got, want):
            scale_ = max(1.0, w.float().abs().max().item())
            e = max(e, max_err(g, w) / scale_)
            require(bool(torch.isfinite(g.float()).all())
                    and max_err(g, w) <= MMA_GRAD_TOL * scale_,
                    f"dropout bwd {label} bf16 d{n} against its plain version")
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"dropout bwd {label} bf16: reruns bit-equal")
        log(f"dropout bwd {label} bf16 rate {rate} (tensor cores, "
            f"{fa.dkv_chunks(b * h, sq, sk)} dk/dv chunks): max|grad-plain| "
            f"/ max(1, max|ref|) {e:.3e} (tol {MMA_GRAD_TOL}), rerun bit-equal")
        errs[("drop_path", label)] = e
        del q, k, v, do, out, lse, got, want, again

    check_flash_path("detr decoder self B4 G32 S100 D32", 4, 8, 100, 32, None)
    check_flash_path("detr decoder self B4 G32 S100 D32 + bias", 4, 8, 100,
                     32, 1)
    check_drop_path("detr encoder B2 G16 S4704 D32 + COCO key mask", 2, 8,
                    4704, 4704, 32, coco_keep(COCO_SIZES[:2]), 0.1)
    check_drop_path("pvt stage 1 B32 G32 Sq3136 Sk49 D64", 32, 1, 3136, 49,
                    64, None, 0.0)
    check_drop_path("vitb16@512 G96 S1025 D64", 8, 12, 1025, 1025, 64, None,
                    0.1)

    # row 5 (bf16, tensor cores) at the DETR train step's shapes: the
    # encoder's self attention and the decoder's cross attention, batch 2,
    # with the key masks of two COCO images, rate 0.1
    def check_drop_fwd_path(label, b, h, sq, sk, d, key_mask, rate):
        q, k, v = (randn(95 + i, b, h, n, d, dtype=bf16)
                   for i, n in enumerate((sq, sk, sk)))
        kw = dict(dropout_rate=rate, seed=8765 + (13 << 34),
                  key_mask=key_mask)
        out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
        ref, ref_lse = fa.flash_dropout_attention_reference(q, k, v, **kw)
        again = fa.flash_dropout_attention_fwd(q, k, v, **kw)
        torch.cuda.synchronize()
        e, el = max_err(out, ref), max_err(lse, ref_lse)
        tol = MASKED_FWD_TOL * max(1.0, ref.float().abs().max().item())
        kw.pop("key_mask")
        ef = planted_fault(lambda m: fa.flash_dropout_attention_reference(
            q[:1], k[:1], v[:1], key_mask=m[:1], **kw), key_mask, b, sk)
        require(ef > tol, f"dropout fwd {label}: one skipped live tile "
                f"({ef:.3e}) would pass the limit {tol:.3e}")
        require(bool(torch.isfinite(out.float()).all())
                and e <= tol and el <= LSE_TOL
                and torch.equal(again[0], out) and torch.equal(again[1], lse),
                f"dropout fwd {label} bf16 against its plain version, rerun "
                "bit-equal")
        log(f"dropout fwd {label} bf16 rate {rate} (tensor cores): "
            f"max|out-plain| {e:.3e} (tol {tol:.3e}, one live tile skipped "
            f"{ef:.3e}), max|lse-plain| {el:.3e}, rerun bit-equal")
        errs[("drop_fwd_path", label)] = e
        del q, k, v, out, lse, ref, ref_lse, again

    det_keep2 = coco_keep(COCO_SIZES[:2])
    check_drop_fwd_path("detr encoder B2 G16 S4704 D32 + COCO key mask", 2,
                        8, 4704, 4704, 32, det_keep2, 0.1)
    check_drop_fwd_path("detr cross B2 G16 Sq100 Sk4704 D32 + COCO key mask",
                        2, 8, 100, 4704, 32, det_keep2, 0.1)

    # the skipped tiles of rows 3 and 5 (bf16): one image whose keys are
    # hidden from a 64-key boundary n on gives out and lse bit-equal to the
    # same call on K/V truncated to n keys, with no mask
    n_cut = 64 * 50
    qt, kt, vt = (randn(98 + i, 1, 8, s_, 32, dtype=bf16)
                  for i, s_ in enumerate((1000, 4704, 4704)))
    cut = (torch.arange(4704, device=dev) < n_cut)[None]
    short = (kt[:, :, :n_cut].contiguous(), vt[:, :, :n_cut].contiguous())
    for row, lib, fn, kw, mask_kw in (
            ("row 3", "flash_attention_large", fa.flash_attention_large_fwd,
             {}, "kv_mask"),
            ("row 5", "dropout_attention", fa.flash_dropout_attention_fwd,
             dict(dropout_rate=0.1, seed=77 + (2 << 40)), "key_mask")):
        fa.masked_tile_counts(lib)  # zeroes the kernel's counters
        got = fn(qt, kt, vt, **kw, **{mask_kw: cut})
        walked, held = fa.masked_tile_counts(lib)
        want = fn(qt, *short, **kw)
        torch.cuda.synchronize()
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"{row} bf16: keys hidden from {n_cut} on give the bits of "
                f"the call on K/V truncated to {n_cut}")
        require(held > 0 and walked * 74 == held * (n_cut // 64),
                f"{row} bf16: the kernel walked {walked} of {held} key "
                f"tiles, not {n_cut // 64} of every 74")
        log(f"{row} bf16, keys hidden from {n_cut} of 4704 on (G 8, Sq "
            f"1000, D 32): out and lse bit-equal to the call on K/V "
            f"truncated to {n_cut} keys; the kernel walked {walked} of "
            f"{held} key tiles ({n_cut // 64} of 74 a block)")
    del qt, kt, vt, short

    # the fused LayerNorm + Dense (row 14) at benchmarks/ln_fused.py's ViT-B
    # shapes (S 197, D 768, batch 32: R 6304) in its two forms, a ragged R
    # without a bias, and gelu_erf in fp32; the fused attention sub-block
    # (row 8) at ViT-B/16, DeiT-B (S 198), T2T-ViT-14 (H 6) and bucket 1;
    # into NaN-filled outputs, twice for equal bits
    def dense_inputs(seed, rows, d, n, dtype, with_bias=True):
        x = randn(seed, rows, d, dtype=dtype)
        g = (1 + 0.1 * randn(seed + 1, d, dtype=fp32))
        b = 0.1 * randn(seed + 2, d, dtype=fp32)
        w = (randn(seed + 3, d, n, dtype=fp32) / d ** 0.5).to(dtype)
        bias = 0.1 * randn(seed + 4, n, dtype=fp32) if with_bias else None
        return x, g, b, w, bias

    def check_ln_dense(label, rows, d, n, activation, with_bias, dtype):
        """Row 14 into a NaN-filled output against its plain version, a
        rerun and torch's (out, in) weight layout bit-equal to it; beside
        the limit a planted fault, the plain output with k 368 .. 383 (one
        16-wide slice) left out of the product, which must exceed it."""
        name = str(dtype).removeprefix("torch.")
        args = dense_inputs(100, rows, d, n, dtype, with_bias)
        kw = dict(activation=activation)
        route = fdense.ln_dense_route(dtype, d, n, *args[3].stride())
        out = fdense.ln_dense_fwd(*args, **kw, out=torch.full(
            (rows, n), float("nan"), dtype=dtype, device=dev))
        want = fdense.ln_dense_reference(*args, **kw)
        again = fdense.ln_dense_fwd(*args, **kw)
        x, g, b, w, bias = args
        out_in = fdense.ln_dense_fwd(x, g, b, w.t().contiguous().t(), bias,
                                     **kw)
        cut = w.clone()
        cut[368:384] = 0
        e_fault = max_err(fdense.ln_dense_reference(x, g, b, cut, bias, **kw),
                          want)
        torch.cuda.synchronize()
        e = max_err(out, want)
        tol = KERNEL_TOL[name] * max(1.0, want.float().abs().max().item())
        errs[("ln_dense", label, name)] = e
        log(f"ln_dense {label} {name} ({route}): max|out-plain| {e:.3e} "
            f"(tol {tol:.3e}, k 368..383 left out {e_fault:.3e}), every "
            "element written, rerun and (out, in) weight bit-equal")
        require(e_fault > tol, f"ln_dense {label} {name}: a 16-wide k slice "
                f"left out ({e_fault:.3e}) would pass the limit {tol:.3e}")
        require(not bool(torch.isnan(out.float()).any())
                and torch.equal(again, out) and torch.equal(out_in, out)
                and e <= tol,
                f"ln_dense {label} {name}: every element written, reruns "
                "and the (out, in) layout bit-equal, within tolerance of the "
                "plain version")

    for dtype in (bf16, fp32):
        check_ln_dense("[ln_1 + QKV] R6304 D768 N2304", 6304, 768, 2304, None,
                       True, dtype)
        check_ln_dense("[ln_2 + fc1 + GELU] R6304 D768 N3072", 6304, 768,
                       3072, "gelu_tanh", True, dtype)
        check_ln_dense("ragged R6301 N2304 no bias", 6301, 768, 2304, None,
                       False, dtype)
        check_ln_dense("ragged R6301 N2312 no bias", 6301, 768, 2312, None,
                       False, dtype)
        check_ln_dense("gelu_erf R6304 N3072", 6304, 768, 3072, "gelu_erf",
                       True, dtype)

    def check_block(label, b, s, h, dh, dtype):
        """Row 8 into a NaN-filled output against its plain version, a rerun
        and torch's (out, in) weight layout bit-equal to it; beside the limit
        a planted fault, the plain output with k 368 .. 383 of Wout (one
        16-wide slice of the out-projection) left out, which must exceed
        it."""
        name = str(dtype).removeprefix("torch.")
        args = block_inputs(randn, 110, b, s, h * dh, dtype)
        x, g, be, wqkv, bqkv, wout, bout = args
        route = fa.fused_block_route(dtype, h * dh, h,
                                     (*wqkv.stride(), *wout.stride()))
        out = fa.fused_attention_block_fwd(
            *args, h, out=torch.full_like(args[0], float("nan")))
        want = fa.fused_attention_block_reference(*args, h)
        again = fa.fused_attention_block_fwd(*args, h)
        out_in = fa.fused_attention_block_fwd(
            x, g, be, wqkv.t().contiguous().t(), bqkv,
            wout.t().contiguous().t(), bout, h)
        cut = wout.clone()
        cut[368:384] = 0
        e_fault = max_err(fa.fused_attention_block_reference(
            x, g, be, wqkv, bqkv, cut, bout, h), want)
        torch.cuda.synchronize()
        e = max_err(out, want)
        tol = KERNEL_TOL[name] * max(1.0, want.float().abs().max().item())
        errs[("fused_block", label, name)] = e
        log(f"fused_attention_block {label} {name} ({route}): max|out-plain| "
            f"{e:.3e} (tol {tol:.3e}, k 368..383 of Wout left out "
            f"{e_fault:.3e}), every element written, rerun and (out, in) "
            "weights bit-equal")
        require(e_fault > tol, f"fused_attention_block {label} {name}: a "
                f"16-wide k slice of Wout left out ({e_fault:.3e}) would pass "
                f"the limit {tol:.3e}")
        require(not bool(torch.isnan(out.float()).any())
                and torch.equal(again, out) and torch.equal(out_in, out)
                and e <= tol,
                f"fused_attention_block {label} {name}: every element "
                "written, reruns and the (out, in) layout bit-equal, within "
                "tolerance of the plain version")
        if route == "tensor_cores":
            # the phases as ordered launches of their own read what an
            # earlier phase wrote only across a kernel boundary
            require(torch.equal(fa._measure_fused_block_phases(
                        *args, h, (0, 1, 2, 3)), out),
                    f"fused_attention_block {label}: the one cooperative "
                    "launch bit-equal to its four phases launched in order")

    for dtype in (bf16, fp32):
        check_block("vitb16 B32 S197 H12", 32, 197, 12, 64, dtype)
        check_block("deit-b B32 S198 H12", 32, 198, 12, 64, dtype)
        check_block("t2t-vit-14 B32 S197 H6", 32, 197, 6, 64, dtype)
        check_block("vitb16 B1 S197 H12", 1, 197, 12, 64, dtype)

    # gradients through both autograd functions against autograd of their
    # plain versions, fp32
    def autograd_err(label, fn, ref, leaves, **kw):
        grads = []
        for f in (fn, ref):
            ts = [t.detach().clone().requires_grad_() for t in leaves]
            out = f(*ts, **kw)
            out.backward(randn(120, *out.shape, dtype=fp32))
            grads.append([t.grad for t in ts])
        e = max(grad_err(f"{label} d{i}", g, r, "float32")[0]
                for i, (g, r) in enumerate(zip(*grads)))
        log(f"{label} gradients vs autograd of the plain version: {e:.3e}")
        return e

    errs[("ln_dense", "grad")] = autograd_err(
        "ln_dense B4 S197 D768 N3072 gelu_tanh", fdense.ln_dense,
        fdense.ln_dense_reference,
        list(dense_inputs(121, 4 * 197, 768, 3072, fp32)),
        activation="gelu_tanh")
    errs[("fused_block", "grad")] = autograd_err(
        "fused_attention_block B2 S197 H12", fa.fused_attention_block,
        fa.fused_attention_block_reference,
        list(block_inputs(randn, 130, 2, 197, 768, fp32)), heads=12)

    # ---- 3. main path: ViT-B/16 @224 served in bf16 ----------------------
    args = get_args("vitb16_224_imagenet")
    shape = (args["image_size"], args["image_size"], 3)
    model = ViT(**args, dtype="bfloat16")
    weights = seeded_state_dict(model, seed=0)
    model.load_state_dict(weights)
    rng = np.random.RandomState(1)
    images = rng.standard_normal((40, *shape)).astype(np.float32)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving.export_classifier(model, shape, tmp, buckets=(1, 8, 32),
                                  dtype=fp32)
        del model
        clf = serving.load_classifier(tmp)
    forwards = [0]
    clf.model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    clf.warmup()
    served = {n: clf.predict(images[:n]) for n in (1, 5, 8, 40)}
    mb = serving.Microbatcher(clf, max_wait_ms=5.0)
    mb_out = [None] * 16
    threads = [threading.Thread(
        target=lambda i=i: mb_out.__setitem__(i, mb.submit(images[i])))
        for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    require(not any(t.is_alive() for t in threads), "microbatcher answers")
    mb.close()
    torch.cuda.synchronize()
    main_launches = dict(fa.LAUNCHES)
    main_forwards = forwards[0]
    log(f"main path: {main_forwards} forwards in "
        f"{time.perf_counter() - t0:.2f} s, launches {main_launches}")
    require(main_forwards > 0 and main_launches["packed_attention"]
            == 12 * main_forwards, "packed kernel: 12 launches per forward")
    require_route("ViT-B/16 bf16 served forward",
                  lambda: clf.predict(images[:8]), [("row 1", "bfloat16")])

    for n, out in served.items():
        require(out.shape == (n, args["num_classes"])
                and bool(torch.isfinite(out.float()).all()),
                f"predict({n}) gives finite ({n}, classes) logits")
    require(all(o is not None and o.shape == (args["num_classes"],)
                and np.isfinite(o).all() for o in mb_out),
            "every microbatched request gets finite logits")
    e_mb = float(np.abs(np.stack(mb_out)
                        - served[40][:16].float().cpu().numpy()).max())
    log(f"microbatcher vs predict(40): max|diff| {e_mb:.3e}")

    # the same weights on the CPU through the plain versions, fp32
    cpu_model = ViT(**args, device="cpu")
    cpu_model.load_state_dict(weights)
    ref = cpu_model(torch.from_numpy(images[:2])).float()
    ref_scale = ref.abs().max().item()
    e_bf16 = max_err(served[5][:2].cpu(), ref)
    log(f"bf16 served logits vs CPU fp32: max|diff| {e_bf16:.3e} "
        f"(max|ref| {ref_scale:.3f}, tol {LOGIT_TOL_BF16_REL} x max|ref|)")
    require(e_bf16 <= LOGIT_TOL_BF16_REL * ref_scale
            and e_mb <= LOGIT_TOL_BF16_REL * ref_scale,
            "bf16 served logits against the CPU run")

    model32 = ViT(**args)
    model32.load_state_dict(weights)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        serving.export_classifier(model32, shape, tmp, buckets=(2,),
                                  dtype=fp32)
        del model32
        clf32 = serving.load_classifier(tmp)
    e_fp32 = max_err(clf32.predict(images[:2]).cpu(), ref)
    log(f"fp32 served logits vs CPU fp32: max|diff| {e_fp32:.3e} "
        f"(tol {LOGIT_TOL_FP32})")
    require(e_fp32 <= LOGIT_TOL_FP32, "fp32 served logits against the CPU run")
    del clf32

    # ---- 3b. int8 serving: ViT-B/16 @224 quantized to w8a8 ----------------
    # quantize_classifier → export_classifier → load_classifier (CUDA) →
    # predict at buckets 1, 8 and 32, with USE_FUSED_BLOCK on: quant8 keeps
    # row 8 off (it reads float weights), so each forward launches row 1 in
    # every layer and nothing else, and runs 48 int8 products (qkv, out, fc1,
    # fc2 of 12 layers; torch._int_mm, the port of JAX's lax.dot_general)
    from vision_transformers_tpu_torch.ops import quant

    fmodel = ViT(**args, dtype="bfloat16")
    fmodel.load_state_dict(weights)  # the float model first, then int8
    qmodel = serving.quantize_classifier(fmodel)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        manifest = serving.export_classifier(qmodel, shape, tmp,
                                             buckets=(1, 8, 32), dtype=fp32)
        del qmodel
        clf8 = serving.load_classifier(tmp)
        clf8_cpu = serving.load_classifier(tmp, device="cpu")
    fc1 = clf8.model.encoder.encoder_layer_0.mlp.fc1
    require(manifest["model_kwargs"].get("quant8") is True
            and fc1.kernel_q.dtype == torch.int8 and fc1.kernel_q.is_cuda,
            "the int8 artifact: quant8 in its kwargs, int8 weights on the "
            "card")
    q_forwards = [0]
    clf8.model.register_forward_hook(
        lambda *_: q_forwards.__setitem__(0, q_forwards[0] + 1))
    clf8.warmup()
    vv.USE_FUSED_BLOCK = True
    try:
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        quant.reset_product_counts()
        _build.reset_launched()
        q_forwards[0] = 0
        served8 = {b: clf8.predict(images[:b]) for b in (1, 8, 32)}
        torch.cuda.synchronize()
    finally:
        vv.USE_FUSED_BLOCK = False
    int8_launches = dict(fa.LAUNCHES)
    int8_products = quant.PRODUCTS["int8_matmul"]
    int8_logged = _build.launched()
    n8 = q_forwards[0]
    log(f"int8 serving ViT-B/16 bf16 (USE_FUSED_BLOCK on): {n8} forwards, "
        f"launches { {k: v for k, v in int8_launches.items() if v} }, "
        f"{int8_products} int8 products, kernels by name {int8_logged}")
    row8_names = (ROUTE_NAMES[("row 8", "bfloat16")]
                  + ROUTE_NAMES[("row 8", "float32")])
    require(n8 == 3 and int8_launches["packed_attention"] == 12 * n8
            and sum(int8_launches.values()) == 12 * n8
            and int8_products == 48 * n8
            and all(int8_logged.get(k, 0) == 12 * n8
                    for k in ROUTE_NAMES[("row 1", "bfloat16")])
            and not any(k in int8_logged for k in row8_names),
            "int8 serving: per forward 12 row-1 launches (tensor cores), no "
            "row-8 launch and 48 int8 products")
    for b, out in served8.items():
        require(out.shape == (b, args["num_classes"])
                and bool(torch.isfinite(out.float()).all()),
                f"int8 predict({b}) gives finite ({b}, classes) logits")
    require(torch.equal(clf8.predict(images[:32]), served8[32])
            and torch.equal(clf8.predict(images[:8]), served8[8]),
            "int8 serving reruns bit-equal")
    # the same artifact on the CPU: the plain versions and the same int8
    # products (torch._int_mm on the CPU)
    cpu8 = clf8_cpu.predict(images[:8]).float()
    scale8 = cpu8.abs().max().item()
    e_cpu8 = max_err(served8[8].cpu(), cpu8)
    log(f"int8 served logits vs the same artifact on the CPU: max|diff| "
        f"{e_cpu8:.3e} (max|ref| {scale8:.3f}, tol {INT8_CPU_TOL_REL} x "
        "max|ref|)")
    require(e_cpu8 <= INT8_CPU_TOL_REL * scale8,
            "int8 served logits against the CPU run of the artifact")
    del clf8_cpu, cpu8
    with torch.inference_mode():
        x32 = torch.from_numpy(images[:32]).to(dev)
        f8 = clf8.model.forward_features(x32).float()
        f16 = fmodel.forward_features(x32).float()
        l16 = fmodel(x32).float()
    feat_rel = ((f8 - f16).norm() / f16.norm()).item()
    logit_rel = ((served8[32].float() - l16).norm() / l16.norm()).item()
    log(f"int8 vs float bf16 on the card, batch 32: relative feature error "
        f"{feat_rel:.4f} (tol {INT8_FEATURE_REL}), relative logit error "
        f"{logit_rel:.4f}")
    require(feat_rel < INT8_FEATURE_REL,
            "int8 features within 5% of the float bf16 model's")
    del f8, f16, l16, fmodel
    # int8_matmul on the card against the CPU, bit-equal (exact int32
    # products, the same fp32 steps), at 5 rows (padded to torch._int_mm's
    # 17 on CUDA) and at ViT-B's fc1 (6304 x 768 -> 3072); K and N off the
    # multiple of 8 (K 100, N 36) are zero-padded on both devices, bit-equal
    # too
    for rows in (5, 32 * 197):
        xm = randn(130, rows, 768, dtype=bf16)
        wq, ws = quant.quantize_kernel(randn(131, 3072, 768, dtype=fp32))
        bm = randn(132, 3072, dtype=fp32)
        got = quant.int8_matmul(xm, wq, ws, bm)
        want = quant.int8_matmul(xm.cpu(), wq.cpu(), ws.cpu(), bm.cpu())
        require(torch.equal(got.cpu(), want),
                f"int8_matmul at {rows} rows: the card bit-equal to the CPU")
    for rows in (5, 40):
        xk = randn(133, rows, 100, dtype=bf16)
        wk, sk_ = quant.quantize_kernel(randn(134, 36, 100, dtype=fp32))
        bk = randn(135, 36, dtype=fp32)
        got = quant.int8_matmul(xk, wk, sk_, bk)
        want = quant.int8_matmul(xk.cpu(), wk.cpu(), sk_.cpu(), bk.cpu())
        require(tuple(got.shape) == (rows, 36)
                and torch.equal(got.cpu(), want),
                f"int8_matmul at K 100, N 36, {rows} rows: the card "
                "bit-equal to the CPU")
    log("int8_matmul at K 100, N 36 (5 and 40 rows, zero-padded to "
        "multiples of 8): the card bit-equal to the CPU")
    del xk, wk, sk_, bk
    w16 = randn(131, 3072, 768, dtype=bf16)
    xq = quant.dynamic_quant_rows(xm)[0]
    mm_ms = queued_ms([lambda: quant.int8_matmul(xm, wq, ws, bm),
                       lambda: torch._int_mm(xq, wq.t()),
                       lambda: F.linear(xm, w16, bm.to(bf16))])
    log(f"ViT-B fc1 (6304 x 768 -> 3072) device time: int8_matmul "
        f"{mm_ms[0]:.4f} ms (quantize rows, torch._int_mm, rescale, bias), "
        f"torch._int_mm alone {mm_ms[1]:.4f} ms, bf16 F.linear "
        f"{mm_ms[2]:.4f} ms")
    del xm, xq, wq, ws, bm, got, want, w16

    def serve_ms(c, b, iters=10):
        """ms per request at bucket b, host numpy in and logits out."""
        x = images[:b]
        for _ in range(2):
            c.predict(x).float().cpu()
        t0 = time.perf_counter()
        for _ in range(iters):
            c.predict(x).float().cpu()
        return (time.perf_counter() - t0) / iters * 1e3

    int8_serving = {}
    for b in (1, 8, 32):
        # bf16, int8, int8, bf16: one process, in turns
        t = [serve_ms(c, b) for c in (clf, clf8, clf8, clf)]
        int8_serving[b] = dict(bf16_ms=(t[0] + t[3]) / 2,
                               int8_ms=(t[1] + t[2]) / 2)
        log(f"serving ViT-B/16 bucket {b}: int8 {t[1]:.3f} / {t[2]:.3f} ms, "
            f"bf16 {t[0]:.3f} / {t[3]:.3f} ms per request")
    log(f"serving ViT-B/16 bucket 32: int8 "
        f"{32e3 / int8_serving[32]['int8_ms']:.1f} images/s, bf16 "
        f"{32e3 / int8_serving[32]['bf16_ms']:.1f} images/s")
    with torch.inference_mode():
        fwd8 = [cuda_ms(lambda: c.model(x32), iters=10) for c in (clf8, clf)]
    log(f"ViT-B/16 forward at batch 32, device time: int8 {fwd8[0]:.3f} ms, "
        f"bf16 {fwd8[1]:.3f} ms")
    for label, c in (("int8", clf8), ("bf16", clf)):
        wall, busy, count, top = device_profile(
            lambda: c.predict(images[:32]).float().cpu(), top=8)
        if busy is None:
            log(f"profile {label} bucket 32: the profiler saw no device "
                "activity")
            continue
        int8_serving[32][f"{label}_idle"] = 1 - busy / wall
        log(f"profile {label} bucket 32: wall {wall:.3f} ms (profiler on), "
            f"device busy {busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in top:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")
    del clf8, x32

    # ---- 4. split-head path: S = 1025 -----------------------------------
    wide = dict(args, image_size=512, num_layers=2)
    split_models = {d: ViT(**wide, dtype=d) for d in ("float32", "bfloat16")}
    split_weights = seeded_state_dict(split_models["float32"], seed=2)
    for m in split_models.values():
        m.load_state_dict(split_weights)
    x512 = torch.from_numpy(
        rng.standard_normal((2, 512, 512, 3)).astype(np.float32))
    fa.reset_launch_counts()
    with torch.inference_mode():
        split_out = {d: m(x512.to(dev)) for d, m in split_models.items()}
    torch.cuda.synchronize()
    split_launches = dict(fa.LAUNCHES)
    log(f"split-head path (2 layers @512, S=1025, fp32 + bf16): launches "
        f"{split_launches}")
    require(split_launches["flash_attention"] == 2 * 2
            and split_launches["packed_attention"] == 0,
            "split-head kernel: 1 launch per layer per forward at S=1025")
    for d_, m in split_models.items():
        with torch.inference_mode():
            require_route(f"split-head path forward {d_}",
                          lambda: m(x512.to(dev)), [("row 2", d_)])
    cpu_wide = ViT(**wide, device="cpu")
    cpu_wide.load_state_dict(split_weights)
    ref512 = cpu_wide(x512).float()
    e32 = max_err(split_out["float32"].cpu(), ref512)
    e16 = max_err(split_out["bfloat16"].cpu(), ref512)
    scale512 = ref512.abs().max().item()
    log(f"split-head logits vs CPU fp32: fp32 {e32:.3e} (tol "
        f"{LOGIT_TOL_FP32}), bf16 {e16:.3e} (max|ref| {scale512:.3f})")
    require(e32 <= LOGIT_TOL_FP32 and e16 <= LOGIT_TOL_BF16_REL * scale512,
            "S=1025 logits against the CPU run")
    del split_models, cpu_wide, cpu_model

    # ---- 5. window path: Swin-T and SwinV2-T served in bf16 ---------------
    swin, swin_weights = {}, {}
    for preset, cls in (("swint_224_imagenet", SwinTransformer),
                        ("swinv2t_224_imagenet", SwinTransformerV2)):
        sargs = get_args(preset)
        sshape = (sargs["image_size"], sargs["image_size"], 3)
        smodel = cls(**sargs, dtype="bfloat16")
        sweights = seeded_state_dict(smodel, seed=5)
        smodel.load_state_dict(sweights)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(smodel, sshape, tmp, buckets=(1, 8, 32),
                                      dtype=fp32)
            del smodel
            sclf = serving.load_classifier(tmp)
        require(type(sclf.model) is cls, f"{preset}: the artifact rebuilds "
                f"a {cls.__name__}")
        forwards = [0]
        sclf.model.register_forward_hook(
            lambda *_, forwards=forwards: forwards.__setitem__(
                0, forwards[0] + 1))
        want = SWIN_LAUNCHES_PER_FORWARD[preset]

        def launches_match(n_forwards):
            return all(v == n_forwards * want.get(k, 0)
                       for k, v in fa.LAUNCHES.items())

        fa.reset_launch_counts()
        windows.ROUTE_LOG = []
        t0 = time.perf_counter()
        sclf.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        require(forwards[0] == 3 and launches_match(3),
                f"{preset}: warmup runs each bucket once through "
                f"{want} and no other attention kernel; got {fa.LAUNCHES}")
        routes = windows.ROUTE_LOG[:12]
        require(windows.ROUTE_LOG == routes * 3,
                f"{preset}: the same 12 routes at every bucket")
        windows.ROUTE_LOG = None
        total = dict(fa.LAUNCHES)
        sserved = {}
        for n in (1, 8, 32, 40):  # 40 = a full bucket of 32 + 8
            fa.reset_launch_counts()
            f0 = forwards[0]
            sserved[n] = sclf.predict(images[:n])
            torch.cuda.synchronize()
            require(forwards[0] - f0 == (2 if n == 40 else 1)
                    and launches_match(forwards[0] - f0),
                    f"{preset}: predict({n}) launches {want} per forward and "
                    f"no other attention kernel; got {fa.LAUNCHES}")
            require(sserved[n].shape == (n, sargs["num_classes"])
                    and bool(torch.isfinite(sserved[n].float()).all()),
                    f"{preset}: predict({n}) gives finite ({n}, classes) "
                    "logits")
            total = {k: v + fa.LAUNCHES[k] for k, v in total.items()}
        log(f"{preset}: {forwards[0]} forwards (warmup {warm_s:.2f} s), "
            f"routes per forward {routes}, launches "
            f"{ {k: v for k, v in total.items() if v} }")
        require_route(f"{preset} bf16 served forward, bucket 32",
                      lambda: sclf.predict(images[:32]), window_routes(want))

        # the same weights on the CPU through the plain versions, fp32
        cpu_swin = cls(**sargs, device="cpu")
        cpu_swin.load_state_dict(sweights)
        with torch.no_grad():
            sref = cpu_swin(torch.from_numpy(images[:2])).float()
        del cpu_swin
        sscale = sref.abs().max().item()
        e16 = max(max_err(sserved[n][:k].cpu(), sref[:k])
                  for n, k in ((1, 1), (8, 2), (32, 2), (40, 2)))
        swin32 = cls(**sargs)
        swin32.load_state_dict(sweights)
        with torch.inference_mode():
            e32 = max_err(swin32(torch.from_numpy(images[:2]).to(dev)).cpu(),
                          sref)
        del swin32
        log(f"{preset} logits vs CPU fp32: fp32 model on the card {e32:.3e} "
            f"(tol {SWIN_LOGIT_TOL_FP32}), bf16 served {e16:.3e} (max|ref| "
            f"{sscale:.3f}, tol {LOGIT_TOL_BF16_REL} x max|ref|)")
        require(e32 <= SWIN_LOGIT_TOL_FP32
                and e16 <= LOGIT_TOL_BF16_REL * sscale,
                f"{preset}: logits against the CPU run of the same weights")
        swin[preset] = (sclf, total, forwards[0])
        swin_weights[preset] = sweights

    # ---- 6. training paths ------------------------------------------------
    # 6a. train_model on vit_tiny_cifar100: full size, fp32, dropout 0.1
    tiny_args = get_args("vit_tiny_cifar100")
    tiny = ViT(**tiny_args)
    train_loader = ColorClassLoader(1000, 64, seed=0)   # 15 x 64 + 40
    test_loader = ColorClassLoader(200, 64, seed=1)
    val_loader = ColorClassLoader(100, 64, seed=2)
    steps_per_epoch, epochs = len(train_loader), 3
    eval_forwards = epochs * (len(test_loader) + len(val_loader))
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    history = tiny.train_model(tiny, train_loader, test_loader, epochs,
                               val_loader, lr=1e-3, verbose=False)
    torch.cuda.synchronize()
    tiny_s = time.perf_counter() - t0
    tiny_launches = dict(fa.LAUNCHES)
    train_steps = history["final_state"].step
    log(f"train_model vit_tiny_cifar100, {epochs} epochs x {steps_per_epoch} "
        f"steps of 64 in {tiny_s:.2f} s: train loss "
        f"{[round(x, 4) for x in history['train_loss']]}, train acc "
        f"{[round(x, 4) for x in history['train_accuracy']]}, test acc "
        f"{[round(x, 4) for x in history['test_accuracy']]}, launches "
        f"{tiny_launches}")
    keys = {f"{split}_{m}" for split in ("train", "val", "test")
            for m in ("loss", "accuracy")}
    require(keys <= set(history) and all(
        len(history[k]) == epochs and np.isfinite(history[k]).all()
        for k in keys), "history has the six keys, finite, one value per epoch")
    require(history["train_loss"][-1] < history["train_loss"][0]
            and history["train_accuracy"][-1] > 0.3,
            "vit_tiny: train loss falls and train accuracy passes 0.3")
    require(train_steps == epochs * steps_per_epoch
            and tiny_launches["packed_attention_bwd"]
            == tiny_args["num_layers"] * train_steps
            and tiny_launches["packed_attention"]
            == tiny_args["num_layers"] * (train_steps + eval_forwards),
            "vit_tiny: 7 packed forward and 7 packed backward launches per "
            "train step (and 7 forward launches per eval batch)")
    del tiny

    # 6b. ViT-B/16 @224, bf16, batch 32, attention dropout 0.1: 3 Adam steps
    vitb_args = dict(args, attention_dropout=0.1)
    vitb = ViT(**vitb_args, dtype="bfloat16")
    vitb.load_state_dict(weights)
    state = trainer.make_train_state(vitb, lr=1e-4)
    step = trainer.train_step_fn(vitb)
    xb = torch.from_numpy(images[:32]).to(dev)
    yb = torch.from_numpy(rng.randint(0, args["num_classes"], 32)).to(dev)
    wb = torch.ones(32, device=dev)
    vitb.dropout_generator.manual_seed(0)
    fa.reset_launch_counts()
    vitb_losses = []
    for _ in range(3):
        state, loss_n, _, n = step(state, xb, yb, wb)
        vitb_losses.append((loss_n / n).item())
    vitb_launches = dict(fa.LAUNCHES)
    log(f"ViT-B/16 bf16 batch 32 attention_dropout 0.1, 3 Adam steps on one "
        f"batch: loss {[round(x, 4) for x in vitb_losses]}, launches "
        f"{vitb_launches}")
    require(np.isfinite(vitb_losses).all()
            and vitb_losses[-1] < vitb_losses[0],
            "ViT-B: finite falling loss over 3 steps on one batch")
    require(vitb_launches["packed_attention"] == 12 * 3
            and vitb_launches["packed_attention_bwd"] == 12 * 3,
            "ViT-B: 12 packed forward and 12 packed backward launches per step")

    # the step's split, CUDA events around the three parts of train_step_fn
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(5)]
    vitb.train()
    t0 = time.perf_counter()
    for e0, e1, e2, e3 in ev:
        e0.record()
        loss = trainer.cross_entropy_with_weights(vitb(xb), yb, wb)
        e1.record()
        state.optimizer.zero_grad()
        loss.backward()
        e2.record()
        state.optimizer.step()
        e3.record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / len(ev) * 1e3
    fwd_t, bwd_t, opt_t = (float(np.mean([e[i].elapsed_time(e[i + 1])
                                          for e in ev])) for i in range(3))
    log(f"ViT-B/16 bf16 train step, batch 32: {step_ms:.3f} ms per step by the "
        f"host clock ({32 / step_ms * 1e3:.1f} images/s); device time forward "
        f"{fwd_t:.3f} ms, backward {bwd_t:.3f} ms, optimizer {opt_t:.3f} ms")
    train_fwd_ms, train_bwd_ms = fwd_t, bwd_t

    def one_step():
        loss = trainer.cross_entropy_with_weights(vitb(xb), yb, wb)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()

    require_route("ViT-B/16 bf16 train step", one_step,
                  [("row 1", "bfloat16"), ("row 7", "bfloat16")])

    # the step's row 7 (the tensor-core backward) fed the tensor-core
    # forward's out and lse on the first layer's projection of this batch,
    # at rate 0.1, against the plain backward on the same (out, lse): the
    # backward replays the forward's mask
    taps = []
    hook = vitb.encoder.encoder_layer_0.self_attention.qkv.register_forward_hook(
        lambda _m, _i, o: taps.append(o.detach()))
    with torch.no_grad():
        vitb(xb)
    hook.remove()
    qkv_t = taps[0]
    do_t = randn(94, *qkv_t.shape[:2], qkv_t.shape[-1] // 3, dtype=bf16)
    kw = dict(dropout_rate=0.1, seed=777 + (5 << 33))
    out_t, lse_t = fa.packed_flash_attention_fwd(qkv_t, 12, **kw)
    g_t = fa.packed_flash_attention_bwd(qkv_t, do_t, out_t, lse_t, 12, **kw)
    g_ref = fa.packed_flash_attention_bwd_reference(qkv_t, do_t, out_t, lse_t,
                                                    12, **kw)
    e_step = max_err(g_t, g_ref)
    tol = MMA_GRAD_TOL * max(1.0, g_ref.float().abs().max().item())
    require(bool(torch.isfinite(g_t.float()).all()) and e_step <= tol,
            f"ViT-B train step layer 0 packed bwd rate 0.1 against its plain "
            f"version ({e_step:.3e} > {tol:.3e})")
    log(f"ViT-B train step, layer 0's projection {tuple(qkv_t.shape)}: row 7 "
        f"(tensor cores) fed row 1's out and lse at rate 0.1, max|dqkv-plain| "
        f"{e_step:.3e} (tol {tol:.3e})")
    del taps, qkv_t, do_t, out_t, lse_t, g_t, g_ref

    wall, busy, count, top = device_profile(one_step, top=10)
    if busy is None:
        log("profile train step: the profiler saw no device activity")
    else:
        log(f"profile train step: wall {wall:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in top:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")
    del vitb, state, step, loss

    # 6b'. superleaf Adam (training/superleaf.py) on the same model and batch:
    # the master weights, mu and nu each one flat fp32 buffer, the forward on
    # views of it, the update one row-15 launch a step; each step's flat
    # buffers against fused_adam_reference applied to the same flat
    # gradient, and the parameters against make_optimizer(fused=True)
    # stepping the same weights under the same dropout seeds, bit-equal
    from vision_transformers_tpu_torch.training import superleaf as sl

    sleaf = ViT(**vitb_args, dtype="bfloat16")
    sleaf.load_state_dict(weights)
    per_leaf = ViT(**vitb_args, dtype="bfloat16")
    per_leaf.load_state_dict(weights)
    sstate, smeta = sl.init_state(dict(sleaf.named_parameters()))
    sstep = sl.superleaf_train_step_fn(sleaf, smeta, 1e-4)
    pstate = trainer.make_train_state(
        per_leaf, tx=make_optimizer("adam", 1e-4, fused=True))
    pstep = trainer.train_step_fn(per_leaf)
    sleaf.dropout_generator.manual_seed(0)
    per_leaf.dropout_generator.manual_seed(0)
    seen = []
    real_adam_flat = sl.adam_flat

    def spy_adam_flat(st, g, *a, **kw):
        """The step's own adam_flat, with its inputs kept for the check."""
        seen.append((st.flat.clone(), st.mu.clone(), st.nu.clone(),
                     g.clone(), st.step))
        return real_adam_flat(st, g, *a, **kw)

    sl_losses, sl_logged = [], []
    sl.adam_flat = spy_adam_flat
    try:
        fa.reset_launch_counts()
        for _ in range(3):
            torch.cuda.synchronize()
            _build.reset_launched()
            sstate, loss_n, _, n = sstep(sstate, xb, yb, wb)
            torch.cuda.synchronize()
            sl_logged.append(_build.launched().get("adam_multi_kernel", 0))
            sl_losses.append((loss_n / n).item())
            p0, m0, v0, g0, t_ = seen.pop()
            fadam.fused_adam_reference(p0, m0, v0, g0,
                                       fadam.adam_scalars(t_ + 1, 1e-4))
            require(torch.equal(p0, sstate.flat) and torch.equal(m0, sstate.mu)
                    and torch.equal(v0, sstate.nu),
                    f"superleaf step {t_ + 1}: the flat buffers bit-equal to "
                    "fused_adam_reference on the same flat gradient")
        sl_launches = dict(fa.LAUNCHES)
    finally:
        sl.adam_flat = real_adam_flat
    del p0, m0, v0, g0
    pl_losses = []
    for _ in range(3):
        pstate, loss_n, _, n = pstep(pstate, xb, yb, wb)
        pl_losses.append((loss_n / n).item())
    flat_params = sl.unflatten_tree(sstate.flat, smeta)
    p_diff = max(max_err(flat_params[k], p)
                 for k, p in per_leaf.named_parameters())
    log(f"superleaf ViT-B/16 bf16 batch 32 attention_dropout 0.1, "
        f"{smeta.total_padded} flat elements ({sum(smeta.sizes)} live): loss "
        f"{sl_losses} (per-leaf fused {pl_losses}), launches "
        f"{ {k: v for k, v in sl_launches.items() if v} }, adam_multi_kernel "
        f"per step {sl_logged}, max|superleaf - per-leaf| {p_diff:.3e}")
    require(sl_logged == [1, 1, 1] and sl_launches["fused_adam"] == 3
            and sl_launches["packed_attention"] == 36
            and sl_launches["packed_attention_bwd"] == 36,
            "superleaf: one row-15 launch a step, 12 row-1 and 12 row-7 "
            "launches a step")
    require(sl_losses == pl_losses and p_diff == 0.0,
            "superleaf: losses and parameters bit-equal to the per-leaf fused "
            "Adam under the same dropout seeds")
    require(np.isfinite(sl_losses).all() and sl_losses[-1] < sl_losses[0],
            "superleaf: finite falling loss over 3 steps on one batch")
    # times: host clock per synchronised step (superleaf, per-leaf,
    # per-leaf, superleaf), the optimizer's device time (the one flat launch
    # against the per-leaf step's one launch over 152 leaves) and the idle
    # share of a profiled step
    box = [sstate, pstate]

    def sl_once():
        box[0] = sstep(box[0], xb, yb, wb)[0]

    def pl_once():
        box[1] = pstep(box[1], xb, yb, wb)[0]

    def step_ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    host = [step_ms(f) for f in (sl_once, pl_once, pl_once, sl_once)]
    g_zero = torch.zeros_like(sstate.flat)
    opt_dev = queued_ms([lambda: real_adam_flat(box[0], g_zero, 1e-4),
                         lambda: box[1].optimizer.step()], reps=5)
    superleaf_times = dict(
        step_ms=(host[0] + host[3]) / 2,
        per_leaf_step_ms=(host[1] + host[2]) / 2,
        adam_ms=opt_dev[0], per_leaf_adam_ms=opt_dev[1],
        flat_elements=smeta.total_padded,
        adam_bound_ms=bound_ms(7 * 4 * smeta.total_padded,
                               12 * smeta.total_padded, "float32")[0])
    log(f"superleaf train step B32: {host[0]:.3f} / {host[3]:.3f} ms by the "
        f"host clock, per-leaf fused {host[1]:.3f} / {host[2]:.3f} ms; "
        f"optimizer device time: one flat launch {opt_dev[0]:.4f} ms (bound "
        f"{superleaf_times['adam_bound_ms']:.4f} ms, 7 fp32 streams), "
        f"per-leaf launch {opt_dev[1]:.4f} ms")
    for label, key, fn in (("superleaf", "idle", sl_once),
                           ("per-leaf fused", "per_leaf_idle", pl_once)):
        wall, busy, count, top = device_profile(fn, top=6)
        if busy is None:
            log(f"profile {label} step: the profiler saw no device activity")
            continue
        superleaf_times[key] = 1 - busy / wall
        log(f"profile {label} step: wall {wall:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in top:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")
    del sleaf, per_leaf, sstate, pstate, sstep, pstep, box, flat_params, g_zero

    # 6c. split-head training: 2 layers at 512 px (S = 1025), bf16, batch 2
    x512_2 = x512.to(dev)
    y512 = torch.tensor([1, 2], device=dev)
    w512 = torch.ones(2, device=dev)
    split_train_launches = {}
    for rate in (0.1, 0.0):
        m = ViT(**dict(wide, attention_dropout=rate), dtype="bfloat16")
        m.load_state_dict(split_weights)
        st = trainer.make_train_state(m, lr=1e-4)
        fa.reset_launch_counts()
        st, loss_n, _, n = trainer.train_step_fn(m)(st, x512_2, y512, w512)
        loss_v = (loss_n / n).item()
        finite = all(bool(torch.isfinite(p).all()) for p in m.parameters())
        split_train_launches[rate] = dict(fa.LAUNCHES)
        log(f"split-head train step (2 layers @512, S=1025, bf16, attention "
            f"dropout {rate}): loss {loss_v:.4f}, launches "
            f"{split_train_launches[rate]}")
        require_route(f"split-head train step bf16 rate {rate}",
                      lambda: trainer.train_step_fn(m)(st, x512_2, y512,
                                                       w512),
                      [("row 6", "bfloat16")]
                      + ([("row 2", "bfloat16")] if rate == 0.0 else []))
        require(np.isfinite(loss_v) and finite,
                f"split-head train step at rate {rate}: finite loss and "
                "parameters")
        del m, st
    want = {0.1: {"dropout_attention_fwd": 2, "dropout_attention_bwd": 2,
                  "flash_attention": 0},
            0.0: {"dropout_attention_fwd": 0, "dropout_attention_bwd": 2,
                  "flash_attention": 2}}
    require(all(split_train_launches[r][k] == v and
                split_train_launches[r]["packed_attention"] == 0
                for r, kv in want.items() for k, v in kv.items()),
            "split-head training: rows 5 and 6 with dropout; row 2 forward "
            "and row 6 backward without")

    # 6d. fp32 gradients, card against CPU (plain versions), 2 layers, rate 0
    small = dict(args, num_layers=2)
    grads = {}
    xg = torch.from_numpy(images[:2])
    yg = torch.tensor([3, 7])
    sd = seeded_state_dict(ViT(**small, device="cpu"), seed=4)
    for device in ("cpu", "cuda"):
        m = ViT(**small, device=device)
        m.load_state_dict(sd)
        m.train()
        fa.reset_launch_counts()
        loss = trainer.cross_entropy_with_weights(
            m(xg.to(device)), yg.to(device), torch.ones(2, device=device))
        loss.backward()
        grads[device] = (loss.item(), {n: p.grad.detach().cpu()
                                       for n, p in m.named_parameters()})
        if device == "cuda":
            require(fa.LAUNCHES["packed_attention_bwd"] == 2,
                    "card gradients went through the packed backward kernel")
    g_ref = max(g.abs().max().item() for g in grads["cpu"][1].values())
    e_grad = max(max_err(grads["cuda"][1][n], g)
                 for n, g in grads["cpu"][1].items())
    log(f"fp32 gradients of a 2-layer ViT-B-width model, card vs CPU: loss "
        f"{grads['cuda'][0]:.6f} vs {grads['cpu'][0]:.6f}, max|dgrad| "
        f"{e_grad:.3e} (max|ref| {g_ref:.3e}, tol {MODEL_GRAD_TOL} x "
        f"max(1, max|ref|))")
    require(abs(grads["cuda"][0] - grads["cpu"][0]) <= 1e-4
            and e_grad <= MODEL_GRAD_TOL * max(1.0, g_ref),
            "card gradients against the CPU run of the same weights")
    del grads

    # 6e. the windowed training path: Swin-T and SwinV2-T, bf16, batch 32
    def step_split(model, state, x, y, w, n=5):
        """Host ms per step and device ms of forward, backward, optimizer."""
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(n)]
        model.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e0, e1, e2, e3 in ev:
            e0.record()
            loss = trainer.cross_entropy_with_weights(model(x), y, w)
            e1.record()
            state.optimizer.zero_grad()
            loss.backward()
            e2.record()
            state.optimizer.step()
            e3.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / n * 1e3
        return (host, *(float(np.mean([e[i].elapsed_time(e[i + 1])
                                       for e in ev])) for i in range(3)))

    def log_profile(what, fn, top=12):
        wall, busy, count, ranked = device_profile(fn, top=top)
        if busy is None:
            log(f"profile {what}: the profiler saw no device activity")
            return
        log(f"profile {what}: wall {wall:.3f} ms (profiler on), device busy "
            f"{busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in ranked:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")

    def train_phase(preset, model, weights, x, y, w, want_fwd, want_bwd,
                    routes=()):
        """3 steps with the fused and 3 with the unfused optimizer from the
        same weights: launches per step, the batch's eval loss before and
        after, the step's split; the step's kernels take ``routes``
        (require_route). Returns (launches, times by optimizer)."""
        n_leaves = sum(1 for p in model.parameters()
                       if p.dtype == torch.float32)
        per_step = -(-n_leaves // fadam._TABLE_LEAVES)  # fused_adam launches
        evaluate = trainer.eval_step_fn(model)
        launches, times = {}, {}
        for fused in (True, False):
            model.load_state_dict(weights)
            state = trainer.make_train_state(
                model, tx=make_optimizer("adam", 1e-4, fused=fused))
            step = trainer.train_step_fn(model)
            before = (evaluate(model, x, y, w)[0] / 32).item()
            model.dropout_generator.manual_seed(0)
            fa.reset_launch_counts()
            _build.reset_launched()
            losses = []
            for _ in range(3):
                state, loss_n, _, n = step(state, x, y, w)
                losses.append((loss_n / n).item())
            torch.cuda.synchronize()
            got = {k: v for k, v in fa.LAUNCHES.items() if v}
            adam_logged = _build.launched().get("adam_multi_kernel", 0)
            after = (evaluate(model, x, y, w)[0] / 32).item()
            want = {k: 3 * v for k, v in {**want_fwd, **want_bwd}.items()}
            if fused:
                want["fused_adam"] = 3 * per_step
            log(f"{preset} bf16 batch 32, 3 Adam steps (fused={fused}) on one "
                f"batch: train-mode loss {[round(v, 4) for v in losses]}, "
                f"eval-mode loss of the batch {before:.4f} -> {after:.4f}, "
                f"launches {got}")
            require(np.isfinite(losses).all() and np.isfinite(after)
                    and after < before,
                    f"{preset} fused={fused}: finite losses, and the batch's "
                    "eval loss falls over 3 steps")
            require(got == want and adam_logged == want.get("fused_adam", 0),
                    f"{preset} fused={fused}: per step {want_fwd} "
                    f"forward, {want_bwd} backward"
                    + (f", {per_step} fused_adam" if fused else "")
                    + f" and no other kernel; got {got}, {adam_logged} "
                    "adam_multi_kernel launches")
            require(all(bool(torch.isfinite(p).all())
                        for p in model.parameters()),
                    f"{preset} fused={fused}: finite parameters")
            launches[fused] = got
            times[fused] = step_split(model, state, x, y, w)
            host, f_ms, b_ms, o_ms = times[fused]
            log(f"{preset} bf16 train step, batch 32, fused={fused}: "
                f"{host:.3f} ms per step by the host clock "
                f"({32 / host * 1e3:.1f} images/s); device time forward "
                f"{f_ms:.3f} ms, backward {b_ms:.3f} ms, optimizer "
                f"{o_ms:.3f} ms ({n_leaves} fp32 leaves, {per_step} "
                "adam_multi_kernel launch(es) a fused step)")
            if fused:
                def one_step(state=state):
                    loss = trainer.cross_entropy_with_weights(model(x), y, w)
                    state.optimizer.zero_grad()
                    loss.backward()
                    state.optimizer.step()
                model.train()
                log_profile(f"{preset} train step (fused Adam)", one_step)
                if routes:
                    require_route(f"{preset} bf16 train step", one_step,
                                  routes)
        return launches, times

    xb = torch.from_numpy(images[:32]).to(dev)
    yb = torch.from_numpy(rng.randint(0, 1000, 32)).to(dev)
    wb = torch.ones(32, device=dev)
    bwd12 = {"window_attention_bwd": 12}
    swin_train = {}
    for preset, cls in (("swint_224_imagenet", SwinTransformer),
                        ("swinv2t_224_imagenet", SwinTransformerV2)):
        smodel = cls(**get_args(preset), dtype="bfloat16")
        want_fwd = SWIN_LAUNCHES_PER_FORWARD[preset]
        swin_train[preset] = train_phase(
            preset, smodel, swin_weights[preset], xb, yb, wb, want_fwd, bwd12,
            [("row 10", "bfloat16")] + window_routes(want_fwd))
        if preset == "swint_224_imagenet":
            adam_model = smodel  # its leaves time the optimizers in phase 7
        del smodel

    # fp32 gradients of narrow 2-stage models, card against CPU (plain
    # versions); stochastic depth 0: its masks differ between devices
    narrow = dict(patch_size=[4, 4], embed_dim=32, depths=[2, 2],
                  num_heads=[1, 2], window_size=[7, 7], num_classes=10,
                  stochastic_depth_prob=0.0)
    xn = torch.from_numpy(rng.standard_normal((2, 56, 56, 3))
                          .astype(np.float32))
    yn = torch.tensor([3, 7])
    for cls in (SwinTransformer, SwinTransformerV2):
        sd = seeded_state_dict(cls(**narrow, device="cpu"), seed=6)
        grads = {}
        for device in ("cpu", "cuda"):
            m = cls(**narrow, device=device)
            m.load_state_dict(sd)
            m.train()
            fa.reset_launch_counts()
            loss = trainer.cross_entropy_with_weights(
                m(xn.to(device)), yn.to(device), torch.ones(2, device=device))
            loss.backward()
            grads[device] = (loss.item(), {n: p.grad.detach().cpu()
                                           for n, p in m.named_parameters()})
            if device == "cuda":
                require(fa.LAUNCHES["window_attention_bwd"] == 4,
                        "card gradients went through the window backward")
        g_ref = max(g.abs().max().item() for g in grads["cpu"][1].values())
        e_grad = max(max_err(grads["cuda"][1][n], g)
                     for n, g in grads["cpu"][1].items())
        log(f"fp32 gradients of a 2-stage {cls.__name__}, card vs CPU: loss "
            f"{grads['cuda'][0]:.6f} vs {grads['cpu'][0]:.6f}, max|dgrad| "
            f"{e_grad:.3e} (max|ref| {g_ref:.3e}, tol {MODEL_GRAD_TOL} x "
            f"max(1, max|ref|))")
        require(abs(grads["cuda"][0] - grads["cpu"][0]) <= 1e-4
                and e_grad <= MODEL_GRAD_TOL * max(1.0, g_ref),
                f"{cls.__name__}: card gradients against the CPU run")
    del grads

    # train_model on swin_tiny_cifar100 (32 px, window 4), fp32
    stiny_args = get_args("swin_tiny_cifar100")
    stiny = SwinTransformer(**stiny_args)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    shist = stiny.train_model(stiny, train_loader, test_loader, epochs,
                              val_loader, lr=1e-4, verbose=False)
    torch.cuda.synchronize()
    stiny_s = time.perf_counter() - t0
    stiny_launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    log(f"train_model swin_tiny_cifar100, {epochs} epochs x {steps_per_epoch} "
        f"steps of 64 in {stiny_s:.2f} s: train loss "
        f"{[round(v, 4) for v in shist['train_loss']]}, train acc "
        f"{[round(v, 4) for v in shist['train_accuracy']]}, test acc "
        f"{[round(v, 4) for v in shist['test_accuracy']]}, launches "
        f"{stiny_launches}")
    require(keys <= set(shist) and all(
        len(shist[k]) == epochs and np.isfinite(shist[k]).all()
        for k in keys), "swin_tiny: the six keys, finite, one value per epoch")
    require(shist["train_loss"][-1] < shist["train_loss"][0]
            and shist["train_accuracy"][-1] > 0.5,
            "swin_tiny: train loss falls and train accuracy passes 0.5")
    require(stiny_launches["window_attention_bwd"]
            == 12 * shist["final_state"].step,
            "swin_tiny: 12 window backward launches per train step")
    del stiny

    # 6f. PVT-Tiny and Twins-SVT-S @224: served and trained, bf16
    hier = {}
    for preset, cls in (("pvt_tiny224_imagenet", PVT),
                        ("twins_svts224_imagenet", TwinSVT)):
        hargs = get_args(preset)
        hmodel = cls(**hargs, dtype="bfloat16")
        hweights = seeded_state_dict(hmodel, seed=7)
        hmodel.load_state_dict(hweights)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(hmodel, (224, 224, 3), tmp,
                                      buckets=(1, 32), dtype=fp32)
            hclf = serving.load_classifier(tmp)
        require(type(hclf.model) is cls,
                f"{preset}: the artifact rebuilds a {cls.__name__}")
        want = HIER_LAUNCHES_PER_FORWARD[preset]
        fa.reset_launch_counts()
        windows.ROUTE_LOG = []
        hclf.warmup()
        routes = windows.ROUTE_LOG[:len(windows.ROUTE_LOG) // 2]
        require(windows.ROUTE_LOG == routes * 2
                and routes == (TWINS_ROUTES if cls is TwinSVT else []),
                f"{preset}: window routes per forward, got {routes}")
        windows.ROUTE_LOG = None
        hserved = {n: hclf.predict(images[:n]) for n in (1, 32)}
        torch.cuda.synchronize()
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        require(got == {k: 4 * v for k, v in want.items()},
                f"{preset}: {want} per forward over 4 forwards and no other "
                f"kernel; got {got}")
        if window_routes(want):
            require_route(f"{preset} bf16 served forward, bucket 32",
                          lambda: hclf.predict(images[:32]),
                          window_routes(want))
        cpu_h = cls(**hargs, device="cpu")
        cpu_h.load_state_dict(hweights)
        with torch.no_grad():
            href = cpu_h(torch.from_numpy(images[:2])).float()
        del cpu_h
        hscale = href.abs().max().item()
        e16 = max(max_err(hserved[n][:k].cpu(), href[:k])
                  for n, k in ((1, 1), (32, 2)))
        h32 = cls(**hargs)
        h32.load_state_dict(hweights)
        with torch.inference_mode():
            e32 = max_err(h32(torch.from_numpy(images[:2]).to(dev)).cpu(),
                          href)
        del h32
        log(f"{preset}: served at buckets 1 and 32, launches per forward "
            f"{want}, routes {routes}; logits vs CPU fp32: fp32 model on the "
            f"card {e32:.3e} (tol {SWIN_LOGIT_TOL_FP32}), bf16 served "
            f"{e16:.3e} (max|ref| {hscale:.3f}, tol {LOGIT_TOL_BF16_REL} x "
            "max|ref|)")
        require(all(bool(torch.isfinite(o.float()).all())
                    for o in hserved.values())
                and e32 <= SWIN_LOGIT_TOL_FP32
                and e16 <= LOGIT_TOL_BF16_REL * hscale,
                f"{preset}: logits against the CPU run of the same weights")
        # training: the split-head backward is the dropout kernel at rate 0;
        # Twins' 9 LSA blocks add their window forwards and the shared backward
        n_attn = want["flash_attention"]
        want_bwd = {"dropout_attention_bwd": n_attn}
        if cls is TwinSVT:
            want_bwd["window_attention_bwd"] = 9
        hier[preset] = (hclf, got, train_phase(
            preset, hmodel, hweights, xb, yb, wb, want, want_bwd,
            [("row 10", "bfloat16")] + window_routes(want)
            if cls is TwinSVT else []))
        del hmodel

    # ---- 6g. the ViT family on the fused path (USE_FUSED_BLOCK) -----------
    # ViT-B/16, DeiT-B, CPE-ViT-B and T2T-ViT-14 (both token types) @224,
    # bf16, weights drawn into the JAX params layout and loaded through the
    # converters; served with the flag on at buckets 1, 8 and 32, then with
    # it off; fp32 on the card and the CPU; trained with the flag on
    family, family_runs = {}, []
    for label, (cls, kw, convert, layers, extra) in FAMILY.items():
        model = cls(**kw, dtype="bfloat16")
        fweights = getattr(port_jax, convert)(jax_shaped_weights(model, 40))
        model.load_state_dict(fweights, strict=True)
        vv.USE_FUSED_BLOCK = True
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serving.export_classifier(model, shape, tmp, buckets=(1, 8, 32),
                                      dtype=fp32)
            del model
            fclf = serving.load_classifier(tmp)
        fwd = [0]
        fclf.model.register_forward_hook(
            lambda *_: fwd.__setitem__(0, fwd[0] + 1))
        fa.reset_launch_counts()
        fclf.warmup()
        fused_out = {n: fclf.predict(images[:n]) for n in (1, 8, 32)}
        torch.cuda.synchronize()
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        want = {k: v * fwd[0] for k, v in
                {"fused_attention_block": layers, **extra}.items()}
        log(f"{label} bf16 served with USE_FUSED_BLOCK: {fwd[0]} forwards "
            f"(buckets 1, 8, 32), launches {got}")
        require(got == want, f"{label}: per forward {layers} fused_attention_"
                f"block launches{', ' + str(extra) if extra else ''} and no "
                f"packed or other launch; got {got}")
        family_runs.append(got)
        x32 = torch.from_numpy(images[:32]).to(dev)
        with torch.inference_mode():
            fused_ms = cuda_ms(lambda: fclf.model(x32), iters=10)
            require_route(f"{label} bf16 served forward, USE_FUSED_BLOCK",
                          lambda: fclf.model(x32),
                          [("row 8", "bfloat16")]
                          + ([("row 3", "bfloat16"), ("row 2", "bfloat16")]
                             if "flash_attention_large" in extra  # T2T_t
                             else []))
        vv.USE_FUSED_BLOCK = False
        fwd[0] = 0
        fa.reset_launch_counts()
        plain_out = fclf.predict(images[:8])
        torch.cuda.synchronize()
        got_off = {k: v for k, v in fa.LAUNCHES.items() if v}
        want_off = {k: v * fwd[0] for k, v in
                    {"packed_attention": layers, **extra}.items()}
        require(got_off == want_off, f"{label} flag off: per forward {layers} "
                f"packed launches{', ' + str(extra) if extra else ''}; got "
                f"{got_off}")
        with torch.inference_mode():
            modular_ms = cuda_ms(lambda: fclf.model(x32), iters=10)
        cpu_model = cls(**kw, device="cpu")
        cpu_model.load_state_dict(fweights, strict=True)
        with torch.no_grad():
            ref = cpu_model(torch.from_numpy(images[:2])).float()
        del cpu_model
        scale = ref.abs().max().item()
        e_off = max_err(fused_out[8], plain_out)
        e_cpu = max_err(fused_out[8][:2].cpu(), ref)
        model32 = cls(**kw)
        model32.load_state_dict(fweights, strict=True)
        vv.USE_FUSED_BLOCK = True
        fa.reset_launch_counts()
        with torch.no_grad():
            out32 = model32(torch.from_numpy(images[:2]).to(dev)).float()
        torch.cuda.synchronize()
        vv.USE_FUSED_BLOCK = False
        require(fa.LAUNCHES["fused_attention_block"] == layers,
                f"{label} fp32: the fused kernel per layer")
        e32 = max_err(out32.cpu(), ref)
        del model32
        log(f"{label}: bf16 fused vs bf16 modular logits {e_off:.3e}, vs CPU "
            f"fp32 {e_cpu:.3e} (max|ref| {scale:.3f}, tol "
            f"{LOGIT_TOL_BF16_REL} x max|ref|); fp32 fused on the card vs CPU "
            f"{e32:.3e} (tol {LOGIT_TOL_FP32}); forward at batch 32, device "
            f"time: fused {fused_ms:.3f} ms, modular {modular_ms:.3f} ms")
        require(all(bool(torch.isfinite(o.float()).all())
                    and o.shape == (o.shape[0], 1000)
                    for o in fused_out.values())
                and e_off <= LOGIT_TOL_BF16_REL * scale
                and e_cpu <= LOGIT_TOL_BF16_REL * scale
                and e32 <= LOGIT_TOL_FP32,
                f"{label}: fused logits against the modular path and the CPU")
        family[label] = dict(clf=fclf, fused_ms=fused_ms,
                             modular_ms=modular_ms)

    # the three new models trained with the flag on: it does not engage in
    # training mode (no fused launch in a step), the packed kernels do
    vv.USE_FUSED_BLOCK = True
    fam_x = torch.from_numpy(images[:32]).to(dev)
    fam_y = torch.from_numpy(rng.randint(0, 1000, 32)).to(dev)
    fam_w = torch.ones(32, device=dev)
    for label, (cls, kw, convert, layers, extra) in FAMILY.items():
        if cls is ViT:
            continue  # trained in phase 6b
        model = cls(**kw, dtype="bfloat16")
        model.load_state_dict(getattr(port_jax, convert)(
            jax_shaped_weights(model, 41)), strict=True)
        evaluate = trainer.eval_step_fn(model)
        before = (evaluate(model, fam_x, fam_y, fam_w)[0] / 32).item()
        state = trainer.make_train_state(model,
                                         tx=make_optimizer("adam", 1e-4))
        step = trainer.train_step_fn(model)
        model.dropout_generator.manual_seed(0)
        fa.reset_launch_counts()
        losses = []
        for _ in range(3):
            state, loss_n, _, n = step(state, fam_x, fam_y, fam_w)
            losses.append((loss_n / n).item())
        torch.cuda.synchronize()
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        after = (evaluate(model, fam_x, fam_y, fam_w)[0] / 32).item()
        want = {k: 3 * v for k, v in {
            "packed_attention": layers, "packed_attention_bwd": layers,
            **extra,
            **({"dropout_attention_bwd": sum(extra.values())}
               if extra else {})}.items()}
        family_runs.append(got)
        host, f_ms, b_ms, o_ms = step_split(model, state, fam_x, fam_y,
                                            fam_w)
        log(f"{label} bf16 batch 32, 3 Adam steps with USE_FUSED_BLOCK set: "
            f"train-mode loss {[round(v, 4) for v in losses]}, eval-mode "
            f"loss of the batch {before:.4f} -> {after:.4f}, launches {got}; "
            f"step {host:.3f} ms by the host clock ({32 / host * 1e3:.1f} "
            f"images/s), device forward {f_ms:.3f}, backward {b_ms:.3f}, "
            f"optimizer {o_ms:.3f} ms")
        require(got == want, f"{label} training: per step {want} / 3 and no "
                f"fused_attention_block launch; got {got}")
        require(np.isfinite(losses).all() and after < before,
                f"{label}: finite losses, and the batch's eval loss falls")
        del model, state
    vv.USE_FUSED_BLOCK = False

    # row 14 as the public op: benchmarks/ln_fused.py's "fused" chain, 12
    # ViT-B/16 layers at batch 32, bf16 (ln_dense for [ln_1 + QKV] and
    # [ln_2 + fc1 + GELU], the packed kernel between), against its "base"
    # chain of library calls
    chain = dense_chain_weights(randn, bf16)
    xc = 0.02 * randn(140, 32, 197, 768, dtype=bf16)
    fa.reset_launch_counts()
    with torch.inference_mode():
        fused_chain = ln_fused_chain(xc, chain, fdense.ln_dense,
                                     fa.packed_flash_attention)
    torch.cuda.synchronize()
    ln_chain_launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    with torch.inference_mode():
        base_chain = ln_fused_chain(xc, chain, base_ln_dense,
                                    fa.packed_flash_attention)
        chain_ms = {name: cuda_ms(lambda f=f: ln_fused_chain(
            xc, chain, f, fa.packed_flash_attention), iters=5)
            for name, f in (("fused", fdense.ln_dense),
                            ("base", base_ln_dense))}
    with torch.inference_mode():
        require_route("ln_fused chain", lambda: ln_fused_chain(
            xc, chain, fdense.ln_dense, fa.packed_flash_attention),
            [("row 14", "bfloat16"), ("row 1", "bfloat16")])
    e_chain = max_err(fused_chain, base_chain)
    c_scale = base_chain.float().abs().max().item()
    log(f"ln_fused chain (12 ViT-B/16 layers, batch 32, bf16): launches "
        f"{ln_chain_launches}; fused {chain_ms['fused']:.3f} ms vs base "
        f"{chain_ms['base']:.3f} ms; max|fused - base| {e_chain:.3e} (max|base| "
        f"{c_scale:.3f})")
    require(ln_chain_launches == {"ln_dense": 24, "packed_attention": 12}
            and bool(torch.isfinite(fused_chain.float()).all())
            and e_chain <= LOGIT_TOL_BF16_REL * max(1.0, c_scale),
            "ln_fused chain: 2 ln_dense and 1 packed launch per layer, the "
            "base chain's output")

    # ---- 7. detection: DETR-R50 (DC5) at COCO scale ------------------------
    det_cfg = dict(num_classes=91, aux_loss=True)   # cli.run_detection_main
    det_w = None
    det_eval, det_models = {}, {}
    det_runs = []  # launches of every run of the detection path
    ds = SyntheticCoco(COCO_SIZES, seed=11)
    nt4, targets4 = next(iter(DetectionLoader(ds, 4)))
    require(nt4.tensors.shape == (4, 896, 1344, 3),
            f"four COCO-sized images collate to the 896 x 1344 bucket, got "
            f"{nt4.tensors.shape}")
    batch4 = nt4.to(dev)
    for dname in ("bfloat16", "float32"):
        det = Detr(**det_cfg, dtype=dname)
        if det_w is None:
            det_w = detr_state_dict_from_jax(jax_shaped_weights(det, seed=12))
        det.load_state_dict(det_w, strict=True)
        forwards = [0]
        det.register_forward_hook(
            lambda *_, forwards=forwards: forwards.__setitem__(
                0, forwards[0] + 1))
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = evaluate_model(det, DetectionLoader(ds, 4), device=dev)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        det_runs.append(got)
        log(f"DETR-R50 {dname} evaluate_model, batch 4 at 896 x 1344 "
            f"(4704 C5 tokens): {eval_s:.2f} s with the first call, "
            f"{forwards[0]} forward, launches {got}, metrics {metrics}")
        require(forwards[0] == 1 and got == DETR_EVAL_LAUNCHES,
                f"DETR {dname} eval: {DETR_EVAL_LAUNCHES} per forward and no "
                f"other kernel; got {got}")
        require(all(np.isfinite(v) for v in metrics.values())
                and {"mAP", "AP50", "AR@100"} <= set(metrics),
                f"DETR {dname}: finite COCO metrics")
        with torch.inference_mode():
            out = det(batch4.tensors, batch4.mask)
            require(out["pred_logits"].shape == (4, 100, 92)
                    and out["pred_boxes"].shape == (4, 100, 4)
                    and len(out["aux_outputs"]) == 5
                    and bool(torch.isfinite(out["pred_logits"].float()).all())
                    and bool(((out["pred_boxes"] >= 0)
                              & (out["pred_boxes"] <= 1)).all()),
                    f"DETR {dname}: finite (4, 100, 92) logits, boxes in "
                    "[0, 1], 5 aux outputs")
            det_eval[dname] = {"out": {k: out[k].float()
                                       for k in ("pred_logits", "pred_boxes")}}
            fwd_ms = cuda_ms(lambda: det(batch4.tensors, batch4.mask),
                             iters=5, warmup=1)
            det_eval[dname]["fwd_ms"] = fwd_ms
            log(f"DETR-R50 {dname} eval forward, batch 4 at 896 x 1344, "
                f"device time {fwd_ms:.3f} ms ({4 / fwd_ms * 1e3:.1f} "
                "images/s)")
            log_profile(f"DETR-R50 {dname} eval forward, batch 4",
                        lambda: det(batch4.tensors, batch4.mask), top=12)
            require_route(f"DETR-R50 {dname} eval forward",
                          lambda: det(batch4.tensors, batch4.mask),
                          [("row 3", dname), ("row 2", dname)])
        det_models[dname] = det
    e16 = max_err(det_eval["bfloat16"]["out"]["pred_logits"],
                  det_eval["float32"]["out"]["pred_logits"])
    log(f"DETR-R50 bf16 against fp32 logits on the card: max|diff| "
        f"{e16:.3e} (max|fp32| "
        f"{det_eval['float32']['out']['pred_logits'].abs().max().item():.3f})")

    # fp32 on the card against the CPU run of the same weights, one image
    # padded to 512 x 640
    small = SyntheticCoco([(480, 620)], seed=14)
    nt1 = nested_tensor_from_tensor_list([small[0][0]])
    require(nt1.tensors.shape == (1, 512, 640, 3), "one image at 512 x 640")
    cpu_det = Detr(**det_cfg, device="cpu")
    cpu_det.load_state_dict(det_w, strict=True)
    with torch.no_grad():
        ref = cpu_det(*nt1.to("cpu").decompose())
    fa.reset_launch_counts()
    with torch.inference_mode():
        got_out = det_models["float32"](*nt1.to(dev).decompose())
    det_runs.append(dict(fa.LAUNCHES))
    scale = ref["pred_logits"].abs().max().item()
    e_logit = max_err(got_out["pred_logits"].cpu(), ref["pred_logits"])
    e_box = max_err(got_out["pred_boxes"].cpu(), ref["pred_boxes"])
    log(f"DETR-R50 fp32 at 512 x 640 (S 1280), card vs CPU: max|dlogits| "
        f"{e_logit:.3e} (max|ref| {scale:.3f}, tol {DETR_LOGIT_TOL_REL} x "
        f"max(1, max|ref|)), max|dboxes| {e_box:.3e} (tol {DETR_BOX_TOL}); "
        f"launches {dict((k, v) for k, v in fa.LAUNCHES.items() if v)}")
    require(e_logit <= DETR_LOGIT_TOL_REL * max(1.0, scale)
            and e_box <= DETR_BOX_TOL
            and fa.LAUNCHES["flash_attention_large"] == 12,
            "DETR fp32 outputs on the card against the CPU run")
    del cpu_det, det_models, ref

    # training: fit_detection, 3 steps at batch 2 on one 896 x 1344 batch
    train_ds = SyntheticCoco([COCO_SIZES[0], COCO_SIZES[2]], seed=15)
    nt2, targets2 = next(iter(DetectionLoader(train_ds, 2)))
    require(nt2.tensors.shape == (2, 896, 1344, 3), "train batch bucket")
    crit = SetCriterion(num_classes=91)

    def det_eval_loss(model):
        labels, boxes, valid = prepare_targets(targets2, 64, 91, dev)
        b = nt2.to(dev)
        model.eval()
        with torch.no_grad():
            out = model(b.tensors, b.mask)
            return crit.total_loss(crit(out, labels, boxes, valid)).item(), \
                out

    det_train = {}
    for rate in (0.1, 0.0):
        model = Detr(**det_cfg, dropout=rate, dtype="bfloat16")
        model.load_state_dict(det_w, strict=True)
        before, _ = det_eval_loss(model)
        fa.USE_PALLAS_BWD = rate == 0.0
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        hist = fit_detection(model, DetectionLoader(train_ds, 2), 3,
                             num_classes=91, seed=0, verbose=False)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        det_runs.append(got)
        after, out_after = det_eval_loss(model)
        want = {k: 3 * v for k, v in DETR_TRAIN_LAUNCHES[rate].items()}
        log(f"DETR-R50 bf16 fit_detection, 3 steps at batch 2 (896 x 1344), "
            f"dropout {rate}, USE_PALLAS_BWD {fa.USE_PALLAS_BWD}: "
            f"{fit_s:.2f} s with the first step, train loss per epoch "
            f"{[round(v, 4) for v in hist['loss']]}, eval-mode loss of the "
            f"batch {before:.4f} -> {after:.4f}, launches {got}")
        require(hist["final_state"].step == 3 and got == want,
                f"DETR train at dropout {rate}: per step "
                f"{DETR_TRAIN_LAUNCHES[rate]} and no other kernel; got {got}")
        require(np.isfinite(hist["loss"]).all() and np.isfinite(after)
                and after < before,
                f"DETR train at dropout {rate}: the batch's eval loss falls")
        state = hist["final_state"]

        # the step's split: forward (with matching and loss), backward,
        # optimizer, CUDA events around the parts of training.detection
        labels, boxes, valid = prepare_targets(targets2, 64, 91, dev)
        b2 = nt2.to(dev)
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(3)]
        model.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e0, e1, e2, e3 in ev:
            e0.record()
            loss = crit.total_loss(crit(model(b2.tensors, b2.mask), labels,
                                        boxes, valid))
            e1.record()
            state.optimizer.zero_grad()
            loss.backward()
            e2.record()
            state.optimizer.step()
            e3.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / len(ev) * 1e3
        f_ms, b_ms, o_ms = (float(np.mean([e[i].elapsed_time(e[i + 1])
                                           for e in ev])) for i in range(3))
        det_train[rate] = dict(launches=got, host_ms=host, fwd_ms=f_ms,
                               bwd_ms=b_ms, opt_ms=o_ms)
        log(f"DETR-R50 bf16 train step, batch 2, dropout {rate}: {host:.3f} "
            f"ms per step by the host clock ({2 / host * 1e3:.2f} images/s); "
            f"device time forward + matching + loss {f_ms:.3f} ms, backward "
            f"{b_ms:.3f} ms, optimizer {o_ms:.3f} ms")

        def det_step(model=model, state=state):
            loss = crit.total_loss(crit(model(b2.tensors, b2.mask), labels,
                                        boxes, valid))
            state.optimizer.zero_grad()
            loss.backward()
            state.optimizer.step()

        log_profile(f"DETR-R50 bf16 train step, dropout {rate}", det_step,
                    top=12)
        require_route(f"DETR-R50 bf16 train step, dropout {rate}", det_step,
                      [("row 6", "bfloat16")]
                      + ([("row 2", "bfloat16"), ("row 3", "bfloat16"),
                          ("row 4", "bfloat16")]
                         if rate == 0.0 else [("row 5", "bfloat16")]))
        if rate == 0.0:
            # the auction on the card against scipy on the step's cost
            cost = HungarianMatcher().cost(out_after, labels, boxes)
            auc = auction_assign(cost, valid)
            ref_idx = _host_assign(cost.cpu().numpy(), valid.cpu().numpy())
            c = cost.cpu().numpy()
            gap = spread = 0.0
            for i in range(c.shape[0]):
                n = int(valid[i].sum())
                mine = c[i, auc[i, :n].cpu().numpy(), np.arange(n)].sum()
                best = c[i, ref_idx[i, :n], np.arange(n)].sum()
                gap = max(gap, float(mine - best))
                spread = max(spread, float(c[i].max() - c[i].min()))
                require(len(set(auc[i, :n].tolist())) == n
                        and bool((auc[i, n:] == -1).all()),
                        "the auction gives a valid matching")
            same = bool((auc.cpu().numpy() == ref_idx).all())
            log(f"auction vs scipy on the trained step's cost (2 x 100 x 64): "
                f"identical {same}, worst total-cost gap {gap:.3e} (cost "
                f"spread {spread:.3f})")
            require(gap <= 0.01 * spread,
                    "the auction within 1% of the cost spread of scipy's")
        fa.USE_PALLAS_BWD = False
        del model, state, hist, loss

    # fp32 gradients of a narrow DETR (full ResNet-50), card against CPU,
    # both matched by scipy (the auction is the card's default), and the
    # diagnosis of their largest difference
    det_runs.append(narrow_detr_gradients())

    # the ViT-B backbone variant: 12 unmasked streaming launches at S 4704
    vdet = Detr(**det_cfg, backbone_arch="vit", dtype="bfloat16")
    vdet.load_state_dict(detr_state_dict_from_jax(jax_shaped_weights(vdet,
                                                                     18)),
                         strict=True)
    fa.reset_launch_counts()
    with torch.inference_mode():
        vout = vdet(batch4.tensors, batch4.mask)
    torch.cuda.synchronize()
    vit_launches = {k: v for k, v in fa.LAUNCHES.items() if v}
    det_runs.append(vit_launches)
    with torch.inference_mode():
        vit_fwd_ms = cuda_ms(lambda: vdet(batch4.tensors, batch4.mask),
                             iters=3, warmup=1)
    log(f"DETR ViT-B/16 backbone bf16, batch 4 at 896 x 1344 (S 4704): "
        f"launches {vit_launches}, forward {vit_fwd_ms:.3f} ms")
    require(vit_launches == {"flash_attention_large": 24,
                             "flash_attention": 6}
            and bool(torch.isfinite(vout["pred_logits"].float()).all()),
            "ViT backbone: 12 unmasked + 12 masked streaming launches and 6 "
            "split-head, finite logits")
    del vdet, vout

    # ---- 7b. the training CLI ---------------------------------------------
    # python -m vision_transformers_tpu_torch.cli, as a user runs it, on a
    # synthetic CIFAR-100 in the real pickle format (4096 train and 1024 test
    # images of learnable colour classes, 0.2 of the train split held out
    # for validation): each run's launch counts are zeroed just before and
    # read just after it, and its routes checked by kernel name over the
    # whole run
    from vision_transformers_tpu_torch import cli, native
    from vision_transformers_tpu_torch.utils import checkpoint as ckpt
    from vision_transformers_tpu_torch.utils.load_data import (
        get_train_test_loaders,
    )

    work = tempfile.mkdtemp(prefix="vtt_cli_")
    cifar_root = os.path.join(work, "data")
    write_cifar100(cifar_root, 4096, 1024, seed=15)
    cli_total = {k: 0 for k in fa.LAUNCHES}
    cli_runs = {}

    def cli_run(label, argv, routes, falls=True):
        """One ``cli.main(argv)`` at batch 256, 2 epochs, on the synthetic
        CIFAR-100; its train loss must fall from epoch to epoch."""
        out = []
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        require_route(f"cli {label}", lambda: out.append(cli.main(
            [argv[0], "--epochs", "2", "--batch-size", "256", "--data-root",
             cifar_root, *argv[1:]])), routes)
        secs = time.perf_counter() - t0
        hist, counts = out[0], {k: v for k, v in fa.LAUNCHES.items() if v}
        for k_, v_ in counts.items():
            cli_total[k_] += v_
        tl = hist["train_loss"]
        log(f"cli {label}: {secs:.1f} s, train loss {tl}, train acc "
            f"{hist['train_accuracy']}, test acc {hist['test_accuracy']}, "
            f"launches {counts}")
        require(all(np.isfinite(tl)) and (tl[-1] < tl[0] or not falls),
                f"cli {label}: the train loss falls ({tl})")
        cli_runs[label] = dict(secs=secs, launches=counts,
                               train_loss=tl, test_accuracy=hist[
                                   "test_accuracy"])
        return hist

    require(native.available(), "the port's augment.cpp builds: the CIFAR "
            "loaders augment through the fused C++ loop")
    ck_dir, art_dir = os.path.join(work, "ckpt"), os.path.join(work, "art")
    vit_routes = [("row 1", "float32"), ("row 7", "float32")]
    hist = cli_run("vit_tiny_cifar100 fp32 + checkpoints + int8 export",
                   ["vit_tiny_cifar100", "--lr", "1e-3", "--checkpoint-dir",
                    ck_dir, "--checkpoint-every", "1", "--export", art_dir,
                    "--export-buckets", "1,8,32", "--export-int8"],
                   vit_routes)
    state = hist["final_state"]
    require(ckpt.available_checkpoints(ck_dir) == [1, 2],
            "a checkpoint after each of the 2 epochs")
    fresh = trainer.make_train_state(
        zoo.ViT(**state.model.config, seed=7), lr=1e-3)
    ckpt.restore_checkpoint(ck_dir, fresh)
    same = (fresh.step == state.step
            and fresh.optimizer.count == state.optimizer.count
            and all(torch.equal(a, b) for a, b in zip(
                state.model.state_dict().values(),
                fresh.model.state_dict().values()))
            and all(torch.equal(a, b) for key in state.optimizer.state
                    for a, b in zip(state.optimizer.state[key],
                                    fresh.optimizer.state[key])))
    require(same, "the latest checkpoint restores bit-equal to final_state "
            "(weights, Adam moments, counts)")
    # --export-int8: the artifact serves quantize_classifier of the trained
    # model, int8 weights and all
    served = serving.load_classifier(art_dir)
    xs = torch.from_numpy(np.random.RandomState(3).rand(
        8, 32, 32, 3).astype(np.float32))
    with torch.inference_mode():
        got = served.predict(xs.numpy())
        e_art = max_err(got, serving.quantize_classifier(state.model)(
            xs.to(dev)))
        f_logits = state.model.eval()(xs.to(dev))
        rel_f = ((got - f_logits).norm() / f_logits.norm()).item()
    log(f"cli export (int8): {art_dir} served at buckets {served.buckets}, "
        f"max|served - quantized trained model| {e_art:.3e} at batch 8, "
        f"relative error against the float model {rel_f:.4f}")
    require(served.manifest["model_kwargs"].get("quant8") is True
            and served.model.encoder.encoder_layer_0.mlp.fc1.kernel_q.dtype
            == torch.int8 and e_art <= 1e-5,
            "the exported int8 artifact serves the quantized trained model")
    del served, fresh, state, hist, got, f_logits

    # --init-from-torch: a reference-layout torch checkpoint written from a
    # seed; the run's first forward sees exactly the weights that
    # load_torch_checkpoint gives when they are loaded by hand
    from vision_transformers_tpu_torch.utils import port_torch

    for key, write, routes in (
            ("vit_tiny_cifar100", reference_vit_state_dict, vit_routes),
            ("swin_tiny_cifar100", reference_swin_state_dict,
             [("row 10", "float32")])):
        key_args = get_args(key)
        ckpt_path = os.path.join(work, f"{key}_reference.pt")
        torch.save({"state_dict": write(key_args, seed=31)}, ckpt_path)
        cls = cli._model_for(key)
        first = []

        def snapshot(module, _inputs, cls=cls, first=first):
            if type(module) is cls and not first:
                first.append({k: v.detach().clone()
                              for k, v in module.state_dict().items()})

        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            snapshot)
        try:
            cli_run(f"{key} --init-from-torch",
                    [key, "--init-from-torch", ckpt_path]
                    + (["--lr", "1e-3"] if key.startswith("vit") else []),
                    routes)
        finally:
            hook.remove()
        hand = cls(**key_args, device=dev)
        started = cls(**key_args, device=dev)
        hand.load_state_dict(port_torch.load_torch_checkpoint(
            ckpt_path, key, key_args))
        started.load_state_dict(first[0])
        xs = torch.from_numpy(np.random.RandomState(4).rand(
            8, 32, 32, 3).astype(np.float32)).to(dev)
        with torch.inference_mode():
            e_first = max_err(started(xs), hand(xs))
        log(f"cli {key} --init-from-torch: the first forward's weights "
            f"against the checkpoint loaded by hand: max|logits diff| "
            f"{e_first:.3e}")
        require(e_first == 0.0 and all(
            torch.equal(first[0][k], v) for k, v in hand.state_dict().items()),
            f"cli {key} --init-from-torch starts from the ported checkpoint")
        del hand, started, first

    # run_study: 2 trials of the real objective (1 epoch each) on the
    # synthetic CIFAR-100, the model and its state carried by fit
    from vision_transformers_tpu_torch.utils import optimization as hpo

    s_train, s_val, _ = get_train_test_loaders(
        "cifar100", 256, val_split=0.2, root_dir=cifar_root)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    study = hpo.run_study(lambda trial: hpo.objective(
        trial, model_cls=zoo.ViT,
        base_args=dict(get_args("vit_tiny_cifar100"), device=dev),
        train_loader=s_train, val_loader=s_val, num_epochs=1),
        n_trials=2, seed=0)
    study_counts = {k: v for k, v in fa.LAUNCHES.items() if v}
    for k_, v_ in study_counts.items():
        cli_total[k_] += v_
    log(f"run_study, 2 trials of 1 epoch: {time.perf_counter() - t0:.1f} s, "
        f"params {[t.params for t in study.trials]}, values {study.values}, "
        f"best {study.best_value}, launches {study_counts}")
    require(len(study.trials) == 2
            and all(v is not None and 0.0 <= v <= 1.0 for v in study.values)
            and study_counts.get("packed_attention_bwd", 0) > 0,
            "run_study: 2 trials of the objective train through rows 1 and 7")
    del study, s_train, s_val

    cli_run("vit_tiny_cifar100 --on-device",
            ["vit_tiny_cifar100", "--lr", "1e-3", "--on-device"], vit_routes)
    cli_run("vit_tiny_cifar100 --bf16",
            ["vit_tiny_cifar100", "--lr", "1e-3", "--bf16"],
            [("row 1", "bfloat16"), ("row 7", "bfloat16")])
    x_tnt = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (256, 32, 32, 3)).astype(np.uint8))
    y_tnt = np.random.RandomState(5).randint(0, 100, 256).astype(np.int32)
    for key in ("cpvt_cifar100", "cpvtgap_cifar100", "tnt_cifar100"):
        for dtype, flag in (("float32", []), ("bfloat16", ["--bf16"])):
            tnt = key.startswith("tnt")
            routes = ([("row 2", dtype), ("row 2 padded", dtype),
                       ("row 6", dtype), ("row 6 padded", dtype)] if tnt
                      else [("row 1", dtype), ("row 7", dtype)])
            hist = cli_run(f"{key} {dtype}",
                           [key, "--lr", "5e-4" if tnt else "1e-3", *flag],
                           routes)
            model = hist["final_state"].model
            st = trainer.make_train_state(model, lr=0.0)
            step = trainer.train_step_fn(model)
            ones = np.ones(256, np.float32)
            if tnt:
                # 7 layers: an inner (D 12) and an outer (D 128) attention
                # each, forward row 2, backward row 6 at rate 0
                fa.reset_launch_counts()
                with torch.inference_mode():
                    model.eval()(x_tnt.to(dev).float() / 255)
                fwd_counts = dict(fa.LAUNCHES)
                fa.reset_launch_counts()
                step(st, x_tnt, y_tnt, ones)
                torch.cuda.synchronize()
                step_counts = dict(fa.LAUNCHES)
                log(f"cli {key} {dtype}: launches per forward "
                    f"{ {k: v for k, v in fwd_counts.items() if v} }, per "
                    f"train step { {k: v for k, v in step_counts.items() if v} }")
                require(fwd_counts["flash_attention"] == 14
                        and sum(fwd_counts.values()) == 14
                        and step_counts["flash_attention"] == 14
                        and step_counts["dropout_attention_bwd"] == 14
                        and sum(step_counts.values()) == 28,
                        f"{key} {dtype}: 14 row-2 launches a forward, 14 "
                        "row-2 and 14 row-6 launches a train step")
            # one train step at batch 256 of the trained model: host clock
            # (synchronised) and the profiler's busy time and idle share
            t0 = time.perf_counter()
            for _ in range(5):
                step(st, x_tnt, y_tnt, ones)
            torch.cuda.synchronize()
            cli_runs[f"{key} {dtype}"]["step_ms"] = \
                (time.perf_counter() - t0) / 5 * 1e3
            log(f"cli {key} {dtype}: train step B256 "
                f"{cli_runs[f'{key} {dtype}']['step_ms']:.3f} ms (host "
                "clock, 5 steps)")
            log_profile(f"cli {key} {dtype} train step B256",
                        lambda: step(st, x_tnt, y_tnt, ones))
            del model, st, step
            del hist
    hist = cli_run("swin_tiny_cifar100", ["swin_tiny_cifar100"],
                   [("row 10", "float32")])
    swin_cli = cli_runs["swin_tiny_cifar100"]["launches"]
    require(sum(swin_cli.get(k_, 0) for k_ in WINDOW_ROWS) > 0
            and swin_cli.get("window_attention_bwd", 0) > 0,
            "swin_tiny_cifar100 through the window kernels (rows 9-13)")
    del hist

    # the Adam step in one launch a step (row 15) through the CLI's
    # run_reference_main, the trainer's fit(fused=True)
    fa.reset_launch_counts()
    hist = cli.run_reference_main("vit_tiny_cifar100", epochs=1,
                                  batch_size=256, data_root=cifar_root,
                                  lr=1e-3, fused=True, verbose=False)
    fused_counts = {k: v for k, v in fa.LAUNCHES.items() if v}
    for k_, v_ in fused_counts.items():
        cli_total[k_] += v_
    log(f"cli run_reference_main(fused=True): launches {fused_counts}")
    require(fused_counts.get("fused_adam", 0) == hist["final_state"].step
            and np.isfinite(hist["train_loss"][0]),
            "fit(fused=True): one fused_adam launch a step")
    del hist

    # DeiT's distillation against a seeded ViT teacher
    fa.reset_launch_counts()
    teacher = zoo.ViT(**get_args("vit_tiny_cifar100"), seed=21)
    torch.nn.init.normal_(teacher.head.weight, std=0.05)
    student = zoo.DeiT(**get_args("deit_tinydistil_cifar100"), seed=22)
    d_train, d_test = get_train_test_loaders("cifar100", 256,
                                             root_dir=cifar_root)
    hist = student.train_model_with_distillation(
        d_train, d_test, 2, teacher=teacher, distillation_type="hard",
        lr=1e-3, verbose=False)
    distill_counts = {k: v for k, v in fa.LAUNCHES.items() if v}
    for k_, v_ in distill_counts.items():
        cli_total[k_] += v_
    tl = hist["train_loss"]
    log(f"DeiT-Ti distilled from a ViT teacher (hard, alpha 0.5): train "
        f"loss {tl}, test acc {hist['test_accuracy']}, launches "
        f"{distill_counts}")
    require(all(np.isfinite(tl)) and tl[-1] < tl[0]
            and student.distilled_training
            and distill_counts.get("packed_attention_bwd", 0) > 0,
            "distillation: the blended loss falls, through rows 1 and 7")
    del teacher, student, hist, d_train, d_test

    # ImageFolderLoader on the card: ViT-Ti/16 @224 on an image folder
    folder_root = os.path.join(work, "folders")
    write_image_folder(os.path.join(folder_root, "imagenet100"), 4, 16, 64,
                       seed=16)
    fa.reset_launch_counts()
    out = []
    t0 = time.perf_counter()
    require_route("cli vitti16_224_imagenet100 image folder", lambda: out.append(
        cli.main(["vitti16_224_imagenet100", "--epochs", "2",
                  "--batch-size", "16", "--data-root", folder_root, "--lr",
                  "1e-3", "--num-workers", "4"])),
        [("row 1", "float32"), ("row 7", "float32")])
    folder_counts = {k: v for k, v in fa.LAUNCHES.items() if v}
    for k_, v_ in folder_counts.items():
        cli_total[k_] += v_
    log(f"cli vitti16_224_imagenet100 (ImageFolderLoader, 64 + 64 PNGs): "
        f"{time.perf_counter() - t0:.1f} s, train loss "
        f"{out[0]['train_loss']}, launches {folder_counts}")
    require(all(np.isfinite(out[0]["train_loss"])),
            "the image-folder run trains")
    del out

    # run_detection_main: DETR-R50 2 steps at batch 2 on a COCO folder
    coco_root = os.path.join(work, "coco")
    write_coco_folder(coco_root, [(480, 640), (427, 640), (640, 480),
                                  (500, 375)], seed=17)
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    dhist = cli.run_detection_main(coco_root, epochs=1, batch_size=2,
                                   verbose=False)
    det_cli = {k: v for k, v in fa.LAUNCHES.items() if v}
    for k_, v_ in det_cli.items():
        cli_total[k_] += v_
    log(f"cli run_detection_main (DETR-R50, 4 + 4 COCO images, batch 2): "
        f"{time.perf_counter() - t0:.1f} s, loss {dhist['loss']}, metrics "
        f"{dhist['metrics'][-1]}, "
        f"launches {det_cli}")
    require(np.isfinite(dhist["loss"][0]) and dhist["final_state"].step == 2
            and det_cli.get("dropout_attention_fwd", 0) > 0
            and det_cli.get("dropout_attention_bwd", 0) > 0,
            "run_detection_main: 2 finite steps through rows 5 and 6")
    del dhist
    shutil.rmtree(work, ignore_errors=True)
    log(f"cli launches in all: { {k: v for k, v in cli_total.items() if v} }")

    # ---- 7c. parallel at one rank: NCCL and the mesh paths ------------------
    # One process on the one card joins an NCCL group of 1 through
    # init_distributed_mode (torchrun's environment, set here); every mesh
    # path runs its collectives at world 1 with the kernels on, each run's
    # launch counts zeroed just before and read just after it. The multi-rank
    # numerics are held on the CPU (tests/test_torch_port_multiprocess.py):
    # NCCL takes no two ranks on one device.
    import socket

    from vision_transformers_tpu_torch import parallel
    from vision_transformers_tpu_torch.parallel import mesh as pmesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        par_port = sock.getsockname()[1]
    par_env = dict(MASTER_ADDR="localhost", MASTER_PORT=str(par_port),
                   RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    os.environ.update(par_env)
    info = parallel.init_distributed_mode()
    require(info == {"rank": 0, "world_size": 1, "distributed": False}
            and torch.distributed.get_backend() == "nccl",
            f"init_distributed_mode under torchrun's env joins NCCL at world "
            f"1: {info}, backend {torch.distributed.get_backend()}")
    log(f"parallel: NCCL {torch.cuda.nccl.version()} "
        f"group of 1, {info}")
    par_total = {k: 0 for k in fa.LAUNCHES}

    def par_run(label, fn):
        """``fn()`` with the launch counts zeroed just before and read just
        after; returns (its result, the counts, the kernels by name)."""
        torch.cuda.synchronize()
        fa.reset_launch_counts()
        _build.reset_launched()
        out = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in fa.LAUNCHES.items() if v}
        for k, v in got.items():
            par_total[k] += v
        log(f"parallel {label}: launches {got}")
        return out, got, _build.launched()

    def same_state(a, b):
        sa, sb = a.state_dict(), b.state_dict()
        return set(sa) == set(sb) and all(torch.equal(sa[k], sb[k])
                                          for k in sa)

    # fit(ViT-B/16, mesh=(1, 1)): 3 steps at batch 32 in bf16, attention
    # dropout 0.1, fused Adam; losses and weights bit-equal to mesh=None
    dm = parallel.make_mesh((1, 1), ("data", "model"))
    prng = np.random.RandomState(21)
    fit_x = prng.standard_normal((96, 224, 224, 3)).astype(np.float32)
    fit_y = prng.randint(0, args["num_classes"], 96).astype(np.int32)

    class Batches:
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            for i in range(0, self.n, 32):
                yield fit_x[i:i + 32], fit_y[i:i + 32]

    def vit_fit(mesh):
        m = ViT(**dict(args, attention_dropout=0.1), dtype="bfloat16")
        m.load_state_dict(weights)
        h = trainer.fit(m, Batches(96), Batches(32), 1, lr=1e-4, mesh=mesh,
                        verbose=False, seed=5, fused=True)
        return h, m

    (h_plain, m_plain), got_plain, _ = par_run(
        "fit ViT-B/16 mesh=None", lambda: vit_fit(None))
    (h_mesh, m_mesh), got_mesh, names = par_run(
        "fit ViT-B/16 mesh (1, 1)", lambda: vit_fit(dm))
    log(f"parallel fit ViT-B/16: train loss {h_mesh['train_loss']} (mesh) "
        f"{h_plain['train_loss']} (none), test loss {h_mesh['test_loss']}")
    require(all(h_mesh[k] == h_plain[k] for k in
                ("train_loss", "train_accuracy", "test_loss",
                 "test_accuracy")) and same_state(m_mesh, m_plain),
            "fit(mesh=(1, 1)): losses and final weights bit-equal to "
            "mesh=None")
    require(got_mesh == got_plain
            and got_mesh.get("packed_attention") == 12 * 4
            and got_mesh.get("packed_attention_bwd") == 12 * 3
            and got_mesh.get("fused_adam") == 3,
            f"fit ViT-B/16 under the mesh: 12 row-1 launches per forward (3 "
            f"steps + 1 eval batch), 12 row-7 per step, one row 15 a step; "
            f"got {got_mesh}")
    want_names = (ROUTE_NAMES[("row 1", "bfloat16")]
                  + ROUTE_NAMES[("row 7", "bfloat16")] + ("adam_multi_kernel",))
    require(all(names.get(x, 0) > 0 for x in want_names),
            f"fit under the mesh launches {want_names} by name; the launch "
            f"logs saw {names}")

    # the step with and without the mesh: the cost of NCCL at world 1
    xb = torch.from_numpy(fit_x[:32]).to(dev)
    yb = torch.from_numpy(fit_y[:32]).long().to(dev)
    wb = torch.ones(32, device=dev)
    steps = {None: (trainer.train_step_fn(m_plain), h_plain["final_state"]),
             dm: (trainer.train_step_fn(m_mesh, mesh=dm),
                  h_mesh["final_state"])}
    step_ms = {None: [], dm: []}
    for mesh in (None, dm, dm, None, None, dm):
        fn, st = steps[mesh]
        fn(st, xb, yb, wb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            fn(st, xb, yb, wb)
        torch.cuda.synchronize()
        step_ms[mesh].append((time.perf_counter() - t0) / 5 * 1e3)
    dp1 = pmesh.DataParallel(dm)
    grads_ms = cuda_ms(lambda: dp1.all_reduce_grads(
        h_mesh["final_state"].optimizer.params), iters=10)
    n_grad = sum(p.numel() for p in h_mesh["final_state"].optimizer.params)
    logits = torch.zeros(32, args["num_classes"], device=dev)
    gather_ms = cuda_ms(lambda: dp1.gather(logits), iters=10)
    par_times = dict(
        step_ms=float(np.median(step_ms[dm])),
        step_plain_ms=float(np.median(step_ms[None])),
        allreduce_ms=grads_ms, gather_ms=gather_ms)
    log(f"parallel ViT-B/16 bf16 train step, batch 32 (host clock, 3 x 5 "
        f"steps alternating): mesh (1, 1) {step_ms[dm]} ms, none "
        f"{step_ms[None]} ms; the step's gradient all-reduce alone "
        f"({n_grad} fp32 values, one NCCL call) {grads_ms:.4f} ms, the "
        f"logits' all-gather {gather_ms:.4f} ms (device time)")
    del m_plain, m_mesh, h_plain, h_mesh, steps, fit_x

    # fit_detection(DETR-R50, mesh=(1,)): one step at batch 2 (896 x 1344)
    # in bf16, at dropout 0.1 (rows 5, 6) and 0 with USE_PALLAS_BWD (rows 2,
    # 3, 4, 6), equal to the step without a mesh
    d1 = parallel.make_mesh((1,), ("data",))
    for rate in (0.1, 0.0):
        fa.USE_PALLAS_BWD = rate == 0.0
        runs = []
        for mesh in (None, d1):
            m = Detr(**det_cfg, dropout=rate, dtype="bfloat16")
            m.load_state_dict(det_w, strict=True)
            hist, got, _ = par_run(
                f"fit_detection DETR-R50 dropout {rate} mesh "
                f"{None if mesh is None else mesh.shape}",
                lambda m=m, mesh=mesh: fit_detection(
                    m, DetectionLoader(train_ds, 2), 1, num_classes=91,
                    seed=0, verbose=False, mesh=mesh))
            runs.append((hist["loss"], m, got))
        fa.USE_PALLAS_BWD = False
        (l0, m0, g0), (l1, m1, g1) = runs
        require(l0 == l1 and np.isfinite(l1).all() and same_state(m0, m1),
                f"fit_detection(mesh=(1,)) at dropout {rate}: loss {l1} and "
                f"weights bit-equal to mesh=None ({l0})")
        require(g1 == g0 == DETR_TRAIN_LAUNCHES[rate],
                f"fit_detection under the mesh at dropout {rate}: "
                f"{DETR_TRAIN_LAUNCHES[rate]}; got {g1}")
        del m0, m1

    # data-parallel serving artifacts (float and int8) at buckets 1, 8, 32:
    # predict bit-equal to the artifacts exported without a mesh
    smodel = ViT(**args, dtype="bfloat16")
    smodel.load_state_dict(weights)
    par_dir = tempfile.mkdtemp(prefix="vtt_par_")
    img_shape = (args["image_size"], args["image_size"], 3)
    for tag, m in (("bf16", smodel),
                   ("int8", serving.quantize_classifier(smodel))):
        plain_dir = os.path.join(par_dir, tag)
        dp_dir = os.path.join(par_dir, tag + "_dp")
        serving.export_classifier(m, img_shape, plain_dir,
                                  buckets=(1, 8, 32))
        manifest = serving.export_classifier(m, img_shape, dp_dir,
                                             buckets=(1, 8, 32), mesh=d1)
        require(manifest["nr_devices"] == 1
                and manifest["data_axis"] == "data",
                f"{tag} DP manifest: {manifest}")
        a = serving.load_classifier(plain_dir)
        b_ = serving.load_classifier(dp_dir, mesh=d1)
        a.warmup()
        b_.warmup()
        outs, got, _ = par_run(
            f"serving {tag} DP artifact, n = 1, 5, 8, 32, 40",
            lambda b_=b_: [b_.predict(images[:n]) for n in (1, 5, 8, 32, 40)])
        for n, o in zip((1, 5, 8, 32, 40), outs):
            require(torch.equal(o, a.predict(images[:n])),
                    f"{tag} DP artifact: predict({n}) bit-equal to the plain "
                    "artifact's")
        require(got.get("packed_attention") == 12 * 6,
                f"{tag} DP serving: 12 row-1 launches per forward; {got}")
    shutil.rmtree(par_dir, ignore_errors=True)

    # vit_pipeline_forward with one stage: the model's forward, bit for bit
    st1 = parallel.make_mesh((1,), ("stage",))
    x8 = torch.from_numpy(images[:8]).to(dev)
    with torch.inference_mode():
        want = smodel(x8)
    got_pp, got, names = par_run(
        "vit_pipeline_forward ViT-B/16 one stage, batch 8",
        lambda: parallel.vit_pipeline_forward(smodel, None, x8, st1,
                                              n_micro=1))
    require(torch.equal(got_pp, want) and got.get("packed_attention") == 12
            and names.get(ROUTE_NAMES[("row 1", "bfloat16")][0], 0) > 0,
            f"one-stage pipeline: the forward's logits (max err "
            f"{max_err(got_pp, want)}), 12 row-1 launches ({got})")
    del smodel

    # ring attention at the DETR encoder's shape, one hop, COCO key masks,
    # against mha_reference; its time beside row 3's (the streaming kernel)
    sq1 = parallel.make_mesh((1,), ("seq",))
    keep2 = coco_keep(COCO_SIZES[:2])
    q, k, v = (randn(90 + i, 2, 8, 4704, 32, dtype=bf16) for i in range(3))
    ring = parallel.sequence_parallel_attention(q, k, v, sq1, kv_mask=keep2)
    ref = attn.mha_reference(q, k, v, mask=keep2[:, None, None, :])
    ring_err = max_err(ring, ref)
    require(ring.shape == ref.shape and ring_err <= KERNEL_TOL["bfloat16"],
            f"ring attention at B2 H8 S4704 D32 against mha_reference: max "
            f"err {ring_err} (limit {KERNEL_TOL['bfloat16']})")
    ring_ms = cuda_ms(lambda: parallel.sequence_parallel_attention(
        q, k, v, sq1, kv_mask=keep2), iters=5)
    row3_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, kv_mask=keep2),
                      iters=5)
    par_times.update(ring_ms=ring_ms, ring_row3_ms=row3_ms,
                     ring_max_abs_err=ring_err)
    log(f"parallel ring attention B2 H8 S4704 D32 bf16, COCO key masks, one "
        f"hop: {ring_ms:.4f} ms (fp32 matmuls and online softmax), max err "
        f"{ring_err:.3g}; row 3 (flash_attention_large) on the same inputs "
        f"{row3_ms:.4f} ms")
    del q, k, v, ring, ref

    # top-1 MoE with its experts on one rank against the dense oracle
    ex1 = parallel.make_mesh((1,), ("expert",))
    g_ = torch.Generator().manual_seed(23)
    moe = [(torch.randn(*s, generator=g_) * 0.05).to(dev)
           for s in ((768, 8), (8, 768, 3072), (8, 3072), (8, 3072, 768),
                     (8, 768))]
    xt = torch.randn(1024, 768, generator=g_).to(dev)
    moe_err = max_err(parallel.expert_parallel_mlp(xt, *moe, ex1),
                      parallel.moe_mlp_reference(xt, *moe))
    moe_ms = cuda_ms(lambda: parallel.expert_parallel_mlp(xt, *moe, ex1),
                     iters=5)
    require(moe_err <= 1e-5, f"expert_parallel_mlp against moe_mlp_reference "
            f"at T 1024 D 768 H 3072 E 8: max err {moe_err}")
    par_times.update(moe_ms=moe_ms, moe_max_abs_err=moe_err)
    log(f"parallel MoE T1024 D768 H3072 E8 fp32, one rank: {moe_ms:.4f} ms, "
        f"max err {moe_err:.3g} against the dense oracle")
    parallel.destroy_distributed_mode()
    for key in par_env:
        os.environ.pop(key, None)
    log(f"parallel launches in all: { {k: v for k, v in par_total.items() if v} }")
    log(f"parallel times: {json.dumps(par_times)}")

    # ---- 7d. ViT-H/14 and rows 1-7 at every head dim ------------------------
    vith_total, vith_times, vith_errs, vith_numbers = vith_phase(det_keep)
    log(f"ViT-H/14 numbers: {json.dumps(vith_numbers)}")

    # ---- 7e. rows 1-7 above 128, rows 9-13 at dh 1-8, ViT-B3 and Swin-T4 -
    wide_total, wide_times, wide_errs, wide_numbers = wide_phase(det_keep)
    log(f"phase 7e numbers: {json.dumps(wide_numbers)}")

    # ---- 7f. row 8 at every head dim, row 4 at every routed shape, ViT-B3
    # served with USE_FUSED_BLOCK --------------------------------------------
    block_total, block_times, _, block_numbers = fused_phase()
    log(f"phase 7f numbers: {json.dumps(block_numbers)}")

    # ---- 7g. rows 11 and 10 at every head dim the JAX batched plan admits,
    # Swin-T at 2 and 1 heads a stage (dh 48, 96) ----------------------------
    whd_total, whd_times, _, whd_numbers = window_head_dims_phase()
    log(f"phase 7g numbers: {json.dumps(whd_numbers)}")

    # ---- 7h. row 16, the biased backward, at SwinV2-B stage 1 ------------
    bias_numbers = bias_bwd_phase()
    log(f"phase 7h numbers: {json.dumps(bias_numbers)}")

    # ---- 8. times ---------------------------------------------------------
    for b in clf.buckets:
        x = images[:b]
        for _ in range(2):
            clf.predict(x).float().cpu()
        iters = 10
        t0 = time.perf_counter()
        for _ in range(iters):
            clf.predict(x).float().cpu()
        ms = (time.perf_counter() - t0) / iters * 1e3
        log(f"serving bf16 bucket {b}: {ms:.3f} ms per request "
            f"(host numpy in, logits out), {b / ms * 1e3:.1f} images/s")
    with torch.inference_mode():
        xb = torch.from_numpy(images[:32]).to(dev)
        fwd_ms = cuda_ms(lambda: clf.model(xb), iters=10)
    log(f"ViT-B/16 bf16 forward, batch 32, device time: {fwd_ms:.3f} ms "
        f"({32 / fwd_ms * 1e3:.1f} images/s)")
    for b in (1, 32):
        wall, busy, count, top = device_profile(
            lambda: clf.predict(images[:b]).float().cpu())
        if busy is None:
            log(f"profile bucket {b}: the profiler saw no device activity")
            continue
        log(f"profile bucket {b}: wall {wall:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms in {count} activities, idle share "
            f"{1 - busy / wall:.3f}")
        for name, ms, n in top:
            log(f"  {ms:8.3f} ms {n:4d}x {name}")

    served_models = {**{k: v[0] for k, v in swin.items()},
                     **{k: v[0] for k, v in hier.items()}}
    for preset, sclf in served_models.items():
        for b in sclf.buckets:
            x = images[:b]
            for _ in range(2):
                sclf.predict(x).float().cpu()
            iters = 10
            t0 = time.perf_counter()
            for _ in range(iters):
                sclf.predict(x).float().cpu()
            ms = (time.perf_counter() - t0) / iters * 1e3
            log(f"serving {preset} bf16 bucket {b}: {ms:.3f} ms per request "
                f"(host numpy in, logits out), {b / ms * 1e3:.1f} images/s")
        with torch.inference_mode():
            xb = torch.from_numpy(images[:32]).to(dev)
            sfwd_ms = cuda_ms(lambda: sclf.model(xb), iters=10)
        log(f"{preset} bf16 forward, batch 32, device time: {sfwd_ms:.3f} ms "
            f"({32 / sfwd_ms * 1e3:.1f} images/s)")
        for b in (1, 32):
            log_profile(f"{preset} bucket {b}",
                        lambda: sclf.predict(images[:b]).float().cpu())

    # the ViT family served with the flag on and off: ms per request per
    # bucket, host numpy in and logits out
    for label, fam in family.items():
        for flag in (True, False):
            vv.USE_FUSED_BLOCK = flag
            for b in fam["clf"].buckets:
                x = images[:b]
                for _ in range(2):
                    fam["clf"].predict(x).float().cpu()
                t0 = time.perf_counter()
                for _ in range(5):
                    fam["clf"].predict(x).float().cpu()
                ms = (time.perf_counter() - t0) / 5 * 1e3
                log(f"serving {label} bf16 USE_FUSED_BLOCK={flag} bucket {b}: "
                    f"{ms:.3f} ms per request, {b / ms * 1e3:.1f} images/s")
            if label == "vitb16_224_imagenet":
                log_profile(f"{label} USE_FUSED_BLOCK={flag} bucket 32",
                            lambda: fam["clf"].predict(images[:32]).float()
                            .cpu())
    vv.USE_FUSED_BLOCK = False

    kernels = []
    port = "vision_transformers_tpu_torch/csrc/"
    jax_file = "vision_transformers_tpu/ops/flash_attention.py"

    # launches on the hierarchical models' paths: both Swins, PVT and Twins, each
    # served and trained
    path_runs = ([t for _, t, _ in swin.values()]
                 + [la for las, _ in swin_train.values() for la in las.values()]
                 + [got for _, got, _ in hier.values()]
                 + [la for _, _, (las, _) in hier.values()
                    for la in las.values()])
    swin_total = {k: sum(run.get(k, 0) for run in path_runs)
                  for k in fa.LAUNCHES}
    det_total = {k: sum(run.get(k, 0) for run in det_runs)
                 for k in fa.LAUNCHES}
    # the ViT family's serving (flag on and off) and training runs
    fam_total = {k: sum(run.get(k, 0) for run in family_runs)
                 for k in fa.LAUNCHES}

    def sdpa_backward(q, k, v, do, p, mask=None):
        """One call of SDPA's backward through autograd, graph kept."""
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                             dropout_p=p)
        return lambda: torch.autograd.grad(out, (q, k, v), do,
                                           retain_graph=True)

    def entry(name, source, line, launches, err, shape, k_ms, p_ms, l_ms,
              nbytes, flops, *, replaces=jax_file, ops_dtype="bfloat16",
              **extra):
        bnd, by = bound_ms(nbytes, flops, ops_dtype)
        extra["cli_launches"] = cli_total[name]  # phase 7b's runs
        extra["parallel_launches"] = par_total[name]  # phase 7c's runs
        extra["vith_launches"] = vith_total[name]  # phase 7d's model runs
        extra.update(vith_times.get(name, {}))  # phase 7d's dh-80 times
        extra["wide_launches"] = wide_total[name]  # phase 7e's model runs
        extra.update(wide_times.get(name, {}))  # phase 7e's dh-256/8 times
        extra["block_launches"] = block_total[name]  # phase 7f's model runs
        extra.update(block_times.get(name, {}))  # phase 7f's times
        extra["head_dims_launches"] = whd_total[name]  # phase 7g's runs
        extra.update(whd_times.get(name, {}))  # phase 7g's dh-48/96/192 times
        launches += (cli_total[name] + par_total[name] + vith_total[name]
                     + wide_total[name] + block_total[name] + whd_total[name])
        require(launches > 0, f"{name}: launched on its path")
        kernels.append(dict(
            name=name, route="cuda", source=port + source,
            replaces=f"{replaces}:{line}", launches=launches, max_abs_err=err,
            ms=k_ms, plain_ms=p_ms, bound_ms=bnd, bound_by=by,
            library_ms=l_ms, **extra))
        more = "".join(f", {k} {v:.4f}" if isinstance(v, float)
                       else f", {k} {v}" for k, v in extra.items())
        log(f"{name} {shape}: kernel {k_ms:.4f} ms, bound {bnd:.4f} ms "
            f"({by}), plain {p_ms:.4f} ms, library {l_ms:.4f} ms{more}")

    # packed: ViT-B/16 @224, batch 32, bf16 — the serving and training shape
    b, s, h, dh = 32, 197, 12, 64
    rate, seed = 0.1, 2026
    shape = f"B{b} S{s} H{h} dh{dh}"
    qkv = randn(6, b, s, 3 * h * dh, dtype=bf16)
    do = randn(24, b, s, h * dh, dtype=bf16)
    qv, kv, vv = (t.view(b, s, h, dh).transpose(1, 2)
                  for t in qkv.split(h * dh, dim=-1))
    out, lse = fa.packed_flash_attention_fwd(qkv, h, dropout_rate=rate,
                                             seed=seed)
    io_bytes = b * s * h * dh * 2
    # S 192: three whole 64-row and 64-key tiles, where S 197 takes four
    # (the last holding 5 rows and 5 keys): the cost of the padding
    qkv192 = randn(6, b, 192, 3 * h * dh, dtype=bf16)
    p_ms = cuda_ms(lambda: fa.packed_flash_attention_fwd(qkv, h))
    p_drop_ms = cuda_ms(lambda: fa.packed_flash_attention_fwd(
        qkv, h, dropout_rate=rate, seed=seed))
    p_flops = 4 * b * h * s * s * dh
    entry("packed_attention", "packed_attention.cu", 796,
          main_launches["packed_attention"] + tiny_launches["packed_attention"]
          + vitb_launches["packed_attention"] + fam_total["packed_attention"]
          + int8_launches["packed_attention"]
          + sl_launches["packed_attention"],
          max(v for k_, v in errs.items() if k_[0] == "packed_path"), shape,
          p_ms, cuda_ms(lambda: fa.packed_flash_attention_reference(qkv, h)),
          cuda_ms(lambda: F.scaled_dot_product_attention(qv, kv, vv)),
          4 * io_bytes + b * s * h * 4, p_flops,
          tflops=p_flops / p_ms / 1e9, dropout_ms=p_drop_ms,
          dropout_tflops=p_flops / p_drop_ms / 1e9,
          dropout_library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
              qv, kv, vv, dropout_p=rate)),
          s192_ms=cuda_ms(lambda: fa.packed_flash_attention_fwd(qkv192, h)),
          fp32_ms=cuda_ms(lambda: fa.packed_flash_attention_fwd(
              qkv.float(), h)),
          int8_serving_launches=int8_launches["packed_attention"],
          superleaf_launches=sl_launches["packed_attention"],
          int8_serving=int8_serving)
    log(f"  x12 layers = {12 * kernels[-1]['ms']:.3f} ms of the {fwd_ms:.3f} "
        f"ms serving forward; with dropout x12 = "
        f"{12 * kernels[-1]['dropout_ms']:.3f} ms of the {train_fwd_ms:.3f} ms "
        f"training forward; S 192 (3 whole tiles a side) "
        f"{kernels[-1]['s192_ms']:.4f} ms against S 197's {p_ms:.4f} (4 tiles "
        f"a side, {197 ** 2 / 256 ** 2:.3f} of the tile work live)")
    del qkv192
    bwd_args = (qkv, do, out, lse, h)
    bwd_kw = dict(dropout_rate=rate, seed=seed)
    do_h = do.view(b, s, h, dh).transpose(1, 2)
    b_flops = 10 * b * h * s * s * dh
    b_ms = cuda_ms(lambda: fa.packed_flash_attention_bwd(*bwd_args, **bwd_kw))
    b0_ms = cuda_ms(lambda: fa.packed_flash_attention_bwd(*bwd_args))
    entry("packed_attention_bwd", "packed_attention.cu", 833,
          tiny_launches["packed_attention_bwd"]
          + vitb_launches["packed_attention_bwd"]
          + fam_total["packed_attention_bwd"]
          + sl_launches["packed_attention_bwd"],
          max([errs[("packed_bwd", "vitb16@224 B32 S197", "bfloat16", rate)]]
              + [v for k_, v in errs.items() if k_[0] == "packed_bwd_path"]),
          shape + f" rate {rate}", b_ms,
          cuda_ms(lambda: fa.packed_flash_attention_bwd_reference(
              *bwd_args, **bwd_kw), iters=10),
          cuda_ms(sdpa_backward(qv, kv, vv, do_h, rate)),
          8 * io_bytes + b * s * h * 4, b_flops,
          tflops=b_flops / b_ms / 1e9, rate0_ms=b0_ms,
          rate0_tflops=b_flops / b0_ms / 1e9,
          rate0_library_ms=cuda_ms(sdpa_backward(qv, kv, vv, do_h, 0.0)),
          superleaf_launches=sl_launches["packed_attention_bwd"],
          fp32_ms=cuda_ms(lambda: fa.packed_flash_attention_bwd(
              qkv.float(), do.float(), out.float(), lse, h, **bwd_kw),
              iters=5))
    log(f"  x12 layers = {12 * kernels[-1]['ms']:.3f} ms of the "
        f"{train_bwd_ms:.3f} ms training backward")
    del qkv, do, out, lse, bwd_args

    # rows 2 and 6 (bf16, tensor cores) at the paths' own shapes: kernel ms,
    # TFLOP/s of the work the inputs need (row 6 counts the keys its mask
    # attends), and SDPA's ms beside them as the yardstick
    def flash_path_times(key, b, h, s, d, bias_lead):
        q, k, v = (randn(84 + i, b, h, s, d, dtype=bf16) for i in range(3))
        bias = (None if bias_lead is None
                else randn(87, bias_lead, h, s, s, dtype=fp32))
        mask = None if bias is None else bias.to(bf16)
        k_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias))
        return {f"{key}_ms": k_ms,
                f"{key}_tflops": 4 * b * h * s * s * d / k_ms / 1e9,
                f"{key}_sdpa_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask))}

    def drop_path_times(key, b, h, sq, sk, d, key_mask, rate):
        q, k, v, do = (randn(88 + i, b, h, n, d, dtype=bf16)
                       for i, n in enumerate((sq, sk, sk, sq)))
        kw = dict(dropout_rate=rate, seed=4321 + (11 << 34),
                  key_mask=key_mask)
        out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
        k_ms = cuda_ms(lambda: fa.flash_dropout_attention_bwd(
            q, k, v, do, out, lse, **kw), iters=10)
        keys = b * sk if key_mask is None else int(key_mask.sum().item())
        mask = None if key_mask is None else key_mask[:, None, None, :]
        return {f"{key}_ms": k_ms,
                f"{key}_tflops": 10 * h * sq * keys * d / k_ms / 1e9,
                f"{key}_sdpa_ms": cuda_ms(sdpa_backward(q, k, v, do, rate,
                                                        mask), iters=10)}

    def skipped_share(lib, run):
        """The share of 64-key tiles one call of ``run`` skipped, from the
        counters the bf16 kernel of ``lib`` (row 3 or 5) keeps."""
        fa.masked_tile_counts(lib)  # zeroes them
        run()
        walked, held = fa.masked_tile_counts(lib)
        require(held > 0, f"{lib}: the bf16 forward counted its key tiles")
        return 1 - walked / held

    def masked_fwd_times(key, lib, run, q, k, v, keep, kv_valid=None,
                         rate=0.0):
        """A row-3 or row-5 call ``run`` (bf16, tensor cores, library
        ``lib``) at one path shape: kernel ms, its bound, TFLOP/s of the keys
        its masks attend, SDPA's ms on the same inputs (the boolean mask, the
        same rate), and the share of key tiles the kernel skipped."""
        b, h, sq, d = q.shape
        sk = k.shape[2]
        att = (torch.arange(sk, device=dev)
               < (sk if kv_valid is None else kv_valid)).expand(b, sk)
        if keep is not None:
            att = att & keep
        flops = 4 * h * sq * d * int(att.sum())
        nbytes = 2 * b * h * (sq + sk) * d * 2 + b * h * sq * 4 + (
            0 if keep is None else keep.numel() * keep.element_size())
        mask = None if bool(att.all()) else att[:, None, None, :]
        k_ms = cuda_ms(run, iters=5)
        return {f"{key}_ms": k_ms,
                f"{key}_bound_ms": bound_ms(nbytes, flops, "bfloat16")[0],
                f"{key}_tflops": flops / k_ms / 1e9,
                f"{key}_sdpa_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask, dropout_p=rate), iters=5),
                f"{key}_skipped_tiles": skipped_share(lib, run)}

    def tnt_times(kind):
        """Rows 2 ("fwd"), 5 ("drop_fwd", rate 0.1) and 6 ("bwd", rate 0,
        TNT's step) at TNT's two attentions at batch 256, bf16: kernel ms,
        its bound (bytes or operations), SDPA's ms on the same inputs, the
        fp32 kernel's ms, and the launches of the CLI's TNT runs (phase
        7b)."""
        got = {}
        for key, (b, h, s_, d) in (("tnt_inner_d12", (4096, 4, 4, 12)),
                                   ("tnt_outer_d128", (256, 4, 17, 128))):
            q, k, v, do = (randn(120 + i, b, h, s_, d, dtype=bf16)
                           for i in range(4))
            io, lse_b = b * h * s_ * d * 2, b * h * s_ * 4
            if kind == "fwd":
                def run(q=q, k=k, v=v):
                    return fa.flash_attention_fwd(q, k, v)
                lib = lambda: F.scaled_dot_product_attention(q, k, v)
                nbytes, flops = 4 * io + lse_b, 4 * b * h * s_ * s_ * d
            elif kind == "drop_fwd":
                def run(q=q, k=k, v=v):
                    return fa.flash_dropout_attention_fwd(
                        q, k, v, dropout_rate=0.1, seed=5)
                lib = lambda: F.scaled_dot_product_attention(
                    q, k, v, dropout_p=0.1)
                nbytes, flops = 4 * io + lse_b, 4 * b * h * s_ * s_ * d
            else:
                def run(q=q, k=k, v=v, do=do):
                    out_, lse_ = fa.flash_attention_reference(q, k, v)
                    return lambda: fa.flash_dropout_attention_bwd(
                        q, k, v, do, out_, lse_, dropout_rate=0.0, seed=None)
                lib = sdpa_backward(q, k, v, do, 0.0)
                nbytes, flops = 8 * io + lse_b, 10 * b * h * s_ * s_ * d
            fp32_in = [t.float() for t in (q, k, v, do)]
            if kind == "bwd":
                k_fn, k32 = run(), run(*fp32_in)
            else:
                k_fn = run
                k32 = lambda: run(*fp32_in[:3])
            bnd, by = bound_ms(nbytes, flops, "bfloat16")
            got.update({f"{key}_ms": cuda_ms(k_fn), f"{key}_bound_ms": bnd,
                        f"{key}_bound_by": by,
                        f"{key}_library_ms": cuda_ms(lib),
                        f"{key}_fp32_ms": cuda_ms(k32)})
        runs = [r["launches"] for lbl, r in cli_runs.items()
                if lbl.startswith("tnt")]
        name = {"fwd": "flash_attention", "drop_fwd": "dropout_attention_fwd",
                "bwd": "dropout_attention_bwd"}[kind]
        got["tnt_cli_launches"] = sum(r.get(name, 0) for r in runs)
        return got

    # split-head: ViT-B/16 @512, batch 8, bf16 — the S = 1025 paths' shape
    b, h, s, d = 8, 12, 1025, 64
    shape = f"G{b * h} S{s} D{d}"
    q, k, v, do = (randn(7 + i, b, h, s, d, dtype=bf16) for i in range(4))
    io_bytes = b * h * s * d * 2
    lse_bytes = b * h * s * 4
    k_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=10)
    entry("flash_attention", "flash_attention.cu", 75,
          split_launches["flash_attention"]
          + split_train_launches[0.0]["flash_attention"]
          + swin_total["flash_attention"] + det_total["flash_attention"]
          + fam_total["flash_attention"],
          errs[("flash", "vitb16@512 G96 S1025", "bfloat16")], shape, k_ms,
          cuda_ms(lambda: fa.flash_attention_reference(q, k, v), iters=10),
          cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=10),
          4 * io_bytes + lse_bytes, 4 * b * h * s * s * d,
          tflops=4 * b * h * s * s * d / k_ms / 1e9,
          detr_self_err=errs[("flash_path",
                              "detr decoder self B4 G32 S100 D32")],
          **flash_path_times("detr_self", 4, 8, 100, 32, None),
          **flash_path_times("detr_self_bias", 4, 8, 100, 32, 1),
          **tnt_times("fwd"))
    kw = dict(dropout_rate=rate, seed=seed)
    k_ms = cuda_ms(lambda: fa.flash_dropout_attention_fwd(q, k, v, **kw),
                   iters=10)
    # row 5 at the DETR train step's shapes (batch 2, two COCO key masks)
    qd, kd, vd = (randn(95 + i, 2, 8, 4704, 32, dtype=bf16) for i in range(3))
    qdc = randn(96, 2, 8, 100, 32, dtype=bf16)
    dkw = dict(kw, key_mask=det_keep2)
    entry("dropout_attention_fwd", "dropout_attention.cu", 491,
          split_train_launches[0.1]["dropout_attention_fwd"]
          + det_total["dropout_attention_fwd"],
          errs[("drop_fwd", "vitb16@512 G96 S1025", "bfloat16", rate)],
          shape + f" rate {rate}", k_ms,
          cuda_ms(lambda: fa.flash_dropout_attention_reference(q, k, v, **kw),
                  iters=5),
          cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         dropout_p=rate),
                  iters=10),
          4 * io_bytes + lse_bytes, 4 * b * h * s * s * d,
          tflops=4 * b * h * s * s * d / k_ms / 1e9,
          rate0_ms=cuda_ms(lambda: fa.flash_dropout_attention_fwd(
              q, k, v, dropout_rate=0.0, seed=None), iters=10),
          detr_enc_err=errs[("drop_fwd_path", "detr encoder B2 G16 S4704 D32 "
                             "+ COCO key mask")],
          detr_cross_err=errs[("drop_fwd_path", "detr cross B2 G16 Sq100 "
                               "Sk4704 D32 + COCO key mask")],
          **masked_fwd_times("detr_enc", "dropout_attention",
                             lambda: fa.flash_dropout_attention_fwd(
                                 qd, kd, vd, **dkw),
                             qd, kd, vd, det_keep2, rate=rate),
          **masked_fwd_times("detr_cross", "dropout_attention",
                             lambda: fa.flash_dropout_attention_fwd(
                                 qdc, kd, vd, **dkw),
                             qdc, kd, vd, det_keep2, rate=rate),
          **tnt_times("drop_fwd"))
    del qd, kd, vd, qdc
    out, lse = fa.flash_dropout_attention_fwd(q, k, v, **kw)
    bwd_args = (q, k, v, do, out, lse)
    k_ms = cuda_ms(lambda: fa.flash_dropout_attention_bwd(*bwd_args, **kw),
                   iters=10)
    entry("dropout_attention_bwd", "dropout_attention.cu", 525,
          split_train_launches[0.1]["dropout_attention_bwd"]
          + split_train_launches[0.0]["dropout_attention_bwd"]
          + swin_total["dropout_attention_bwd"]
          + det_total["dropout_attention_bwd"]
          + fam_total["dropout_attention_bwd"],
          errs[("drop_bwd", "vitb16@512 G96 S1025", "bfloat16", rate)],
          shape + f" rate {rate}", k_ms,
          cuda_ms(lambda: fa.flash_dropout_attention_bwd_reference(
              *bwd_args, **kw), iters=5),
          cuda_ms(sdpa_backward(q, k, v, do, rate), iters=10),
          8 * io_bytes + lse_bytes, 10 * b * h * s * s * d,
          rate0_ms=cuda_ms(lambda: fa.flash_dropout_attention_bwd(
              *bwd_args, dropout_rate=0.0, seed=None), iters=10),
          tflops=10 * b * h * s * s * d / k_ms / 1e9,
          detr_enc_err=errs[("drop_path", "detr encoder B2 G16 S4704 D32 "
                             "+ COCO key mask")],
          pvt_err=errs[("drop_path", "pvt stage 1 B32 G32 Sq3136 Sk49 D64")],
          **drop_path_times("detr_enc", 2, 8, 4704, 4704, 32,
                            coco_keep(COCO_SIZES[:2]), 0.1),
          **drop_path_times("pvt", 32, 1, 3136, 49, 64, None, 0.0),
          **tnt_times("bwd"))


    # the window kernels, each at its largest launch on the two Swin paths
    def split_heads(qkv, h):
        """(G, N, 3·H·dh) → contiguous q, k, v (G, H, N, dh), not timed."""
        g, n, c3 = qkv.shape
        return (t.reshape(g, n, h, c3 // (3 * h)).transpose(1, 2).contiguous()
                for t in qkv.split(c3 // 3, dim=-1))

    def window_bytes_flops(g, n, h, dh, nwp):
        """qkv read once, out written once, the bias once (bf16)."""
        return ((4 * g * n * h * dh + nwp * h * n * n) * 2,
                4 * g * h * n * n * dh)

    def median_ms(fn, reps=5, **kw):
        """The median of ``reps`` timings of ``fn`` (cuda_ms): the library
        calls of rows 9-13, whose times moved between runs (row 10's SDPA
        backward 0.31 and 0.76 ms in two calls)."""
        return float(np.median([cuda_ms(fn, **kw) for _ in range(reps)]))

    def window_entry(name, line, label, g, n, h, dh, nwp, other, **more):
        qkv, bias = window_inputs(g, n, h, dh, nwp, bf16)
        q, k, v = split_heads(qkv, h)
        mask = bias.to(bf16).repeat(g // nwp, 1, 1, 1)
        nbytes, flops = window_bytes_flops(g, n, h, dh, nwp)
        fn, other_fn = getattr(fa, name), getattr(fa, other)
        entry(name, "window_attention.cu", line, swin_total[name],
              errs[(name, label, "bfloat16")],
              f"G{g} N{n} H{h} dh{dh} nW'{nwp}",
              cuda_ms(lambda: fn(qkv, bias, h)),
              cuda_ms(lambda: fa.window_attention_reference(qkv, bias, h)),
              median_ms(lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=mask)),
              nbytes, flops,
              **{f"{other}_ms": cuda_ms(lambda: other_fn(qkv, bias, h))},
              device_ms=queued_ms([lambda: fn(qkv, bias, h)])[0], **more)

    # row 9: fp32 (the CUDA cores), and the cost of padding 49 keys to the
    # tensor-core kernel's 64: Swin-T's stage 1 (N 49) against SwinV2-T's
    # (N 64) at the same 100 352 tokens, in ms per 10^6 tokens
    qkv, bias = window_inputs(1568, 64, 3, 32, 49, fp32)
    row9_fp32_ms = cuda_ms(lambda: fa.window_packed_attention(qkv, bias, 3))
    qkv, bias = window_inputs(2048, 49, 3, 32, 64, bf16)
    n49_ms = cuda_ms(lambda: fa.window_packed_attention(qkv, bias, 3))
    del qkv, bias
    window_entry("window_packed_attention", 1295,
                 "swinv2-t s1 G1568 N64 H3 nW'49", 1568, 64, 3, 32, 49,
                 "window_batched_attention", fp32_ms=row9_fp32_ms,
                 n49_g2048_ms=n49_ms,
                 n49_ms_per_mtok=n49_ms / (2048 * 49) * 1e6)
    k9 = kernels[-1]
    k9["n64_ms_per_mtok"] = k9["ms"] / (1568 * 64) * 1e6
    log(f"  padding: N 49 (G 2048, 64 keys a tile) {n49_ms:.4f} ms = "
        f"{k9['n49_ms_per_mtok']:.4f} ms per 10^6 tokens against N 64 (G "
        f"1568) {k9['ms']:.4f} ms = {k9['n64_ms_per_mtok']:.4f}; the padded "
        f"keys are {1 - 49 / 64:.3f} of N 49's key tiles")
    # row 11: fp32 (the CUDA cores)
    qkv, bias = window_inputs(2048, 49, 3, 32, 1, fp32)
    row11_fp32_ms = cuda_ms(lambda: fa.window_batched_attention(qkv, bias, 3))
    del qkv, bias
    window_entry("window_batched_attention", 1708,
                 "swin-t s1 G2048 N49 H3 shared", 2048, 49, 3, 32, 1,
                 "window_packed_attention", fp32_ms=row11_fp32_ms)

    def fused_times(kind, b, hw, win, shift, h, dh, per_window, dtype=bf16):
        """ms of the fused kernel of ``kind`` on a seeded map back to back
        and as device time (queued_ms: the wrapper's host time, some 50 µs,
        is near the kernel's at these shapes), and the inputs."""
        qkv, bias, nwp = fused_inputs(b, hw, win, h, dh, per_window, dtype)
        plan = fused_plans(b, hw, win, h, dh, nwp)[kind]
        window, sh = (win, win), (shift, shift)
        call = lambda: fa.fused_window_attention(  # noqa: E731
            qkv, bias, h, window, sh, plan=plan)
        return cuda_ms(call), queued_ms([call])[0], qkv, bias, nwp

    def fused_entry(kind, line, label, b, hw, win, shift, h, dh, **more):
        name = f"window_fused_{kind}_attention"
        other = "flat" if kind == "slab" else "slab"
        k_ms, k_dev, qkv, bias, nwp = fused_times(kind, b, hw, win, shift, h,
                                                  dh, True)
        plans = fused_plans(b, hw, win, h, dh, nwp)
        g = b * nwp
        mask = bias.to(bf16).repeat(b, 1, 1, 1)
        window, sh = (win, win), (shift, shift)

        def chain():
            """The same function from library calls: roll, partition, head
            split, SDPA with the bias as its mask, merge, reverse, roll."""
            x = torch.roll(qkv, shifts=(-shift, -shift), dims=(1, 2))
            q, k, v = split_heads(windows.window_partition(x, win, win), h)
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            o = o.transpose(1, 2).reshape(g, win * win, h * dh)
            o = windows.window_reverse(o, win, win, hw, hw)
            return torch.roll(o, shifts=(shift, shift), dims=(1, 2))

        # the library chain rounds at SDPA's own points, not the TPU
        # kernels', so it keeps its own, looser limit
        e = max_err(chain(), fa.window_fused_reference(qkv, bias, h, window, sh))
        require(e <= LIBRARY_WINDOW_TOL,
                f"the library chain computes the fused function ({e:.3e})")
        nbytes, flops = window_bytes_flops(g, win * win, h, dh, nwp)
        entry(name, "window_fused_attention.cu", line, swin_total[name],
              errs[(name, label, shift, "bfloat16")],
              f"B{b} {hw}x{hw} win{win} shift{shift} H{h} dh{dh} nW'{nwp}",
              k_ms,
              cuda_ms(lambda: fa.window_fused_reference(qkv, bias, h, window,
                                                        sh)),
              median_ms(chain), nbytes, flops, device_ms=k_dev,
              fp32_ms=fused_times(kind, b, hw, win, shift, h, dh, True,
                                  fp32)[0],
              **({f"{other}_same_map_ms": cuda_ms(
                  lambda: fa.fused_window_attention(
                      qkv, bias, h, window, sh, plan=plans[other]))}
                 if other in plans else {}), **more)

    # row 12 at Swin-T's stage 3 (B 32, 14 x 14, H 12), which takes 6 of its
    # 7 launches a forward: shifted (nW' 4) and unshifted (nW' 1)
    s3 = {}
    for sh_ in (3, 0):
        s3[f"s3_shift{sh_}_ms"], s3[f"s3_shift{sh_}_device_ms"] = fused_times(
            "flat", 32, 14, 7, sh_, 12, 32, sh_ > 0)[:2]
    fused_entry("flat", 1997, "swin-t s2 B32 28x28 H6", 32, 28, 7, 3, 6, 32,
                **s3)
    fused_entry("slab", 2056, "swin-t s1 B32 56x56 H3", 32, 56, 7, 3, 3, 32)

    # the window backward at its largest launch: Swin-T stage 1, batch 32
    g, n, h, dh, nwp = 2048, 49, 3, 32, 1
    qkv, bias = window_inputs(g, n, h, dh, nwp, bf16)
    do = randn(34, g, n, h * dh, dtype=bf16)
    q, k, v = split_heads(qkv, h)
    do_h = do.reshape(g, n, h, dh).transpose(1, 2).contiguous()
    mask = bias.to(bf16).repeat(g // nwp, 1, 1, 1)

    def sdpa_masked_backward(bias_grad):
        """SDPA's backward with the bias as its mask, graph kept. With
        ``bias_grad`` the (nW', H, N, N) bias is a leaf repeated over the
        windows, so the backward also gives its gradient, the score gradient
        summed over the windows that share a bias row, as _reduce_window_ds
        sums the kernel's ds: the kernel's function. Without, no bias
        gradient."""
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        m = mask
        if bias_grad:
            leaves.append(bias.to(bf16).requires_grad_())
            m = leaves[-1].repeat(g // nwp, 1, 1, 1)
        out = F.scaled_dot_product_attention(*leaves[:3], attn_mask=m)
        return lambda: torch.autograd.grad(out, leaves, do_h,
                                           retain_graph=True)

    io = g * n * h * dh * 2
    ds_ = torch.ones(g, h, n, n, dtype=bf16, device=dev)
    qkv32, do32 = qkv.float(), do.float()
    bias_c, dqkv_ = bias.to(bf16), torch.empty_like(qkv)
    bwd_lib = _build.load("window_attention_bwd")

    def row10_kernel(ds):
        """The kernel alone, as window_attention_bwd launches it (its C
        entry, the bias already in bf16), ds written or not, no sum after
        it."""
        rc = bwd_lib.window_attention_bwd(
            qkv.data_ptr(), bias_c.data_ptr(), do.data_ptr(), dqkv_.data_ptr(),
            None if ds is None else ds.data_ptr(), g, n, h, dh, nwp,
            dh ** -0.5, *fa.window_bwd_plan(g, n, h, dh), 1,
            torch.cuda.current_stream().cuda_stream)
        _build.check(bwd_lib, "window_attention_bwd", rc)
    entry("window_attention_bwd", "window_attention_bwd.cu", 1466,
          swin_total["window_attention_bwd"],
          errs[("window_attention_bwd", "swin-t s1 G2048 N49 H3 shared",
                "bfloat16")],
          f"G{g} N{n} H{h} dh{dh} nW'{nwp} bf16, dbias wanted",
          cuda_ms(lambda: fa.window_attention_bwd(qkv, bias, do, h)),
          cuda_ms(lambda: fa.window_attention_bwd_reference(qkv, bias, do, h),
                  iters=10),
          median_ms(sdpa_masked_backward(True)),
          # qkv and do read, dqkv written, the bias read, ds written
          7 * io + nwp * h * n * n * 2 + g * h * n * n * 2,
          10 * g * h * n * n * dh,
          no_dbias_ms=cuda_ms(lambda: fa.window_attention_bwd(
              qkv, bias, do, h, need_dbias=False)),
          library_no_dbias_ms=median_ms(sdpa_masked_backward(False)),
          # of ms: the fp32 sum of ds over the windows that share a bias
          # row, in plain PyTorch after the kernel (_reduce_window_ds)
          reduce_ds_ms=cuda_ms(lambda: fa._reduce_window_ds(ds_, bias)),
          kernel_ds_ms=cuda_ms(lambda: row10_kernel(ds_)),
          kernel_no_ds_ms=cuda_ms(lambda: row10_kernel(None)),
          fp32_ms=cuda_ms(lambda: fa.window_attention_bwd(
              qkv32, bias, do32, h), iters=5))
    k10 = kernels[-1]
    log(f"  the bias gradient: {1 - k10['no_dbias_ms'] / k10['ms']:.3f} of the "
        f"wrapper's time, {k10['reduce_ds_ms']:.4f} ms of it the sum of ds "
        f"after the kernel; the kernel alone {k10['kernel_ds_ms']:.4f} ms "
        f"writing ds, {k10['kernel_no_ds_ms']:.4f} without (ds "
        f"{g * h * n * n * 2 / 1e6:.1f} MB of the "
        f"{k10['bound_ms'] * HBM_BYTES_PER_S / 1e9:.1f} MB it moves); SDPA's "
        f"backward {k10['library_ms']:.4f} ms with the bias gradient, "
        f"{k10['library_no_dbias_ms']:.4f} without")
    sw_t = swin_train["swint_224_imagenet"][1][True]
    log(f"  the 12 launches of a Swin-T step are part of its {sw_t[2]:.3f} ms "
        "backward")
    del qkv, bias, do, q, k, v, do_h, mask, ds_, qkv32, do32, bias_c, dqkv_

    # the multi-tensor Adam kernel (row 15) on Swin-T's largest leaf (stage
    # 4's fc1, 768 x 3072: ViT-B/16's fc1 too), device time with L2 cold, as
    # a step over all the leaves finds each leaf, and warm (the 38 MB leaf
    # fits the 50 MB L2); then the optimizer step over all of Swin-T's and
    # of ViT-B/16's leaves, fused (one launch), unfused (torch._foreach_*)
    # and torch.optim.Adam(fused=True) on the same tensors: device time,
    # back to back, and the host's enqueue time
    leaf = [randn(60 + i, 768, 3072, dtype=fp32) * sc
            for i, sc in enumerate((1.0, 0.0, 0.0, 0.01))]
    sc = fadam.adam_scalars(5, 1e-4)
    one = fadam.FusedAdamLeaves(*([t] for t in leaf[:3]))

    def one_leaf():
        one.update(leaf[3:], 5, 1e-4)

    lib_p = leaf[0].clone().requires_grad_()
    lib_p.grad = leaf[3].clone()
    lib_opt = torch.optim.Adam([lib_p], lr=1e-4, fused=True)
    n_el = leaf[0].numel()

    def host_ms(fn, iters=10):
        """Host ms of one call of ``fn``: the clock around ``iters`` calls
        with no synchronisation between them (what the host spends to
        enqueue, while the card keeps up)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        ms = (time.perf_counter() - t0) / iters * 1e3
        torch.cuda.synchronize()
        return ms

    def optimizer_times(model_name, params):
        for p_ in params:
            p_.grad = torch.full_like(p_, 1e-3)
        times = {}
        for label, tx in (
                ("fused", make_optimizer("adam", 1e-4, fused=True)
                 .init(params)),
                ("unfused", make_optimizer("adam", 1e-4).init(params)),
                ("library", torch.optim.Adam(params, lr=1e-4, fused=True))):
            times[f"{model_name}_{label}_device_ms"] = queued_ms(
                [tx.step], reps=5)[0]
            times[f"{model_name}_{label}_cold_device_ms"] = cold_ms(
                tx.step, reps=5)
            times[f"{model_name}_{label}_ms"] = cuda_ms(tx.step, iters=10)
            times[f"{model_name}_{label}_host_ms"] = host_ms(tx.step)
        n_all = sum(p_.numel() for p_ in params)
        times[f"{model_name}_bound_ms"] = 7 * 4 * n_all / HBM_BYTES_PER_S * 1e3
        log(f"optimizer step over {model_name}'s {len(params)} leaves "
            f"({n_all} elements): " + ", ".join(
                f"{k.removeprefix(model_name + '_')} {v:.4f}"
                for k, v in times.items()))
        for p_ in params:
            p_.grad = None
        return times

    opt_times = optimizer_times("swin_t", list(adam_model.parameters()))
    vit_adam = ViT(**get_args("vitb16_224_imagenet"))
    opt_times |= optimizer_times("vit_b16", list(vit_adam.parameters()))
    del vit_adam
    entry("fused_adam", "fused_adam.cu", 36,
          swin_total["fused_adam"] + sl_launches["fused_adam"],
          max(v for k, v in errs.items() if k[0] == "fused_adam"),
          f"one fp32 leaf of {n_el} elements (device time, L2 cold)",
          cold_ms(one_leaf),
          cuda_ms(lambda: fadam.fused_adam_reference(*leaf, sc)),
          cold_ms(lib_opt.step),
          7 * 4 * n_el, 12 * n_el,
          replaces="vision_transformers_tpu/ops/fused_adam.py",
          ops_dtype="float32", warm_device_ms=queued_ms([one_leaf])[0],
          back_to_back_ms=cuda_ms(one_leaf),
          library_warm_device_ms=queued_ms([lib_opt.step])[0],
          library_back_to_back_ms=cuda_ms(lib_opt.step), **opt_times,
          superleaf_launches=sl_launches["fused_adam"],
          **{f"superleaf_{k}": v for k, v in superleaf_times.items()})
    # the streaming forward at the DETR-R50 encoder's eval shape (batch 4 at
    # 896 x 1344), beside its cross shape, the kv_valid shape, the ViT-B
    # S 1297 shape and T2T-ViT_t-14's tokens; the bound counts the keys this
    # data attends (masked keys need no work)
    b, h, s, d = 4, 8, 4704, 32
    q, k, v = (randn(80 + i, b, h, s, d, dtype=bf16) for i in range(3))
    qc = randn(83, b, h, 100, d, dtype=bf16)
    qs3 = randn(79, 2, 8, 300, d, dtype=bf16)
    qv, kv, vv = (randn(84 + i, 2, 12, 1297, 64, dtype=bf16)
                  for i in range(3))
    qt, kt, vt = (randn(87 + i, 32, 1, 3136, 64, dtype=bf16)
                  for i in range(3))
    n_keys = int(det_keep.sum())
    sdpa_mask = det_keep[:, None, None, :]
    io_bytes = b * h * s * d * 2
    k_ms = cuda_ms(lambda: fa.flash_attention_large_fwd(q, k, v,
                                                        kv_mask=det_keep),
                   iters=5)
    large = fa.flash_attention_large_fwd
    entry("flash_attention_large", "flash_attention_large.cu", 229,
          det_total["flash_attention_large"]
          + fam_total["flash_attention_large"],
          errs[("large", "detr-r50 encoder B4 G32 S4704 D32", "bfloat16")],
          f"G{b * h} S{s} D{d}, the key masks of {COCO_SIZES}", k_ms,
          cuda_ms(lambda: fa.flash_attention_large_reference(
              q, k, v, kv_mask=det_keep), iters=3),
          cuda_ms(lambda: F.scaled_dot_product_attention(
              q, k, v, attn_mask=sdpa_mask), iters=5),
          4 * io_bytes + b * h * s * 4 + det_keep.numel(),
          4 * h * s * n_keys * d,
          tflops=4 * h * s * n_keys * d / k_ms / 1e9,
          skipped_tiles=skipped_share("flash_attention_large", lambda: large(
              q, k, v, kv_mask=det_keep)),
          t2t_err=errs[("large", "t2t-vit_t-14 tokens B32 G32 S3136 D64 no "
                        "mask", "bfloat16")],
          **masked_fwd_times("cross_sq100", "flash_attention_large",
              lambda: large(
              qc, k, v, kv_mask=det_keep), qc, k, v, det_keep),
          **masked_fwd_times("kv_valid4600_sq300", "flash_attention_large",
              lambda: large(
              qs3, k[:2], v[:2], kv_mask=det_keep[:2], kv_valid=4600),
              qs3, k[:2], v[:2], det_keep[:2], kv_valid=4600),
          **masked_fwd_times("vitb_s1297", "flash_attention_large",
              lambda: large(qv, kv, vv),
                             qv, kv, vv, None),
          **masked_fwd_times("t2t_s3136", "flash_attention_large",
              lambda: large(qt, kt, vt),
                             qt, kt, vt, None))
    log(f"  x6 encoder layers = {6 * kernels[-1]['ms']:.3f} ms of the "
        f"{det_eval['bfloat16']['fwd_ms']:.3f} ms bf16 eval forward at batch 4")
    del q, k, v, qc, qs3, qv, kv, vv, qt, kt, vt

    # the small-S backward at the DETR decoder's self attention in a train
    # step (batch 2), beside ViT-B/16's S 197 at batch 32
    def small_bwd_inputs(seed, b, h, s, d):
        q, k, v, do = (randn(seed + i, b, h, s, d, dtype=bf16)
                       for i in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v)
        return q, k, v, out, lse, do

    def row6(q, k, v, out, lse, do):
        return fa.flash_dropout_attention_bwd(q, k, v, do, out, lse,
                                              dropout_rate=0.0, seed=None)

    dargs = small_bwd_inputs(88, 2, 8, 100, 32)
    vargs = small_bwd_inputs(92, 32, 12, 197, 64)
    g, s, d = 16, 100, 32
    k_ms = cuda_ms(lambda: fa.flash_attention_bwd(*dargs))
    v_ms = cuda_ms(lambda: fa.flash_attention_bwd(*vargs))
    # device time with the stream kept full: at the decoder's shape the
    # back-to-back calls are paced by the host
    d_ms = queued_ms([lambda: fa.flash_attention_bwd(*dargs),
                     sdpa_backward(*dargs[:3], dargs[5], 0.0),
                     lambda: row6(*dargs),
                     lambda: fa.flash_attention_bwd(*vargs),
                     sdpa_backward(*vargs[:3], vargs[5], 0.0),
                     lambda: row6(*vargs)])
    entry("flash_attention_bwd", "flash_attention_bwd.cu", 362,
          det_total["flash_attention_bwd"],
          errs[("small_bwd", "detr decoder self B2 G16 S100 D32",
                "bfloat16")],
          f"G{g} S{s} D{d}", k_ms,
          cuda_ms(lambda: fa.flash_attention_bwd_reference(*dargs)),
          cuda_ms(sdpa_backward(*dargs[:3], dargs[5], 0.0)),
          8 * g * s * d * 2 + g * s * 4, 10 * g * s * s * d,
          row6_rate0_ms=cuda_ms(lambda: row6(*dargs)),
          device_ms=d_ms[0], library_device_ms=d_ms[1], row6_device_ms=d_ms[2],
          tflops=10 * g * s * s * d / d_ms[0] / 1e9,
          vitb_g384_s197_ms=v_ms,
          vitb_g384_s197_tflops=10 * 384 * 197 * 197 * 64 / v_ms / 1e9,
          vitb_g384_s197_row6_ms=cuda_ms(lambda: row6(*vargs)),
          vitb_g384_s197_library_ms=cuda_ms(
              sdpa_backward(*vargs[:3], vargs[5], 0.0)),
          vitb_g384_s197_device_ms=d_ms[3],
          vitb_g384_s197_library_device_ms=d_ms[4],
          vitb_g384_s197_row6_device_ms=d_ms[5],
          vitb_g384_s197_bound_ms=bound_ms(8 * 384 * 197 * 64 * 2
                                           + 384 * 197 * 4,
                                           10 * 384 * 197 * 197 * 64,
                                           "bfloat16")[0])
    del dargs, vargs

    # the fused LayerNorm + Dense at benchmarks/ln_fused.py's ViT-B shapes,
    # batch 32: [ln_1 + QKV], with [ln_2 + fc1 + GELU] beside it; the
    # library call is F.layer_norm -> F.linear (+ F.gelu)
    r, d = 32 * 197, 768
    qkv_in = dense_inputs(150, r, d, 2304, bf16)
    fc1_in = dense_inputs(155, r, d, 3072, bf16)
    gelu = dict(activation="gelu_tanh")

    def ln_bytes(n):
        """x read, W read, out written (bf16); gamma, beta, bias (fp32)."""
        return (r * d + d * n + r * n) * 2 + (2 * d + n) * 4

    l_ms = cuda_ms(lambda: fdense.ln_dense_fwd(*qkv_in))
    l_gelu_ms = cuda_ms(lambda: fdense.ln_dense_fwd(*fc1_in, **gelu))
    x_, g_, b_, w_, bias_ = qkv_in
    w_t = w_.t().contiguous().t()  # torch's (out, in) weight, transposed
    entry("ln_dense", "ln_dense.cu", 72, ln_chain_launches["ln_dense"],
          max(v for k, v in errs.items() if k[0] == "ln_dense"
              and k[-1] == "bfloat16"),
          f"R{r} D{d} N2304 [ln_1 + QKV]", l_ms,
          cuda_ms(lambda: fdense.ln_dense_reference(*qkv_in)),
          cuda_ms(lambda: base_ln_dense(*qkv_in)),
          ln_bytes(2304), 2 * r * d * 2304,
          replaces="vision_transformers_tpu/ops/fused_dense.py",
          tflops=2 * r * d * 2304 / l_ms / 1e9,
          out_in_ms=cuda_ms(lambda: fdense.ln_dense_fwd(x_, g_, b_, w_t,
                                                        bias_)),
          fp32_ms=cuda_ms(lambda: fdense.ln_dense_fwd(
              x_.float(), g_, b_, w_.float(), bias_)),
          fc1_gelu_ms=l_gelu_ms,
          fc1_gelu_tflops=2 * r * d * 3072 / l_gelu_ms / 1e9,
          fc1_gelu_plain_ms=cuda_ms(lambda: fdense.ln_dense_reference(
              *fc1_in, **gelu)),
          fc1_gelu_library_ms=cuda_ms(lambda: base_ln_dense(*fc1_in, **gelu)),
          fc1_gelu_bound_ms=bound_ms(ln_bytes(3072), 2 * r * d * 3072,
                                     "bfloat16")[0],
          chain_fused_ms=chain_ms["fused"], chain_base_ms=chain_ms["base"])
    del qkv_in, fc1_in, x_, w_, w_t

    # the fused attention sub-block at ViT-B/16 @224, batch 32, beside bucket
    # 1 and T2T-ViT-14's 6 heads; the library chain is LN -> F.linear ->
    # SDPA -> F.linear + residual

    def block_cost(b, s, hd):
        """(bytes, FLOPs): x read, the weights read, out written (bf16), the
        fp32 rows; the two projections and the attention products."""
        return ((2 * b * s * hd + 4 * hd * hd) * 2 + 6 * hd * 4,
                2 * b * s * hd * 4 * hd + 4 * b * s * s * hd)

    blk = block_inputs(randn, 160, 32, 197, 768, bf16)
    blk1 = block_inputs(randn, 161, 1, 197, 768, bf16)
    blk_t2t = block_inputs(randn, 162, 32, 197, 384, bf16)
    casts = [torch.zeros(n, 768, device=dev) for n in (2304, 768)]
    vit_fam = family["vitb16_224_imagenet"]
    block_fwd = fa.fused_attention_block_fwd
    block_phases = fa._measure_fused_block_phases  # ordinary launches
    # the kernel's device time in one cooperative launch, and in ordered
    # launches of one phase each, at ViT-B B 32: what the one launch spends
    # beyond its phases run alone is its wait at the grid barriers (and the
    # tail of each phase's last wave, which the barrier makes every block
    # wait out); beside them rows 14 and 1 alone at the same shapes (row 14
    # with its statistics launch)
    x_rows = blk[0].reshape(-1, 768)
    qkv_blk = fdense.ln_dense_fwd(x_rows, blk[1], blk[2], blk[3], blk[4])
    dev_ms = queued_ms(
        [lambda: block_fwd(*blk, 12)]
        + [lambda p=p: block_phases(*blk, 12, (p,)) for p in range(4)]
        + [lambda: block_phases(*blk, 12, (0, 1, 2, 3)),
           lambda: fdense.ln_dense_fwd(x_rows, blk[1], blk[2], blk[3],
                                       blk[4]),
           lambda: fa.packed_flash_attention_fwd(
               qkv_blk.view(32, 197, 2304), 12),
           lambda: block_fwd(*blk1, 12), lambda: block_fwd(*blk_t2t, 6)])
    one, phases, ordered, row14, row1 = (dev_ms[:1], dev_ms[1:5], dev_ms[5],
                                         dev_ms[6], dev_ms[7])
    log(f"row 8 at ViT-B B 32, device time: one launch {one[0]:.4f} ms; "
        f"its phases launched alone {', '.join(f'{t:.4f}' for t in phases)} "
        f"ms (statistics, LN + QKV, attention, out-projection), sum "
        f"{sum(phases):.4f}; wait at the barriers {one[0] - sum(phases):.4f} "
        f"ms; rows 14 + 1 alone {row14:.4f} + {row1:.4f} ms, with the "
        f"out-projection {row14 + row1 + phases[3]:.4f} ms; the four phases "
        f"in one call of ordered launches {ordered:.4f} ms")
    # the tensor-core route against the CUDA-core one, which the route rule
    # gives weights in two layouts
    mixed = (*blk[:5], blk[5].t().contiguous().t(), blk[6])
    require(fa.fused_block_route(bf16, 768, 12, (*mixed[3].stride(),
                                                 *mixed[5].stride()))
            == "cuda_cores", "row 8: mixed weight layouts take the CUDA "
            "cores by the route rule")
    entry("fused_attention_block", "fused_block.cu", 1028,
          fam_total["fused_attention_block"],
          max(v for k, v in errs.items() if k[0] == "fused_block"
              and k[-1] == "bfloat16"),
          "B32 S197 H12 dh64 (ViT-B/16)",
          cuda_ms(lambda: block_fwd(*blk, 12)),
          cuda_ms(lambda: fa.fused_attention_block_reference(*blk, 12)),
          cuda_ms(lambda: library_block(*blk, 12)),
          *block_cost(32, 197, 768),
          tflops=block_cost(32, 197, 768)[1] / one[0] / 1e9,
          device_ms=one[0], ordered_ms=ordered,
          **{f"phase{i}_ms": t for i, t in enumerate(phases)},
          barrier_wait_ms=one[0] - sum(phases),
          row14_row1_outproj_ms=row14 + row1 + phases[3],
          ordered_back_to_back_ms=cuda_ms(
              lambda: block_phases(*blk, 12, (0, 1, 2, 3))),
          cuda_core_ms=cuda_ms(lambda: block_fwd(*mixed, 12), iters=5),
          bucket1_ms=cuda_ms(lambda: fa.fused_attention_block_fwd(*blk1, 12)),
          bucket1_device_ms=dev_ms[8],
          bucket1_library_ms=cuda_ms(lambda: library_block(*blk1, 12)),
          bucket1_bound_ms=bound_ms(*block_cost(1, 197, 768), "bfloat16")[0],
          t2t14_ms=cuda_ms(lambda: fa.fused_attention_block_fwd(*blk_t2t, 6)),
          t2t14_device_ms=dev_ms[9],
          t2t14_library_ms=cuda_ms(lambda: library_block(*blk_t2t, 6)),
          t2t14_bound_ms=bound_ms(*block_cost(32, 197, 384), "bfloat16")[0],
          weight_casts_per_layer_ms=cuda_ms(
              lambda: [c.to(bf16) for c in casts]),
          vitb_forward_fused_ms=vit_fam["fused_ms"],
          vitb_forward_modular_ms=vit_fam["modular_ms"])
    log(f"  x12 layers = {12 * kernels[-1]['ms']:.3f} ms of the "
        f"{vit_fam['fused_ms']:.3f} ms flag-on ViT-B/16 forward at batch 32 "
        f"(flag off {vit_fam['modular_ms']:.3f} ms); its per-call weight "
        f"casts {12 * kernels[-1]['weight_casts_per_layer_ms']:.3f} ms")
    del blk, blk1, blk_t2t, casts, mixed, x_rows, qkv_blk

    # the biased split-head backward at SwinV2-B @256 w16's stage 1, from
    # phase 7h (the shared bias, then the shifted block's one a window); its
    # launches are the SwinV2-B step's there. It replaces no TPU kernel: the
    # line is the JAX package's jnp backward it computes.
    b16, b16s = bias_numbers["stage 1"], bias_numbers["stage 1 shifted"]
    entry("flash_attention_bias_bwd", "flash_attention_bias_bwd.cu", 2427,
          bias_numbers["swinv2_b step"]["launches"],
          max(b16["max_abs_err"], b16s["max_abs_err"]),
          "G8192 S256 dh32 bias_g 4 (SwinV2-B @256 w16 stage 1, batch 128)",
          b16["kernel_ms"], b16["plain_ms"], b16["library_ms"],
          b16["moved"], b16["flops"], tflops=b16["tflops"],
          errors=b16["errors"], off_step=b16["off_step"],
          shifted_ms=b16s["kernel_ms"], shifted_bound_ms=b16s["bound_ms"],
          shifted_plain_ms=b16s["plain_ms"],
          shifted_library_ms=b16s["library_ms"],
          shifted_errors=b16s["errors"], shifted_off_step=b16s["off_step"])

    require(len(kernels) == len(fa.LAUNCHES),
            "every kernel of the launch table has its line")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
