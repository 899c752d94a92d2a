#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (perceptor_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the flash-attention and GroupNorm kernels from csrc/ with nvcc,
then runs these phases, each printing one JSON line; any failure raises
and the script exits non-zero without a result line:

1. kernels        each CUDA kernel against its plain PyTorch version (fp32
                  arithmetic on the same bf16 inputs) at the three attention
                  shapes of the 512px guided step and at the 512px ADM
                  UNet's site (1, 8, 1024, 64), head-interleaved as its
                  AttentionBlock passes q, k and v, two dq and two dk/dv
                  launches held bitwise equal at each; at the CFG sampling
                  step's batch-2 sites (S = 4096 and 1024), strided as the
                  UNet passes them; and off the main path: fp32 inputs,
                  strided batch-2 bf16 inputs (S = 1024 and 768px's 2304),
                  d = 512 at S = 1024, and K/V of a single tile; then each
                  kernel's registers, spills, shared memory and resident
                  blocks per SM;
   group_norm     the GroupNorm + activation kernels against their plain
                  version, forward and backward, at the SD UNet's levels (B =
                  1 and 16), the KL-VAE decoder's from 64 to 512 px (B = 1
                  and 8), one channels-last input (copied to NCHW by the
                  wrapper), ADM's 256 px scale-shift norm and v-diffusion's
                  one-group FiLM: errors, dx bitwise repeatable, device ms
                  against the byte bound, the plain version's and
                  `F.group_norm`'s ms;
2. guided_step    the full-width guided step (SD-1.x UNet + VAE at 512px,
                  CLIP ViT-B/32, batch 1, random weights from seed 0) for 5
                  steps: finite latents and loss, exactly 11 launches of each
                  kernel per step, steady ms per step and peak memory (from
                  an emptied allocator cache);
3. profile        one guided step under torch.profiler: device time by
                  kernel and the device's busy share, against the profiled
                  step and against the same step timed unprofiled;
   flops          the guided step's model FLOPs (`utils.flops`, every
                  attention on the plain route) less the kernel route's:
                  exactly 4 b h s^2 d forward plus 8 b h s^2 d backward over
                  its 11 attention sites;
   guided_step_remat  2 guided steps of a `remat=True` build beside 2 of the
                  plain one: 21 / 11 / 11 launches a step (the UNet's
                  forward runs again in the backward), the same losses bit
                  for bit, each one's peak memory;
4. route_parity   the UNet forward and its latent gradient, a batch-2 CFG
                  UNet evaluation, and the VAE decode, through the kernels
                  against the plain attention route (and both against an
                  fp32 copy), same weights and inputs, bf16;
   group_norm_steps  the GroupNorm launches of a guided step (74 calls
                  forward and backward), of a batch-16 UNet evaluation (45)
                  and of a batch-8 decode (29), each asserted, every input
                  asserted NCHW (no copy in the wrapper), and the device
                  ms of those calls: kernels, byte bound, plain version and
                  `F.group_norm`;
5. sample         `StableDiffusion(MODEL).sample` at 512px, batch 1, CFG 7:
                  a 20-step DDIM, a 10-step DPM-Solver++(2M) and an
                  img2img/RePaint run from the first image; launches
                  asserted (10 per batched UNet evaluation, one per VAE
                  decode or encode; GroupNorm 45 per UNet evaluation, 29 per
                  decode, 21 per encode), finite images, seconds per image, ms
                  per sampling step, text-encode and decode ms, peak memory;
6. sample_profile one CFG sampling step under torch.profiler;
   sample_deepcache  the 20-step DDIM again with `cache_interval=3`
                  (DeepCache) beside `cache_interval=1`: 10 launches a full
                  step and 5 a cached one, each step checked; seconds per
                  image of both and the relative L2 between their images;
7. guided_sample  `engine.guided_sample` with CFG for 2 steps, the guided
                  step's CLIP loss (a fixed random target): 21 launches of
                  each kernel a step, finite latents and losses, ms per step
                  and peak memory;
8. text_tower     `models.CLIP("ViT-B-32")` (both towers, bf16): two prompts
                  through the port's vocabulary and the text tower, unit
                  norm, finite, within 5e-2 relative L2 of an fp32 copy of
                  the same weights; text-encode ms;
9. optimize_raw   `engine.optimize` of a 256px `Raw` fractal image under
                  `losses.CLIP("ViT-B-32")` with a text prompt plus
                  `losses.Smoothness()`, Adam 0.05, 30 steps: the loss falls,
                  finite pixels, no flash launch (50 image tokens, masked
                  text); ms per step, peak memory, one step under the
                  profiler; then the same steps through `run_on_device`,
                  whose history must equal `optimize`'s within 1e-6;
10. optimize_cutouts  a 512px `Raw` under the same CLIP loss over
                  `random_cutouts` (n = 8, 32, 64 cutouts of 224px, cut_pow
                  0.5, a seeded CUDA generator), 10 steps each;
11. optimize_jpeg `drawers.JPEG` from the 256px fractal image, 10 steps; its
                  decode on the card against the CPU's (1e-4) and the round
                  trip's mean error;
12. guided_sample_text  `engine.guided_sample` with CFG 7, guidance 0.5, the
                  text-prompted `losses.CLIP` over 16 random cutouts a step,
                  4 steps at 512px: 21 launches of each kernel a step, finite
                  latents and losses, ms per step and peak memory;
13. adm_sample    `GuidedDiffusion("standard").sample` at 512px, batch 1,
                  full depth: a 10-step DDIM, a 5-step DPM-Solver++(2M) and an
                  img2img run (from index 600, eta 0.5) from the first
                  image: exactly 5 forward launches a UNet evaluation and no
                  backward launch, finite images, seconds per image, ms per
                  step, peak memory, parameters; one UNet evaluation under
                  torch.profiler;
14. adm_guided_sample  `engine.guided_sample` on that model under the
                  text-prompted `losses.CLIP` over 16 random cutouts a step
                  (no generator passed: the augment gets the default one), 3
                  steps from the first image diffused to index 600: 5 / 5 / 5
                  launches a step, finite images and losses, ms per step,
                  peak memory;
15. adm_route_parity  the ADM UNet forward at 512px and its input gradient
                  through the kernels against the plain attention route and
                  an fp32 copy, with route_parity's tolerances;
16. velocity_sample  `VelocityDiffusion("cc12m_1_cfg")` at 256px, full width
                  and depth, conditioned on the prompt through
                  `models.CLIP("ViT-B-16")`: 10-step DDIM with correction,
                  10-step "plms", 5-step "dpm++", a `reverse_sample` of the
                  DDIM image, and a 3-step `guided_sample` under the text loss
                  over float (from_t, to_t) pairs: no flash launch (its
                  attention sites have at most 256 tokens), finite outputs,
                  seconds per image, ms per UNet evaluation, peak memory; one
                  UNet evaluation under torch.profiler;
17. ldm_text2image  `models.latent_diffusion.Text2Image()` at full width
                  (32-layer BERT, the 320-channel spatial-transformer UNet,
                  KL-f8; random weights from seed 0, a synthetic vocabulary)
                  at 256px, CFG 5: a 10-step DDIM, a 5-step dpm++ and a
                  5-step DDIM at eta 0.5: 5 forward launches a UNet
                  evaluation and 1 a decode, finite images, ms per
                  evaluation, seconds per image, peak memory, one (CFG)
                  evaluation under torch.profiler; then the UNet's kernel
                  route against its plain route and an fp32 copy;
18. ldm_face      `Face()` (VQ-f4) at 256px, 10-step DDIM: 5 launches an
                  evaluation (the ds-2 AttentionBlocks, 14 heads of 32), 1 a
                  decode (the VQ decoder's mid block, S = 4096); a profiled
                  evaluation as above;
19. ldm_super_resolution  `SuperResolution()` on a 64 -> 256 canvas, 10-step
                  DDIM at eta 1: no UNet launch (attention at 64 tokens), 1 a
                  decode; a profiled evaluation;
20. inpaint_sample  (run after guided_sample, with phases 21 too)
                  `StableDiffusion(INPAINT_MODEL).sample` at 512px, CFG
                  7, 20-step DDIM with `replace_diffused` on a synthetic
                  image with its left half masked: 10 launches a batched
                  UNet evaluation, one per VAE call (three encodes in JAX's
                  order, one decode), finite images, the known region held
                  to the replace step's bound; s per image, ms per step;
21. inpaint_guided_sample  `engine.guided_sample` on that model over
                  `Conditioning`s, CFG 7, 2 steps: 21 / 21 / 21 launches a
                  step; then inpaint_route_parity, a batched CFG evaluation
                  of the 9-channel UNet through both routes and fp32;
22. monster_sample  `MonsterDiffusion("all")`, a 64-sprite sheet at 48px:
                  the elucidated sampler (20 evaluations), dpm++ and linear
                  multistep (10): finite images in [0, 1], no flash launch,
                  s per sheet, ms per evaluation, a profiled evaluation;
23. clip_resnet   `models.CLIP("RN50")` at 224px and `("RN50x4")` at 288px,
                  bf16 against fp32 (5e-2), then 20 optimization steps of a
                  224px `Raw` under `losses.CLIP("RN50")`: the loss falls,
                  no flash launch;
24. perceptual_losses  each loss of the perceptual slice at full width on a
                  512px image, batch 1: `LPIPS` squeeze / alex / vgg (to a
                  fixed init image), `StyleTransfer` (VGG19, a striped style
                  image), `Memorability("resmem")` (ResNet-152 + AlexNet at
                  227), `SimulacraAesthetic` ViT-L-14 and ViT-B-32,
                  `AestheticVisualAssessment` (ViT-B-16) in its three modes
                  and `TransformersOpenAICLIP` ViT-L/14 with the prompt: the
                  value, forward + backward ms, peak memory, no flash launch,
                  a finite nonzero gradient; LPIPS(a, a) < 1e-6,
                  StyleTransfer(a, a) < 1e-5; the four bf16 CLIP towers
                  within 5e-2 of fp32 copies;
25. perceptual_optimize  20 Adam steps of a 512px `Raw` from the init image
                  under five of them (Memorability weighted -1): the loss
                  falls, no flash launch, ms a step, a profiled step;
26. aesthetic_guided_sample  2 CFG-guided SD steps at 512px under
                  Simulacra ViT-L-14 and LPIPS-vgg to the init image: 21 /
                  21 / 21 launches a step, finite latents and losses;
27. depth_models  each depth model at full width on a 512px image, batch 1:
                  `MidasDepth` dpt_large, dpt_hybrid, midas_v21 and
                  midas_v21_small (bf16; the negated depth <= 0, each within
                  5e-2 relative L2 of an fp32 build of the same weights) and
                  AdaBins "nyu" (`adabins_depth.predict` over a seeded
                  full-width `UnetAdaptiveBins`, the depth within its range):
                  parameters, the depth's shape and range, forward and
                  forward + backward ms, a profiled forward + backward, peak
                  memory, no flash launch, a finite nonzero input gradient;
28. depth_optimize  20 Adam steps of a 512px `Raw` from the init image under
                  `losses.CLIP("ViT-B-32")` with the prompt and
                  `losses.MidasDepth("dpt_large")` to the striped image's
                  depth: the loss falls, no flash launch, ms a step, a
                  profiled step;
29. depth_guided_sample  2 CFG-guided SD steps at 512px under
                  `losses.MidasDepth("dpt_hybrid")` to the init image's
                  depth: 21 / 21 / 21 launches a step, finite latents and
                  losses; run twice, the two loss histories bitwise equal;
30. ensemble_guided_sample  `engine.guided_sample` over
                  `GuidedDiffusion("pixelart")` at 256px under BLIP
                  (model_base_retrieval_flickr, 384px), CLOOB (16-epochs) and
                  SLIP (ViT-B/16) at full width, each to its own random
                  target, 5 steps of the rho-3 schedule: no flash launch,
                  finite images and losses, ms a step, a profiled step, peak
                  memory; each tower's bf16 encodings within 5e-2 of an fp32
                  build of its weights;
31. clip_variants `LiT("LiT-L16L")` and `RuCLIP("ruclip-vit-large-patch14-336")`:
                  each image tower forward and backward, each text tower
                  forward (a synthetic vocabulary; a stand-in tokenizer of
                  fixed ids), bf16 against fp32, no flash launch;
32. dip_optimize  20 Adam steps (lr 0.01) of `run_on_device` over a 256px
                  `drawers.DeepImagePrior` (192-channel skip levels) under
                  OpenCLIP ViT-B/32 to a random target: the loss falls, no
                  flash launch, a profiled step; `dip_optimize_deform`, 3 steps
                  of the same net with deformable convs (`offset_type="full"`,
                  offsets at lr / 10), and `ops.deform_conv2d` with zero
                  offsets against `F.conv2d` at a 192-channel 256 x 256 layer
                  in fp32 and bf16; each phase's seconds;
33. rudalle_optimize  10 Adam steps (lr 0.01) of `run_on_device` over
                  `drawers.BruteRuDalle` (ruDALL-E's Gumbel VQGAN at full
                  width, the latent encoded from a seeded 256px fractal image)
                  under OpenCLIP ViT-B/32 to a random target: 4 / 4 / 4 flash
                  launches a step at (1, 1, 1024, 512), 3 / 0 / 0 an encode,
                  the loss falls, a second run bitwise equal, images in
                  [0, 1], a profiled step; `rudalle_optimize_dwt`, 3 steps of
                  the DWT variant (512px images), 4 / 4 / 4 and repeatable;
34. super_resolution  Real-ESRGAN x4 (23 RRDBs) 128 -> 512px forward and
                  backward, bf16 against an fp32 build; `enhance` in 64px
                  tiles on a 200 x 232 frame against the whole frame (the
                  difference on the tiles' interiors reported); the
                  animevideo-xsx4 SRVGG forward; `losses.SuperResolution("x2")`
                  and `SuperResolutionDiscriminator()` forward and backward
                  at 512px; no flash launch;
35. owlvit_loss   `losses.OWLViT()` (B/32 at 768px) with two queries, its
                  logits bf16 against fp32, 5 Adam steps of a 256px `Raw`:
                  no flash launch (577 tokens);
36. glide_clip    `models.GlideCLIP()`: `encode_images` of 4 images at four
                  timesteps, forward and backward, bf16 against fp32, and
                  `encode_texts`; no flash launch (257 tokens);
37. stylegan_xl_optimize  `models.StyleGANXL("imagenet128")` (bf16
                  synthesis up to 148px at 512 channels, JAX's seed-0
                  weights), `latents(1, seeds=[0])` into `drawers.StyleGANXL`,
                  10 Adam steps (lr 0.05) of `run_on_device` under
                  `losses.CLIP("ViT-B-32")` to a random target: no flash
                  launch, the loss falls, finite (1, 3, 128, 128) images, a
                  second run bitwise equal, bf16 against an fp32 build, a
                  profiled step with its top kernels; `stylegan_xl_ffhq256`,
                  the unconditional generator's `latents(2)` forward and
                  backward to the latents at 256px; `stylegan_xl_checkpoints`,
                  the generator written as .pt, {'G_ema': module} .pkl, .npz
                  and a hand-written .safetensors, each loaded through
                  `utils.checkpoints.load_state_dict` into a zeroed fresh
                  wrapper: bitwise equal images; the native reader built, its
                  read byte-equal to the Python read, both timed;
   each of 33-37 prints ms, device ms (a profile), launches, peak memory
   and the card's name and power limit;
   serving_sample  (after guided_sample) `StableDiffusion.export_sample` at
                  512px, DDIM and dpm++, 1 step: exported through
                  `torch.export`, serialized, loaded back and run against
                  the live `sample_loop` on the same context and latents
                  (bitwise, or gated at 1e-3); the loaded program's launches
                  per UNet evaluation held to `sample`'s 10 / 0 / 0 plus the
                  decode's; export and load seconds, artifact bytes against
                  the weights', ms an image loaded and live;
   serving_guided_sample  `engine.export_guided_sample` over the same model
                  under the guided step's CLIP loss, 1 step without CFG:
                  the flash ops as graph nodes, 11 / 11 / 11 launches a step,
                  latents and losses against the live `guided_sample`; then
                  with 4 random 224px cutouts as the image augment, their
                  uniforms drawn by `engine.draw_guided_noise`: bitwise the
                  live sampler on the same generator;
   routing_report  (after guided_step) `parallel.explain` over one guided
                  step on fake CUDA tensors: its flash records equal SITES
                  (11 sites: (4096, 4096, 8) x5, (1024, 1024, 8) x5,
                  (4096, 4096, 1) x1), the summary printed;
   mesh_sample    (after serving_conditioning) a one-rank NCCL world
                  (`parallel.initialize_distributed` on localhost, a free
                  port): `sample(mesh=)` at 512px, 2 DDIM steps with CFG, on
                  `create_mesh(data=-1)` and on a tensor=1 / context=1 mesh,
                  against `sample()` on the same generator (bitwise, or
                  within 1e-3), 10 / 0 / 0 launches a CFG evaluation plus the
                  decode's; `engine.guided_sample(mesh=)`, 1 step, against the
                  live one, 11 / 11 / 11; ms of both paths (a mesh's first
                  call, which places the weights, apart) and the host ops of
                  a mesh call with the weights placed anew and kept; the
                  collective inventory of one traced mesh step;
   parallel_collectives  in the same world, each on a one-rank mesh:
                  `ring_attention`, `ulysses_attention` (77 keys) and a
                  `pipeline` of 2 microbatches, forward and backward on bf16
                  inputs at SD's level-0 shape (1, 8, 4096, 40) against
                  their plain counterparts on the same inputs (the ring's
                  and the flash kernels' in fp32 arithmetic, Ulysses' plain
                  bf16 attention and the bf16 stages in their own), 2e-2 of
                  the largest magnitude, and the flash kernels through
                  DTensor (batch- and head-sharded operands), then
                  `destroy_process_group`.
                  Multi-rank runs are the CPU tests' (gloo worlds of 2 and 4):
                  this machine has one card;
   training_stats a `utils.stats.Collector` over the guided runs' losses, its mean and
                  std against numpy's; serving_conditioning, the text
                  encoder's program against the live encoder;
   session_resume  (after optimize_jpeg) a 256px `Raw` under Adam and the
                  CLIP loss on random cutouts: 6 steps straight against 3,
                  `save_session`, fresh objects, `load_session` and 3 more,
                  losses and pixels bitwise; `SessionManager` (async,
                  interval 2, two kept) over the same run, its restore
                  bitwise the run's state;
   serving_velocity  (after velocity_sample) yfcc_2's `export_sample`, 1
                  step, against the live sampler, no flash launch;
   checkpoint_discovery  (after stylegan_xl) OpenCLIP ViT-B/32's weights as
                  an open_clip-layout file, converted by the port's CLI into
                  a temporary cache directory, found by a fresh
                  `OpenCLIP("ViT-B-32", "laion2b_s34b_b79k")`: embeddings
                  bitwise those of the model that wrote the file; the CLI's
                  and the load's seconds;
38. timings       each kernel, its plain version and PyTorch's
                  scaled_dot_product_attention at each site (and the
                  forward at the batch-2 sites), PyTorch's fused flash
                  backward where it takes the head_dim (d <= 256), beside
                  the card's bound; launches queue up behind a spin on the
                  device, so a small kernel is timed at the device's pace,
                  not the host's.

Each phase measures its launches per step and holds them against the one
table PER_STEP. Then the script's seconds (`total`), the kernel table as one
JSON line (launches of every
main-path run and measured launches per step, by entry point) and, last,
the device line. Exits non-zero with no result when
CUDA is not available.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

STEPS = 5
# (site, batch, heads, seq, head_dim, launches per guided step)
SITES = (
    ("unet_level0_attn1", 1, 8, 4096, 40, 5),
    ("unet_level1_attn1", 1, 8, 1024, 80, 5),
    ("vae_mid_attn", 1, 1, 4096, 512, 1),
)
# the forward's sites in a CFG sampling step: the uncond/cond pair batched,
# (site, batch, heads, seq, head_dim, launches per sampling step)
CFG_SITES = (
    ("unet_level0_attn1_cfg", 2, 8, 4096, 40, 5),
    ("unet_level1_attn1_cfg", 2, 8, 1024, 80, 5),
)
# the 512px ADM "standard" UNet's flash site: its five attention blocks at
# downsampling 16 (32 x 32 tokens, 8 heads of 64 channels), q, k and v
# head-interleaved views of one qkv projection;
# (site, batch, heads, seq, head_dim, launches per UNet evaluation)
ADM_SITES = (("adm_ds16_attn", 1, 8, 1024, 64, 5),)
# the latent-diffusion family's new flash sites at 256px: Text2Image's
# spatial-transformer self-attention at ds 1 (32 x 32 latents, the CFG pair
# batched; 8 heads of 40), Face's ds-2 AttentionBlocks (14 heads of 32,
# head-interleaved) and the KL-f8 decoder's mid block. The VQ-f4 decoder's
# mid block is the SD VAE's (1, 1, 4096, 512) and DeepCache's cached SD step
# keeps the level-0 CFG site.
# (site, batch, heads, seq, head_dim, launches per UNet evaluation / decode)
LDM_SITES = (
    ("txt2img_ds1_attn1_cfg", 2, 8, 1024, 40, 5),
    ("face_ds2_attn", 1, 14, 1024, 32, 5),
    ("kl_f8_mid_attn_256", 1, 1, 1024, 512, 1),
)
LDM_SITE_PATHS = ("ldm_text2image", "ldm_face", "ldm_text2image_decode")
# SDXL at 1024px (`sdxl_sample`, forward only): the UNet's self-attention
# with the CFG pair of 4 prompts batched, 20 heads over 32 x 32 = 1,024
# tokens in its 60 blocks at that level and 10 heads over 64 x 64 = 4,096 in
# its 10 others (d = 64), and the decoder's mid block over 128 x 128 =
# 16,384 latents (one head of 512).
# (site, batch, heads, seq, head_dim, launches per UNet evaluation / decode)
SDXL_SITES = (
    ("sdxl_unet_32x32_attn1_cfg", 8, 20, 1024, 64, 60),
    ("sdxl_unet_64x64_attn1_cfg", 8, 10, 4096, 64, 10),
    ("sdxl_vae_mid_attn_1024", 4, 1, 16384, 512, 1),
)
# The one table of expected launches: each kernel's launches per step of
# each path, by entry point. The guided step is one UNet evaluation (5
# self-attentions at level 0, S = 4096, and 5 at level 1, S = 1024) and the
# VAE decode, forward and backward; `sample` is counted per batched CFG UNet
# evaluation, forward only; `guided_sample` with CFG is two UNet
# evaluations and the VAE decode, forward and backward. Each phase measures
# its counts and holds them against this table.
PER_STEP = {
    "guided_step": {"flash_fwd": 11, "flash_dq": 11, "flash_dkv": 11},
    # the same step with `remat`: the backward runs each UNet res and
    # transformer block's forward again, so the UNet's 10 sites launch the
    # forward twice; the VAE is not rematerialized (as in JAX)
    "guided_step_remat": {"flash_fwd": 21, "flash_dq": 11, "flash_dkv": 11},
    "sample": {"flash_fwd": 10, "flash_dq": 0, "flash_dkv": 0},
    # SDXL at 1024px, per batched CFG evaluation: 70 transformer blocks,
    # 60 at 32 x 32 (1,024 tokens) and 10 at 64 x 64 (4,096), each one
    # self-attention at d = 64; cross-attention (77 keys) takes the plain route
    "sdxl_sample": {"flash_fwd": 70, "flash_dq": 0, "flash_dkv": 0},
    "guided_sample": {"flash_fwd": 21, "flash_dq": 21, "flash_dkv": 21},
    "guided_sample_text": {"flash_fwd": 21, "flash_dq": 21, "flash_dkv": 21},
    # drawer -> CLIP ViT-B/32: 50 image tokens and a masked text tower
    "optimize": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # ADM at 512px: per UNet evaluation (sample), and per guided step, which
    # is one evaluation forward and backward (CLIP ViT-B/32 launches none)
    "adm_sample": {"flash_fwd": 5, "flash_dq": 0, "flash_dkv": 0},
    "adm_guided_sample": {"flash_fwd": 5, "flash_dq": 5, "flash_dkv": 5},
    # cc12m_1_cfg at 256px: attention at 16 x 16 tokens and below
    "velocity_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "velocity_guided_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # yfcc_2 (bench_cuda.py), per UNet evaluation at 512px and per guided step
    # at 256px: attention at levels 5-7, 16 x 16 tokens and below at 512px
    # (8 x 8 at 256px), and CLIP ViT-B/32's 50 tokens
    "velocity_yfcc2_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "velocity_yfcc2_guided_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # DeepCache on `sample`: a full step is the batched CFG evaluation; a
    # cached one runs level 0 only (2 down + 3 up spatial transformers)
    "sample_deepcache_full": {"flash_fwd": 10, "flash_dq": 0, "flash_dkv": 0},
    "sample_deepcache_cached": {"flash_fwd": 5, "flash_dq": 0, "flash_dkv": 0},
    # the latent-diffusion family at 256px, per UNet evaluation: Text2Image
    # 2 input + 3 output transformers at ds 1, Face 2 + 3 AttentionBlocks at
    # ds 2, SuperResolution none (attention at ds 8 / 16 of 64 x 64 latents)
    "ldm_text2image": {"flash_fwd": 5, "flash_dq": 0, "flash_dkv": 0},
    "ldm_face": {"flash_fwd": 5, "flash_dq": 0, "flash_dkv": 0},
    "ldm_super_resolution": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # SD inpainting at 512px: the 9-channel UNet has SD-1.x's attention, so a
    # batched CFG evaluation launches `sample`'s 10 and a CFG-guided step
    # `guided_sample`'s 21 / 21 / 21 (two B = 1 evaluations and the decode,
    # forward and backward); the masked-image and init encodes and the decode
    # are counted apart, PER_VAE_CALL each
    "inpaint_sample": {"flash_fwd": 10, "flash_dq": 0, "flash_dkv": 0},
    "inpaint_guided_sample": {"flash_fwd": 21, "flash_dq": 21, "flash_dkv": 21},
    # MonsterDiffusion at 48px: attention at 24 x 24 and 12 x 12 tokens, per
    # evaluation; the CLIP ResNets: the pool's one query over 50 / 82 keys
    "monster_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "clip_resnet": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # the perceptual, style, memorability and aesthetic losses, per loss
    # evaluation (forward and backward) and per optimization step: CNNs and
    # CLIP ViTs of at most 257 tokens (ViT-L/14 at 224px) take no kernel;
    # guided SD sampling under two of them launches `guided_sample`'s
    "perceptual_losses": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "perceptual_optimize": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "aesthetic_guided_sample": {"flash_fwd": 21, "flash_dq": 21, "flash_dkv": 21},
    # the depth models, per forward + backward and per optimization step: the
    # longest attention is 577 tokens (DPT's ViTs at 384px) and AdaBins'
    # mini-ViT writes its own softmax; guided SD sampling under the depth
    # loss launches `guided_sample`'s
    "depth_models": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "depth_optimize": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "depth_guided_sample": {"flash_fwd": 21, "flash_dq": 21, "flash_dkv": 21},
    # the CLIP-family ensemble over ADM "pixelart" at 256px, per guided step:
    # the UNet attends at ds 16 (16 x 16 = 256 tokens), BLIP's ViT at 384px
    # over 577 tokens, CLOOB's and SLIP's at 224px over 197, their text
    # towers masked
    "ensemble_guided_sample": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # deep image prior at 256px, per optimizer step: convolutions only, and
    # OpenCLIP ViT-B/32's 50 tokens
    "dip_optimize": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "dip_optimize_deform": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # LiT-L16L (197 image tokens, a masked 16-token BERT) and ruCLIP L/14 at
    # 336px (577 image tokens, a causal text tower), per forward + backward
    "clip_variants": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # ruDALL-E's VQGAN at 256px attends at 32 x 32 (S = 1024, one head of
    # 512): an optimizer step decodes the latent, forward and backward,
    # through the decoder's mid block and the three AttnBlocks of its level 0
    # (vae.py Decoder: n_res_blocks + 1 resnets, each followed by one); an
    # encode runs the encoder's two level-3 AttnBlocks and its mid block,
    # forward only. OpenCLIP ViT-B/32 launches none
    "rudalle_optimize": {"flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4},
    "rudalle_encode": {"flash_fwd": 3, "flash_dq": 0, "flash_dkv": 0},
    "rudalle_optimize_dwt": {"flash_fwd": 4, "flash_dq": 4, "flash_dkv": 4},
    # Real-ESRGAN and its discriminator: convolutions only, per phase;
    # OWL-ViT B/32 at 768px (577 tokens; a causal 16-token text tower), per
    # optimizer step; GLIDE's CLIP (257 image tokens, a causal 77-token text
    # tower), per phase
    "super_resolution": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "owlvit_loss": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "glide_clip": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # StyleGAN-XL's synthesis has no attention; CLIP ViT-B/32 attends over 50
    # tokens: per optimizer step, and per forward + backward of ffhq256
    "stylegan_xl_optimize": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "stylegan_xl_ffhq256": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # the loaded torch.export programs (SD's `export_sample` is held to
    # `sample`'s row per batched CFG UNet evaluation, the decode apart):
    # `export_guided_sample` over SD without CFG, per step: one B = 1 UNet
    # evaluation and the decode, forward and backward (the guided step's);
    # the text-conditioning program (a masked S = 77 tower) and yfcc_2's
    # sampler (attention at 16 x 16 tokens and below) launch none
    "serving_guided_sample": {"flash_fwd": 11, "flash_dq": 11, "flash_dkv": 11},
    # `sample(mesh=)` and `guided_sample(mesh=)` on a one-rank mesh: the
    # unsharded paths' launches (per batched CFG UNet evaluation, the decode
    # apart; per guided step without CFG)
    "mesh_sample": {"flash_fwd": 10, "flash_dq": 0, "flash_dkv": 0},
    "mesh_guided_sample": {"flash_fwd": 11, "flash_dq": 11, "flash_dkv": 11},
    "serving_conditioning": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "serving_velocity": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    # the session and discovery phases: CLIP ViT-B/32's 50 tokens
    "session_resume": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
    "checkpoint_discovery": {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0},
}
# launches of one no-grad VAE decode or encode (the mid-block attention)
PER_VAE_CALL = {"flash_fwd": 1, "flash_dq": 0, "flash_dkv": 0}
# the forward's launches by design (`fa.FWD_DESIGN_LAUNCHES`), which the
# head_dim picks: per UNet evaluation, every self-attention (d = 40 / 80,
# SDXL's d = 64) on the Hopper design; per decode, the mid block's d = 512
# on mma.sync
FWD_DESIGNS_PER_UNET_EVAL = {
    "sample": {"wgmma": 10, "mma": 0, "fp32": 0},
    "sdxl_sample": {"wgmma": 70, "mma": 0, "fp32": 0},
}
FWD_DESIGNS_PER_VAE_CALL = {"wgmma": 0, "mma": 1, "fp32": 0}
# the B = 1 sites' launches per CFG-guided step: the UNet's sites twice
CFG_GUIDED_SITE_LAUNCHES = {
    site: n * (2 if site.startswith("unet") else 1) for site, *_, n in SITES
}
MODEL = "runwayml/stable-diffusion-v1-5"
SDXL_MODEL = "stabilityai/stable-diffusion-xl-base-1.0"
SDXL_SIZE = 1024
SDXL_BATCH = 4
SDXL_STEPS = 20
SDXL_CFG_SCALE = 5.0
IMAGE_SIZE = 512
PROMPT = "a photograph of an astronaut riding a horse on the moon"
CFG_SCALE = 7.0
# text-to-image runs of `StableDiffusion.sample` at 512px, batch 1, in this
# order; img2img starts from the first run's image
SAMPLE_RUNS = (
    ("ddim", {"n_steps": 20}),
    ("dpm++", {"n_steps": 10, "method": "dpm++"}),
    ("img2img", {"n_steps": 5, "from_index": 600, "eta": 0.5, "n_resample": 1}),
)
GUIDED_SAMPLE_STEPS = 2
# the pixel-space families: ADM "standard" at 512px and the CLIP-conditioned
# v-diffusion model at 256px, full width and depth, batch 1
ADM_MODEL = "standard"
ADM_SAMPLE_RUNS = (
    ("ddim", {"n_steps": 10}),
    ("dpm++", {"n_steps": 5, "method": "dpm++"}),
    ("img2img", {"n_steps": 5, "from_index": 600, "eta": 0.5}),
)
ADM_GUIDED_STEPS = 3
ADM_GUIDED_FROM_INDEX = 600
ADM_GUIDED_CUTOUTS = 16
VELOCITY_MODEL = "cc12m_1_cfg"
VELOCITY_SAMPLE_RUNS = (
    ("ddim_correction", {"n_steps": 10, "correction": True}),
    ("plms", {"n_steps": 10, "method": "plms"}),
    ("dpm++", {"n_steps": 5, "method": "dpm++"}),
)
VELOCITY_REVERSE_STEPS = 10
DEEPCACHE_STEPS = 20
DEEPCACHE_INTERVAL = 3
# the latent-diffusion family at 256px, batch 1, full width and depth
LDM_SIZE = 256
LDM_CFG_SCALE = 5.0
LDM_TEXT2IMAGE_RUNS = (
    ("ddim", {"n_steps": 10}),
    ("dpm++", {"n_steps": 5, "method": "dpm++"}),
    ("ddim_eta", {"n_steps": 5, "eta": 0.5}),
)
LDM_FACE_RUNS = (("ddim", {"n_steps": 10}),)
LDM_SR_RUNS = (("ddim_eta1", {"n_steps": 10}),)
LDM_SR_LOW_RES = 64
# SD inpainting at 512px, batch 1, CFG 7, on a fixed synthetic image with its
# left half masked (1 = paint): a 20-step DDIM with `replace_diffused`, then
# 2 CFG-guided steps under the guided step's loss
INPAINT_MODEL = "runwayml/stable-diffusion-inpainting"
INPAINT_STEPS = 20
INPAINT_GUIDED_STEPS = 2
# outside the mask the final latents are the init latents diffused to the
# last target index: |final - init| <= (1 - alpha) |init| + sigma |noise|,
# with |noise| held to this many standard deviations
KNOWN_REGION_NOISE_SIGMAS = 6.0
# MonsterDiffusion "all" (48px sprites), a 64-sprite sheet: the elucidated
# sampler at 20 evaluations, DPM-Solver++(2M) and linear multistep at 10
MONSTER_BATCH = 64
MONSTER_RUNS = (("sample", 20), ("dpm_solver_sample", 10), ("linear_multistep_sample", 10))
# CLIP's ResNet towers at their published image sizes; 20 optimization steps
# of a `Raw` drawer at RN50's 224px under `losses.CLIP("RN50")`
CLIP_RESNETS = ("RN50", "RN50x4")
RN_OPTIMIZE_STEPS = 20
# the perceptual, style, memorability and aesthetic losses at full width on
# 512px images; 20 optimization steps of a 512px `Raw` drawer under five of
# them, and 2 CFG-guided SD steps under Simulacra (ViT-L/14) and LPIPS-vgg
LPIPS_NAMES = ("squeeze", "alex", "vgg")
RESMEM_NAME = "resmem"
SIMULACRA_NAMES = ("ViT-L-14", "ViT-B-32")
HF_CLIP_NAME = "openai/clip-vit-large-patch14"
PERCEPTUAL_LOSSES = (
    *(f"lpips_{name}" for name in LPIPS_NAMES), "style_transfer", "memorability",
    *(f"simulacra_{name}" for name in SIMULACRA_NAMES),
    "ava_logit", "ava_expected", "ava_probability", "transformers_openai_clip",
)
# (loss, weight): memorability is raised, so it takes a negative weight
OPTIMIZE_OBJECTIVES = (
    ("transformers_openai_clip", 1.0), ("simulacra_ViT-L-14", 1.0), ("lpips_vgg", 1.0),
    ("style_transfer", 1.0), ("memorability", -1.0),
)
GUIDED_OBJECTIVES = ["simulacra_ViT-L-14", "lpips_vgg"]
PERCEPTUAL_STEPS = 20
AESTHETIC_GUIDED_STEPS = 2
# the depth slice on 512px images, batch 1: MiDaS's four architectures at
# full width through `models.MidasDepth` (each also built in fp32, the same
# weights, for the bf16 gate), AdaBins "nyu" through
# `models.adabins_depth.predict` over a seeded full-width network (no
# weights are in the tree, and the wrapper refuses full width without
# them); 20 Adam steps of a 512px `Raw` under CLIP and the dpt_large depth
# loss; 2 CFG-guided SD steps under the dpt_hybrid depth loss
MIDAS_NAMES = ("dpt_large", "dpt_hybrid", "midas_v21", "midas_v21_small")
ADABINS_NAME = "nyu"
DEPTH_OPTIMIZE_MODEL = "dpt_large"
DEPTH_GUIDED_MODEL = "dpt_hybrid"
DEPTH_STEPS = 20
DEPTH_GUIDED_STEPS = 2
# a bf16 depth map against the fp32 build's of the same weights, relative L2
DEPTH_BF16_RTOL = 5e-2
# a loss between an image and itself: LPIPS's normalized features cancel
# exactly, StyleTransfer's fp32 Gram matrices to rounding
LPIPS_SELF_ATOL = 1e-6
STYLE_SELF_ATOL = 1e-5
# bert-base-uncased has 30,522 entries; no vocabulary file is in the tree, so
# a synthetic one of that size: a few real word pieces, then [unusedN]
BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "a", "cat", "photo", "of", "##s", "the"]
BERT_VOCAB += [f"[unused{i}]" for i in range(30522 - len(BERT_VOCAB))]
VELOCITY_GUIDED_STEPS = 3
# the text-prompted optimization phases (CLIP ViT-B/32, openai config)
CLIP_NAME = "ViT-B-32"
TEXT_PROMPTS = (PROMPT, "an oil painting of a lighthouse at dusk")
RAW_SIZE = 256
RAW_STEPS = 30
CUTOUT_IMAGE_SIZE = 512
CUTOUT_COUNTS = (8, 32, 64)
CUT_SIZE = 224
CUT_POW = 0.5
CUTOUT_STEPS = 10
# every step draws new cutouts, so the history is noisy from step to step:
# the loss must fall under one fixed draw of this many boxes, before to after
CUTOUT_EVAL_COUNT = 64
JPEG_STEPS = 10
GUIDED_TEXT_STEPS = 4
GUIDED_TEXT_CUTOUTS = 16
# bf16 towers against an fp32 copy of the same weights, relative L2
TEXT_BF16_RTOL = 5e-2
# the CLIP-family ensemble over ADM "pixelart" (bench_families.py config 5)
ENSEMBLE_ADM = "pixelart"
ENSEMBLE = (("BLIP", "model_base_retrieval_flickr"), ("CLOOB", "16-epochs"),
            ("SLIP", "SLIP_VITB16"))
ENSEMBLE_SIZE = 256
ENSEMBLE_STEPS = 5
# deep image prior (config 2): 256px, 192-channel skip levels, Adam 0.01
DIP_SIZE = 256
DIP_STEPS = 20
DIP_DEFORM_STEPS = 3
DIP_LR = 0.01
# deform_conv2d with zero offsets against F.conv2d at a DIP layer's shape:
# fp32 sums in another order; bf16 inputs, each result rounded to bf16 once
DEFORM_SHAPE = (1, 192, DIP_SIZE, DIP_SIZE)
DEFORM_FP32_RTOL = 1e-4
DEFORM_BF16_RTOL = 8e-3
# LiT and ruCLIP at published widths
LIT_NAME = "LiT-L16L"
RUCLIP_NAME = "ruclip-vit-large-patch14-336"
# ruDALL-E's Gumbel VQGAN (GUMBEL_F8) at 256px under OpenCLIP ViT-B/32,
# Adam over the latent; a short run of the DWT variant beside it
RUDALLE_SIZE = 256
RUDALLE_STEPS = 10
RUDALLE_DWT_STEPS = 3
RUDALLE_LR = 0.01
# Real-ESRGAN x4 on 128px (512px out); `enhance` tiled on a frame no
# multiple of the tile; both SR losses at 512px
SR_NAME = "x4"
SR_VIDEO_NAME = "RealESRGANv2-animevideo-xsx4"
SR_SIZE = 128
SR_ENHANCE_FRAME = (200, 232)
SR_TILE, SR_TILE_PAD = 64, 10
SR_LOSS_NAME = "x2"
SR_LOSS_SIZE = 512
# OWL-ViT B/32 at 768px over a 256px Raw, two queries; GLIDE's CLIP at 64px
OWLVIT_QUERIES = ["a lighthouse", "a horse"]
OWLVIT_STEPS = 5
OWLVIT_RAW_SIZE = 256
GLIDE_BATCH = 4
GLIDE_TIMESTEPS = (0, 250, 500, 999)
# StyleGAN-XL: the class-conditional ImageNet generator optimized under CLIP,
# the unconditional FFHQ one forward and backward at batch 2
STYLEGAN_NAME = "imagenet128"
STYLEGAN_UNCOND_NAME = "ffhq256"
STYLEGAN_STEPS = 10
STYLEGAN_LR = 0.05
# `optimize` and `run_on_device` do the same arithmetic in the same order
# serving (torch.export programs), sessions, training stats and checkpoint
# discovery: the steps are kept few, since each step of a program is traced
# into its graph
SERVING_STEPS = 1
SERVING_GUIDED_STEPS = 1
SERVING_VELOCITY_MODEL = "yfcc_2"
SERVING_ATOL = 1e-3
SERVING_CUTOUTS = 4
# the mesh paths on one rank: the unsharded sampler's arithmetic, so bitwise
# is expected; MESH_ATOL gates it where a gathered weight's storage changes a
# library's algorithm choice (printed with the reason)
MESH_STEPS = 2
MESH_ATOL = 1e-3
# ring / Ulysses / pipeline on one rank, bf16 inputs, against plain
# attention and the sequential stages on the same inputs: KERNEL_RTOL
COLLECTIVE_SHAPE = (1, 8, 4096, 40)
COLLECTIVE_KV = 77
PIPELINE_WIDTH = 320
SESSION_STEPS = 6
SESSION_CUTOUTS = 8
DISCOVERY_WEIGHTS = "laion2b_s34b_b79k"
STATS_RTOL = 1e-6
PR14_SECONDS = 236.4
RUN_ON_DEVICE_ATOL = 1e-6
# the JPEG decode on the card against the CPU's, same coefficients, fp32
JPEG_DECODE_ATOL = 1e-4
# the codec is lossy (2x chroma subsampling, quantization at factor 1): the
# round trip of the fractal image is held to a mean absolute error only
JPEG_ROUND_TRIP_MEAN = 0.1
# bf16 kernels vs fp32 arithmetic: bf16 keeps 8 mantissa bits, so rounding
# the output alone costs ~2e-3 of its magnitude, and P / dS are rounded to
# bf16 before their products; 2e-2 of the reference's largest magnitude
# leaves a 10x margin while a wrong tile, index or scale errs by O(1) of it.
KERNEL_RTOL = 2e-2
# The GroupNorm + activation sites of the main paths, (site, batch,
# channels, H = W, groups, eps, (N, C) affine, activation, channels-last):
# the SD UNet's levels (and the up path's concatenated widths) at the
# guided step's batch 1 and b8's CFG batch 16, the KL-VAE decoder's from 64
# to 512 px at 1 and 8, SDXL's UNet at its CFG batch 8 and its decoder at
# 1024 px, one channels-last input (the wrapper copies it to NCHW), ADM's
# scale-shift norm at 256 px and v-diffusion's one-group FiLM.
GN_SITES = (
    *((f"sd_unet_{c}x{hw}_b{b}", b, c, hw, 32, 1e-5, False, "silu", False)
      for b in (1, 16) for c, hw in ((320, 64), (640, 32), (1280, 16), (1280, 8), (2560, 8),
                                     (1920, 16), (960, 32), (640, 64))),
    *((f"vae_{c}x{hw}_b{b}", b, c, hw, 32, 1e-6, False, "silu", False) for b in (1, 8)
      for c, hw in ((512, 64), (512, 128), (512, 256), (256, 256), (256, 512), (128, 512))),
    # SDXL at 1024px: the UNet's levels and the up path's concatenated widths at
    # the CFG batch 8, and the decoder of 4 images from 128 to 1024 px
    *((f"sdxl_unet_{c}x{hw}_b8", 8, c, hw, 32, 1e-5, False, "silu", False)
      for c, hw in ((320, 128), (640, 128), (960, 128), (320, 64), (640, 64), (960, 64),
                    (1280, 64), (1920, 64), (640, 32), (1280, 32), (1920, 32), (2560, 32))),
    *((f"sdxl_vae_{c}x{hw}_b4", 4, c, hw, 32, 1e-6, False, "silu", False)
      for c, hw in ((512, 128), (512, 256), (512, 512), (256, 512), (256, 1024), (128, 1024))),
    ("vae_512x64_b1_channels_last", 1, 512, 64, 32, 1e-6, False, "silu", True),
    *((f"adm256_{c}x{hw}", 1, c, hw, 32, 1e-5, True, "silu", False)
      for c, hw in ((256, 256), (512, 32), (1024, 8))),
    *((f"vdiff_film_{c}x{hw}", 1, c, hw, 1, 1e-5, True, "relu", False)
      for c, hw in ((128, 256), (256, 128), (512, 32))),
)
# bf16 outputs (y, dx): one rounding to bf16 (2^-9 of a value) plus fp32
# sums taken in another order, against the largest plain fp32 magnitude
GN_RTOL = 1e-2
# fp32 statistics and sums: summation order only
GN_STATS_RTOL = 1e-4
# GroupNormSiLU calls of the SD UNet (22 res blocks x 2 and conv_norm_out),
# of the KL-VAE decoder (14 res blocks x 2 and conv_norm_out) and encoder
# (10 x 2 and conv_norm_out); a guided step runs the UNet and the decoder
# forward and backward
GN_PER_UNET_EVAL = 45
GN_PER_DECODE = 29
GN_PER_ENCODE = 21
GN_PER_GUIDED_STEP = GN_PER_UNET_EVAL + GN_PER_DECODE
# SDXL's UNet: 17 res blocks x 2 and conv_norm_out; its decoder is SD's
GN_PER_SDXL_UNET_EVAL = 35
# The fused residual add + LayerNorm's sites, (site, batch, tokens,
# channels): the transformer blocks of SDXL's UNet at its CFG batch 8 (60
# blocks at 1,024 tokens of 1,280, 10 at 4,096 of 640) and of SD-1.5's at
# b8's CFG batch 16 (its four levels); each with the branch to add and
# without
LN_SITES = (
    ("sdxl_1280x1024_b8", 8, 1024, 1280), ("sdxl_640x4096_b8", 8, 4096, 640),
    ("sd_320x4096_b16", 16, 4096, 320), ("sd_640x1024_b16", 16, 1024, 640),
    ("sd_1280x256_b16", 16, 256, 1280), ("sd_1280x64_b16", 16, 64, 1280),
)
# the op's calls a UNet evaluation: three a transformer block (norm1 without
# a branch, norm2 and norm3 with one), in bf16 with no gradient; none where a
# gradient flows through the UNet (the guided step)
LN_PER_UNET_EVAL = {"layer_norm": 16, "add_layer_norm": 32}  # SD-1.x: 16 blocks
LN_PER_SDXL_UNET_EVAL = {"layer_norm": 70, "add_layer_norm": 140}
LN_PER_GUIDED_STEP = {"layer_norm": 0, "add_layer_norm": 0}
LSE_ATOL = 1e-3
# the Hopper forward's lse: fp32 statistics of one ex2.approx a score and
# one logf a row, a few fp32 ulps of values up to ~20 (2e-6 measured on an
# H100 at every site)
WGMMA_LSE_ATOL = 1e-5
# Off the main path: fp32 inputs (the kernels' scalar path: the plain
# version's fp32 arithmetic up to summation order, so 1e-4; d = 64 too) and
# bf16 inputs (KERNEL_RTOL), all viewed from (B, S, H * D) projections as the
# SD UNet passes them: batch 2 at S = 1024 (d = 40, 80 and ADM's 64) and at
# 768px's S = 2304, the VAE's d = 512 at S = 1024, and Sk of a single K/V
# tile of the bf16 forward (128 keys at d = 40, 32 at d = 512).
# (dtype, batch, heads, seq_q, seq_k, head_dim)
FP32_RTOL = 1e-4
EXTRA_CASES = (
    ("float32", 1, 2, 256, 256, 40), ("float32", 1, 2, 256, 256, 80),
    ("float32", 1, 1, 256, 256, 512), ("float32", 1, 2, 256, 256, 64),
    ("bfloat16", 2, 2, 1024, 1024, 40), ("bfloat16", 2, 2, 1024, 1024, 80),
    ("bfloat16", 2, 2, 2304, 2304, 40), ("bfloat16", 2, 2, 2304, 2304, 80),
    ("bfloat16", 2, 2, 1024, 1024, 64),
    ("bfloat16", 1, 1, 1024, 1024, 512),
    ("bfloat16", 1, 2, 256, 128, 40), ("bfloat16", 1, 1, 128, 32, 512),
)
# kernel route vs plain route through the whole bf16 model, relative L2
# error. Both routes are bf16 approximations: the plain route rounds the
# scores to bf16 before its fp32 softmax (as the JAX dot-product path does),
# and with random weights the scores reach tens, where bf16's spacing is
# 0.125. So each route is also held against an fp32 copy of the model, and
# the kernel route must be no less accurate than the plain one (within
# ROUTE_MARGIN), besides the direct comparison below.
ROUTE_FWD_RTOL = 5e-2
ROUTE_GRAD_RTOL = 1e-1
ROUTE_MARGIN = 1.25
SOURCES = {
    # d = 512; every head_dim up to 128 runs FWD_WGMMA_SOURCE's forward
    "flash_fwd": "perceptor_tpu_torch/csrc/flash_mma.cu",
    "flash_dq": "perceptor_tpu_torch/csrc/flash_mma.cu",
    "flash_dkv": "perceptor_tpu_torch/csrc/flash_mma.cu",
}
FWD_WGMMA_SOURCE = "perceptor_tpu_torch/csrc/flash_wgmma.cu"
REPLACES = {
    "flash_fwd": "perceptor_tpu/ops/flash_attention_kernel.py:45",
    "flash_dq": "perceptor_tpu/ops/flash_attention_kernel.py:126",
    "flash_dkv": "perceptor_tpu/ops/flash_attention_kernel.py:159",
}
FLOPS_PER_S2D = {"flash_fwd": 4, "flash_dq": 6, "flash_dkv": 8}
# the model FLOPs of an attention, per b h s^2 d: q k^T and p v forward, and
# the input gradient's four products (the flash backward's 6 + 8 recompute
# the scores, so the kernels do more than the model)
MODEL_FLOPS_PER_S2D = {"forward": 4, "backward": 8}
REMAT_STEPS = 2


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def site_work(kernel: str, b: int, h: int, s: int, d: int):
    """(FLOPs, bytes) the kernel must do and move at one site: each input
    read once, each output written once."""
    flops = FLOPS_PER_S2D[kernel] * b * h * s * s * d
    tensor = b * h * s * d * 2
    rows = b * h * s * 4
    if kernel == "flash_fwd":
        nbytes = 4 * tensor + rows  # q, k, v -> o, lse
    elif kernel == "flash_dq":
        nbytes = 5 * tensor + 2 * rows  # q, k, v, do, lse, delta -> dq
    else:
        nbytes = 6 * tensor + 2 * rows  # q, k, v, do, lse, delta -> dk, dv
    return flops, nbytes


_SPIN_CYCLES_PER_MS = None


def spin_cycles_per_ms() -> float:
    """Cycles of `torch.cuda._sleep` (a kernel that spins on the device) per
    millisecond, measured once."""
    global _SPIN_CYCLES_PER_MS
    import torch

    if _SPIN_CYCLES_PER_MS is None:
        cycles = 10_000_000
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS = cycles / start.elapsed_time(end)
    return _SPIN_CYCLES_PER_MS


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device ms per call of `fn`, by CUDA events around `reps` calls. A
    wrapper call costs the host tens of microseconds, more than a small
    kernel runs, and events around calls enqueued at the host's pace would
    time the host. So the device first spins for twice the time the host
    needs to enqueue all the calls (its pace is taken from the warm-up, at
    most 200 ms of spin): the timed calls queue up behind the spin and run
    back to back."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(spin_cycles_per_ms() * min(2.0 * reps * host_ms, 200.0)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def site_inputs(b, h, s, d, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn((b, h, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(4)
    ]


def adm_site_inputs(b, h, s, d, seed):
    """q, k, v, do as the ADM `AttentionBlock` hands them over: q, k and v
    are views of one (B, S, H * 3 * D) qkv projection whose channels are
    [head0(q|k|v), head1(q|k|v), ...]; do is the gradient of the
    (B, S, H * D) merge, viewed (B, H, S, D)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, s, h * 3 * d), generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (qkv.view(b, s, h, 3, d)[:, :, :, i].transpose(1, 2) for i in range(3))
    do = torch.randn((b, s, h * d), generator=gen, device="cuda").to(torch.bfloat16)
    return [q, k, v, do.view(b, s, h, d).transpose(1, 2)]


def projection_site_inputs(b, h, s, d, seed):
    """q, k, v, do as `CrossAttention` hands them over: each a (B, S, H * D)
    projection viewed (B, H, S, D)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [
        torch.randn((b, s, h * d), generator=gen, device="cuda").to(torch.bfloat16)
        .view(b, s, h, d).transpose(1, 2)
        for _ in range(4)
    ]


# how each LDM site's module hands q, k and v to `attention`
LDM_SITE_INPUTS = (projection_site_inputs, adm_site_inputs, site_inputs)
# and each SDXL site's: `CrossAttention`'s projections, the VAE's `AttnBlock`
SDXL_SITE_INPUTS = (projection_site_inputs, projection_site_inputs, site_inputs)


def phase_kernels(fa) -> dict:
    """Each kernel against its plain version at the main paths' shapes, the
    backward both on the plain forward's lse and on the forward kernel's; at
    SDXL_SITES, whose path runs no backward, the forward, and at its UNet
    sites the backward on the forward kernel's lse."""
    import torch

    errors = {name: 0.0 for name in REPLACES}
    sites = []
    site_list = [(site, site_inputs) for site in SITES]
    site_list += [(site, adm_site_inputs) for site in ADM_SITES]
    site_list += list(zip(LDM_SITES, LDM_SITE_INPUTS))
    for i, ((site, b, h, s, d, _), make_inputs) in enumerate(site_list):
        q, k, v, do = make_inputs(b, h, s, d, seed=i)
        scale = 1.0 / math.sqrt(d)
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        o_ref, lse_ref = fa.flash_forward_plain(qf, kf, vf, scale)
        o, lse = fa.flash_forward(q, k, v, scale)
        # both backward versions take the same residuals: the plain forward's
        o_in = o_ref.to(torch.bfloat16)
        delta = (o_in.float() * dof).sum(-1)
        dq_ref = fa.flash_dq_plain(qf, kf, vf, dof, lse_ref, delta, scale)
        dk_ref, dv_ref = fa.flash_dkv_plain(qf, kf, vf, dof, lse_ref, delta, scale)
        dq = fa.flash_dq(q, k, v, do, lse_ref, delta, scale)
        dq2 = fa.flash_dq(q, k, v, do, lse_ref, delta, scale)
        dk, dv = fa.flash_dkv(q, k, v, do, lse_ref, delta, scale)
        dk2, dv2 = fa.flash_dkv(q, k, v, do, lse_ref, delta, scale)
        torch.cuda.synchronize()
        if not torch.equal(dq, dq2):
            raise AssertionError(f"flash_dq at {site}: two launches differ")
        if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
            raise AssertionError(f"flash_dkv at {site}: two launches differ")
        checks = {
            "o": ("flash_fwd", o, o_ref), "dq": ("flash_dq", dq, dq_ref),
            "dk": ("flash_dkv", dk, dk_ref), "dv": ("flash_dkv", dv, dv_ref),
        }
        record = {"site": site, "shape": [b, h, s, d], "q_strides": list(q.stride())}
        for out_name, (kernel, got, ref) in checks.items():
            err = float((got.float() - ref).abs().max())
            tol = KERNEL_RTOL * float(ref.abs().max())
            if not err <= tol:
                raise AssertionError(f"{kernel} {out_name} at {site}: max |err| {err} > {tol}")
            errors[kernel] = max(errors[kernel], err)
            record[out_name] = {"max_abs_err": err, "tol": tol}
        design = fa.fwd_design(q.shape[-1], q.dtype)
        lse_tol = WGMMA_LSE_ATOL if design == "wgmma" else LSE_ATOL
        lse_err = float((lse - lse_ref).abs().max())
        if not lse_err <= lse_tol:
            raise AssertionError(f"flash_fwd lse at {site}: max |err| {lse_err} > {lse_tol}")
        record["lse"] = {"max_abs_err": lse_err, "tol": lse_tol}
        record["fwd_design"] = design
        record["backward_on_fwd_lse"] = check_backward_on_forward(
            fa, site, (q, k, v, do), (o, lse), (dq_ref, dk_ref, dv_ref))
        record["dq_bitwise_repeatable"] = True
        record["dkv_bitwise_repeatable"] = True
        sites.append(record)
    # the CFG sampling step's batch-2 sites, strided as the UNet passes them
    cfg_sites = []
    for i, (site, b, h, s, d, _) in enumerate(CFG_SITES):
        for record in check_strided(fa, ("bfloat16", b, h, s, s, d), seed=80 + i):
            kernel = OUT_KERNEL[record["out"]]
            errors[kernel] = max(errors[kernel], record["max_abs_err"])
            cfg_sites.append({"site": site, **record})
    sdxl_sites = []
    for i, ((site, b, h, s, d, _), make_inputs) in enumerate(zip(SDXL_SITES, SDXL_SITE_INPUTS)):
        # the UNet's sites: the backward too, on the forward's lse
        record = check_forward(fa, site, make_inputs(b, h, s, d, seed=120 + i),
                               backward=site.startswith("sdxl_unet"))
        errors["flash_fwd"] = max(errors["flash_fwd"], record["o"]["max_abs_err"])
        sdxl_sites.append(record)
    extra = []
    for i, case in enumerate(EXTRA_CASES):
        extra.extend(check_strided(fa, case, seed=50 + i))
    emit({"phase": "kernels", "ok": True, "sites": sites, "cfg_sites": cfg_sites,
          "sdxl_sites": sdxl_sites, "off_path": extra})
    return errors


def check_forward(fa, site, inputs, backward=False) -> dict:
    """The forward kernel against its plain version on one site's bf16 q, k
    and v (a path that runs no backward): o within KERNEL_RTOL of the plain
    fp32 result's largest magnitude, lse within LSE_ATOL (WGMMA_LSE_ATOL on
    the Hopper forward); raises above them. With `backward`, also
    `check_backward_on_forward`."""
    import torch

    q, k, v, do = inputs
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_forward(q, k, v, scale)
    o_ref, lse_ref = fa.flash_forward_plain(q.float(), k.float(), v.float(), scale)
    torch.cuda.synchronize()
    err, tol = float((o.float() - o_ref).abs().max()), KERNEL_RTOL * float(o_ref.abs().max())
    if not err <= tol:
        raise AssertionError(f"flash_fwd o at {site}: max |err| {err} > {tol}")
    design = fa.fwd_design(q.shape[-1], q.dtype)
    lse_tol = WGMMA_LSE_ATOL if design == "wgmma" else LSE_ATOL
    lse_err = float((lse - lse_ref).abs().max())
    if not lse_err <= lse_tol:
        raise AssertionError(f"flash_fwd lse at {site}: max |err| {lse_err} > {lse_tol}")
    record = {"site": site, "shape": list(q.shape), "q_strides": list(q.stride()),
              "fwd_design": design, "o": {"max_abs_err": err, "tol": tol},
              "lse": {"max_abs_err": lse_err, "tol": lse_tol}}
    if backward:
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        delta = (o_ref.to(q.dtype).float() * dof).sum(-1)
        refs = (fa.flash_dq_plain(qf, kf, vf, dof, lse_ref, delta, scale),
                *fa.flash_dkv_plain(qf, kf, vf, dof, lse_ref, delta, scale))
        record["backward_on_fwd_lse"] = check_backward_on_forward(
            fa, site, inputs, (o, lse), refs)
    return record


def check_backward_on_forward(fa, site, inputs, forward, refs) -> dict:
    """dq and dk/dv from the forward kernel's o and lse, as autograd hands
    them over, against the plain fp32 gradients `refs` (from the plain
    forward's lse): each within KERNEL_RTOL of the reference's largest
    magnitude; raises above it."""
    import torch

    q, k, v, do = inputs
    o, lse = forward
    scale = 1.0 / math.sqrt(q.shape[-1])
    delta = (o.float() * do.float()).sum(-1)
    outs = (fa.flash_dq(q, k, v, do, lse, delta, scale),
            *fa.flash_dkv(q, k, v, do, lse, delta, scale))
    torch.cuda.synchronize()
    record = {}
    for name, got, ref in zip(("dq", "dk", "dv"), outs, refs):
        err, tol = float((got.float() - ref).abs().max()), KERNEL_RTOL * float(ref.abs().max())
        if not err <= tol:
            raise AssertionError(f"{name} on the forward's lse at {site}: max |err| {err} > {tol}")
        record[name] = {"max_abs_err": err, "tol": tol}
    return record


OUT_KERNEL = {"o": "flash_fwd", "dq": "flash_dq", "dk": "flash_dkv", "dv": "flash_dkv"}


def check_strided(fa, case, seed) -> list:
    """All three kernels against their plain versions on (B, S, H * D)
    projections viewed as (B, H, S, D), the UNet's strided layout; raises on
    an error above the tolerance."""
    import torch

    dtype, b, h, sq, sk, d = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        torch.randn((b, s, h * d), generator=gen, device="cuda")
        .to(getattr(torch, dtype)).view(b, s, h, d).transpose(1, 2)
        for s in (sq, sk, sk, sq)
    )
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    o_ref, lse_ref = fa.flash_forward_plain(qf, kf, vf, scale)
    delta = (o_ref.to(q.dtype).float() * dof).sum(-1)
    refs = [o_ref, fa.flash_dq_plain(qf, kf, vf, dof, lse_ref, delta, scale),
            *fa.flash_dkv_plain(qf, kf, vf, dof, lse_ref, delta, scale)]
    outs = [fa.flash_forward(q, k, v, scale)[0], fa.flash_dq(q, k, v, do, lse_ref, delta, scale),
            *fa.flash_dkv(q, k, v, do, lse_ref, delta, scale)]
    torch.cuda.synchronize()
    rtol = FP32_RTOL if dtype == "float32" else KERNEL_RTOL
    records = []
    for out_name, got, ref in zip(("o", "dq", "dk", "dv"), outs, refs):
        err, tol = float((got.float() - ref).abs().max()), rtol * float(ref.abs().max())
        if not err <= tol:
            raise AssertionError(f"{out_name} at {list(case)}: max |err| {err} > {tol}")
        records.append({"case": list(case), "out": out_name, "max_abs_err": err, "tol": tol})
    return records


def phase_kernel_info(fa, library) -> None:
    """Per kernel at each site's head_dim: registers, local bytes, dynamic
    shared bytes, threads and resident blocks per SM from the CUDA runtime,
    and ptxas's spill report from the build."""
    import re

    import torch

    info = [
        {"kernel": name, "site": site, "head_dim": d,
         **fa.kernel_info(name.removeprefix("flash_"), d, torch.bfloat16)}
        for site, _, _, _, d, _ in SITES + ADM_SITES + LDM_SITES + SDXL_SITES
        for name in REPLACES
    ]
    for record in info:
        if record["kernel"] == "flash_fwd" and record["local_bytes"]:
            raise AssertionError(f"flash_fwd at {record['site']}: {record['local_bytes']} "
                                 "local (spill) bytes")
    ptxas = []
    report = library.with_suffix(".ptxas.txt")
    for mangled, body in re.findall(
        r"Function properties for (\S+)\n(.*?)(?=Compile time|\Z)", report.read_text(), re.S
    ):
        kernel = re.search(r"((?:flash_)?(?:fwd_wgmma|fwd|dq|dkv)_kernel)I", mangled)
        numbers = lambda pattern: [int(x) for x in re.findall(pattern, body)]
        ptxas.append({
            "kernel": kernel.group(1) if kernel else mangled,
            "bf16": "bfloat16" in mangled,
            "template": [int(x) for x in re.findall(r"Li(\d+)E", mangled)],
            "registers": numbers(r"Used (\d+) registers"),
            "spill_stores": numbers(r"(\d+) bytes spill stores"),
            "spill_loads": numbers(r"(\d+) bytes spill loads"),
        })
    emit({"phase": "kernel_info", "ok": True, "runtime": info, "ptxas": ptxas})


def gn_inputs(case, seed):
    """x (bf16, NCHW), scale, bias and dy of one GroupNorm site: activations
    of mean 0.5 and spread 2, the affine near (1, 0), (C,) or (N, C) fp32."""
    import torch

    _, n, c, hw, _, _, per_sample, _, channels_last = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((n, c, hw, hw), generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
    layout = torch.channels_last if channels_last else torch.contiguous_format
    x = x.contiguous(memory_format=layout)
    shape = (n, c) if per_sample else (c,)
    scale = 1 + 0.2 * torch.randn(shape, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(shape, generator=gen, device="cuda")
    dy = torch.randn((n, c, hw, hw), generator=gen, device="cuda").to(torch.bfloat16)
    return x, scale, bias, dy.contiguous(memory_format=layout)


def phase_group_norm(gn) -> dict:
    """The GroupNorm + activation kernels against their plain version on the
    same bf16 inputs, forward and backward, at the main paths' shapes (GN_SITES):
    the output and dx (in bf16) held within GN_RTOL of the plain fp32
    result's largest magnitude, mean, rstd and the (N, C) sums within
    GN_STATS_RTOL, two backward launches bitwise equal; then the device ms
    of each against the byte bound (each input byte read once, each output
    byte written once, at the card's peak), the plain version's ms and
    `F.group_norm` + the activation (forward only), which the port never
    calls. Returns {kernel: largest max |err|}."""
    import torch
    import torch.nn.functional as F

    from perceptor_tpu_torch.utils.flops import card_peaks

    _, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    library_act = {"silu": F.silu, "relu": F.relu, "gelu": F.gelu}
    errors = {"gn_forward": 0.0, "gn_backward": 0.0}
    records = []
    for i, case in enumerate(GN_SITES):
        site, n, c, hw, groups, eps, per_sample, act, channels_last = case
        x, scale, bias, dy = gn_inputs(case, seed=200 + i)
        y, mean, rstd = gn._gn_op(x, scale, bias, groups, eps, torch.bfloat16, act)
        y_ref, mean_ref, rstd_ref = gn.group_norm_act_plain(x, scale, bias, groups, eps,
                                                            torch.float32, act)
        dx, dh, dhx = gn._gn_bwd_op(dy, x, scale, bias, mean, rstd, act)
        dx2, _, _ = gn._gn_bwd_op(dy, x, scale, bias, mean, rstd, act)
        dx_ref, dh_ref, dhx_ref = gn.group_norm_act_backward_plain(
            dy, x.float(), scale, bias, mean, rstd, act)
        torch.cuda.synchronize()
        if not torch.equal(dx, dx2):
            raise AssertionError(f"group norm backward at {site}: two launches differ")
        if not (y.is_contiguous() and dx.is_contiguous()):
            raise AssertionError(f"group norm at {site}: outputs not NCHW")
        record = {"site": site, "shape": [n, c, hw, hw], "groups": groups, "eps": eps,
                  "affine": "(N, C)" if per_sample else "(C,)", "activation": act,
                  "channels_last": channels_last}
        checks = {"y": ("gn_forward", y, y_ref, GN_RTOL),
                  "mean": ("gn_forward", mean, mean_ref, GN_STATS_RTOL),
                  "rstd": ("gn_forward", rstd, rstd_ref, GN_STATS_RTOL),
                  "dx": ("gn_backward", dx, dx_ref, GN_RTOL),
                  "dh_sum": ("gn_backward", dh, dh_ref, GN_STATS_RTOL),
                  "dhx_sum": ("gn_backward", dhx, dhx_ref, GN_STATS_RTOL)}
        for name, (kernel, got, ref, rtol) in checks.items():
            err = float((got.float() - ref).abs().max())
            scale_ref = float(ref.abs().max())
            if not err <= rtol * scale_ref:
                raise AssertionError(f"group norm {name} at {site}: max |err| {err} > "
                                     f"{rtol} x {scale_ref}")
            errors[kernel] = max(errors[kernel], err)
            record[name] = {"max_abs_err": err, "rel_err": err / scale_ref, "rtol": rtol}
        elements = x.numel()
        timed = {
            "forward_ms": lambda: gn._gn_op(x, scale, bias, groups, eps, torch.bfloat16, act),
            "backward_ms": lambda: gn._gn_bwd_op(dy, x, scale, bias, mean, rstd, act),
            "plain_forward_ms": lambda: gn.group_norm_act_plain(
                x, scale, bias, groups, eps, torch.bfloat16, act),
            "plain_backward_ms": lambda: gn.group_norm_act_backward_plain(
                dy, x, scale, bias, mean, rstd, act),
        }
        if not per_sample and act in library_act:
            timed["library_forward_ms"] = lambda: library_act[act](
                F.group_norm(x, groups, scale.to(x.dtype), bias.to(x.dtype), eps))
        for name, fn in timed.items():
            record[name] = time_ms(fn)
        # x in, y out (2 bytes each); x and dy in, dx out
        record["forward_bound_ms"] = 4 * elements / peak_bw * 1e3
        record["backward_bound_ms"] = 6 * elements / peak_bw * 1e3
        record["forward_roofline"] = record["forward_bound_ms"] / record["forward_ms"]
        record["backward_roofline"] = record["backward_bound_ms"] / record["backward_ms"]
        records.append(record)
    emit({"phase": "group_norm", "ok": True, "rtol": GN_RTOL, "stats_rtol": GN_STATS_RTOL,
          "sites": records})
    return errors


def ln_inputs(site, seed):
    """x and h (bf16 (B, S, C), a residual of mean 0.3 and spread 1.5 and a
    branch of spread 1) and a LayerNorm's fp32 affine near (1, 0)."""
    import torch

    _, b, s, c = site
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((b, s, c), generator=gen, device="cuda") * 1.5 + 0.3).to(torch.bfloat16)
    h = torch.randn((b, s, c), generator=gen, device="cuda").to(torch.bfloat16)
    weight = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
    bias = 0.2 * torch.randn(c, generator=gen, device="cuda")
    return x, h, weight, bias


def phase_layer_norm(ln) -> dict:
    """The fused residual add + LayerNorm kernel against its plain version on
    the same bf16 inputs at LN_SITES, with the branch and without: r bitwise
    the plain bf16 add; y within one bf16 spacing of each row's largest
    fp32 magnitude of the plain fp32 norm, and the share of y equal to the
    plain version's bf16; two launches bitwise equal. Then the device ms of
    a call against its byte bound (x and h read, r and y written: 8 bytes
    an element; 4 without h), the plain version (the add, `.float()`, fp32
    `F.layer_norm`, one cast to bf16) and ATen's bf16 `F.layer_norm` after
    the add, which the port never calls. Returns the largest max |err| of y."""
    import torch
    import torch.nn.functional as F

    from perceptor_tpu_torch.utils.flops import card_peaks

    _, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    eps, worst, records = 1e-5, 0.0, []
    for i, site in enumerate(LN_SITES):
        name, b, s, c = site
        x, h, weight, bias = ln_inputs(site, seed=400 + i)
        w16, b16 = weight.to(torch.bfloat16), bias.to(torch.bfloat16)
        for branch in (h, None):
            r, y = ln._ln_op(x, branch, weight, bias, eps)
            r2, y2 = ln._ln_op(x, branch, weight, bias, eps)
            r_ref, y_plain = ln.add_layer_norm_plain(x, branch, weight, bias, eps)
            y32 = F.layer_norm(r_ref.float(), (c,), weight, bias, eps)
            torch.cuda.synchronize()
            label = f"layer norm at {name} ({'with' if branch is not None else 'without'} h)"
            if not (torch.equal(r2, r) and torch.equal(y2, y)):
                raise AssertionError(f"{label}: two launches differ")
            if branch is not None and not torch.equal(r, r_ref):
                raise AssertionError(f"{label}: r is not the bf16 add")
            if branch is None and r.numel():
                raise AssertionError(f"{label}: r written without h")
            err = (y.float() - y32).abs().amax(dim=-1)
            spacing = torch.exp2(torch.floor(torch.log2(y32.abs().amax(dim=-1))) - 7)
            if not bool((err <= spacing).all()):
                over = float((err / spacing).max())
                raise AssertionError(f"{label}: y off by {over} bf16 spacings of its row")
            worst = max(worst, float(err.max()))
            bytes_per = 8 if branch is not None else 4
            record = {
                "site": name, "shape": [b, s, c], "with_h": branch is not None,
                "max_abs_err": float(err.max()),
                "max_err_in_spacings": float((err / spacing).max()),
                "equal_to_plain_share": float((y == y_plain).float().mean()),
                "kernel_ms": time_ms(lambda: ln._ln_op(x, branch, weight, bias, eps)),
                "plain_ms": time_ms(lambda: ln.add_layer_norm_plain(x, branch, weight, bias,
                                                                    eps)),
                "library_ms": time_ms(lambda: F.layer_norm(
                    x if branch is None else x + branch, (c,), w16, b16, eps)),
                "bound_ms": bytes_per * x.numel() / peak_bw * 1e3,
            }
            record["roofline"] = record["bound_ms"] / record["kernel_ms"]
            records.append(record)
    emit({"phase": "layer_norm", "ok": True, "sites": records})
    return {"add_layer_norm": worst}


def check_ln_launches(path: str, got: dict, evals: int, per_eval: dict) -> None:
    """LN_LAUNCHES of `evals` UNet evaluations against `per_eval` each."""
    want = {k: n * evals for k, n in per_eval.items()}
    if got != want:
        raise AssertionError(f"{path}: LayerNorm launches {got}, want {want}")


def phase_layer_norm_guided(ln, step) -> None:
    """LN_LAUNCHES of two guided steps, asserted LN_PER_GUIDED_STEP: the
    gradient flows through the UNet, so its blocks keep the unfused chain.
    (`sample` and `sdxl_sample` assert the launches of a UNet evaluation.)"""
    import torch

    latents, context = step.initial_inputs()
    torch.cuda.synchronize()
    ln.reset_launches()
    for _ in range(2):
        latents, _ = step.guided_denoise_step(latents, context)
    torch.cuda.synchronize()
    check_ln_launches("guided step", dict(ln.LN_LAUNCHES), 2, LN_PER_GUIDED_STEP)
    emit({"phase": "layer_norm_guided", "ok": True, "per_guided_step": LN_PER_GUIDED_STEP})


def record_gn_calls(gn, fn) -> list:
    """Runs `fn()` with the GroupNorm ops watched: one (kind, x shape, x
    dtype, per-sample affine, groups, eps, output dtype, activation, whether
    x's memory is other than NCHW, so the wrapper copies it) per call, kind
    "forward" or "backward"."""
    calls = []
    ops = gn._gn_op, gn._gn_bwd_op

    def forward(x, scale, bias, groups, eps, out_dtype, act):
        calls.append(("forward", tuple(x.shape), x.dtype, max(scale.ndim, bias.ndim) == 2,
                      groups, eps, out_dtype, act, not x.is_contiguous()))
        return ops[0](x, scale, bias, groups, eps, out_dtype, act)

    def backward(dy, x, scale, bias, mean, rstd, act):
        calls.append(("backward", tuple(x.shape), x.dtype, max(scale.ndim, bias.ndim) == 2,
                      mean.shape[1], None, dy.dtype, act, not x.is_contiguous()))
        return ops[1](dy, x, scale, bias, mean, rstd, act)

    gn._gn_op, gn._gn_bwd_op = forward, backward
    try:
        fn()
    finally:
        gn._gn_op, gn._gn_bwd_op = ops
    return calls


def time_gn_calls(gn, calls, peak_bw) -> dict:
    """Device ms of every recorded call, summed: the kernels, their byte
    bound (each input byte read once and each output byte written once, at
    the card's peak), the plain version, and for the forward
    `F.group_norm` + the activation in the input's dtype, which the port
    never calls."""
    import collections

    import torch
    import torch.nn.functional as F

    library_act = {"silu": F.silu, "relu": F.relu, "gelu": F.gelu, "none": lambda v: v}
    totals = collections.Counter()
    for i, (call, count) in enumerate(sorted(collections.Counter(calls).items(), key=str)):
        kind, shape, dtype, per_sample, groups, eps, out_dtype, act, channels_last = call
        layout = torch.channels_last if channels_last else torch.contiguous_format
        gen = torch.Generator(device="cuda").manual_seed(300 + i)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype).contiguous(
            memory_format=layout)
        affine = shape[:2] if per_sample else shape[1:2]
        scale = 1 + 0.2 * torch.randn(affine, generator=gen, device="cuda")
        bias = 0.2 * torch.randn(affine, generator=gen, device="cuda")
        item = x.element_size()
        if kind == "forward":
            totals["forward_ms"] += count * time_ms(
                lambda: gn._gn_op(x, scale, bias, groups, eps, out_dtype, act))
            totals["plain_forward_ms"] += count * time_ms(
                lambda: gn.group_norm_act_plain(x, scale, bias, groups, eps, out_dtype, act))
            if not per_sample:
                w, b = scale.to(dtype), bias.to(dtype)
                totals["library_forward_ms"] += count * time_ms(
                    lambda: library_act[act](F.group_norm(x, groups, w, b, eps)))
            out_item = torch.empty((), dtype=out_dtype).element_size()
            totals["forward_bound_ms"] += count * x.numel() * (item + out_item) / peak_bw * 1e3
        else:
            _, mean, rstd = gn._gn_op(x, scale, bias, groups, 1e-5, out_dtype, act)
            dy = torch.randn(shape, generator=gen, device="cuda").to(out_dtype).contiguous(
                memory_format=layout)
            totals["backward_ms"] += count * time_ms(
                lambda: gn._gn_bwd_op(dy, x, scale, bias, mean, rstd, act))
            totals["plain_backward_ms"] += count * time_ms(
                lambda: gn.group_norm_act_backward_plain(dy, x, scale, bias, mean, rstd, act))
            totals["backward_bound_ms"] += (count * x.numel() * (2 * item + dy.element_size())
                                            / peak_bw * 1e3)
    return dict(totals)


def phase_group_norm_steps(gn, step, sd) -> dict:
    """GN_LAUNCHES of a guided step (GN_PER_GUIDED_STEP forward and backward
    calls, each of two launches), of one batch-16 UNet evaluation (a b8
    step: GN_PER_UNET_EVAL forward calls) and of a batch-8 decode
    (GN_PER_DECODE); each asserted, and every call's input asserted NCHW
    memory, which the kernels take without a copy. Then the device ms of each one's
    GroupNorm calls (`time_gn_calls`), the b8 step's with the decode's over
    the call's 20 steps. Returns the launches per guided step."""
    import torch

    from perceptor_tpu_torch.utils.flops import card_peaks

    _, peak_bw = card_peaks(torch.cuda.get_device_name(0))
    latents, context = step.initial_inputs()
    step.guided_denoise_step(latents, context)  # warm-up
    torch.cuda.synchronize()
    gn.reset_launches()
    steps = 2
    for _ in range(steps):
        latents, _ = step.guided_denoise_step(latents, context)
    torch.cuda.synchronize()
    guided = per_step(gn.GN_LAUNCHES, steps)
    want = {name: GN_PER_GUIDED_STEP for name in gn.GN_LAUNCHES}
    if guided != want:
        raise AssertionError(f"guided step: GroupNorm launches per step {guided}, want {want}")
    guided_calls = record_gn_calls(gn, lambda: step.guided_denoise_step(latents, context))
    gen = torch.Generator(device="cuda").manual_seed(7)
    b8 = torch.randn((16, 4, IMAGE_SIZE // 8, IMAGE_SIZE // 8), generator=gen, device="cuda")
    with torch.no_grad():
        context = sd.conditioning([PROMPT] * 16)
        torch.cuda.synchronize()
        gn.reset_launches()
        unet_calls = record_gn_calls(gn, lambda: sd.predictions(b8, 500, context))
        torch.cuda.synchronize()
        unet = dict(gn.GN_LAUNCHES)
        gn.reset_launches()
        decode_calls = record_gn_calls(gn, lambda: sd.decode(b8[:8]))
        torch.cuda.synchronize()
        decode = dict(gn.GN_LAUNCHES)
    for name, got, calls in (("b8 UNet evaluation", unet, GN_PER_UNET_EVAL),
                             ("batch-8 decode", decode, GN_PER_DECODE)):
        want = {"gn_stats": calls, "gn_apply": calls, "gn_bwd_sums": 0, "gn_bwd_dx": 0}
        if got != want:
            raise AssertionError(f"{name}: GroupNorm launches {got}, want {want}")
    for name, recorded in (("guided step", guided_calls), ("b8 UNet evaluation", unet_calls),
                           ("batch-8 decode", decode_calls)):
        copied = [call[:2] for call in recorded if call[-1]]
        if copied:
            raise AssertionError(f"{name}: GroupNorm inputs not NCHW {copied}")
    unet_ms = time_gn_calls(gn, unet_calls, peak_bw)
    decode_ms = time_gn_calls(gn, decode_calls, peak_bw)
    emit({"phase": "group_norm_steps", "ok": True, "per_guided_step": guided,
          "per_b8_unet_evaluation": unet, "per_b8_decode": decode,
          "per_b8_step_20_steps": {k: unet[k] + decode[k] / 20 for k in unet},
          "guided_step_ms": time_gn_calls(gn, guided_calls, peak_bw),
          "b8_unet_evaluation_ms": unet_ms, "b8_decode_ms": decode_ms,
          "b8_step_ms": {k: unet_ms.get(k, 0.0) + decode_ms.get(k, 0.0) / 20
                         for k in set(unet_ms) | set(decode_ms)}})
    return guided


def per_step(launches: dict, steps: int) -> dict:
    """Measured launches of each kernel per step."""
    return {name: n / steps for name, n in launches.items()}


def check_per_step(path: str, measured: dict) -> None:
    if measured != PER_STEP[path]:
        raise AssertionError(f"{path}: kernel launches per step {measured}, want {PER_STEP[path]}")


def phase_guided_step(fa, step):
    """Five full-width guided steps through the kernels: (launches, launches
    per step)."""
    import torch

    latents, context = step.initial_inputs()
    step.guided_denoise_step(latents, context)  # warm-up: cuDNN/cuBLAS set-up
    torch.cuda.synchronize()
    # the peak is the step's own: no blocks cached by earlier phases
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
    t0 = time.perf_counter()
    events[0].record()
    losses = []
    for i in range(STEPS):
        latents, loss = step.guided_denoise_step(latents, context)
        events[i + 1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, STEPS)
    check_per_step("guided_step", measured)
    if not (torch.isfinite(latents).all() and all(torch.isfinite(x) for x in losses)):
        raise AssertionError("non-finite latents or loss")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(STEPS)]
    emit({
        "phase": "guided_step", "ok": True, "config": "sd-v1-512", "steps": STEPS,
        "latents_shape": list(latents.shape), "losses": [float(x) for x in losses],
        "step_ms": step_ms, "steady_ms_per_step": sorted(step_ms)[STEPS // 2],
        "wall_s": wall, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def phase_flops(step) -> None:
    """The model FLOPs of one guided step (`utils.flops.count_model_flops`,
    every attention on the plain route) less those of the kernel route,
    whose launches no counter sees: the plain route's attention products,
    which must equal MODEL_FLOPS_PER_S2D x b h s^2 d over the step's 11
    sites, forward (a no-grad `loss_and_noise`) and forward + backward (the
    step)."""
    import torch

    from perceptor_tpu_torch.utils.flops import count_flops, count_model_flops

    latents, context = step.initial_inputs()

    def forward():
        with torch.no_grad():
            step.loss_and_noise(latents, context)

    def guided():
        step.guided_denoise_step(latents, context)

    record = {"phase": "flops", "ok": True}
    forward_s2d = MODEL_FLOPS_PER_S2D["forward"]
    for name, fn, per_s2d in (("forward", forward, forward_s2d),
                              ("guided_step", guided, forward_s2d + MODEL_FLOPS_PER_S2D["backward"])):
        model, kernel_route = count_model_flops(fn), count_flops(fn)
        torch.cuda.empty_cache()
        want = sum(n * per_s2d * b * h * s * s * d for _, b, h, s, d, n in SITES)
        if model - kernel_route != want:
            raise AssertionError(
                f"flops {name}: plain-route attention {model - kernel_route}, want {want}")
        record[name] = {"model_flops": model, "kernel_route_flops": kernel_route,
                        "attention_flops": model - kernel_route, "want": want}
    emit(record)


def phase_guided_step_remat(fa, step):
    """REMAT_STEPS guided steps of a `remat` build of the same seeded models
    beside as many of `step`: launches a step held to
    PER_STEP["guided_step_remat"], losses bitwise equal to the plain
    step's, each one's peak memory (from an emptied allocator cache).
    Returns (launches, launches per step)."""
    import torch

    from perceptor_tpu_torch import guided_step

    remat = guided_step.build("sd-v1-512", device="cuda", seed=step.seed, remat=True)
    record, launches = {"phase": "guided_step_remat", "ok": True, "steps": REMAT_STEPS}, {}
    for name, run in (("plain", step), ("remat", remat)):
        latents, context = run.initial_inputs()
        run.guided_denoise_step(latents, context)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        losses = []
        start.record()
        for _ in range(REMAT_STEPS):
            latents, loss = run.guided_denoise_step(latents, context)
            losses.append(float(loss).hex())
        end.record()
        torch.cuda.synchronize()
        launches[name] = dict(fa.LAUNCHES)
        record[name] = {"losses": losses, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                        "ms_per_step": start.elapsed_time(end) / REMAT_STEPS,
                        "launches_per_step": per_step(launches[name], REMAT_STEPS)}
    check_per_step("guided_step", record["plain"]["launches_per_step"])
    measured = record["remat"]["launches_per_step"]
    check_per_step("guided_step_remat", measured)
    if record["remat"]["losses"] != record["plain"]["losses"]:
        raise AssertionError(f"guided_step_remat: losses {record['remat']['losses']} differ "
                             f"from the plain step's {record['plain']['losses']}")
    emit(record)
    del remat
    torch.cuda.empty_cache()
    return launches["remat"], measured


def _set_route(module, use_flash) -> None:
    for m in module.modules():
        if hasattr(m, "use_flash"):
            m.use_flash = use_flash


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_route_parity(step) -> None:
    """Kernel route vs plain route at full width, same weights and inputs,
    both also against an fp32 copy of each model."""
    import torch

    latents, context = step.initial_inputs()
    gen = torch.Generator(device="cuda").manual_seed(7)
    probe = torch.randn(latents.shape, generator=gen, device="cuda")
    # a CFG evaluation: the latents twice, under two contexts (batch 2)
    context2 = step.initial_inputs(batch=2)[1]

    def unet_out_grad(unet, use_flash):
        _set_route(unet, use_flash)
        x = latents.detach().requires_grad_(True)
        with torch.enable_grad():
            out = unet(x, step.from_idx.float(), context)
            (grad,) = torch.autograd.grad((out * probe).sum(), x)
        return out.detach(), grad

    def unet_cfg_out(unet, use_flash):
        _set_route(unet, use_flash)
        with torch.no_grad():
            return (unet(torch.cat([latents, latents]), step.from_idx.float().expand(2), context2),)

    def vae_decode(vae, use_flash):
        _set_route(vae, use_flash)
        with torch.no_grad():
            return (vae.decode(latents),)

    results = {}
    for name, bf16_model, run, outputs in (
        ("unet", step.unet, unet_out_grad, ("out", "latent_grad")),
        ("unet_cfg", step.unet, unet_cfg_out, ("out",)),
        ("vae_decode", step.vae, vae_decode, ("images",)),
    ):
        results.update(compare_routes(name, bf16_model, run, outputs))
    emit({"phase": "route_parity", "ok": True, "metric": "relative L2 error", **results})


def compare_routes(name, bf16_model, run, outputs) -> dict:
    """`run(model, use_flash)` through the kernels, through the plain
    attention route and on an fp32 copy of the model: per output, the
    relative L2 errors, held to ROUTE_FWD_RTOL (ROUTE_GRAD_RTOL for a
    gradient) between the routes and to ROUTE_MARGIN against fp32."""
    import copy

    import torch

    kernel, plain = run(bf16_model, None), run(bf16_model, False)
    reference = run(copy.deepcopy(bf16_model).float(), False)
    _set_route(bf16_model, None)
    results = {}
    for i, out_name in enumerate(outputs):
        tol = ROUTE_GRAD_RTOL if out_name.endswith("_grad") else ROUTE_FWD_RTOL
        rec = {
            "kernel_vs_plain": _rel_l2(kernel[i], plain[i]), "tol": tol,
            "kernel_vs_fp32": _rel_l2(kernel[i], reference[i]),
            "plain_vs_fp32": _rel_l2(plain[i], reference[i]),
        }
        key = f"{name}_{out_name}"
        if not rec["kernel_vs_plain"] <= tol:
            raise AssertionError(f"route parity {key}: {rec}")
        if not rec["kernel_vs_fp32"] <= ROUTE_MARGIN * rec["plain_vs_fp32"] + 1e-3:
            raise AssertionError(f"kernel route less accurate than the plain one, {key}: {rec}")
        results[key] = rec
    del reference
    torch.cuda.empty_cache()
    return results


def phase_profile(step) -> dict:
    """One guided step under torch.profiler: device time by kernel, and the
    step's device busy share."""
    latents, context = step.initial_inputs()
    record = {"phase": "profile", "ok": True,
              **profile_record(lambda: step.guided_denoise_step(latents, context))}
    emit(record)
    return record


def profile_record(fn) -> dict:
    """`fn()` once under torch.profiler: its wall ms, device ms, busy share,
    flash-kernel ms, kernel launches and the 15 kernels of most device time;
    and `fn()` unprofiled (CUDA events, median of 3), against which the busy
    share is also given: the profiler's cost per launch stretches the
    profiled wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    unprofiled = []
    for _ in range(3):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        unprofiled.append(start.elapsed_time(end))
    unprofiled_ms = sorted(unprofiled)[1]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [
        e for e in prof.key_averages()
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
    ]
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    # flash_attention.cu's (fp32) kernels are flash_*_kernel; the bf16 ones,
    # flash_wgmma.cu's forward up to d = 128 and flash_mma.cu's (forward at
    # d = 512, dq, dk/dv), are flash::*
    flash_us = sum(
        e.self_device_time_total for e in kernels if "flash_" in e.key or "flash::" in e.key
    )
    return {
        "step_wall_ms": wall_ms,
        "device_ms": total_us / 1e3, "device_busy_share": total_us / 1e3 / wall_ms,
        "unprofiled_ms": unprofiled_ms,
        "device_busy_share_unprofiled": total_us / 1e3 / unprofiled_ms,
        "flash_kernels_ms": flash_us / 1e3, "kernel_launches": sum(e.count for e in kernels),
        "top": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3, "count": e.count}
                for e in top],
    }


class PartTimer:
    """Shadows methods of `obj` with wrappers that record CUDA events and
    the flash launches around each call; `remove()` restores them."""

    def __init__(self, fa, obj, names):
        self.fa, self.obj, self.calls = fa, obj, {name: [] for name in names}
        self.design_calls = {name: [] for name in names}  # the forward by design
        self.last = {}  # each name's last result
        for name in names:
            setattr(obj, name, self._wrap(name, getattr(obj, name)))

    def _wrap(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            before = dict(self.fa.LAUNCHES)
            designs = dict(self.fa.FWD_DESIGN_LAUNCHES)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            launched = {k: self.fa.LAUNCHES[k] - before[k] for k in before}
            self.calls[name].append((start, end, launched))
            self.design_calls[name].append(
                {k: self.fa.FWD_DESIGN_LAUNCHES[k] - designs[k] for k in designs})
            self.last[name] = out
            return out

        return timed

    def remove(self) -> None:
        for name in self.calls:
            delattr(self.obj, name)

    def ms(self, name) -> float:
        return sum(start.elapsed_time(end) for start, end, _ in self.calls[name])

    def launches(self, name) -> dict:
        """Launches of each kernel over every call of `name`."""
        return {k: sum(launched[k] for _, _, launched in self.calls[name]) for k in self.fa.LAUNCHES}

    def designs(self, name) -> dict:
        """The forward's launches by design over every call of `name`."""
        return {k: sum(launched[k] for launched in self.design_calls[name])
                for k in self.fa.FWD_DESIGN_LAUNCHES}


def check_designs(path, timer, evals, decodes) -> dict:
    """The forward's launches by design in `timer`'s sample loop and decode
    against FWD_DESIGNS_PER_UNET_EVAL[path] and FWD_DESIGNS_PER_VAE_CALL;
    raises on a difference. Returns them."""
    designs = {"sample_loop": timer.designs("sample_loop"), "decode": timer.designs("decode")}
    want = {"sample_loop": {k: n * evals for k, n in FWD_DESIGNS_PER_UNET_EVAL[path].items()},
            "decode": {k: n * decodes for k, n in FWD_DESIGNS_PER_VAE_CALL.items()}}
    if designs != want:
        raise AssertionError(f"{path}: the forward's launches by design {designs}, want {want}")
    return designs


def phase_sample(fa, sd, gn, ln):
    """`StableDiffusion.sample` at 512px, batch 1, CFG 7: a 20-step DDIM, a
    10-step DPM-Solver++(2M) and an img2img/RePaint run from the first
    image. Per run: the schedule's k, flash launches (the loop's per UNet
    evaluation, the decode's and encode's, each asserted), the GroupNorm
    launches (GN_PER_UNET_EVAL a UNet evaluation, GN_PER_DECODE and
    GN_PER_ENCODE a decode and an encode; asserted), the LayerNorm
    launches (LN_PER_UNET_EVAL a UNet evaluation; asserted), the image
    (asserted finite, (1, 3, 512, 512)), seconds per image, the text
    encoding, the UNet loop and the decode apart, and peak memory. Returns
    (launches, launches per UNet evaluation)."""
    import torch

    def generator(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    size = (IMAGE_SIZE, IMAGE_SIZE)
    sd.sample([PROMPT], n_steps=2, size=size, generator=generator(1))  # warm-up
    torch.cuda.synchronize()
    totals = {name: 0 for name in REPLACES}
    runs, first_image = [], None
    for name, options in SAMPLE_RUNS:
        if name == "img2img":
            options = {**options, "init_images": first_image}
        k = len(sd.schedule_indices(options["n_steps"], from_index=options.get("from_index", 999)))
        evals = k * (1 + options.get("n_resample", 0))
        timer = PartTimer(fa, sd, ("conditioning", "sample_loop", "decode", "encode"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        gn.reset_launches()
        ln.reset_launches()
        t0 = time.perf_counter()
        images = sd.sample([PROMPT], guidance_scale=CFG_SCALE, size=size, generator=generator(0),
                           **options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        gn_launches = dict(gn.GN_LAUNCHES)
        ln_launches = dict(ln.LN_LAUNCHES)
        timer.remove()
        parts = {part: timer.launches(part) for part in timer.calls}
        measured = per_step(parts["sample_loop"], evals)
        check_per_step("sample", measured)
        vae_calls = {"decode": 1, "encode": int("init_images" in options)}
        for part, calls in vae_calls.items():
            if parts[part] != {k: n * calls for k, n in PER_VAE_CALL.items()}:
                raise AssertionError(f"sample {name}: {part} launched {parts[part]}")
        # text encoding (masked, S = 77) launches none
        if any(parts["conditioning"].values()):
            raise AssertionError(f"sample {name}: the text encoder launched a flash kernel")
        designs = check_designs("sample", timer, evals, vae_calls["decode"])
        if launches != {k: sum(p[k] for p in parts.values()) for k in launches}:
            raise AssertionError(f"sample {name}: launches {launches} outside {parts}")
        gn_calls = (GN_PER_UNET_EVAL * evals + GN_PER_DECODE * vae_calls["decode"]
                    + GN_PER_ENCODE * vae_calls["encode"])
        gn_want = {"gn_stats": gn_calls, "gn_apply": gn_calls, "gn_bwd_sums": 0, "gn_bwd_dx": 0}
        if gn_launches != gn_want:
            raise AssertionError(f"sample {name}: GroupNorm launches {gn_launches}, "
                                 f"want {gn_want}")
        check_ln_launches(f"sample {name}", ln_launches, evals, LN_PER_UNET_EVAL)
        if images.shape != (1, 3, IMAGE_SIZE, IMAGE_SIZE) or not torch.isfinite(images).all():
            raise AssertionError(f"sample {name}: images {tuple(images.shape)} not finite")
        loop_ms = timer.ms("sample_loop")
        runs.append({
            "run": name, "options": {k: v for k, v in options.items() if k != "init_images"},
            "k": k, "unet_evals": evals, "launches": launches,
            "launches_per_unet_eval": measured, "group_norm_launches": gn_launches,
            "layer_norm_launches": ln_launches, "fwd_designs": designs,
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "s_per_image": wall,
            "ms_per_sampling_step": loop_ms / k, "ms_per_unet_eval": loop_ms / evals,
            "loop_ms": loop_ms, "text_encode_ms": timer.ms("conditioning"),
            "decode_ms": timer.ms("decode"), "encode_ms": timer.ms("encode"),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
        for kernel in totals:
            totals[kernel] += launches[kernel]
        if first_image is None:
            first_image = images
    emit({"phase": "sample", "ok": True, "model": MODEL, "guidance_scale": CFG_SCALE,
          "runs": runs})
    return totals, measured


def phase_sdxl_sample(fa, gn, ln):
    """`StableDiffusion(SDXL_MODEL).sample` at SDXL_SIZE px: SDXL_BATCH
    prompts, CFG SDXL_CFG_SCALE (zeros for the unconditional half),
    SDXL_STEPS-step DDIM. Flash launches per UNet evaluation (PER_STEP) and
    per decode (PER_VAE_CALL), GroupNorm launches (GN_PER_SDXL_UNET_EVAL an
    evaluation, GN_PER_DECODE a decode), LayerNorm launches
    (LN_PER_SDXL_UNET_EVAL an evaluation), none from the two text towers, the
    images finite; seconds, ms a step and peak memory. Returns (launches,
    launches per UNet evaluation)."""
    import torch

    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    t0 = time.perf_counter()
    sd = StableDiffusion(SDXL_MODEL, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = [PROMPT, "a watercolor of a fox in the snow", "a castle", "a robot reading"]
    prompts = (prompts * SDXL_BATCH)[:SDXL_BATCH]
    size = (SDXL_SIZE, SDXL_SIZE)
    options = dict(n_steps=SDXL_STEPS, guidance_scale=SDXL_CFG_SCALE, size=size)
    sd.sample(prompts, generator=torch.Generator(device="cuda").manual_seed(1), **options)
    k = len(sd.schedule_indices(SDXL_STEPS))
    timer = PartTimer(fa, sd, ("conditioning", "sample_loop", "decode"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    gn.reset_launches()
    ln.reset_launches()
    t0 = time.perf_counter()
    images = sd.sample(prompts, generator=torch.Generator(device="cuda").manual_seed(0),
                       **options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    gn_launches = dict(gn.GN_LAUNCHES)
    ln_launches = dict(ln.LN_LAUNCHES)
    timer.remove()
    parts = {part: timer.launches(part) for part in timer.calls}
    measured = per_step(parts["sample_loop"], k)
    check_per_step("sdxl_sample", measured)
    if parts["decode"] != PER_VAE_CALL:
        raise AssertionError(f"sdxl_sample: decode launched {parts['decode']}")
    if any(parts["conditioning"].values()):
        raise AssertionError("sdxl_sample: a text tower launched a flash kernel")
    designs = check_designs("sdxl_sample", timer, k, 1)
    gn_calls = GN_PER_SDXL_UNET_EVAL * k + GN_PER_DECODE
    gn_want = {"gn_stats": gn_calls, "gn_apply": gn_calls, "gn_bwd_sums": 0, "gn_bwd_dx": 0}
    if gn_launches != gn_want:
        raise AssertionError(f"sdxl_sample: GroupNorm launches {gn_launches}, want {gn_want}")
    check_ln_launches("sdxl_sample", ln_launches, k, LN_PER_SDXL_UNET_EVAL)
    shape = (SDXL_BATCH, 3, SDXL_SIZE, SDXL_SIZE)
    if tuple(images.shape) != shape or not torch.isfinite(images).all():
        raise AssertionError(f"sdxl_sample: images {tuple(images.shape)} not finite")
    loop_ms = timer.ms("sample_loop")
    emit({"phase": "sdxl_sample", "ok": True, "model": SDXL_MODEL, "build_s": build_s,
          "parameters": {part: sum(p.numel() for p in getattr(sd, part).parameters())
                         for part in sd.parts},
          "k": k, "launches": launches, "launches_per_unet_eval": measured,
          "fwd_designs": designs,
          "group_norm_launches": gn_launches, "layer_norm_launches": ln_launches,
          "images_shape": list(images.shape),
          "image_mean": float(images.mean()), "image_std": float(images.std()),
          "s_per_call": wall, "ms_per_sampling_step": loop_ms / k,
          "text_encode_ms": timer.ms("conditioning"), "decode_ms": timer.ms("decode"),
          "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    del sd
    torch.cuda.empty_cache()
    return launches, measured


def phase_sample_profile(sd) -> dict:
    """One CFG sampling step (the batched UNet evaluation and the DDIM
    update) under torch.profiler."""
    import torch

    uncond, cond = sd.conditioning([""]), sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE), torch.Generator("cuda").manual_seed(2))
    pairs = sd.schedule_indices(20)[:1]
    sd.sample_loop(latents, pairs, uncond, cond, CFG_SCALE)
    record = {"phase": "sample_profile", "ok": True,
              **profile_record(lambda: sd.sample_loop(latents, pairs, uncond, cond, CFG_SCALE))}
    emit(record)
    return record


def phase_guided_sample(fa, sd, step):
    """`engine.guided_sample` at 512px with CFG 7 and guidance scale 0.5,
    the loss the guided step's prompt-bank loss (CLIP ViT-B/32, spherical
    distance to its fixed target), for GUIDED_SAMPLE_STEPS steps: finite latents and losses, 21
    launches of each kernel a step, ms per step and peak memory. Returns
    (launches, launches per step, the per-step losses)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample

    uncond, cond = sd.conditioning([""]), sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE), torch.Generator("cuda").manual_seed(3))
    pairs = sd.schedule_indices(GUIDED_SAMPLE_STEPS)
    options = dict(conditioning=cond, uncond_conditioning=uncond, cfg_scale=CFG_SCALE,
                   guidance_scale=0.5)
    guided_sample(sd, [step.clip_loss], latents, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, losses = guided_sample(sd, [step.clip_loss], latents, pairs, **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step("guided_sample", measured)
    if not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("guided_sample: non-finite latents or losses")
    emit({
        "phase": "guided_sample", "ok": True, "steps": k, "pairs": pairs.tolist(),
        "guidance_scale": 0.5, "cfg_scale": CFG_SCALE, "losses": losses.tolist(),
        "latents_shape": list(out.shape), "ms_per_step": start.elapsed_time(end) / k,
        "wall_s": wall, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured, losses


def text_loss(prompts=TEXT_PROMPTS[:1]):
    """`losses.CLIP` with a text prompt bank; every call shares the one
    memoized tower."""
    from perceptor_tpu_torch import losses

    return losses.CLIP(CLIP_NAME).add_texts_(list(prompts))


def phase_text_tower(fa):
    """Both CLIP towers at full width; the text tower on two prompts against
    an fp32 copy of the same weights. Returns the wrapper, which the later
    phases' losses share."""
    import copy

    import torch

    from perceptor_tpu_torch import models
    from perceptor_tpu_torch.models.clip.tokenizer import tokenize

    t0 = time.perf_counter()
    clip = models.CLIP(CLIP_NAME)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    fa.reset_launches()
    prompts = list(TEXT_PROMPTS)
    encodings = clip.encode_texts(prompts)  # warm-up, and the checked result
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(5):
        start.record()
        clip.encode_texts(prompts)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    tokens = tokenize(prompts, clip.config.context_length, tokenizer=clip.tokenizer)
    with torch.no_grad():
        reference = copy.deepcopy(clip.module).float().encode_text(tokens)
    reference = reference / reference.norm(dim=-1, keepdim=True)
    err = _rel_l2(encodings, reference)
    norms = encodings.norm(dim=-1)
    if tuple(encodings.shape) != (len(prompts), clip.config.embed_dim):
        raise AssertionError(f"text_tower: encodings {tuple(encodings.shape)}")
    if not torch.isfinite(encodings).all() or float((norms - 1).abs().max()) > 1e-5:
        raise AssertionError(f"text_tower: norms {norms.tolist()}")
    if not err <= TEXT_BF16_RTOL:
        raise AssertionError(f"text_tower: bf16 vs fp32 relative L2 {err} > {TEXT_BF16_RTOL}")
    if any(fa.LAUNCHES.values()):
        raise AssertionError(f"text_tower: flash launches {dict(fa.LAUNCHES)}")
    emit({
        "phase": "text_tower", "ok": True, "model": CLIP_NAME, "build_s": build_s,
        "parameters": sum(p.numel() for p in clip.module.parameters()),
        "prompts": prompts, "eot_positions": tokens.argmax(-1).tolist(),
        "encodings_shape": list(encodings.shape), "bf16_vs_fp32_rel_l2": err,
        "tol": TEXT_BF16_RTOL, "cosine_between_prompts": float(encodings[0] @ encodings[1]),
        "text_encode_ms": sorted(times)[len(times) // 2],
    })
    return clip


def run_optimize(fa, name, drawer, objectives, steps, extra=None, evaluate=None,
                 loss_weights=None) -> dict:
    """`engine.optimize` for `steps` Adam steps, a CUDA event after each:
    the loss must fall (the history's last entry below its first, or, where
    every step draws new cutouts, `evaluate()` after the steps below
    `evaluate()` before them), parameters and history stay finite, no flash
    kernel may launch. ms per step is the median after the first (warm-up)
    step; the peak is read from an emptied allocator cache."""
    import torch

    from perceptor_tpu_torch import engine

    before = evaluate() if evaluate else None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    t0 = time.perf_counter()
    events[0].record()
    _, history = engine.optimize(
        drawer, objectives, n_steps=steps, loss_weights=loss_weights,
        callback=lambda i, params, aux: events[i + 1].record(),
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    check_per_step("optimize", per_step(launches, steps))
    finite = all(math.isfinite(h) for h in history) and all(
        bool(torch.isfinite(p).all()) for p in drawer.parameters())
    if not finite:
        raise AssertionError(f"{name}: non-finite history or parameters")
    first, last = (before, evaluate()) if evaluate else (history[0], history[-1])
    if not last < first:
        raise AssertionError(f"{name}: loss did not fall: {first} -> {last} ({history})")
    step_ms = [events[i].elapsed_time(events[i + 1]) for i in range(steps)]
    record = {
        "steps": steps, "loss_first": first, "loss_last": last, "history": history,
        "first_step_ms": step_ms[0], "ms_per_step": sorted(step_ms[1:])[(steps - 1) // 2],
        "wall_s": wall, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "flash_launches": launches, **(extra or {}),
    }
    return record


def profile_summary(fn) -> dict:
    """`profile_record(fn)` without its list of kernels: device ms,
    launches and the busy share."""
    record = profile_record(fn)
    return {k: record[k] for k in (
        "device_ms", "kernel_launches", "unprofiled_ms", "device_busy_share_unprofiled",
        "step_wall_ms", "device_busy_share")}


def step_profile(drawer, objectives, loss_weights=None) -> dict:
    """One more optimization step under torch.profiler (and three unprofiled
    before it): device ms, launches and the busy share."""
    from perceptor_tpu_torch import engine

    return profile_summary(engine.make_guidance_step(drawer, objectives,
                                                     loss_weights=loss_weights))


def phase_optimize_raw(fa) -> None:
    """Text-prompted optimization of a 256px pixel grid, then the same steps
    through `run_on_device`."""
    import torch

    from perceptor_tpu_torch import drawers, engine, losses

    shape = (1, 3, RAW_SIZE, RAW_SIZE)
    objectives = [text_loss(), losses.Smoothness()]
    drawer = drawers.Raw.random_fractal_image(shape, seed=0)
    record = run_optimize(fa, "optimize_raw", drawer, objectives, RAW_STEPS)
    if tuple(drawer.synthesize().shape) != shape:
        raise AssertionError(f"optimize_raw: images {tuple(drawer.synthesize().shape)}")
    # the same steps with no read-back: a fresh drawer from the same seed
    fresh = drawers.Raw.random_fractal_image(shape, seed=0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fa.reset_launches()
    start.record()
    params, history = engine.run_on_device(fresh, objectives, fresh.params, RAW_STEPS)
    end.record()
    torch.cuda.synchronize()
    check_per_step("optimize", per_step(dict(fa.LAUNCHES), RAW_STEPS))
    if not (history.is_cuda and params.is_cuda and history.shape == (RAW_STEPS,)):
        raise AssertionError("run_on_device: history or parameters left the device")
    diff = float((history.cpu() - torch.tensor(record["history"])).abs().max())
    if not diff <= RUN_ON_DEVICE_ATOL:
        raise AssertionError(f"run_on_device: history differs from optimize's by {diff}")
    pixels_diff = float((params - drawer.pixels.detach()).abs().max())
    emit({
        "phase": "optimize_raw", "ok": True, "model": CLIP_NAME, "image_size": RAW_SIZE,
        "prompt": TEXT_PROMPTS[0], **record,
        "run_on_device": {
            "ms_per_step": start.elapsed_time(end) / RAW_STEPS,
            "history_max_abs_diff": diff, "tol": RUN_ON_DEVICE_ATOL,
            "pixels_max_abs_diff": pixels_diff,
        },
        "profile": step_profile(drawer, objectives),
    })


def phase_optimize_cutouts(fa) -> None:
    """A 512px pixel grid under the CLIP loss over n random cutouts."""
    import torch

    from perceptor_tpu_torch import drawers
    from perceptor_tpu_torch.transforms import random_cutouts

    clip_loss = text_loss()
    shape = (1, 3, CUTOUT_IMAGE_SIZE, CUTOUT_IMAGE_SIZE)

    def fixed_draw_loss(drawer) -> float:
        generator = torch.Generator(device="cuda").manual_seed(1)
        with torch.no_grad():
            return float(clip_loss(random_cutouts(
                drawer.synthesize(), generator, CUTOUT_EVAL_COUNT, cut_size=CUT_SIZE,
                cut_pow=CUT_POW)))

    runs = []
    for n in CUTOUT_COUNTS:
        generator = torch.Generator(device="cuda").manual_seed(0)
        shapes = set()

        def cutout_loss(images, n=n, generator=generator, shapes=shapes):
            cutouts = random_cutouts(images, generator, n, cut_size=CUT_SIZE, cut_pow=CUT_POW)
            shapes.add(tuple(cutouts.shape))
            return clip_loss(cutouts)

        drawer = drawers.Raw.random_fractal_image(shape, seed=0)
        record = run_optimize(fa, f"optimize_cutouts n={n}", drawer, [cutout_loss],
                              CUTOUT_STEPS, {"n_cutouts": n},
                              evaluate=lambda: fixed_draw_loss(drawer))
        if shapes != {(n, 3, CUT_SIZE, CUT_SIZE)}:
            raise AssertionError(f"optimize_cutouts n={n}: cutouts {sorted(shapes)}")
        record["cutouts_shape"] = [n, 3, CUT_SIZE, CUT_SIZE]
        record["profile"] = step_profile(drawer, [cutout_loss])
        runs.append(record)
    emit({"phase": "optimize_cutouts", "ok": True, "model": CLIP_NAME,
          "image_size": CUTOUT_IMAGE_SIZE, "cut_size": CUT_SIZE, "cut_pow": CUT_POW,
          "runs": runs})


def phase_optimize_jpeg(fa) -> None:
    """The JPEG drawer: its decode on the card against the CPU's, the round
    trip of the image it encoded, then optimization of its coefficients."""
    import torch

    from perceptor_tpu_torch import drawers, losses
    from perceptor_tpu_torch.drawers import inits
    from perceptor_tpu_torch.drawers.jpeg import decompress_jpeg

    image = inits.fractal((1, 3, RAW_SIZE, RAW_SIZE), seed=0)
    drawer = drawers.JPEG(image)
    with torch.no_grad():
        decoded = drawer.synthesize()
        on_cpu = decompress_jpeg(*(p.detach().cpu() for p in drawer.parameters()),
                                 RAW_SIZE, RAW_SIZE, drawer.factor)
    decode_err = float((decoded.cpu() - on_cpu).abs().max())
    if not decode_err <= JPEG_DECODE_ATOL:
        raise AssertionError(f"optimize_jpeg: decode differs from the CPU's by {decode_err}")
    round_trip = (decoded.cpu() - torch.from_numpy(image)).abs()
    if not float(round_trip.mean()) <= JPEG_ROUND_TRIP_MEAN:
        raise AssertionError(f"optimize_jpeg: round trip mean error {float(round_trip.mean())}")
    objectives = [text_loss(), losses.Smoothness()]
    record = run_optimize(fa, "optimize_jpeg", drawer, objectives, JPEG_STEPS)
    emit({
        "phase": "optimize_jpeg", "ok": True, "model": CLIP_NAME, "image_size": RAW_SIZE,
        "coefficient_shapes": [list(p.shape) for p in drawer.parameters()],
        "decode_vs_cpu_max_abs": decode_err, "decode_tol": JPEG_DECODE_ATOL,
        "round_trip_mean_abs": float(round_trip.mean()),
        "round_trip_max_abs": float(round_trip.max()), "round_trip_mean_tol": JPEG_ROUND_TRIP_MEAN,
        **record, "profile": step_profile(drawer, objectives),
    })


def phase_guided_sample_text(fa, sd):
    """`engine.guided_sample` at 512px with CFG 7 and guidance scale 0.5
    under the text-prompted CLIP loss over 16 random cutouts a step: finite
    latents and losses, 21 launches of each kernel a step, ms per step and
    peak memory. Returns (launches, launches per step)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.transforms import random_cutouts

    uncond, cond = sd.conditioning([""]), sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE), torch.Generator("cuda").manual_seed(4))
    pairs = sd.schedule_indices(GUIDED_TEXT_STEPS)
    shapes = set()

    def augment(generator, images):
        cutouts = random_cutouts(images, generator, GUIDED_TEXT_CUTOUTS)
        shapes.add(tuple(cutouts.shape))
        return cutouts

    options = dict(conditioning=cond, uncond_conditioning=uncond, cfg_scale=CFG_SCALE,
                   guidance_scale=0.5, image_augment=augment)
    objectives = [text_loss()]
    guided_sample(sd, objectives, latents, pairs[:1],
                  generator=torch.Generator("cuda").manual_seed(5), **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, losses = guided_sample(sd, objectives, latents, pairs,
                                generator=torch.Generator("cuda").manual_seed(5), **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step("guided_sample_text", measured)
    if not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("guided_sample_text: non-finite latents or losses")
    if shapes != {(GUIDED_TEXT_CUTOUTS, 3, 224, 224)}:
        raise AssertionError(f"guided_sample_text: cutouts {sorted(shapes)}")
    emit({
        "phase": "guided_sample_text", "ok": True, "steps": k, "pairs": pairs.tolist(),
        "prompt": PROMPT, "n_cutouts": GUIDED_TEXT_CUTOUTS, "guidance_scale": 0.5,
        "cfg_scale": CFG_SCALE, "losses": losses.tolist(), "latents_shape": list(out.shape),
        "ms_per_step": start.elapsed_time(end) / k, "wall_s": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def phase_adm_sample(fa, gd):
    """`GuidedDiffusion.sample` at 512px, batch 1, full depth: the runs of
    ADM_SAMPLE_RUNS, img2img from the first run's image. Per run: the
    schedule's k, the UNet evaluations (k + 1: the last gives the denoised
    images), flash launches per evaluation (asserted: 5 forward, no
    backward), the image (asserted finite, (1, 3, 512, 512); its range is
    reported: like the JAX sampler this one does not clamp), seconds per
    image, ms per step and per evaluation, peak memory. Returns (launches,
    launches per UNet evaluation, the first image)."""
    import torch

    size = (IMAGE_SIZE, IMAGE_SIZE)
    gd.sample(n_steps=2, size=size)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    totals = {name: 0 for name in REPLACES}
    runs, first_image = [], None
    for name, options in ADM_SAMPLE_RUNS:
        if name == "img2img":
            options = {**options, "init_images": first_image}
        k = len(gd.schedule_indices(options["n_steps"], from_index=options.get("from_index", 999),
                                    rho=3.0))
        timer = PartTimer(fa, gd, ("predicted_noise",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        images = gd.sample(n_images=1, size=size,
                           generator=torch.Generator(device="cuda").manual_seed(0), **options)
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        timer.remove()
        evals = len(timer.calls["predicted_noise"])
        if evals != k + 1:
            raise AssertionError(f"adm_sample {name}: {evals} UNet evaluations for k = {k}")
        if launches != timer.launches("predicted_noise"):
            raise AssertionError(f"adm_sample {name}: launches outside the UNet: {launches}")
        measured = per_step(launches, evals)
        check_per_step("adm_sample", measured)
        if images.shape != (1, 3, IMAGE_SIZE, IMAGE_SIZE) or not torch.isfinite(images).all():
            raise AssertionError(f"adm_sample {name}: images {tuple(images.shape)} not finite")
        runs.append({
            "run": name, "options": {k_: v for k_, v in options.items() if k_ != "init_images"},
            "k": k, "unet_evals": evals, "launches": launches, "launches_per_unet_eval": measured,
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "image_min": float(images.min()),
            "image_max": float(images.max()), "s_per_image": wall,
            "ms_per_sampling_step": start.elapsed_time(end) / k,
            "ms_per_unet_eval": timer.ms("predicted_noise") / evals,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
        for kernel in totals:
            totals[kernel] += launches[kernel]
        if first_image is None:
            first_image = images
    # one UNet evaluation under the profiler: device ms and the busy share
    diffused = gd.diffuse_images(first_image.clamp(0, 1), ADM_GUIDED_FROM_INDEX,
                                 generator=torch.Generator(device="cuda").manual_seed(9))

    def evaluate():
        with torch.no_grad():
            gd.predicted_noise(diffused, ADM_GUIDED_FROM_INDEX)

    emit({"phase": "adm_sample", "ok": True, "model": ADM_MODEL, "image_size": IMAGE_SIZE,
          "parameters": sum(p.numel() for p in gd.module.parameters()), "runs": runs,
          "unet_eval_profile": profile_record(evaluate)})
    return totals, measured, first_image


def phase_adm_guided_sample(fa, gd, image):
    """`engine.guided_sample` on the ADM model at 512px under the
    text-prompted CLIP loss over 16 random cutouts a step, from `image`
    diffused to ADM_GUIDED_FROM_INDEX; no generator is passed, so the
    augment draws from the default one. Returns (launches, launches per
    step)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.transforms import random_cutouts

    pairs = gd.schedule_indices(ADM_GUIDED_STEPS, from_index=ADM_GUIDED_FROM_INDEX)
    diffused = gd.diffuse_images(image.clamp(0, 1), int(pairs[0, 0]),
                                 generator=torch.Generator(device="cuda").manual_seed(6))
    shapes = set()

    def augment(generator, images):
        cutouts = random_cutouts(images, generator, ADM_GUIDED_CUTOUTS)
        shapes.add(tuple(cutouts.shape))
        return cutouts

    objectives = [text_loss()]
    options = dict(guidance_scale=0.5, image_augment=augment)
    guided_sample(gd, objectives, diffused, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, losses = guided_sample(gd, objectives, diffused, pairs, **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step("adm_guided_sample", measured)
    if out.shape != diffused.shape or not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("adm_guided_sample: non-finite images or losses")
    if shapes != {(ADM_GUIDED_CUTOUTS, 3, 224, 224)}:
        raise AssertionError(f"adm_guided_sample: cutouts {sorted(shapes)}")
    emit({
        "phase": "adm_guided_sample", "ok": True, "model": ADM_MODEL, "steps": k,
        "pairs": pairs.tolist(), "prompt": PROMPT, "n_cutouts": ADM_GUIDED_CUTOUTS,
        "guidance_scale": 0.5, "losses": losses.tolist(), "images_shape": list(out.shape),
        "ms_per_step": start.elapsed_time(end) / k, "wall_s": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def phase_adm_route_parity(gd) -> None:
    """The ADM UNet forward at 512px and its input gradient: kernel route vs
    plain route, both also against an fp32 copy."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    xs = torch.randn((1, 3, IMAGE_SIZE, IMAGE_SIZE), generator=gen, device="cuda")
    probe = torch.randn((1, 6, IMAGE_SIZE, IMAGE_SIZE), generator=gen, device="cuda")
    timesteps = torch.tensor([600.0], device="cuda")

    def unet_out_grad(unet, use_flash):
        _set_route(unet, use_flash)
        x = xs.detach().requires_grad_(True)
        with torch.enable_grad():
            out = unet(x, timesteps)
            (grad,) = torch.autograd.grad((out * probe).sum(), x)
        return out.detach(), grad

    torch.cuda.reset_peak_memory_stats()
    results = compare_routes("adm_unet", gd.module, unet_out_grad, ("out", "input_grad"))
    emit({"phase": "adm_route_parity", "ok": True, "metric": "relative L2 error",
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **results})


def phase_velocity_sample(fa):
    """`VelocityDiffusion("cc12m_1_cfg")` at 256px, batch 1, conditioned on
    the prompt: the runs of VELOCITY_SAMPLE_RUNS, a `reverse_sample` of the
    first image and a 3-step `guided_sample` under the text loss over float
    (from_t, to_t) pairs. No flash kernel may launch. Returns ({path:
    launches}, {path: launches per step})."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion

    t0 = time.perf_counter()
    vd = VelocityDiffusion(VELOCITY_MODEL, device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    cond = vd.conditioning(texts=[PROMPT])
    end.record()
    torch.cuda.synchronize()
    conditioning_ms = start.elapsed_time(end)
    if tuple(cond.shape) != (1, 1, vd.config.mapping.clip_dim) or not torch.isfinite(cond).all():
        raise AssertionError(f"velocity_sample: conditioning {tuple(cond.shape)}")
    shape = (1, *vd.shape)
    vd.sample(n_steps=2, conditioning=cond)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    def timed(fn):
        """fn() with the UNet evaluations counted and timed: (result,
        record)."""
        timer = PartTimer(fa, vd, ("velocities",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timer.remove()
        evals = len(timer.calls["velocities"])
        return result, {
            "unet_evals": evals, "wall_s": wall, "ms": start.elapsed_time(end),
            "ms_per_unet_eval": timer.ms("velocities") / evals,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        }

    fa.reset_launches()
    runs, first_image = [], None
    for name, options in VELOCITY_SAMPLE_RUNS:
        images, record = timed(lambda: vd.sample(
            n_images=1, conditioning=cond,
            generator=torch.Generator(device="cuda").manual_seed(0), **options))
        if images.shape != shape or not torch.isfinite(images).all():
            raise AssertionError(f"velocity_sample {name}: images {tuple(images.shape)} not finite")
        runs.append({
            "run": name, "options": options, **record, "s_per_image": record["wall_s"],
            "ms_per_sampling_step": record["ms"] / options["n_steps"],
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "image_min": float(images.min()),
            "image_max": float(images.max()),
        })
        if first_image is None:
            first_image = images
    reversed_images, record = timed(lambda: vd.reverse_sample(
        first_image.clamp(0, 1), n_steps=VELOCITY_REVERSE_STEPS, conditioning=cond))
    if reversed_images.shape != shape or not torch.isfinite(reversed_images).all():
        raise AssertionError("velocity_sample: reverse_sample not finite")
    runs.append({"run": "reverse_sample", "options": {"n_steps": VELOCITY_REVERSE_STEPS}, **record,
                 "image_std": float(reversed_images.std())})
    launches = {"velocity_sample": dict(fa.LAUNCHES)}
    total_evals = sum(r["unet_evals"] for r in runs)
    measured = {"velocity_sample": per_step(launches["velocity_sample"], total_evals)}
    check_per_step("velocity_sample", measured["velocity_sample"])

    # guided sampling over float (from_t, to_t) pairs
    pairs = vd.schedule_ts(VELOCITY_GUIDED_STEPS)
    diffused = vd.random_diffused(shape, torch.Generator(device="cuda").manual_seed(7))
    objectives = [text_loss()]
    options = dict(conditioning=cond, guidance_scale=0.5)
    guided_sample(vd, objectives, diffused, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fa.reset_launches()
    (out, losses), record = timed(lambda: guided_sample(vd, objectives, diffused, pairs, **options))
    launches["velocity_guided_sample"] = dict(fa.LAUNCHES)
    measured["velocity_guided_sample"] = per_step(launches["velocity_guided_sample"], len(pairs))
    check_per_step("velocity_guided_sample", measured["velocity_guided_sample"])
    if out.shape != shape or not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("velocity guided_sample: non-finite images or losses")

    def evaluate():
        with torch.no_grad():
            vd.velocities(diffused, 0.5, cond)

    emit({
        "phase": "velocity_sample", "ok": True, "model": VELOCITY_MODEL,
        "image_size": list(vd.shape[1:]), "build_s": build_s,
        "parameters": sum(p.numel() for p in vd.module.parameters()),
        "clip_model": vd.config.mapping.clip_model, "conditioning_ms": conditioning_ms,
        "prompt": PROMPT, "runs": runs,
        "guided_sample": {
            "steps": len(pairs), "pairs": pairs.tolist(), "guidance_scale": 0.5,
            "losses": losses.tolist(), "ms_per_step": record["ms"] / len(pairs), **record,
        },
        "flash_launches": launches, "unet_eval_profile": profile_record(evaluate),
    })
    return launches, measured


def fused_flash_backward(q, k, v, do, scale):
    """PyTorch's one call for the attention backward, the flash kernel
    behind SDPA (head dims up to 256), given its own forward's output and
    logsumexp: a callable computing (dq, dk, dv), or None where the op does
    not take the head_dim."""
    import torch

    if q.shape[-1] > 256:
        return None
    aten = torch.ops.aten
    o, lse, cum_q, cum_k, max_q, max_k, seed, offset, _ = aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, False, False, scale=scale)
    return lambda: aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, lse, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset, scale=scale)


def phase_sample_deepcache(fa, sd):
    """`StableDiffusion.sample` at 512px, CFG 7, DEEPCACHE_STEPS-step DDIM,
    with `cache_interval=DEEPCACHE_INTERVAL` and with 1: each step's flash
    launches checked (a full step 10, a cached one 5), seconds per image of
    both, and the relative L2 between the two images, a fact and not a gate.
    Returns (launches, {path: launches per step})."""
    import torch

    size = (IMAGE_SIZE, IMAGE_SIZE)
    sd.sample([PROMPT], n_steps=4, size=size, cache_interval=DEEPCACHE_INTERVAL)  # warm-up
    torch.cuda.synchronize()
    totals = {name: 0 for name in REPLACES}
    runs, images = [], {}
    for interval in (1, DEEPCACHE_INTERVAL):
        timer = PartTimer(fa, sd, ("cfg_predictions", "decode"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        images[interval] = sd.sample(
            [PROMPT], n_steps=DEEPCACHE_STEPS, guidance_scale=CFG_SCALE, size=size,
            generator=torch.Generator(device="cuda").manual_seed(0), cache_interval=interval)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        timer.remove()
        steps = timer.calls["cfg_predictions"]
        cached = [i % interval != 0 for i in range(len(steps))]
        for i, (_, _, launched) in enumerate(steps):
            want = PER_STEP["sample_deepcache_cached" if cached[i] else "sample_deepcache_full"]
            if launched != want:
                raise AssertionError(f"sample_deepcache interval {interval} step {i}: {launched}")
        if timer.launches("decode") != PER_VAE_CALL:
            raise AssertionError(f"sample_deepcache: decode launched {timer.launches('decode')}")
        img = images[interval]
        if img.shape != (1, 3, IMAGE_SIZE, IMAGE_SIZE) or not torch.isfinite(img).all():
            raise AssertionError(f"sample_deepcache interval {interval}: images not finite")
        step_ms = [start.elapsed_time(end) for start, end, _ in steps]
        runs.append({
            "cache_interval": interval, "k": len(steps), "cached_steps": sum(cached),
            "launches": launches, "s_per_image": wall,
            "ms_full_step": sorted(t for t, c in zip(step_ms, cached) if not c)[
                (len(cached) - sum(cached)) // 2],
            "ms_cached_step": (sorted(t for t, c in zip(step_ms, cached) if c)[sum(cached) // 2]
                               if any(cached) else None),
            "decode_ms": timer.ms("decode"), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "image_mean": float(img.mean()), "image_std": float(img.std()),
        })
        for kernel in totals:
            totals[kernel] += launches[kernel]
    emit({"phase": "sample_deepcache", "ok": True, "model": MODEL, "steps": DEEPCACHE_STEPS,
          "guidance_scale": CFG_SCALE, "runs": runs,
          "rel_l2_cached_vs_exact": _rel_l2(images[DEEPCACHE_INTERVAL], images[1])})
    return totals, {"sample_deepcache_full": PER_STEP["sample_deepcache_full"],
                    "sample_deepcache_cached": PER_STEP["sample_deepcache_cached"]}


def phase_ldm(fa, phase, model, runs, sample, evaluate) -> tuple:
    """`sample(options)` for each run of `runs` on a latent-diffusion
    wrapper: the UNet evaluations (k + 1) and their flash launches per
    evaluation (held to PER_STEP[phase]), the decode's (PER_VAE_CALL), no
    launch elsewhere (BERT's 77 tokens take the plain route); finite images
    of LDM_SIZE; seconds per image, ms per UNet evaluation, decode ms and
    peak memory; then `evaluate()`, one UNet evaluation, under the
    profiler. Returns (record, launches, launches per evaluation)."""
    import torch

    sample({"n_steps": 3})  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    totals = {name: 0 for name in REPLACES}
    records = []
    for name, options in runs:
        unet = PartTimer(fa, model.unet, ("forward",))
        parts = PartTimer(fa, model, ("images",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.perf_counter()
        images = sample(options)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        unet.remove()
        parts.remove()
        evals = len(unet.calls["forward"])
        measured = per_step(unet.launches("forward"), evals)
        check_per_step(phase, measured)
        if parts.launches("images") != PER_VAE_CALL or len(parts.calls["images"]) != 1:
            raise AssertionError(f"{phase} {name}: decode launched {parts.launches('images')}")
        outside = {k: launches[k] - unet.launches("forward")[k] - parts.launches("images")[k]
                   for k in launches}
        if any(outside.values()):
            raise AssertionError(f"{phase} {name}: launches outside the UNet and decode {outside}")
        if images.shape != (1, 3, LDM_SIZE, LDM_SIZE) or not torch.isfinite(images).all():
            raise AssertionError(f"{phase} {name}: images {tuple(images.shape)} not finite")
        records.append({
            "run": name, "options": options, "k": evals - 1, "unet_evals": evals,
            "launches": launches, "launches_per_unet_eval": measured,
            "decode_launches": parts.launches("images"), "s_per_image": wall,
            "ms_per_unet_eval": unet.ms("forward") / evals, "decode_ms": parts.ms("images"),
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "image_min": float(images.min()),
            "image_max": float(images.max()), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
        for kernel in totals:
            totals[kernel] += launches[kernel]
    with torch.no_grad():
        profile = profile_record(evaluate)
    record = {"phase": phase, "ok": True, "image_size": LDM_SIZE,
              "parameters": sum(p.numel() for m in (model.unet, model.first_stage)
                                for p in m.parameters()), "runs": records,
              "unet_eval_profile": profile}
    return record, totals, measured


def phase_ldm_text2image(fa):
    """`Text2Image()` at full width, 256px, CFG LDM_CFG_SCALE: the runs of
    LDM_TEXT2IMAGE_RUNS, then the UNet's kernel route against the plain
    route and an fp32 copy (a batched CFG evaluation at index 500)."""
    import torch

    from perceptor_tpu_torch.models.latent_diffusion import BERTTokenizer, Text2Image

    t0 = time.perf_counter()
    model = Text2Image(guidance_scale=LDM_CFG_SCALE, tokenizer=BERTTokenizer(vocab=BERT_VOCAB),
                       device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    size = (LDM_SIZE, LDM_SIZE)

    def sample(options):
        return model.sample([PROMPT], size=size,
                            generator=torch.Generator(device="cuda").manual_seed(0), **options)

    cond = model.conditioning([PROMPT])
    gen = torch.Generator(device="cuda").manual_seed(10)
    latents = torch.randn((1, *model.latent_shape(*size)), generator=gen, device="cuda")
    ts = torch.full((2,), 500.0, device="cuda")
    record, launches, measured = phase_ldm(
        fa, "ldm_text2image", model, LDM_TEXT2IMAGE_RUNS, sample,
        lambda: model.eps(latents, 500, cond))
    record["parameters"] += sum(p.numel() for p in model.bert.parameters())

    def unet_cfg_out(unet, use_flash):
        _set_route(unet, use_flash)
        with torch.no_grad():
            return (unet(torch.cat([latents, latents]), ts, cond),)

    torch.cuda.reset_peak_memory_stats()
    record["route_parity"] = compare_routes("txt2img_unet_cfg", model.unet, unet_cfg_out, ("out",))
    record.update(build_s=build_s, guidance_scale=LDM_CFG_SCALE, prompt=PROMPT,
                  conditioning_shape=list(cond.shape),
                  route_parity_peak_mem_bytes=torch.cuda.max_memory_allocated())
    emit(record)
    return launches, measured


def phase_ldm_face(fa):
    """`Face()` at 256px: the runs of LDM_FACE_RUNS."""
    import torch

    from perceptor_tpu_torch.models.latent_diffusion import Face

    model = Face(device="cuda", seed=0)

    def sample(options):
        return model.sample(n_images=1, size=(LDM_SIZE, LDM_SIZE),
                            generator=torch.Generator(device="cuda").manual_seed(0), **options)

    latents = torch.randn((1, *model.latent_shape(LDM_SIZE, LDM_SIZE)),
                          generator=torch.Generator(device="cuda").manual_seed(12), device="cuda")
    record, launches, measured = phase_ldm(fa, "ldm_face", model, LDM_FACE_RUNS, sample,
                                           lambda: model.eps(latents, 500))
    emit(record)
    return launches, measured


def phase_ldm_super_resolution(fa):
    """`SuperResolution()` on a seeded LDM_SR_LOW_RES image upsampled to the
    LDM_SIZE canvas: the runs of LDM_SR_RUNS (eta 1, the model's default)."""
    import torch

    from perceptor_tpu_torch.models.latent_diffusion import SuperResolution

    model = SuperResolution(device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(11)
    low_res = torch.rand((1, 3, LDM_SR_LOW_RES, LDM_SR_LOW_RES), generator=gen, device="cuda")
    canvas = model.upsample(low_res)
    if canvas.shape != (1, 3, LDM_SIZE, LDM_SIZE):
        raise AssertionError(f"ldm_super_resolution: canvas {tuple(canvas.shape)}")

    def sample(options):
        return model.sample(canvas, generator=torch.Generator(device="cuda").manual_seed(0),
                            **options)

    cond = model.conditioning(canvas)
    latents = torch.randn(cond.shape, generator=torch.Generator(device="cuda").manual_seed(13),
                          device="cuda")
    record, launches, measured = phase_ldm(fa, "ldm_super_resolution", model, LDM_SR_RUNS, sample,
                                           lambda: model.eps(latents, 500, cond))
    record.update(low_res=LDM_SR_LOW_RES, eta=model.eta)
    emit(record)
    return launches, measured


def inpaint_inputs():
    """The fixed synthetic init image (color ramps and a diagonal wave) and
    its mask, 1 on the left half."""
    import torch

    ramp = torch.linspace(0.0, 1.0, IMAGE_SIZE, device="cuda")
    y, x = torch.meshgrid(ramp, ramp, indexing="ij")
    wave = 0.5 + 0.5 * torch.sin(2 * math.pi * (x + y) * 4)
    image = torch.stack([x, y, wave])[None]
    mask = torch.zeros((1, 1, IMAGE_SIZE, IMAGE_SIZE), device="cuda")
    mask[..., : IMAGE_SIZE // 2] = 1.0
    return image, mask


def phase_inpaint_sample(fa, sd):
    """`StableDiffusion(INPAINT_MODEL).sample` at 512px, CFG 7, a 20-step
    DDIM with `replace_diffused` on the synthetic image: launches (10 per
    batched UNet evaluation, PER_VAE_CALL per encode and decode: the uncond
    and cond masked images, the init image, the decode), finite images
    (their range is reported: like JAX's, the decode does not clamp), the
    known region (outside the latent mask the final latents stay within
    (1 - alpha) |init| + 6 sigma of the init latents), seconds per image, ms
    per step, peak memory. Returns (launches, launches per evaluation)."""
    import torch

    image, mask = inpaint_inputs()
    size = (IMAGE_SIZE, IMAGE_SIZE)

    def sample(n_steps):
        return sd.sample([PROMPT], n_steps=n_steps, guidance_scale=CFG_SCALE, size=size,
                         init_images=image, inpainting_masks=mask,
                         generator=torch.Generator(device="cuda").manual_seed(0))

    sample(2)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pairs = sd.schedule_indices(INPAINT_STEPS)
    timer = PartTimer(fa, sd, ("conditioning", "sample_loop", "decode", "encode"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.perf_counter()
    images = sample(INPAINT_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    timer.remove()
    k = len(pairs)
    measured = per_step(timer.launches("sample_loop"), k)
    check_per_step("inpaint_sample", measured)
    # the conditioning calls hold the two masked-image encodes
    for part, calls in (("encode", 3), ("conditioning", 2), ("decode", 1)):
        if timer.launches(part) != {name: n * calls for name, n in PER_VAE_CALL.items()}:
            raise AssertionError(f"inpaint_sample: {part} launched {timer.launches(part)}")
    if len(timer.calls["encode"]) != 3:
        raise AssertionError(f"inpaint_sample: {len(timer.calls['encode'])} encodes")
    outside = {name: launches[name] - timer.launches("sample_loop")[name]
               - timer.launches("encode")[name] - timer.launches("decode")[name]
               for name in launches}
    if any(outside.values()):
        raise AssertionError(f"inpaint_sample: launches outside the loop and the VAE {outside}")
    if images.shape != (1, 3, IMAGE_SIZE, IMAGE_SIZE) or not torch.isfinite(images).all():
        raise AssertionError(f"inpaint_sample: images {tuple(images.shape)} not finite")
    final, init = timer.last["sample_loop"], timer.last["encode"]
    known = (sd.latent_masks(mask) == 0).expand_as(final)
    to = int(pairs[-1, 1])
    alpha, sigma = float(sd.schedule_alphas[to]), float(sd.schedule_sigmas[to])
    bound = (1 - alpha) * float(init.abs().max()) + KNOWN_REGION_NOISE_SIGMAS * sigma
    known_err = float((final - init)[known].abs().max())
    if not (known.float().mean() > 0.4 and known_err <= bound):
        raise AssertionError(f"inpaint_sample: known region {known_err} > {bound}")
    loop_ms = timer.ms("sample_loop")
    emit({
        "phase": "inpaint_sample", "ok": True, "model": INPAINT_MODEL, "steps": k,
        "guidance_scale": CFG_SCALE, "launches": launches, "launches_per_unet_eval": measured,
        "vae_launches": {part: timer.launches(part) for part in ("encode", "decode")},
        "images_shape": list(images.shape), "image_min": float(images.min()),
        "image_max": float(images.max()), "image_mean": float(images.mean()),
        "known_share": float(known.float().mean()), "known_region_max_abs_diff": known_err,
        "known_region_bound": bound,
        "painted_rel_l2_to_init": _rel_l2(final[~known], init[~known]),
        "s_per_image": wall, "ms_per_sampling_step": loop_ms / k,
        "text_and_mask_conditioning_ms": timer.ms("conditioning"),
        "encode_ms": timer.ms("encode"), "decode_ms": timer.ms("decode"),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches, measured


def phase_inpaint_guided_sample(fa, sd, step):
    """`engine.guided_sample` on the inpainting model with CFG 7 over
    `Conditioning`s of the synthetic image and mask, guidance scale 0.5,
    the guided step's loss, INPAINT_GUIDED_STEPS steps: 21 launches of each
    kernel a step, finite latents and losses, ms per step, peak memory.
    Returns (launches, launches per step)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample

    image, mask = inpaint_inputs()
    inpaint = dict(inpainting_masks=mask, inpainting_images=image)
    uncond, cond = sd.conditioning([""], **inpaint), sd.conditioning([PROMPT], **inpaint)
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE),
                                         torch.Generator("cuda").manual_seed(3))
    pairs = sd.schedule_indices(INPAINT_GUIDED_STEPS)
    options = dict(conditioning=cond, uncond_conditioning=uncond, cfg_scale=CFG_SCALE,
                   guidance_scale=0.5)
    guided_sample(sd, [step.clip_loss], latents, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, losses = guided_sample(sd, [step.clip_loss], latents, pairs, **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step("inpaint_guided_sample", measured)
    if not (torch.isfinite(out).all() and torch.isfinite(losses).all()):
        raise AssertionError("inpaint_guided_sample: non-finite latents or losses")
    emit({
        "phase": "inpaint_guided_sample", "ok": True, "model": INPAINT_MODEL, "steps": k,
        "pairs": pairs.tolist(), "guidance_scale": 0.5, "cfg_scale": CFG_SCALE,
        "losses": losses.tolist(), "latents_shape": list(out.shape),
        "ms_per_step": start.elapsed_time(end) / k, "wall_s": wall,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured


def phase_inpaint_route_parity(sd) -> None:
    """One batched CFG evaluation of the 9-channel UNet at 512px on the
    synthetic image's conditionings: the kernel route against the plain
    route and an fp32 copy, with route_parity's forward gates."""
    import dataclasses

    import torch

    image, mask = inpaint_inputs()
    inpaint = dict(inpainting_masks=mask, inpainting_images=image)
    uncond, cond = sd.conditioning([""], **inpaint), sd.conditioning([PROMPT], **inpaint)
    cond2 = dataclasses.replace(cond, encodings=torch.cat([uncond.encodings, cond.encodings]))
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE),
                                         torch.Generator("cuda").manual_seed(14))
    unet_input = cond2.input(torch.cat([latents, latents]))
    ts = torch.full((2,), 500.0, device="cuda")

    def unet_cfg_out(unet, use_flash):
        _set_route(unet, use_flash)
        with torch.no_grad():
            return (unet(unet_input, ts, cond2.encodings),)

    torch.cuda.reset_peak_memory_stats()
    results = compare_routes("inpaint_unet_cfg", sd.unet, unet_cfg_out, ("out",))
    emit({"phase": "inpaint_route_parity", "ok": True, "metric": "relative L2 error",
          "unet_input_shape": list(unet_input.shape),
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), **results})


def phase_monster_sample(fa):
    """`MonsterDiffusion("all")`, a MONSTER_BATCH-sprite sheet at 48px, the
    runs of MONSTER_RUNS: finite images in [0, 1] of the sheet's shape, no
    flash launch; seconds per sheet, ms per network evaluation, peak
    memory; one evaluation under the profiler. Returns (launches, launches
    per evaluation)."""
    import torch

    from perceptor_tpu_torch.models import MonsterDiffusion

    t0 = time.perf_counter()
    md = MonsterDiffusion("all", device="cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    md.sample(MONSTER_BATCH, n_evaluations=4)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    fa.reset_launches()
    runs, evals = [], 0
    for sampler, n_evaluations in MONSTER_RUNS:
        timer = PartTimer(fa, md, ("denoised_",))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        images = getattr(md, sampler)(MONSTER_BATCH, n_evaluations=n_evaluations,
                                      generator=torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timer.remove()
        n = len(timer.calls["denoised_"])
        if images.shape != (MONSTER_BATCH, *md.shape) or not torch.isfinite(images).all():
            raise AssertionError(f"monster_sample {sampler}: images {tuple(images.shape)}")
        if float(images.min()) < 0 or float(images.max()) > 1:
            raise AssertionError(f"monster_sample {sampler}: images outside [0, 1]")
        runs.append({
            "sampler": sampler, "n_evaluations": n_evaluations, "evaluations": n,
            "s_per_sheet": wall, "ms_per_evaluation": timer.ms("denoised_") / n,
            "images_shape": list(images.shape), "image_mean": float(images.mean()),
            "image_std": float(images.std()), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        })
        evals += n
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, evals)
    check_per_step("monster_sample", measured)
    noise = md.random_noise(MONSTER_BATCH, torch.Generator(device="cuda").manual_seed(5))

    def evaluate():
        with torch.no_grad():
            md.denoised_(noise, 10.0)

    emit({"phase": "monster_sample", "ok": True, "model": "all", "batch": MONSTER_BATCH,
          "image_shape": list(md.shape), "build_s": build_s,
          "parameters": sum(p.numel() for p in md.module.parameters()), "runs": runs,
          "launches": launches, "evaluation_profile": profile_record(evaluate)})
    return launches, measured


def check_bf16_tower(clip, label, seed):
    """`clip`'s bf16 image tower on two random images at its native size
    against an fp32 copy of the same weights: (images, encodings, relative
    L2 error); raises if the embeddings are not finite or the error is
    above TEXT_BF16_RTOL."""
    import copy

    import torch

    images = torch.rand((2, 3, *clip.config.image_size),
                        generator=torch.Generator("cuda").manual_seed(seed), device="cuda")
    normalized = (images - clip._mean) / clip._std
    with torch.no_grad():
        encodings = clip.module.encode_image(normalized)
        reference = copy.deepcopy(clip.module.visual).float()(normalized)
    err = _rel_l2(encodings, reference)
    if not (torch.isfinite(encodings).all() and err <= TEXT_BF16_RTOL):
        raise AssertionError(f"{label}: bf16 vs fp32 relative L2 {err}")
    return images, encodings, err


def phase_clip_resnet(fa):
    """CLIP's ResNet towers (`models.CLIP` of CLIP_RESNETS, bf16) on two
    images at their native sizes against an fp32 copy (relative L2 within
    TEXT_BF16_RTOL), embedding ms, parameters; then RN_OPTIMIZE_STEPS steps
    of `engine.optimize` on a 224px `Raw` drawer under `losses.CLIP("RN50")`
    with the prompt: the loss falls, no flash launch. Returns (launches,
    launches per optimization step)."""
    import torch

    from perceptor_tpu_torch import drawers, losses, models

    fa.reset_launches()
    towers = {}
    for name in CLIP_RESNETS:
        clip = models.CLIP(name)
        size = clip.config.image_size
        images, encodings, err = check_bf16_tower(clip, f"clip_resnet {name}", seed=15)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        times = []
        for _ in range(5):
            start.record()
            clip.encode_images(images)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        towers[name] = {
            "image_size": list(size), "encodings_shape": list(encodings.shape),
            "visual_parameters": sum(p.numel() for p in clip.module.visual.parameters()),
            "bf16_vs_fp32_rel_l2": err, "tol": TEXT_BF16_RTOL,
            "encode_images_ms": sorted(times)[2],
        }
        del clip
        torch.cuda.empty_cache()
    embedding_launches = dict(fa.LAUNCHES)
    if any(embedding_launches.values()):
        raise AssertionError(f"clip_resnet: flash launches {embedding_launches}")
    loss = losses.CLIP("RN50").add_texts_([PROMPT])
    size = loss.model.config.image_size
    drawer = drawers.Raw.random_fractal_image((1, 3, *size), seed=0)
    record = run_optimize(fa, "clip_resnet RN50", drawer, [loss], RN_OPTIMIZE_STEPS)
    launches = record["flash_launches"]
    measured = per_step(launches, RN_OPTIMIZE_STEPS)
    check_per_step("clip_resnet", measured)
    emit({"phase": "clip_resnet", "ok": True, "towers": towers, "prompt": PROMPT,
          "optimize_rn50": record, "profile": step_profile(drawer, [loss])})
    return launches, measured


def perceptual_images():
    """The fixed 512px init image (inpainting's ramps and wave), a second
    image (uniform noise from a seeded generator) and a style image
    (diagonal stripes, a phase apart in each channel)."""
    import torch

    init, _ = inpaint_inputs()
    other = torch.rand(init.shape, generator=torch.Generator("cuda").manual_seed(21),
                       device="cuda")
    ramp = torch.linspace(0.0, 1.0, IMAGE_SIZE, device="cuda")
    y, x = torch.meshgrid(ramp, ramp, indexing="ij")
    style = torch.stack([0.5 + 0.5 * torch.sin(2 * math.pi * 12 * (x - y) + phase)
                         for phase in (0.0, 2.1, 4.2)])[None]
    return init, other, style


def perceptual_objective(name, init, style):
    """One of PERCEPTUAL_LOSSES at full width: (images -> scalar, the module
    whose parameters it runs); LPIPS is taken to `init`, StyleTransfer to
    `style`. The models are memoized: a loss built twice shares them."""
    from perceptor_tpu_torch import losses

    kind, _, arg = name.partition("_")
    if kind == "lpips":
        lpips = losses.LPIPS(arg)
        return (lambda images: lpips(images, init).mean()), lpips.model.module
    if kind == "style":
        loss = losses.StyleTransfer(style)
        return loss, loss.model.module
    if kind == "memorability":
        loss = losses.Memorability(RESMEM_NAME)
        return loss, loss.model.module
    if kind == "simulacra":
        loss = losses.SimulacraAesthetic(arg)
        return loss, loss.model.clip_model.module.visual
    if kind == "ava":
        loss = losses.AestheticVisualAssessment(mode=arg)
        return loss, loss.model.module.visual
    loss = losses.TransformersOpenAICLIP(HF_CLIP_NAME).add_texts_([PROMPT])
    return loss, loss.model.module.visual


def phase_perceptual_losses(fa):
    """Each loss of this slice at full width on a 512px image, batch 1: its
    value, forward + backward ms (`time_ms`: device-paced unless the host
    waits inside the call, as it does on the resize's pageable copy of its
    matrices), the same call profiled (device ms, launches), peak memory,
    flash launches (none: ViT-L/14's 257 tokens and the CNNs take no
    kernel) and a finite, nonzero image gradient; LPIPS(a, a) and
    StyleTransfer(a, a) near 0; each bf16 CLIP tower within TEXT_BF16_RTOL
    of an fp32 copy (relative L2 of the image embeddings). Returns
    (launches, launches per loss evaluation)."""
    import torch

    from perceptor_tpu_torch import losses, models

    init, other, style = perceptual_images()
    objectives = {name: perceptual_objective(name, init, style) for name in PERCEPTUAL_LOSSES}
    records, launches = {}, {name: 0 for name in REPLACES}
    for name, (loss, module) in objectives.items():
        x = other.clone().requires_grad_(True)

        def forward_backward(loss=loss, x=x):
            value = loss(x).float().reshape(())
            (grad,) = torch.autograd.grad(value, x)
            return value, grad

        forward_backward()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        allocated = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        value, grad = forward_backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        launched = dict(fa.LAUNCHES)
        check_per_step("perceptual_losses", per_step(launched, 1))
        grad_max = float(grad.abs().max())
        if not (torch.isfinite(value) and torch.isfinite(grad).all() and grad_max > 0):
            raise AssertionError(f"perceptual_losses {name}: value {value}, |grad| max {grad_max}")
        records[name] = {
            "value": float(value.detach()), "fwd_bwd_ms": time_ms(forward_backward, reps=10),
            "profile": profile_summary(forward_backward), "peak_mem_bytes": peak,
            "allocated_before_bytes": allocated,
            "parameters": sum(p.numel() for p in module.parameters()),
            "grad_abs_max": grad_max, "flash_launches": launched,
        }
        for kernel in launches:
            launches[kernel] += launched[kernel]
    # each loss between an image and itself
    with torch.no_grad():
        self_distance = {f"lpips_{name}": float(losses.LPIPS(name)(init, init).abs().max())
                         for name in LPIPS_NAMES}
        self_distance["style_transfer"] = float(objectives["style_transfer"][0](init, init))
    for name, distance in self_distance.items():
        atol = STYLE_SELF_ATOL if name == "style_transfer" else LPIPS_SELF_ATOL
        if not distance < atol:
            raise AssertionError(f"perceptual_losses: {name}(a, a) = {distance} >= {atol}")
    # the bf16 CLIP towers against fp32 copies of the same weights
    towers = {}
    clips = [models.CLIP(name) for name in (*SIMULACRA_NAMES, "ViT-B-16")]
    clips.append(models.TransformersOpenAICLIP(HF_CLIP_NAME))
    for clip in clips:
        label = getattr(clip, "name", clip.architecture)
        _, _, err = check_bf16_tower(clip, f"perceptual_losses {label}", seed=22)
        towers[label] = {"image_size": list(clip.config.image_size), "bf16_vs_fp32_rel_l2": err,
                         "tol": TEXT_BF16_RTOL}
    emit({"phase": "perceptual_losses", "ok": True, "image_size": IMAGE_SIZE, "prompt": PROMPT,
          "losses": records, "self_distance": self_distance, "towers": towers})
    return launches, per_step(launches, len(records))


def phase_perceptual_optimize(fa):
    """`engine.optimize`, PERCEPTUAL_STEPS Adam steps of a 512px `Raw`
    drawer from the init image under the HF-layout CLIP ViT-L/14 with the
    prompt, `SimulacraAesthetic("ViT-L-14")`, `LPIPS("vgg")` to the init
    image, `StyleTransfer` to the style image and `Memorability` weighted
    -1: the total falls, no flash launch; ms a step, one profiled step,
    peak memory. Returns (launches, launches per step)."""
    from perceptor_tpu_torch import drawers

    init, _, style = perceptual_images()
    names, weights = zip(*OPTIMIZE_OBJECTIVES)
    chosen = [perceptual_objective(name, init, style)[0] for name in names]
    drawer = drawers.Raw(init)
    record = run_optimize(fa, "perceptual_optimize", drawer, chosen, PERCEPTUAL_STEPS,
                          loss_weights=weights)
    launches = record["flash_launches"]
    measured = per_step(launches, PERCEPTUAL_STEPS)
    check_per_step("perceptual_optimize", measured)
    emit({"phase": "perceptual_optimize", "ok": True, "image_size": IMAGE_SIZE,
          "objectives": dict(OPTIMIZE_OBJECTIVES), "prompt": PROMPT, **record,
          "profile": step_profile(drawer, chosen, loss_weights=weights)})
    return launches, measured


def guided_sample_phase(fa, path, objectives, steps, extra) -> tuple:
    """`engine.guided_sample` on SD at 512px with CFG 7 and guidance scale
    0.5 under `objectives`, `steps` steps from seeded latents: launches a
    step held to PER_STEP[path], finite latents and losses, ms per step,
    peak memory; `extra` joins the phase's line. Returns (launches,
    launches per step, losses)."""
    import torch

    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion

    sd = StableDiffusion(MODEL, device="cuda", seed=0)
    uncond, cond = sd.conditioning([""]), sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE),
                                         torch.Generator("cuda").manual_seed(23))
    pairs = sd.schedule_indices(steps)
    options = dict(conditioning=cond, uncond_conditioning=uncond, cfg_scale=CFG_SCALE,
                   guidance_scale=0.5)
    guided_sample(sd, objectives, latents, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, history = guided_sample(sd, objectives, latents, pairs, **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    k = len(pairs)
    measured = per_step(launches, k)
    check_per_step(path, measured)
    if not (torch.isfinite(out).all() and torch.isfinite(history).all()):
        raise AssertionError(f"{path}: non-finite latents or losses")
    emit({
        "phase": path, "ok": True, "model": MODEL, "steps": k, "pairs": pairs.tolist(), **extra,
        "guidance_scale": 0.5, "cfg_scale": CFG_SCALE, "losses": history.tolist(),
        "latents_shape": list(out.shape), "ms_per_step": start.elapsed_time(end) / k,
        "wall_s": wall, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured, history.tolist()


def phase_aesthetic_guided_sample(fa):
    """`guided_sample_phase` under `SimulacraAesthetic("ViT-L-14")` and
    `LPIPS("vgg")` to the init image, AESTHETIC_GUIDED_STEPS steps: 21
    launches of each kernel a step."""
    init, _, style = perceptual_images()
    objectives = [perceptual_objective(name, init, style)[0] for name in GUIDED_OBJECTIVES]
    return guided_sample_phase(fa, "aesthetic_guided_sample", objectives,
                               AESTHETIC_GUIDED_STEPS, {"objectives": GUIDED_OBJECTIVES})[:2]

def depth_record(fa, fn, x) -> dict:
    """One depth model `fn` (images -> depth) on `x`: the depth's shape and
    range, its nonzero share, forward and forward + backward ms (`time_ms`),
    one forward + backward profiled, its peak memory, its flash launches
    (held to PER_STEP["depth_models"]) and a finite, nonzero input
    gradient. Returns (record, depth, launches)."""
    import torch

    def forward_backward():
        images = x.clone().requires_grad_(True)
        depth = fn(images)
        (grad,) = torch.autograd.grad(depth.float().mean(), images)
        return depth, grad

    forward_backward()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    depth, grad = forward_backward()
    depth = depth.detach()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = dict(fa.LAUNCHES)
    check_per_step("depth_models", per_step(launched, 1))
    grad_max = float(grad.abs().max())
    if not (torch.isfinite(depth).all() and torch.isfinite(grad).all() and grad_max > 0):
        raise AssertionError(f"depth_models: non-finite depth or gradient, |grad| max {grad_max}")
    with torch.no_grad():
        forward_ms = time_ms(lambda: fn(x), reps=10)
    return {
        "depth_shape": list(depth.shape), "depth_min": float(depth.min()),
        "depth_max": float(depth.max()), "depth_nonzero_share": float((depth != 0).float().mean()),
        "fwd_ms": forward_ms, "fwd_bwd_ms": time_ms(forward_backward, reps=10),
        "profile": profile_summary(forward_backward), "peak_mem_bytes": peak,
        "grad_abs_max": grad_max, "flash_launches": launched,
    }, depth, launched


def phase_depth_models(fa):
    """Each depth model at full width on a 512px image, batch 1
    (`depth_record`): MiDaS's four through `models.MidasDepth` (the negated
    depth at 384px, or 256px for the small one, <= 0), each bf16 build
    within DEPTH_BF16_RTOL of an fp32 build of the same weights; AdaBins
    "nyu" through `adabins_depth.predict` (the depth at 512px within its
    range). Returns (launches, launches per forward + backward)."""
    import torch

    from perceptor_tpu_torch import models
    from perceptor_tpu_torch.core.init import random_module
    from perceptor_tpu_torch.models import adabins_depth

    _, other, _ = perceptual_images()
    records, launches = {}, {name: 0 for name in REPLACES}
    for name in MIDAS_NAMES:
        model = models.MidasDepth(name)
        record, depth, launched = depth_record(fa, model, other)
        if not float(depth.max()) <= 0.0:
            raise AssertionError(f"depth_models {name}: negated depth above 0")
        fp32 = models.MidasDepth(name, optimize=False)
        fp32.load_state_dict({k: v.float() for k, v in model.module.state_dict().items()})
        with torch.no_grad():
            err = _rel_l2(depth, fp32(other))
        if not err <= DEPTH_BF16_RTOL:
            raise AssertionError(f"depth_models {name}: bf16 vs fp32 relative L2 {err}")
        records[name] = {"parameters": sum(p.numel() for p in model.module.parameters()),
                         "image_size": list(model.image_size), **record,
                         "bf16_vs_fp32_rel_l2": err, "tol": DEPTH_BF16_RTOL}
        for kernel in launches:
            launches[kernel] += launched[kernel]
        del model, fp32
        torch.cuda.empty_cache()
    spec = adabins_depth.DATASETS[ADABINS_NAME]
    config = adabins_depth.AdaBinsConfig(min_val=spec["min_depth"], max_val=spec["max_depth"])
    net = random_module(lambda cfg: adabins_depth.UnetAdaptiveBins(cfg, dtype=torch.bfloat16),
                        config, torch.device("cuda"), torch.Generator("cuda").manual_seed(0),
                        torch.float32)
    record, depth, launched = depth_record(
        fa, lambda images: adabins_depth.predict(net, images, spec["min_depth"],
                                                 spec["max_depth"]), other)
    if not spec["min_depth"] <= float(depth.min()) <= float(depth.max()) <= spec["max_depth"]:
        raise AssertionError(f"depth_models adabins: depth outside {spec}")
    records[f"adabins_{ADABINS_NAME}"] = {
        "parameters": sum(p.numel() for p in net.parameters()), **record}
    for kernel in launches:
        launches[kernel] += launched[kernel]
    emit({"phase": "depth_models", "ok": True, "image_size": IMAGE_SIZE, "models": records})
    return launches, per_step(launches, len(records))


def phase_depth_optimize(fa):
    """`engine.optimize`, DEPTH_STEPS Adam steps of a 512px `Raw` drawer from
    the init image under `losses.CLIP(CLIP_NAME)` with the prompt and
    `losses.MidasDepth(DEPTH_OPTIMIZE_MODEL)` to the depth of the striped
    image (`add_images_`): the total falls, no flash launch; ms a step, one
    profiled step, peak memory. Returns (launches, launches per step)."""
    from perceptor_tpu_torch import drawers, losses

    init, _, stripes = perceptual_images()
    objectives = [losses.CLIP(CLIP_NAME).add_texts_([PROMPT]),
                  losses.MidasDepth(DEPTH_OPTIMIZE_MODEL).add_images_(stripes)]
    drawer = drawers.Raw(init)
    record = run_optimize(fa, "depth_optimize", drawer, objectives, DEPTH_STEPS)
    launches = record["flash_launches"]
    measured = per_step(launches, DEPTH_STEPS)
    check_per_step("depth_optimize", measured)
    emit({"phase": "depth_optimize", "ok": True, "image_size": IMAGE_SIZE,
          "objectives": [f"clip_{CLIP_NAME}", f"midas_{DEPTH_OPTIMIZE_MODEL}"], "prompt": PROMPT,
          **record, "profile": step_profile(drawer, objectives)})
    return launches, measured


def phase_depth_guided_sample(fa):
    """`engine.guided_sample` on SD at 512px with CFG 7 and guidance scale
    0.5 under `losses.MidasDepth(DEPTH_GUIDED_MODEL)` to the init image's
    depth, DEPTH_GUIDED_STEPS steps: 21 launches of each kernel a step,
    finite latents and losses, ms per step, peak memory; run twice, the two
    loss histories bitwise equal. Returns (launches, launches per step)."""
    from perceptor_tpu_torch import losses

    init, _, _ = perceptual_images()
    objective = losses.MidasDepth(DEPTH_GUIDED_MODEL).add_images_(init)
    extra = {"objectives": [f"midas_{DEPTH_GUIDED_MODEL}"]}
    launches, measured, first = guided_sample_phase(
        fa, "depth_guided_sample", [objective], DEPTH_GUIDED_STEPS, extra)
    second = guided_sample_phase(
        fa, "depth_guided_sample", [objective], DEPTH_GUIDED_STEPS, extra)[2]
    runs = [[float(x).hex() for x in losses] for losses in (first, second)]
    if runs[0] != runs[1]:
        raise AssertionError(f"depth_guided_sample: two runs' losses differ: {runs}")
    emit({"phase": "depth_guided_sample_repeat", "ok": True, "losses": runs})
    return launches, measured


def random_target(loss, seed):
    """A prompt-bank target without a vocabulary: a fixed random direction of
    the tower's width (bench_families.py's `_random_encodings`)."""
    import torch

    dim = loss.model.config.embed_dim
    return loss.add_encodings_(torch.randn((1, dim), device="cuda",
                                           generator=torch.Generator("cuda").manual_seed(seed)))


def check_bf16_encoder(model, label, seed) -> float:
    """`model`'s bf16 image tower against an fp32 build of the same weights
    (`precision="fp32"`, the bf16 state_dict in fp32) on two random images
    at its native size: relative L2 of the encodings, at most
    TEXT_BF16_RTOL, finite."""
    import torch

    size = model.image_size if isinstance(model.image_size, tuple) else (model.image_size,) * 2
    images = torch.rand((2, 3, *size), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    fp32 = type(model)(model.name, precision="fp32")
    fp32.load_state_dict({k: v.float() for k, v in model.module.state_dict().items()})
    with torch.no_grad():
        encodings, reference = model.encode_images(images), fp32.encode_images(images)
    err = _rel_l2(encodings, reference)
    if not (torch.isfinite(encodings).all() and err <= TEXT_BF16_RTOL):
        raise AssertionError(f"{label}: bf16 vs fp32 relative L2 {err}")
    del fp32
    return err


def phase_ensemble_guided_sample(fa):
    """`engine.guided_sample` over `GuidedDiffusion(ENSEMBLE_ADM)` (fp16) at
    256px under BLIP (384px), CLOOB and SLIP at full width, each to its own
    random target (seeds 1, 2, 3), loss weights 1, 1, 1, guidance 0.5, clamp
    1e-2, ENSEMBLE_STEPS steps of the rho-3 schedule: finite images and
    losses of the expected shape, no flash launch; ms a step, a profiled
    step (device ms, busy share), peak memory; each tower's bf16 encodings
    within TEXT_BF16_RTOL of an fp32 build of its weights. Returns
    (launches, launches per step)."""
    import torch

    from perceptor_tpu_torch import losses
    from perceptor_tpu_torch.engine import guided_sample
    from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion

    t0 = time.perf_counter()
    model = GuidedDiffusion(ENSEMBLE_ADM, fp16=True, device="cuda", seed=0)
    ensemble = [random_target(getattr(losses, kind)(name), seed)
                for seed, (kind, name) in enumerate(ENSEMBLE, start=1)]
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    towers = {f"{kind}_{name}": check_bf16_encoder(loss.model, f"ensemble {kind}", seed=31)
              for (kind, name), loss in zip(ENSEMBLE, ensemble)}
    diffused = model.random_diffused((1, 3, ENSEMBLE_SIZE, ENSEMBLE_SIZE),
                                     torch.Generator("cuda").manual_seed(0))
    pairs = model.schedule_indices(ENSEMBLE_STEPS, rho=3.0)
    options = dict(guidance_scale=0.5, loss_weights=[1.0, 1.0, 1.0], clamp_value=1e-2)
    guided_sample(model, ensemble, diffused, pairs[:1], **options)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    out, history = guided_sample(model, ensemble, diffused, pairs, **options)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, len(pairs))
    check_per_step("ensemble_guided_sample", measured)
    if tuple(out.shape) != (1, 3, ENSEMBLE_SIZE, ENSEMBLE_SIZE) or not (
            torch.isfinite(out).all() and torch.isfinite(history).all()):
        raise AssertionError(f"ensemble_guided_sample: output {tuple(out.shape)} or history "
                             f"{history.tolist()} not finite")
    peak = torch.cuda.max_memory_allocated()
    profile = profile_summary(lambda: guided_sample(model, ensemble, diffused, pairs[:1],
                                                    **options))
    emit({
        "phase": "ensemble_guided_sample", "ok": True, "model": ENSEMBLE_ADM,
        "objectives": [f"{kind}_{name}" for kind, name in ENSEMBLE], "steps": len(pairs),
        "pairs": pairs.tolist(), "losses": history.tolist(), "images_shape": list(out.shape),
        "ms_per_step": start.elapsed_time(end) / len(pairs), "wall_s": wall,
        "peak_mem_bytes": peak, "profile": profile, "bf16_vs_fp32_rel_l2": towers,
        "tol": TEXT_BF16_RTOL, "launches": launches, "launches_per_step": measured,
        "build_s": build_s,
    })
    return launches, measured


def dip_run(fa, path, drawer, loss, steps, optimizer) -> dict:
    """`engine.run_on_device` over `drawer` under `loss` for `steps` steps:
    finite history and weights, launches a step held to PER_STEP[path];
    ms a step (CUDA events around the run), peak memory."""
    import torch

    from perceptor_tpu_torch import engine

    engine.run_on_device(drawer, [loss], drawer.params, 1, optimizer=optimizer)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    final, history = engine.run_on_device(drawer, [loss], drawer.params, steps,
                                          optimizer=optimizer)
    end.record()
    torch.cuda.synchronize()
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, steps)
    check_per_step(path, measured)
    history = history.tolist()
    if not (all(math.isfinite(h) for h in history)
            and all(bool(torch.isfinite(p).all()) for p in final)):
        raise AssertionError(f"{path}: non-finite history or weights: {history}")
    return {"steps": steps, "history": history, "ms_per_step": start.elapsed_time(end) / steps,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": launches,
            "launches_per_step": measured}


def check_deform_conv() -> dict:
    """`ops.deform_conv2d` with zero offsets against `F.conv2d` at a DIP 3x3
    layer's shape (192 channels, 256 x 256 out, reflection-padded input,
    4 offset groups), fp32 and bf16: max error over max magnitude within
    DEFORM_FP32_RTOL / DEFORM_BF16_RTOL; the ms of each (forward)."""
    import torch
    import torch.nn.functional as F

    from perceptor_tpu_torch.ops import deform_conv2d

    generator = torch.Generator("cuda").manual_seed(41)
    b, c, h, w = DEFORM_SHAPE
    x = F.pad(torch.randn(DEFORM_SHAPE, device="cuda", generator=generator), (1,) * 4,
              mode="reflect")
    weight = torch.randn((c, c, 3, 3), device="cuda", generator=generator) / math.sqrt(c * 9)
    bias = 0.1 * torch.randn((c,), device="cuda", generator=generator)
    offsets = torch.zeros((b, 2 * 4 * 9, h, w), device="cuda")
    record = {}
    for dtype, rtol in ((torch.float32, DEFORM_FP32_RTOL), (torch.bfloat16, DEFORM_BF16_RTOL)):
        xd, wd = x.to(dtype), weight.to(dtype)
        with torch.no_grad():
            got = deform_conv2d(xd, offsets.to(dtype), wd, bias)
            # fp32 sums of the same (rounded) inputs
            want = F.conv2d(xd.float(), wd.float(), bias)
        err = float((got.float() - want).abs().max() / want.abs().max())
        if not (got.dtype == dtype and err <= rtol):
            raise AssertionError(f"deform_conv2d {dtype}: error {err} over {rtol}")
        with torch.no_grad():
            ms = time_ms(lambda: deform_conv2d(xd, offsets.to(dtype), wd, bias), reps=5)
            conv_ms = time_ms(lambda: F.conv2d(xd, wd, bias.to(dtype)), reps=5)
        record[str(dtype).removeprefix("torch.")] = {"max_err_over_max": err, "tol": rtol,
                                                     "ms": ms, "conv2d_ms": conv_ms}
    return record


def phase_dip_optimize(fa):
    """DIP_STEPS steps of `run_on_device` over `drawers.DeepImagePrior` at
    DIP_SIZE (192-channel skip levels, bf16 convs) under
    `losses.OpenCLIP("ViT-B-32", "laion2b_s34b_b79k")` to a random target,
    Adam DIP_LR: the loss falls, no flash launch, a profiled step; then the
    same net with `offset_type="full"` (deformable 3x3 convs, offsets at
    lr / 10) for DIP_DEFORM_STEPS steps (`dip_optimize_deform`); and
    `deform_conv2d` against `F.conv2d` (`check_deform_conv`). Returns
    ({path: launches}, {path: launches per step})."""
    import torch

    from perceptor_tpu_torch import drawers, engine, losses

    t0 = time.perf_counter()
    loss = random_target(losses.OpenCLIP("ViT-B-32", "laion2b_s34b_b79k"), seed=1)
    drawer = drawers.DeepImagePrior((DIP_SIZE, DIP_SIZE), seed=0)
    build_s = time.perf_counter() - t0

    def adam(params):
        return torch.optim.Adam(params, lr=DIP_LR)

    t0 = time.perf_counter()
    record = dip_run(fa, "dip_optimize", drawer, loss, DIP_STEPS, adam)
    if not record["history"][-1] < record["history"][0]:
        raise AssertionError(f"dip_optimize: loss did not fall: {record['history']}")
    record["profile"] = profile_summary(engine.make_guidance_step(drawer, [loss], adam))
    record["seconds"] = time.perf_counter() - t0
    emit({"phase": "dip_optimize", "ok": True, "image_size": DIP_SIZE, "lr": DIP_LR,
          "parameters": sum(p.numel() for p in drawer.parameters()), "build_s": build_s,
          **record})
    del drawer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    deform = drawers.DeepImagePrior((DIP_SIZE, DIP_SIZE), seed=0, offset_type="full")
    deform_record = dip_run(fa, "dip_optimize_deform", deform, loss, DIP_DEFORM_STEPS,
                            deform.optimizer(DIP_LR))
    deform_record["deform_conv2d_vs_conv2d"] = check_deform_conv()
    deform_record["seconds"] = time.perf_counter() - t0
    emit({"phase": "dip_optimize_deform", "ok": True, "image_size": DIP_SIZE,
          "offset_type": "full", "lr": DIP_LR, "offset_lr": DIP_LR * 0.1, **deform_record})
    return ({"dip_optimize": record["launches"], "dip_optimize_deform": deform_record["launches"]},
            {"dip_optimize": record["launches_per_step"],
             "dip_optimize_deform": deform_record["launches_per_step"]})


def _ruclip_tokenizer(texts):
    """A stand-in for youtokentome's BPE: fixed ids (bos 2, eos 3, pad 0)."""
    import numpy as np

    rows = np.zeros((len(texts), 77), dtype=np.int64)
    rows[:, :6] = [2, 310, 4077, 1580, 925, 3]
    return rows


def phase_clip_variants(fa):
    """`LiT(LIT_NAME)` and `RuCLIP(RUCLIP_NAME)` at published widths: each
    image tower forward and backward on a random image at its native size (a
    finite, nonzero input gradient), each text tower forward on the prompt
    (LiT through the synthetic vocabulary, ruCLIP through a stand-in
    tokenizer of fixed ids), unit-norm finite encodings, the bf16 image
    encodings within TEXT_BF16_RTOL of an fp32 build; no flash launch.
    Returns (launches, launches per forward + backward)."""
    import torch

    from perceptor_tpu_torch import models
    from perceptor_tpu_torch.models.latent_diffusion import BERTTokenizer

    t0 = time.perf_counter()
    fa.reset_launches()
    towers = {}
    for label, model in (
            (LIT_NAME, lambda: models.LiT(LIT_NAME, tokenizer=BERTTokenizer(BERT_VOCAB, 16))),
            (RUCLIP_NAME, lambda: models.RuCLIP(RUCLIP_NAME, tokenizer=_ruclip_tokenizer))):
        model = model()
        size = model.image_size if isinstance(model.image_size, tuple) else (model.image_size,) * 2
        images = torch.rand((1, 3, *size), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(51)).requires_grad_(True)
        # a random probe: LiT's encodings are a LayerNorm's, whose features
        # sum to 0, so their plain sum has no gradient
        probe = torch.randn((1, model.config.embed_dim), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(52))
        encodings = model.encode_images(images)
        (grad,) = torch.autograd.grad((encodings * probe).sum(), images)
        texts = model.encode_texts([PROMPT])
        norms = torch.linalg.norm(torch.cat([encodings.detach(), texts]), dim=-1)
        if not (torch.isfinite(grad).all() and float(grad.abs().max()) > 0
                and torch.allclose(norms, torch.ones_like(norms), atol=1e-3)):
            raise AssertionError(f"clip_variants {label}: gradient or encodings off: {norms}")
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        (grad,) = torch.autograd.grad((model.encode_images(images) * probe).sum(), images)
        end.record()
        torch.cuda.synchronize()
        towers[label] = {
            "image_size": list(size), "parameters": sum(p.numel() for p in model.module.parameters()),
            "image_fwd_bwd_ms": start.elapsed_time(end),
            "bf16_vs_fp32_rel_l2": check_bf16_encoder(model, f"clip_variants {label}", seed=53),
            "tol": TEXT_BF16_RTOL, "text_shape": list(texts.shape)}
        del model
        torch.cuda.empty_cache()
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, len(towers))
    check_per_step("clip_variants", measured)
    emit({"phase": "clip_variants", "ok": True, "towers": towers, "prompt": PROMPT,
          "seconds": time.perf_counter() - t0})
    return launches, measured


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def timed_ms(fn) -> tuple:
    """`fn()` between two CUDA events: (its result, ms)."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _rudalle_adam(params):
    import torch

    return torch.optim.Adam(params, lr=RUDALLE_LR)


def rudalle_run(fa, path, drawer, loss, steps) -> dict:
    """`engine.run_on_device` over a ruDALL-E drawer for `steps` steps:
    launches a step held to PER_STEP[path]; a second run from the same latent
    bitwise equal to the first; finite losses; the final latent's images
    finite and in [0, 1]; ms a step, peak memory."""
    import torch

    from perceptor_tpu_torch import engine

    engine.run_on_device(drawer, [loss], drawer.params, 1, optimizer=_rudalle_adam)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    (final, history), ms = timed_ms(lambda: engine.run_on_device(
        drawer, [loss], drawer.params, steps, optimizer=_rudalle_adam))
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, steps)
    check_per_step(path, measured)
    peak = torch.cuda.max_memory_allocated()
    _, again = engine.run_on_device(drawer, [loss], drawer.params, steps, optimizer=_rudalle_adam)
    if not torch.equal(history, again):
        raise AssertionError(f"{path}: two runs differ: {history.tolist()} vs {again.tolist()}")
    with torch.no_grad():
        images = drawer.synthesize(final)
    history = history.tolist()
    if not (all(math.isfinite(h) for h in history) and torch.isfinite(images).all()
            and float(images.min()) >= 0.0 and float(images.max()) <= 1.0):
        raise AssertionError(f"{path}: history {history} or images off")
    return {"steps": steps, "history": history, "repeat_bitwise_equal": True,
            "images_shape": list(images.shape), "ms_per_step": ms / steps,
            "peak_mem_bytes": peak, "launches": launches, "launches_per_step": measured}


def phase_rudalle_optimize(fa):
    """`drawers.BruteRuDalle` (GUMBEL_F8, bf16, random weights from seed 0)
    from a seeded RUDALLE_SIZE fractal image under
    `losses.OpenCLIP("ViT-B-32")` to a random target, RUDALLE_STEPS Adam
    steps (lr RUDALLE_LR) of `engine.run_on_device`: 4 / 4 / 4 flash
    launches a step at (1, 1, 1024, 512), the loss falls, two runs bitwise
    equal, images in [0, 1]; the encode (at construction and once more,
    the same latent): 3 / 0 / 0; a profiled step; then RUDALLE_DWT_STEPS of
    the DWT variant (512px images), 4 / 4 / 4 and repeatable too. Returns
    ({path: launches}, {path: launches per step})."""
    import torch

    from perceptor_tpu_torch import drawers, engine, losses
    from perceptor_tpu_torch.drawers import inits

    card = nvidia_smi()
    t0 = time.perf_counter()
    loss = random_target(losses.OpenCLIP("ViT-B-32"), seed=1)
    init = inits.fractal((1, 3, RUDALLE_SIZE, RUDALLE_SIZE), 0)
    fa.reset_launches()
    drawer = drawers.BruteRuDalle(init, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        quant, encode_ms = timed_ms(lambda: drawer.encode(torch.as_tensor(init, device="cuda")))
    encode_launches = dict(fa.LAUNCHES)
    encode_measured = per_step(encode_launches, 2)
    check_per_step("rudalle_encode", encode_measured)
    if not torch.equal(quant, drawer.quant):
        raise AssertionError("rudalle_optimize: the encode does not repeat the constructor's")
    record = rudalle_run(fa, "rudalle_optimize", drawer, loss, RUDALLE_STEPS)
    if not record["history"][-1] < record["history"][0]:
        raise AssertionError(f"rudalle_optimize: loss did not fall: {record['history']}")
    record["profile"] = profile_summary(engine.make_guidance_step(drawer, [loss], _rudalle_adam))
    emit({"phase": "rudalle_optimize", "ok": True, "card": card, "image_size": RUDALLE_SIZE,
          "lr": RUDALLE_LR, "latent_shape": list(drawer.quant.shape),
          "vqgan_parameters": sum(p.numel() for p in drawer.model.parameters()),
          "build_s": build_s, "encode_ms": encode_ms, "encode_launches": encode_launches,
          "encode_launches_per_call": encode_measured, **record,
          "seconds": time.perf_counter() - t0})
    del drawer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dwt = drawers.BruteRuDalle(init, dwt=True, seed=0)
    dwt_record = rudalle_run(fa, "rudalle_optimize_dwt", dwt, loss, RUDALLE_DWT_STEPS)
    emit({"phase": "rudalle_optimize_dwt", "ok": True, "card": card, "dwt": True,
          "image_size": RUDALLE_SIZE, "lr": RUDALLE_LR, **dwt_record,
          "seconds": time.perf_counter() - t0})
    return ({"rudalle_optimize": record["launches"], "rudalle_encode": encode_launches,
             "rudalle_optimize_dwt": dwt_record["launches"]},
            {"rudalle_optimize": record["launches_per_step"], "rudalle_encode": encode_measured,
             "rudalle_optimize_dwt": dwt_record["launches_per_step"]})


def check_bf16_against_fp32(label, got, want) -> float:
    """Relative L2 of a bf16 build's output `got` from an fp32 build's
    `want`: at most TEXT_BF16_RTOL, `got` finite."""
    err = _rel_l2(got, want)
    if not (torch_finite(got) and err <= TEXT_BF16_RTOL):
        raise AssertionError(f"{label}: bf16 vs fp32 relative L2 {err}")
    return err


def torch_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def phase_super_resolution(fa):
    """`models.SuperResolution(SR_NAME)` (23 RRDBs, 64 / 32 channels, bf16)
    on a SR_SIZE image, forward and backward, against an fp32 build of the
    same weights; `enhance` of a SR_ENHANCE_FRAME frame in SR_TILE tiles
    against the whole frame, the difference reported on the tiles'
    interiors; SR_VIDEO_NAME forward against fp32; `losses.SuperResolution
    (SR_LOSS_NAME)` and `SuperResolutionDiscriminator()` forward and backward
    at SR_LOSS_SIZE: finite values, finite nonzero gradients, no flash
    launch. Returns (launches, launches per phase)."""
    import torch

    from perceptor_tpu_torch import losses, models

    card = nvidia_smi()
    t0 = time.perf_counter()
    fa.reset_launches()
    gen = torch.Generator("cuda").manual_seed(61)
    model = models.SuperResolution(SR_NAME)
    scale = model.scale
    images = torch.rand((1, 3, SR_SIZE, SR_SIZE), device="cuda", generator=gen)
    images.requires_grad_(True)
    probe = torch.randn((1, 3, SR_SIZE * scale, SR_SIZE * scale), device="cuda", generator=gen)

    def fwd_bwd():
        up = model.upsample(images)
        return up, torch.autograd.grad((up * probe).sum(), images)[0]

    fwd_bwd()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (up, grad), fwd_bwd_ms = timed_ms(fwd_bwd)
    peak = torch.cuda.max_memory_allocated()
    if not (torch_finite(grad) and float(grad.abs().max()) > 0):
        raise AssertionError("super_resolution: upsample gradient not finite or zero")
    fp32 = models.SuperResolution(SR_NAME, half=False)
    fp32.load_state_dict({k: v.float() for k, v in model.module.state_dict().items()})
    with torch.no_grad():
        up_err = check_bf16_against_fp32("super_resolution x4", up, fp32.upsample(images))
    del fp32
    profile = profile_summary(fwd_bwd)

    frame = torch.rand((1, 3, *SR_ENHANCE_FRAME), device="cuda", generator=gen)
    with torch.no_grad():
        whole, whole_ms = timed_ms(lambda: model.enhance(frame))
        tiled, tiled_ms = timed_ms(lambda: model.enhance(frame, tile_size=SR_TILE,
                                                         tile_pad=SR_TILE_PAD))
    shape = (1, 3, SR_ENHANCE_FRAME[0] * scale, SR_ENHANCE_FRAME[1] * scale)
    if not (tuple(whole.shape) == tuple(tiled.shape) == shape and torch_finite(tiled)):
        raise AssertionError(f"super_resolution: enhance shapes {whole.shape} {tiled.shape}")
    # the tiles' interiors: away by tile_pad from each tile's edge, in the
    # pre-padded frame's coordinates (enhance pads 10 at the bottom and right)
    interior = torch.ones(shape[-2:], dtype=torch.bool, device="cuda")
    for axis, size in enumerate(SR_ENHANCE_FRAME):
        keep = torch.zeros(size, dtype=torch.bool, device="cuda")
        for start in range(0, size, SR_TILE):
            keep[start + SR_TILE_PAD: start + SR_TILE - SR_TILE_PAD] = True
        keep = keep.repeat_interleave(scale)
        interior &= keep[:, None] if axis == 0 else keep[None, :]
    diff = (tiled - whole).abs()
    enhance = {"frame": list(SR_ENHANCE_FRAME), "tile_size": SR_TILE, "tile_pad": SR_TILE_PAD,
               "whole_ms": whole_ms, "tiled_ms": tiled_ms,
               "interior_max_abs_diff": float(diff[..., interior].max()),
               "interior_rel_l2": _rel_l2(tiled[..., interior], whole[..., interior]),
               "max_abs_diff": float(diff.max()), "whole_max_abs": float(whole.abs().max())}

    video = models.SuperResolution(SR_VIDEO_NAME)
    video_fp32 = models.SuperResolution(SR_VIDEO_NAME, half=False)
    video_fp32.load_state_dict({k: v.float() for k, v in video.module.state_dict().items()})
    with torch.no_grad():
        video_up, video_ms = timed_ms(lambda: video.upsample(images))
        video_err = check_bf16_against_fp32("super_resolution video", video_up,
                                            video_fp32.upsample(images))
    del video, video_fp32

    loss_records = {}
    big = torch.rand((1, 3, SR_LOSS_SIZE, SR_LOSS_SIZE), device="cuda", generator=gen)
    big.requires_grad_(True)
    for label, loss in ((f"SuperResolution_{SR_LOSS_NAME}", losses.SuperResolution(SR_LOSS_NAME)),
                        ("SuperResolutionDiscriminator", losses.SuperResolutionDiscriminator())):
        def value_grad(loss=loss):
            value = loss(big)
            return value, torch.autograd.grad(value, big)[0]

        value_grad()  # warm-up
        (value, grad), ms = timed_ms(value_grad)
        if not (math.isfinite(value.item()) and torch_finite(grad)
                and float(grad.abs().max()) > 0):
            raise AssertionError(f"super_resolution {label}: value {float(value)} or gradient off")
        loss_records[label] = {"value": value.item(), "fwd_bwd_ms": ms,
                               "profile": profile_summary(value_grad)}
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, 1)
    check_per_step("super_resolution", measured)
    emit({"phase": "super_resolution", "ok": True, "card": card, "model": SR_NAME,
          "parameters": sum(p.numel() for p in model.module.parameters()),
          "in_size": SR_SIZE, "out_size": SR_SIZE * scale, "fwd_bwd_ms": fwd_bwd_ms,
          "peak_mem_bytes": peak, "profile": profile, "bf16_vs_fp32_rel_l2": up_err,
          "tol": TEXT_BF16_RTOL, "enhance": enhance,
          "video": {"model": SR_VIDEO_NAME, "fwd_ms": video_ms, "bf16_vs_fp32_rel_l2": video_err},
          "losses": loss_records, "loss_size": SR_LOSS_SIZE, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches, measured


def phase_owlvit_loss(fa):
    """`losses.OWLViT()` (B/32 at 768px, bf16) with OWLVIT_QUERIES through the
    port's vocabulary: its logits on a `Raw` fractal image against an fp32
    build of the same weights; then OWLVIT_STEPS Adam steps of
    `run_on_device` over the OWLVIT_RAW_SIZE `Raw`: finite losses and pixels,
    no flash launch, ms a step, a profiled step, peak memory. Returns
    (launches, launches per step)."""
    import torch

    from perceptor_tpu_torch import drawers, engine, losses, models

    card = nvidia_smi()
    t0 = time.perf_counter()
    loss = losses.OWLViT().add_texts_(OWLVIT_QUERIES)
    drawer = drawers.Raw.random_fractal_image((1, 3, OWLVIT_RAW_SIZE, OWLVIT_RAW_SIZE), seed=0)
    build_s = time.perf_counter() - t0
    fp32 = models.OWLViT(precision="fp32")
    fp32.load_state_dict({k: v.float() for k, v in loss.model.module.state_dict().items()})
    with torch.no_grad():
        images = drawer.synthesize()
        logits = loss.model(images, loss.encodings).logits
        err = check_bf16_against_fp32("owlvit_loss", logits,
                                      fp32(images, loss.encodings).logits)
    del fp32
    torch.cuda.empty_cache()
    engine.run_on_device(drawer, [loss], drawer.params, 1)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    (final, history), ms = timed_ms(lambda: engine.run_on_device(
        drawer, [loss], drawer.params, OWLVIT_STEPS))
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, OWLVIT_STEPS)
    check_per_step("owlvit_loss", measured)
    history = history.tolist()
    if not (all(math.isfinite(h) for h in history) and torch_finite(final)):
        raise AssertionError(f"owlvit_loss: history {history} or pixels not finite")
    emit({"phase": "owlvit_loss", "ok": True, "card": card, "queries": OWLVIT_QUERIES,
          "image_size": loss.model.config.image_size, "raw_size": OWLVIT_RAW_SIZE,
          "parameters": sum(p.numel() for p in loss.model.module.parameters()),
          "logits_shape": list(logits.shape), "bf16_vs_fp32_rel_l2": err, "tol": TEXT_BF16_RTOL,
          "steps": OWLVIT_STEPS, "history": history, "ms_per_step": ms / OWLVIT_STEPS,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "profile": profile_summary(engine.make_guidance_step(drawer, [loss])),
          "launches": launches, "build_s": build_s, "seconds": time.perf_counter() - t0})
    return launches, measured


def phase_glide_clip(fa):
    """`models.GlideCLIP()` (both towers, bf16): `encode_images` of
    GLIDE_BATCH random 64px images at GLIDE_TIMESTEPS, forward and backward
    (a finite nonzero input gradient), against an fp32 build of the same
    weights; `encode_texts` of two prompts through the port's vocabulary;
    unit norms, no flash launch. Returns (launches, launches per phase)."""
    import torch

    from perceptor_tpu_torch import models

    card = nvidia_smi()
    t0 = time.perf_counter()
    fa.reset_launches()
    model = models.GlideCLIP()
    size = model.config.image_size
    gen = torch.Generator("cuda").manual_seed(71)
    diffused = torch.rand((GLIDE_BATCH, 3, size, size), device="cuda", generator=gen)
    diffused.requires_grad_(True)
    ts = torch.tensor(GLIDE_TIMESTEPS, device="cuda")
    probe = torch.randn((GLIDE_BATCH, model.config.n_embd), device="cuda", generator=gen)

    def fwd_bwd():
        encodings = model.encode_images(diffused, ts)
        return encodings, torch.autograd.grad((encodings * probe).sum(), diffused)[0]

    fwd_bwd()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (encodings, grad), ms = timed_ms(fwd_bwd)
    peak = torch.cuda.max_memory_allocated()
    texts, text_ms = timed_ms(lambda: model.encode_texts(list(TEXT_PROMPTS)))
    norms = torch.linalg.norm(torch.cat([encodings.detach(), texts]), dim=-1)
    if not (torch_finite(grad) and float(grad.abs().max()) > 0
            and torch.allclose(norms, torch.ones_like(norms), atol=1e-3)):
        raise AssertionError(f"glide_clip: gradient or norms off: {norms.tolist()}")
    fp32 = models.GlideCLIP(precision="fp32")
    fp32.load_state_dicts(
        text={k: v.float() for k, v in model.text_encoder.state_dict().items()},
        image={k: v.float() for k, v in model.image_encoder.state_dict().items()})
    with torch.no_grad():
        err = check_bf16_against_fp32("glide_clip", encodings, fp32.encode_images(diffused, ts))
    del fp32
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, 1)
    check_per_step("glide_clip", measured)
    emit({"phase": "glide_clip", "ok": True, "card": card, "batch": GLIDE_BATCH,
          "timesteps": list(GLIDE_TIMESTEPS), "image_size": size,
          "parameters": sum(p.numel() for m in (model.text_encoder, model.image_encoder)
                            for p in m.parameters()),
          "image_fwd_bwd_ms": ms, "text_encode_ms": text_ms, "peak_mem_bytes": peak,
          "profile": profile_summary(fwd_bwd), "bf16_vs_fp32_rel_l2": err,
          "tol": TEXT_BF16_RTOL, "text_shape": list(texts.shape), "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches, measured


def write_safetensors(path, tensors) -> None:
    """{name: fp32 CPU tensor} -> a safetensors file, its header written
    here (no package): the 8-byte little-endian header length, the JSON
    header padded with spaces to 8 bytes, then each tensor's bytes in
    order."""
    import struct

    import torch

    header, offset, blobs = {}, 0, []
    for name, tensor in tensors.items():
        if tensor.dtype != torch.float32:
            raise ValueError(f"write_safetensors writes F32 only, not {tensor.dtype} ({name})")
        data = tensor.contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(tensor.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)) + text)
        for data in blobs:
            f.write(data)


def stylegan_checkpoints(model, latents, images) -> dict:
    """`model`'s generator state_dict written as a torch `.pt`, a
    `{'G_ema': module}` `.pkl` (stdlib pickle), an `.npz` and a hand-written
    `.safetensors` in a temporary directory; each read through
    `utils.checkpoints.load_state_dict` into a fresh wrapper whose weights
    were zeroed first: its images of `latents` bitwise equal to `images`.
    The native reader must have built; its read of the safetensors payload
    byte-equal to the Python read. Read and load times in ms."""
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch

    from perceptor_tpu_torch.models import stylegan_xl
    from perceptor_tpu_torch.utils import checkpoints, native_io

    if not native_io.native_available():
        raise AssertionError(f"native reader did not build: {native_io.build_error()}")
    sd = {k: v.detach().cpu() for k, v in model.generator.state_dict().items()}
    fresh = stylegan_xl.StyleGANXL.__wrapped__(model.name)
    record = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {fmt: f"{tmp}/stylegan_xl_{model.name}{fmt}"
                 for fmt in (".pt", ".pkl", ".npz", ".safetensors")}
        torch.save(sd, paths[".pt"])
        with open(paths[".pkl"], "wb") as f:
            pickle.dump({"G_ema": model.generator}, f)
        np.savez(paths[".npz"], **{k: v.numpy() for k, v in sd.items()})
        write_safetensors(paths[".safetensors"], sd)
        for fmt, path in paths.items():
            with torch.no_grad():
                for tensor in fresh.generator.parameters():
                    tensor.zero_()
            t0 = time.perf_counter()
            loaded = checkpoints.load_state_dict(path)
            read_ms = (time.perf_counter() - t0) * 1e3
            fresh.load_state_dict(loaded)
            with torch.no_grad():
                again = fresh(latents)
            if not torch.equal(again, images):
                raise AssertionError(f"stylegan_xl checkpoint {fmt}: images differ after loading")
            record[fmt] = {"bytes": os.path.getsize(path), "read_ms": read_ms}
        size = os.path.getsize(paths[".safetensors"])
        t0 = time.perf_counter()
        native = native_io.read_span(paths[".safetensors"], 0, size)
        native_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        python = native_io.read_span_python(paths[".safetensors"], 0, size)
        python_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(native, python):
            raise AssertionError("stylegan_xl: native read_span differs from the Python read")
    del fresh
    return {"formats": record, "native_available": True, "read_span_bytes": size,
            "read_span_native_ms": native_ms, "read_span_python_ms": python_ms,
            "bitwise_equal_images": True}


def phase_stylegan_xl_optimize(fa):
    """`models.StyleGANXL(STYLEGAN_NAME)` (bf16 synthesis, JAX's seed-0
    weights) on the card, `latents(1, seeds=[0])` into `drawers.StyleGANXL`,
    STYLEGAN_STEPS Adam steps (lr STYLEGAN_LR) of `engine.run_on_device`
    under `losses.CLIP("ViT-B-32")` to a random target: the loss falls, no
    flash launch, finite images (1, 3, 128, 128), a second run bitwise
    equal, the bf16 image within TEXT_BF16_RTOL of an fp32 build's, a
    profiled step; then `StyleGANXL(STYLEGAN_UNCOND_NAME)`'s `latents(2)`
    forward and backward to the latents; then the checkpoint round trip
    (`stylegan_checkpoints`). Returns ({path: launches}, {path: launches
    per step})."""
    import torch

    from perceptor_tpu_torch import drawers, engine, losses, models

    card = nvidia_smi()
    t0 = time.perf_counter()
    model = models.StyleGANXL(STYLEGAN_NAME)
    loss = random_target(losses.CLIP(CLIP_NAME), seed=1)
    latents = model.latents(1, seeds=[0])
    drawer = drawers.StyleGANXL(model=model, latents=latents)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    def adam(params):
        return torch.optim.Adam(params, lr=STYLEGAN_LR)

    record = dip_run(fa, "stylegan_xl_optimize", drawer, loss, STYLEGAN_STEPS, adam)
    _, again = engine.run_on_device(drawer, [loss], drawer.params, STYLEGAN_STEPS, optimizer=adam)
    if again.tolist() != record["history"]:
        raise AssertionError(f"stylegan_xl_optimize: two runs differ: {record['history']} vs "
                             f"{again.tolist()}")
    if not record["history"][-1] < record["history"][0]:
        raise AssertionError(f"stylegan_xl_optimize: loss did not fall: {record['history']}")
    with torch.no_grad():
        images = drawer.synthesize()
        fp32 = models.StyleGANXL(STYLEGAN_NAME, dtype=torch.float32)
        err = check_bf16_against_fp32("stylegan_xl_optimize", images, fp32(latents))
    del fp32
    size = model.config.synthesis.img_resolution
    if tuple(images.shape) != (1, 3, size, size):
        raise AssertionError(f"stylegan_xl_optimize: images {tuple(images.shape)}")
    record["profile"] = profile_record(engine.make_guidance_step(drawer, [loss], adam))
    emit({"phase": "stylegan_xl_optimize", "ok": True, "card": card, "model": STYLEGAN_NAME,
          "lr": STYLEGAN_LR, "latent_shape": list(latents.shape),
          "parameters": sum(p.numel() for p in model.generator.parameters()),
          "build_s": build_s, "repeat_bitwise_equal": True, "images_shape": list(images.shape),
          "bf16_vs_fp32_rel_l2": err, "tol": TEXT_BF16_RTOL, **record,
          "seconds": time.perf_counter() - t0})
    launches, measured = ({"stylegan_xl_optimize": record["launches"]},
                          {"stylegan_xl_optimize": record["launches_per_step"]})
    del drawer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    uncond = models.StyleGANXL(STYLEGAN_UNCOND_NAME)
    ws = uncond.latents(2).requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def fwd_bwd():
        out = uncond(ws)
        grad, = torch.autograd.grad(out.square().mean(), ws)
        return out, grad

    fwd_bwd()  # warm-up
    fa.reset_launches()
    (out, grad), ms = timed_ms(fwd_bwd)
    ffhq_launches = dict(fa.LAUNCHES)
    check_per_step("stylegan_xl_ffhq256", per_step(ffhq_launches, 1))
    size = uncond.config.synthesis.img_resolution
    if not (tuple(out.shape) == (2, 3, size, size) and torch_finite(out) and torch_finite(grad)
            and float(grad.abs().max()) > 0):
        raise AssertionError(f"stylegan_xl_ffhq256: output {tuple(out.shape)} or gradient off")
    emit({"phase": "stylegan_xl_ffhq256", "ok": True, "card": card, "model": STYLEGAN_UNCOND_NAME,
          "latent_shape": list(ws.shape), "images_shape": list(out.shape), "fwd_bwd_ms": ms,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(), "launches": ffhq_launches,
          "profile": profile_summary(fwd_bwd), "seconds": time.perf_counter() - t0})
    launches["stylegan_xl_ffhq256"] = ffhq_launches
    measured["stylegan_xl_ffhq256"] = per_step(ffhq_launches, 1)
    del uncond, ws, out, grad
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with torch.no_grad():
        images = model(latents)
    emit({"phase": "stylegan_xl_checkpoints", "ok": True, "card": card, "model": STYLEGAN_NAME,
          **stylegan_checkpoints(model, latents, images), "seconds": time.perf_counter() - t0})
    return launches, measured


def _weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for tensors in params.values()
               for t in tensors.values())


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_serving_sample(fa, sd):
    """SD's `export_sample` at 512px (DDIM and dpm++, SERVING_STEPS steps,
    CFG 7): exported, serialized, loaded back and run on the live
    `sample_loop`'s context and latents. Per method: the images against the
    live ones (bitwise, or gated at SERVING_ATOL), the flash launches of the
    loaded program per UNet evaluation against PER_STEP["serving_sample"]
    (the decode's PER_VAE_CALL apart; `sample`'s row), export and load seconds, artifact
    bytes against the weights', and ms an image of the loaded program and of
    the live sampler. Returns (launches, launches per UNet evaluation)."""
    import torch

    from perceptor_tpu_torch.utils import serving

    size = (IMAGE_SIZE, IMAGE_SIZE)
    context2 = torch.cat([sd.conditioning([""]), sd.conditioning([PROMPT])])
    latents = sd.random_diffused_latents((1, *size), torch.Generator("cuda").manual_seed(4))
    scale = torch.tensor(CFG_SCALE, device="cuda")
    pairs = sd.schedule_indices(SERVING_STEPS)
    totals = {name: 0 for name in REPLACES}
    runs = []
    for method in ("ddim", "dpm++"):
        t0 = time.perf_counter()
        blob = sd.export_sample(batch=1, size=size, n_steps=SERVING_STEPS, method=method)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = serving.load_program(blob)
        load_s = time.perf_counter() - t0
        noise = torch.zeros(sd.sample_noise_shape(1, size, SERVING_STEPS), device="cuda")

        def served_run():
            return program(sd.params, context2, latents, noise, scale)

        def live_run():
            return sd.decode(sd.sample_loop(latents, pairs, context2[:1], context2[1:],
                                            CFG_SCALE, method=method))

        served_run(), live_run()  # warm-up
        torch.cuda.synchronize()
        fa.reset_launches()
        served, served_ms = timed_ms(served_run)
        launches = dict(fa.LAUNCHES)
        live, live_ms = timed_ms(live_run)
        loop = {k: launches[k] - PER_VAE_CALL[k] for k in launches}
        measured = per_step(loop, len(pairs))
        check_per_step("sample", measured)
        diff = _max_diff(served, live)
        if tuple(served.shape) != (1, 3, *size) or not torch.isfinite(served).all():
            raise AssertionError(f"serving_sample {method}: images {tuple(served.shape)}")
        if not diff <= SERVING_ATOL:
            raise AssertionError(f"serving_sample {method}: loaded program {diff} off the live")
        for kernel in totals:
            totals[kernel] += launches[kernel]
        runs.append({
            "method": method, "steps": len(pairs), "export_s": export_s, "load_s": load_s,
            "artifact_bytes": len(blob), "weight_bytes": _weight_bytes(sd.params),
            "bitwise": bool(torch.equal(served, live)), "max_abs_diff": diff,
            "tol": SERVING_ATOL, "loaded_ms_per_image": served_ms,
            "live_ms_per_image": live_ms, "launches": launches,
            "launches_per_unet_eval": measured,
        })
        del program, blob
    emit({"phase": "serving_sample", "ok": True, "model": MODEL, "runs": runs})
    return totals, measured


def phase_serving_guided_sample(fa, sd, step):
    """`engine.export_guided_sample` over SD at 512px under the guided step's
    CLIP ViT-B/32 prompt-bank loss, SERVING_GUIDED_STEPS steps without CFG:
    loaded back and run against the live `guided_sample` on the same
    latents (latents and losses bitwise, or gated at SERVING_ATOL), its
    launches per step against PER_STEP["serving_guided_sample"]. Returns
    (launches, launches per step, the loaded program's per-step losses)."""
    import io

    import torch

    from perceptor_tpu_torch.engine import export_guided_sample, guided_noise_shape, guided_sample
    from perceptor_tpu_torch.utils import serving

    cond = sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, IMAGE_SIZE, IMAGE_SIZE),
                                         torch.Generator("cuda").manual_seed(5))
    pairs = sd.schedule_indices(SERVING_GUIDED_STEPS)
    loss = step.clip_loss
    t0 = time.perf_counter()
    blob = export_guided_sample(sd, [loss], latents, pairs, cond)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = serving.load_program(blob)
    load_s = time.perf_counter() - t0
    args = (sd.params, latents, torch.as_tensor(pairs, device="cuda"),
            [serving.object_params(loss)], cond,
            torch.zeros(guided_noise_shape(latents, len(pairs)), device="cuda"),
            torch.tensor(0.5, device="cuda"), torch.tensor(0.0, device="cuda"))
    program(*args)  # warm-up
    torch.cuda.synchronize()
    fa.reset_launches()
    (served, served_losses), served_ms = timed_ms(lambda: program(*args))
    launches = dict(fa.LAUNCHES)
    measured = per_step(launches, len(pairs))
    check_per_step("serving_guided_sample", measured)
    (live, live_losses), live_ms = timed_ms(
        lambda: guided_sample(sd, [loss], latents, pairs, cond, guidance_scale=0.5))
    diffs = {"latents": _max_diff(served, live), "losses": _max_diff(served_losses, live_losses)}
    if not (torch.isfinite(served).all() and torch.isfinite(served_losses).all()):
        raise AssertionError("serving_guided_sample: non-finite latents or losses")
    if not all(d <= SERVING_ATOL for d in diffs.values()):
        raise AssertionError(f"serving_guided_sample: loaded program off the live by {diffs}")
    graph_ops = sorted({str(n.target) for n in torch.export.load(io.BytesIO(blob)).graph.nodes
                        if "perceptor_tpu_torch" in str(n.target)})
    cutouts = serving_cutouts(fa, sd, loss, latents, pairs, cond)
    emit({
        "phase": "serving_guided_sample", "ok": True, "steps": len(pairs), "cutouts": cutouts,
        "export_s": export_s, "load_s": load_s, "artifact_bytes": len(blob),
        "weight_bytes": _weight_bytes(sd.params), "graph_flash_ops": graph_ops,
        "bitwise": bool(torch.equal(served, live) and torch.equal(served_losses, live_losses)),
        "max_abs_diff": diffs, "tol": SERVING_ATOL, "losses": served_losses.tolist(),
        "loaded_ms_per_step": served_ms / len(pairs), "live_ms_per_step": live_ms / len(pairs),
        "launches": launches, "launches_per_step": measured,
    })
    return launches, measured, served_losses


def serving_cutouts(fa, sd, loss, latents, pairs, cond) -> dict:
    """`export_guided_sample` with SERVING_CUTOUTS random CUT_SIZE cutouts
    as the image augment, its uniforms drawn by `draw_guided_noise` from a
    generator: bitwise the live `guided_sample` on the same generator, the
    guided step's launches a step."""
    import torch

    from perceptor_tpu_torch.engine import draw_guided_noise, export_guided_sample, guided_sample
    from perceptor_tpu_torch.transforms import RandomCutouts
    from perceptor_tpu_torch.utils import serving

    augment = RandomCutouts(SERVING_CUTOUTS, CUT_SIZE)
    program = serving.load_program(
        export_guided_sample(sd, [loss], latents, pairs, cond, image_augment=augment))
    noise = draw_guided_noise(torch.Generator(sd.device).manual_seed(9), latents, len(pairs),
                              image_augment=augment)
    args = (sd.params, latents, torch.as_tensor(pairs, device=sd.device),
            [serving.object_params(loss)], cond, noise, torch.tensor(0.5, device=sd.device),
            torch.tensor(0.0, device=sd.device))
    program(*args)  # warm-up
    fa.reset_launches()
    (served, served_losses), served_ms = timed_ms(lambda: program(*args))
    measured = per_step(dict(fa.LAUNCHES), len(pairs))
    check_per_step("serving_guided_sample", measured)
    (live, live_losses), live_ms = timed_ms(lambda: guided_sample(
        sd, [loss], latents, pairs, cond, guidance_scale=0.5, image_augment=augment,
        generator=torch.Generator(sd.device).manual_seed(9)))
    if not (torch.equal(served, live) and torch.equal(served_losses, live_losses)):
        raise AssertionError(
            f"serving_guided_sample cutouts: not bitwise the live sampler "
            f"({_max_diff(served, live)}, {_max_diff(served_losses, live_losses)})")
    return {"n_cutouts": SERVING_CUTOUTS, "cut_size": CUT_SIZE, "bitwise": True,
            "noise_shape": list(noise.shape), "losses": served_losses.tolist(),
            "loaded_ms_per_step": served_ms / len(pairs), "live_ms_per_step": live_ms / len(pairs),
            "launches_per_step": measured}


def phase_routing_report(step) -> None:
    """`parallel.explain` over one guided step on fake CUDA tensors (no
    kernel runs): the flash records against SITES, the summary printed."""
    from perceptor_tpu_torch import parallel

    latents, context = step.initial_inputs()
    t0 = time.perf_counter()
    report = parallel.explain(step.guided_denoise_step, latents, context)
    seconds = time.perf_counter() - t0
    flash = {rec.shape: rec.count for rec in report
             if rec.site == "attention" and rec.route == "flash"}
    want = {(s, s, h): n for _, _, h, s, _, n in SITES}
    if flash != want or sum(flash.values()) != PER_STEP["guided_step"]["flash_fwd"]:
        raise AssertionError(f"routing_report: flash records {flash}, SITES {want}")
    print(report.summary(), flush=True)
    emit({"phase": "routing_report", "ok": True, "seconds": seconds,
          "flash": {str(k): n for k, n in flash.items()}, "routes": {
              str(k): n for k, n in report.routes().items()}})


def traced_mesh_step(sd, mesh, latents, context2) -> dict:
    """The collective inventory of one CFG sampling step under `mesh`: the
    weights placed by the rules, gathered at each layer's call
    (`parallel.partition`), traced by make_fx."""
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx

    from perceptor_tpu_torch.parallel.partition import gathered_params, placed_params
    from perceptor_tpu_torch.utils import hlo

    sharded = {part: placed_params(module, mesh)
               for part, module in sd.serving_modules().items()}
    pairs = torch.as_tensor(sd.schedule_indices(MESH_STEPS), device=sd.device)
    from_idx, to_idx = pairs[0, 0].expand(1), pairs[0, 1].expand(1)

    def step(x):
        with gathered_params(sd.serving_modules(), sharded):
            return sd.cfg_predictions(x, from_idx, context2, CFG_SCALE).step(to_idx)

    with torch.no_grad():
        graph = make_fx(step)(latents)
    return {"collective_counts": hlo.collective_counts(graph),
            "max_gather_elements": hlo.max_gather_elements(graph),
            "ici_bytes": hlo.program_ici_bytes(graph)}


def phase_mesh_sample(fa, sd, step):
    """A one-rank process group on the card, `sample(mesh=)` and
    `guided_sample(mesh=)` against the unsharded paths. Returns ({path:
    launches}, {path: launches per step})."""
    import torch
    import torch.distributed as dist

    from perceptor_tpu_torch import parallel
    from perceptor_tpu_torch.engine import guided_sample

    address = f"localhost:{parallel.mesh.free_port()}"
    parallel.initialize_distributed(address, 1, 0, device=sd.device)
    meshes = {"data": parallel.create_mesh(data=-1),
              "tensor_context": parallel.create_mesh(data=-1, tensor=1, context=1)}
    size = (IMAGE_SIZE, IMAGE_SIZE)

    def generator(seed):
        return torch.Generator(device=sd.device).manual_seed(seed)

    def sample(mesh):
        return sd.sample([PROMPT], n_steps=MESH_STEPS, size=size, guidance_scale=CFG_SCALE,
                         generator=generator(0), mesh=mesh)

    first_ms = {}
    for name, mesh in meshes.items():  # the first call places the weights
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(mesh)
        torch.cuda.synchronize()
        first_ms[name] = (time.perf_counter() - t0) * 1e3
    k = len(sd.schedule_indices(MESH_STEPS))
    want = {name: PER_STEP["mesh_sample"][name] * k + PER_VAE_CALL[name] for name in REPLACES}
    runs, launches = {}, {}
    for name, mesh in (("plain", None), *meshes.items()):
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.perf_counter()
        images = sample(mesh)
        torch.cuda.synchronize()
        runs[name] = (images, (time.perf_counter() - t0) * 1e3)
        launches[name] = dict(fa.LAUNCHES)
        if launches[name] != want:
            raise AssertionError(f"mesh_sample {name}: launches {launches[name]}, want {want}")
    checks = {}
    for name in meshes:
        images = runs[name][0]
        bitwise = torch.equal(images, runs["plain"][0])
        diff = _max_diff(images, runs["plain"][0])
        if not torch.isfinite(images).all() or (not bitwise and diff > MESH_ATOL):
            raise AssertionError(f"mesh_sample {name}: images off the unsharded by {diff}")
        checks[name] = {"bitwise": bool(bitwise), "max_abs_diff": diff}
        if not bitwise:
            print(f"mesh_sample {name}: within {diff} of sample(), not bitwise: the gathered "
                  "weights are new tensors, and a library may choose another algorithm for "
                  "them", flush=True)
    # where a call's host time goes, with the weights placed anew (cold)
    # and kept from the call before (warm)
    from perceptor_tpu_torch.parallel import partition

    partition._PLACED.clear()
    host = {"cold": host_profile(lambda: sample(meshes["data"])),
            "warm": host_profile(lambda: sample(meshes["data"]))}
    # guided: 1 step without CFG under the guided step's CLIP loss
    cond = sd.conditioning([PROMPT])
    latents = sd.random_diffused_latents((1, *size), generator(5))
    pairs = sd.schedule_indices(1)
    live, live_ms = timed_ms(lambda: guided_sample(sd, [step.clip_loss], latents, pairs, cond,
                                                   guidance_scale=0.5))
    guided_sample(sd, [step.clip_loss], latents, pairs, cond, guidance_scale=0.5,
                  mesh=meshes["data"])  # warm-up
    fa.reset_launches()
    meshed, mesh_ms = timed_ms(lambda: guided_sample(sd, [step.clip_loss], latents, pairs, cond,
                                                     guidance_scale=0.5, mesh=meshes["data"]))
    guided_launches = dict(fa.LAUNCHES)
    guided_measured = per_step(guided_launches, len(pairs))
    check_per_step("mesh_guided_sample", guided_measured)
    guided = {part: {"bitwise": bool(torch.equal(a, b)), "max_abs_diff": _max_diff(a, b)}
              for part, a, b in (("latents", meshed[0], live[0]), ("losses", meshed[1], live[1]))}
    if any(not g["bitwise"] and g["max_abs_diff"] > MESH_ATOL for g in guided.values()):
        raise AssertionError(f"mesh_guided_sample: off the live sampler: {guided}")
    context2 = torch.cat([sd.conditioning([""]), sd.conditioning([PROMPT])])
    t0 = time.perf_counter()
    traced = traced_mesh_step(sd, meshes["data"], latents, context2)
    traced["trace_s"] = time.perf_counter() - t0
    print(f"mesh_sample traced step: collective_counts {traced['collective_counts']} "
          f"max_gather_elements {traced['max_gather_elements']}", flush=True)
    emit({
        "phase": "mesh_sample", "ok": True, "backend": dist.get_backend(), "address": address,
        "world_size": dist.get_world_size(),
        "meshes": {name: str(mesh) for name, mesh in meshes.items()}, "steps": k,
        "images": checks, "ms_per_image": {name: run[1] for name, run in runs.items()},
        "first_call_ms": first_ms, "host_profile": host,
        "launches": launches, "guided": guided, "guided_ms_per_step": {
            "live": live_ms / len(pairs), "mesh": mesh_ms / len(pairs)},
        "guided_launches_per_step": guided_measured, "traced_step": traced,
    })
    per_eval = {name: (launches["data"][name] - PER_VAE_CALL[name]) / k for name in REPLACES}
    return ({"mesh_sample": launches["data"], "mesh_guided_sample": guided_launches},
            {"mesh_sample": per_eval, "mesh_guided_sample": guided_measured})


def host_profile(fn, top: int = 8) -> dict:
    """`fn()` once under torch.profiler's CPU activity: its wall ms and the
    `top` host ops by self CPU time (ms, calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"wall_ms": wall_ms, "top": [
        {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3, "count": e.count}
        for e in ops[:top]]}


def _rel_max(got, want) -> float:
    """max |got - want| over max |want| (KERNEL_RTOL's measure)."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def phase_parallel_collectives(fa) -> None:
    """ring_attention, ulysses_attention and pipeline on a one-rank mesh in
    the process group `phase_mesh_sample` brought up, forward and backward
    against their plain counterparts in bf16, and the flash kernels called
    on DTensors (their registered sharding strategies); then the process
    group is destroyed."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from perceptor_tpu_torch import parallel
    from perceptor_tpu_torch.ops.attention import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(12)
    b, h, s, d = COLLECTIVE_SHAPE

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
    k77, v77 = randn(b, h, COLLECTIVE_KV, d), randn(b, h, COLLECTIVE_KV, d)
    mesh = parallel.create_mesh(data=-1)

    def forward_backward(fn, *args):
        args = [a.clone().requires_grad_(True) for a in args]
        out = fn(*args)
        probe = torch.randn(out.shape, generator=torch.Generator("cuda").manual_seed(3),
                            device="cuda")
        grads = torch.autograd.grad((out.float() * probe).sum(), args)
        return out.detach(), grads

    records = {}
    # the ring's recurrence runs in fp32, Ulysses' local attention is the
    # plain bf16 path (both as in JAX): each against that arithmetic
    for name, fn, args, dtype in (
        ("ring_attention", lambda *a: parallel.ring_attention(*a, mesh), (q, k, v),
         torch.float32),
        ("ulysses_attention", lambda *a: parallel.ulysses_attention(*a, mesh), (q, k77, v77),
         torch.bfloat16),
    ):
        (out, grads), ms = timed_ms(lambda: forward_backward(fn, *args))
        ref, ref_grads = forward_backward(dot_product_attention, *(a.to(dtype) for a in args))
        errs = [_rel_max(out, ref)] + [_rel_max(g, r) for g, r in zip(grads, ref_grads)]
        if max(errs) > KERNEL_RTOL:
            raise AssertionError(f"parallel_collectives {name}: {errs} > {KERNEL_RTOL}")
        records[name] = {"rel_err": errs, "ms_fwd_bwd": ms}
    stages = parallel.create_mesh(data=-1, stage=1)
    x = randn(2, s, PIPELINE_WIDTH)
    w = randn(1, PIPELINE_WIDTH, PIPELINE_WIDTH) * 0.05
    bias = randn(1, PIPELINE_WIDTH) * 0.1

    def stage_fn(p, hidden):
        return hidden + torch.tanh(hidden @ p["w"] + p["b"])

    (out, grads), ms = timed_ms(lambda: forward_backward(
        lambda w_, b_, x_: parallel.pipeline(stage_fn, {"w": w_, "b": b_}, x_, stages, 2),
        w, bias, x))
    ref, ref_grads = forward_backward(lambda w_, b_, x_: stage_fn({"w": w_[0], "b": b_[0]}, x_),
                                      w, bias, x)
    errs = [_rel_max(out, ref)] + [_rel_max(g, r) for g, r in zip(grads, ref_grads)]
    if max(errs) > KERNEL_RTOL:
        raise AssertionError(f"parallel_collectives pipeline: {errs} > {KERNEL_RTOL}")
    records["pipeline"] = {"rel_err": errs, "ms_fwd_bwd": ms, "stages": 1, "microbatches": 2}
    # the flash kernels through DTensor's strategies, batch- or head-sharded
    from perceptor_tpu_torch.ops.flash_attention_kernel import flash_attention

    ref, ref_grads = forward_backward(dot_product_attention, q.float(), k.float(), v.float())
    for dim in (0, 1):
        placements = [Shard(dim) if i == 0 else Replicate() for i in range(mesh.ndim)]
        fa.reset_launches()
        out, grads = forward_backward(
            lambda *a: flash_attention(*a).full_tensor(),
            *(distribute_tensor(t, mesh, placements) for t in (q, k, v)))
        launches = dict(fa.LAUNCHES)
        if launches != {name: 1 for name in REPLACES}:
            raise AssertionError(f"parallel_collectives flash on DTensor: {launches}")
        errs = [_rel_max(out, ref)] + [_rel_max(g.full_tensor(), r)
                                       for g, r in zip(grads, ref_grads)]
        if max(errs) > KERNEL_RTOL:
            raise AssertionError(f"parallel_collectives flash Shard({dim}): {errs}")
        records[f"flash_dtensor_shard{dim}"] = {"rel_err": errs, "launches": launches}
    print("parallel_collectives: one card, one rank; the multi-rank ring, Ulysses, pipeline "
          "and tensor-parallel runs are the CPU tests' (gloo worlds of 2 and 4)", flush=True)
    emit({"phase": "parallel_collectives", "ok": True, "shape": list(COLLECTIVE_SHAPE),
          "kv_len": COLLECTIVE_KV, "dtype": "bfloat16", "tol": KERNEL_RTOL, **records})
    dist.destroy_process_group()


def phase_training_stats(losses) -> None:
    """A `utils.stats.Collector` over the guided runs' per-step losses (the
    live CFG run's and the loaded program's), reported on the device one
    step at a time: its num, mean and std against numpy's float64 ones."""
    import numpy as np

    from perceptor_tpu_torch.utils import stats

    bag = stats.zeros(["guided/loss"], device=losses.device)
    collector = stats.Collector(regex="guided/.*")
    for value in losses:
        bag = stats.report(bag, "guided/loss", value)
    collector.update(stats.all_reduce(bag))
    want = losses.double().cpu().numpy()
    got = collector.as_dict()["guided/loss"]
    if got["num"] != want.size or not (
            np.isclose(got["mean"], want.mean(), rtol=STATS_RTOL)
            and np.isclose(got["std"], want.std(), rtol=STATS_RTOL, atol=1e-7)):
        raise AssertionError(f"training_stats: {got} against numpy's {want.mean(), want.std()}")
    emit({"phase": "training_stats", "ok": True, **got, "numpy_mean": float(want.mean()),
          "numpy_std": float(want.std()), "rtol": STATS_RTOL})


def phase_serving_conditioning(fa, sd):
    """SD's `export_conditioning` (the text encoder, uncond and cond) loaded
    back against the live encoder; no flash launch."""
    import torch

    from perceptor_tpu_torch.models.clip.tokenizer import tokenize
    from perceptor_tpu_torch.utils import serving

    t0 = time.perf_counter()
    blob = sd.export_conditioning(batch=1)
    export_s = time.perf_counter() - t0
    program = serving.load_program(blob)
    tokens = torch.from_numpy(tokenize(["", PROMPT], sd.text_config.context_length,
                                       tokenizer=sd.tokenizer)).to("cuda")
    program(sd.params, tokens)  # warm-up
    fa.reset_launches()
    served, served_ms = timed_ms(lambda: program(sd.params, tokens))
    launches = dict(fa.LAUNCHES)
    check_per_step("serving_conditioning", launches)
    live, live_ms = timed_ms(lambda: sd.text_encoder(tokens))
    diff = _max_diff(served, live)
    if not diff <= SERVING_ATOL:
        raise AssertionError(f"serving_conditioning: {diff} off the live encoder")
    emit({"phase": "serving_conditioning", "ok": True, "export_s": export_s,
          "artifact_bytes": len(blob), "weight_bytes": _weight_bytes(sd.params),
          "bitwise": bool(torch.equal(served, live)), "max_abs_diff": diff,
          "loaded_ms": served_ms, "live_ms": live_ms, "launches": launches})
    return launches, launches


def phase_serving_velocity(fa):
    """`VelocityDiffusion(SERVING_VELOCITY_MODEL).export_sample` (DDIM,
    SERVING_STEPS steps) loaded back against the live `sample_loop`; no
    flash launch."""
    import torch

    from perceptor_tpu_torch.models.velocity_diffusion import VelocityDiffusion
    from perceptor_tpu_torch.utils import serving

    vd = VelocityDiffusion(SERVING_VELOCITY_MODEL, device="cuda", seed=0)
    t0 = time.perf_counter()
    blob = vd.export_sample(n_images=1, n_steps=SERVING_STEPS)
    export_s = time.perf_counter() - t0
    program = serving.load_program(blob)
    diffused = vd.random_diffused((1, *vd.shape), torch.Generator("cuda").manual_seed(6))
    pairs = torch.as_tensor(vd.schedule_ts(SERVING_STEPS), device="cuda")
    noise = torch.zeros(vd.sample_noise_shape(1, vd.shape, SERVING_STEPS), device="cuda")
    zero = torch.tensor(0.0, device="cuda")
    cond = (torch.zeros((1, vd.config.mapping.clip_dim), device="cuda")
            if vd.conditioned else None)
    program(vd.params, diffused, pairs, cond, noise, zero, zero)  # warm-up
    fa.reset_launches()
    served, served_ms = timed_ms(lambda: program(vd.params, diffused, pairs, cond, noise, zero,
                                                 zero))
    launches = dict(fa.LAUNCHES)
    check_per_step("serving_velocity", launches)
    live, live_ms = timed_ms(lambda: vd.sample_loop(diffused, pairs, cond))
    diff = _max_diff(served, live)
    if not (torch.isfinite(served).all() and diff <= SERVING_ATOL):
        raise AssertionError(f"serving_velocity: {diff} off the live sampler")
    emit({"phase": "serving_velocity", "ok": True, "model": SERVING_VELOCITY_MODEL,
          "shape": list(vd.shape), "steps": SERVING_STEPS, "export_s": export_s,
          "artifact_bytes": len(blob), "weight_bytes": _weight_bytes(vd.params),
          "bitwise": bool(torch.equal(served, live)), "max_abs_diff": diff,
          "loaded_ms_per_image": served_ms, "live_ms_per_image": live_ms,
          "launches": launches})
    return launches, launches


def phase_session_resume(fa):
    """A Raw drawer at RAW_SIZE under Adam and the CLIP text loss on
    SESSION_CUTOUTS random cutouts from its own generator: SESSION_STEPS
    steps straight against half of them, `save_session`, a fresh drawer,
    optimizer and generator, `load_session` and the other half (losses and
    pixels bitwise); then `SessionManager` (async, interval 2, two kept)
    over the same run, its latest restore bitwise the straight run's state
    at that step. Returns (launches, launches per step)."""
    import tempfile

    import numpy as np
    import torch

    from perceptor_tpu_torch import drawers, engine, transforms
    from perceptor_tpu_torch.utils import SessionManager, load_session, save_session

    loss = text_loss()
    shape = (1, 3, RAW_SIZE, RAW_SIZE)

    class Run:
        def __init__(self, seed):
            self.drawer = drawers.Raw.random_fractal_image(shape, seed=seed)
            self.optimizer = torch.optim.Adam(self.drawer.parameters(), lr=0.05)
            self.generator = torch.Generator("cuda").manual_seed(seed)
            self.n = 0

            def cutout_loss(images):
                return loss(transforms.random_cutouts(images, self.generator, SESSION_CUTOUTS,
                                                      cut_size=CUT_SIZE))

            self.step = engine.make_guidance_step(self.drawer, [cutout_loss], self.optimizer)

        def run(self, n, manager=None, snapshots=None):
            out = []
            for _ in range(n):
                if manager is not None:
                    manager.save(self.n, self.state())
                if snapshots is not None:
                    snapshots[self.n] = self.drawer.pixels.detach().clone()
                out.append(self.step()["loss"])
                self.n += 1
            return out

        def state(self):
            return {"params": self.drawer.state_dict(),
                    "opt_state": self.optimizer.state_dict(), "generator": self.generator,
                    "step": self.n}

        def restore(self, state):
            self.drawer.load_state_dict(state["params"])
            self.optimizer.load_state_dict(state["opt_state"])
            self.n = state["step"]

    half = SESSION_STEPS // 2
    fa.reset_launches()
    straight = Run(0)
    snapshots = {}
    want = torch.stack(straight.run(SESSION_STEPS, snapshots=snapshots))
    launches = dict(fa.LAUNCHES)
    check_per_step("session_resume", per_step(launches, SESSION_STEPS))
    with tempfile.TemporaryDirectory() as tmp:
        first = Run(0)
        got = first.run(half)
        t0 = time.perf_counter()
        path = save_session(f"{tmp}/session.pt", first.state())
        save_s = time.perf_counter() - t0
        resumed = Run(1)
        t0 = time.perf_counter()
        resumed.restore(load_session(path, like=resumed.state()))
        load_s = time.perf_counter() - t0
        got = torch.stack(got + resumed.run(SESSION_STEPS - half))
        if not (torch.equal(got, want) and torch.equal(resumed.drawer.pixels,
                                                       straight.drawer.pixels)):
            raise AssertionError("session_resume: the resumed run left the straight one by "
                                 f"{_max_diff(got, want)}")
        managed = Run(0)
        with SessionManager(f"{tmp}/ckpt", max_to_keep=2, save_interval_steps=2,
                            async_save=True) as manager:
            managed.run(SESSION_STEPS, manager=manager)
            manager.wait()
            kept = manager.all_steps()
            fresh = Run(2)
            step, state = manager.restore_latest(fresh.state())
            fresh.restore(state)
        if kept != [SESSION_STEPS - 4, SESSION_STEPS - 2] or step != kept[-1]:
            raise AssertionError(f"session_resume: SessionManager kept {kept}")
        if not torch.equal(fresh.drawer.pixels, snapshots[step]):
            raise AssertionError("session_resume: the manager's restore is not the run's state")
        resumed_tail = torch.stack(fresh.run(SESSION_STEPS - step))
        if not torch.equal(resumed_tail, want[step:]):
            raise AssertionError("session_resume: the run resumed from the manager diverged")
    emit({"phase": "session_resume", "ok": True, "image_size": RAW_SIZE,
          "steps": SESSION_STEPS, "losses": want.tolist(), "bitwise": True,
          "save_s": save_s, "load_s": load_s, "manager_kept": kept,
          "launches": launches})
    return launches, per_step(launches, SESSION_STEPS)


def phase_checkpoint_discovery(fa):
    """The full-width OpenCLIP ViT-B/32's state dict, written in open_clip's
    layout, converted by the port's CLI into a temporary cache directory;
    `OpenCLIP("ViT-B-32", DISCOVERY_WEIGHTS)` built past its memo finds the
    artifact, and its image embeddings are bitwise those of the model that
    wrote the file. Times the CLI and the load."""
    import os
    import tempfile

    import torch

    from perceptor_tpu_torch import convert
    from perceptor_tpu_torch.models.open_clip import OpenCLIP
    from perceptor_tpu_torch.utils import checkpoints

    source = OpenCLIP.__wrapped__(CLIP_NAME, DISCOVERY_WEIGHTS, device="cuda", seed=11)
    images = torch.rand((2, 3, 224, 224), generator=torch.Generator("cuda").manual_seed(7),
                        device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        upstream = os.path.join(tmp, "open_clip_weights.pt")
        torch.save(source.module.state_dict(), upstream)
        cache = os.path.join(tmp, "cache")
        os.makedirs(cache)
        saved = checkpoints.CACHE_DIRS
        checkpoints.CACHE_DIRS = (cache,)
        try:
            name = f"{CLIP_NAME}/{DISCOVERY_WEIGHTS}"
            t0 = time.perf_counter()
            convert.main([upstream, "--family", "open-clip", "--name", name, "--out",
                          os.path.join(cache, convert.canonical_basename("open-clip", name)),
                          "--device", "cuda"])
            cli_s = time.perf_counter() - t0
            written = sorted(os.listdir(cache))
            fa.reset_launches()
            t0 = time.perf_counter()
            found = OpenCLIP.__wrapped__(CLIP_NAME, DISCOVERY_WEIGHTS, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
        finally:
            checkpoints.CACHE_DIRS = saved
        artifact_bytes = os.path.getsize(os.path.join(cache, written[0]))
    want, got = source.encode_images(images), found.encode_images(images)
    launches = dict(fa.LAUNCHES)
    check_per_step("checkpoint_discovery", launches)
    if written != [f"open_clip_{CLIP_NAME}_{DISCOVERY_WEIGHTS}{checkpoints.PORT_SUFFIX}"]:
        raise AssertionError(f"checkpoint_discovery: the CLI wrote {written}")
    if not torch.equal(got, want):
        raise AssertionError(f"checkpoint_discovery: embeddings {_max_diff(got, want)} off")
    emit({"phase": "checkpoint_discovery", "ok": True, "model": CLIP_NAME,
          "weights": DISCOVERY_WEIGHTS, "artifact": written[0],
          "artifact_bytes": artifact_bytes, "cli_s": cli_s, "load_s": load_s,
          "bitwise": True, "launches": launches})
    return launches, launches


def phase_timings(fa, peak_flops, peak_bw) -> list:
    """Kernel, plain version, SDPA and the fused flash backward per site,
    and the bound; for the forward, the mma.sync design's ms beside it."""
    import torch
    import torch.nn.functional as F

    rows = []
    site_list = [(site, site_inputs, "guided_step") for site in SITES] + [
        (site, adm_site_inputs, "adm_guided_sample") for site in ADM_SITES] + list(
        zip(LDM_SITES, LDM_SITE_INPUTS, LDM_SITE_PATHS))
    for i, ((site, b, h, s, d, count), make_inputs, path) in enumerate(site_list):
        q, k, v, do = make_inputs(b, h, s, d, seed=100 + i)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_forward(q, k, v, scale)
        delta = (o.float() * do.float()).sum(-1)
        kernels = {
            "flash_fwd": (lambda: fa.flash_forward(q, k, v, scale),
                          lambda: fa.flash_forward_plain(q, k, v, scale)),
            "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, scale),
                         lambda: fa.flash_dq_plain(q, k, v, do, lse, delta, scale)),
            "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, scale),
                          lambda: fa.flash_dkv_plain(q, k, v, do, lse, delta, scale)),
        }
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qg, kg, vg, scale=scale).backward(do)

        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            fused_bwd = fused_flash_backward(q, k, v, do, scale)
            fused_bwd_ms = None if fused_bwd is None else time_ms(fused_bwd)
        sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd)
        for name, (kernel_fn, plain_fn) in kernels.items():
            flops, nbytes = site_work(name, b, h, s, d)
            t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
            rows.append({
                "kernel": name, "site": site, "path": path, "shape": [b, h, s, d],
                "per_step": count, "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn, reps=5),
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "flops": flops, "bytes": nbytes,
                "sdpa_fwd_ms": sdpa_fwd, "sdpa_fwd_bwd_ms": sdpa_fwd_bwd_ms,
                "fused_bwd_ms": fused_bwd_ms,
                **({"design": fa.fwd_design(d, q.dtype)} if name == "flash_fwd" else {}),
            })
    # the forward at the CFG sampling step's batch-2 sites and at SDXL's
    forward_sites = [(site, site_inputs, "sample", 120 + i) for i, site in enumerate(CFG_SITES)]
    forward_sites += [(site, make_inputs, "sdxl_sample", 140 + i) for i, (site, make_inputs)
                      in enumerate(zip(SDXL_SITES, SDXL_SITE_INPUTS))]
    for (site, b, h, s, d, count), make_inputs, path, seed in forward_sites:
        q, k, v, _ = make_inputs(b, h, s, d, seed=seed)
        scale = 1.0 / math.sqrt(d)
        flops, nbytes = site_work("flash_fwd", b, h, s, d)
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        with torch.no_grad():
            sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        rows.append({
            "kernel": "flash_fwd", "site": site, "path": path, "shape": [b, h, s, d],
            "per_step": count, "ms": time_ms(lambda: fa.flash_forward(q, k, v, scale)),
            "plain_ms": time_ms(lambda: fa.flash_forward_plain(q, k, v, scale), reps=5),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "sdpa_fwd_ms": sdpa_fwd,
            "design": fa.fwd_design(d, q.dtype),
        })

    # per guided step: the port's two backward kernels against SDPA's
    # backward (its forward plus backward, less its forward)
    def weighted(names, key):
        return sum(r[key] * r["per_step"] for r in rows
                   if r["kernel"] in names and r["path"] == "guided_step")

    # and against PyTorch's fused flash backward (dq, dk and dv in one
    # call) at the sites whose head_dim it takes
    fused = [r for r in rows if r["path"] == "guided_step" and r["fused_bwd_ms"] is not None]
    backward = {
        "dq_plus_dkv_ms": weighted(("flash_dq", "flash_dkv"), "ms"),
        "sdpa_bwd_ms": weighted(("flash_fwd",), "sdpa_fwd_bwd_ms")
        - weighted(("flash_fwd",), "sdpa_fwd_ms"),
        "fused_bwd_ms_where_taken": sum(
            r["fused_bwd_ms"] * r["per_step"] for r in fused if r["kernel"] == "flash_fwd"),
        "dq_plus_dkv_ms_where_taken": sum(
            r["ms"] * r["per_step"] for r in fused if r["kernel"] in ("flash_dq", "flash_dkv")),
        "no_fused_bwd_sites": sorted(
            {r["site"] for r in rows if "fused_bwd_ms" in r and r["fused_bwd_ms"] is None}),
    }
    emit({"phase": "timings", "ok": True, "rows": rows, "backward_per_step": backward})
    return rows


def kernel_table(rows, launches_by_path, per_step_by_path, errors) -> list:
    """Per kernel, the work of one guided step (site times weighted by their
    launches per step), its launches in every main-path run, and its
    measured launches and ms per step of each path."""
    table = []
    for name in REPLACES:
        mine = [r for r in rows if r["kernel"] == name and r["path"] == "guided_step"]

        def weighted(key, weights=None):
            return sum(r[key] * (weights or {}).get(r["site"], r["per_step"]) for r in mine)

        sampling = [r for r in rows if r["kernel"] == name and r["path"] == "sample"]
        adm = sum(r["ms"] * r["per_step"] for r in rows
                  if r["kernel"] == name and r["path"] == "adm_guided_sample")

        def path_ms(path):
            return sum(r["ms"] * r["per_step"] for r in rows
                       if r["kernel"] == name and r["path"] == path)

        # ruDALL-E's AttnBlocks run at the KL-f8 decoder's 256px site
        vqgan_site_ms = sum(r["ms"] for r in rows
                            if r["kernel"] == name and r["site"] == "kl_f8_mid_attn_256")

        t_ops = sum(r["flops"] * r["per_step"] for r in mine)
        t_bytes = sum(r["bytes"] * r["per_step"] for r in mine)
        table.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            **({"wgmma_source": FWD_WGMMA_SOURCE} if name == "flash_fwd" else {}),
            "replaces": REPLACES[name],
            "launches": sum(path[name] for path in launches_by_path.values()),
            "max_abs_err": errors[name], "ms": weighted("ms"), "plain_ms": weighted("plain_ms"),
            "bound_ms": weighted("bound_ms"),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in mine) else "bytes",
            # one PyTorch call computes the forward alone (SDPA); none computes
            # dq or dk/dv alone (SDPA's backward returns all three)
            "library_ms": weighted("sdpa_fwd_ms") if name == "flash_fwd" else None,
            "flops_per_step": t_ops, "bytes_per_step": t_bytes,
            "launches_by_path": {path: counts[name] for path, counts in launches_by_path.items()},
            "launches_per_step": {path: counts[name] for path, counts in per_step_by_path.items()},
            "ms_per_step_by_path": {
                "guided_step": weighted("ms"),
                "sample": sum(r["ms"] * r["per_step"] for r in sampling),
                # per SDXL UNet evaluation, forward only
                "sdxl_sample": sum(r["ms"] * r["per_step"] for r in rows if r["kernel"] == name
                                   and r["site"].startswith("sdxl_unet")),
                "guided_sample": weighted("ms", CFG_GUIDED_SITE_LAUNCHES),
                "guided_sample_text": weighted("ms", CFG_GUIDED_SITE_LAUNCHES),
                # the 9-channel UNet has SD-1.x's sites
                "inpaint_sample": sum(r["ms"] * r["per_step"] for r in sampling),
                "inpaint_guided_sample": weighted("ms", CFG_GUIDED_SITE_LAUNCHES),
                "aesthetic_guided_sample": weighted("ms", CFG_GUIDED_SITE_LAUNCHES),
                "depth_guided_sample": weighted("ms", CFG_GUIDED_SITE_LAUNCHES),
                # per UNet evaluation (forward only) and per guided step
                "adm_sample": adm if name == "flash_fwd" else 0.0,
                "adm_guided_sample": adm,
                # forward only: per UNet evaluation, and per decode
                "ldm_text2image": path_ms("ldm_text2image") if name == "flash_fwd" else 0.0,
                "ldm_face": path_ms("ldm_face") if name == "flash_fwd" else 0.0,
                "ldm_text2image_decode":
                    path_ms("ldm_text2image_decode") if name == "flash_fwd" else 0.0,
                # per optimizer step, and per encode
                **{path: PER_STEP[path][name] * vqgan_site_ms for path in (
                    "rudalle_optimize", "rudalle_optimize_dwt", "rudalle_encode")},
            },
        })
    return table


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from perceptor_tpu_torch import guided_step
    from perceptor_tpu_torch.models.guided_diffusion import GuidedDiffusion
    from perceptor_tpu_torch.models.stable_diffusion import StableDiffusion
    from perceptor_tpu_torch.ops import cuda_library
    from perceptor_tpu_torch.ops import flash_attention_kernel as fa
    from perceptor_tpu_torch.ops import groupnorm as gn
    from perceptor_tpu_torch.ops import layernorm as ln
    from perceptor_tpu_torch.utils.bench_env import triton_imports
    from perceptor_tpu_torch.utils.flops import card_peaks

    started = time.perf_counter()
    smi = nvidia_smi()
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bw = card_peaks(name)
    emit({
        "phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
        "device": name, "nvidia_smi": smi, "peak_bf16_flops": peak_flops,
        "peak_bytes_per_s": peak_bw, "triton": triton_imports(),
    })

    t0 = time.perf_counter()
    library = cuda_library.build_library()
    emit({"phase": "build", "ok": True, "library": library.name,
          "seconds": time.perf_counter() - t0})

    errors = phase_kernels(fa)
    phase_kernel_info(fa, library)
    phase_group_norm(gn)
    phase_layer_norm(ln)
    t0 = time.perf_counter()
    step = guided_step.build("sd-v1-512", device="cuda", seed=0)
    emit({"phase": "model_build", "ok": True, "seconds": time.perf_counter() - t0})
    launches, measured = {}, {}
    launches["guided_step"], measured["guided_step"] = phase_guided_step(fa, step)
    phase_routing_report(step)
    phase_profile(step)
    phase_flops(step)
    launches["guided_step_remat"], measured["guided_step_remat"] = phase_guided_step_remat(
        fa, step)
    phase_route_parity(step)
    t0 = time.perf_counter()
    sd = StableDiffusion(MODEL, device="cuda", seed=0)
    emit({"phase": "sd_build", "ok": True, "model": MODEL, "seconds": time.perf_counter() - t0})
    phase_group_norm_steps(gn, step, sd)
    phase_layer_norm_guided(ln, step)
    launches["sample"], measured["sample"] = phase_sample(fa, sd, gn, ln)
    phase_sample_profile(sd)
    launches["sample_deepcache"], deepcache_measured = phase_sample_deepcache(fa, sd)
    measured.update(deepcache_measured)
    launches["guided_sample"], measured["guided_sample"], guided_losses = phase_guided_sample(
        fa, sd, step)
    # the torch.export programs over the same model, then the training stats
    # over the loaded guided program's losses
    launches["serving_sample"], measured["serving_sample"] = phase_serving_sample(fa, sd)
    (launches["serving_guided_sample"], measured["serving_guided_sample"],
     serving_losses) = phase_serving_guided_sample(fa, sd, step)
    phase_training_stats(torch.cat([guided_losses, serving_losses]))
    launches["serving_conditioning"], measured["serving_conditioning"] = (
        phase_serving_conditioning(fa, sd))
    mesh_launches, mesh_measured = phase_mesh_sample(fa, sd, step)
    launches.update(mesh_launches)
    measured.update(mesh_measured)
    phase_parallel_collectives(fa)
    del sd
    torch.cuda.empty_cache()
    launches["sdxl_sample"], measured["sdxl_sample"] = phase_sdxl_sample(fa, gn, ln)
    # SD inpainting; its guided phase shares the guided step's loss
    t0 = time.perf_counter()
    sd = StableDiffusion(INPAINT_MODEL, device="cuda", seed=0)
    emit({"phase": "inpaint_build", "ok": True, "model": INPAINT_MODEL,
          "seconds": time.perf_counter() - t0})
    launches["inpaint_sample"], measured["inpaint_sample"] = phase_inpaint_sample(fa, sd)
    launches["inpaint_guided_sample"], measured["inpaint_guided_sample"] = (
        phase_inpaint_guided_sample(fa, sd, step))
    phase_inpaint_route_parity(sd)
    # the optimization phases' peaks are their own: no diffusion model loaded
    del step, sd
    torch.cuda.empty_cache()
    clip = phase_text_tower(fa)  # held: the phases below share this tower
    phase_optimize_raw(fa)
    phase_optimize_cutouts(fa)
    phase_optimize_jpeg(fa)
    launches["session_resume"], measured["session_resume"] = phase_session_resume(fa)
    sd = StableDiffusion(MODEL, device="cuda", seed=0)
    launches["guided_sample_text"], measured["guided_sample_text"] = phase_guided_sample_text(fa, sd)
    del sd
    torch.cuda.empty_cache()
    # the pixel-space families; the text loss still shares the held tower
    t0 = time.perf_counter()
    gd = GuidedDiffusion(ADM_MODEL, device="cuda", seed=0)
    torch.cuda.synchronize()
    emit({"phase": "adm_build", "ok": True, "model": ADM_MODEL,
          "seconds": time.perf_counter() - t0})
    launches["adm_sample"], measured["adm_sample"], adm_image = phase_adm_sample(fa, gd)
    launches["adm_guided_sample"], measured["adm_guided_sample"] = phase_adm_guided_sample(
        fa, gd, adm_image)
    phase_adm_route_parity(gd)
    del gd
    torch.cuda.empty_cache()
    velocity_launches, velocity_measured = phase_velocity_sample(fa)
    launches.update(velocity_launches)
    measured.update(velocity_measured)
    torch.cuda.empty_cache()
    launches["serving_velocity"], measured["serving_velocity"] = phase_serving_velocity(fa)
    del clip
    torch.cuda.empty_cache()
    # the latent-diffusion family, one model at a time, then
    # MonsterDiffusion, CLIP's ResNet towers, the perceptual losses and the
    # depth models
    for phase in (phase_ldm_text2image, phase_ldm_face, phase_ldm_super_resolution,
                  phase_monster_sample, phase_clip_resnet, phase_perceptual_losses,
                  phase_perceptual_optimize, phase_aesthetic_guided_sample, phase_depth_models,
                  phase_depth_optimize, phase_depth_guided_sample, phase_ensemble_guided_sample,
                  phase_clip_variants):
        path = phase.__name__.removeprefix("phase_")
        t0 = time.perf_counter()
        launches[path], measured[path] = phase(fa)
        if path in ("ensemble_guided_sample", "clip_variants"):
            emit({"phase": f"{path}_seconds", "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dip_launches, dip_measured = phase_dip_optimize(fa)
    launches.update(dip_launches)
    measured.update(dip_measured)
    emit({"phase": "dip_optimize_seconds", "seconds": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    # ruDALL-E's drawer on the flash kernels, then Real-ESRGAN, OWL-ViT and
    # GLIDE's CLIP
    rudalle_launches, rudalle_measured = phase_rudalle_optimize(fa)
    launches.update(rudalle_launches)
    measured.update(rudalle_measured)
    torch.cuda.empty_cache()
    for phase in (phase_super_resolution, phase_owlvit_loss, phase_glide_clip):
        path = phase.__name__.removeprefix("phase_")
        launches[path], measured[path] = phase(fa)
        torch.cuda.empty_cache()
    # StyleGAN-XL: the drawer under CLIP, ffhq256, the checkpoint readers
    stylegan_launches, stylegan_measured = phase_stylegan_xl_optimize(fa)
    launches.update(stylegan_launches)
    measured.update(stylegan_measured)
    torch.cuda.empty_cache()
    launches["checkpoint_discovery"], measured["checkpoint_discovery"] = (
        phase_checkpoint_discovery(fa))
    torch.cuda.empty_cache()
    rows = phase_timings(fa, peak_flops, peak_bw)
    emit({"phase": "total", "seconds": time.perf_counter() - started,
          "pr14_seconds": PR14_SECONDS})

    print(json.dumps({"kernels": kernel_table(rows, launches, measured, errors)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
