#!/usr/bin/env python3
"""Smoke run of the PyTorch port (denoise_gan_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py          # from the repository root

Phases, each printed on its own line:
1. device: needs torch.cuda; prints nvidia-smi's name and power limit.
2. build: compiles csrc/*.cu with nvcc into the package's _build/.
3. K1 vs twin: the FSRGAN fused tail kernel (csrc/tail.cu) against its
   plain PyTorch twins at the 1080p main-path shapes (h (128, 139, 124, 32),
   8x16 tiles, core_rows 135): the u8 epilogue in bf16, w8a8 and qh8 (h
   from quantize_h of the seeded h), RGB and BGR, and the canvas epilogue
   in the three modes.  Bound: max |du8| <= 1 on < 1e-3 of the bytes; the
   canvas within 2**-8 (one bf16 rounding at the top of tanh's range) on
   < 1e-3 of the values (bf16: < 2e-3, bf16 values round apart more often
   than bytes).  w8a8 u8 must be bit-identical; for qh8 and the int8
   canvases bit-identity is the target, and each line says if it held.
   Then K1's build: each instantiation's IMMA and HMMA counts in its SASS
   (cuobjdump; the run fails if a mode's tensor-core products, HMMA for
   bf16 and w8a8's up1, IMMA for the int8 ones, count 0), its registers
   and spills (ptxas), dynamic shared memory and resident blocks an SM;
   the parameters the kernel reports (dgt_tail_params: up1's margin by
   mode, the block and chunk geometry), which must equal ops/tail.py's
   (up1_err(288) in w8a8, BLOCK, CHUNK);
   w8a8 and qh8, u8 and canvas, on the one-sign input at 1080p
   (ops/tail.py::one_sign_up1_ on a copy of the seeded tail, one_sign_h,
   the int8 scales calibrated on it: every up1 product >= 0, the bias
   cancelling the large sums), and w8a8 on the exact-sum input
   (ops/tail_srgan.py::dyadic_up1_ on a copy of the seeded tail, dyadic_h:
   every f32 partial sum of up1 exact in any order), bit-identical to the
   twin (K1, like K2, keeps a tensor-core u1 in w8a8 only where its int8
   step is certain within ops/tail.py::up1_err(288) and sums the rest
   again in the twin's order); and (printed) the share of up1's values that
   margin leaves uncertain on 16 seeded tiles and the one-sign input, by
   the kernels' own test (tail_common.cuh::up1_certain, through
   dgt_up1_certain) on the twin's sums.
3b. K2 vs twin: the SRGAN fused tail kernel (csrc/tail_srgan.cu) the same
   way, at h (128, 139, 124, 64); w8a8 bit-identical as in K1 (the kernel
   sums up1 on the tensor cores and again, in the twin's order, where that
   leaves u1's rounding uncertain).  Then K2's build report as K1's (HMMA
   for bf16 and w8a8's up1, IMMA for the int8 products; its w8a8 margin
   must equal ops/tail.py::up1_err(576), its bf16 margin is the measured
   2**-18, printed); the one-sign and exact-sum inputs as K1,
   bit-identical to the twin.  Then the w8a8 margins ERR = the twin's part
   gamma_{K-1} (proven) plus the tensor core's (an allowance of 2**-16),
   as the kernels report them, at K in SUM_KS (K1's 288 and K2's 576): the
   largest distance, relative to |x| |w|, of f32 sums of K bf16 products
   from the exact sum, for bf16 mma.sync (K8's chained product kernel,
   relayout.py's seeded operands, 2048 x 128 sums; K = 288 zero-padded to
   K8's multiple of 64, the zero products adding nothing) and for the
   twin's one-at-a-time order, on inputs of both signs and of one sign;
   the run fails unless the twin's order stays within its part and
   mma.sync within a tenth of its part, and (K = 576) unless the two
   together stay below K2's measured bf16 margin 2**-18.  The same at K3's
   depths, K = 32 (the expand; K8's product zero-padded to 64) and K = E =
   192 (the project), against the tensor core's allowances that K3
   reports (dgt_mbconv_params: mma.sync within a tenth of each) and the
   plain order's gamma_{K-1}.  The share of up1's values that the margin
   leaves uncertain (summed again by the repair) on 16 seeded tiles (w8a8,
   bf16) and on the one-sign input (w8a8), as for K1.  And (printed) how
   far the twin's frame moves when up1 is summed exactly (float64, rounded
   once) instead of in its order: w8a8 u8 and the bf16 canvas at 1080p,
   against the kernel-vs-twin bounds.
3c. K3 vs its plain version: the fused inverted residual (csrc/mbconv.cu)
   at the 1080p body shape x (128, 139, 124, 32) bf16, with and without
   the expand, on the seeded FSRGAN blocks (non-zero BN statistics, so
   relu(be) > 0 and the zero ring of the expanded tensor matters), and on
   the one-sign input (ops/mbconv.py::one_sign_x, the blocks through
   one_sign_block: every product of the expand and the project >= 0, the
   biases cancelling the large sums), bit-identical to the plain version
   (the kernel keeps a tensor-core value only where its bf16 rounding is
   certain within its margin and sums the rest again in the plain order).
   The parameters the kernel reports (dgt_mbconv_params: the margins'
   parts, the unit and chunk geometry, the threads) must equal
   ops/mbconv.py's; printed, the share of d and of y values that each
   test left to the repair, counted by the kernel itself
   (fused_mbconv_counted, a check entry that no frame path runs).
3d. The probes vs their plain versions at the JAX probes' shapes (no frame
   path runs them).  K9 (csrc/probe_fma.cu) at x (512, 1024), seeded as
   tools/exp_vpu_peak.py: the FMA chain (256 steps) and the roll + FMA
   chain (128 steps) bit-identical to their plain versions, which round
   each multiply-add once as fmaf does (fma_peak.fma_f32).  K6 (csrc/probe_mma.cu) at y
   (K, 3840), K in (128, 384, 1152), from the probe's initial state: int8
   bit-identical to the float64 plain version after 2000 steps (there it
   saturates at 127 within two steps, so also from a random state of both
   signs after RANDOM_STEPS steps); bf16 at steps 1-16 only (the chain
   overflows to inf, then NaN, well before step 100), each step from the
   kernel's previous state within int8_chain.bf16_step_bound (one bf16
   rounding after f32 sums in another order), rows >= 128 unchanged, and
   one 16-step launch equal to the 16 single steps; the same from a random
   state.  K8 (csrc/probe_relayout.cu): the product kernel's LDSM (.trans
   among them) and HMMA counts by cuobjdump (printed); matmul_form in both
   operand forms at the JAX shapes (2048, 384, 128), (2048, 1152, 128),
   (1024, 1152, 48) with 64 reps, every element of y within
   relayout.product_bound of the float64 plain version (K * 2**-24 *
   sum |x w|: f32 sums in another order) and acc within
   relayout.acc_bound; the transpose chain at (1536, 128) x 8 iterations
   bit-identical.  K10 (csrc/probe_u8.cu): the u8 phase store at (1024,
   48) and at a 4K frame's (518400, 48), drawn on the card, bit-identical
   (tanhf is torch's CUDA tanh; every step rounded apart on both sides).
   K7 (csrc/probe_overlap.cu) from the probe's initial state, y (128,
   15360) bf16, z (8, 15360) f32: the loops of its SASS by cuobjdump
   (printed; mode both's loop must hold HMMA and SHFL); modes mxu and both
   for 8 single steps from the kernel's previous state, y within
   overlap.step_bound (one bf16 rounding after f32 sums in another order),
   z bit-identical, and one 8-step launch equal to them; each mode at the
   JAX counts (4000, 0), (0, 3000), (4000, 3000), z bit-identical to the
   plain version (fmaf(z, c1, roll * c2) on both sides) and y's columns
   128.. unchanged (y itself overflows to NaN near step 55).  K4
   (csrc/probe_dw.cu): each form at e (192, 2176) f32 bit-identical to its
   plain version (fmaf in the JAX order on both sides) at 1, 37 and 2000
   reps, and chunked apart from scratch after one rep exactly at columns 0
   and 127 of each output chunk.  K5 (csrc/probe_mbpipe.cu) in each mode
   (one chain; two chains with their own barriers, or one barrier with
   their phases aligned or offset) from the probe's initial state, r
   (32, 2176) bf16: launches of 1, 2 and 37 steps, each adding one to its
   launch count, the last step against the plain version's pieces from the
   kernel's own bands one step earlier (mbpipe.check: E and p within
   mbpipe.expand_bound and project_bound, tensor-core f32 sums in another
   order; D bit-identical to the depthwise of the kernel's own E; the new
   bands bit-identical to the update from the kernel's own p), and the
   same at 2 steps on one band per SM, every band also equal to that band
   launched alone.
4. FSRGAN engine: the full-width FSRGAN generator (gf=32, 6 blocks) from
   numpy-seeded weights, 1080p -> 4K through build_fsrgan_kernel_engine on
   two alternating seeded frames, once per main path: w8a8 (calibrated on
   the first frame), qh8 (the same calibration), bf16, and the float-output
   engine (out_uint8=False, the canvas epilogue) on one frame.  Each run
   zeroes the launch counts just before and reads them just after: K1 ran
   once per frame in that path's epilogue and mode, and nothing else.
   Checks shape, dtype, device, that the output is not flat, the float
   frame's (4320, 7680, 3) f32 in [0, 1] and its trunc(x*255 + 0.5)
   against the u8 engine (max 1 on < 1e-3), the w8a8 and the qh8 engine
   with the twin as tail within the phase-3 bound (bit-identical), and, on
   a small input, the bf16 kernel tail against the plain f32 FSRGANTail
   module.  Prints qh8 against w8a8: the JAX package's qh8 envelope (max
   <= 2, > 1 on < 5e-3) does not hold on these seeded weights, for the JAX
   package's engines as for the port's (PERF.md, section 6); phase 4d
   asserts it on the JAX package's initialisation.
4b. SRGAN engine: the full-width SRGAN generator (16 residual blocks, 64
   filters) the same way through build_srgan_kernel_engine, with K2; then
   the input options: the u8_input + bgr_input engine on a uint8 BGR frame
   byte for byte against the bgr_input engine on the same frame as float
   (w8a8), and against the float RGB engine within the whole-slice
   envelopes (bf16 max <= 1 on < 5%; w8a8 max <= 3, > 1 on < 1%).
4c. FSRGAN engine with the K3 body: prepare_mbconv_fsrgan_engine (the
   body's six inverted residuals as K3 launches, the w8a8 tail calibrated
   on its output) wired by build_kernel_engine, on the same frames.  Checks
   that K3 ran 6 times and K1 once per frame and nothing else, the output
   as phase 4, and the engine against the plain-body engine on the same
   weights and tail: both bf16 bodies round away from the f32 body (the K3
   body once per block, the plain one after every op), so the bound is the
   plain-body engine's own distance from the engine with the f32 body (TF32
   off): the K3-body engine differs from that engine on no more bytes, and
   by more than one level on no more bytes.  Then the same engine with K3's
   plain version as its blocks, byte for byte.
4d. The whole-frame quality rule (the JAX package's tools/exp_q8_exact.py):
   per family, each engine mode against the exact whole-frame output, the
   plain bf16 generator on the whole 1080p frame edge-padded at the bottom
   and right to a multiple of 8 rows and 128 columns (as the JAX whole-frame
   engine, infer/engine.py:170-176), clip((y+1)/2) and trunc(x*255 + 0.5)
   as uint8, cropped.  Frames: a seeded u8-representable noise frame, and a
   structured scene-change frame with the int8 modes calibrated on the
   noise frame.  Modes: bf16, w8a8, qh8, u8q8-bgr (u8 BGR input and output,
   w8a8: the video CLI's production engine; noise frame only), and for
   FSRGAN the K3-body w8a8 engine; each over the whole frame and over its
   interior (the pixels at least INTERIOR coarse pixels from a tile seam
   and from the frame border).  Two weight sets: the seeded generators of
   the phases above, and the JAX package's own initialisers drawn with
   numpy (jax_init_tree; the weights tools/exp_q8_exact.py scores).  The
   rule (w8a8's share > 1 at most bf16's + 0.1 percentage point, qh8's at
   most w8a8's + 0.1 pp, the int8 modes' max at most bf16's + 2) and the
   JAX package's qh8 envelope (the qh8 engine within max 2, > 1 on < 5e-3,
   of the w8a8 engine) are printed for both and asserted on the JAX-init
   weights.  On the seeded weights they are printed only: there the JAX
   package's engines miss them by the same margins as the port's (PERF.md,
   section 6), so they measure the weights and modes, not the port.
   Asserted on both: in bf16 the engine equals the whole-frame output
   within 1 level on the interior (max <= 2, > 1 on < 1e-3: only summation
   order differs there), so every larger difference sits at the tile seams
   and frame borders.
4e. The generic frame engine (infer/engine.py::build_frame_engine, plain
   PyTorch, no hand kernel: each engine's run must launch none), at full
   width on seeded weights (rng SEED + 1; BN running statistics away from
   0 and 1), the 1080p frames of phase 4: the autoencoder's crop engine at
   tile 128 / overlap 8 (9 x 16 tiles; bf16 and f32, and in bf16 with bgr
   and with frames_per_call 2) and pix2pix's at 256 / 8 (5 x 8 tiles; bf16
   and f32), each the plain generator per tile (the video CLI's 1x
   engine); FSRGAN 4x through infer/fast.py::build_fast_coarse (bf16),
   feathered and cropped at 144 / 4 and whole-frame (tile 0); SRGAN 2x
   through it, feathered at 144 / 4.  Asserted: (a) each family's engine
   on the card against the same engine on the CPU, f32 (TF32 off), at
   270x480 (pix2pix 256x512): max |du8| <= 1 on < 1e-3 of the bytes;
   (b) the autoencoder and pix2pix crop engines against a per-tile loop
   written here (each tile through the generator alone, its core copied
   into place), at 1080p: f32 the same bound; bf16 within PERF.md section
   2's bf16 envelope, max 1 on < 5% (cuDNN sums one tile in another order
   than the batch, and bf16 carries the roundings through every layer:
   the autoencoder measured 2.7e-3 on the H100); the bgr output
   equal to the RGB output flipped, the frames_per_call=2 output to the
   single frames within the bound; (c) every output (H*s, W*s, 3) uint8 on
   the card.  Printed: (d) the FSRGAN whole-frame engine against its
   feathered and cropped engines (share of bytes > 1 level apart);
   frames/s and torch.cuda.max_memory_allocated per engine and dtype, the
   FSRGAN kernel engines' frames/s beside them, and the card's name and
   power limit.
4f. The CLIs (infer/video.py, infer/image.py) as a user runs them, in
   this process, on the card: seeded FSRGAN, SRGAN 4x and autoencoder
   generators written as .dgt exports by io/checkpoint.py::
   export_generator (the FSRGAN and SRGAN of phase 3, an autoencoder from
   rng SEED + 2), and a 6-frame 1080p RGBA AVI (io/avi.py: three frames of
   colour waves, then a scene change to three of the structured frame).
   The video CLI runs FSRGAN by default (the kernel engine, w8a8 calibrated
   on frames 0, 1, 3, 4, uint8 BGR in, RGB out packed to RGBA on the card,
   unscored), scored (f32 RGB in, frame 0 scored), with --q8 2 and --q8 0,
   SRGAN w8a8, FSRGAN's default again (warm: the first run pays the CLI's
   one-time costs), the autoencoder's crop engine (128/8) and FSRGAN with
   --kernel_tail 0 (the coarse engine, 144/4), each writing an RGBA AVI.
   Asserted: every frame read back from each output equals the same engine
   built and called here on the same frames with the same calibration; with
   every launch count zeroed before each run and read after it, K1 (FSRGAN)
   or K2 (SRGAN) fired once a frame in its mode, and the other runs
   launched no hand kernel; the scored run's PSNR and SSIM equal
   ops/metrics.py's on its frame against the bicubic upscale (within 1e-5);
   the image CLI on two 1080p .npy frames (FSRGAN, whole image) writes the
   direct forward's bytes. Printed: each run's frames/s by the host clock
   (decode, copies and writing included) beside the same engine's frames/s
   alone, and the AVI reader's ms per 1080p frame, the writer's per
   4320x7680 RGBA frame, the CLI's packing of it on the card with its copy
   to pinned memory, and its uint8 copy to the host (pinned and pageable);
   a scored frame's parts on the card (bicubic reference, cold and warm,
   levels to f32, PSNR, SSIM); and the default FSRGAN run, warm, on a
   24-frame clip without an output and writing one (the run fails where the
   disk has no room for it). The files are deleted.
4g. Training (train/, plain PyTorch: no hand kernel may launch): 32
   seeded uint8 .npy images at DIV2K's size (1356x2040: colour waves
   plus noise, made on the card) written under _train_smoke/ (deleted
   after); each trainer run through its entry point,
   train_<family>_torch.py's main, from that directory, at full width
   (FSRGAN gf 32, SRGAN 16 blocks, the full discriminators and VGG19),
   crop 256 (the default), batch 16, 3 epochs of 2 steps, each family at
   its own fp16 default (SRGAN bf16), on the card.  Asserted: every
   launch count zero across the run; 6 steps and 3 epoch lines; the
   losses finite (the loop's check at each summary, and one more step
   after); the exports read back into fresh nets equal the final state;
   one FSRGAN step (f32, TF32 off, degrade=False, crop 64, batch 4) on
   the card against the same step in float64 on the CPU from the same
   weights and pair, within the CPU tests' tolerances (losses 1e-5
   relative, BN statistics 1e-5, the gradients recovered from Adam per
   tensor cosine >= 0.9999, norms within 1e-3) and max |d| <=
   STEP_GRAD_CARD max |g| per tensor; printed beside it, with the three
   worst tensors of each net, the CPU's f32 step (oneDNN off, as the step
   runs, and on) against float64.  Printed: per family the run's wall time,
   StepTimer's steps/s and images/s (after the first step; the loop's
   data loading, summaries and checkpoints included), the step alone by
   CUDA events over BARE_STEPS steps, peak memory
   (torch.cuda.max_memory_allocated over the run); FSRGAN's step split by
   CUDA events at the step's marks (train/step.py::PARTS) and the
   device's idle share over 3 steps from a torch.profiler trace.
4h. Data parallelism (parallel/mesh.py), two ranks spawned over gloo on
   the one card (cuda:0; NCCL refuses two ranks on one card), each joining
   through a file store, at full width.  Training: the FSRGAN step at crop
   256, global batch 16 (8 a rank; phase 4g's seeded weights and its
   first 16 images, the JPEG qualities drawn at random over the global
   batch) and pix2pix's at global batch 2 (its dropout masks drawn over
   the global batch too), each rank against the one-process step on the
   card: in f32 the losses and BatchNorm statistics within 1e-5
   (pix2pix's statistics 1e-4), the gradients' directions (cosine 0.9999;
   pix2pix's generator 0.999), their norms within 3e-3 and max |d| within
   5e-2 of max |g| (pix2pix's generator 5e-3 and 1e-1; F32_RULES: kinks
   flip between 8 images a rank and 16); both steps again in
   float64, held to the CPU tests' whole rule; both nets bit-identical
   across the ranks after each step;
   gloo's all_reduce (f32, uint8) and broadcast on CUDA tensors.
   Serving: the FSRGAN w8a8 kernel engine at 1080p -> 4K, two distinct
   frames a rank (parallel/mesh.py::map_frames), each rank's frames
   byte-equal to the one-process engine's, K1 fired once a frame on each
   rank (counts zeroed just before, read just after); the same with the K3
   body (K3 six times a frame); the autoencoder's f32 crop engine with its
   tile batch split over the ranks, within phase 4e's bound of the
   one-process engine (byte-equality printed).  The native codec: whether
   it built, the decoder data/pipeline.py::decode_image uses, and where
   it built the ms of a JPEG round trip of a seeded 1356x2040 image.
   Printed: the two-rank step's ms beside the one-process step's, with the
   card's name and power limit (two ranks sharing one card: not a scaling
   figure), and the phase's time.
4i. (a) A reference Keras .h5 on the card (io/hdf5.py, io/keras_h5.py;
   no h5py there): tests/data/fsrgan_ref.h5 (the reference FSRGAN at full
   width, saved by Keras from numpy-seeded weights) read by the port's
   reader, each dataset's shape and sha256 equal to its sidecar's; the
   port's converter (python3 -m denoise_gan_tpu_torch.io.keras_h5) writes
   a .dgt of it; the video CLI (infer_video_torch.py's main) on a seeded
   2-frame 1080p RGBA AVI with --model the .h5 and with the .dgt, counts
   zeroed just before each run and read just after: K1 (w8a8) once a
   frame, the frames byte-equal; the K3-body engine from each, K3 six
   times and K1 once a frame, byte-equal; printed, the load time of each
   onto the card.  (b) The space axis (parallel/spatial.py): two ranks
   spawned over gloo sharing cuda:0 (as phase 4h), FSRGAN and SRGAN at
   full width from seeded weights, whole-frame forward of a seeded 1080p
   frame, rows 540 / 540, f32 (TF32 off) and bf16: each rank's rows
   against the one-process forward on the card (f32 max |d| <= 1e-4, the
   JAX test's tolerance, byte-equality printed; bf16 within the bf16
   envelope in u8 levels), one halo exchange a conv wider than 1x1, the
   gathered frame equal on both ranks; printed, each rank's peak memory
   beside the one-process peak, ms a forward and the exchanges' bytes.
5. times: per engine, frames/s (kernel vs twin tail, w8a8 and qh8), tail
   ms/frame (kernel vs twin, each mode and epilogue, and the bf16 tail
   module on cuDNN), quantize_h and body ms/frame; K3's six launches per
   frame vs its plain version and the six plain InvertedResidual modules on
   cuDNN, and the K3-body engine's frames/s beside the plain-body engine's;
   each beside the card's name and power limit.  K3's build: each
   instantiation's HMMA count in its SASS (the run fails if one counts
   0), registers and spills (ptxas), shared memory and blocks an SM; and
   (printed) blocks 0 and 1 through K3's check form, the share of each
   phase in the clock64 cycles of each warp role's first thread.  Each kernel's bound (the
   larger of its bytes over 3.35 TB/s and its operations over the
   tensor-core peak for their type) is computed from the main path's
   shapes.  The probes: K9's ms per launch over 32 chained launches (the
   JAX probe's time_chained) at its iterations (printed: a few
   microseconds of work, where the wrapper's host time between launches
   dominates) and at LONG_ITERS (the kernels line, with the plain version
   timed once at the same count and held bit-identical there; the roll
   chain also on 4096 rows, 8 warps to a scheduler, printed), beside the
   FP32 peak (SMs x 128 lanes x 2 x clocks.max.sm); torch.matmul at the
   JAX probe's matmul shapes (the cuBLAS yardstick); K6's ms per 2000-step
   chain per K and type, its i8/bf16 ratio, its plain version, one step's
   product by torch.matmul / torch._int_mm (printed) and the whole chain
   through those calls (int8_chain.library_chain: library_ms).  Their
   bounds: K9's operations over the FP32 peak, K6's over the bf16 or int8
   tensor-core peak.  K8 and K10 kernels: ms per launch queued behind a
   device sleep (card.queued_ms: the wrapper's host time is not counted).
   K8: matmul_form per form and shape at the probe's 64 reps (the kernels
   line: ms, bound (operations over the bf16 peak), the plain version and
   the same reps through torch.matmul calls (library_ms), all at 64 reps)
   and at LONG_REPS (printed: no plain version runs at the long counts),
   T/s, and sublane / canonical at both; the transpose chain at 8
   iterations (the kernels line, with its bound (bytes), the plain
   version and the chain through .t().contiguous() and mul, all at 8) and
   at LONG_ITERS (printed), and its shared-memory floor.  K10 at (1024,
   48) and at the 4K frame (the kernels line; no single PyTorch call
   computes it), its bound (bytes) and its plain version.  K7: each
   mode's ms at the JAX counts (the kernels line, with the plain version
   timed in phase 3d and the same chains through torch.matmul /
   torch.roll + mul + add: library_ms) and at equal counts
   overlap.EQUAL_ITERS, the JAX probe's comparison (its t(c) runs both
   chains 4000 times) and the one at equal counts with the overlap share
   (t(a) + t(b) - t(c)) / min(t(a), t(b)); bounds: the product's
   operations over the bf16 peak, the roll's over the FP32 peak (and its
   shuffle floor, 32 a clock on one SM), the larger for both.  K4: each
   form's ms per 2000 reps and us per band step against the bound
   (operations over the FP32 peak) and the shared-memory floor, scaled by
   the TPU geometry's 7119 band steps a frame, beside the plain version
   and the chain through F.conv2d(groups=192) with cuDNN's TF32 off.  K5,
   one band per SM: each mode's ms per launch of 1500 steps (the JAX
   default; the modes timed in order, then in reverse), nvidia-smi's SM
   clock, power and temperature while it runs, us per band step over the
   card, x 7119 band steps, the bound (the larger of the tensor-core flops
   over the bf16 peak and the CUDA-core operations over the FP32 peak, the
   JAX step's work once), the gain t1/t2 and aligned/offset; at 32 steps
   (the kernels line) the
   kernel, its plain version and the same steps through torch.matmul,
   torch.roll and elementwise ops (library_ms, TF32 off).

Any failure raises, and the run exits non-zero.  The line before the last
is the kernels' JSON record, the last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import importlib
import io
import json
import math
import os
import pickle
import shutil
import tempfile
import time
from pathlib import Path
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import engine as generic
from denoise_gan_tpu_torch.infer import kernel_engine as ke
from denoise_gan_tpu_torch.infer import image as image_cli
from denoise_gan_tpu_torch.infer import video as video_cli
from denoise_gan_tpu_torch.infer.fast import build_fast_coarse, \
    build_fast_forward
from denoise_gan_tpu_torch.io import avi
from denoise_gan_tpu_torch.data import native, pipeline
from denoise_gan_tpu_torch.data.degrade import degrade_pair
from denoise_gan_tpu_torch.io import hdf5, keras_h5
from denoise_gan_tpu_torch.io.checkpoint import export_generator, \
    load_export_into, load_generator
from denoise_gan_tpu_torch.io.params import from_jax_params
from denoise_gan_tpu_torch.models import build_generator, build_models
from denoise_gan_tpu_torch.models.vgg import init_vgg_params
from denoise_gan_tpu_torch.models.fsrgan import FSRGANTail
from denoise_gan_tpu_torch.models.srgan import SRGANTail
from denoise_gan_tpu_torch.ops import _build
from denoise_gan_tpu_torch.ops import mbconv
from denoise_gan_tpu_torch.ops import image as image_ops
from denoise_gan_tpu_torch.ops import metrics
from denoise_gan_tpu_torch.ops.image import resize_bicubic
from denoise_gan_tpu_torch.models.layers import Conv
from denoise_gan_tpu_torch.parallel import spatial
from denoise_gan_tpu_torch.parallel.mesh import (
    init_distributed, make_mesh, map_frames, row_range, shard_batch,
)
from denoise_gan_tpu_torch.ops import tail as tail_ops
from denoise_gan_tpu_torch.ops import tail_srgan
from denoise_gan_tpu_torch.probes import (dw_forms, fma_peak, int8_chain,
                                          mbpipe, overlap, relayout,
                                          u8_store)
from denoise_gan_tpu_torch.train.state import create_train_state
from denoise_gan_tpu_torch.train.step import PARTS, build_train_step
from denoise_gan_tpu_torch.utils import card
from denoise_gan_tpu_torch.utils.config import make_config, parse_args
from denoise_gan_tpu_torch.utils.device import no_tf32, require_cuda

HEIGHT, WIDTH = 1080, 1920
SEED = 0
MAX_DIFF, MAX_FRAC = 1, 1e-3      # u8 bound, kernel vs twin
CANVAS_DIFF = 2.0 ** -8           # canvas bound: one rounding at |x| >= 0.5
# bf16 canvas: share of values that may differ; measured 1.11e-3 (K1) and
# 5.0e-4 (K2) at 1080p, 1.03e-3 at the 1x2x24 geometry of
# tests/test_torch_cuda.py, all on the H100
CANVAS_FRAC_BF16 = 2e-3
STD_FLOOR = 8.0                   # per-channel u8 std of a non-flat frame
MAIN_FRAMES = 4                   # frames driven through each main path
TIMED_FRAMES = 10
MODES = tail_ops.MODES
# phase 4d: coarse pixels from a tile seam or the frame border beyond which
# a bf16 engine pixel sees no per-tile SAME padding (measured on the CPU at
# 270x480: max 1 level there from 8 on for FSRGAN, from 4 for SRGAN)
INTERIOR = 8
# SRGAN residual-block and post-conv kernels at a tenth of LeCun normal, as
# tests/test_torch_engine_srgan.py: 16 residual adds then neither saturate
# tanh nor amplify bf16 rounding differences between two engines' bodies.
SRGAN_BODY_GAIN = 0.1
# H100 SXM peaks (NVIDIA's data sheet, dense): the bounds' rates
HBM_BYTES_S = 3.35e12
BF16_FLOP_S = 989e12
INT8_OP_S = 1979e12
# phase 3b: the w8a8 up1 margins (csrc/tail.cu, csrc/tail_srgan.cu): a
# kernel keeps a tensor-core u1 value only where every sum within ERR *
# |x| |w| of it rounds alike, ERR = the two parts of ops/tail.py::
# up1_err(K); K is up1's depth, 9 taps x 32 (K1) or 64 (K2) channels.
SUM_KS = {288: "fsrgan", 576: "srgan"}
# phase 3b: the share of u1 values left uncertain is counted on these tiles
SHARE_TILES = 16
# phase 3d: K6 bf16 checked step by step for BF16_STEPS steps (then the
# chain overflows on its way to inf and NaN), the random states for
# RANDOM_STEPS
BF16_STEPS = 16
RANDOM_STEPS = 100
# phase 3d: K7's y checked step by step for K7_STEPS steps (it overflows
# near step 55); K4 at these reps, and at dw_forms.REPS
K7_STEPS = 8
K4_REPS = (1, 37)
# phase 3d: K5's last step checked at these step counts
K5_REPS = (1, 2, 37)
# phase 4e: the generic engines' (tile, overlap) (infer/video.py's
# TILE_DEFAULTS), the cut geometries of the CPU check (a), and the frames
# timed per engine
TILES_1X = {"autoencoder": (128, 8), "pix2pix": (256, 8)}
TILE_4X = (144, 4)
CUT = {"autoencoder": (270, 480), "pix2pix": (256, 512),
       "fsrgan": (270, 480), "srgan": (270, 480)}
GENERIC_FRAMES = 6
# phase 4f: the CLIs' frames, and their files' directory (deleted after)
CLI_FRAMES = 6
STEADY_REPEATS = 4                # the steady run's clip: the frames x 4
CLI_DIR = Path(__file__).resolve().parent / "_cli_smoke"
# phase 4g: the trainers' images (DIV2K's size) and files (deleted after)
TRAIN_DIR = Path(__file__).resolve().parent / "_train_smoke"
TRAIN_IMAGES = 32
DIV2K_HW = (1356, 2040)
TRAIN_BATCH = 16
TRAIN_EPOCHS = 3                  # 2 steps an epoch: 6 steps, 5 timed
BARE_STEPS = 4                    # the step alone, after the run
CHECK_CROP, CHECK_BATCH = 64, 4   # the card-vs-float64 FSRGAN step
STEP_RTOL, STEP_COS, STEP_NORM, STEP_NOISE = 1e-5, 0.9999, 1e-3, 1e-5
# max |d| <= STEP_GRAD_CARD max |g| per tensor, the card's f32 step against
# the same step in float64 on the CPU: the CPU tests' rule, against the
# reference it stands for (PERF.md section 6 has the readings)
STEP_GRAD_CARD = 1e-3
# phase 4e check (b) in bf16: PERF.md section 2's bf16 envelope of the port
# against its references (SRGAN, the K3 body)
BF16_ENVELOPE = 5e-2


@dataclass(frozen=True)
class Family:
    """One 4x family's pieces: generator name, tail module class, body
    channels, tail preparation, the u8 and canvas kernel wrappers and their
    twins, their launch counts, the engine's constructor and preparation,
    the CUDA source, the TPU kernel it replaces, and the gains of the
    seeded body and output conv."""

    name: str
    tail_cls: type
    cin: int
    prepare: Callable
    kernel: Callable
    twin: Callable
    canvas: Callable
    canvas_twin: Callable
    counts: dict
    build: Callable
    prepare_engine: Callable
    source: str
    replaces: str
    body_gain: float
    out_gain: float
    kernel_name: str
    occupancy: str
    params: str
    products: dict

    def key(self, fn: Callable, mode: str) -> str:
        """The launch-count key of a wrapper in a mode."""
        return f"{fn.__name__}:{mode}"


FAMILIES = [
    Family("fsrgan", FSRGANTail, 32, tail_ops.prepare_tail,
           tail_ops.fused_tail_u8, tail_ops.fused_tail_u8_reference,
           tail_ops.fused_tail_canvas, tail_ops.fused_tail_canvas_reference,
           tail_ops.launch_counts, ke.build_fsrgan_kernel_engine,
           ke.prepare_fsrgan_engine, "denoise_gan_tpu_torch/csrc/tail.cu",
           "denoise_gan_tpu/ops/pallas/tail.py:290", 1.0, 0.5,
           "tail_kernel", "dgt_tail_occupancy", "dgt_tail_params",
           {"bf16": ("HMMA",), "w8a8": ("HMMA", "IMMA"), "qh8": ("IMMA",)}),
    Family("srgan", SRGANTail, 64, tail_srgan.prepare_tail64,
           tail_srgan.fused_tail64_u8, tail_srgan.fused_tail64_u8_reference,
           tail_srgan.fused_tail64_canvas,
           tail_srgan.fused_tail64_canvas_reference,
           tail_srgan.launch_counts, ke.build_srgan_kernel_engine,
           ke.prepare_srgan_engine,
           "denoise_gan_tpu_torch/csrc/tail_srgan.cu",
           "denoise_gan_tpu/ops/pallas/tail_srgan.py:151", SRGAN_BODY_GAIN,
           1.0, "tail64_kernel", "dgt_tail64_occupancy", "dgt_tail64_params",
           {"bf16": ("HMMA",), "w8a8": ("HMMA", "IMMA"), "qh8": ("IMMA",)}),
]


COUNTS = [f.counts for f in FAMILIES] + [mbconv.launch_counts,
                                         fma_peak.launch_counts,
                                         int8_chain.launch_counts,
                                         relayout.launch_counts,
                                         u8_store.launch_counts,
                                         overlap.launch_counts,
                                         dw_forms.launch_counts,
                                         mbpipe.launch_counts]


def fired() -> dict[str, int]:
    """The launch counts that are not zero."""
    return {k: v for counts in COUNTS for k, v in counts.items() if v}


def reset_counts() -> None:
    for counts in COUNTS:
        for k in counts:
            counts[k] = 0


def bound(n_bytes: float, ops: list[tuple[float, float]]
          ) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of n_bytes over the memory rate and
    the sum of ops / rate over the (ops, rate) pairs."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = sum(o / r for o, r in ops)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops \
        else "operations"


def tail_bound(h: torch.Tensor, tw, canvas: bool) -> tuple[float, str]:
    """Bound of a tail at 1080p: h read once (bf16, or int8 in qh8), the 4K
    frame written once (u8, or bf16 canvas); per core coarse pixel, up1
    (9C x 4C multiply-adds), up2 (four 2x pixels of 9C x 4C) and the output
    conv (16 fine pixels of k*k*C x 3), each at the tensor-core rate of its
    operands' type (up1 int8 only in qh8)."""
    c = tw.cin
    k2 = tw.w3.numel() // 3 // c                 # the output conv's k*k
    px = HEIGHT * WIDTH
    n_bytes = h.numel() * h.element_size() + 16 * px * 3 * (2 if canvas
                                                            else 1)
    up1, rest = 2 * px * 36 * c * c, 2 * px * (144 * c * c + 48 * k2 * c)
    return bound(n_bytes, [
        (up1, INT8_OP_S if tw.qh8 else BF16_FLOP_S),
        (rest, INT8_OP_S if tw.q8 else BF16_FLOP_S)])


def k3_bound(x: torch.Tensor, blocks) -> tuple[float, str]:
    """Bound of the body's K3 launches per frame: each block reads x and
    its weights once and writes its output once; C*E + 9E + E*C
    multiply-adds per pixel in bf16."""
    px, c = x.numel() // x.shape[-1], x.shape[-1]
    n_bytes, ops = 0, 0
    for w in blocks:
        weights = [w.we, w.be, w.wd, w.bd, w.wp, w.bp]
        n_bytes += 2 * x.numel() * x.element_size() + sum(
            t.numel() * t.element_size() for t in weights if t is not None)
        e = w.e_dim
        ops += 2 * px * ((c * e if w.has_expand else 0) + 9 * e + e * c)
    return bound(n_bytes, [(ops, BF16_FLOP_S)])


def flax_tree(model: torch.nn.Module, draw: Callable):
    """Flax-layout (params, batch_stats) trees for `model`, each leaf drawn
    by draw(path, leaf, shape), conv kernels in HWIO."""
    params, stats = {}, {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        shape = tuple(t.shape)
        if leaf == "weight":
            # a ConvTranspose weight is (in, out, kh, kw) (io/params.py)
            if path[-1].startswith("ConvTranspose"):
                i, o, kh, kw = shape
            else:
                o, i, kh, kw = shape
            leaf, shape = "kernel", (kh, kw, i, o)
        a = draw(path, leaf, shape)
        tree = stats if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        tree[leaf] = np.asarray(a, np.float32)
    return params, stats


def seeded_flax_tree(model: torch.nn.Module, rng: np.random.Generator,
                     body_gain: float = 1.0, out_gain: float = 0.5):
    """Flax-layout trees for `model` from numpy: LeCun-normal kernels,
    small biases, BN statistics near identity, PReLU slopes in [0.05, 0.3].
    Body kernels after the stem are scaled by body_gain, and the output
    conv by out_gain, so that tanh stays out of saturation and the frame is
    not flat."""
    def draw(path, leaf, shape):
        if leaf == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:3]))
            if path[-1] == "out_conv":
                a *= out_gain
            elif path[0] == "body" and path[-1] != "Conv_0":
                a *= body_gain
            return a
        if leaf == "alpha":
            return rng.uniform(0.05, 0.3, shape)
        if leaf == "scale":
            return rng.uniform(0.8, 1.2, shape)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape)
        return rng.standard_normal(shape) * 0.05    # conv/BN bias, BN mean

    return flax_tree(model, draw)


def jax_init_tree(model: torch.nn.Module, rng: np.random.Generator,
                  family: str):
    """Flax-layout trees for `model` drawn with numpy from the JAX
    package's own initialisers (denoise_gan_tpu/models/layers.py,
    srgan.py), the weights that tools/exp_q8_exact.py scores: FSRGAN
    kernels glorot-uniform; SRGAN kernels N(0, 0.02) and BN scales
    N(1, 0.02); every other BN scale and variance 1; biases, BN means and
    PReLU slopes 0."""
    def draw(path, leaf, shape):
        if leaf == "kernel":
            if family == "srgan":
                return rng.standard_normal(shape) * 0.02
            kh, kw, i, o = shape
            limit = np.sqrt(6.0 / ((i + o) * kh * kw))
            return rng.uniform(-limit, limit, shape)
        if leaf == "scale" and family == "srgan":
            return 1.0 + rng.standard_normal(shape) * 0.02
        return np.ones(shape) if leaf in ("scale", "var") else np.zeros(shape)

    return flax_tree(model, draw)


def seeded_frame(rng: np.random.Generator, height: int, width: int,
                 device) -> torch.Tensor:
    """A video-like (H, W, 3) frame in [0, 1]: smooth colour waves plus
    sensor noise."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32) / 97.0
    phase = rng.uniform(0, 2 * np.pi, 3)
    f = 0.5 + 0.35 * np.sin(yy[..., None] * (1 + phase / 7)
                            + xx[..., None] * (0.7 + phase / 5) + phase)
    f += 0.04 * rng.standard_normal((height, width, 3))
    return torch.from_numpy(np.clip(f, 0, 1).astype(np.float32)).to(device)


def structured_frame(height: int, width: int) -> np.ndarray:
    """High-contrast structured frame: smooth gradients, saturated blocks
    and a hard edge (tools/exp_q8_exact.py:32-44)."""
    y = np.linspace(0, 1, height, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, width, dtype=np.float32)[None, :]
    r = y * np.ones_like(x)
    g = np.ones_like(y) * x
    b = 0.5 + 0.5 * np.sin(12.0 * np.pi * (x + y))
    im = np.stack([r, g, b], axis=-1)
    im[: height // 4, : width // 4] = 1.0            # saturated white block
    im[-height // 4:, -width // 4:] = 0.0            # black block
    im[height // 2:, : width // 2, 0] = 1.0          # hard red edge
    return im.astype(np.float32)


def u8_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    d = (a.int() - b.int()).abs()
    return int(d.max()), float((d > 0).float().mean())


def check_bound(what: str, a: torch.Tensor, b: torch.Tensor,
                exact: bool = False, target: bool = False) -> int:
    """Kernel vs twin u8: within MAX_DIFF on < MAX_FRAC, and (exact) equal;
    with `target`, says whether they are equal."""
    dmax, frac = u8_diff(a, b)
    held = f", bit-identical target {'held' if not dmax else 'missed'}" \
        if target else ""
    print(f"  {what}: max |du8| {dmax}, bytes differing {frac:.3e}{held}")
    if dmax > MAX_DIFF or frac >= MAX_FRAC or (exact and dmax):
        raise AssertionError(f"{what}: kernel and twin disagree (max "
                             f"{dmax}, fraction {frac:.3e})")
    return dmax


def check_canvas(what: str, a: torch.Tensor, b: torch.Tensor,
                 target: bool) -> float:
    """Kernel vs twin canvas (bf16 tanh): within CANVAS_DIFF on < MAX_FRAC
    of the values (bf16 mode: < CANVAS_FRAC_BF16); with `target`, says
    whether they are equal."""
    d = (a.float() - b.float()).abs()
    dmax, frac = float(d.max()), float((d > 0).float().mean())
    held = f", bit-identical target {'held' if not dmax else 'missed'}" \
        if target else ""
    print(f"  {what}: max |d| {dmax:.3e}, values differing {frac:.3e}"
          f"{held}")
    if dmax > CANVAS_DIFF or frac >= (MAX_FRAC if target
                                      else CANVAS_FRAC_BF16):
        raise AssertionError(f"{what}: kernel and twin disagree (max "
                             f"{dmax:.3e}, fraction {frac:.3e})")
    return dmax


def timed_once(fn: Callable[[], torch.Tensor]) -> tuple[torch.Tensor, float]:
    """(fn(), its ms) by CUDA events around one run, no warm-up: for plain
    versions that run for seconds."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def engine_fps(run, frames, n: int) -> float:
    """Frames/s of run over n frames alternating, host clock, after
    two warm-up frames; ends in a synchronize."""
    for f in frames:
        run(f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        run(frames[i % len(frames)])
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def seeded_model(fam: Family, rng, dev):
    model = build_generator(fam.name, device=dev)
    return from_jax_params(model, *seeded_flax_tree(
        model, rng, fam.body_gain, fam.out_gain))


def kernel_vs_twin(label: str, fam: Family, model, dev):
    """Phase 3/3b: the family's kernel vs its twins on seeded h at the
    1080p main-path shapes, both epilogues, every mode.  Returns (the
    tails' input by mode, grid, tail weights by mode, max error by launch
    key)."""
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = (torch.randn((ny * nx, cr + 4, tail_ops.T, fam.cin), generator=gen,
                     device=dev) * 0.5).to(torch.bfloat16)
    tails = {"bf16": fam.prepare(model.tail),
             "w8a8": fam.prepare(model.tail, q8_calib=h[:16]),
             "qh8": fam.prepare(model.tail, q8_calib=h[:16], qh8=True)}
    inputs = {m: tail_ops.quantize_h(h, tw) if tw.qh8 else h
              for m, tw in tails.items()}
    print(f"phase {label} {fam.kernel.__name__} and {fam.canvas.__name__} "
          f"vs twins: h {tuple(h.shape)} bf16 (qh8: int8), grid {ny}x{nx}, "
          f"core_rows {cr}")
    errs = {}
    for mode, tw in tails.items():
        for bgr in (False, True):
            args = (inputs[mode], tw, ny, nx, HEIGHT, WIDTH, bgr)
            got = fam.kernel(*args)
            torch.cuda.synchronize()
            want = fam.twin(*args)
            torch.cuda.synchronize()
            assert got.shape == (4 * HEIGHT, 4 * WIDTH, 3)
            key = fam.key(fam.kernel, mode)
            errs[key] = max(errs.get(key, 0), check_bound(
                f"u8 {mode} {'bgr' if bgr else 'rgb'}", got, want,
                exact=mode == "w8a8", target=mode == "qh8"))
        args = (inputs[mode], tw, ny, nx, HEIGHT, WIDTH)
        got = fam.canvas(*args)
        torch.cuda.synchronize()
        want = fam.canvas_twin(*args)
        torch.cuda.synchronize()
        assert got.shape == (4 * HEIGHT, 4 * WIDTH, 3) and \
            got.dtype == torch.bfloat16
        errs[fam.key(fam.canvas, mode)] = check_canvas(
            f"canvas {mode}", got, want, target=mode != "bf16")
    return inputs, (ny, nx, cr), tails, errs


def build_report(fam: Family) -> None:
    """Phase 3/3b: the family's kernel build, per instantiation: its SASS
    product counts, ptxas registers and spills, shared memory and blocks an
    SM; fails where a mode runs none of its tensor-core products."""
    sass = tail_ops.sass_counts(fam.kernel_name)
    ptxas = tail_ops.ptxas_report(fam.kernel_name)
    for mode in MODES:
        for canvas in (False, True):
            key = (mode, canvas)
            smem, blocks = tail_ops.occupancy(fam.occupancy, mode, canvas)
            print(f"  {fam.kernel_name}<{mode}, "
                  f"{'canvas' if canvas else 'u8'}>: SASS {sass.get(key)}, "
                  f"ptxas {ptxas.get(key)}, shared memory {smem} bytes, "
                  f"{blocks} blocks an SM")
            if not all(sass.get(key, {}).get(op)
                       for op in fam.products[mode]):
                raise AssertionError(
                    f"{fam.kernel_name}<{mode}> runs no "
                    f"{'/'.join(fam.products[mode])}: {sass.get(key)}")
    check_params(fam)


def check_params(fam: Family) -> None:
    """Phase 3/3b: the parameters the family's kernel reports, by mode,
    against the Python side's: w8a8's up1 margin and its tensor-core part
    equal to ops/tail.py::up1_err(9 x channels), no margin in qh8 (exact)
    nor in K1's bf16 (up1 in the twin's order), a measured one in K2's
    bf16; K1's block and chunk geometry equal to ops/tail.py's BLOCK and
    CHUNK, which the index-map tests use."""
    twin, mma = tail_ops.up1_err(9 * fam.cin)
    want = {"w8a8": (float(np.float32(twin) + np.float32(mma)), mma),
            "qh8": (0.0, 0.0)}
    if fam.cin == tail_ops.CIN:
        want["bf16"] = (0.0, 0.0)
    geom = (*tail_ops.BLOCK, tail_ops.CHUNK) if fam.cin == tail_ops.CIN \
        else None
    for mode in MODES:
        err, err_mma, got_geom = tail_ops.kernel_params(fam.params, mode)
        print(f"  {fam.kernel_name}<{mode}> parameters: up1 margin "
              f"{err:.4e} |x| |w| (tensor-core part {err_mma:.4e}), block "
              f"{got_geom[0]}x{got_geom[1]}, chunk {got_geom[2]}")
        if mode in want and (err, err_mma) != want[mode]:
            raise AssertionError(f"{fam.kernel_name}<{mode}>'s up1 margin "
                                 f"{(err, err_mma)} is not ops/tail.py's "
                                 f"{want[mode]}")
        if mode not in want and not err > 0:
            raise AssertionError(f"{fam.kernel_name}<{mode}> has no margin")
        if geom and got_geom != geom:
            raise AssertionError(f"{fam.kernel_name}'s geometry {got_geom} "
                                 f"is not ops/tail.py's {geom}")


def bit_identical(what: str, fam: Family, h: torch.Tensor, tw) -> None:
    """The family's kernel, u8 and canvas, against its twin on h and tw at
    1080p: equal, or the run fails."""
    ny, nx, _ = ke.plan_grid(HEIGHT, WIDTH, 27)
    for kernel, twin in ((fam.kernel, fam.twin),
                         (fam.canvas, fam.canvas_twin)):
        args = (h, tw, ny, nx, HEIGHT, WIDTH)
        got = kernel(*args)
        torch.cuda.synchronize()
        same, d_max = same_bits(got.float(), twin(*args).float())
        print(f"  {kernel.__name__} {tw.mode} on the {what} input: "
              f"{'bit-identical' if same else f'max |d| {d_max}'}")
        if not same:
            raise AssertionError(f"{kernel.__name__} {tw.mode} differs from "
                                 f"its twin on the {what} input")


def one_sign_case(fam: Family, model, dev, qh8: bool = False):
    """The one-sign input at 1080p: (h, tail weights): the seeded tail
    through one_sign_up1_, h from one_sign_h, the int8 scales calibrated on
    h's first 16 tiles; qh8's h through quantize_h."""
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    gen = torch.Generator().manual_seed(SEED)
    tail = tail_ops.one_sign_up1_(copy.deepcopy(model.tail))
    h = tail_ops.one_sign_h((ny * nx, cr + 4, tail_ops.T, fam.cin), gen, dev)
    tw = fam.prepare(tail, q8_calib=h[:16], qh8=qh8)
    return (tail_ops.quantize_h(h, tw) if qh8 else h), tw


def one_sign_checks(fam: Family, model, dev) -> None:
    """Phase 3/3b: w8a8 and qh8, u8 and canvas, bit-identical to the twin
    on the one-sign input at 1080p."""
    for qh8 in (False, True):
        bit_identical("one-sign", fam, *one_sign_case(fam, model, dev, qh8))


def exact_sums(fam: Family, model, dev) -> None:
    """Phase 3/3b: the family's kernel in w8a8 on the exact-sum input at
    1080p (ops/tail_srgan.py::dyadic_up1_ on a copy of the seeded tail,
    dyadic_h), u8 and canvas, bit-identical to the twin."""
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    gen = torch.Generator().manual_seed(SEED)
    tail = tail_srgan.dyadic_up1_(copy.deepcopy(model.tail), gen)
    h = tail_srgan.dyadic_h((ny * nx, cr + 4, tail_ops.T, fam.cin), gen, dev)
    bit_identical("exact-sum", fam, h, fam.prepare(tail, q8_calib=h[:16]))


def up1_sum_errors(dev) -> None:
    """Phase 3b: f32 sums of K bf16 products, by mma.sync (K8's chained
    product; K = 288 zero-padded to 320) and one at a time in the twin's
    order, against the exact sum, relative to |x| |w|, at each K of
    SUM_KS: the twin's order must stay within the twin's part of up1_err(K)
    (proven: a failure here is a fault of the check), mma.sync within a
    tenth of the tensor-core part that the kernel of depth K reports, and
    at K = 576 the two together below K2's measured bf16 margin."""
    rng = np.random.default_rng(SEED)
    for k, fam_name in SUM_KS.items():
        fam = next(f for f in FAMILIES if f.name == fam_name)
        twin_err = tail_ops.up1_err(k)[0]
        err, mma_err, _ = tail_ops.kernel_params(fam.params, "w8a8")
        bf16_err = tail_ops.kernel_params(fam.params, "bf16")[0]
        kp = -(-k // 64) * 64
        for name, one_sign in (("both signs", False), ("one sign", True)):
            x, w = relayout.seeded_operands(2048, k, 128, "canonical", dev,
                                            rng)
            if one_sign:
                x, w = x.abs(), w.abs()
            xp = torch.nn.functional.pad(x, (0, kp - k)).contiguous()
            wp = torch.nn.functional.pad(w, (0, 0, 0, kp - k)).contiguous()
            _, tc = relayout.matmul_form(xp, wp, "canonical", 1)
            seq = torch.zeros_like(tc)
            xf, wf = x.float(), w.float()
            for i in range(k):
                seq.addcmul_(xf[:, i:i + 1], wf[i:i + 1])
            exact = x.double() @ w.double()
            norm = x.double().norm(dim=1, keepdim=True) * \
                w.double().norm(dim=0, keepdim=True)
            e_tc, e_seq = (float(((v.double() - exact).abs() / norm).max())
                           for v in (tc, seq))
            print(f"  up1 sums of {k} bf16 products, {name}: mma.sync "
                  f"{e_tc:.3e} ({mma_err / e_tc:.1f}x below its part "
                  f"{mma_err:.3e}), the twin's order {e_seq:.3e} "
                  f"({twin_err / e_seq:.1f}x below its part "
                  f"{twin_err:.3e}) of |x| |w|; {fam.kernel_name}'s w8a8 "
                  f"ERR {err:.3e}"
                  + (f", bf16 margin {bf16_err:.3e} "
                     f"({bf16_err / (e_tc + e_seq):.2f}x their sum)"
                     if bf16_err else ""))
            if e_seq > twin_err or 10 * e_tc >= mma_err or \
                    (bf16_err and e_tc + e_seq >= bf16_err):
                raise AssertionError(f"f32 sum errors of {k} products "
                                     f"({name}) reach {fam.kernel_name}'s "
                                     "up1 margin")


def mbconv_sum_errors(dev) -> None:
    """Phase 3b for K3: f32 sums of K bf16 products at K3's depths, K = 32
    (the expand) and K = mbconv.E_MAX (the project), by chained mma.sync
    (K8's product; K = 32 zero-padded to 64) and in the plain one-at-a-time
    order, against the exact sum, relative to |x| |w|: mma.sync must stay
    within a tenth of the tensor core's allowance that K3 reports at that
    depth, the plain order within gamma_{K-1} (proven)."""
    rng = np.random.default_rng(SEED + 3)
    err, _ = mbconv.kernel_params()
    allowance = {mbconv.C: err[1], mbconv.E_MAX: err[2]}
    for k, mma_err in allowance.items():
        kp = -(-k // 64) * 64
        plain_err = mbconv.sum_err(k)
        for name, one_sign in (("both signs", False), ("one sign", True)):
            x, w = relayout.seeded_operands(2048, k, 128, "canonical", dev,
                                            rng)
            if one_sign:
                x, w = x.abs(), w.abs()
            xp = torch.nn.functional.pad(x, (0, kp - k)).contiguous()
            wq = torch.nn.functional.pad(w, (0, 0, 0, kp - k)).contiguous()
            _, tc = relayout.matmul_form(xp, wq, "canonical", 1)
            seq = torch.zeros_like(tc)
            xf, wf = x.float(), w.float()
            for i in range(k):
                seq.addcmul_(xf[:, i:i + 1], wf[i:i + 1])
            exact = x.double() @ w.double()
            norm = x.double().norm(dim=1, keepdim=True) * \
                w.double().norm(dim=0, keepdim=True)
            e_tc, e_seq = (float(((v.double() - exact).abs() / norm).max())
                           for v in (tc, seq))
            print(f"  K3 sums of {k} bf16 products, {name}: mma.sync "
                  f"{e_tc:.3e} ({mma_err / e_tc:.1f}x below K3's allowance "
                  f"{mma_err:.3e}), the plain order {e_seq:.3e} "
                  f"({plain_err / e_seq:.1f}x below gamma_{k - 1} "
                  f"{plain_err:.3e}) of |x| |w|")
            if e_seq > plain_err or 10 * e_tc >= mma_err:
                raise AssertionError(f"f32 sum errors of {k} products "
                                     f"({name}) reach K3's margin parts")


def uncertain_share(fam: Family, h: torch.Tensor, tw, err: float) -> float:
    """The share of up1's values on h (SHARE_TILES tiles) whose rounding
    (int8 step in w8a8, bf16 in bf16) the margin err * |x| |w| leaves
    uncertain: the kernels' own test (ops/tail.py::up1_certain) on the
    twin's sums (a conv with TF32 off), |x| and |w| rounded up as the
    kernels round them."""
    w1 = tw.conv_weights()[0]
    with tail_ops._exact_f32(), torch.no_grad():
        x = h[:SHARE_TILES].float().permute(0, 3, 1, 2)
        z = tail_ops._conv(x, w1) + tw.b1.view(1, -1, 1, 1)
        xerr = tail_ops._conv(x * x, torch.ones_like(w1[:1])).sqrt() * \
            (err * (1 + 2.0 ** -10))
    wn = w1.flatten(1).norm(dim=1).view(1, -1, 1, 1) * (1 + 2.0 ** -10)
    a = tw.a1.repeat(4).view(1, -1, 1, 1)
    sure = tail_ops.up1_certain(z, a.expand_as(z), xerr.expand_as(z),
                                wn.expand_as(z), tw.inv_su1, tw.q8)
    return float(1.0 - sure.float().mean())


def margin_shares(fam: Family, model, inputs, tails, dev) -> None:
    """Phase 3/3b (printed): uncertain_share of the family's up1 with the
    margin its kernel reports, on the seeded input (w8a8; K2 also bf16)
    and the one-sign input (w8a8)."""
    modes = ("w8a8", "bf16") if fam.cin == tail_srgan.CIN else ("w8a8",)
    cases = [("seeded", m, inputs[m], tails[m]) for m in modes]
    cases.append(("one-sign", "w8a8", *one_sign_case(fam, model, dev)))
    for what, mode, h, tw in cases:
        err = tail_ops.kernel_params(fam.params, mode)[0]
        print(f"  {fam.kernel_name} up1 values left uncertain, {what} "
              f"{mode}, {SHARE_TILES} tiles: "
              f"{uncertain_share(fam, h, tw, err):.4%} with margin "
              f"{err:.3e}")


def exactly_rounded_up1(fam: Family, inputs, grid, tails) -> None:
    """Phase 3b (printed): the twin's frame with up1 summed in float64 and
    rounded once against the twin's own, w8a8 u8 and bf16 canvas: how far
    an order other than the twin's moves the frame."""
    ny, nx, _ = grid

    def exact(x, w1):
        return torch.nn.functional.conv2d(x.double(), w1.double(),
                                          padding=1).float()

    for mode, twin, diff in (("w8a8", fam.twin, u8_diff),
                             ("bf16", fam.canvas_twin, None)):
        args = (inputs[mode], tails[mode], ny, nx, HEIGHT, WIDTH)
        want = twin(*args)
        summed, tail_ops._up1_sum = tail_ops._up1_sum, exact
        try:
            got = twin(*args)
        finally:
            tail_ops._up1_sum = summed
        if diff:
            d_max, frac = diff(got, want)
        else:
            d = (got.float() - want.float()).abs()
            d_max, frac = float(d.max()), float((d > 0).float().mean())
        print(f"  {twin.__name__}:{mode} with up1 exactly rounded vs in the "
              f"twin's order: max {d_max:.4g}, differing {frac:.3e}")


def k3_vs_plain(model, dev):
    """Phase 3c: K3's reported parameters against ops/mbconv.py's; K3 vs
    its plain version at the 1080p body shape, on the seeded model's block
    0 (no expand) and block 1 (expand), on the seeded input and on the
    one-sign input, bit for bit; the shares of d and y values the kernel
    repaired.  Returns (x, the six blocks' weights, max |error|: 0)."""
    err, geom = mbconv.kernel_params()
    want = (mbconv.margin_parts(),
            (*mbconv.BLOCK, mbconv.E_CHUNK, mbconv.THREADS))
    print(f"phase 3c fused_mbconv parameters: margin parts {err}, unit "
          f"{geom[0]}x{geom[1]}, chunk {geom[2]}, {geom[3]} threads")
    if (err, geom) != want:
        raise AssertionError(f"K3 reports {(err, geom)}, ops/mbconv.py "
                             f"holds {want}")
    ny, nx, cr = ke.plan_grid(HEIGHT, WIDTH, 27)
    body = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH)[0]
    blocks = mbconv.build_mbconv_fsrgan_body(body).blocks
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shape = (ny * nx, cr + 4, tail_ops.T, mbconv.C)
    x = (torch.randn(shape, generator=gen, device=dev) * 0.5).to(
        torch.bfloat16)
    ring = float((blocks[1].be > 0).float().mean())
    print(f"phase 3c fused_mbconv vs plain: x {tuple(x.shape)} bf16, "
          f"be > 0 on {ring:.2f} of block 1's channels")
    if ring == 0:
        raise AssertionError("seeded be <= 0: the ring is not exercised")
    one_x = mbconv.one_sign_x(shape, torch.Generator().manual_seed(SEED), dev)
    max_err = 0.0
    for what, xi in (("seeded", x), ("one-sign", one_x)):
        for i in (0, 1):
            w = blocks[i] if what == "seeded" else \
                mbconv.one_sign_block(blocks[i], xi)
            got = mbconv.fused_mbconv(xi, w)
            torch.cuda.synchronize()
            want_y = mbconv.fused_mbconv_reference(xi, w)
            torch.cuda.synchronize()
            same, d_max = same_bits(got.float(), want_y.float())
            counted, n_d, n_y, _ = mbconv.fused_mbconv_counted(xi, w)
            n = xi.numel() // mbconv.C
            print(f"  block {i} ({'expand' if w.has_expand else 'no expand'}"
                  f"), {what} input: "
                  f"{'bit-identical' if same else f'max |d| {d_max:.3e}'}; "
                  f"repaired d {n_d / (n * w.e_dim):.4%}, y "
                  f"{n_y / (n * mbconv.C):.4%}")
            if not (same and torch.equal(counted, got)):
                raise AssertionError(f"K3 block {i} differs from its plain "
                                     f"version on the {what} input")
            max_err = max(max_err, d_max)
    return x, blocks, max_err


def same_bits(a: torch.Tensor, b: torch.Tensor) -> tuple[bool, float]:
    """(whether a and b are equal, NaN where the other is NaN, and max
    |a - b| over the elements that are finite in both)."""
    nan = torch.isnan(a)
    same = torch.equal(nan, torch.isnan(b)) and \
        torch.equal(a.masked_fill(nan, 0), b.masked_fill(nan, 0))
    fin = torch.isfinite(a) & torch.isfinite(b)
    d = (a[fin] - b[fin]).abs()
    return same, float(d.max()) if d.numel() else 0.0


def k9_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K9: the FMA and roll + FMA kernels bit-identical to their
    plain versions at the JAX probe's shape and iterations.  Returns max
    |error| by kernel."""
    x0 = fma_peak.seeded_input(dev)
    errs = {}
    for fn, plain, iters in (
            (fma_peak.fma_chain, fma_peak.fma_chain_reference, fma_peak.ITERS),
            (fma_peak.roll_fma_chain, fma_peak.roll_fma_chain_reference,
             fma_peak.ITERS // 2)):
        got = fn(x0, iters)
        torch.cuda.synchronize()
        want = plain(x0, iters)
        same, d = same_bits(got, want)
        print(f"  {fn.__name__} {tuple(x0.shape)} x {iters}: bit-identical "
              f"{'held' if same else 'missed'} (max |d| {d:.3e}, max |plain| "
              f"{float(want.abs().max()):.3e})")
        if not same or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{fn.__name__} disagrees with its plain "
                                 "version")
        errs[fn.__name__] = d
    return errs


def bf16_steps(y, w, steps: int) -> tuple[float, float]:
    """K6 bf16 from (y, w), step by step: each kernel step from the
    kernel's previous state against the plain version's step from the same
    state, within int8_chain.bf16_step_bound, rows >= 128 kept; then one
    launch of all the steps equal to them.  Returns (max |d|, the largest
    ratio of a difference to its bound)."""
    got, max_d, ratio = y, 0.0, 0.0
    for _ in range(steps):
        prev = got
        got = int8_chain.dot_chain_steps(prev, w, 1)
        want = int8_chain.dot_chain_steps_reference(prev, w, 1)
        torch.cuda.synchronize()
        d = (got.double() - want.double()).abs()
        bound = int8_chain.bf16_step_bound(prev, w, want).clamp_min(1e-300)
        max_d = max(max_d, float(d.max()))
        ratio = max(ratio, float((d[:int8_chain.NOUT] / bound).max()))
        if not bool(torch.isfinite(got).all()) or ratio > 1 or \
                not torch.equal(got[int8_chain.NOUT:], y[int8_chain.NOUT:]):
            raise AssertionError(f"K6 bf16 step disagrees with its plain "
                                 f"version (ratio to bound {ratio:.3f})")
    if not torch.equal(int8_chain.dot_chain_steps(y, w, steps), got):
        raise AssertionError(f"K6 bf16: one launch of {steps} steps differs "
                             "from its steps")
    return max_d, ratio


def k6_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K6: at each K, from the probe's initial state at the JAX
    shape (K, 3840): int8 after ITERS steps bit-identical to the float64
    plain version; bf16 for BF16_STEPS steps by bf16_steps, and the two
    chains' divergence after them (printed).  From random states: int8
    after RANDOM_STEPS steps bit-identical, bf16 by bf16_steps.  Returns max
    |error| by kernel line name."""
    errs = {}
    steps = int8_chain.ITERS
    for k in int8_chain.KS:
        got = int8_chain.dot_chain(k, steps, torch.int8, device=dev)
        torch.cuda.synchronize()
        want = int8_chain.dot_chain_reference(k, steps, torch.int8,
                                              device=dev)
        y, w = int8_chain.random_state(k, torch.int8, device=dev,
                                        seed=SEED + k)
        r_got = int8_chain.dot_chain_steps(y, w, RANDOM_STEPS)
        torch.cuda.synchronize()
        r_want = int8_chain.dot_chain_steps_reference(y, w, RANDOM_STEPS)
        top = r_got[:int8_chain.NOUT]
        print(f"  dot_chain int8 K={k} (K, {int8_chain.M}): {steps} steps "
              f"bit-identical {'held' if torch.equal(got, want) else 'missed'}"
              f" (rows 0..127: {int(got[:int8_chain.NOUT].unique().numel())} "
              f"distinct values); random state, {RANDOM_STEPS} steps: "
              f"{'held' if torch.equal(r_got, r_want) else 'missed'} "
              f"({int(top.unique().numel())} distinct values, "
              f"{float((top.abs() == 127).float().mean()):.3f} at +-127)")
        if not (torch.equal(got, want) and torch.equal(r_got, r_want)):
            raise AssertionError(f"K6 int8 K={k} differs from its plain "
                                 "version")
        errs[f"dot_chain:int8:K={k}"] = 0.0
        y, w = int8_chain.initial_state(k, torch.bfloat16, device=dev)
        d, ratio = bf16_steps(y, w, BF16_STEPS)
        free = int8_chain.dot_chain(k, BF16_STEPS, torch.bfloat16, device=dev)
        ref = int8_chain.dot_chain_reference(k, BF16_STEPS, torch.bfloat16,
                                             device=dev)
        torch.cuda.synchronize()
        scale = float(ref.double().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        dfree = float((free.double() - ref.double()).abs().max())
        r_d, r_ratio = bf16_steps(
            *int8_chain.random_state(k, torch.bfloat16, device=dev,
                                     seed=SEED + k), BF16_STEPS)
        print(f"  dot_chain bf16 K={k}: steps 1-{BF16_STEPS} within "
              f"bf16_step_bound (max |d| {d:.3e}, {ratio:.3f} of the bound; "
              f"random state {r_ratio:.3f}); the two chains after "
              f"{BF16_STEPS} steps (printed only): max |d| {dfree:.3e} = "
              f"{dfree / ulp:.2f} bf16 ulps of max |plain| {scale:.3e}")
        errs[f"dot_chain:bf16:K={k}"] = max(d, r_d)
    return errs


def k8_bound(m: int, k: int, n: int, reps: int) -> tuple[float, str]:
    """K8's product: x and w read once (bf16), y (f32) and acc written
    once; 2 * M * K * N * reps operations at the bf16 tensor-core peak."""
    n_bytes = 2 * (m * k + k * n) + 4 * (m * n + 1)
    return bound(n_bytes, [(relayout.ops(m, k, n, reps), BF16_FLOP_S)])


def k8_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K8: the product kernel's instruction counts by cuobjdump
    (printed), then each form at each JAX shape with the probe's 64 reps
    within relayout.product_bound of its plain version per element and
    acc within relayout.acc_bound; the transpose chain at (1536, 128) x 8
    bit-identical.  Returns max |error| by kernels-line name."""
    for form, c in relayout.sass_counts().items():
        print(f"  matmul_form_kernel<{form}> SASS: {c['LDSM']} LDSM "
              f"({c['LDSM.16.MT88']} of them .trans), {c['HMMA']} HMMA")
    errs = {}
    for m, k, n in relayout.SHAPES:
        for form in relayout.FORMS:
            x, w = relayout.seeded_operands(m, k, n, form, dev)
            acc, y = relayout.matmul_form(x, w, form)
            torch.cuda.synchronize()
            want_acc, want = relayout.matmul_form_reference(x, w, form)
            yb = relayout.product_bound(x, w, form)
            d = (y.double() - want.double()).abs()
            ratio = float((d / yb.clamp_min(1e-300)).max())
            da = abs(float(acc) - float(want_acc))
            ab = relayout.acc_bound(yb, want_acc, relayout.REPS)
            b_ms, b_by = k8_bound(m, k, n, relayout.REPS)
            print(f"  matmul_form {form} {m}x{k}x{n} x {relayout.REPS}: max "
                  f"|dy| {float(d.max()):.3e} = {ratio:.4f} of the f32-order "
                  f"bound (max {float(yb.max()):.3e}); acc {float(acc)!r} vs "
                  f"{float(want_acc)!r}, |d| {da:.3e} of {ab:.3e}; bound "
                  f"{b_ms * 1e3:.2f} us ({b_by})")
            if not (bool(torch.isfinite(y).all()) and ratio <= 1 and
                    da <= ab):
                raise AssertionError(f"matmul_form {form} {m}x{k}x{n} "
                                     "disagrees with its plain version")
            errs[f"matmul_form:{form}:{m}x{k}x{n}"] = max(float(d.max()), da)
    x = relayout.seeded_block(dev)
    got = relayout.transpose_chain(x)
    torch.cuda.synchronize()
    same, d = same_bits(got, relayout.transpose_chain_reference(x))
    print(f"  transpose_chain {tuple(x.shape)} x {relayout.TK_ITERS}: "
          f"bit-identical {'held' if same else 'missed'} (max |d| {d:.3e})")
    if not same:
        raise AssertionError("transpose_chain disagrees with its plain "
                             "version")
    errs["transpose_chain"] = d
    return errs


def k10_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K10: the u8 store bit-identical to its plain version at
    the JAX probe's (1024, 48) and at a 4K frame's (518400, 48).  Returns
    max |error| (u8 levels) by kernels-line name."""
    d_max = 0
    for res in (u8_store.seeded_input(dev), u8_store.frame_input(dev, SEED)):
        got = u8_store.u8_phase_store(res)
        torch.cuda.synchronize()
        want = u8_store.u8_phase_store_reference(res)
        d = (got.int() - want.int()).abs()
        same = torch.equal(got, want)
        print(f"  u8_phase_store {tuple(res.shape)} -> {tuple(got.shape)}: "
              f"bit-identical {'held' if same else 'missed'} (max "
              f"{int(d.max())}, {float((d > 0).float().mean()):.2e} of the "
              f"bytes differ; {int(got.unique().numel())} distinct values)")
        if not same:
            raise AssertionError("u8_phase_store disagrees with its plain "
                                 "version")
        d_max = max(d_max, int(d.max()))
    return {"u8_phase_store": float(d_max)}


def k7_vs_plain(dev) -> tuple[dict[str, float], dict[str, float]]:
    """Phase 3d, K7: the kernel's loops in SASS by cuobjdump (printed; the
    loop of mode both must hold HMMA and SHFL); modes mxu and both for
    K7_STEPS single steps, each from the kernel's previous state, y's
    columns 0..127 within overlap.step_bound of the plain version's step,
    columns 128.. unchanged and z bit-identical, then one launch of the
    K7_STEPS steps equal to them; each mode at the JAX counts, z
    bit-identical to the plain version (timed once) and y's unchanging part
    kept.  Returns (max |error| by kernels-line name, the plain versions'
    ms at the JAX counts)."""
    loops = overlap.sass_loop_counts()
    if not loops:
        raise AssertionError("cuobjdump read no overlap_kernel from the "
                             "built library")
    for key, found in loops.items():
        print(f"  overlap_kernel<{key}> SASS loops with HMMA or SHFL: "
              + "; ".join(", ".join(f"{k} {v}" for k, v in c.items())
                          for c in found))
    if not any(c["HMMA"] and c["SHFL"]
                         for c in loops.get("both", [])):
        raise AssertionError("overlap_kernel<both> has no loop holding "
                             "both HMMA and SHFL")
    y0, z0, w = overlap.initial_state(dev)
    errs, plain_ms = {}, {}
    for mi, vi in ((1, 0), (1, 1)):
        name = f"overlap_chain:{overlap.mode(mi, vi)}"
        y, z, ratio, dmax = y0, z0, 0.0, 0.0
        for _ in range(K7_STEPS):
            gy, gz, _ = overlap.overlap_chain(y, z, w, mi, vi)
            torch.cuda.synchronize()
            wy, wz, _ = overlap.overlap_chain_reference(y, z, w, mi, vi)
            d = (gy[:, :overlap.ROWS].double()
                 - wy[:, :overlap.ROWS].double()).abs()
            b = overlap.step_bound(y, w, wy).clamp_min(1e-300)
            ratio = max(ratio, float((d / b).max()))
            dmax = max(dmax, float(d.max()))
            if not (bool(torch.isfinite(gy).all()) and ratio <= 1 and
                    torch.equal(gy[:, overlap.ROWS:], y0[:, overlap.ROWS:])
                    and torch.equal(gz, wz)):
                raise AssertionError(f"{name} step disagrees with its plain "
                                     f"version (ratio to bound {ratio:.3f})")
            y, z = gy, gz
        one = overlap.overlap_chain(y0, z0, w, K7_STEPS * mi, K7_STEPS * vi)
        if not (torch.equal(one[0], y) and torch.equal(one[1], z)):
            raise AssertionError(f"{name}: one launch of {K7_STEPS} steps "
                                 "differs from its steps")
        print(f"  {name} steps 1-{K7_STEPS}: y within step_bound (max |d| "
              f"{dmax:.3e}, {ratio:.3f} of the bound), z bit-identical; one "
              f"launch equal to the steps")
        errs[name] = dmax
    for mi, vi in ((overlap.MXU_ITERS, 0), (0, overlap.VPU_ITERS),
                   (overlap.MXU_ITERS, overlap.VPU_ITERS)):
        name = f"overlap_chain:{overlap.mode(mi, vi)}"
        gy, gz, _ = overlap.overlap_chain(y0, z0, w, mi, vi)
        (wy, wz, _), plain_ms[name] = timed_once(
            lambda: overlap.overlap_chain_reference(y0, z0, w, mi, vi))
        same, dz = same_bits(gz, wz)
        kept = torch.equal(gy[:, overlap.ROWS:], y0[:, overlap.ROWS:]) \
            and (bool(mi) or torch.equal(gy, y0))
        nan = float(torch.isnan(gy[:, :overlap.ROWS].float()).float().mean())
        print(f"  {name} ({mi}, {vi}): z bit-identical "
              f"{'held' if same else 'missed'} (max |d| {dz:.3e}); y "
              f"columns 128.. kept {'held' if kept else 'missed'}; "
              f"{nan:.3f} of y[:, 0:128] NaN (plain "
              f"{float(torch.isnan(wy[:, :overlap.ROWS].float()).float().mean()):.3f})")
        if not (same and kept):
            raise AssertionError(f"{name} at ({mi}, {vi}) disagrees with its "
                                 "plain version")
        errs[name] = max(errs.get(name, 0.0), dz)
    return errs, plain_ms


def k4_vs_plain(dev) -> tuple[dict[str, float], dict[str, float]]:
    """Phase 3d, K4: every form at the JAX shape bit-identical (e and d) to
    its plain version at K4_REPS reps and at dw_forms.REPS; chunked differs
    from scratch after one rep exactly at columns 0 and 127 of every output
    chunk.  The plain version has two functions, the flat rolls of scratch,
    value and planes and chunked's rolls within a chunk, each run (and
    timed) once at dw_forms.REPS for the forms that share it.  Returns (max
    |error| by kernels-line name, the plain versions' ms at dw_forms.REPS)."""
    e, w = dw_forms.initial_state(dev)
    errs, plain_ms, first, plain = {}, {}, {}, {}
    for form in dw_forms.FORMS:
        name = f"dw_chain:{form}"
        fn = "chunked" if form == "chunked" else "flat"
        for reps in K4_REPS + (dw_forms.REPS,):
            ge, gd = dw_forms.dw_chain(e, w, reps, form)
            torch.cuda.synchronize()
            if (fn, reps) not in plain:
                plain[fn, reps] = timed_once(
                    lambda: dw_forms.dw_chain_reference(e, w, reps, form))
            (we, wd), p_ms = plain[fn, reps]
            same = torch.equal(ge, we) and torch.equal(gd, wd)
            d = float((gd - wd).abs().max())
            if reps == 1:
                first[form] = gd
            print(f"  {name} ({e.shape[0]}, {dw_forms.MB}) x {reps}: "
                  f"bit-identical {'held' if same else 'missed'} (max |d| "
                  f"{d:.3e}, max |plain| {float(wd.abs().max()):.3e})")
            if not same:
                raise AssertionError(f"{name} x {reps} disagrees with its "
                                     "plain version")
            errs[name] = max(errs.get(name, 0.0), d)
        plain_ms[name] = p_ms
    diff = (first["chunked"] != first["scratch"]).reshape(
        e.shape[0], -1, dw_forms.CHUNK)
    cols = torch.nonzero(diff.any(0).any(0)).flatten().tolist()
    print(f"  chunked vs scratch after one rep: differ at chunk columns "
          f"{cols}, on {float(diff[..., [0, -1]].float().mean()):.3f} of "
          f"those")
    if cols != [0, dw_forms.CHUNK - 1]:
        raise AssertionError("chunked differs from scratch elsewhere than "
                             "at its chunks' edge columns")
    return errs, plain_ms


def k5_vs_plain(dev) -> dict[str, float]:
    """Phase 3d, K5: in every mode at the JAX shape, from the probe's
    initial state, a launch of K5_REPS steps held by mbpipe.check (its
    launch count must go up by one; its last step against the plain
    version's pieces from the kernel's own bands one step earlier: E and p
    within their tensor-core bounds, D and the new bands bit-identical);
    then the same at 2 steps on one band per SM, every band also equal to
    that band alone.  Returns max |error| of E and p by kernels-line
    name."""
    st = mbpipe.initial_state(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    errs = {}
    for chains, sync in mbpipe.MODES:
        name = mbpipe.mode_key(chains, sync)
        for reps, bands in [(n, 1) for n in K5_REPS] + [(2, sms)]:
            state = st if bands == 1 else mbpipe.band_state(st, bands)
            r = mbpipe.check(state, reps, chains, sync)
            same = r.get("bands_equal", True)
            print(f"  {name} x {reps} on {bands} band(s): launches "
                  f"{r['launches']}; E {r['e_err']:.3e} ({r['e_ratio']:.3f} "
                  f"of its bound), p {r['p_err']:.3e} ({r['p_ratio']:.3f}); "
                  f"D bit-identical {'held' if r['d_equal'] else 'missed'}, "
                  f"r {'held' if r['r_equal'] else 'missed'}"
                  + ("" if bands == 1 else ", every band equal to that band "
                     f"alone {'held' if same else 'missed'}"))
            if not (r["launches"] == 1 and r["d_equal"] and r["r_equal"] and
                    r["e_ratio"] <= 1 and r["p_ratio"] <= 1 and same):
                raise AssertionError(f"{name} x {reps} on {bands} band(s) "
                                     "disagrees with its plain version")
            errs[name] = max(errs.get(name, 0.0), r["e_err"], r["p_err"])
    return errs


def k3_main_path(model, frames):
    """Phase 4c: the K3-body engine as a user builds it, on MAIN_FRAMES
    alternating frames, counts zeroed just before and read just after; then
    against the plain-body engine and the plain-K3 engine on the same
    weights and tail.  Returns (launches, K3 engine, plain-body engine)."""
    body, tw, brc = ke.prepare_mbconv_fsrgan_engine(
        model, HEIGHT, WIDTH, q8_calib_frame=frames[0])
    engine = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc)
    reset_counts()
    outs = [engine(frames[i % 2]) for i in range(MAIN_FRAMES)]
    torch.cuda.synchronize()
    launches = fired()
    print(f"phase 4c fsrgan engine, K3 body: {MAIN_FRAMES} frames "
          f"{HEIGHT}x{WIDTH} -> {tuple(outs[0].shape)} {outs[0].dtype} on "
          f"{outs[0].device}; launches {launches}")
    want = {"fused_mbconv": 6 * MAIN_FRAMES,
            "fused_tail_u8:w8a8": MAIN_FRAMES}
    if launches != want:
        raise AssertionError("the K3-body engine did not run K3 6 times and "
                             f"K1 once per frame, and nothing else: {launches}")
    check_frames(outs)
    plain = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH, brc)[0]
    p_eng = ke.build_kernel_engine(plain, tw, HEIGHT, WIDTH, brc=brc)
    r_eng = ke.build_kernel_engine(
        mbconv.build_mbconv_fsrgan_body(plain, mbconv.fused_mbconv_reference),
        tw, HEIGHT, WIDTH, brc=brc)

    def f32_body(tiles):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return model.body(tiles.float()).to(torch.bfloat16)

    f_eng = ke.build_kernel_engine(f32_body, tw, HEIGHT, WIDTH, brc=brc)
    p_out, r_out, f_out = (e(frames[1]) for e in (p_eng, r_eng, f_eng))
    torch.cuda.synchronize()
    shares = {}
    for name, a, b in (("K3-body engine vs plain-body engine", outs[1], p_out),
                       ("K3-body engine vs f32-body engine", outs[1], f_out),
                       ("plain-body engine vs f32-body engine", p_out, f_out)):
        d = (a.int() - b.int()).abs()
        shares[name] = (float((d > 0).float().mean()),
                        float((d > 1).float().mean()))
        print(f"  {name} (w8a8, same tail): max |du8| {int(d.max())}, > 0 on "
              f"{shares[name][0]:.3e}, > 1 on {shares[name][1]:.3e}")
    k3_f32 = shares["K3-body engine vs f32-body engine"]
    plain_f32 = shares["plain-body engine vs f32-body engine"]
    if k3_f32[0] > plain_f32[0] or k3_f32[1] > plain_f32[1]:
        raise AssertionError("the K3-body engine is farther from the f32-body "
                             "engine than the plain-body engine is")
    check_bound("K3-body engine vs plain-K3-body engine", outs[1], r_out,
                exact=True)
    return launches, engine, p_eng


def k3_times(model, frames, x, blocks, k_eng, p_eng):
    """Phase 5 for K3: (kernel ms, plain ms) per frame of six blocks, the
    six plain InvertedResidual modules on cuDNN, and both engines' fps."""
    reps = 10
    k_ms = card.cuda_ms(lambda: [mbconv.fused_mbconv(x, w) for w in blocks],
                        reps)
    p_ms = card.cuda_ms(lambda: [mbconv.fused_mbconv_reference(x, w)
                            for w in blocks], 1)
    body = ke.prepare_fsrgan_engine(model, HEIGHT, WIDTH)[0]
    xc = x.permute(0, 3, 1, 2)
    mods = [getattr(body, f"InvertedResidual_{i}") for i in range(len(blocks))]
    with torch.inference_mode():
        lib_ms = card.cuda_ms(lambda: [m(xc) for m in mods], reps)
    sass = tail_ops.sass_counts("mbconv_kernel")
    ptxas = tail_ops.ptxas_report("mbconv_kernel")
    for expand in (False, True):
        smem, per_sm = mbconv.occupancy(expand)
        for check in (False, True):
            key = (expand, check)
            print(f"  mbconv_kernel<{'expand' if expand else 'no expand'}"
                  f"{', check form' if check else ''}>: SASS {sass.get(key)},"
                  f" ptxas {ptxas.get(key)}"
                  + ("" if check else f", shared memory {smem} bytes, "
                     f"{per_sm} blocks an SM"))
            if not sass.get(key, {}).get("HMMA"):
                raise AssertionError(f"mbconv_kernel<{expand}, {check}> runs "
                                     f"no HMMA: {sass.get(key)}")
    for i in (0, 1):
        _, n_d, n_y, cycles = mbconv.fused_mbconv_counted(x, blocks[i])
        tc = sum(v for k, v in cycles.items() if k.startswith("tc"))
        dw = sum(v for k, v in cycles.items() if k.startswith("dw"))
        print(f"  K3 block {i} phases (clock64 cycles of each role's first "
              "thread, share of its total): " + ", ".join(
                  f"{k} {v / (tc if k.startswith('tc') else dw):.1%}"
                  for k, v in cycles.items()))
    b_ms, b_by = k3_bound(x, blocks)
    print(f"  K3, {len(blocks)} launches at x {tuple(x.shape)}: kernel "
          f"{k_ms:.2f} ms/frame, plain version {p_ms:.2f}, plain "
          f"InvertedResidual modules (bf16, cuDNN) {lib_ms:.2f}, bound "
          f"{b_ms:.3f} ({b_by})")
    fps_k = engine_fps(k_eng, frames, TIMED_FRAMES)
    fps_p = engine_fps(p_eng, frames, TIMED_FRAMES)
    print(f"  fsrgan engine 1080p->4K w8a8: K3 body {fps_k:.2f} frames/s, "
          f"plain body {fps_p:.2f} frames/s")
    return k_ms, p_ms, lib_ms, b_ms, b_by


def check_frames(outs) -> None:
    """Engine outputs: shape, dtype, device, not flat, deterministic."""
    for out in outs:
        if out.shape != (4 * HEIGHT, 4 * WIDTH, 3) or \
                out.dtype != torch.uint8 or out.device.type != "cuda":
            raise AssertionError(f"bad engine output {tuple(out.shape)} "
                                 f"{out.dtype} {out.device}")
    std = outs[1].float().std(dim=(0, 1))
    print(f"  per-channel std {[round(float(s), 2) for s in std]} "
          f"(floor {STD_FLOOR}), mean "
          f"{[round(float(m), 2) for m in outs[1].float().mean(dim=(0, 1))]}")
    if float(std.min()) <= STD_FLOOR:
        raise AssertionError("engine output is flat")
    if u8_diff(outs[0], outs[2]) != (0, 0.0):
        raise AssertionError("same frame, different output")


def drive(what: str, engine, frames, n: int, want: dict[str, int]):
    """One main path: `engine` on n alternating frames, every launch count
    zeroed just before and read just after; the counts must be `want`.
    Returns (the outputs, the launch counts read)."""
    reset_counts()
    outs = [engine(frames[i % 2]) for i in range(n)]
    torch.cuda.synchronize()
    launches = fired()
    print(f"  {what}: {n} frames {HEIGHT}x{WIDTH} -> {tuple(outs[0].shape)} "
          f"{outs[0].dtype} on {outs[0].device}; launches {launches}")
    if launches != want:
        raise AssertionError(f"{what} did not launch {want} and nothing "
                             f"else: {launches}")
    return outs, launches


def main_paths(label: str, fam: Family, model, frames) -> dict[str, int]:
    """Phase 4/4b: the family's engine, as a user builds it, in each mode
    and epilogue; every launch count is zeroed just before each run and
    read just after.  Returns the launches by key."""
    print(f"phase {label} {fam.name} engine, main paths:")
    calib = dict(q8_calib_frame=frames[0])
    launches, outs = {}, {}
    for mode, kw in (("w8a8", calib), ("qh8", dict(calib, qh8=True)),
                     ("bf16", {})):
        key = fam.key(fam.kernel, mode)
        engine = fam.build(model, HEIGHT, WIDTH, **kw)
        outs[mode], counted = drive(f"{mode} u8 engine", engine, frames,
                                   MAIN_FRAMES, {key: MAIN_FRAMES})
        check_frames(outs[mode])
        launches[key] = counted[key]
    d = (outs["qh8"][1].int() - outs["w8a8"][1].int()).abs()
    print(f"  qh8 vs w8a8 engine (reported here; the JAX package's qh8 "
          f"envelope, max 2, > 1 on < 5e-3, is asserted in phase 4d on the "
          f"JAX package's initialisation): max |du8| {int(d.max())}, > 0 on "
          f"{float((d > 0).float().mean()):.3e}, > 1 on "
          f"{float((d > 1).float().mean()):.3e}")
    key = fam.key(fam.canvas, "w8a8")
    engine = fam.build(model, HEIGHT, WIDTH, out_uint8=False, **calib)
    (f32,), counted = drive("w8a8 float-output engine (canvas)", engine,
                           frames[1:], 1, {key: 1})
    launches[key] = counted[key]
    lo, hi = float(f32.min()), float(f32.max())
    print(f"  float output {tuple(f32.shape)} {f32.dtype} in [{lo:.4f}, "
          f"{hi:.4f}]")
    if f32.shape != (4 * HEIGHT, 4 * WIDTH, 3) or \
            f32.dtype != torch.float32 or lo < 0 or hi > 1:
        raise AssertionError("bad float-output engine frame")
    check_bound("float engine's trunc(x*255 + 0.5) vs u8 engine",
                (f32 * 255.0 + 0.5).to(torch.uint8), outs["w8a8"][1])
    return launches


def engine_pair(fam: Family, model, frames, qh8: bool = False):
    """The engine (w8a8, or qh8) with the kernel tail and with the twin
    tail, on one calibration; the two agree within the kernel-vs-twin
    bound (w8a8: bit-identical; qh8: the target)."""
    body, tw, brc = fam.prepare_engine(model, HEIGHT, WIDTH,
                                       q8_calib_frame=frames[0], qh8=qh8)
    k_eng = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc,
                                   tail_fn=fam.kernel)
    t_eng = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc,
                                   tail_fn=fam.twin)
    k_out, t_out = k_eng(frames[1]), t_eng(frames[1])
    torch.cuda.synchronize()
    err = check_bound(f"{tw.mode} engine, kernel vs twin tail", k_out, t_out,
                      exact=not qh8, target=qh8)
    return body, k_eng, t_eng, err


def check_input_options(fam: Family, model, frames) -> None:
    """u8_input and bgr_input on the card, on frames[1] as uint8.
    u8: the u8_input + bgr_input engine on the uint8 BGR frame equals, byte
    for byte, the bgr_input engine on the same frame as float (u8 / 255,
    divided on the host: CUDA divides by a scalar as a multiply by its
    reciprocal), both w8a8 calibrated on frames[0]: the u8 levels normalise
    to the bf16 values the float path rounds them to, so the tiles are
    equal and all that follows.  BGR: the u8 BGR engine against the float
    RGB engine, within the whole-slice envelopes of
    tests/test_torch_engine_srgan.py (bf16 max <= 1 on < 5%; w8a8 max <= 3,
    > 1 on < 1%): the flipped stem sums its input channels in another order
    and the body carries the differences on."""
    frame_u8 = (frames[1] * 255 + 0.5).to(torch.uint8)
    bgr_u8 = frame_u8.flip(-1).contiguous()
    levels = torch.from_numpy(np.arange(256, dtype=np.float32)
                              / np.float32(255)).to(frame_u8.device)
    rgb01, bgr01 = levels[frame_u8.long()], levels[bgr_u8.long()]

    def run(frame, **kw):
        return fam.build(model, HEIGHT, WIDTH, **kw)(frame)

    q8 = dict(q8_calib_frame=frames[0])
    u8 = {"w8a8": run(bgr_u8, u8_input=True, bgr_input=True, **q8),
          "bf16": run(bgr_u8, u8_input=True, bgr_input=True)}
    f32 = run(bgr01, bgr_input=True, **q8)
    rgb = {"w8a8": run(rgb01, **q8), "bf16": run(rgb01)}
    torch.cuda.synchronize()
    dmax, frac = u8_diff(u8["w8a8"], f32)
    print(f"  u8 BGR input engine vs float BGR input engine (w8a8): max "
          f"|du8| {dmax}, bytes differing {frac:.3e}")
    if dmax:
        raise AssertionError("u8 input engine differs from the float one")
    for mode, (max_d, over, max_frac) in (("bf16", (1, 0, 0.05)),
                                          ("w8a8", (3, 1, 0.01))):
        d = (u8[mode].int() - rgb[mode].int()).abs()
        dmax, frac0 = int(d.max()), float((d > 0).float().mean())
        frac1 = float((d > 1).float().mean())
        print(f"  {mode} u8 BGR input engine vs float RGB engine: max |du8| "
              f"{dmax}, > 0 on {frac0:.3e}, > 1 on {frac1:.3e}")
        if dmax > max_d or float((d > over).float().mean()) >= max_frac:
            raise AssertionError(f"{mode} u8 BGR input engine disagrees "
                                 "with the float RGB engine")


def check_plain_tail(model, rng, dev, height: int = 135,
                     width: int = 240) -> None:
    """Small input: the bf16 kernel tail vs the plain f32 FSRGANTail module
    (TF32 off) on the same bf16 body output, per tile and crop-stitched,
    with the JAX package's envelope for this comparison
    (tests/test_pallas_tail.py: max <= 3, > 1 on < 1%)."""
    frame = seeded_frame(rng, height, width, dev)
    body, tw, brc = ke.prepare_fsrgan_engine(model, height, width)
    ny, nx, cr = ke.plan_grid(height, width, brc)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        h = body(ke._tiles(frame, ny, nx, cr)).contiguous()
        got = tail_ops.fused_tail_u8(h, tw, ny, nx, height, width)
        fine = model.tail(h.float())
    core = fine[:, 8:8 + 4 * cr, 8:8 + 4 * tail_ops.CORE]
    core = core.reshape(ny, nx, 4 * cr, 4 * tail_ops.CORE, 3)
    core = core.permute(0, 2, 1, 3, 4).reshape(ny * 4 * cr, -1, 3)
    want = (((core[:4 * height, :4 * width] + 1) / 2).clamp(0, 1) * 255
            + 0.5).to(torch.uint8)
    d = (got.int() - want.int()).abs()
    dmax, frac = int(d.max()), float((d > 1).float().mean())
    print(f"  bf16 kernel tail vs plain f32 tail at {height}x{width}: "
          f"max |du8| {dmax}, > 1 on {frac:.3e}")
    if dmax > 3 or frac >= 0.01:
        raise AssertionError("kernel tail disagrees with the plain tail")


@torch.inference_mode()
def exact_frame(fam: Family, model, frame01: torch.Tensor) -> torch.Tensor:
    """Phase 4d's exact oracle: the plain bf16 generator on the whole frame,
    edge-padded at the bottom and right to a multiple of 8 rows and 128
    columns (infer/engine.py:170-176, 204-209), then clip((y+1)/2, 0, 1)
    and trunc(x*255 + 0.5) as uint8, cropped to (4H, 4W, 3)."""
    height, width = frame01.shape[:2]
    dev = frame01.device
    gen = build_generator(fam.name, dtype=torch.bfloat16, device=dev)
    gen.load_state_dict(model.state_dict())
    rows = torch.arange(-(-height // 8) * 8, device=dev).clamp(max=height - 1)
    cols = torch.arange(-(-width // 128) * 128,
                        device=dev).clamp(max=width - 1)
    x = (frame01 * 2.0 - 1.0).index_select(0, rows).index_select(1, cols)
    y = gen(x[None])[0, :4 * height, :4 * width].float()
    return (((y + 1.0) / 2.0).clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def interior(height: int, width: int, cr: int) -> torch.Tensor:
    """(4H, 4W) mask of the fine pixels whose coarse pixel lies at least
    INTERIOR from a tile seam (every cr rows, every CORE columns) and from
    the frame border."""
    def far(n, period):
        i = torch.arange(n)
        k = i % period
        return torch.minimum(torch.minimum(k, period - 1 - k),
                             torch.minimum(i, n - 1 - i)) >= INTERIOR

    m = far(height, cr)[:, None] & far(width, tail_ops.CORE)[None, :]
    return m.repeat_interleave(4, 0).repeat_interleave(4, 1)


def quality_rule(fam: Family, model, height: int, width: int, dev,
                 weights: str, holds: bool) -> None:
    """Phase 4d for one family and one weight set: every engine mode against
    the exact whole-frame output on the noise and the structured frame (the
    int8 modes calibrated on the noise frame), over the whole frame and its
    interior; prints the rule of tools/exp_q8_exact.py and the qh8 engine
    against the w8a8 engine, and asserts the bf16 engine on the interior,
    and with `holds` the rule and the qh8 envelope (see the module
    docstring)."""
    rng = np.random.default_rng(SEED)
    noise_u8 = rng.integers(0, 256, (height, width, 3), dtype=np.uint8)
    noise = torch.from_numpy(noise_u8.astype(np.float32)
                             / np.float32(255.0)).to(dev)
    frames = {"noise": noise,
              "scene change": torch.from_numpy(
                  structured_frame(height, width)).to(dev)}
    brc = 27                        # every mode on the same grid
    inside = interior(height, width, ke.plan_grid(height, width, brc)[2])
    inside = inside.to(dev)
    calib = dict(q8_calib_frame=noise)

    def build(**kw):
        return fam.build(model, height, width, brc=brc, **kw)

    engines = {"bf16": build(), "w8a8": build(**calib),
               "qh8": build(qh8=True, **calib)}
    if fam.name == "fsrgan":
        body, tw, _ = ke.prepare_mbconv_fsrgan_engine(
            model, height, width, brc=brc, q8_calib_frame=noise)
        engines["K3-body w8a8"] = ke.build_kernel_engine(
            body, tw, height, width, brc=brc)
    rows, inner, outs = {}, {}, {}
    failed = []

    def score(label, got, exact):
        outs[label] = got
        d = (got.int() - exact.int()).abs()
        rows[label] = (int(d.max()), float((d > 0).float().mean()),
                       float((d > 1).float().mean()))
        di = d[inside]
        inner[label] = (int(di.max()), float((di > 1).float().mean()))
        print(f"  {fam.name} {weights} kernel[{label}] vs exact: "
              f"max={rows[label][0]} frac>0={rows[label][1]:.5f} "
              f"frac>1={rows[label][2]:.5f}; interior "
              f"({float(inside.float().mean()):.3f} of the frame) "
              f"max={inner[label][0]} frac>1={inner[label][1]:.5f}")

    for fname, frame in frames.items():
        exact = exact_frame(fam, model, frame)
        for mode, engine in engines.items():
            score(f"{mode} {fname}", engine(frame), exact)
        if fname == "noise":
            eng = build(u8_input=True, bgr_input=True, bgr=True, **calib)
            bgr_u8 = torch.from_numpy(
                np.ascontiguousarray(noise_u8[..., ::-1])).to(dev)
            score("u8q8-bgr noise", eng(bgr_u8), exact.flip(-1))
    for fname in frames:
        r = {m: rows[f"{m} {fname}"] for m in ("bf16", "w8a8", "qh8")}
        q = [rows[k] for k in rows if k.endswith(fname)
             and k.split()[0] in ("w8a8", "qh8", "u8q8-bgr")]
        w8_pp = 100 * (r["w8a8"][2] - r["bf16"][2])
        qh8_pp = 100 * (r["qh8"][2] - r["w8a8"][2])
        d = (outs[f"qh8 {fname}"].int() - outs[f"w8a8 {fname}"].int()).abs()
        dq, fq = int(d.max()), float((d > 1).float().mean())
        for what, ok in (
                (f"w8a8 frac>1 - bf16's = {w8_pp:+.3f} pp (<= 0.1)",
                 w8_pp <= 0.1),
                (f"qh8 frac>1 - w8a8's = {qh8_pp:+.3f} pp (<= 0.1)",
                 qh8_pp <= 0.1),
                (f"int8 modes' max {max(v[0] for v in q)} <= bf16's "
                 f"{r['bf16'][0]} + 2", all(v[0] <= r["bf16"][0] + 2
                                            for v in q)),
                (f"qh8 vs w8a8 engine max {dq} <= 2, > 1 on {fq:.2e} "
                 f"(< 5e-3)", dq <= 2 and fq < 5e-3)):
            print(f"  rule, {fam.name} {weights} {fname}: {what}: "
                  f"{'held' if ok else 'not held'}")
            if holds and not ok:
                failed.append(f"{fname}: {what}")
        b = inner[f"bf16 {fname}"]
        if b[0] > 2 or b[1] >= 1e-3:
            failed.append(f"{fname}: the bf16 engine is off the whole-frame "
                          f"output inside its tiles (max {b[0]}, > 1 on "
                          f"{b[1]:.3e})")
    if failed:
        raise AssertionError(f"{fam.name} {weights}: " + "; ".join(failed))


def times(fam: Family, model, frames, inputs, grid, tails, body,
          k_eng, t_eng) -> dict[str, tuple[float, float | None]]:
    """Phase 5 for one family; returns {launch key: (kernel ms, twin ms or
    None)} for each epilogue and mode."""
    ny, nx, cr = grid
    twin_reps = 1 if fam.cin > 32 else 3
    fps_k = engine_fps(k_eng, frames, TIMED_FRAMES)
    fps_t = engine_fps(t_eng, frames, twin_reps)
    q_eng = fam.build(model, HEIGHT, WIDTH, q8_calib_frame=frames[0],
                      qh8=True)
    fps_q = engine_fps(q_eng, frames, TIMED_FRAMES)
    print(f"  {fam.name} engine 1080p->4K: w8a8 kernel tail {fps_k:.2f} "
          f"frames/s, twin tail {fps_t:.2f} frames/s; qh8 kernel tail "
          f"{fps_q:.2f} frames/s")
    tiles = ke._tiles(frames[1], ny, nx, cr)
    with torch.inference_mode():
        body_ms = card.cuda_ms(lambda: body(tiles), 5)
    h = inputs["bf16"]
    q_ms = card.cuda_ms(lambda: tail_ops.quantize_h(h, tails["qh8"]), 10)
    print(f"  {fam.name} body (bf16, {ny * nx} tiles): {body_ms:.2f} "
          f"ms/frame; quantize_h (plain PyTorch): {q_ms:.2f} ms/frame")
    ms = {}
    for mode, tw in tails.items():
        args = (inputs[mode], tw, ny, nx, HEIGHT, WIDTH)
        for kernel, twin in ((fam.kernel, fam.twin),
                             (fam.canvas, fam.canvas_twin)):
            key = fam.key(kernel, mode)
            k_ms = card.cuda_ms(lambda: kernel(*args), 10)
            # the twins are slow; time those of the kernels line's entries
            t_ms = card.cuda_ms(lambda: twin(*args), twin_reps) \
                if kernel is fam.kernel or mode == "w8a8" else None
            ms[key] = (k_ms, t_ms)
            print(f"  {fam.name} tail {key}: kernel {k_ms:.2f} ms/frame"
                  + ("" if t_ms is None else f", twin {t_ms:.2f} ms/frame"))
    # The twin is built to be exact, not fast; the bf16 tail module on
    # cuDNN (per tile, without crop-stitch or u8) shows what a library tail
    # costs.
    cudnn_tail = fam.tail_cls(dtype=torch.bfloat16).to(h.device).eval()
    cudnn_tail.load_state_dict(model.tail.state_dict())
    with torch.inference_mode():
        cudnn_ms = card.cuda_ms(lambda: cudnn_tail(h), 3)
    print(f"  {fam.name} tail, bf16 {fam.tail_cls.__name__} module on cuDNN "
          f"(no crop, no u8): {cudnn_ms:.2f} ms/frame")
    return ms


def probe_times(dev, smi: str, errs: dict[str, float]) -> list[dict]:
    """Phase 5 for the probes: K9 at the JAX shape with the probe's and
    with LONG_ITERS iterations, and the roll chain on WIDE_ROWS rows (ms
    per launch over 32 chained launches, as the JAX probe's
    time_chained), its plain versions, and the FP32 peak from
    clocks.max.sm; cuBLAS at the JAX probe's matmul shapes; K6 per K
    and type (ITERS steps), its plain version, one step's product by
    torch.matmul / torch._int_mm, and the chain through them
    (library_ms).  Returns the kernels line's entries: K9 at LONG_ITERS,
    where the kernel's time is measured rather than the wrapper's, and
    K6; all with launches 0: no frame path runs the probes."""
    peak, sms, mhz = card.fp32_peak(dev)
    print(f"  FP32 peak {peak / 1e12:.2f} TF/s = {sms} SMs x "
          f"{card.FP32_LANES} lanes x 2 x {mhz:.0f} MHz (clocks.max.sm) "
          f"[{smi}]")
    x0 = fma_peak.seeded_input(dev)
    plain = {"fma_chain": fma_peak.fma_chain_reference,
             "roll_fma_chain": fma_peak.roll_fma_chain_reference}
    entries = []
    for r in fma_peak.measure(dev):
        n_bytes = 2 * 4 * r["shape"][0] * r["shape"][1]
        b_ms, b_by = bound(n_bytes, [(r["flops"], peak)])
        print(f"  {r['name']} {r['shape']} x {r['iters']}: "
              f"{r['ms']:.4f} ms, {r['tflops']:.2f} TF/s "
              f"({100 * r['tflops'] * 1e12 / peak:.1f}% of the FP32 peak), "
              f"bound {b_ms:.4f} ms ({b_by})")
        fn = plain[r["name"]]
        if not r["long"]:
            p_ms = card.time_chained(
                lambda x, fn=fn, n=r["iters"]: fn(x, n), x0, fma_peak.CHAINED)
            print(f"    plain version: {p_ms:.4f} ms (chained)")
        elif r["shape"] == fma_peak.SHAPE:
            kernel = getattr(fma_peak, r["name"])
            got = kernel(x0, r["iters"])
            want, p_ms = timed_once(lambda: fn(x0, r["iters"]))
            same, d = same_bits(got, want)
            print(f"    plain version: {p_ms:.2f} ms (one run); bit-identical "
                  f"{'held' if same else 'missed'}, "
                  f"{float(torch.isnan(want).float().mean()):.3f} NaN")
            if not same:
                raise AssertionError(f"{r['name']} x {r['iters']} disagrees "
                                     "with its plain version")
            entries.append({
                "name": r["name"], "route": "cuda",
                "source": "denoise_gan_tpu_torch/csrc/probe_fma.cu",
                "replaces": "tools/exp_vpu_peak.py:" + (
                    "39" if r["name"] == "fma_chain" else "49"),
                "launches": 0, "max_abs_err": max(errs[r["name"]], d),
                "ms": r["ms"], "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None})
    for r in fma_peak.matmul_yardsticks(dev):
        print(f"  torch.matmul form {r['form']} bf16 {r['m']}x{r['k']}x"
              f"{r['n']} (chained): {r['ms']:.4f} ms, {r['tflops']:.1f} TF/s")
    steps = int8_chain.ITERS
    by_k: dict[int, dict[str, float]] = {}
    for r in int8_chain.measure(dev):
        k, dtype = r["k"], r["dtype"]
        name = int8_chain.NAMES[dtype]
        y, w = int8_chain.initial_state(k, dtype, device=dev)
        p_ms = card.cuda_ms(
            lambda: int8_chain.dot_chain_steps_reference(y, w, steps), 1)
        n_bytes = (2 * y.numel() + w.numel()) * y.element_size()
        b_ms, b_by = bound(n_bytes, [(int8_chain.ops(k, steps),
                                      BF16_FLOP_S if name == "bf16"
                                      else INT8_OP_S)])
        lib, chain = r["library_step_ms"], r["library_chain_ms"]
        by_k.setdefault(k, {})[name] = r["ms"]
        print(f"  dot_chain {name} K={k} x {steps} steps: {r['ms']:.3f} ms, "
              f"{r['tops']:.1f} T/s, bound {b_ms:.3f} ms ({b_by}); plain "
              f"version {p_ms:.2f} ms; by "
              + ("torch.matmul" if name == "bf16" else "torch._int_mm")
              + (f": one step's product {lib:.4f} ms, the chain {chain:.2f} ms"
                 if lib is not None else ": refused"))
        if name == "int8" and lib is not None:
            same = torch.equal(int8_chain.library_chain(y, w, steps),
                               int8_chain.dot_chain_steps(y, w, steps))
            print(f"    the library chain bit-identical to the kernel's: "
                  f"{'held' if same else 'missed'} (printed only)")
        if len(by_k[k]) == 2:
            ratio = by_k[k]["bf16"] / by_k[k]["int8"]
            print(f"    i8/bf16 at K={k}: {ratio:.2f}x")
        entries.append({
            "name": f"dot_chain:{name}:K={k}", "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_mma.cu",
            "replaces": "tools/exp_int8_mosaic.py:" + (
                "33" if name == "bf16" else "50"),
            "launches": 0, "max_abs_err": errs[f"dot_chain:{name}:K={k}"],
            "ms": r["ms"], "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": chain})
    return entries


def k8_k10_times(dev, errs: dict[str, float]) -> list[dict]:
    """Phase 5 for K8 and K10: K8's product per form and JAX shape with the
    probe's 64 reps (the kernels line: ms, bound, the plain version and 64
    torch.matmul calls (library_ms), all at 64 reps) and with LONG_REPS
    (printed: ms, T/s, bound); the transpose chain with 8 iterations (the
    kernels line, as the product) and LONG_ITERS (printed), each with its
    bound and shared-memory floor (16 bytes an element an iteration at
    128 bytes/clock/SM); K10 at (1024, 48) and at the 4K frame's rows (the
    kernels line), its bound and its plain version.  Kernel and library
    times are queued behind a device sleep (card.queued_ms).  Returns the
    kernels line's entries, all with launches 0: no frame path runs the
    probes."""
    peak, sms, mhz = card.fp32_peak(dev)
    entries, long_ms = [], {}
    for r in relayout.measure(dev):
        long, reps = r["long"], r["reps"]
        if r["name"] == "transpose_chain":
            x = relayout.seeded_block(dev)
            n_el = x.numel()
            b_ms, b_by = bound(8 * n_el, [(n_el * reps, peak)])
            smem_ms = 16 * n_el * reps / (128 * sms * mhz * 1e6) * 1e3
            print(f"  transpose_chain {relayout.TK_SHAPE} x {reps} "
                  f"iterations: {r['ms']:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}), shared-memory floor {smem_ms:.4f} ms")
            if long:
                continue
            lib = card.queued_ms(
                lambda: relayout.library_transpose_chain(x, reps), 5)
            p_ms = card.cuda_ms(
                lambda: relayout.transpose_chain_reference(x, reps), 5)
            print(f"    x {reps}: plain version {p_ms:.4f} ms; by "
                  f".t().contiguous() and mul {lib:.4f} ms")
            entries.append({
                "name": "transpose_chain", "route": "cuda",
                "source": "denoise_gan_tpu_torch/csrc/probe_relayout.cu",
                "replaces": "tools/exp_relayout.py:119", "launches": 0,
                "max_abs_err": errs["transpose_chain"], "ms": r["ms"],
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib})
            continue
        (m, k, n), form = r["shape"], r["name"].split(":")[1]
        name = f"{r['name']}:{m}x{k}x{n}"
        b_ms, b_by = k8_bound(m, k, n, reps)
        print(f"  {name} x {reps} reps: {r['ms']:.4f} ms, {r['tops']:.1f} "
              f"T/s ({100 * r['tops'] * 1e12 / BF16_FLOP_S:.1f}% of the bf16 "
              f"peak), bound {b_ms:.4f} ms ({b_by})")
        if long:
            long_ms[name] = r["ms"]
            continue
        x, w = relayout.seeded_operands(m, k, n, form, dev)
        lib = card.queued_ms(
            lambda: relayout.library_products(x, w, form, reps), 5)
        p_ms = card.cuda_ms(
            lambda: relayout.matmul_form_reference(x, w, form, reps), 3)
        print(f"    x {reps}: plain version (float64) {p_ms:.3f} ms; "
              f"{reps} torch.matmul calls {lib:.4f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_relayout.cu",
            "replaces": "tools/exp_relayout.py:41", "launches": 0,
            "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
    ms = {e["name"]: e["ms"] for e in entries}
    for m, k, n in relayout.SHAPES:
        shape = f"{m}x{k}x{n}"
        for reps, by in ((relayout.REPS, ms), (relayout.LONG_REPS, long_ms)):
            ratio = by[f"matmul_form:sublane:{shape}"] \
                / by[f"matmul_form:canonical:{shape}"]
            print(f"    sublane / canonical at {shape} x {reps}: "
                  f"{ratio:.3f}")
    for r in u8_store.measure(dev):
        rows = r["rows"]
        res = u8_store.seeded_input(dev) if rows == u8_store.ROWS \
            else u8_store.frame_input(dev, SEED)
        b_ms, b_by = bound(u8_store.n_bytes(rows),
                           [(8 * res.numel(), peak)])
        p_ms = card.cuda_ms(lambda: u8_store.u8_phase_store_reference(res), 3)
        print(f"  u8_phase_store ({rows}, {u8_store.COLS}): {r['ms']:.4f} ms, "
              f"{r['gbs']:.0f} GB/s, bound {b_ms:.4f} ms ({b_by}); plain "
              f"version {p_ms:.4f} ms")
        if rows == u8_store.FRAME_4K_ROWS:
            entries.append({
                "name": "u8_phase_store", "route": "cuda",
                "source": "denoise_gan_tpu_torch/csrc/probe_u8.cu",
                "replaces": "tools/exp_u8_store.py:17", "launches": 0,
                "max_abs_err": errs["u8_phase_store"], "ms": r["ms"],
                "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
    return entries


def k7_k4_times(dev, errs: dict[str, float],
                plain_ms: dict[str, float]) -> list[dict]:
    """Phase 5 for K7 and K4.  K7: each mode's ms (CUDA events, the mean
    of overlap.TIMED launches) at the JAX counts and at equal counts
    overlap.EQUAL_ITERS, the JAX probe's comparison (its t(c) runs both
    chains 4000 times) and the one at equal counts with the overlap share;
    the chains through library calls at the JAX counts (library_ms); the
    bound per mode (the product's operations at the bf16 peak, the roll +
    FMA's at the FP32 peak, the larger of the two for both) and the roll's
    shuffle floor (one row's 15,360 shuffles an iteration on one SM at 32
    a clock).  K4: each form's ms per launch of dw_forms.REPS reps, us per
    band step against the bound (operations at the FP32 peak) and the
    shared-memory floor, scaled by the TPU geometry's 7119 band steps a
    frame, and the chain through F.conv2d(groups=192) with cuDNN's TF32
    off (library_ms).  Returns the kernels line's entries (the JAX counts;
    launches 0: no frame path runs the probes)."""
    peak, sms, mhz = card.fp32_peak(dev)
    entries = []
    ms = overlap.measure(dev)
    cmp = overlap.compare(ms)
    n = overlap.EQUAL_ITERS
    y0, z0, w = overlap.initial_state(dev)
    for mi, vi in ((overlap.MXU_ITERS, 0), (0, overlap.VPU_ITERS),
                   (overlap.MXU_ITERS, overlap.VPU_ITERS)):
        name = f"overlap_chain:{overlap.mode(mi, vi)}"
        mma_ops, fma_ops = overlap.ops(mi, vi)
        b_ms, b_by = max(bound(overlap.n_bytes(), [(mma_ops, BF16_FLOP_S)]),
                         bound(overlap.n_bytes(), [(fma_ops, peak)]))
        lib = card.cuda_ms(
            lambda: overlap.library_chain(y0, z0, w, mi, vi), 1)
        shuffle_ms = max(mi, vi) * overlap.M / 32 / (mhz * 1e3) if vi else 0
        print(f"  {name} ({mi}, {vi}): {ms[mi, vi]:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), shuffle floor {shuffle_ms:.3f} ms; "
              f"plain version {plain_ms[name]:.1f} ms; library calls "
              f"{lib:.2f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_overlap.cu",
            "replaces": "tools/exp_overlap_probe.py:32", "launches": 0,
            "max_abs_err": errs[name], "ms": ms[mi, vi],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib})
    print(f"    the JAX probe's comparison: sum {cmp['jax_sum']:.3f}, max "
          f"{cmp['jax_max']:.3f}, interleaved {cmp['jax_c']:.3f} ms")
    print(f"    equal counts n={n}: t(a) {ms[n, 0]:.3f}, t(b) {ms[0, n]:.3f}, "
          f"t(c) {cmp['c']:.3f} ms; sum {cmp['sum']:.3f}, max "
          f"{cmp['max']:.3f}; overlap share {cmp['share']:.3f} (t(c) is "
          f"set by the 8 SMs that run both chains)")
    reps = dw_forms.REPS
    times = dw_forms.measure(dev)
    lib = dw_forms.library_ms(dev)
    b_ms, b_by = bound(dw_forms.n_bytes(), [(dw_forms.ops(reps), peak)])
    for form in dw_forms.FORMS:
        name = f"dw_chain:{form}"
        us = times[form] / reps * 1e3
        floor = dw_forms.smem_floor_ms(form, sms, mhz) * 1e3
        print(f"  {name} x {reps}: {times[form]:.3f} ms, {us:.3f} us/band "
              f"step (x {dw_forms.FRAME_STEPS} band steps of the TPU "
              f"geometry: {us * dw_forms.FRAME_STEPS / 1e3:.2f} ms), bound "
              f"{b_ms / reps * 1e3:.3f} us ({b_by}), shared-memory floor "
              f"{floor:.3f} us; plain version {plain_ms[name]:.1f} ms; "
              f"F.conv2d chain (TF32 off) {lib[form]:.2f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_dw.cu",
            "replaces": "tools/exp_dw_forms.py:96", "launches": 0,
            "max_abs_err": errs[name], "ms": times[form],
            "plain_ms": plain_ms[name], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib[form]})
    return entries


def k5_times(dev, errs: dict[str, float]) -> list[dict]:
    """Phase 5 for K5, one band per SM from the initial state: each mode's
    ms per launch of mbpipe.REPS steps (CUDA events, the mean of
    mbpipe.TIMED launches; two readings, the modes in order and then in
    reverse), the SM clock, power and temperature read while it runs,
    us per band step over the card, the TPU geometry's frame (x
    FRAME_STEPS), the bound, the gain t1/t2 and aligned/offset; and at
    mbpipe.LINE_REPS steps (the kernels line) the
    kernel, the plain version and the same steps through torch.matmul,
    torch.roll and elementwise ops (library_ms, TF32 off), one run each.
    Returns the kernels line's entries (launches 0: no frame path runs
    the probes)."""
    peak, sms, _ = card.fp32_peak(dev)
    reps, line = mbpipe.REPS, mbpipe.LINE_REPS

    def k5_bound(steps: int, chains: int) -> tuple[float, str]:
        tc, cc = mbpipe.ops(steps, chains, sms)
        n_bytes = mbpipe.n_bytes(chains, sms)
        return max(bound(n_bytes, [(tc, BF16_FLOP_S)]),
                   bound(n_bytes, [(cc, peak)]))

    ms = mbpipe.measure(dev)
    smi = mbpipe.clocks(dev)
    st = mbpipe.band_state(mbpipe.initial_state(dev), sms)
    yard = mbpipe.yardstick_ms(dev)
    entries, per = [], {}
    for chains, sync in mbpipe.MODES:
        name = mbpipe.mode_key(chains, sync)
        mean = sum(ms[name]) / len(ms[name])
        per[name] = mbpipe.us_per_step(mean, reps, chains, sms)
        b_ms, b_by = k5_bound(reps, chains)
        k_ms = card.cuda_ms(lambda: mbpipe.mbpipe_chain(st, line, chains,
                                                        sync), mbpipe.TIMED)
        l_ms, l_by = k5_bound(line, chains)
        p_ms, lib = yard[f"plain:{chains}"], yard[f"library:{chains}"]
        print(f"  {name} x {reps} on {sms} bands: {mean:.3f} ms (readings "
              f"{', '.join(f'{m:.3f}' for m in ms[name])}; "
              f"{mbpipe.CLOCK_QUERY} {smi[name]}), "
              f"{per[name]:.4f} us/band step (x {mbpipe.FRAME_STEPS}: "
              f"{per[name] * mbpipe.FRAME_STEPS / 1e3:.3f} ms), bound "
              f"{mbpipe.us_per_step(b_ms, reps, chains, sms):.4f} us "
              f"({b_by}); x {line}: {k_ms:.3f} ms, bound {l_ms:.3f} ms, "
              f"plain version {p_ms:.1f} ms, library calls {lib:.2f} ms")
        entries.append({
            "name": name, "route": "cuda",
            "source": "denoise_gan_tpu_torch/csrc/probe_mbpipe.cu",
            "replaces": "tools/exp_mbpipe.py:40", "launches": 0,
            "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": l_ms, "bound_by": l_by, "library_ms": lib})
    one, two = mbpipe.mode_key(1), mbpipe.mode_key(2)
    aligned, offset = (per[mbpipe.mode_key(2, s)] for s in ("aligned",
                                                             "offset"))
    print(f"    gain t1/t2 {per[one] / per[two]:.3f}x; aligned/offset "
          f"{aligned / offset:.3f}x")
    return entries


def plain_tile_loop(model, frame01: torch.Tensor, tile: int,
                    overlap: int) -> torch.Tensor:
    """Check (b)'s reference for a 1x crop engine, written apart from
    infer/engine.py: the frame normalised and edge-padded (overlap/2 on
    top and left), each tile through the generator alone, its central
    (tile - overlap) square copied into place, then clip((y+1)/2) and
    trunc(x*255 + 0.5) as uint8 (x=1 gives 255), cropped."""
    height, width = frame01.shape[:2]
    dev = frame01.device
    stride, m0 = tile - overlap, overlap // 2
    ny, nx = -(-height // stride), -(-width // stride)
    rows = (torch.arange((ny - 1) * stride + tile, device=dev)
            - m0).clamp(0, height - 1)
    cols = (torch.arange((nx - 1) * stride + tile, device=dev)
            - m0).clamp(0, width - 1)
    x = (frame01 * 2.0 - 1.0)[rows][:, cols]
    out = torch.empty(ny * stride, nx * stride, 3, device=dev)
    with torch.inference_mode(), no_tf32():
        for i in range(ny):
            for j in range(nx):
                y = model(x[None, i * stride:i * stride + tile,
                            j * stride:j * stride + tile])[0]
                out[i * stride:(i + 1) * stride,
                    j * stride:(j + 1) * stride] = \
                    y[m0:m0 + stride, m0:m0 + stride]
    out01 = ((out + 1.0) / 2.0).clamp(0.0, 1.0)
    return (out01 * 255.0 + 0.5).clamp(max=255.0).to(
        torch.uint8)[:height, :width]


def check_bf16_envelope(what: str, a: torch.Tensor, b: torch.Tensor
                        ) -> None:
    """Check (b) in bf16: max |du8| <= 1 on < BF16_ENVELOPE of the bytes.
    cuDNN picks other conv algorithms for one tile than for the batch, and
    bf16 rounds every activation, so the two sums round apart and drift
    through the layers (f32 holds check_bound's 1e-3)."""
    dmax, frac = u8_diff(a, b)
    print(f"  {what}: max |du8| {dmax}, bytes differing {frac:.3e} (bf16 "
          f"envelope: max 1 on < {BF16_ENVELOPE})")
    if dmax > 1 or frac >= BF16_ENVELOPE:
        raise AssertionError(f"{what}: outside the bf16 envelope (max "
                             f"{dmax}, fraction {frac:.3e})")


def check_output(what: str, out: torch.Tensor, shape) -> None:
    """Check (c): an engine output is the (H*s, W*s, 3) uint8 frame on the
    card; prints its per-channel std."""
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.uint8 or \
            out.device.type != "cuda":
        raise AssertionError(f"{what}: bad output {tuple(out.shape)} "
                             f"{out.dtype} {out.device}")
    std = out.float().reshape(-1, 3).std(dim=0)
    print(f"    {what} output {tuple(out.shape)} uint8, per-channel std "
          f"{[round(float(v), 2) for v in std]}")


def generic_engine(fam: str, model, height: int, width: int, dt, **kw):
    """The engine the JAX video CLI builds for `fam`: the plain generator
    (compute dtype `dt`) per tile at scale 1, or build_fast_coarse's
    forward (`dt`) at its scale; u8 output, on the model's device."""
    dev = next(model.parameters()).device
    if fam in TILES_1X:
        gen = build_generator(fam, dtype=dt, device=dev)
        gen.load_state_dict(model.state_dict())
        tile, overlap = TILES_1X[fam]
        kw = dict(dict(tile=tile, overlap=overlap, stitch="crop"), **kw)
        return generic.build_frame_engine(gen, height, width, 1,
                                          out_uint8=True, device=dev, **kw)
    fwd, scale = build_fast_coarse(model, dtype=dt)
    kw = dict(dict(tile=TILE_4X[0], overlap=TILE_4X[1]), **kw)
    return generic.build_frame_engine(fwd, height, width, scale,
                                      out_uint8=True, device=dev, **kw)


def drive_generic(what: str, engine, frames, shape) -> list[torch.Tensor]:
    """One generic engine's path: every launch count zeroed just before,
    read just after; plain PyTorch must launch no hand kernel.  Check (c)
    on its outputs."""
    reset_counts()
    outs = [engine(frames[i % 2]) for i in range(2)]
    torch.cuda.synchronize()
    if fired():
        raise AssertionError(f"{what} launched hand kernels: {fired()}")
    check_output(what, outs[1], shape)
    return outs


def fps_and_peak(engine, frames) -> tuple[float, float]:
    """(frames/s over GENERIC_FRAMES alternating frames, host clock ending
    in a synchronize; torch.cuda.max_memory_allocated in GB over one more
    frame)."""
    fps = engine_fps(engine, frames, GENERIC_FRAMES)
    torch.cuda.reset_peak_memory_stats()
    engine(frames[0])
    torch.cuda.synchronize()
    return fps, torch.cuda.max_memory_allocated() / 1e9


def generic_engines(models: dict, frames, smi: str) -> None:
    """Phase 4e (see the module docstring)."""
    t0 = time.perf_counter()
    dev = frames[0].device
    rng = np.random.default_rng(SEED + 1)
    models = dict(models)
    for fam in ("autoencoder", "pix2pix"):
        model = build_generator(fam, device=dev)
        models[fam] = from_jax_params(model, *seeded_flax_tree(model, rng))
    model = build_generator("srgan", device=dev, scale=2)
    models["srgan2x"] = from_jax_params(model, *seeded_flax_tree(
        model, rng, SRGAN_BODY_GAIN, 1.0))
    print(f"phase 4e generic frame engine [{smi}]:")

    # (a) the same engine on the card and on the CPU, f32, TF32 off
    print("  (a) card vs CPU, f32, TF32 off:")
    for fam, key in (("autoencoder", "autoencoder"), ("pix2pix", "pix2pix"),
                     ("fsrgan", "fsrgan"), ("srgan", "srgan2x")):
        height, width = CUT[fam]
        frame = seeded_frame(rng, height, width, "cpu")
        model = models[key]
        cpu_model = copy.deepcopy(model).cpu()
        on_card = generic_engine(fam, model, height, width, torch.float32)(
            frame.to(dev))
        on_cpu = generic_engine(fam, cpu_model, height, width,
                                torch.float32)(frame)
        check_bound(f"{key} {height}x{width} card vs CPU", on_card.cpu(),
                    on_cpu)

    # (b), (c) the 1x crop engines at 1080p, against a per-tile loop
    for fam in ("autoencoder", "pix2pix"):
        tile, overlap = TILES_1X[fam]
        for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            what = f"{fam} crop {tile}/{overlap} {name}"
            engine = generic_engine(fam, models[fam], HEIGHT, WIDTH, dt)
            outs = drive_generic(what, engine, frames, (HEIGHT, WIDTH, 3))
            gen = build_generator(fam, dtype=dt, device=dev)
            gen.load_state_dict(models[fam].state_dict())
            loop = plain_tile_loop(gen, frames[1], tile, overlap)
            if dt == torch.float32:
                check_bound(f"{what} vs per-tile loop", outs[1], loop)
            else:
                check_bf16_envelope(f"{what} vs per-tile loop", outs[1],
                                    loop)
            fps, peak = fps_and_peak(engine, frames)
            print(f"    {what}: {fps:.2f} frames/s, peak {peak:.2f} GB")
            if fam != "autoencoder" or name != "bf16":
                continue
            bgr = generic_engine(fam, models[fam], HEIGHT, WIDTH, dt,
                                 bgr=True)
            out = drive_generic(f"{what} bgr", bgr, frames,
                                (HEIGHT, WIDTH, 3))[1]
            if not torch.equal(out, outs[1].flip(-1)):
                raise AssertionError("bgr output is not the RGB output "
                                     "flipped")
            fps, peak = fps_and_peak(bgr, frames)
            print(f"    {what} bgr: {fps:.2f} frames/s, peak {peak:.2f} GB")
            fpc = generic_engine(fam, models[fam], HEIGHT, WIDTH, dt,
                                 frames_per_call=2)
            pair = torch.stack(frames)
            out = drive_generic(f"{what} frames_per_call=2", fpc,
                                [pair, pair], (2, HEIGHT, WIDTH, 3))[1]
            for k in range(2):
                check_bound(f"{what} frames_per_call=2, frame {k}", out[k],
                            outs[k])
            fps, peak = fps_and_peak(fpc, [pair, pair])
            print(f"    {what} frames_per_call=2: {2 * fps:.2f} frames/s, "
                  f"peak {peak:.2f} GB")

    # the 4x engines through build_fast_coarse, bf16
    fine = (4 * HEIGHT, 4 * WIDTH, 3)
    outs4 = {}
    for label, kw in (("feather", {}), ("crop", dict(stitch="crop")),
                      ("whole", dict(tile=0))):
        what = f"fsrgan fast-coarse {label}" + (
            "" if label == "whole" else f" {TILE_4X[0]}/{TILE_4X[1]}")
        engine = generic_engine("fsrgan", models["fsrgan"], HEIGHT, WIDTH,
                                torch.bfloat16, **kw)
        outs4[label] = drive_generic(what, engine, frames, fine)[1]
        fps, peak = fps_and_peak(engine, frames)
        print(f"    {what} bf16: {fps:.2f} frames/s, peak {peak:.2f} GB")
    what = f"srgan 2x fast-coarse feather {TILE_4X[0]}/{TILE_4X[1]}"
    engine = generic_engine("srgan", models["srgan2x"], HEIGHT, WIDTH,
                            torch.bfloat16)
    drive_generic(what, engine, frames, (2 * HEIGHT, 2 * WIDTH, 3))
    fps, peak = fps_and_peak(engine, frames)
    print(f"    {what} bf16: {fps:.2f} frames/s, peak {peak:.2f} GB")

    # (d) FSRGAN whole frame against the tiled engines (printed)
    for label in ("feather", "crop"):
        d = (outs4["whole"].int() - outs4[label].int()).abs()
        print(f"  (d) fsrgan whole-frame vs {label}: max |du8| "
              f"{int(d.max())}, > 1 on {float((d > 1).float().mean()):.4%}"
              f", > 0 on {float((d > 0).float().mean()):.4%}")
    fam = FAMILIES[0]
    for mode, kw in (("w8a8", dict(q8_calib_frame=frames[0])),
                     ("bf16", {})):
        fps = engine_fps(fam.build(models["fsrgan"], HEIGHT, WIDTH, **kw),
                         frames, GENERIC_FRAMES)
        print(f"    beside it: fsrgan kernel engine {mode} (K1 tail) "
              f"{fps:.2f} frames/s")
    print(f"  phase 4e took {time.perf_counter() - t0:.1f} s")


def cli_frames(rng) -> list[np.ndarray]:
    """Phase 4f's video: BGR uint8 1080p frames, three of colour waves
    drifting right, then three of the structured frame (a scene
    change)."""
    wave = seeded_frame(rng, HEIGHT, WIDTH, "cpu").numpy()
    out = []
    for i in range(CLI_FRAMES):
        f = np.roll(wave, 8 * i, axis=1) if i < 3 else np.roll(
            structured_frame(HEIGHT, WIDTH), 8 * i, axis=0)
        out.append(np.ascontiguousarray(
            (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8)[..., ::-1]))
    return out


def rgb01(frame_bgr: np.ndarray, dev) -> torch.Tensor:
    """A BGR uint8 frame as RGB f32 [0, 1] on the card, divided on the
    host, as the CLI divides it."""
    return torch.from_numpy(frame_bgr[..., ::-1].astype(np.float32)
                            / 255.0).to(dev)


def run_cli(what: str, argv: list[str], want: dict[str, int]):
    """One video CLI run with every launch count zeroed just before and
    read just after: the counts must equal `want` (key: launches).
    Returns (result, the output's frames, BGR)."""
    reset_counts()
    t0 = time.perf_counter()
    result = video_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = fired()
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    reader = avi.VideoReader(argv[argv.index("--output_video") + 1])
    frames = [reader.read()[1] for _ in range(reader.frame_count)]
    reader.release()
    print(f"  {what}: {result['frames']} frames, {result['fps']:.2f} "
          f"frames/s by the host clock (decode, copies, writing; "
          f"{seconds:.1f} s with the set-up), launches {got}")
    return result, frames


def same_frames(what: str, got: list[np.ndarray], want: list[np.ndarray]
                ) -> None:
    if len(got) != len(want) or any(
            g.shape != w.shape or not np.array_equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError(f"{what}: the CLI's frames are not the "
                             "engine's")
    print(f"    {what}: {len(got)} frames {got[0].shape} equal to the "
          "engine called directly")


def io_times(frames: list[np.ndarray], out4k: torch.Tensor) -> None:
    """Phase 4f (printed): the AVI reader's ms per input frame; the
    writer's per RGBA output frame (written only; warm page cache); the
    CLI's RGBA packing on the card with the copy to pinned memory, and a
    uint8 frame's copy to pinned and to pageable host memory; the parts of
    a scored frame on the card: the bicubic reference (its first call
    builds the weights and moves them to the card; later calls reuse
    them), the output's uint8 levels to f32, PSNR and SSIM."""
    path = CLI_DIR / "io.avi"
    packed = video_cli._rgba(out4k).cpu().numpy()
    writer = avi.VideoWriter(str(path), 25.0, (out4k.shape[1],
                                                out4k.shape[0]))
    t0 = time.perf_counter()
    for _ in range(3):
        writer.write_rgba(packed)
    write_ms = (time.perf_counter() - t0) / 3 * 1e3
    writer.release()
    path.unlink()
    reader = avi.VideoReader(str(CLI_DIR / "in.avi"))
    t0 = time.perf_counter()
    for _ in range(len(frames)):
        reader.read()
    read_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    reader.release()

    def card_ms(fn, n=5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) / n * 1e3

    copy_ms = {}
    for name, src, pin in (("pinned", lambda: out4k, True),
                           ("pageable", lambda: out4k, False),
                           ("pack+pinned", lambda: video_cli._rgba(out4k),
                            True)):
        host = torch.empty(src().shape, dtype=torch.uint8, pin_memory=pin)
        _, copy_ms[name] = card_ms(lambda: host.copy_(src(),
                                                      non_blocking=True))
    # a scored frame's parts, as the CLI takes them
    x01 = rgb01(frames[0], out4k.device)
    levels = video_cli._levels(out4k.device)
    h4, w4 = out4k.shape[:2]

    def bicubic():
        return resize_bicubic(x01[None], h4, w4).clamp(0.0, 1.0)

    image_ops._resize_matrix.cache_clear()
    _, cold_ms = card_ms(bicubic, 1)
    ref, bicubic_ms = card_ms(bicubic)
    out01, levels_ms = card_ms(lambda: levels[out4k.long()][None])
    _, psnr_ms = card_ms(lambda: float(metrics.psnr(out01, ref)[0]))
    _, ssim_ms = card_ms(lambda: float(metrics.ssim(out01, ref)[0]))
    t0 = time.perf_counter()
    for f in frames:
        video_cli._rgb01(f)
    f32_ms = (time.perf_counter() - t0) / len(frames) * 1e3
    print(f"  a scored {h4}x{w4} frame on the card: bicubic reference "
          f"{bicubic_ms:.2f} ms (its first call, building the weights and "
          f"moving them to the card: {cold_ms:.2f} ms), the output's levels "
          f"to f32 {levels_ms:.2f} ms, PSNR {psnr_ms:.2f} ms, SSIM "
          f"{ssim_ms:.2f} ms (each read back); the scored path's host "
          f"conversion of a frame to RGB f32: {f32_ms:.2f} ms")
    in_mb, out_mb = frames[0].size * 4 / 3e6, packed.size / 1e6
    print(f"  AVI read {read_ms:.2f} ms per {HEIGHT}x{WIDTH} frame "
          f"({in_mb:.1f} MB RGBA); write {write_ms:.2f} ms per {h4}x{w4} "
          f"RGBA frame ({out_mb:.1f} MB); on the card, packing to RGBA and "
          f"the copy to pinned memory {copy_ms['pack+pinned']:.2f} ms; the "
          f"uint8 frame ({out4k.numel() / 1e6:.1f} MB) to the host "
          f"{copy_ms['pinned']:.2f} ms pinned, {copy_ms['pageable']:.2f} ms "
          "pageable")


def cli_phase(models: dict, smi: str) -> None:
    """Phase 4f (see the module docstring)."""
    t0 = time.perf_counter()
    dev = next(models["fsrgan"].parameters()).device
    rng = np.random.default_rng(SEED + 2)
    ae = build_generator("autoencoder", device=dev)
    ae = from_jax_params(ae, *seeded_flax_tree(ae, rng))
    print(f"phase 4f CLIs [{smi}]:")
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    CLI_DIR.mkdir()
    try:
        exports = {}
        for name, model, scale in (("fsrgan", models["fsrgan"], 4),
                                   ("srgan", models["srgan"], 4),
                                   ("autoencoder", ae, 1)):
            exports[name] = str(CLI_DIR / f"{name}.dgt")
            export_generator(exports[name], name, scale, model)
        frames = cli_frames(rng)
        video = str(CLI_DIR / "in.avi")
        writer = avi.VideoWriter(video, 25.0, (WIDTH, HEIGHT))
        for f in frames:
            writer.write(f)
        writer.release()
        cli_runs(models, ae, exports, video, frames, dev)
        cli_image(models["fsrgan"], exports["fsrgan"], frames, dev)
    finally:
        shutil.rmtree(CLI_DIR, ignore_errors=True)
    print(f"  phase 4f took {time.perf_counter() - t0:.1f} s")


def cli_runs(models, ae, exports, video, frames, dev) -> None:
    """Phase 4f's video CLI runs, each against its engine called here."""
    calib = [rgb01(frames[i], dev) for i in (0, 1, 3, 4)]
    u8_in = [torch.from_numpy(f).to(dev) for f in frames]
    f32_in = [rgb01(f, dev) for f in frames]
    n = len(frames)

    def argv(family, out, *flags):
        return ["--input_video", video, "--output_video",
                str(CLI_DIR / out), "--model", exports[family],
                "--score", "0", *flags]

    def outputs(engine, inputs):
        return [engine(x).cpu().numpy() for x in inputs]

    def rgb(read_back):
        # the AVI reads back BGR; the CLI's engines emit RGB for it
        return [f[..., ::-1] for f in read_back]

    last = None
    for fam, mode, flags in ((FAMILIES[0], "w8a8", ()),
                             (FAMILIES[0], "qh8", ("--q8", "2")),
                             (FAMILIES[0], "bf16", ("--q8", "0")),
                             (FAMILIES[1], "w8a8", ())):
        what = f"{fam.name} kernel engine {mode}, u8/BGR in, RGB out"
        _, got = run_cli(what, argv(fam.name, f"{fam.name}_{mode}.avi",
                                    *flags),
                         {fam.key(fam.kernel, mode): n})
        kw = {} if mode == "bf16" else dict(q8_calib_frame=calib,
                                             qh8=mode == "qh8")
        engine = fam.build(models[fam.name], HEIGHT, WIDTH, u8_input=True,
                           bgr_input=True, **kw)
        want = outputs(engine, u8_in)
        same_frames(what, rgb(got), want)
        print(f"    the engine alone: "
              f"{engine_fps(engine, u8_in[:2], GENERIC_FRAMES):.2f} "
              "frames/s (uint8 in, output on the card)")
        last = engine(u8_in[0])
        if (fam.name, mode) == ("fsrgan", "w8a8"):
            first = want
    # the first run paid the CLI's one-time costs (pinned host blocks,
    # cuDNN's first calls on these shapes): the default once more, warm
    fam = FAMILIES[0]
    what = "fsrgan kernel engine w8a8 again (warm)"
    _, got = run_cli(what, argv("fsrgan", "fsrgan_warm.avi"),
                     {fam.key(fam.kernel, "w8a8"): n})
    same_frames(what, rgb(got), first)

    # scored: f32 RGB in, frame 0 scored against the bicubic upscale
    what = "fsrgan kernel engine w8a8 scored"
    scored_argv = argv("fsrgan", "fsrgan_scored.avi")
    scored_argv[scored_argv.index("--score") + 1] = "1"
    result, got = run_cli(what, scored_argv,
                          {fam.key(fam.kernel, "w8a8"): n})
    engine = fam.build(models["fsrgan"], HEIGHT, WIDTH, q8_calib_frame=calib)
    want = outputs(engine, f32_in)
    same_frames(what, rgb(got), want)
    out01 = video_cli._levels(dev)[torch.from_numpy(want[0]).to(
        dev).long()][None]
    ref = resize_bicubic(f32_in[0][None], 4 * HEIGHT, 4 * WIDTH).clamp(
        0.0, 1.0)
    p, q = float(metrics.psnr(out01, ref)[0]), float(metrics.ssim(out01,
                                                                  ref)[0])
    print(f"    scored frames {result['scored_frames']}: psnr "
          f"{result['psnr']:.6f} (direct {p:.6f}), ssim {result['ssim']:.6f}"
          f" (direct {q:.6f})")
    if result["scored_frames"] != 1 or abs(result["psnr"] - p) > 1e-5 or \
            abs(result["ssim"] - q) > 1e-5:
        raise AssertionError(f"{what}: the CLI's scores are not "
                             "ops/metrics.py's")

    # the autoencoder's crop engine and FSRGAN's coarse engine: plain
    # PyTorch, no hand kernel
    what = "autoencoder crop engine 128/8"
    _, got = run_cli(what, argv("autoencoder", "ae.avi"), {})
    fwd = build_fast_forward(ae)
    engine = generic.build_frame_engine(fwd, HEIGHT, WIDTH, 1, 128, 8,
                                        out_uint8=True, stitch="crop",
                                        acc_dtype=torch.bfloat16,
                                        device=dev)
    same_frames(what, rgb(got), outputs(engine, f32_in))
    what = "fsrgan coarse engine 144/4 (--kernel_tail 0)"
    _, got = run_cli(what, argv("fsrgan", "coarse.avi", "--kernel_tail",
                                "0"), {})
    fwd, scale = build_fast_coarse(models["fsrgan"],
                                   out_dtype=torch.bfloat16)
    engine = generic.build_frame_engine(fwd, HEIGHT, WIDTH, scale, 144, 4,
                                        out_uint8=True, stitch="crop",
                                        acc_dtype=torch.bfloat16,
                                        device=dev)
    same_frames(what, rgb(got), outputs(engine, f32_in))
    io_times(frames, last)
    cli_steady(exports["fsrgan"], frames, n)


def cli_steady(export: str, frames: list[np.ndarray], n: int) -> None:
    """Phase 4f (printed): the default FSRGAN run, warm, on a clip of
    STEADY_REPEATS times the frames, without an output and writing one:
    frames/s by the host clock.  Fails where the disk has no room for
    three times the output."""
    video = CLI_DIR / "long.avi"
    writer = avi.VideoWriter(str(video), 25.0, (WIDTH, HEIGHT))
    for f in frames * STEADY_REPEATS:
        writer.write(f)
    writer.release()
    total = n * STEADY_REPEATS
    fam = FAMILIES[0]
    out = CLI_DIR / "long_out.avi"
    # three times the output (RGBA, 16 x the input's pixels) free
    need = 3 * total * 64 * HEIGHT * WIDTH
    free = shutil.disk_usage(CLI_DIR).free
    if free < need:
        raise AssertionError(f"steady run: {free} bytes free, {need} "
                             "needed for its output")
    for label, path in (("without an output", ""),
                        ("writing the RGBA AVI", str(out))):
        reset_counts()
        result = video_cli.main(["--input_video", str(video),
                                 "--output_video", path, "--model", export,
                                 "--score", "0"])
        if fired() != {fam.key(fam.kernel, "w8a8"): total}:
            raise AssertionError(f"steady run launches {fired()}")
        print(f"  fsrgan default on {total} frames, {label}: "
              f"{result['fps']:.2f} frames/s by the host clock")
        if path:
            out.unlink()
    video.unlink()


def cli_image(model, export: str, frames, dev) -> None:
    """Phase 4f: the image CLI on two 1080p .npy frames (FSRGAN, the whole
    image through the bf16 coarse-tail forward) against that forward
    called here, saved as the CLI saves."""
    src, dst = CLI_DIR / "images", CLI_DIR / "images_out"
    src.mkdir()
    for i in (0, 3):
        np.save(src / f"f{i}.npy", frames[i][..., ::-1])
    reset_counts()
    t0 = time.perf_counter()
    image_cli.main(["--image_dir", str(src), "--output_dir", str(dst),
                    "--model", export])
    seconds = time.perf_counter() - t0
    if fired():
        raise AssertionError(f"image CLI launched hand kernels: {fired()}")
    fwd = build_fast_forward(model)
    for i in (0, 3):
        x = rgb01(frames[i], dev)
        sr = (fwd(x[None])[0].float().cpu().numpy() + 1.0) / 2.0
        want = np.clip(sr * 255.0, 0, 255).astype(np.uint8)
        got = np.load(dst / f"f{i}.npy")
        if got.shape != (4 * HEIGHT, 4 * WIDTH, 3) or \
                not np.array_equal(got, want):
            raise AssertionError(f"image CLI f{i}.npy: not the forward's "
                                 "bytes")
    print(f"  image CLI, fsrgan whole image: 2 .npy 1080p frames -> "
          f"{(4 * HEIGHT, 4 * WIDTH, 3)} uint8, equal to the forward called "
          f"directly ({seconds:.1f} s with the set-up)")

# ---------------------------------------------------------------------------
# phase 4g: training


def train_images(directory: Path, dev) -> None:
    """TRAIN_IMAGES seeded uint8 RGB .npy images at DIV2K's size under
    directory/data/div2k, made on `dev` from a generator seeded SEED + 3:
    per channel a colour wave of random frequency and phase plus sensor
    noise."""
    d = directory / "data" / "div2k"
    d.mkdir(parents=True)
    h, w = DIV2K_HW
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :, None]
    for i in range(TRAIN_IMAGES):
        a, b, p = (torch.rand(3, 3, generator=g, device=dev)
                   * torch.tensor([[0.04], [0.04], [6.28]], device=dev)
                   + torch.tensor([[0.01], [0.01], [0.0]], device=dev))
        img = 0.5 + 0.4 * torch.sin(a * yy + b * xx + p)
        img += 0.03 * torch.randn(h, w, 3, generator=g, device=dev)
        np.save(d / f"{i:04d}.npy", (img.clamp(0, 1) * 255 + 0.5).to(
            torch.uint8).cpu().numpy())


def hr_batch(directory: Path, rng, n: int, crop: int) -> torch.Tensor:
    """n random crops (N, crop, crop, 3) f32 [0, 1] on the host from the
    first n images."""
    paths = sorted((directory / "data" / "div2k").glob("*.npy"))[:n]
    out = []
    for p in paths:
        img = np.load(p)
        y = rng.integers(0, img.shape[0] - crop + 1)
        x = rng.integers(0, img.shape[1] - crop + 1)
        out.append(img[y:y + crop, x:x + crop].astype(np.float32) / 255.0)
    return torch.from_numpy(np.stack(out))


def train_argv(family: str) -> list[str]:
    """The flags of a phase-4g run: the family's defaults (crop 256, its
    own fp16, --device cuda) but the data, batch and epochs."""
    return ["--image_dir", "data", "--batch_size", str(TRAIN_BATCH),
            "--epochs", str(TRAIN_EPOCHS)]


def grads_of(state) -> dict[str, dict[str, torch.Tensor]]:
    """Each net's gradients of its last step, recovered from Adam's first
    moments (after one step exp_avg = (1 - b1) g), on the host."""
    out = {}
    for name, net in (("gen", state.gen), ("disc", state.disc)):
        b1 = net.opt.param_groups[0]["betas"][0]
        out[name] = {n: (net.opt.state[p]["exp_avg"] / (1 - b1)).double()
                     .cpu()
                     for n, p in net.model.named_parameters()}
    return out


def compare_grads(got: dict, want: dict
                  ) -> tuple[float, float, float, str]:
    """(smallest cosine, largest |norm ratio - 1|, largest max|d| /
    max|g_want| and its tensor) over the tensors of one net above the
    noise level (STEP_NOISE of the net's largest gradient: a bias feeding
    a train-mode BatchNorm has none in exact arithmetic); raises where a
    tensor at the noise level is above it on either side."""
    largest = max(float(w.abs().max()) for w in want.values())
    cos_min, norm_max, rel_max, worst = 1.0, 0.0, 0.0, ""
    for name, w in want.items():
        g = got[name].double()
        w = w.double()
        scale = float(w.abs().max())
        if scale <= STEP_NOISE * largest:
            if float(g.abs().max()) > STEP_NOISE * largest:
                raise AssertionError(f"{name}: gradient above the noise "
                                     "level on one side only")
            continue
        cos_min = min(cos_min, float((g * w).sum() / (g.norm() * w.norm())))
        norm_max = max(norm_max, abs(float(g.norm() / w.norm()) - 1))
        rel = float((g - w).abs().max()) / scale
        if rel > rel_max:
            rel_max, worst = rel, name
    return cos_min, norm_max, rel_max, worst


def worst_tensors(got: dict, want: dict, n: int = 3) -> str:
    """The n tensors of one net whose max |d| / max |g_want| is largest,
    among those above the noise level, with that ratio."""
    largest = max(float(w.abs().max()) for w in want.values())
    rows = sorted(((float((got[k].double() - w).abs().max())
                    / float(w.abs().max()), k) for k, w in want.items()
                   if float(w.abs().max()) > STEP_NOISE * largest),
                  reverse=True)[:n]
    return ", ".join(f"{k} {r:.2e}" for r, k in rows)


def step_readings(bundle, cfg, pair, dev, dtype=torch.float32,
                  onednn: bool = False) -> tuple[dict, dict, dict]:
    """One step (degrade=False) on `dev` in `dtype` from the seeded
    weights: (losses, the gradients recovered from Adam per net, the new
    BatchNorm statistics), on the host in float64.  The step runs under
    utils/device.py::exact_f32 (TF32 off; on the CPU without oneDNN);
    `onednn` leaves oneDNN's CPU convolutions on (TF32 off only)."""
    import denoise_gan_tpu_torch.train.step as step_module
    state = create_train_state(bundle, cfg, dev, seed=SEED)
    vgg = init_vgg_params(device=dev)
    for m in (state.gen.model, state.disc.model, vgg):
        m.to(dtype)
    step = build_train_step(bundle, cfg, degrade=False)
    saved = step_module.exact_f32
    if onednn:
        step_module.exact_f32 = no_tf32
    try:
        metrics = {k: float(v) for k, v in step(
            state, vgg, tuple(p.to(dev, dtype) for p in pair)).items()}
    finally:
        step_module.exact_f32 = saved
    stats = {f"{net}.{n}": b.double().cpu() for net in ("gen", "disc")
             for n, b in getattr(state, net).model.named_buffers()}
    return metrics, grads_of(state), stats


def card_vs_f64_step(directory: Path, dev) -> None:
    """One FSRGAN step (f32, TF32 off, degrade=False, crop CHECK_CROP,
    batch CHECK_BATCH) on the card against the same step in float64 on
    the CPU, from the same weights and pair: every loss within STEP_RTOL
    relative, the new BatchNorm statistics within STEP_RTOL of each
    tensor's largest magnitude, the gradients recovered from Adam per
    tensor cosine >= STEP_COS, norms within STEP_NORM and max |d| <=
    STEP_GRAD_CARD max |g|.  Printed beside it, tensor by tensor (the
    three worst of each net): the card, the CPU's f32 step (oneDNN off,
    as the step runs) and the CPU's f32 step with oneDNN on, each against
    float64."""
    cfg = make_config("fsrgan", crop_size=CHECK_CROP,
                      batch_size=CHECK_BATCH, device="cpu")
    bundle = build_models("fsrgan")
    hr = hr_batch(directory, np.random.default_rng(SEED + 4), CHECK_BATCH,
                  CHECK_CROP)
    pair = degrade_pair(hr, 4, 50)
    runs = {"card": step_readings(bundle, cfg, pair, dev),
            "cpu": step_readings(bundle, cfg, pair, "cpu"),
            "cpu_onednn": step_readings(bundle, cfg, pair, "cpu",
                                        onednn=True),
            "f64": step_readings(bundle, cfg, pair, "cpu", torch.float64)}
    ref_m, ref_g, ref_s = runs["f64"]
    print(f"  FSRGAN step against float64 on the CPU (crop {CHECK_CROP}, "
          f"batch {CHECK_BATCH}, f32, TF32 off), max|d|/max|g| per "
          "tensor:")
    ok = True
    for key in ("card", "cpu", "cpu_onednn"):
        metrics, grads, stats = runs[key]
        worst_loss = max(abs(metrics[k] - v) / max(abs(v), 1e-30)
                         for k, v in ref_m.items())
        stat_rel = max(float((b - ref_s[n]).abs().max())
                       / max(float(ref_s[n].abs().max()), 1e-30)
                       for n, b in stats.items())
        print(f"    {key}: losses {worst_loss:.2e} relative, BN statistics "
              f"{stat_rel:.2e}")
        for net in ("gen", "disc"):
            cos, norm, rel, _ = compare_grads(grads[net], ref_g[net])
            print(f"      {net}: cosine >= {cos:.7f}, norms within "
                  f"{norm:.2e}, max|d|/max|g| {rel:.2e}; worst: "
                  f"{worst_tensors(grads[net], ref_g[net])}")
            if key == "card":
                ok &= cos >= STEP_COS and norm <= STEP_NORM and \
                    rel <= STEP_GRAD_CARD
        if key == "card":
            ok &= worst_loss <= STEP_RTOL and stat_rel <= STEP_RTOL
    print(f"    held: the card within losses and statistics {STEP_RTOL}, "
          f"cosine {STEP_COS}, norms {STEP_NORM}, max|d|/max|g| "
          f"{STEP_GRAD_CARD} of float64")
    if not ok:
        raise AssertionError("the card's FSRGAN step is outside the "
                             "tolerances against float64")


def step_split(step, state, vgg, batch, gen, n: int
               ) -> tuple[dict[str, float], float]:
    """ms per part of the step (train/step.py::PARTS) by CUDA events at
    the step's marks, and ms per step, means over n steps."""
    parts = dict.fromkeys(PARTS, 0.0)
    total = 0.0
    for _ in range(n):
        events = [torch.cuda.Event(enable_timing=True)]
        names = []

        def mark(part):
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
            names.append(part)

        torch.cuda.synchronize()
        events[0].record()
        step(state, vgg, batch, gen, mark=mark)
        torch.cuda.synchronize()
        for a, b, name in zip(events, events[1:], names):
            parts[name] += a.elapsed_time(b) / n
        total += events[0].elapsed_time(events[-1]) / n
    return parts, total


def idle_share(step, state, vgg, batch, gen, n: int) -> str:
    """The device's idle share over n steps from a torch.profiler trace:
    1 - (union of the CUDA kernels' intervals) / (the trace's span, from
    its first event to its last)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step(state, vgg, batch, gen)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA)
    if not kernels:
        return "not measured (no device events in the trace)"
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    busy, end = 0.0, -1.0
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    return (f"{1 - busy / span:.3f} ({len(kernels)} kernels, busy "
            f"{busy / 1e3:.1f} of {span / 1e3:.1f} ms)")


def exports_equal(family: str, state, cfg, dev) -> None:
    """The run's exports read back into fresh nets equal its final
    state."""
    bundle = build_models(family, scale=cfg.scale, fp16=bool(cfg.fp16))
    for suffix, live, fresh in (
            ("", state.gen.model, bundle.build_generator_net(dev)),
            ("_disc", state.disc.model, bundle.build_discriminator(dev))):
        load_export_into(f"models/{cfg.model_name}{suffix}.dgt", fresh)
        theirs = fresh.state_dict()
        bad = [n for n, t in live.state_dict().items()
               if not torch.equal(t, theirs[n])]
        if bad:
            raise AssertionError(f"{family}{suffix} export differs from "
                                 f"the final state: {bad[:4]}")


def training_phase(smi: str) -> torch.Tensor:
    """Phase 4g (see the module docstring); returns phase 4h's HR batch
    (PAR_BATCH crops of PAR_CROP from 4g's first images, on the host)."""
    t0 = time.perf_counter()
    dev = require_cuda()
    print(f"phase 4g training [{smi}]:")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    TRAIN_DIR.mkdir()
    cwd = os.getcwd()
    try:
        train_images(TRAIN_DIR, dev)
        print(f"  {TRAIN_IMAGES} seeded uint8 images {DIV2K_HW[0]}x"
              f"{DIV2K_HW[1]} written in {time.perf_counter() - t0:.1f} s")
        os.chdir(TRAIN_DIR)
        batch_rng = np.random.default_rng(SEED + 5)
        for family in ("fsrgan", "srgan", "autoencoder", "pix2pix"):
            trainer = importlib.import_module(f"train_{family}_torch")
            argv = train_argv(family)
            cfg = parse_args(family, argv)
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as log:
                state = trainer.main(argv)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t1
            run_steps = state.step
            peak = torch.cuda.max_memory_allocated() / 1e9
            if fired():
                raise AssertionError(f"training {family} launched hand "
                                     f"kernels: {fired()}")
            epochs = [l for l in log.getvalue().splitlines()
                      if "Starting epoch" in l]
            if len(epochs) != TRAIN_EPOCHS or run_steps != \
                    TRAIN_EPOCHS * (TRAIN_IMAGES // TRAIN_BATCH):
                raise AssertionError(f"{family}: {state.step} steps, "
                                     f"epochs {epochs}")
            exports_equal(family, state, cfg, dev)
            bundle = build_models(family, scale=cfg.scale,
                                  fp16=bool(cfg.fp16))
            step = build_train_step(bundle, cfg)
            vgg = init_vgg_params(device=dev)
            hr = hr_batch(TRAIN_DIR, batch_rng, TRAIN_BATCH,
                          cfg.crop_size).to(dev)
            gen = torch.Generator(device=dev).manual_seed(SEED)
            metrics = step(state, vgg, hr, gen)
            torch.cuda.synchronize()
            bad = {k: float(v) for k, v in metrics.items()
                   if not math.isfinite(float(v))}
            if bad:
                raise AssertionError(f"{family}: non-finite losses {bad}")
            parts, step_ms = step_split(step, state, vgg, hr, gen,
                                        BARE_STEPS)
            timer = state.timer
            print(f"  {family} ({'bf16' if cfg.fp16 else 'f32'}, crop "
                  f"{cfg.crop_size}, batch {TRAIN_BATCH}): main() "
                  f"{run_s:.1f} s for {run_steps} steps "
                  f"(with set-up, {TRAIN_EPOCHS} epochs, checkpoints, "
                  f"exports); StepTimer {timer.steps_per_sec:.3f} steps/s "
                  f"= {timer.images_per_sec:.2f} images/s over "
                  f"{timer.steps} steps (data and summaries every "
                  f"{min(cfg.save_iter, TRAIN_IMAGES // TRAIN_BATCH)} "
                  f"steps included); the step alone {step_ms:.2f} ms = "
                  f"{1e3 / step_ms:.3f} steps/s = "
                  f"{TRAIN_BATCH * 1e3 / step_ms:.2f} images/s (CUDA events,"
                  f" {BARE_STEPS} steps); peak memory {peak:.2f} GB; hand-"
                  "kernel launches 0; losses finite; exports read back "
                  f"equal; last losses gen {float(metrics['gen_loss']):.4g},"
                  f" disc {float(metrics['disc_loss']):.4g}")
            if family == "fsrgan":
                print("  fsrgan step split, ms (CUDA events at the step's "
                      "marks, mean of "
                      f"{BARE_STEPS}): " + ", ".join(
                          f"{k} {v:.2f}" for k, v in parts.items()))
                print("  fsrgan device idle share over 3 steps "
                      "(torch.profiler): "
                      + idle_share(step, state, vgg, hr, gen, 3))
            del state, step, vgg, hr
            torch.cuda.empty_cache()
        os.chdir(cwd)
        card_vs_f64_step(TRAIN_DIR, dev)
        hr = hr_batch(TRAIN_DIR, np.random.default_rng(SEED + 4),
                      PAR_BATCH, PAR_CROP)
    finally:
        os.chdir(cwd)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    print(f"  phase 4g took {time.perf_counter() - t0:.1f} s")
    return hr



# ---------------------------------------------------------------------------
# phase 4h: data parallelism, two ranks over gloo on the one card

RANKS = 2
PAR_CROP, PAR_BATCH = 256, 16     # the FSRGAN step's global batch, 8 a rank
PAR_P2P = 2                       # pix2pix's global batch, 1 a rank
PAR_STEPS = 3                     # steps timed after the first
PAR_FRAMES = 2                    # kernel-engine frames a rank
PAR_JOIN_S = 300                  # a rank's join and each collective
PAR_RUN_S = 600                   # both ranks, start to end
# The f32 two-rank step against the one-process step: the convolutions
# run on 8 images a rank against 16 (other cuDNN algorithms) and the
# BatchNorm sums are added per rank, so activations near a leaky-ReLU kink
# land on either side of it; one flip moves a gradient summed over N
# positions by ~1/sqrt(N) of its largest value (N = 4096 for the FSRGAN
# discriminator's last conv at crop 256, batch 16).  So in f32 the losses
# and statistics are held (pix2pix's statistics to 1e-4: at batch 1 a rank
# its inner BatchNorms normalise 2-64 values a channel, where E[x^2] -
# mean^2 cancels), the gradients' directions (cosine; pix2pix's generator
# as tests/test_torch_cuda.py holds it card vs CPU), their norms within
# PAR_NORM_F32 (pix2pix's generator 5e-3, as tests/test_torch_cuda.py) and
# max |d| within PAR_GRAD_F32 of max |g| (the card rule of the training
# tests before they were held to float64; pix2pix's generator 1e-1, where
# one transposed conv's few positions read 4.34e-2 on an H100 80GB HBM3 at
# 700 W); both steps again in float64, where no kink flips, held to the
# CPU tests' whole rule.
PAR_NORM_F32, PAR_GRAD_F32 = 3e-3, 5e-2
F32_RULES = {"fsrgan": {"loss": STEP_RTOL, "stats": STEP_RTOL,
                        "gen": (STEP_COS, PAR_NORM_F32, PAR_GRAD_F32),
                        "disc": (STEP_COS, PAR_NORM_F32, PAR_GRAD_F32)},
             "pix2pix": {"loss": STEP_RTOL, "stats": 1e-4,
                         "gen": (0.999, 5e-3, 1e-1),
                         "disc": (STEP_COS, PAR_NORM_F32, PAR_GRAD_F32)}}
F64_RULES = {"loss": STEP_RTOL, "stats": STEP_RTOL,
             "gen": (STEP_COS, STEP_NORM, 1e-3),
             "disc": (STEP_COS, STEP_NORM, 1e-3)}


def digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def par_frames(dev) -> torch.Tensor:
    """RANKS x PAR_FRAMES distinct seeded 1080p frames (rng SEED + 7)."""
    rng = np.random.default_rng(SEED + 7)
    return torch.stack([seeded_frame(rng, HEIGHT, WIDTH, dev)
                        for _ in range(RANKS * PAR_FRAMES)])


def par_models(dev) -> tuple[torch.nn.Module, torch.nn.Module]:
    """Phase 3's seeded FSRGAN (rng SEED) and a seeded autoencoder (rng
    SEED + 8)."""
    fsrgan = seeded_model(FAMILIES[0], np.random.default_rng(SEED), dev)
    ae = build_generator("autoencoder", device=dev)
    ae = from_jax_params(ae, *seeded_flax_tree(
        ae, np.random.default_rng(SEED + 8)))
    return fsrgan, ae


def par_step(family: str, hr: torch.Tensor, mesh, steps: int = 0,
             dtype: torch.dtype = torch.float32) -> dict:
    """One step of `family` (TF32 off, the JPEG qualities drawn at random
    over the global batch) from the seeded weights on this rank's rows of
    the global HR batch `hr`: its losses, gradients (host float64), new
    BatchNorm statistics and the digest of both nets after it; with
    `steps`, the ms of a step (CUDA events) over that many more.  In f32
    the step degrades the batch; in float64 the f32 degradation of the
    global batch is made first and the step takes its rows in float64."""
    dev = mesh.device
    cfg = make_config(family, crop_size=PAR_CROP, jpeg_quality=0,
                      device=str(dev))
    bundle = build_models(family, scale=cfg.scale)
    state = create_train_state(bundle, cfg, dev, seed=SEED)
    vgg = init_vgg_params(device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    if dtype == torch.float32:
        step = build_train_step(bundle, cfg, mesh=mesh)
        batch = shard_batch(hr.to(dev), mesh)
    else:
        for m in (state.gen.model, state.disc.model, vgg):
            m.to(dtype)
        step = build_train_step(bundle, cfg, degrade=False, mesh=mesh)
        pair = degrade_pair(hr.to(dev), cfg.scale, 1, gen,
                            random_quality=True)
        batch = shard_batch(tuple(p.to(dtype) for p in pair), mesh)
    out = {"metrics": {k: float(v) for k, v in
                       step(state, vgg, batch, gen).items()},
           "grads": grads_of(state),
           "stats": {f"{net}.{n}": b.double().cpu() for net in ("gen",
                     "disc") for n, b in getattr(state, net).model
                     .named_buffers()},
           "digest": digest(*state.gen.model.state_dict().values(),
                            *state.disc.model.state_dict().values())}
    if steps:
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(steps):
            step(state, vgg, batch, gen)
        end.record()
        torch.cuda.synchronize(dev)
        out["ms"] = start.elapsed_time(end) / steps
    return out


def par_serving(mesh) -> dict:
    """Frame parallelism: the FSRGAN w8a8 kernel engine (plain body, then
    the K3 body) on this rank's frames of par_frames, counts zeroed just
    before and read just after (digests of the frames); the autoencoder's
    f32 crop engine with its tile batch split over the ranks on frame 0
    (its output, or on one rank its digest)."""
    dev = mesh.device
    frames = par_frames(dev)
    fsrgan, ae = par_models(dev)
    k3_body, tw, brc = ke.prepare_mbconv_fsrgan_engine(
        fsrgan, HEIGHT, WIDTH, q8_calib_frame=frames[0])
    engines = {"w8a8": FAMILIES[0].build(fsrgan, HEIGHT, WIDTH,
                                         q8_calib_frame=frames[0]),
               "k3": ke.build_kernel_engine(k3_body, tw, HEIGHT, WIDTH,
                                            brc=brc)}
    out = {}
    for name, engine in engines.items():
        reset_counts()
        outs = map_frames(engine, frames, mesh)
        torch.cuda.synchronize(dev)
        out[name] = ([digest(o) for o in outs], fired())
    engine = generic_engine("autoencoder", ae, HEIGHT, WIDTH, torch.float32,
                            mesh=mesh if mesh.size > 1 else None)
    reset_counts()
    o = engine(frames[0])
    torch.cuda.synchronize(dev)
    out["generic"] = (o.cpu() if mesh.rank == 0 else None, digest(o),
                      fired())
    return out


def gloo_probe(mesh) -> dict:
    """all_reduce (f32, uint8) and broadcast of CUDA tensors over the
    group: the values every rank must see."""
    import torch.distributed as dist
    dev, r = mesh.device, mesh.rank
    f = torch.full((3,), r + 1.0, device=dev)
    u = torch.full((5,), r + 1, dtype=torch.uint8, device=dev)
    b = torch.full((2,), float(r + 7), device=dev)
    dist.all_reduce(f)
    dist.all_reduce(u)
    dist.broadcast(b, src=0)
    return {"f32": f.tolist(), "u8": u.tolist(), "broadcast": b.tolist()}


def _par_rank(rank: int, store: str, hr: torch.Tensor, out_dir: str
              ) -> None:
    """One rank of phase 4h (spawned): gloo on the card cuda:0."""
    import torch.distributed as dist
    init_distributed(backend="gloo", device="cuda:0",
                     init_method=f"file://{store}", rank=rank,
                     world_size=RANKS, timeout_s=PAR_JOIN_S)
    mesh = make_mesh(device="cuda:0")
    out = {"mesh": (mesh.size, mesh.rank, str(mesh.device)),
           "backend": dist.get_backend(), "gloo": gloo_probe(mesh),
           "fsrgan": par_step("fsrgan", hr, mesh, PAR_STEPS),
           "fsrgan64": par_step("fsrgan", hr, mesh, dtype=torch.float64),
           "pix2pix": par_step("pix2pix", hr[:PAR_P2P], mesh),
           "pix2pix64": par_step("pix2pix", hr[:PAR_P2P], mesh,
                                 dtype=torch.float64)}
    out.update(par_serving(mesh))
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_spawned(fn: Callable, args: tuple, limit_s: float, phase: str
                ) -> list[dict]:
    """fn(rank, store, *args, out_dir) on RANKS spawned ranks, joined
    within `limit_s` (a rank's failure raises here; ranks still running
    then are killed): each rank's pickled result."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix=f"dgt_{phase}_") as tmp:
        ctx = mp.start_processes(
            fn, args=(os.path.join(tmp, "store"), *args, tmp),
            nprocs=RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + limit_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"phase {phase}'s ranks ran past "
                                       f"{limit_s} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def compare_steps(what: str, got: dict, want: dict, rules: dict) -> bool:
    """A rank's step against the one-process step, printed: losses and
    statistics (held within rules["loss"], rules["stats"]), each net's
    gradients (held by rules[net] = (cosine, norms, max |d| / max |g|)).
    Whether it held."""
    worst_loss = max(abs(got["metrics"][k] - v) / max(abs(v), 1e-30)
                     for k, v in want["metrics"].items())
    stat_rel = max(float((b - want["stats"][n]).abs().max())
                   / max(float(want["stats"][n].abs().max()), 1e-30)
                   for n, b in got["stats"].items())
    print(f"    {what}: losses {worst_loss:.2e} relative (bound "
          f"{rules['loss']}), BN statistics {stat_rel:.2e} (bound "
          f"{rules['stats']})")
    ok = worst_loss <= rules["loss"] and stat_rel <= rules["stats"]
    for net in ("gen", "disc"):
        c, n, r = rules[net]
        cos, norm, rel, name = compare_grads(got["grads"][net],
                                             want["grads"][net])
        print(f"      {net} gradients: cosine >= {cos:.7f} (bound {c}), "
              f"norms within {norm:.2e} (bound {n}), max|d|/max|g| "
              f"{rel:.2e} ({name}; bound {r}); worst: "
              f"{worst_tensors(got['grads'][net], want['grads'][net])}")
        ok &= cos >= c and norm <= n and rel <= r
    return ok


def codec_reading() -> None:
    """Whether the native codec built here, the decoder decode_image uses,
    and where it built, the ms of a JPEG round trip (quality 75) of a
    seeded DIV2K-sized uint8 image (mean of 3 after one)."""
    built = native.available()
    print(f"  codec: native/imgcodec.cpp "
          f"{'built' if built else 'not built: ' + native.build_error}; "
          f"data/pipeline.py::decode_image decodes image files by "
          f"{pipeline.decoder()}")
    if not built:
        return
    img = (np.random.default_rng(SEED + 9).random((*DIV2K_HW, 3))
           * 255).astype(np.uint8)
    native.jpeg_roundtrip_u8(img, 75)
    t = time.perf_counter()
    for _ in range(3):
        out = native.jpeg_roundtrip_u8(img, 75)
    ms = (time.perf_counter() - t) / 3 * 1e3
    if out is None or out.shape != img.shape:
        raise AssertionError("the native JPEG round trip failed")
    print(f"    JPEG round trip (libjpeg encode + decode, quality 75) of a "
          f"{DIV2K_HW[0]}x{DIV2K_HW[1]} image: {ms:.2f} ms (host clock)")


def parallel_phase(hr: torch.Tensor, smi: str) -> None:
    """Phase 4h (see the module docstring)."""
    t0 = time.perf_counter()
    dev = require_cuda()
    print(f"phase 4h data parallelism, {RANKS} ranks over gloo sharing the "
          f"card [{smi}]:")
    one_mesh = make_mesh(device=dev)
    one = {"fsrgan": par_step("fsrgan", hr, one_mesh, PAR_STEPS),
           "fsrgan64": par_step("fsrgan", hr, one_mesh,
                                dtype=torch.float64),
           "pix2pix": par_step("pix2pix", hr[:PAR_P2P], one_mesh),
           "pix2pix64": par_step("pix2pix", hr[:PAR_P2P], one_mesh,
                                 dtype=torch.float64)}
    serving = par_serving(one_mesh)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ranks = run_spawned(_par_rank, (hr,), PAR_RUN_S, "4h")
    print(f"  the ranks ran in {time.perf_counter() - t1:.1f} s (spawned, "
          "each joining over a file store)")
    for r, got in enumerate(ranks):
        if got["mesh"] != (RANKS, r, "cuda:0") or got["backend"] != "gloo":
            raise AssertionError(f"rank {r}: {got['mesh']}, "
                                 f"{got['backend']}")
        if got["gloo"] != {"f32": [3.0] * 3, "u8": [3] * 5,
                           "broadcast": [7.0] * 2}:
            raise AssertionError(f"rank {r}: gloo on CUDA tensors gave "
                                 f"{got['gloo']}")
    print("  gloo on CUDA tensors: all_reduce (f32, uint8) and broadcast "
          "right on both ranks")
    print(f"  FSRGAN step, crop {PAR_CROP}, global batch {PAR_BATCH} "
          f"({PAR_BATCH // RANKS} a rank), random JPEG qualities drawn over "
          "the global batch, rank 0 against the one-process step:")
    ok = compare_steps("f32", ranks[0]["fsrgan"], one["fsrgan"],
                       F32_RULES["fsrgan"])
    ok &= compare_steps("float64", ranks[0]["fsrgan64"], one["fsrgan64"],
                        F64_RULES)
    print(f"  pix2pix, global batch {PAR_P2P} (1 a rank), dropout masks "
          "and JPEG qualities drawn over the global batch:")
    ok &= compare_steps("f32", ranks[0]["pix2pix"], one["pix2pix"],
                        F32_RULES["pix2pix"])
    ok &= compare_steps("float64", ranks[0]["pix2pix64"], one["pix2pix64"],
                        F64_RULES)
    if not ok:
        raise AssertionError("the two-rank step is not the one-process "
                             "step")
    for fam in ("fsrgan", "fsrgan64", "pix2pix", "pix2pix64"):
        if len({r[fam]["digest"] for r in ranks}) != 1 or \
                ranks[0][fam]["metrics"] != ranks[1][fam]["metrics"]:
            raise AssertionError(f"{fam}: the ranks' nets differ after the "
                                 "step")
    print("    both nets bit-identical across the ranks after each step")
    print(f"    ms a step: one process (batch {PAR_BATCH}) "
          f"{one['fsrgan']['ms']:.2f}; two ranks sharing the card "
          f"({PAR_BATCH // RANKS} each, gloo) "
          + " / ".join(f"{r['fsrgan']['ms']:.2f}" for r in ranks)
          + f" (CUDA events over {PAR_STEPS} steps after the first) "
          f"[{smi}]; ranks sharing one card: not a scaling figure")
    for name, kernels in (("w8a8", {"fused_tail_u8:w8a8": PAR_FRAMES}),
                          ("k3", {"fused_mbconv": 6 * PAR_FRAMES,
                                  "fused_tail_u8:w8a8": PAR_FRAMES})):
        want = serving[name][0]
        for r, got in enumerate(ranks):
            digests, launches = got[name]
            if digests != want[r * PAR_FRAMES:(r + 1) * PAR_FRAMES]:
                raise AssertionError(f"{name} rank {r}: frames differ from "
                                     "the one-process engine's")
            if launches != kernels:
                raise AssertionError(f"{name} rank {r}: launches "
                                     f"{launches}, not {kernels}")
        print(f"  FSRGAN kernel engine ({'K3 body, ' if name == 'k3' else ''}"
              f"w8a8), {PAR_FRAMES} distinct 1080p -> 4K frames a rank: "
              f"each byte-equal to the one-process engine; launches a rank "
              f"{kernels}")
    out0, dig0, launched0 = ranks[0]["generic"]
    if launched0 or ranks[1]["generic"][2] or \
            dig0 != ranks[1]["generic"][1]:
        raise AssertionError("the tile-split engine's ranks disagree or "
                             "launched hand kernels")
    same = dig0 == serving["generic"][1]
    check_bound(f"autoencoder f32 crop engine, tile batch split over "
                f"{RANKS} ranks, vs one process (byte-equal: {same})",
                out0, serving["generic"][0])
    codec_reading()
    print(f"  phase 4h took {time.perf_counter() - t0:.1f} s")



# ---------------------------------------------------------------------------
# phase 4i: a reference Keras .h5 on the card, and the space axis

ROOT = Path(__file__).resolve().parent
H5_FIXTURE = ROOT / "tests" / "data" / "fsrgan_ref.h5"
H5_SIDECAR = H5_FIXTURE.with_suffix(".json")
H5_DIR = ROOT / "_h5_smoke"            # the phase's files (deleted after)
H5_FRAMES = 2
H5_LOADS = 3                            # timed loads, after one
SPACE_TOL = 1e-4                        # tests/test_parallel.py:58-59
SPACE_REPEATS = 2                       # timed forwards, after the first
SPACE_RUN_S = 300                       # both ranks, start to end
SPACE_CASES = (("fsrgan", torch.float32), ("fsrgan", torch.bfloat16),
               ("srgan", torch.float32), ("srgan", torch.bfloat16))


def h5_datasets(group, prefix: str = "") -> dict:
    """{path: dataset} under an io/hdf5.py group."""
    out = {}
    for name in group.keys():
        node, path = group[name], f"{prefix}{name}"
        if isinstance(node, hdf5.Group):
            out.update(h5_datasets(node, path + "/"))
        else:
            out[path] = node
    return out


def fixture_hashes() -> None:
    """The fixture read by io/hdf5.py: the same datasets as the sidecar
    lists, each one's float32 bytes of its sha256."""
    side = json.loads(H5_SIDECAR.read_text())
    t0 = time.perf_counter()
    found = h5_datasets(hdf5.File(str(H5_FIXTURE)))
    bad = [d["path"] for d in side["datasets"]
           if d["path"] not in found or hashlib.sha256(np.ascontiguousarray(
               found[d["path"]][()], np.float32).tobytes()).hexdigest()
           != d["sha256"] or list(found[d["path"]].shape) != d["shape"]]
    ms = (time.perf_counter() - t0) * 1e3
    if bad or len(found) != len(side["datasets"]):
        raise AssertionError(f"{H5_FIXTURE.name}: {len(found)} datasets, "
                             f"the sidecar {len(side['datasets'])}; "
                             f"differing {bad[:4]}")
    print(f"  {H5_FIXTURE.name} ({H5_FIXTURE.stat().st_size:,} bytes, "
          f"written by {side['writer']}): {len(found)} datasets read by "
          f"io/hdf5.py ({ms:.1f} ms), each one's shape and sha256 equal to "
          "the sidecar's")


def load_ms(path: str, dev) -> float:
    """ms of io/checkpoint.py::load_generator(path) onto the card, host
    clock ending in a synchronize, mean of H5_LOADS after one."""
    with contextlib.redirect_stdout(io.StringIO()):
        load_generator(path, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(H5_LOADS):
            load_generator(path, device=dev)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / H5_LOADS * 1e3


def h5_phase(smi: str) -> None:
    """Phase 4i (a) (see the module docstring)."""
    t0 = time.perf_counter()
    dev = require_cuda()
    print(f"phase 4i(a) a reference Keras .h5 on the card [{smi}]:")
    fixture_hashes()
    shutil.rmtree(H5_DIR, ignore_errors=True)
    H5_DIR.mkdir()
    try:
        h5, dgt = str(H5_FIXTURE), str(H5_DIR / "fsrgan_ref.dgt")
        keras_h5.main(["--h5", h5, "--out", dgt])
        rng = np.random.default_rng(SEED + 11)
        frames = [np.ascontiguousarray((seeded_frame(
            rng, HEIGHT, WIDTH, "cpu").numpy() * 255 + 0.5).astype(
                np.uint8)[..., ::-1]) for _ in range(H5_FRAMES)]
        video = str(H5_DIR / "in.avi")
        writer = avi.VideoWriter(video, 25.0, (WIDTH, HEIGHT))
        for f in frames:
            writer.write(f)
        writer.release()
        fam = FAMILIES[0]
        got = {}
        for name, path in (("h5", h5), ("dgt", dgt)):
            argv = ["--input_video", video, "--output_video",
                    str(H5_DIR / f"{name}.avi"), "--model", path,
                    "--score", "0"]
            _, got[name] = run_cli(
                f"video CLI --model {Path(path).name} (kernel engine w8a8)",
                argv, {fam.key(fam.kernel, "w8a8"): H5_FRAMES})
        if len(got["h5"]) != H5_FRAMES or any(
                not np.array_equal(a, b) for a, b in zip(got["h5"],
                                                         got["dgt"])):
            raise AssertionError("the CLI's frames from the .h5 and the "
                                 ".dgt differ")
        print(f"    {H5_FRAMES} frames {got['h5'][0].shape} from the .h5 "
              "byte-equal to those from the .dgt (the port's converter)")
        x01 = [rgb01(f, dev) for f in frames]
        want = {"fused_mbconv": 6 * H5_FRAMES,
                fam.key(fam.kernel, "w8a8"): H5_FRAMES}
        digests = {}
        for name, path in (("h5", h5), ("dgt", dgt)):
            with contextlib.redirect_stdout(io.StringIO()):
                _, model = load_generator(path, device=dev)
            body, tw, brc = ke.prepare_mbconv_fsrgan_engine(
                model, HEIGHT, WIDTH, q8_calib_frame=x01[0])
            engine = ke.build_kernel_engine(body, tw, HEIGHT, WIDTH, brc=brc)
            reset_counts()
            outs = [engine(x) for x in x01]
            torch.cuda.synchronize()
            launches = fired()
            if launches != want:
                raise AssertionError(f"K3-body engine from the {name}: "
                                     f"launches {launches}, not {want}")
            check_output(f"K3-body engine from the .{name}", outs[0],
                         (4 * HEIGHT, 4 * WIDTH, 3))
            digests[name] = [digest(o) for o in outs]
        if digests["h5"] != digests["dgt"]:
            raise AssertionError("the K3-body engines from the .h5 and the "
                                 ".dgt differ")
        print(f"  K3-body engine (w8a8) from the .h5 byte-equal to the one "
              f"from the .dgt on {H5_FRAMES} frames; launches {want}")
        print(f"  load_generator onto the card, host clock, mean of "
              f"{H5_LOADS} after one: .h5 {load_ms(h5, dev):.1f} ms "
              f"({H5_FIXTURE.stat().st_size:,} bytes), .dgt "
              f"{load_ms(dgt, dev):.1f} ms ({os.path.getsize(dgt):,} "
              f"bytes) [{smi}]")
    finally:
        shutil.rmtree(H5_DIR, ignore_errors=True)
    print(f"  phase 4i(a) took {time.perf_counter() - t0:.1f} s")


def space_model(name: str, dtype, dev):
    """The seeded full-width generator of phase 3's draw (rng SEED + 12)
    in compute dtype `dtype`."""
    fam = FAMILIES[0 if name == "fsrgan" else 1]
    model = build_generator(name, dtype=dtype, device=dev)
    return from_jax_params(model, *seeded_flax_tree(
        model, np.random.default_rng(SEED + 12), fam.body_gain,
        fam.out_gain))


def space_forward(name: str, dtype, mesh) -> dict:
    """The whole-frame forward of `name` in `dtype` on this rank's rows of
    the seeded 1080p frame (rng SEED + 13), TF32 off: one process runs the
    plain forward, several ranks parallel/spatial.py::spatial_apply.  Its
    output rows, the peak of torch.cuda.max_memory_allocated over the
    first forward, the halo exchanges and their bytes in it, and the ms a
    forward (CUDA events over SPACE_REPEATS after it)."""
    dev = mesh.device
    model = space_model(name, dtype, dev)
    x = seeded_frame(np.random.default_rng(SEED + 13), HEIGHT, WIDTH,
                     dev)[None] * 2.0 - 1.0
    lo, hi = row_range(HEIGHT, mesh)
    x = x[:, lo:hi].contiguous()

    def run():
        if mesh.size == 1:
            with torch.no_grad():
                return model(x)
        return spatial.spatial_apply(model, x, HEIGHT, mesh)

    with no_tf32():
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        spatial.reset_counts()
        out = run()
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        exch = dict(spatial.counts)
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(SPACE_REPEATS):
            run()
        end.record()
        torch.cuda.synchronize(dev)
    convs = sum(1 for m in model.modules() if isinstance(m, Conv)
                and m.weight.shape[-1] > 1)
    return {"out": out, "peak": peak, "ms": start.elapsed_time(end)
            / SPACE_REPEATS, "convs": convs, **exch}


def _space_rank(rank: int, store: str, ref_dir: str, out_dir: str) -> None:
    """One rank of phase 4i (b) (spawned): gloo on the card cuda:0.  For
    each case its rows against the one-process output saved in `ref_dir`
    (f32: max |d| and byte-equality; bf16: u8 levels), and the digest of
    the frame gathered from both ranks."""
    import torch.distributed as dist
    init_distributed(backend="gloo", device="cuda:0",
                     init_method=f"file://{store}", rank=rank,
                     world_size=RANKS, timeout_s=PAR_JOIN_S)
    mesh = make_mesh(device="cuda:0")
    out = {}
    for name, dtype in SPACE_CASES:
        key = f"{name}-{str(dtype).split('.')[1]}"
        got = space_forward(name, dtype, mesh)
        rows = got.pop("out")
        lo, hi = row_range(4 * HEIGHT, mesh, unit=4)
        want = torch.load(os.path.join(ref_dir, key + ".pt"))[:, lo:hi].to(
            rows.device)
        levels = [generic.to_uint8((t + 1.0) / 2.0) for t in (rows, want)]
        got.update(rows=tuple(rows.shape),
                   max_abs=float((rows - want).abs().max()),
                   equal=bool(torch.equal(rows, want)),
                   u8=u8_diff(*levels),
                   gathered=digest(spatial.gather_frame(rows, HEIGHT, 4,
                                                        mesh)))
        out[key] = got
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def space_phase(smi: str) -> None:
    """Phase 4i (b) (see the module docstring)."""
    t0 = time.perf_counter()
    dev = require_cuda()
    print(f"phase 4i(b) the space axis: a 1080p frame's rows split over "
          f"{RANKS} ranks over gloo sharing the card, halos exchanged "
          f"[{smi}]:")
    one_mesh = make_mesh(device=dev)
    with tempfile.TemporaryDirectory(prefix="dgt_4i_") as tmp:
        one = {}
        for name, dtype in SPACE_CASES:
            key = f"{name}-{str(dtype).split('.')[1]}"
            got = space_forward(name, dtype, one_mesh)
            out = got.pop("out")
            torch.save(out.cpu(), os.path.join(tmp, key + ".pt"))
            got["digest"] = digest(out)
            one[key] = got
            del out
            torch.cuda.empty_cache()
        ranks = run_spawned(_space_rank, (tmp,), SPACE_RUN_S, "4i")
    for key, o in one.items():
        rs = [r[key] for r in ranks]
        f32 = key.endswith("float32")
        for r, g in enumerate(rs):
            if g["halo_exchanges"] != o["convs"]:
                raise AssertionError(f"{key} rank {r}: "
                                     f"{g['halo_exchanges']} halo exchanges,"
                                     f" not one a conv ({o['convs']})")
            if f32 and g["max_abs"] > SPACE_TOL:
                raise AssertionError(f"{key} rank {r}: max |d| "
                                     f"{g['max_abs']:.3e} > {SPACE_TOL}")
            if not f32 and (g["u8"][0] > 1 or g["u8"][1] >= BF16_ENVELOPE):
                raise AssertionError(f"{key} rank {r}: u8 {g['u8']} outside "
                                     "the bf16 envelope")
        if rs[0]["gathered"] != rs[1]["gathered"]:
            raise AssertionError(f"{key}: the gathered frames differ "
                                 "between the ranks")
        agree = ("max |d| " + " / ".join(f"{g['max_abs']:.3e}" for g in rs)
                 + f" (bound {SPACE_TOL})" if f32 else
                 "u8 levels " + " / ".join(
                     f"max {g['u8'][0]} on {g['u8'][1]:.3e}" for g in rs)
                 + f" (envelope max 1 on < {BF16_ENVELOPE})")
        print(f"  {key}: rows {rs[0]['rows'][1]} / {rs[1]['rows'][1]} of "
              f"{4 * HEIGHT} out, each rank against the one-process "
              f"forward: {agree}; byte-equal "
              f"{' / '.join(str(g['equal']) for g in rs)}; the gathered "
              f"frame equal on both ranks (byte-equal to one process: "
              f"{rs[0]['gathered'] == o['digest']})")
        print(f"    {rs[0]['halo_exchanges']} halo exchanges a forward "
              f"({rs[0]['halo_bytes'] / 1e6:.2f} MB of all_reduce buffers a "
              f"rank); peak memory a rank "
              + " / ".join(f"{g['peak'] / 2**30:.2f}" for g in rs)
              + f" GiB against one process's {o['peak'] / 2**30:.2f} GiB ("
              + " / ".join(f"{g['peak'] / o['peak']:.2f}x" for g in rs)
              + "); ms a forward (CUDA events, mean of "
              f"{SPACE_REPEATS}): one process {o['ms']:.2f}, two ranks "
              "sharing the card " + " / ".join(f"{g['ms']:.2f}" for g in rs)
              + f" [{smi}]")
    print(f"  phase 4i(b) took {time.perf_counter() - t0:.1f} s")


T0 = time.perf_counter()


def main() -> None:
    # ---- phase 1: device
    dev = require_cuda()
    smi = card.smi("name,power.limit", dev.index or 0)
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"phase 1 device: {kind}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # ---- phase 2: build
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    print(f"phase 2 build: {build_s:.1f} s (nvcc of csrc/*.cu, set-up)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print(f"  ptxas: {line.strip()}")

    rng = np.random.default_rng(SEED)
    models = {f.name: seeded_model(f, rng, dev) for f in FAMILIES}

    # ---- phase 3 / 3b / 3c: kernels vs twins at the main-path shapes
    checked = {}
    for label, fam in zip(("3", "3b"), FAMILIES):
        model = models[fam.name]
        checked[fam.name] = kernel_vs_twin(label, fam, model, dev)
        build_report(fam)
        one_sign_checks(fam, model, dev)
        exact_sums(fam, model, dev)
        if fam.name == "srgan":
            up1_sum_errors(dev)
            mbconv_sum_errors(dev)
        inputs, _, tails, _ = checked[fam.name]
        margin_shares(fam, model, inputs, tails, dev)
    inputs2, grid2, tails2, _ = checked["srgan"]
    exactly_rounded_up1(FAMILIES[1], inputs2, grid2, tails2)
    x3, blocks3, err3 = k3_vs_plain(models["fsrgan"], dev)
    # ---- phase 3d: the probes' kernels vs their plain versions
    print("phase 3d probes vs plain versions (K9 at (512, 1024), K6 at "
          f"(K, {int8_chain.M}), K8, K10, K7, K4 and K5 at the JAX shapes, "
          "K10 also at a 4K frame):")
    probe_errs = {**k9_vs_plain(dev), **k6_vs_plain(dev), **k8_vs_plain(dev),
                  **k10_vs_plain(dev)}
    k7_errs, k7_plain = k7_vs_plain(dev)
    k4_errs, k4_plain = k4_vs_plain(dev)
    k5_errs = k5_vs_plain(dev)

    # ---- phase 4 / 4b: the main paths, 1080p -> 4K
    frames = [seeded_frame(rng, HEIGHT, WIDTH, dev) for _ in range(2)]
    launches, pairs, errs = {}, {}, {}
    for label, fam in zip(("4", "4b"), FAMILIES):
        model = models[fam.name]
        launches.update(main_paths(label, fam, model, frames))
        pairs[fam.name] = engine_pair(fam, model, frames)
        errs.update(checked[fam.name][3])
        key = fam.key(fam.kernel, "w8a8")
        errs[key] = max(errs[key], pairs[fam.name][3])
        key = fam.key(fam.kernel, "qh8")
        errs[key] = max(errs[key],
                        engine_pair(fam, model, frames, qh8=True)[3])
        if fam.name == "fsrgan":
            check_plain_tail(model, rng, dev)
        else:
            check_input_options(fam, model, frames)
    # ---- phase 4c: the FSRGAN engine with the K3 body
    launches3, k3_eng, plain_eng = k3_main_path(models["fsrgan"], frames)
    # ---- phase 4d: the whole-frame quality rule
    print(f"phase 4d whole-frame quality rule ({HEIGHT}x{WIDTH}, u8 levels "
          "vs the plain bf16 generator on the whole frame):")
    for fam in FAMILIES:
        quality_rule(fam, models[fam.name], HEIGHT, WIDTH, dev, "seeded",
                     holds=False)
        model = build_generator(fam.name, device=dev)
        model = from_jax_params(model, *jax_init_tree(
            model, np.random.default_rng(SEED), fam.name))
        quality_rule(fam, model, HEIGHT, WIDTH, dev, "JAX-init", holds=True)

    # ---- phase 4e: the generic frame engine and the 1x families
    generic_engines(models, frames, smi)
    # ---- phase 4f: the CLIs on .dgt exports and an RGBA AVI
    cli_phase(models, smi)
    # ---- phase 4g: the four trainers on the card
    hr = training_phase(smi)
    # ---- phase 4h: data parallelism, two ranks sharing the card
    parallel_phase(hr, smi)
    # ---- phase 4i: a reference .h5 on the card; the space axis
    h5_phase(smi)
    space_phase(smi)

    # ---- phase 5: times
    print(f"phase 5 times [{smi}]:")
    ms = {}
    for fam in FAMILIES:
        inputs, grid, tails, _ = checked[fam.name]
        body, k_eng, t_eng, _ = pairs[fam.name]
        ms.update(times(fam, models[fam.name], frames, inputs, grid, tails,
                        body, k_eng, t_eng))

    k3 = k3_times(models["fsrgan"], frames, x3, blocks3, k3_eng, plain_eng)
    probes = probe_times(dev, smi, probe_errs) + k8_k10_times(
        dev, probe_errs) + k7_k4_times(dev, {**k7_errs, **k4_errs},
                                       {**k7_plain, **k4_plain}) + \
        k5_times(dev, k5_errs)

    kernels = []
    for fam in FAMILIES:
        inputs, _, tails, _ = checked[fam.name]
        for key in [fam.key(fam.kernel, m) for m in MODES] + \
                [fam.key(fam.canvas, "w8a8")]:
            mode = key.split(":")[1]
            b_ms, b_by = tail_bound(inputs[mode], tails[mode],
                                    canvas=key.startswith(
                                        fam.canvas.__name__))
            print(f"  {key} bound {b_ms:.3f} ms/frame ({b_by})")
            kernels.append({
                "name": key, "route": "cuda", "source": fam.source,
                "replaces": fam.replaces, "launches": launches[key],
                "max_abs_err": errs[key], "ms": ms[key][0],
                "plain_ms": ms[key][1], "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None})
    kernels.append({
        "name": "fused_mbconv", "route": "cuda",
        "source": "denoise_gan_tpu_torch/csrc/mbconv.cu",
        "replaces": "tools/exp_mbconv_kernel.py:37",
        "launches": launches3["fused_mbconv"], "max_abs_err": err3,
        "ms": k3[0], "plain_ms": k3[1], "bound_ms": k3[3],
        "bound_by": k3[4], "library_ms": None})
    record = {"kernels": kernels + probes}
    print(f"chip_smoke.py took {time.perf_counter() - T0:.1f} s")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
