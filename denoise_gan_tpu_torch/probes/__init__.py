"""Hopper counterparts of the JAX package's TPU hardware probes
(tools/exp_*.py).

Each module ports one probe: its kernels are hand-written CUDA in ``csrc/``
with plain PyTorch versions beside them, and its ``main`` times them on the
card at the JAX probe's shapes.  No frame path runs them.

* ``fma_peak``: tools/exp_vpu_peak.py (K9), the CUDA cores' FFMA peak and
  the cost of a warp-shuffle roll + FMA, and cuBLAS at the probe's matmul
  shapes.
* ``int8_chain``: tools/exp_int8_mosaic.py (K6), chained bf16 vs int8
  tensor-core dots at the tails' contraction depths.
* ``relayout``: tools/exp_relayout.py (K8), tensor-core products with a
  K-major or an MN-major operand (``ldmatrix`` vs ``ldmatrix.trans``) at
  the tails' shapes, and a chain of in-kernel transposes.
* ``u8_store``: tools/exp_u8_store.py (K10), the tails' tanh -> u8
  epilogue and its four-phase split alone, up to a 4K frame.
* ``overlap``: tools/exp_overlap_probe.py (K7), a tensor-core product
  chain and a warp-shuffle roll + FMA chain, alone and interleaved in one
  loop body: whether one SM's tensor and CUDA cores overlap.
* ``dw_forms``: tools/exp_dw_forms.py (K4), a chained 3x3 depthwise on a
  192-channel band in four forms (rolled copies, rolls as addresses, a
  register window with shuffles, weight planes).
* ``mbpipe``: tools/exp_mbpipe.py (K5), one inverted-residual band step
  (expand and project on tensor cores, the depthwise on CUDA cores), one
  chain against two chains on separate warps of a CTA, with their own
  barriers or one barrier with their phases aligned or offset: whether
  the two units overlap on separate warps.

Run each with ``python -m denoise_gan_tpu_torch.probes.<name>`` on a CUDA
GPU.
"""
