"""Coarse-space rewrite of the pixel-shuffle generator tails
(denoise_gan_tpu/infer/fast.py:35-251).

``depth_to_space`` is a pure rearrangement, so a conv applied after it
equals a conv applied before it with a phase-scattered kernel.  Pushing
every tail conv down to the coarse grid keeps the tail at the body's
resolution with 4x / 16x the channels, and no fine-resolution
intermediate exists.  The rewrite is exact in real arithmetic (the same
weights, reindexed, with structural zeros), so the engines can use it
where training uses the plain modules.

A fine tensor T at scale m is held in its coarse form R[i, j, (e*m+f)*C +
c] = T[m*i+e, m*j+f, c] (the canonical layout).  A fine kxk conv becomes a
coarse conv with kernel K[r, s, idx(e',f',c), idx(e,f,o)] = W[u, v, c, o],
u = m*r + e' - e (valid where |u| <= k//2); TF's depth_to_space order
(channel (dy*block + dx)*C + c) becomes a fixed channel permutation, which
is folded into the next kernel when it is built.

The weights come from the port's generator modules (their names mirror the
Flax scopes); the numpy helpers are the port's own copies.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from denoise_gan_tpu_torch.models.fsrgan import FSRGANBody, FSRGANGenerator
from denoise_gan_tpu_torch.models.srgan import SRGANBody, SRGANGenerator
from denoise_gan_tpu_torch.ops.image import depth_to_space
from denoise_gan_tpu_torch.ops.tail import _tanh
from denoise_gan_tpu_torch.utils.device import no_tf32


def scatter_conv_kernel(W: np.ndarray, m: int) -> np.ndarray:
    """Fine (kh, kw, cin, cout) conv kernel at phase factor m -> coarse
    kernel over canonical-layout channels (m^2*cin, m^2*cout)."""
    kh, kw, cin, cout = W.shape
    kh2, kw2 = kh // 2, kw // 2
    # Coarse radius: u = m*r + e' - e must reach |u| <= k//2 for all phase
    # offsets e, e' in [0, m), so |r| <= (k//2 + m - 1) // m.
    hr = (kh2 + m - 1) // m if kh > 1 else 0
    hs = (kw2 + m - 1) // m if kw > 1 else 0
    W = np.asarray(W)
    K = np.zeros((2 * hr + 1, 2 * hs + 1, m * m * cin, m * m * cout),
                 W.dtype)
    for e in range(m):
        for ep in range(m):
            for r in range(-hr, hr + 1):
                u = m * r + ep - e
                if abs(u) > kh2:
                    continue
                for f in range(m):
                    for fp in range(m):
                        for s in range(-hs, hs + 1):
                            v = m * s + fp - f
                            if abs(v) > kw2:
                                continue
                            K[r + hr, s + hs,
                              (ep * m + fp) * cin:(ep * m + fp + 1) * cin,
                              (e * m + f) * cout:(e * m + f + 1) * cout] \
                                = W[u + kh2, v + kw2]
    return K


def d2s_perm(m: int, c_next: int) -> np.ndarray:
    """Channel permutation converting 'canonical scale-m with 4*c_next fine
    channels' into 'canonical scale-2m with c_next channels' after a
    depth_to_space(2) in fine space (TF channel order (2a+b)*C + c)."""
    P = np.zeros((2 * m) * (2 * m) * c_next, np.int64)
    for e in range(m):
        for f in range(m):
            for a in range(2):
                for b in range(2):
                    base_new = ((2 * e + a) * (2 * m) + (2 * f + b)) * c_next
                    base_old = (e * m + f) * (4 * c_next) \
                        + (2 * a + b) * c_next
                    for cc in range(c_next):
                        P[base_new + cc] = base_old + cc
    return P


def _hwio(conv: nn.Module) -> np.ndarray:
    """A port conv's OIHW weight as the Flax (kh, kw, in, out) kernel."""
    return conv.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0)


def _np(a) -> np.ndarray:
    return a.detach().float().cpu().numpy()


class CoarseTail(nn.Module):
    """The coarse tail (JAX: the ``tail`` closure of build_coarse_tail).
    NHWC (N, H, W, C) body output -> (N, H, W, 3*m^2) phase channels in
    `out_dtype`, tanh'd in f32, or with `final_d2s` the (N, mH, mW, 3)
    image.  Each 2x stage is a conv (dense, or at m = 2 the m^2 exact
    per-output-phase 2x2 convs, 2.25x fewer products), its bias, and
    PReLU with the permuted slopes; all computed in `dtype`, the bias added
    after the conv as Flax does.  The tanh is single-threaded on the CPU
    (ops/tail.py::_tanh), so the phase channels and the image agree."""

    def __init__(self, stages, final: tuple[np.ndarray, np.ndarray],
                 scale: int, dtype: torch.dtype, final_d2s: bool,
                 out_dtype: torch.dtype, device: torch.device):
        super().__init__()
        self.dtype, self.scale = dtype, scale
        self.final_d2s, self.out_dtype = final_d2s, out_dtype

        def oihw(k):
            return torch.from_numpy(np.ascontiguousarray(
                k.transpose(3, 2, 0, 1))).to(device, dtype)

        def vec(v):
            return torch.from_numpy(np.asarray(v, np.float32)).to(
                device, dtype).view(1, -1, 1, 1)

        self.stages = [(kind, [oihw(k) for k in ks], vec(b), vec(alpha))
                       for kind, ks, b, alpha in stages]
        self.final = (oihw(final[0]), vec(final[1]))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        x = h.permute(0, 3, 1, 2).to(self.dtype)
        for kind, ks, b, alpha in self.stages:
            if kind == "phased":
                # phase (a, c) pads rows (1 - a, a) and columns (1 - c, c):
                # a window of the input padded by one on every side
                xp = F.pad(x, (1, 1, 1, 1))
                hh, ww = x.shape[-2:]
                x = torch.cat([F.conv2d(xp[:, :, a:a + hh + 1, c:c + ww + 1],
                                        k)
                               for (a, c), k in zip(_PHASES, ks)], dim=1) + b
            else:
                k = ks[0]
                x = F.conv2d(x, k, padding=k.shape[-1] // 2) + b
            x = torch.where(x >= 0, x, alpha * x)
        k, b = self.final
        y = F.conv2d(x, k, padding=k.shape[-1] // 2) + b
        y = _tanh(y.float()).to(self.out_dtype).permute(0, 2, 3, 1)
        return depth_to_space(y, self.scale) if self.final_d2s else y


_PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def build_coarse_tail(tail: nn.Module, stage_names: list[str],
                      dtype: torch.dtype = torch.bfloat16,
                      final_d2s: bool = True,
                      out_dtype: torch.dtype = torch.float32) -> CoarseTail:
    """The coarse tail of a port tail module (FSRGANTail, SRGANTail): its
    2x pixel-shuffle stages `stage_names` (each ``Conv_0`` + ``PReLU_0``)
    and ``out_conv``, on the module's device.  Returns a module h -> [-1, 1]
    image at scale 2^len(stage_names) (phase channels unless
    `final_d2s`)."""
    # Every channel permutation (TF depth_to_space order between stages)
    # is folded into the next conv's kernel here: each stage's output stays
    # in its raw (pre-permutation) layout, the following kernel's input
    # axis is inverse-permuted, and the PReLU slopes are permuted vectors.
    stages = []
    pend = None          # canonical = raw[pend] for the current tensor
    m = 1
    for name in stage_names:
        stage = getattr(tail, name)
        W, b = _hwio(stage.Conv_0), _np(stage.Conv_0.bias)
        alpha = _np(stage.PReLU_0.alpha)
        c_next = W.shape[-1] // 4
        K = scatter_conv_kernel(W, m) if m > 1 else W
        if pend is not None:
            K = np.take(K, np.argsort(pend), axis=2)
        bias = np.tile(b, m * m)
        Q = d2s_perm(m, c_next)
        alpha_t = np.tile(alpha, (2 * m) * (2 * m))[np.argsort(Q)]
        # At m = 2 the dense scattered 3x3 kernel is mostly structural
        # zeros: split it into the m^2 per-output-phase 2x2 convs (phase
        # a's taps live in rows [a, a+2)).  A fine kernel wider than 3
        # gives a coarse radius of 2, which cannot split.
        if m == 2 and K.shape[:2] == (3, 3):
            blk = K.shape[-1] // (m * m)
            ks = [K[a:a + 2, c:c + 2, :, (m * a + c) * blk:
                    (m * a + c + 1) * blk] for a, c in _PHASES]
            stages.append(("phased", ks, bias, alpha_t))
        else:
            stages.append(("dense", [K], bias, alpha_t))
        pend = Q
        m *= 2
    K_f = scatter_conv_kernel(_hwio(tail.out_conv), m)
    if pend is not None:
        K_f = np.take(K_f, np.argsort(pend), axis=2)
    b_f = np.tile(_np(tail.out_conv.bias), m * m)
    return CoarseTail(stages, (K_f, b_f), m, dtype, final_d2s, out_dtype,
                      tail.out_conv.weight.device)


def _stage_names(model: nn.Module) -> list[str] | None:
    """The tail's 2x stage names of a FSRGAN or SRGAN generator (with at
    least one stage), else None."""
    if isinstance(model, FSRGANGenerator):
        return ["up1", "up2"]
    if isinstance(model, SRGANGenerator) and model.tail.stages:
        return [f"up{i + 1}" for i in range(model.tail.stages)]
    return None


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _body(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """The generator's body computed in `dtype`, with its weights, on its
    device."""
    if isinstance(model, FSRGANGenerator):
        body = FSRGANBody(model.body.gf, model.body.n_residual_blocks,
                          dtype=dtype)
    else:
        body = SRGANBody(model.body.num_res_blocks, model.body.filters,
                         dtype=dtype)
    body.load_state_dict(model.body.state_dict())
    return body.to(_device(model)).eval()


def build_fast_coarse(model: nn.Module, dtype: torch.dtype = torch.bfloat16,
                      out_dtype: torch.dtype = torch.float32
                      ) -> tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """(forward_coarse, scale) for the frame engine: the body and the
    coarse tail WITHOUT the final depth_to_space, (N, T, T, 3) [-1, 1] ->
    (N, T, T, 3*scale^2) phase channels in `out_dtype`, on the model's
    device, computed in `dtype` (the JAX default bf16; f32 runs with TF32
    off).  FSRGAN (4x) and SRGAN (2x or 4x) only; another model raises
    ValueError."""
    names = _stage_names(model)
    if names is None:
        raise ValueError(f"no coarse path for {type(model).__name__}")
    body = _body(model, dtype)
    tail = build_coarse_tail(model.tail, names, dtype, final_d2s=False,
                             out_dtype=out_dtype)

    @torch.inference_mode()
    def forward_coarse(x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return tail(body(x))

    return forward_coarse, tail.scale


def build_fast_forward(model: nn.Module, dtype: torch.dtype = torch.bfloat16
                       ) -> Callable[[torch.Tensor], torch.Tensor]:
    """NHWC -> NHWC generator forward on the model's device in `dtype`
    (bf16, or f32 with TF32 off): FSRGAN and SRGAN through the coarse-tail
    rewrite; the other families (the 1x autoencoder and pix2pix) through
    their plain module."""
    names = _stage_names(model)
    if names is not None:
        net = nn.Sequential(_body(model, dtype),
                            build_coarse_tail(model.tail, names, dtype))
    else:
        net = type(model)(dtype=dtype if dtype == torch.bfloat16 else None)
        net.load_state_dict(model.state_dict())
        net = net.to(_device(model)).eval()

    @torch.inference_mode()
    def forward(x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return net(x)

    return forward
