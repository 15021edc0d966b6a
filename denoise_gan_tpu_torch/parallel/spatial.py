"""The ``space`` axis: a frame's rows split over the ranks for inference
(denoise_gan_tpu/parallel/mesh.py:12-14, 91-96).

The JAX package shards H of a large frame over every device
(``spatial_sharding``) and GSPMD partitions each convolution spatially,
exchanging its halo rows with the neighbouring devices.  Here each rank
holds its ``row_range`` rows of the NHWC frame and runs the generator on
them under :func:`rows_split`: models/layers.py::Conv then takes a stride-1
SAME conv's H padding from the neighbouring ranks' rows (:func:`halo`),
and zeros only at the frame's true top and bottom.  Each rank's output
rows are then those of the unsharded forward, and its activations its
own rows plus one halo a conv.  This is not a tiling: nothing is
recomputed or feathered.

The other ops stay local: pointwise ops, eval BatchNorm, depth_to_space
(which doubles each rank's rows), max_pool_same and upsample_nearest
(each rank's rows must divide by the total stride: the autoencoder's 32)
and the skip concatenations.  FSRGAN, SRGAN and the autoencoder run so;
pix2pix, whose strided 4x4 U-Net narrows its fixed 256 rows to one, is
not ported (ROADMAP A).

The halos go through parallel/mesh.py's rule: one ``all_reduce`` of a
zeroed buffer in which each rank puts its edge rows, summed as bytes
(exact in any dtype), so that NCCL, gloo on the CPU and gloo with ranks
sharing a card run one code path.  A rank that is missing or times out
makes the collective raise; nothing gathers the frame and runs it whole.
"""

from __future__ import annotations

import contextlib

import torch

from denoise_gan_tpu_torch.parallel.mesh import (
    Mesh, all_sum, gather_rows, split_range,
)

# halo exchanges (one per stride-1 SAME conv of more than one row) and
# their buffers' bytes, since the last reset_counts
counts = {"halo_exchanges": 0, "halo_bytes": 0}

_SPLIT: Mesh | None = None


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def active() -> Mesh | None:
    """The mesh whose ranks split the rows, inside :func:`rows_split`."""
    return _SPLIT


@contextlib.contextmanager
def rows_split(mesh: Mesh):
    """Inside the block, the convs of models/layers.py take their H
    padding from the neighbouring ranks of `mesh` (:func:`halo`)."""
    global _SPLIT
    saved, _SPLIT = _SPLIT, mesh
    try:
        yield
    finally:
        _SPLIT = saved


def halo(x: torch.Tensor, before: int, after: int, stride: int
         ) -> torch.Tensor:
    """NCHW `x`, this rank's rows, with `before` rows of the rank above and
    `after` rows of the rank below put on either side of H (zeros above
    the first rank and below the last): the rows a SAME conv reads.  A
    stride other than 1 raises NotImplementedError, a rank with fewer
    rows than a halo ValueError."""
    mesh = _SPLIT
    if stride != 1:
        raise NotImplementedError(
            f"a stride-{stride} conv under the space axis (its SAME padding "
            "depends on the whole frame's rows; ROADMAP A)")
    n, c, h, w = x.shape
    if h < max(before, after):
        raise ValueError(f"rank {mesh.rank} holds {h} rows, fewer than a "
                         f"conv's halo of {max(before, after)}")
    # slot r: rank r's first `after` rows (the rank above's lower halo),
    # then its last `before` rows (the rank below's upper halo)
    buf = x.new_zeros((mesh.size, n, c, after + before, w))
    buf[mesh.rank] = torch.cat([x[:, :, :after], x[:, :, h - before:]], 2)
    all_sum(buf.view(-1).view(torch.uint8))
    counts["halo_exchanges"] += 1
    counts["halo_bytes"] += buf.numel() * buf.element_size()
    r = mesh.rank
    top = (buf[r - 1, :, :, after:] if r > 0 else
           x.new_zeros((n, c, before, w)))
    bottom = (buf[r + 1, :, :, :after] if r < mesh.size - 1 else
              x.new_zeros((n, c, after, w)))
    fmt = (torch.channels_last
           if x.is_contiguous(memory_format=torch.channels_last)
           and not x.is_contiguous() else torch.contiguous_format)
    return torch.cat([top, x, bottom], 2).contiguous(memory_format=fmt)


def _row_multiple(model: torch.nn.Module) -> int:
    """The rows each rank's part must be a multiple of for `model`:
    NotImplementedError for pix2pix."""
    from denoise_gan_tpu_torch.models.autoencoder import AutoencoderGenerator
    from denoise_gan_tpu_torch.models.pix2pix import Pix2PixGenerator
    if isinstance(model, Pix2PixGenerator):
        raise NotImplementedError(
            "pix2pix under the space axis: its strided 4x4 U-Net narrows "
            "the fixed 256-row input to one row (ROADMAP A, 'pix2pix under "
            "space')")
    return 32 if isinstance(model, AutoencoderGenerator) else 1


def spatial_apply(model: torch.nn.Module, x_rows: torch.Tensor,
                  n_rows: int, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of the generator's output (eval mode, no
    gradient), from its ``row_range(n_rows, mesh)`` rows `x_rows` of an
    NHWC frame of `n_rows` rows: the unsharded forward's rows, each conv's
    halo exchanged with the neighbouring ranks.  ``gather_frame``
    assembles the whole output.  Every rank checks every rank's split
    before the first exchange, so they raise together: ValueError where
    `x_rows` is not this rank's share, where a share is not a multiple of
    the autoencoder's 32 rows, or a model is in train mode;
    NotImplementedError for pix2pix."""
    unit = _row_multiple(model)
    shares = [hi - lo for lo, hi in (split_range(n_rows, r, mesh.size)
                                     for r in range(mesh.size))]
    if any(s % unit or s == 0 for s in shares):
        raise ValueError(f"{n_rows} rows split over {mesh.size} ranks as "
                         f"{shares}: each share must be a non-zero "
                         f"multiple of {unit} rows for "
                         f"{type(model).__name__}")
    if x_rows.shape[1] != shares[mesh.rank]:
        raise ValueError(f"rank {mesh.rank} holds {x_rows.shape[1]} rows, "
                         f"not its {shares[mesh.rank]} of {n_rows}")
    if any(m.training for m in model.modules()):
        raise ValueError("spatial_apply runs the model in eval mode: "
                         "call model.eval() first")
    with torch.no_grad(), rows_split(mesh):
        return model(x_rows)


def gather_frame(out_rows: torch.Tensor, n_rows: int, scale: int,
                 mesh: Mesh) -> torch.Tensor:
    """The whole NHWC output on every rank, from each rank's
    ``spatial_apply`` rows of a frame of `n_rows` input rows upscaled
    `scale` times (parallel/mesh.py::gather_rows, exact)."""
    rows = gather_rows(out_rows.transpose(0, 1), n_rows * scale, mesh,
                       unit=scale)
    return rows.transpose(0, 1)
