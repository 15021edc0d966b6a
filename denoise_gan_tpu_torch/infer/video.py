"""Streaming video CLI (denoise_gan_tpu/infer/video.py), the inference
north star: a video is denoised (1x families) or upscaled 4x (FSRGAN,
SRGAN) frame by frame through the engines of the port.

The engine is chosen as the JAX CLI chooses it (video.py:142-291):
- ``--fast 1``, a 1x family, ``--tile`` > 0: the crop-stitched frame
  engine (infer/engine.py) with the plain generator per tile, at the
  family's measured tile geometry (TILE_DEFAULTS); uint8 out when not
  scoring, BGR out when writing unscored through cv2.
- ``--fast 1``, FSRGAN or SRGAN 4x: the fused-tail kernel engine
  (infer/kernel_engine.py: K1 or K2), on by default where the device is
  CUDA (``--kernel_tail -1``); uint8 BGR input when not scoring, BGR out
  when writing through cv2; a w8a8 tail (``--q8`` -1 or 1) or qh8 (2)
  calibrated on 4 frames spread across the clip, or bf16 (0).  Otherwise
  the coarse-tail frame engine (infer/fast.py + infer/engine.py).
- ``--fast 0``: the plain f32 generator over overlapping tiles
  (infer/tile.py), or on the whole frame padded to multiples of 256
  (``--tile 0``).
Scoring (``--score``) takes PSNR and SSIM of the engine's output against
``--clean_video`` or the bicubic-upscaled input, every ``--score_every``
frames (auto: 8 on the kernel engine, else every frame).

Frames stream in through a reader thread (a queue of 8, pinned host
memory on the card), ``--pipeline`` frames stay in flight with their
device-to-host copy as the only sync point, and a writer thread (a queue
of 4) writes the output; its errors are raised at the end.  For the AVI
writer the engines emit RGB and the frames are packed to RGBA on the
device, before the copy; for cv2's they emit BGR where they can, and are
flipped on the device where they cannot.

Containers: the uncompressed RGBA AVI is read and written in plain Python
(io/avi.py), as the machine with the card has no cv2; any other input or
output container needs cv2.  The flags are the JAX CLI's, plus
``--device`` (the card by default).
"""

from __future__ import annotations

import collections
import os
import queue
import threading
import time
from argparse import ArgumentParser

import numpy as np
import torch

from denoise_gan_tpu_torch.infer import kernel_engine as ke
from denoise_gan_tpu_torch.infer.engine import build_frame_engine, to_uint8
from denoise_gan_tpu_torch.infer.fast import build_fast_coarse
from denoise_gan_tpu_torch.infer.image import build_forward, upscales
from denoise_gan_tpu_torch.infer.tile import tiled_apply
from denoise_gan_tpu_torch.io import avi
from denoise_gan_tpu_torch.ops.image import (resize_bicubic,
                                             resize_with_crop_or_pad)
from denoise_gan_tpu_torch.ops.metrics import psnr, ssim
from denoise_gan_tpu_torch.utils.config import get_path
from denoise_gan_tpu_torch.utils.device import resolve_device

decode_fourcc = avi.decode_fourcc


class _Cv2Reader:
    """cv2.VideoCapture behind VideoReader's interface."""

    def __init__(self, path: str):
        import cv2
        self._cap = cv2.VideoCapture(path)
        self._pos = cv2.CAP_PROP_POS_FRAMES
        self.frame_count = int(self._cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.width = int(self._cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self._cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.fps = self._cap.get(cv2.CAP_PROP_FPS)
        self.fourcc = int(self._cap.get(cv2.CAP_PROP_FOURCC))

    def read(self):
        return self._cap.read()

    def seek(self, index: int) -> None:
        self._cap.set(self._pos, index)

    def release(self) -> None:
        self._cap.release()


def _need_cv2(path: str, why: str):
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: {why}; without cv2 only the uncompressed RGBA AVI "
            "(fourcc 'RGBA', 32 bits, as cv2.VideoWriter_fourcc(*'RGBA') "
            "writes it) is supported") from None
    return cv2


def open_video(path: str):
    """A reader of `path` (read, seek, release; frame_count, fps, width,
    height, fourcc): io/avi.py for an RGBA AVI, cv2 for anything else."""
    try:
        return avi.VideoReader(path)
    except avi.UnsupportedVideo as e:
        _need_cv2(path, str(e))
        return _Cv2Reader(path)


def writes_avi(path: str) -> bool:
    """Whether open_writer(path) writes the RGBA AVI (io/avi.py)."""
    return path.lower().endswith(".avi")


def open_writer(path: str, fps: float, size: tuple[int, int]):
    """A writer of BGR uint8 frames (write, release): the RGBA AVI for
    ``.avi`` (which also takes RGBA bytes, write_rgba), else cv2's mp4v,
    as the JAX CLI writes."""
    if writes_avi(path):
        return avi.VideoWriter(path, fps, size)
    cv2 = _need_cv2(path, "writing a container other than .avi needs cv2")
    return cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)


def get_video_info(video_path: str):
    """(frames, fps, width, height, fourcc), printed as the JAX CLI prints
    them."""
    video = open_video(get_path(video_path))
    num_frames, fps = video.frame_count, video.fps
    frame_width, frame_height, fourcc = video.width, video.height, \
        video.fourcc
    video.release()
    print(f"frames: {num_frames}, fps: {fps}, width: {frame_width}, "
          f"height: {frame_height}, fourcc: {decode_fourcc(fourcc)}/{fourcc}")
    return num_frames, fps, frame_width, frame_height, fourcc


def _rgb01(frame_bgr: np.ndarray) -> np.ndarray:
    """A decoded BGR uint8 frame as RGB f32 [0, 1], divided on the host."""
    return frame_bgr[..., ::-1].astype(np.float32) / 255.0


def _peek_calib_frames(input_path: str, frame_start: int, n: int = 4):
    """Up to `n` frames spread across the clip (RGB [0, 1]) for the int8
    tail's calibration, at the JAX CLI's positions (video.py:62-98);
    None when none decodes."""
    cap = open_video(input_path)
    total = cap.frame_count
    frames = []
    if total > 0:
        span = max(total - frame_start, 1)
        positions = sorted({frame_start + (span * k) // n for k in range(n)})
        for pos in positions:
            if pos:
                cap.seek(pos)
            ok, frame = cap.read()
            if ok:
                frames.append(_rgb01(frame))
    else:
        # no frame count (some containers through cv2): every stride-th
        # frame of a bounded sequential scan
        stride, scan_cap = 24, 24 * n * 4
        for i in range(frame_start + scan_cap):
            ok, frame = cap.read()
            if not ok:
                break
            if i >= frame_start and (i - frame_start) % stride == 0:
                frames.append(_rgb01(frame))
                if len(frames) >= n:
                    break
        if frames:
            print(f"note: container reports no frame count; q8 calibration "
                  f"sampled {len(frames)} frame(s) sequentially", flush=True)
    cap.release()
    return frames or None


def _reader(cap, q: queue.Queue, max_frames: int, raw_bgr: bool = False,
            pin: bool = False):
    """Decode frames into `q` as CPU tensors, then None (or the exception
    that stopped it, for the consumer to raise): the decoder's BGR uint8
    frame verbatim (raw_bgr, for the u8/BGR-input engine), else RGB f32
    [0, 1]; in pinned memory with `pin`."""
    count = 0
    try:
        while max_frames <= 0 or count < max_frames:
            ret, frame = cap.read()
            if not ret:
                break
            t = torch.from_numpy(frame if raw_bgr else _rgb01(frame))
            q.put(t.pin_memory() if pin else t)
            count += 1
    except Exception as e:  # noqa: BLE001 - raised again by the consumer
        q.put(e)
        return
    q.put(None)


# The JAX CLI's crop-engine (tile, overlap) per family at 1080p
# (tools/sweep_tile_defaults.py).  pix2pix's U-Net needs tile % 256 == 0;
# the 4x rows apply to the coarse engine only (the kernel engine has a
# fixed geometry).
TILE_DEFAULTS = {
    "autoencoder": (128, 8),
    "pix2pix": (256, 8),
    "fsrgan": (144, 4),
    "srgan": (144, 4),
}


def resolve_tile_defaults(args, family: str) -> None:
    """--tile/--tile_overlap -1 (auto) take the family's TILE_DEFAULTS;
    explicit values (--tile 0: whole frame) stay as given."""
    t, ov = TILE_DEFAULTS.get(family, (256, 32))
    if args.tile < 0:
        args.tile = t
    if args.tile_overlap < 0:
        args.tile_overlap = ov


def _rgba(frame: torch.Tensor) -> torch.Tensor:
    """An (H, W, 3) uint8 RGB frame as (H, W, 4) RGBA bytes, A = 255, on
    its device: the AVI writer's form, packed on the card before the copy
    to the host, so that the writer thread only writes."""
    out = torch.full((*frame.shape[:2], 4), 255, dtype=torch.uint8,
                     device=frame.device)
    out[..., :3] = frame
    return out


def _levels(device: torch.device) -> torch.Tensor:
    """u / 255 for u = 0..255, divided on the host (the card's division by
    a scalar multiplies by the reciprocal)."""
    return (torch.arange(256, dtype=torch.float32) / 255.0).to(device)


def process_video(args) -> dict:
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    input_path = get_path(args.input_video)
    num_frames, fps, fw, fh, _ = get_video_info(input_path)
    config, model, forward = build_forward(get_path(args.model),
                                           fast=bool(args.fast), device=dev)
    family = config.get("family")
    up = upscales(config)
    scale = config["scale"] if up else 1
    resolve_tile_defaults(args, family or "")

    # the AVI writer takes RGBA bytes, packed on the device (_rgba); cv2's
    # takes BGR, which the uint8 engines emit themselves where they can
    rgba_out = bool(args.output_video) and writes_avi(args.output_video)
    cv2_out = bool(args.output_video) and not rgba_out
    engine = None
    engine_flat = engine_kernel = engine_bgr = engine_u8_in = False
    engine_name = "whole-frame" if not args.tile else "plain-tiled"
    score_every = args.score_every
    if args.fast and args.tile > 0 and not up:
        # 1x families: the crop-stitched frame engine, the plain generator
        # per tile; BGR out when writing unscored through cv2
        flat = not args.score
        engine_bgr = flat and cv2_out
        engine = build_frame_engine(
            forward, fh, fw, 1, args.tile, args.tile_overlap,
            out_uint8=flat, stitch=args.stitch,
            acc_dtype=torch.bfloat16 if args.engine_bf16 else torch.float32,
            bgr=engine_bgr, device=dev)
        engine_flat = flat
        engine_name = (f"torch-crop ({args.tile}/{args.tile_overlap})"
                       + (", bgr out" if engine_bgr else ""))
        if args.kernel_tail == 1:
            print("note: --kernel_tail 1 ignored — the fused kernel engine "
                  f"exists only for fsrgan/srgan 4x (family={family}, "
                  "scale=1); using the crop engine", flush=True)
    if args.fast and up:
        use_kernel = (args.kernel_tail != 0 if args.kernel_tail >= 0
                      else cuda)
        kernel_ok = args.tile > 0 and scale == 4 and \
            family in ("fsrgan", "srgan")
        if use_kernel and kernel_ok:
            build = (ke.build_fsrgan_kernel_engine if family == "fsrgan"
                     else ke.build_srgan_kernel_engine)
            # BGR bytes out when writing through cv2, the decoder's BGR
            # uint8 frame in when not scoring
            engine_bgr = cv2_out
            bkw = {"bgr": engine_bgr}
            engine_u8_in = not args.score
            if engine_u8_in:
                bkw["u8_input"] = True
                bkw["bgr_input"] = True
            if args.q8 != 0:
                calib = _peek_calib_frames(input_path, args.frame_start)
                if calib is not None:
                    bkw["q8_calib_frame"] = [torch.from_numpy(f).to(dev)
                                             for f in calib]
                    bkw["qh8"] = args.q8 == 2
                elif args.q8 in (1, 2):
                    print(f"note: --q8 {args.q8} ignored — could not decode "
                          "a calibration frame; using the bf16 tail",
                          flush=True)
            engine = build(model, fh, fw, **bkw)
            engine_flat = engine_kernel = True
            engine_name = (f"fused-kernel ({family} 4x"
                           + ((", w8a8+h8 tail" if bkw.get("qh8")
                               else ", w8a8 tail")
                              if "q8_calib_frame" in bkw else "")
                           + (", u8/bgr in" if engine_u8_in else "")
                           + (", bgr out" if engine_bgr else "")
                           + "; fixed 124/120 tile geometry — --tile/"
                             "--tile_overlap/--stitch not used)")
        else:
            if args.kernel_tail == 1 and not kernel_ok:
                print("note: --kernel_tail 1 ignored — the fused kernel "
                      "engine needs --tile > 0, scale 4 and family fsrgan/"
                      f"srgan (got tile={args.tile}, scale={scale}, family="
                      f"{family}); using the coarse engine", flush=True)
            flat = not args.score
            eng_dt = torch.bfloat16 if args.engine_bf16 else torch.float32
            try:
                fwd_coarse, scale = build_fast_coarse(model, out_dtype=eng_dt)
            except ValueError:          # a model with no coarse path
                fwd_coarse = None
            if fwd_coarse is not None:
                engine = build_frame_engine(
                    fwd_coarse, fh, fw, scale, args.tile, args.tile_overlap,
                    out_uint8=flat, stitch=args.stitch, acc_dtype=eng_dt,
                    device=dev)
                engine_flat = flat
                engine_name = (f"torch-{args.stitch} coarse "
                               f"({args.tile}/{args.tile_overlap})")
    if score_every <= 0:
        score_every = 8 if (engine_kernel and args.score) else 1
    print(f"engine: {engine_name}"
          + (f"; scoring every {score_every}th frame on device"
             if args.score else "; scoring off"), flush=True)

    cap = open_video(input_path)
    if args.frame_start:
        cap.seek(args.frame_start)

    writer = writer_q = writer_thread = None
    writer_err: list = []
    if args.output_video:
        out_path = get_path(args.output_video)
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        writer = open_writer(out_path, fps or 25.0, (fw * scale, fh * scale))
        # the writer runs in its own thread behind a bounded queue, so
        # that writing overlaps the device work and the next copies
        writer_q = queue.Queue(maxsize=4)
        write = writer.write_rgba if rgba_out else writer.write

        def _writer_worker():
            while True:
                item = writer_q.get()
                if item is None:
                    break
                if not writer_err:
                    try:
                        write(item)
                    except Exception as e:  # noqa: BLE001
                        writer_err.append(e)   # keep draining; raise at end

        writer_thread = threading.Thread(target=_writer_worker, daemon=True)
        writer_thread.start()

    def writer_form(out_u8):
        # a uint8 output, BGR where engine_bgr else RGB, on the device, in
        # the form its writer takes
        if rgba_out:
            return _rgba(out_u8)
        return out_u8 if engine_bgr else out_u8.flip(-1)

    clean_cap = None
    if args.clean_video:
        clean_cap = open_video(get_path(args.clean_video))
        if args.frame_start:
            clean_cap.seek(args.frame_start)

    # the whole-frame path (the reference's mode): pad to multiples of 256
    pad_h = (fh + 255) // 256 * 256
    pad_w = (fw + 255) // 256 * 256

    def whole_frame(x01):
        xin = resize_with_crop_or_pad(x01, pad_h, pad_w) * 2.0 - 1.0
        out = forward(xin[None])[0]
        out01 = ((out + 1.0) / 2.0).clamp(0.0, 1.0)
        return resize_with_crop_or_pad(out01, fh * scale, fw * scale)

    def score(out01, ref01):
        a, b = out01[None], ref01[None]
        return float(psnr(a, b)[0]), float(ssim(a, b)[0])

    def upscale_ref(x01):
        if scale == 1:
            return x01
        return resize_bicubic(x01[None], fh * scale,
                              fw * scale)[0].clamp(0.0, 1.0)

    levels = _levels(dev)

    def score_u8(out_u8, ref01):
        # the engine's uint8 output; PSNR/SSIM are invariant under a
        # channel permutation applied to both, so a BGR output is held
        # against the flipped reference
        if engine_bgr:
            ref01 = ref01.flip(-1)
        return score(levels[out_u8.long()], ref01)

    q: queue.Queue = queue.Queue(maxsize=8)
    threading.Thread(target=_reader,
                     args=(cap, q, args.max_frames, engine_u8_in, cuda),
                     daemon=True).start()

    frames = submitted = scored = 0
    psnr_sum = ssim_sum = 0.0
    t0 = time.time()
    # uint8 engine outputs in flight: each one's copy to pinned host
    # memory is queued behind it, and waited for `args.pipeline` frames
    # later
    inflight = collections.deque()

    def _to_host(out: torch.Tensor):
        if not cuda:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _drain_one():
        nonlocal frames
        host, done = inflight.popleft()
        if done is not None:
            done.synchronize()
        if writer_q is not None:
            writer_q.put(host.numpy())
        frames += 1
        if args.verbose:
            print(f"frame {frames}", flush=True)

    while True:
        frame01 = q.get()
        if frame01 is None:
            break
        if isinstance(frame01, Exception):
            raise frame01
        x = frame01.to(dev, non_blocking=True)
        # keep the clean reference in frame sync whatever the cadence
        clean_ref = None
        if args.score and clean_cap is not None:
            ok, clean = clean_cap.read()
            if ok:
                clean_ref = torch.from_numpy(_rgb01(clean)).to(dev)
        if engine is not None:
            out = engine(x)
            if engine_flat:
                if args.score and engine_kernel \
                        and submitted % score_every == 0:
                    ref = clean_ref if clean_ref is not None \
                        else upscale_ref(x)
                    p, s = score_u8(out, ref)
                    psnr_sum += p
                    ssim_sum += s
                    scored += 1
                submitted += 1
                inflight.append(_to_host(writer_form(out) if writer_q
                                         is not None else out))
                if len(inflight) > max(args.pipeline, 0):
                    _drain_one()
                continue
            out01 = out
        elif args.tile:
            out01 = tiled_apply(forward, x * 2.0 - 1.0, args.tile,
                                args.tile_overlap, scale,
                                batch=args.tile_batch)
            out01 = ((out01 + 1.0) / 2.0).clamp(0.0, 1.0)
        else:
            out01 = whole_frame(x)

        if args.score and submitted % score_every == 0:
            ref = clean_ref if clean_ref is not None else upscale_ref(x)
            p, s = score(out01, ref)
            psnr_sum += p
            ssim_sum += s
            scored += 1
        submitted += 1

        if writer_q is not None:
            # rounded (+0.5) as the engines' uint8 output
            writer_q.put(writer_form(to_uint8(out01)).cpu().numpy())
        frames += 1
        if args.verbose:
            print(f"frame {frames}", flush=True)

    while inflight:
        _drain_one()
    if cuda:
        torch.cuda.synchronize(dev)
    if writer_q is not None:
        writer_q.put(None)
        writer_thread.join()
    elapsed = time.time() - t0
    if writer is not None:
        writer.release()
        if writer_err:
            raise writer_err[0]
    cap.release()
    if clean_cap is not None:
        clean_cap.release()

    result = {
        "frames": frames,
        "seconds": elapsed,
        "fps": frames / max(elapsed, 1e-9),
        "scored_frames": scored,
        "psnr": psnr_sum / scored if args.score and scored else None,
        "ssim": ssim_sum / scored if args.score and scored else None,
    }
    print(f"processed {frames} frames in {elapsed:.2f}s "
          f"({result['fps']:.2f} fps/chip)"
          + (f", psnr={result['psnr']:.2f}, ssim={result['ssim']:.4f} "
             f"({scored} frames scored)"
             if args.score and scored else ""))
    return result


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="denoise_gan_tpu_torch video "
                                        "inference")
    parser.add_argument("--input_video", default="./video_in/in.mp4",
                        type=str, help="Path to input video")
    parser.add_argument("--output_video", default="./video_out/out.mp4",
                        type=str, help="Path to output high res video "
                                       "(.avi: uncompressed RGBA, written "
                                       "without cv2; else mp4v by cv2)")
    parser.add_argument("--model", default="./models/fsrgan.dgt", type=str,
                        help="Path to a .dgt export or a reference "
                             "Keras .h5 (read directly, family "
                             "auto-detected)")
    parser.add_argument("--frame_start", default=0, type=int)
    parser.add_argument("--max_frames", default=0, type=int)
    parser.add_argument("--tile", default=-1, type=int,
                        help="frame-engine tile size; -1 = auto (per-family "
                             "optimum, e.g. 128 for autoencoder); 0 = "
                             "whole-frame mode (reference behavior)")
    parser.add_argument("--tile_overlap", default=-1, type=int,
                        help="-1 = auto (per-family optimum)")
    parser.add_argument("--stitch", default="crop",
                        choices=["crop", "feather"],
                        help="tile stitching: hard-cut center crop or "
                             "feathered overlap-add")
    parser.add_argument("--tile_batch", default=0, type=int)
    parser.add_argument("--score", default=1, type=int,
                        help="compute PSNR/SSIM on the device (vs the "
                             "bicubic-upscaled input, or --clean_video); "
                             "with the fused kernel engine from its uint8 "
                             "output every --score_every frames")
    parser.add_argument("--score_every", default=0, type=int,
                        help="score every Nth frame; 0 = auto (8 on the "
                             "fused kernel engine, else every frame)")
    parser.add_argument("--clean_video", default="", type=str,
                        help="optional ground-truth video for scoring")
    parser.add_argument("--fast", default=1, type=int,
                        help="coarse-space bf16 inference rewrite "
                             "(infer/fast.py)")
    parser.add_argument("--pipeline", default=2, type=int,
                        help="frames kept in flight on the device in the "
                             "uint8 engine path (0 = sync every frame)")
    parser.add_argument("--engine_bf16", default=1, type=int,
                        help="bf16 tail/stitch in the frame engine "
                             "(0 = f32)")
    parser.add_argument("--kernel_tail", default=-1, type=int,
                        help="fused tail kernel engine (fsrgan/srgan 4x): "
                             "1=force, 0=off, -1=auto (on where the device "
                             "is CUDA). Uses a fixed 124/120 tile geometry; "
                             "--tile/--tile_overlap/--stitch are not used "
                             "by this engine (a notice is printed if 1 "
                             "cannot be honored)")
    parser.add_argument("--q8", default=-1, type=int,
                        help="int8 tail in the fused kernel engine (fsrgan/"
                             "srgan 4x), activation scales calibrated on 4 "
                             "frames spread across the clip: -1 = auto "
                             "(w8a8 when the kernel engine is used), 0 = "
                             "bf16 tail, 1 = w8a8, 2 = qh8 (w8a8 + int8 h "
                             "+ w8a8 up1)")
    parser.add_argument("--verbose", default=0, type=int)
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device (cuda by default; cpu runs the "
                             "kernels' plain twins)")
    return parser


def main(argv=None):
    return process_video(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
