"""The PyTorch half of the serving tests (tests/test_torch_checkpoint.py,
test_torch_image_ops.py, test_torch_avi.py, test_torch_cli.py,
test_torch_cli_kernel.py, test_torch_image_cli.py, and the CLI tests of
test_torch_cuda.py): the ``.dgt`` reader and writer, the image ops and
metrics, the containers and the CLIs of the port.

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_serving")``), so that no pytest worker
imports torch.  They take and return numpy arrays, bytes and plain Python
values; Flax trees travel as nested dicts of numpy arrays.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys

import numpy as np
import torch

from denoise_gan_tpu_torch import unit_test as tunit
from denoise_gan_tpu_torch.data.pipeline import decode_image
from denoise_gan_tpu_torch.infer import image as timage_cli
from denoise_gan_tpu_torch.infer import kernel_engine as tke
from denoise_gan_tpu_torch.infer import video as tvideo
from denoise_gan_tpu_torch.io import avi, flax_msgpack
from denoise_gan_tpu_torch.io import checkpoint as tck
from denoise_gan_tpu_torch.io.params import from_jax_params, to_jax_trees
from denoise_gan_tpu_torch.models import build_generator
from denoise_gan_tpu_torch.ops import image as timage
from denoise_gan_tpu_torch.ops import metrics as tmetrics


def _state(model: torch.nn.Module) -> dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# io/checkpoint.py, io/params.py, io/flax_msgpack.py

def load_matches_trees(path, params, stats):
    """(config, names whose tensor differs, dtype) after load_generator on
    the CPU, against from_jax_params on the same trees (f32 arrays)."""
    config, model = tck.load_generator(path, device="cpu")
    want = from_jax_params(build_generator(config["family"], device="cpu",
                                           scale=config["scale"]),
                           params, stats)
    got, ref = _state(model), _state(want)
    return config, sorted(k for k in ref if not np.array_equal(got[k],
                                                               ref[k])), \
        str(next(model.parameters()).dtype)


def export_from_trees(path, family, scale, params, stats):
    """The port's export_generator of a model filled from the trees."""
    model = from_jax_params(build_generator(family, device="cpu",
                                            scale=scale), params, stats)
    tck.export_generator(path, family, scale, model)


def trees_round_trip(family, scale, params, stats):
    """to_jax_trees of a model filled from the trees."""
    return to_jax_trees(from_jax_params(build_generator(
        family, device="cpu", scale=scale), params, stats))


def load_refusal(path):
    """The message of load_generator's exception on `path`."""
    try:
        tck.load_generator(path, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def msgpack_dumps(tree):
    return flax_msgpack.dumps(tree)


def msgpack_loads(data):
    """loads(data), bf16 tensors as (f32 values, "bfloat16")."""
    def plain(v):
        if isinstance(v, dict):
            return {k: plain(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor):
            return v.float().numpy(), str(v.dtype)
        return v
    return plain(flax_msgpack.loads(data))


def load_on_cuda_without_gpu(path):
    try:
        tck.load_generator(path)
    except RuntimeError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# ops/image.py, ops/metrics.py, data/pipeline.py, unit_test.py

def resize_bicubic(x, height, width):
    return timage.resize_bicubic(torch.from_numpy(x), height, width).numpy()


def resize_with_crop_or_pad(x, th, tw):
    return timage.resize_with_crop_or_pad(torch.from_numpy(x), th,
                                          tw).numpy()


def psnr_ssim(a, b):
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    return tmetrics.psnr(a, b).numpy(), tmetrics.ssim(a, b).numpy()


def decode(path):
    return decode_image(path)


def denoise_median(img01):
    return tunit.denoise_median(img01)


@contextlib.contextmanager
def _no_cv2():
    """``import cv2`` fails inside the block."""
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved


def without_cv2(what, path):
    """The error of a cv2-only step with cv2 unimportable: "read" opens
    `path`, "write" opens a writer on it, "nlmeans" filters an image,
    "save" writes a PNG (PIL still works: returns None)."""
    with _no_cv2():
        try:
            if what == "read":
                tvideo.open_video(path)
            elif what == "write":
                tvideo.open_writer(path, 25.0, (8, 8))
            elif what == "nlmeans":
                tunit.denoise_nlmeans(np.zeros((8, 8, 3), np.float32))
            else:
                timage_cli.save_image_bgr(path, np.zeros((8, 8, 3)))
        except RuntimeError as e:
            return str(e)
    return None


# ---------------------------------------------------------------------------
# the CLIs

def _capture(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(argv)
    return result, out.getvalue()


def read_avi(path):
    """Every frame of an RGBA AVI, BGR."""
    r = avi.VideoReader(path)
    frames = [r.read()[1] for _ in range(r.frame_count)]
    r.release()
    return np.stack(frames)


def video_cli(argv):
    """(result dict, stdout, output frames or None) of the port's video
    CLI; the output is read back when it is an .avi."""
    result, text = _capture(tvideo.main, argv)
    out = argv[argv.index("--output_video") + 1] \
        if "--output_video" in argv else ""
    frames = read_avi(out) if out.endswith(".avi") and \
        os.path.exists(out) else None
    return result, text, frames


def video_cli_cv2(argv):
    """(stdout, the frames the port's video CLI hands cv2.VideoWriter) for
    a non-.avi output, with cv2's writer replaced by a recorder."""
    import cv2

    frames = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            pass

        def write(self, frame):
            frames.append(np.array(frame))

        def release(self):
            pass

    saved, cv2.VideoWriter = cv2.VideoWriter, Recorder
    try:
        _, text = _capture(tvideo.main, argv)
    finally:
        cv2.VideoWriter = saved
    return text, np.stack(frames)


def peek_calib(path, frame_start):
    return tvideo._peek_calib_frames(path, frame_start)


def kernel_engine_direct(model_path, video_path, frame_start, calib_at,
                         qh8=False, device="cpu"):
    """The video CLI's unscored kernel-engine output, built by hand: the
    export's generator on `device`, build_{fsrgan,srgan}_kernel_engine
    with BGR uint8 input and RGB output (the AVI writer's order), calibrated
    on the frames at positions `calib_at` (RGB [0, 1], divided on the
    host), run on every frame from `frame_start`; BGR, as the AVI reads
    back."""
    config, model = tck.load_generator(model_path, device=device)
    r = avi.VideoReader(video_path)
    frames = [r.read()[1] for _ in range(r.frame_count)]
    r.release()
    calib = [torch.from_numpy(frames[i][..., ::-1].astype(np.float32)
                              / 255.0).to(device) for i in calib_at]
    build = (tke.build_fsrgan_kernel_engine if config["family"] == "fsrgan"
             else tke.build_srgan_kernel_engine)
    h, w = frames[0].shape[:2]
    engine = build(model, h, w, q8_calib_frame=calib, qh8=qh8,
                   u8_input=True, bgr_input=True)
    return np.stack([engine(torch.from_numpy(f).to(device)).cpu().numpy()
                     for f in frames[frame_start:]])[..., ::-1]


def image_cli(argv):
    return _capture(timage_cli.main, argv)[1]


def unit_test_cli(argv):
    return _capture(tunit.main, argv)[1]


def _seeded_files(family, directory):
    """(export, video) of chip_smoke.py's seeded weights for `family` and
    4 frames of chip_smoke.seeded_frame, 64x96 for a 1x family, 100x150
    for a 4x one."""
    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED + 3)
    scale = 1 if family == "autoencoder" else 4
    model = build_generator(family, device="cpu", scale=scale)
    gain = (cs.SRGAN_BODY_GAIN, 1.0) if family == "srgan" else ()
    model = from_jax_params(model, *cs.seeded_flax_tree(model, rng, *gain))
    export = os.path.join(directory, f"{family}.dgt")
    tck.export_generator(export, family, scale, model)
    h, w = (64, 96) if scale == 1 else (100, 150)
    video = os.path.join(directory, "in.avi")
    vw = avi.VideoWriter(video, 25.0, (w, h))
    for _ in range(4):
        f = cs.seeded_frame(rng, h, w, "cpu").numpy()
        vw.write((f * 255 + 0.5).astype(np.uint8)[..., ::-1].copy())
    vw.release()
    return export, video


def _cli_on(device, export, video, directory, flags):
    """(result, frames, launch counts) of the video CLI on `device`."""
    import chip_smoke as cs

    out = os.path.join(directory, f"{device}.avi")
    cs.reset_counts()
    result, _, frames = video_cli(["--input_video", video, "--output_video",
                                   out, "--model", export, "--device",
                                   device, *flags])
    torch.cuda.synchronize()
    return result, frames, cs.fired()


def _u8_stats(a, b):
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return {"max_diff": int(d.max()), "frac_diff": float((d > 0).mean()),
            "frac_diff_1": float((d > 1).mean())}


def cuda_video_cli_vs_cpu(family, flags, directory):
    """The video CLI on the card and on the CPU on the same export and AVI
    (_seeded_files).  Returns the u8 stats of the card's frames against the
    CPU's (max, share > 0 and share > 1 level), the frames' shape, the
    card run's launch counts and both runs' PSNR."""
    export, video = _seeded_files(family, directory)
    card = _cli_on("cuda", export, video, directory, flags)
    cpu = _cli_on("cpu", export, video, directory, flags)
    return {**_u8_stats(card[1], cpu[1]), "shape": card[1].shape,
            "launches": card[2], "psnr": (card[0]["psnr"], cpu[0]["psnr"])}


def cuda_video_cli_vs_engine(family, q8, directory):
    """The video CLI's kernel engine on the card, unscored (--q8 -1: w8a8,
    2: qh8), against kernel_engine_direct on the card on the same export
    and AVI (_seeded_files; calibrated on frames 0-3, as the CLI for 4
    frames).  Returns the u8 stats, the shape and the launch counts."""
    export, video = _seeded_files(family, directory)
    _, got, launches = _cli_on("cuda", export, video, directory,
                               ["--score", "0", "--q8", str(q8)])
    want = kernel_engine_direct(export, video, 0, [0, 1, 2, 3],
                                qh8=q8 == 2, device="cuda")
    return {**_u8_stats(got, want), "shape": got.shape,
            "launches": launches}
