"""The PyTorch half of tests/test_torch_quality_tools.py: the port's quality
tools (denoise_gan_tpu_torch/tools/) on the CPU.

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_quality")``), so that no pytest worker
imports torch.  They take and return numpy arrays and plain Python values.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import os

import numpy as np
import torch

from denoise_gan_tpu_torch.io.checkpoint import load_generator
from denoise_gan_tpu_torch.tools import convert_vgg19, evaluate
from denoise_gan_tpu_torch.tools import quality_table as tq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# torchvision's VGG19 `features` indices of its 16 convs
TORCHVISION_CONVS = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32,
                     34]


def evaluate_arrays(model, image_dir, crop, q, batch, max_batches, fast):
    """tools/evaluate.py's evaluate on the CPU: the four per-image
    arrays."""
    return evaluate.evaluate(model, image_dir, crop, q, batch, max_batches,
                             bool(fast), device="cpu")


def evaluate_main(argv):
    """The tool's main with --device cpu: its printed lines."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        evaluate.main([*argv, "--device", "cpu"])
    return out.getvalue().splitlines()


def smoke_family(workdir, family, data_root):
    """run_family at the smoke budget (one epoch) in `workdir` on the CPU:
    the RESULT dict, the config of its export read back by load_generator,
    and whether the export's weights are finite."""
    old = os.getcwd()
    os.chdir(workdir)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = tq.run_family(family, data_root, "cpu",
                                tq.budget(smoke=True))
        config, model = load_generator(res["export"], device="cpu")
        finite = all(bool(torch.isfinite(p).all())
                     for p in model.state_dict().values())
    finally:
        os.chdir(old)
    return res, config, finite


def torch_route(directory, widths):
    """A torchvision-style VGG19 state dict (`features.<i>` convs of
    `widths`, a 2-D classifier weight the converters skip) written with
    torch.save, converted by the port's tool (its .npz) and by
    tools/convert_vgg19.py's from_torch (loaded by file path): both dicts
    of arrays."""
    g = torch.Generator().manual_seed(23)
    sd, cin = {}, 3
    for i, w in zip(TORCHVISION_CONVS, widths):
        sd[f"features.{i}.weight"] = torch.randn(w, cin, 3, 3, generator=g)
        sd[f"features.{i}.bias"] = torch.randn(w, generator=g) * 0.05
        cin = w
    sd["classifier.0.weight"] = torch.randn(5, cin, generator=g)
    sd["classifier.0.bias"] = torch.zeros(5)
    pth = os.path.join(directory, "vgg19.pth")
    out = os.path.join(directory, "port_torch.npz")
    torch.save(sd, pth)
    with contextlib.redirect_stdout(io.StringIO()):
        assert convert_vgg19.main(["--torch", pth, "--out", out]) == 0
    with np.load(out) as data:
        port = {k: data[k] for k in data.files}
    spec = importlib.util.spec_from_file_location(
        "jax_convert_vgg19", os.path.join(REPO, "tools", "convert_vgg19.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    return port, jtool.from_torch(pth)


def cuda_run_family(workdir):
    """run_family on the card, its default device, for one step (the
    autoencoder, a corpus of 8 train images at its batch 8): the RESULT,
    the device of the export's generator read back by load_generator, and
    the hand kernels' launch counts over the run (none may launch)."""
    from denoise_gan_tpu_torch.ops import mbconv, tail, tail_srgan

    counts = (tail.launch_counts, tail_srgan.launch_counts,
              mbconv.launch_counts)
    root = os.path.join(workdir, "qdata")
    with contextlib.redirect_stdout(io.StringIO()):
        tq.make_corpus(root, 8, 8)
    old = os.getcwd()
    os.chdir(workdir)
    try:
        for c in counts:
            c.update({k: 0 for k in c})
        with contextlib.redirect_stdout(io.StringIO()):
            res = tq.run_family("autoencoder", root,
                                cfg_table=tq.budget(smoke=True))
        launches = sum(v for c in counts for v in c.values())
        _, model = load_generator(res["export"])
        device = str(next(model.parameters()).device)
    finally:
        os.chdir(old)
    return res, device, launches
