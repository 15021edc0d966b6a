"""The PyTorch half of tests/test_torch_parallel.py, tests/test_torch_plan.py
and tests/test_torch_native_codec.py: the data-parallel port
(parallel/mesh.py) and the space axis (parallel/spatial.py) on two gloo
ranks of the CPU, its random draws, the data shards and the dry run; the
kernel engines' ``plan``; the native codec.

tests/torch_process.py runs these functions in a child process
(``torch_process("torch_side_parallel")``).  The two ranks are processes
that child spawns: they join one group through a file store in a
temporary directory (no TCP port), each collective and the join time out
after RANK_TIMEOUT_S, and the child kills a rank still running after
SUITE_TIMEOUT_S.  Arguments and results are numpy arrays and plain Python
values.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import os
import pickle
import tempfile
import time

import numpy as np
import torch
import torch.multiprocessing as mp

from denoise_gan_tpu_torch.data import native as tnative
from denoise_gan_tpu_torch.data import pipeline as tpipeline
from denoise_gan_tpu_torch.data.degrade import degrade_pair
from denoise_gan_tpu_torch.infer import engine as tengine
from denoise_gan_tpu_torch.infer import kernel_engine as tke
from denoise_gan_tpu_torch.io.params import from_jax_params, to_jax_trees
from denoise_gan_tpu_torch.models import build_generator, build_models
from denoise_gan_tpu_torch.models.layers import Dropout
from denoise_gan_tpu_torch.models.vgg import VGG19Features
from denoise_gan_tpu_torch.parallel import dryrun
from denoise_gan_tpu_torch.parallel import mesh as tmesh
from denoise_gan_tpu_torch.parallel import spatial
from denoise_gan_tpu_torch.train import loop as tloop
from denoise_gan_tpu_torch.train.loop import resume_step
from denoise_gan_tpu_torch.train.state import create_train_state
from denoise_gan_tpu_torch.train.step import build_train_step
from denoise_gan_tpu_torch.utils import config as tconfig
from torch_side_training import _grad_tree

RANKS = 2
RANK_TIMEOUT_S = 120
SUITE_TIMEOUT_S = 300
# the child and its ranks share the machine with the suite's other workers
torch.set_num_threads(min(2, torch.get_num_threads()))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _digest(*modules: torch.nn.Module) -> str:
    """sha256 of every parameter's and buffer's bytes."""
    h = hashlib.sha256()
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the ranks' work


def _step(family, crop, inputs, mesh):
    """One port step (degrade=False, f32, CPU) from the Flax trees on this
    rank's rows of the global pair (the whole pair, unsplit, where `mesh`
    is None): metrics, the gradients recovered from Adam's first moments
    and the new statistics as Flax trees, and the digest of the nets after
    the step."""
    gen, disc, vgg_params, img_in, img_tgt = inputs
    cfg = tconfig.make_config(family, crop_size=crop, device="cpu")
    bundle = build_models(family, scale=cfg.scale)
    state = create_train_state(bundle, cfg, "cpu")
    from_jax_params(state.gen.model, *gen)
    from_jax_params(state.disc.model, *disc)
    vgg = from_jax_params(VGG19Features(), vgg_params).eval()
    vgg.requires_grad_(False)
    step = build_train_step(bundle, cfg, degrade=False, mesh=mesh)
    pair = (_t(img_in), _t(img_tgt))
    metrics = step(state, vgg, pair if mesh is None
                   else tmesh.shard_batch(pair, mesh))
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "step": state.step,
           "digest": _digest(state.gen.model, state.disc.model)}
    for name, net in (("gen", state.gen), ("disc", state.disc)):
        b1 = net.opt.param_groups[0]["betas"][0]
        out[name + "_grads"] = _grad_tree(net.model, [
            net.opt.state[p]["exp_avg"] / (1 - b1)
            for p in net.model.parameters()])
        out[name + "_stats"] = to_jax_trees(net.model)[1]
    return out


def _mesh_errors(mesh) -> list[str]:
    """The exception types of make_mesh's refusals under the group ("none"
    where it gives a mesh)."""
    out = []
    for kw in ({"num_devices": 1}, {"num_devices": 3}, {"space": 2},
               {"space": 3}):
        try:
            tmesh.make_mesh(device="cpu", **kw)
            out.append("none")
        except (ValueError, NotImplementedError) as exc:
            out.append(type(exc).__name__)
    return out


def _net(family, params, stats):
    """The family's generator on the CPU (eval mode) from Flax trees."""
    return from_jax_params(build_generator(family, device="cpu"), params,
                           stats)


def _spatial(cases, mesh) -> dict:
    """Per case (name -> (family, scale, params, stats, NHWC frame)): this
    rank's parallel/spatial.py::spatial_apply rows of the whole frame, the
    output gathered (gather_frame) and the halo exchanges of the forward;
    then the exception types of pix2pix and of an autoencoder frame of 96
    rows (48 a rank)."""
    out = {}
    for name, (family, scale, params, stats, x) in cases.items():
        n = x.shape[1]
        lo, hi = tmesh.row_range(n, mesh)
        spatial.reset_counts()
        rows = spatial.spatial_apply(_net(family, params, stats),
                                     _t(x[:, lo:hi]), n, mesh)
        out[name] = {"rows": rows.numpy(), "range": (lo, hi),
                     "exchanges": spatial.counts["halo_exchanges"],
                     "whole": spatial.gather_frame(rows, n, scale,
                                                   mesh).numpy()}
    refused = []
    for family, shape in (("pix2pix", (1, 256, 256, 3)),
                          ("autoencoder", (1, 96, 64, 3))):
        lo, hi = tmesh.row_range(shape[1], mesh)
        try:
            spatial.spatial_apply(build_generator(family, device="cpu"),
                                  torch.zeros(shape)[:, lo:hi], shape[1],
                                  mesh)
            refused.append("none")
        except (ValueError, NotImplementedError) as exc:
            refused.append(type(exc).__name__)
    out["refused"] = refused
    return out


def spatial_one_process(cases) -> dict:
    """The port's plain forward of each case (see _spatial) on one
    process, f32."""
    out = {}
    for name, (family, _, params, stats, x) in cases.items():
        with torch.no_grad():
            out[name] = _net(family, params, stats)(_t(x)).numpy()
    return out


def mesh_layout(ranks: int, space: int, shape) -> list[tuple]:
    """For each rank of a (ranks // space, space) mesh: its (data index,
    space index) and the [lo, hi) of axes 0 and 1 that batch_sharding
    gives it of a global array of `shape` (read from a tensor of its
    indices)."""
    out = []
    index0 = torch.arange(shape[0]).view(-1, 1).expand(shape[:2])
    index1 = torch.arange(shape[1]).view(1, -1).expand(shape[:2])
    for r in range(ranks):
        mesh = tmesh.Mesh(ranks, r, torch.device("cpu"), space=space)
        shard = tmesh.batch_sharding(mesh)
        a, b = shard.take(index0), shard.take(index1)
        out.append((mesh.data_index, mesh.space_index,
                    (int(a.min()), int(a.max()) + 1),
                    (int(b.min()), int(b.max()) + 1)))
    return out


class _Checkpoints:
    """A CheckpointManager's face to train/loop.py::resume_step: the step
    of its latest checkpoint."""

    ckpt_dir = "checkpoints"

    def __init__(self, step):
        self.step = step

    def latest_step(self):
        return self.step


def _resume_steps(mesh) -> list:
    """resume_step where every rank finds step 5, where only rank 0 does,
    and with no manager: the step, or the exception's type."""
    out = []
    for mgr in (_Checkpoints(5), _Checkpoints(5 if mesh.rank == 0 else None),
                None):
        try:
            out.append(resume_step(mgr, mesh))
        except RuntimeError as exc:
            out.append(type(exc).__name__)
    return out


def _rank_main(rank: int, store: str, payload: dict, out_dir: str) -> None:
    tmesh.init_distributed(device="cpu", init_method=f"file://{store}",
                           rank=rank, world_size=RANKS,
                           timeout_s=RANK_TIMEOUT_S)
    mesh = tmesh.make_mesh(device="cpu")
    space = tmesh.make_mesh(device="cpu", space=2)
    out = {"mesh": (mesh.size, mesh.rank, str(mesh.device), mesh.hosts),
           "space_mesh": (space.size, space.rank, space.space,
                          space.data_index, space.space_index),
           "mesh_errors": _mesh_errors(mesh),
           "resume": _resume_steps(mesh), "steps": {},
           "spatial": _spatial(payload["spatial"], mesh)}
    for family, (crop, inputs) in payload["steps"].items():
        out["steps"][family] = _step(family, crop, inputs, mesh)

    e = payload["engine"]
    w = _t(e["w"])
    eng = tengine.build_frame_engine(
        lambda x: torch.tanh(x @ w), e["height"], e["width"], e["scale"],
        tile=e["tile"], overlap=e["overlap"], device="cpu", mesh=mesh)
    out["engine"] = eng(_t(e["frame"])).numpy()

    k = payload["kernel_engine"]
    from torch_side import _generator
    run = tke.build_fsrgan_kernel_engine(
        _generator(k["params"], k["stats"]), k["height"], k["width"],
        brc=k["brc"])
    out["kernel_engine"] = tmesh.map_frames(
        run, _t(np.stack(k["frames"])), mesh).numpy()
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def two_ranks(payload: dict) -> list[dict]:
    """Each rank's results of `payload` (see _rank_main), the ranks spawned
    on the CPU over gloo."""
    return _spawn(_rank_main, payload)


def _spawn(target, payload) -> list[dict]:
    """target(rank, store, payload, out_dir) on RANKS spawned ranks: each
    rank's pickled result; a rank's exception is raised here, and a rank
    still running after SUITE_TIMEOUT_S is killed."""
    with tempfile.TemporaryDirectory(prefix="dgt_ranks_") as tmp:
        ctx = mp.start_processes(
            target, args=(os.path.join(tmp, "store"), payload, tmp),
            nprocs=RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + SUITE_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks ran past "
                                       f"{SUITE_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        out = []
        for r in range(RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _trainer(family, argv, workdir) -> dict:
    """The trainer's main(argv) in `workdir`: the nets' digest, the steps
    and the stdout."""
    old = os.getcwd()
    os.chdir(workdir)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state = tloop.main(family, argv)
        return {"digest": _digest(state.gen.model, state.disc.model),
                "step": state.step, "stdout": out.getvalue()}
    finally:
        os.chdir(old)


def _batch_one_rank(rank: int, store: str, payload: dict, out_dir: str
                    ) -> None:
    """One rank of a --batch_size 1 run (train/loop.py's fallback: each
    rank steps the same batch unsplit) and the unsplit step on the JAX
    step's inputs; rank 0 then runs the trainer once more on one process,
    with the same threads, in a directory of its own."""
    tmesh.init_distributed(device="cpu", init_method=f"file://{store}",
                           rank=rank, world_size=RANKS,
                           timeout_s=RANK_TIMEOUT_S)
    family, argv = payload["family"], payload["argv"]
    out = {"run": _trainer(family, argv, payload["workdir"]),
           "step": _step(family, payload["crop"], payload["inputs"], None)}
    torch.distributed.destroy_process_group()
    if rank == 0:
        out["one_process"] = _trainer(family, argv, payload["one_dir"])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def batch_one_ranks(payload: dict) -> list[dict]:
    """Each rank's results of a --batch_size 1 run on two ranks (see
    _batch_one_rank)."""
    return _spawn(_batch_one_rank, payload)


def batch_split(batch_size, hosts, ranks):
    """train/loop.py::batch_split: (global batch, split), or the
    ValueError's message."""
    try:
        return tloop.batch_split(batch_size, hosts, ranks)
    except ValueError as exc:
        return str(exc)


def one_process_step(family, crop, inputs):
    """The port's one-process step on the whole pair, as _step returns
    it (no group)."""
    return _step(family, crop, inputs, tmesh.make_mesh(device="cpu"))


def no_group_mesh_errors() -> list[str]:
    """make_mesh's refusals without a group (one rank)."""
    out = []
    for kw in ({"num_devices": 2}, {"space": 2}):
        try:
            tmesh.make_mesh(device="cpu", **kw)
            out.append("none")
        except (ValueError, NotImplementedError) as exc:
            out.append(type(exc).__name__)
    return out


# ---------------------------------------------------------------------------
# the global draws, the shards, the dry run


def sliced_draws(seed: int = 3) -> dict:
    """Whether each rank's rows of a global draw, put together, equal the
    one-process draw: degrade_pair's random qualities (through the
    degraded images) and Dropout's masks (three layers in a row, as
    pix2pix draws them, from one generator)."""
    hr = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    whole = degrade_pair(hr, 4, 50, torch.Generator().manual_seed(seed),
                         random_quality=True)[0]
    parts = [degrade_pair(tmesh.Shard(i, 2).take(hr), 4, 50,
                          torch.Generator().manual_seed(seed),
                          random_quality=True, shard=tmesh.Shard(i, 2))[0]
             for i in range(2)]
    drop = Dropout(0.5).train()
    shapes = [(4, 8, 2, 2), (4, 8, 4, 4), (4, 8, 8, 8)]
    g = torch.Generator().manual_seed(seed)
    masks = [drop(torch.ones(s), g) for s in shapes]
    sliced = []
    for i in range(2):
        draw = tmesh.GlobalDraw(torch.Generator().manual_seed(seed),
                                tmesh.Shard(i, 2))
        sliced.append([drop(torch.ones(2, *s[1:]), draw) for s in shapes])
    local = [drop(torch.ones(2, *s[1:]), torch.Generator().manual_seed(
        seed)) for s in shapes]
    return {
        "qualities": bool(torch.equal(torch.cat(parts), whole)),
        "masks": all(torch.equal(torch.cat([sliced[0][j], sliced[1][j]]),
                                 masks[j]) for j in range(3)),
        # a local draw would not be the global one
        "local_differs": not torch.equal(local[0], masks[0][:2]) or
        not torch.equal(local[1], masks[1][:2]),
    }


def pipeline_shard(image_dir, index, count):
    """DataPipeline's shard: (paths, train_size, steps)."""
    cfg = tconfig.make_config("fsrgan", image_dir=image_dir, batch_size=2,
                              device="cpu")
    p = tpipeline.DataPipeline(cfg, process_index=index,
                               process_count=count)
    try:
        return list(p.paths), p.train_size, len(p)
    finally:
        p.close()


def dry_run(workdir):
    return dryrun.run("cpu", 2, "fsrgan", workdir)


# ---------------------------------------------------------------------------
# the kernel engines' plan, the native codec


def engine_with_plan(family, params, stats, height, width, brc, plan,
                     frames):
    """The family's kernel engine (bf16, twin tails on the CPU) built
    with `plan`: each frame's uint8 output."""
    from torch_side import _BUILDERS, _generator
    run = _BUILDERS[family][1](_generator(params, stats, family), height,
                               width, brc=brc, plan=plan)
    return [run(_t(f)).numpy() for f in frames]


def plan_refused(params, stats):
    from torch_side import _generator
    try:
        tke.build_fsrgan_kernel_engine(_generator(params, stats), 64, 70,
                                       brc=8, plan=(1, 1, 32))
    except ValueError as exc:
        return str(exc)
    return None


def native_fresh_build(build_dir):
    """The codec compiled anew into `build_dir` (the port's build step,
    without a library built before): the library's path."""
    from pathlib import Path
    saved, tnative.BUILD_DIR = tnative.BUILD_DIR, Path(build_dir)
    try:
        return str(tnative.build())
    finally:
        tnative.BUILD_DIR = saved


def native_codec(paths, rgb, qualities):
    """The port's native codec: available, each file decoded, the round
    trip of `rgb` at each quality, decode_image of each file, the decoder
    decode_image uses, and the library's path."""
    return {"available": tnative.available(),
            "decoded": [tnative.decode(p) for p in paths],
            "roundtrip": [tnative.jpeg_roundtrip_u8(rgb, q)
                          for q in qualities],
            "decode_image": [tpipeline.decode_image(p) for p in paths],
            "decoder": tpipeline.decoder(),
            "library": str(tnative.library_path())}


# ---------------------------------------------------------------------------
# the space axis on the card (tests/test_torch_cuda.py)


def _seeded_net(family: str, seed: int, device) -> torch.nn.Module:
    """The family's generator with every tensor drawn from `seed`: kernels
    N(0, 1/4 fan_in), biases and BatchNorm means N(0, 0.05^2), scales and
    variances U(0.8, 1.2) and U(0.5, 1.5), PReLU slopes U(0.05, 0.3)."""
    net = build_generator(family, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "weight":
                t.copy_(torch.randn(t.shape, generator=g) * 0.5
                        / t[0].numel() ** 0.5)
            elif leaf in ("scale", "var"):
                lo, hi = (0.8, 1.2) if leaf == "scale" else (0.5, 1.5)
                t.copy_(torch.rand(t.shape, generator=g) * (hi - lo) + lo)
            elif leaf == "alpha":
                t.copy_(torch.rand(t.shape, generator=g) * 0.25 + 0.05)
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return net.to(device).eval()


def _space_frames(cases):
    return {name: torch.rand((1, rows, cols, 3), generator=torch.Generator(
        ).manual_seed(i)) * 2 - 1 for i, (name, (_, rows, cols))
        in enumerate(cases.items())}


def _cuda_space_rank(rank: int, store: str, cases: dict, out_dir: str
                     ) -> None:
    from denoise_gan_tpu_torch.utils.device import no_tf32
    tmesh.init_distributed(backend="gloo", device="cuda:0",
                           init_method=f"file://{store}", rank=rank,
                           world_size=RANKS, timeout_s=RANK_TIMEOUT_S)
    mesh = tmesh.make_mesh(device="cuda:0")
    out = {}
    for (name, (family, rows, _)), x in zip(cases.items(),
                                            _space_frames(cases).values()):
        lo, hi = tmesh.row_range(rows, mesh)
        spatial.reset_counts()
        with no_tf32():
            y = spatial.spatial_apply(_seeded_net(family, 7, mesh.device),
                                      x[:, lo:hi].to(mesh.device), rows,
                                      mesh)
        out[name] = (y.cpu().numpy(), (lo, hi),
                     spatial.counts["halo_exchanges"])
    torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def cuda_spatial_two_ranks(cases: dict) -> dict:
    """On the card: each case (name -> (family, rows, cols)) through
    parallel/spatial.py::spatial_apply on two gloo ranks sharing cuda:0
    and through the plain forward on one process, f32 with TF32 off: per
    case each rank's (rows, max |d| against one process, byte-equal,
    halo exchanges)."""
    from denoise_gan_tpu_torch.utils.device import no_tf32
    ranks = _spawn(_cuda_space_rank, cases)
    out = {}
    for (name, (family, _, _)), x in zip(cases.items(),
                                         _space_frames(cases).values()):
        with torch.no_grad(), no_tf32():
            one = _seeded_net(family, 7, "cuda")(x.cuda()).cpu().numpy()
        scale = one.shape[1] // x.shape[1]
        got = []
        for r in ranks:
            y, (lo, hi), exchanges = r[name]
            want = one[:, scale * lo:scale * hi]
            got.append(((lo, hi), float(np.abs(y - want).max()),
                        bool(np.array_equal(y, want)), exchanges,
                        float(want.std())))
        out[name] = got
    return out
