"""Entry points: the flagship stereo depth function, and a dry run of the
whole sharded stack.

- entry(): (fn, (left, right)): the fast-mode hh4 stereo depth function
  at 64 disparities on a seeded 270x480 pair, on the card.
- dryrun(n): the sharded stack over n ranks, one process per rank (NCCL
  across GPUs, or gloo on the CPU): frame data parallelism with row tiles
  and halo exchange, batch_pipeline on whole frames, the disparity-range
  split (blockmatch and the SGM matcher) when the 'model' axis has more
  than one rank, the tiny mono net's train step with data and tensor
  parallelism, and predict_sharded against the single forward (in
  float32, TF32 off, within 1e-4 as in JAX).

    python -m depthestimation_torch.entry [N] [--device cuda|cpu]

runs entry()'s function once, then dryrun(N) (N defaults to the number of
GPUs, or 1 on the CPU).
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .config import SGMConfig
from .pipeline import _resolve_device, stereo_depth_fn

__all__ = ["entry", "dryrun", "mesh_shape"]


def entry(device="cuda"):
    """(fn, (left, right)): fn(left, right) is the fast-mode hh4 stereo
    pipeline at 64 disparities, returning the cropped disparity; the
    example arguments are a seeded 270x480 float32 pair on `device`."""
    device = _resolve_device(device)
    cfg = SGMConfig(num_disp=64, sgbm_mode="hh4")

    def fn(left, right):
        disp, _ = stereo_depth_fn(left, right, cfg, 1.0, fast_mode=True)
        return disp

    rng = np.random.default_rng(0)
    h, w = 270, 480
    left = torch.tensor(rng.integers(0, 255, (h, w)).astype(np.float32), device=device)
    right = torch.tensor(rng.integers(0, 255, (h, w)).astype(np.float32), device=device)
    return fn, (left, right)


def mesh_shape(n: int) -> Tuple[int, int, int]:
    """(data, tile, model) of n ranks, factored as the JAX package's dry
    run does: 2 tiles x 2 model ranks when 4 divides n, else 2 tiles
    when 2 does, else data parallelism only."""
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (n // 2, 2, 1)
    return (n, 1, 1)


def _body(n: int, device) -> dict:
    """One rank's dry run over the running process group of n ranks.
    Returns what it checked; rank 0 prints it."""
    import copy

    from .models.dpt import DPTConfig
    from .models.mono import MonoDepthModel, MonoDepthNet
    from .models.train import gather_params, make_sharded_train_state, make_train_step
    from .ops import cuda_sgm
    from .parallel import shard
    from .parallel.mesh import axis_info, make_mesh
    from .pipeline import postprocess_and_depth, raw_disparity
    from .models.vit import ViTConfig

    shape = mesh_shape(n)
    mesh = make_mesh(shape, device=device)
    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device("cpu"))
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say(f"mesh: {dict(zip(mesh.mesh_dim_names, shape))} on {dist.get_backend()}")
    out = {"mesh": list(shape), "backend": dist.get_backend()}
    rng = np.random.default_rng(0)
    _, data_index, data_size = axis_info(mesh, "data")

    def mine(batch):
        """This rank's frames of a global batch, on its device."""
        per = batch.shape[0] // data_size
        return torch.tensor(batch[data_index * per:(data_index + 1) * per], device=dev)

    # -- frame data parallelism x row tiles with halo exchange --
    cfg = SGMConfig(num_disp=16, sgbm_mode="sgbm_3way", focal_length=100.0, baseline=0.1)
    b = shape[0]
    h, w = 32 * shape[1], 64
    lb = rng.integers(0, 255, (b, h, w)).astype(np.float32)
    rb = rng.integers(0, 255, (b, h, w)).astype(np.float32)
    disp, depth = shard.batch_pipeline(mesh, cfg, fast_mode=True, halo=4)(mine(lb), mine(rb))
    if disp.shape != (b // data_size, h, w - 16) or depth.shape != disp.shape \
            or not torch.isfinite(disp).all():
        raise AssertionError(f"stereo dp+tile: disparity {tuple(disp.shape)} not finite "
                             "or not of the frames' shape")
    say(f"stereo dp+tile: disp {tuple(disp.shape)}, depth {tuple(depth.shape)} per rank")
    out["stereo_tiles"] = list(disp.shape)

    # -- frame data parallelism on whole frames: each frame equals the
    # single-pair path --
    cfg_w = SGMConfig(num_disp=16, sgbm_mode="sgbm_3way", speckle_window_size=0)
    lw = rng.integers(0, 255, (b, 16, 384)).astype(np.float32)
    rw = rng.integers(0, 255, (b, 16, 384)).astype(np.float32)
    lm, rm = mine(lw), mine(rw)
    dw, _ = shard.batch_pipeline(mesh, cfg_w, fast_mode=True, tile_axis=None)(lm, rm)
    for i in range(lm.shape[0]):
        want = postprocess_and_depth(raw_disparity(lm[i], rm[i], cfg_w), cfg_w,
                                     fast_mode=True)[0]
        if not torch.equal(dw[i], want):
            raise AssertionError(f"batch_pipeline frame {i} differs from the single pair")
    say(f"stereo dp, whole frames: disp {tuple(dw.shape)} per rank == the single pair")
    out["stereo_whole_frames"] = list(dw.shape)

    # -- the disparity range split over 'model' --
    if shape[2] > 1:
        l0, r0 = torch.tensor(lb[0], device=dev), torch.tensor(rb[0], device=dev)
        d2 = shard.disp_sharded_blockmatch(mesh, cfg, axis="model")(l0, r0)
        say(f"disp-sharded blockmatch: {tuple(d2.shape)}")
        d3 = shard.disp_sharded_sgm(mesh, cfg, axis="model")(l0, r0)
        if not torch.equal(d3, cuda_sgm.sgm_disparity(l0, r0, cfg)):
            raise AssertionError("disp_sharded_sgm differs from the single-device matcher")
        say(f"disp-sharded SGM: {tuple(d3.shape)} == the single-device matcher")
        out["disp_sharded"] = list(d3.shape)

    # -- the mono train step: data and tensor parallelism --
    vit_cfg = ViTConfig(image_size=56, patch_size=14, hidden_size=64, num_layers=2,
                        num_heads=2, out_layers=(0, 0, 1, 1))
    dpt_cfg = DPTConfig(features=32, reassemble_channels=(16, 16, 32, 32), head_features=16)
    net = MonoDepthNet(vit_cfg, dpt_cfg)
    local, opt, shardings = make_sharded_train_state(net, mesh, (56, 56))
    step = make_train_step(local, opt, mesh, shardings)
    images = rng.uniform(0, 1, (b * 2, 56, 56, 3)).astype(np.float32)
    targets = rng.uniform(0.1, 10, (b * 2, 56, 56)).astype(np.float32)
    loss = float(step(images, targets))
    if not np.isfinite(loss):
        raise AssertionError(f"mono train step: loss {loss}")
    say(f"mono train step: loss {loss:.4f}")
    out["loss"] = loss

    # -- sharded inference with the trained weights --
    full = copy.deepcopy(net)
    full.load_state_dict({k: v.detach().cpu() for k, v in gather_params(
        dict(local.named_parameters()), mesh, shardings).items()})
    model = MonoDepthModel(net=full.eval()).to_device(dev)
    # In float32: with TF32 on, cuDNN runs a batch of one and a batch of
    # two through other algorithms, which round apart by more than the
    # tolerance (about 7e-4 on an H100).
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        depth_sharded = model.predict_sharded(images, mesh)
        with torch.no_grad():
            ref = model.net(torch.from_numpy(images[:1]).to(dev)).cpu().numpy()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = float(np.abs(depth_sharded[:1] - ref).max())
    if not err < 1e-4:
        raise AssertionError(f"sharded mono inference diverges: {err}")
    say(f"mono sharded inference: depth {depth_sharded.shape}, "
        f"max |diff| vs single-device {err:.2e}")
    out["predict_sharded_err"] = err
    say("dryrun OK")
    return out


def _rank(rank: int, n: int, store: str, device: str) -> None:
    """One process of a dry run over n ranks (torch.multiprocessing)."""
    from .parallel.mesh import destroy_process_group, initialize_distributed

    initialize_distributed(store, n, rank, device=device)
    try:
        _body(n, device)
    finally:
        destroy_process_group()


def dryrun(n: int, device="cuda") -> Optional[dict]:
    """The sharded stack over n ranks (mesh_shape(n)). One rank runs in
    this process, on a running group of one rank or on one it starts and
    ends, and returns what it checked. More ranks run one process each
    (one per GPU on the card; NCCL, or gloo on the CPU), meeting on a
    file in a temporary directory; a failed rank raises here."""
    device = _resolve_device(device)
    if n == 1:
        started = not dist.is_initialized()
        try:
            return _body(1, device)
        finally:
            if started:
                from .parallel.mesh import destroy_process_group

                destroy_process_group()
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun({n}) needs {n} GPUs, {torch.cuda.device_count()} visible")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "rendezvous")
        mp.spawn(_rank, args=(n, store, device.type), nprocs=n, join=True)
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="ranks of the dry run (default: the GPUs, or 1 on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    fn, (left, right) = entry(args.device)
    disp = fn(left, right)
    print(f"entry: disparity {tuple(disp.shape)} on {disp.device}")
    n = args.n or (torch.cuda.device_count() if args.device == "cuda" else 1)
    dryrun(n, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
