"""One rank of a data-parallel run of the port's trainers on the CPU, and the
cases that tests/test_torch_dist.py holds it to.

    python tests/torch_dist_worker.py SPEC RANK WORLD PORT OUT

joins a gloo group of WORLD processes at ``localhost:PORT`` as RANK, runs
every run of the torch-saved SPEC (a list of names: a case of CASES, or
``case+fault`` for the case with a fault of FAULTS planted) on this rank's
rows of its global batch (:func:`global_batch`), each from its trainer's
seeded state, and torch-saves ``{name: {"logs": [{term: float}], "states":
[{leaf path: numpy}]}}``, one entry per call, to OUT; it prints each run's
name as it starts. :func:`run_case` with no process group is the
one-process run on the whole global batch. No JAX here.
"""

from __future__ import annotations

import contextlib
import random
import sys

import numpy as np
import torch

from esrganplus_tpu_torch.models import RRDBNetConfig
from esrganplus_tpu_torch.models.discriminator import DiscriminatorVGGConfig
from esrganplus_tpu_torch.models.sft import SFTNetConfig
from esrganplus_tpu_torch.models.vgg import VGGFeatConfig
from esrganplus_tpu_torch.parallel import mesh
from esrganplus_tpu_torch.train import (GANTrainConfig, GANTrainer, SFTGANTrainConfig,
                                        SFTGANTrainer, SRTrainConfig, SRTrainer)
from esrganplus_tpu_torch.train.sr_model import tree_leaves

LR = 1e-4
SEED = 3
NOISE = dict(rdb_noise=True, rrdb_noise=True, noise_sigma=0.1)
SR_NET = dict(nf=8, nb=1, gc=4, upscale=4)
D_NET = dict(input_size=96, base_nf=8)
VGG = dict(feature_layer=20, layout=(8, 8, "M", 16, 16, "M", 32, 32, "M", 32, 32))

# case → (model, trainer options, global batch, the steps of each call, resident):
# a host-fed call is one step, a resident one a burst of that many (run_eager)
CASES = {
    # sr with both noise modes and both routes (the kernels' twins on the CPU)
    "sr_input": ("sr", dict(net=dict(**SR_NET, **NOISE)), 4, (1, 1), False),
    "sr_fused": ("sr", dict(net=dict(**SR_NET, **NOISE, noise_kernel="fused")), 4, (1, 1), False),
    "sr_fused_kernels": ("sr", dict(net=dict(**SR_NET, **NOISE, noise_kernel="fused",
                                             trunk_kernel="cuda", tail_kernel="cuda")),
                         4, (1, 1), False),
    # BN D and the RaGAN pairing, the plain D and the stage kernels' twins
    "srragan": ("srragan", dict(net=dict(**SR_NET, **NOISE), stage_kernel="plain"), 4, (1, 1), False),
    "srragan_stage": ("srragan", dict(net=dict(**SR_NET, rdb_noise=False),
                                      stage_kernel="cuda"), 4, (1, 1), False),
    "srgan_wgan_gp": ("srgan", dict(net=dict(**SR_NET, rdb_noise=False), stage_kernel="plain",
                                    gan_type="wgan-gp"), 4, (1,), False),
    # the ACD's BN and the masked CE (rank 0 keeps no label, rank 1 one)
    "sftgan": ("sftgan", {}, 2, (1,), False),
    # a resident burst of two steps through resident_exec.run_eager
    "resident_sr": ("sr", dict(net=dict(**SR_NET, **NOISE, noise_kernel="fused")), 4, (1, 2), True),
    "resident_srragan": ("srragan", dict(net=dict(**SR_NET, **NOISE), stage_kernel="plain"),
                         4, (1, 2), True),
    # noise off, fp32, a global batch of 8: held against JAX's 8-device mesh
    # (srragan without the perceptual net, which the cases above cover)
    "sr_jax": ("sr", dict(net=dict(**SR_NET, rdb_noise=False)), 8, (1,), False),
    "srragan_jax": ("srragan", dict(net=dict(**SR_NET, rdb_noise=False), stage_kernel="plain",
                                    feature_weight=0.0), 8, (1,), False),
}
SFT_LABELS = (0, 3)


@contextlib.contextmanager
def _no_backward_sum():
    """The fault of an all-reduce whose backward keeps each rank's own
    cotangent (no sum over the ranks)."""
    saved = mesh._AllReduceSum.backward
    mesh._AllReduceSum.backward = staticmethod(lambda ctx, g: g)
    try:
        yield
    finally:
        mesh._AllReduceSum.backward = saved


@contextlib.contextmanager
def _local_bn_cotangent():
    """The fault of a batch norm that normalises by the global statistics
    but differentiates them as this rank's own."""
    from esrganplus_tpu_torch.models import discriminator, layers

    saved = layers.global_moments

    def faulty(xf):
        mean, var, n = saved(xf)
        lm, lv = xf.mean((0, 1, 2)), xf.var((0, 1, 2), unbiased=False)
        return lm + (mean - lm).detach(), lv + (var - lv).detach(), n

    layers.global_moments = discriminator.global_moments = faulty
    try:
        yield
    finally:
        layers.global_moments = discriminator.global_moments = saved


FAULTS = {"no_backward_sum": _no_backward_sum, "local_bn_cotangent": _local_bn_cotangent}


def make_trainer(case: str):
    model, o, _, _, _ = CASES[case]
    if model == "sr":
        return SRTrainer(RRDBNetConfig(**o["net"]), SRTrainConfig(lr=LR, milestones=(2,)),
                         device="cpu")
    if model == "sftgan":
        return SFTGANTrainer(SFTNetConfig(nf=8, nb=1, cond_nf=4),
                             SFTGANTrainConfig(lr_g=LR, lr_d=LR, feature_weight=0.0,
                                               other_start_iter=0), device="cpu")
    cfg = GANTrainConfig(variant=model, gan_type=o.get("gan_type", "vanilla"), lr_g=LR,
                         lr_d=LR, milestones=(2,), feature_weight=o.get("feature_weight", 1.0))
    return GANTrainer(RRDBNetConfig(**o["net"]),
                      DiscriminatorVGGConfig(stage_kernel=o["stage_kernel"], **D_NET), cfg,
                      device="cpu", vgg_cfg=VGGFeatConfig(stage_kernel=o["stage_kernel"], **VGG))


def global_batch(case: str) -> tuple:
    """The case's global batch from a numpy seed: (LR, HR) for sr and the
    GANs (HR 32 and 96), (LR, seg, HR, category) for SFT-GAN."""
    model, _, n, _, _ = CASES[case]
    rs = np.random.RandomState(7)
    hr = 32 if model == "sr" else 96
    lr = rs.rand(n, hr // 4, hr // 4, 3).astype(np.float32)
    hr_img = rs.rand(n, hr, hr, 3).astype(np.float32)
    if model != "sftgan":
        return lr, hr_img
    seg = rs.rand(n, hr, hr, 8).astype(np.float32)
    seg /= seg.sum(-1, keepdims=True)
    return lr, seg, hr_img, np.asarray(SFT_LABELS, np.int64)


class _CropSource:
    """A dataset as ``data/resident.py`` samples it: seeded aligned crops."""

    opt: dict = {}

    def __init__(self, hr: int):
        self.hr = hr

    def __len__(self):
        return 6

    def sample(self, idx, crop_rng: random.Random):
        rs = np.random.RandomState(idx * 1000 + crop_rng.randrange(1000))
        return {"LR": rs.rand(self.hr // 4, self.hr // 4, 3).astype(np.float32),
                "HR": rs.rand(self.hr, self.hr, 3).astype(np.float32)}


def named_leaves(tree, prefix: str = "") -> list:
    """(path, tensor) of every tensor leaf, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in named_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, f"{prefix}/{i}")]
    return [(prefix, tree)] if torch.is_tensor(tree) else []


def _state(trainer, init):
    """The trainer's state: its own seeded init, or ``init`` (a state of the
    same tree) placed in it; then every rank takes rank 0's."""
    state = trainer.init_state(SEED)
    if init is not None:
        with torch.no_grad():
            for t, a in zip(tree_leaves(state), tree_leaves(init)):
                if torch.is_tensor(t):
                    t.copy_(torch.as_tensor(a))
    return mesh.replicate_tree(state)


def run_case(case: str, init=None, calls=None) -> dict:
    """The case's calls (its first ``calls`` of them) on this rank's rows of
    its global batch (the whole batch without a process group) → {"logs",
    "states"}, one entry per call."""
    from esrganplus_tpu_torch.data.resident import ResidentCropStore
    from esrganplus_tpu_torch.train.resident_exec import run_eager

    model, _, n, _, resident = CASES[case]
    calls = CASES[case][3][:calls]
    trainer = make_trainer(case)
    state = _state(trainer, init)
    logs, states = [], []
    if resident:
        store = ResidentCropStore(_CropSource(32 if model == "sr" else 96), "cpu", n_crops=8,
                                  refresh_steps=0, seed=SEED)
        step = lambda k: run_eager(trainer, state, store, SEED, n, k)
    else:
        batch = tuple(mesh.local_rows(torch.from_numpy(a)) for a in global_batch(case))
        step = lambda k: trainer.train_step(state, batch, SEED)
    for k in calls:
        state, out = step(k)
        logs.append({k: float(v) for k, v in out.items()})
        states.append({n: t.detach().numpy().copy() for n, t in named_leaves(state)})
    return {"logs": logs, "states": states}


def main(argv):
    spec_path, rank, world, port, out = argv
    torch.set_num_threads(1)  # the test workers share the machine's cores
    mesh.init_process_group(f"localhost:{port}", int(world), int(rank), device="cpu")
    try:
        res = {}
        for name in torch.load(spec_path, weights_only=False):
            print(name, flush=True)
            case, _, fault = name.partition("+")
            with FAULTS[fault]() if fault else contextlib.nullcontext():
                res[name] = run_case(case)
        torch.save(res, out)
    finally:
        mesh.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
