"""Torch ``.pth`` checkpoint ↔ the port's parameter trees (generator half).

Counterpart of ``esrganplus_tpu/convert/pth.py``. The reference saves
flattened ``nn.Sequential`` state dicts:

    model.0.{weight,bias}                              fea_conv
    model.1.sub.{n}.RDB{k}.conv{1..4}.0.{weight,bias}  dense convs
    model.1.sub.{n}.RDB{k}.conv1x1.weight              ESRGAN+ shortcut (bias-free;
                                                       ABSENT in vanilla ESRGAN ckpts)
    model.1.sub.{n}.RDB{k}.conv5.0.{weight,bias}       fusion conv
    model.1.sub.{nb}.{weight,bias}                     LR/trunk conv
    model.{i}.{weight,bias}  (i ≥ 2, conv entries)     upconvs… then HR_conv0, HR_conv1

Weights convert OIHW → HWIO and the per-block tensors stack along a leading
nb axis, the JAX package's layout.

Vanilla-ESRGAN quirk: the reference loads those checkpoints with
``strict=False``, leaving ``conv1x1`` at random init. We default to zeros —
identical to the vanilla graph the checkpoint was trained with — and record
the event; ``missing_conv1x1='error'`` makes it fatal.

Scale ambiguity: a ×2 and a ×3 checkpoint both have one upconv, and the keys
cannot tell them apart. :func:`infer_rrdbnet_config` reads it as ×2; pass a
config with ``upscale=3`` for a ×3 checkpoint.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch

from esrganplus_tpu_torch.models.rrdb import RRDBNetConfig

__all__ = [
    "generator_from_state_dict",
    "infer_rrdbnet_config",
    "load_state_dict",
    "rrdbnet_from_state_dict",
    "rrdbnet_to_state_dict",
]

_RDB_KEY = re.compile(r"^model\.1\.sub\.(\d+)\.RDB(\d)\.(conv\d(?:x\d)?)(?:\.0)?\.(weight|bias)$")
_TOP_KEY = re.compile(r"^model\.(\d+)\.(weight|bias)$")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch checkpoint file into ``{key: CPU tensor}``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.detach() for k, v in sd.items()}


def _oihw_to_hwio(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 3, 1, 0).contiguous()


def _hwio_to_oihw(w: torch.Tensor) -> torch.Tensor:
    return w.permute(3, 2, 0, 1).contiguous()


def _top_indices(sd) -> list:
    return sorted({int(m.group(1)) for k in sd
                   if (m := _TOP_KEY.match(k)) and int(m.group(1)) >= 2})


def infer_rrdbnet_config(sd: Dict[str, torch.Tensor]) -> RRDBNetConfig:
    """Deduce (nb, nf, gc, in/out channels, upscale, conv1x1 presence) from keys."""
    blocks = set()
    has_1x1 = False
    for k in sd:
        m = _RDB_KEY.match(k)
        if m:
            blocks.add(int(m.group(1)))
            has_1x1 = has_1x1 or m.group(3) == "conv1x1"
    nb = max(blocks) + 1 if blocks else 0
    nf, in_nc = sd["model.0.weight"].shape[:2]
    gc = sd["model.1.sub.0.RDB1.conv1.0.weight"].shape[0]
    top = _top_indices(sd)
    out_nc = sd[f"model.{top[-1]}.weight"].shape[0]
    return RRDBNetConfig(in_nc=int(in_nc), out_nc=int(out_nc), nf=int(nf), nb=nb,
                         gc=int(gc), upscale=2 ** (len(top) - 2), conv1x1=has_1x1)


def rrdbnet_from_state_dict(
    sd: Dict[str, torch.Tensor],
    cfg: Optional[RRDBNetConfig] = None,
    missing_conv1x1: str = "zeros",
    dtype: torch.dtype = torch.float32,
) -> Tuple[dict, RRDBNetConfig, dict]:
    """Convert a reference RRDBNet state dict → (params, cfg, info), on the
    CPU. ``info['missing_conv1x1_blocks']`` lists the (block, rdb) pairs
    without a 1×1 weight in the checkpoint (vanilla-ESRGAN case)."""
    inferred = infer_rrdbnet_config(sd)
    if cfg is None:
        cfg = inferred
    else:
        for f in ("in_nc", "out_nc", "nf", "nb", "gc", "n_upscale_stages"):
            a, b = getattr(cfg, f), getattr(inferred, f)
            if a != b:
                raise ValueError(f"checkpoint mismatch: cfg.{f}={a} but checkpoint has {b}")
        if cfg.conv1x1 and not inferred.conv1x1 and missing_conv1x1 == "error":
            raise ValueError("checkpoint has no conv1x1 weights but cfg.conv1x1=True")

    def conv(prefix: str, bias: bool = True) -> dict:
        # conv5 is a one-module Sequential in the reference: accept both forms
        if prefix + ".weight" not in sd and prefix + ".0.weight" in sd:
            prefix = prefix + ".0"
        p = {"w": _oihw_to_hwio(sd[prefix + ".weight"]).to(dtype)}
        if bias:
            p["b"] = sd[prefix + ".bias"].to(dtype)
        return p

    missing = []

    def rdb(n: int, k: int) -> dict:
        base = f"model.1.sub.{n}.RDB{k}"
        p = {f"conv{j}": conv(f"{base}.conv{j}" + (".0" if j < 5 else ""))
             for j in range(1, 6)}
        if cfg.conv1x1:
            key = base + ".conv1x1.weight"
            if key in sd:
                p["conv1x1"] = {"w": _oihw_to_hwio(sd[key]).to(dtype)}
            else:
                missing.append((n, k))
                p["conv1x1"] = {"w": torch.zeros((1, 1, cfg.nf, cfg.gc), dtype=dtype)}
        return p

    def stacked(k: int) -> dict:
        per_block = [rdb(n, k) for n in range(cfg.nb)]
        return {name: {leaf: torch.stack([blk[name][leaf] for blk in per_block])
                       for leaf in per_block[0][name]}
                for name in per_block[0]}

    top = _top_indices(sd)
    params = {
        "fea_conv": conv("model.0"),
        "trunk": {"rdb1": stacked(1), "rdb2": stacked(2), "rdb3": stacked(3)},
        "trunk_conv": conv(f"model.1.sub.{cfg.nb}"),
        "upconvs": [conv(f"model.{i}") for i in top[:-2]],
        "hr_conv0": conv(f"model.{top[-2]}"),
        "hr_conv1": conv(f"model.{top[-1]}"),
    }
    return params, cfg, {"missing_conv1x1_blocks": missing}


def rrdbnet_to_state_dict(params: dict, cfg: RRDBNetConfig) -> Dict[str, torch.Tensor]:
    """Export params → a reference-layout state dict of fp32 CPU tensors
    (``torch.save`` it for the reference's tools)."""
    sd: Dict[str, torch.Tensor] = {}
    cpu = lambda t: t.detach().to("cpu", torch.float32)

    def put(prefix: str, p: dict):
        sd[prefix + ".weight"] = _hwio_to_oihw(cpu(p["w"]))
        if "b" in p:
            sd[prefix + ".bias"] = cpu(p["b"]).contiguous()

    put("model.0", params["fea_conv"])
    for n in range(cfg.nb):
        for k, name in ((1, "rdb1"), (2, "rdb2"), (3, "rdb3")):
            sub = params["trunk"][name]
            base = f"model.1.sub.{n}.RDB{k}"
            for cname in ("conv1", "conv2", "conv3", "conv4", "conv5"):
                put(f"{base}.{cname}.0", {leaf: v[n] for leaf, v in sub[cname].items()})
            if cfg.conv1x1:
                sd[f"{base}.conv1x1.weight"] = _hwio_to_oihw(cpu(sub["conv1x1"]["w"][n]))
    put(f"model.1.sub.{cfg.nb}", params["trunk_conv"])
    idx = 3
    for up in params["upconvs"]:
        put(f"model.{idx}", up)
        idx += 3
    put(f"model.{idx - 1}", params["hr_conv0"])
    put(f"model.{idx + 1}", params["hr_conv1"])
    return sd


def generator_from_state_dict(sd: Dict[str, torch.Tensor], cfg=None, **kw):
    """Dispatch on the checkpoint's keys → (params, cfg, info). RRDBNet only
    so far; SRResNet (``.res.`` keys) and SFT-GAN (``sft_branch.``) checkpoints
    are not ported yet."""
    if any(k.startswith("sft_branch.") or ".res.0.weight" in k for k in sd):
        raise NotImplementedError("SRResNet / SFT-GAN checkpoints are not ported yet")
    return rrdbnet_from_state_dict(sd, cfg, **kw)
