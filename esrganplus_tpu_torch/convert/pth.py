"""Torch ``.pth`` checkpoint ↔ the port's parameter trees (RRDBNet,
SRResNet and SFT_Net generators, the VGG-style discriminators; SRResNet's
and SFT-GAN's own key layouts, the ACD's included, are in
``models/srresnet.py`` and ``models/sft.py``).

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
    "discriminator_from_state_dict",
    "discriminator_sn_from_state_dict",
    "discriminator_sn_to_state_dict",
    "discriminator_to_state_dict",
    "generator_from_state_dict",
    "generator_to_state_dict",
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
    """Dispatch on the checkpoint's keys → (params, cfg, info): RRDBNet
    checkpoints have RDB keys, SRResNet ones ``.res`` keys, SFT_Net ones
    ``sft_branch.`` keys (an ``SFTNetConfig`` ``cfg`` gives ``legacy``;
    the depth is the checkpoint's, and info is empty, as in the JAX
    package)."""
    from esrganplus_tpu_torch.models.sft import SFTNetConfig, sftnet_from_state_dict
    from esrganplus_tpu_torch.models.srresnet import (SRResNetConfig, is_srresnet_state_dict,
                                                      srresnet_from_state_dict)

    dtype = kw.get("dtype", torch.float32)
    if any(k.startswith("sft_branch.") for k in sd) or isinstance(cfg, SFTNetConfig):
        params, cfg = sftnet_from_state_dict(sd, cfg if cfg is not None else SFTNetConfig(),
                                             dtype=dtype)
        return params, cfg, {}
    if is_srresnet_state_dict(sd) or isinstance(cfg, SRResNetConfig):
        params, cfg = srresnet_from_state_dict(sd, cfg, dtype=dtype)
        return params, cfg, {"missing_conv1x1_blocks": []}
    return rrdbnet_from_state_dict(sd, cfg, **kw)


def generator_to_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """Export generator params (RRDBNet, SRResNet or SFT_Net) → reference
    state dict."""
    from esrganplus_tpu_torch.models.sft import SFTNetConfig, sftnet_to_state_dict
    from esrganplus_tpu_torch.models.srresnet import SRResNetConfig, srresnet_to_state_dict

    if isinstance(cfg, SFTNetConfig):
        return sftnet_to_state_dict(params, cfg)
    if isinstance(cfg, SRResNetConfig):
        return srresnet_to_state_dict(params, cfg)
    return rrdbnet_to_state_dict(params, cfg)


# ---------------------------------------------------------------------------
# Discriminator (VGG-style) conversion
# ---------------------------------------------------------------------------
#
# Reference flattening (architecture.py:87-129 via block.sequential): stage 0
# contributes [conv, act]; every later conv_block contributes [conv, bn, act]
# (or [conv, act] without norm). Classifier = classifier.0 / classifier.2
# Linears. The first Linear acts on a C-major (NCHW) flatten; the forward
# transposes to NCHW before flattening, so Linear weights convert as plain
# transposes.


def _d_plan(cfg):
    """Yield ('a'|'b', stage_idx, has_bn) in flattened feature order."""
    for i in range(cfg.n_stages):
        yield ("a", i, cfg.use_bn and i > 0)
        yield ("b", i, cfg.use_bn)


def discriminator_from_state_dict(sd: Dict[str, torch.Tensor], cfg,
                                  dtype: torch.dtype = torch.float32) -> dict:
    """Reference ``Discriminator_VGG_{96,128,192}`` state dict → params on the CPU."""
    t = lambda v: torch.as_tensor(v).detach().to(dtype)
    idx = 0
    convs, bns = [], []
    cur = None
    for side, i, has_bn in _d_plan(cfg):
        p = {"w": _oihw_to_hwio(t(sd[f"features.{idx}.weight"])),
             "b": t(sd[f"features.{idx}.bias"])}
        idx += 1
        bn = None
        if has_bn:
            bn = {"scale": t(sd[f"features.{idx}.weight"]),
                  "bias": t(sd[f"features.{idx}.bias"]),
                  "mean": t(sd[f"features.{idx}.running_mean"]),
                  "var": t(sd[f"features.{idx}.running_var"])}
            idx += 1
        idx += 1  # activation slot
        if side == "a":
            cur = {"a": p}
            if cfg.use_bn:
                bns.append({"a": bn})
        else:
            cur["b"] = p
            convs.append(cur)
            if cfg.use_bn:
                bns[-1]["b"] = bn
    params = {"convs": convs,
              "fc0": {"w": t(sd["classifier.0.weight"]).T.contiguous(),
                      "b": t(sd["classifier.0.bias"])},
              "fc1": {"w": t(sd["classifier.2.weight"]).T.contiguous(),
                      "b": t(sd["classifier.2.bias"])}}
    if cfg.use_bn:
        params["bn"] = bns
    return params


def discriminator_to_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    sd: Dict[str, torch.Tensor] = {}
    cpu = lambda v: v.detach().to("cpu", torch.float32).contiguous()
    idx = 0
    for side, i, has_bn in _d_plan(cfg):
        p = params["convs"][i][side]
        sd[f"features.{idx}.weight"] = _hwio_to_oihw(cpu(p["w"]))
        sd[f"features.{idx}.bias"] = cpu(p["b"])
        idx += 1
        if has_bn:
            bn = params["bn"][i][side]
            sd[f"features.{idx}.weight"] = cpu(bn["scale"])
            sd[f"features.{idx}.bias"] = cpu(bn["bias"])
            sd[f"features.{idx}.running_mean"] = cpu(bn["mean"])
            sd[f"features.{idx}.running_var"] = cpu(bn["var"])
            sd[f"features.{idx}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
            idx += 1
        idx += 1
    sd["classifier.0.weight"] = cpu(params["fc0"]["w"]).T.contiguous()
    sd["classifier.0.bias"] = cpu(params["fc0"]["b"])
    sd["classifier.2.weight"] = cpu(params["fc1"]["w"]).T.contiguous()
    sd["classifier.2.bias"] = cpu(params["fc1"]["b"])
    return sd


def discriminator_sn_to_state_dict(params: dict, cfg) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`discriminator_sn_from_state_dict`: the reference SN
    layout ``conv{0..2n-1}.{weight_orig,weight,weight_u,bias}`` +
    ``linear{0,1}.*`` (architecture.py:133-175). ``weight`` is the
    sigma-normalised buffer torch's vendored SN registers alongside the
    parameter (spectral_norm.py:66-74), computed from the stored ``u`` exactly
    as a forward pass leaves it, so reference tools can load strict=True."""
    cpu = lambda v: v.detach().to("cpu", torch.float32)

    def put(sd, name, w_store, w2d, b, u):
        u = cpu(u)
        v = w2d.T @ u
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        sigma = float(u @ (w2d @ v))
        sd[f"{name}.weight_orig"] = w_store.contiguous()
        sd[f"{name}.weight"] = (w_store / sigma).contiguous()
        sd[f"{name}.weight_u"] = u
        sd[f"{name}.bias"] = cpu(b)

    sd: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_stages):
        for j, side in enumerate(("a", "b")):
            p = params["convs"][i][side]
            w = cpu(p["w"])  # HWIO
            # sigma is invariant to the contraction-column permutation (hwi
            # here, ihw in torch)
            put(sd, f"conv{2 * i + j}", _hwio_to_oihw(w), w.reshape(-1, w.shape[-1]).T,
                p["b"], p["u"])
    for ours, theirs in (("fc0", "linear0"), ("fc1", "linear1")):
        p = params[ours]
        wt = cpu(p["w"]).T  # [out, in], torch layout
        put(sd, theirs, wt, wt, p["b"], p["u"])
    return sd


def discriminator_sn_from_state_dict(sd: Dict[str, torch.Tensor], cfg,
                                     dtype: torch.dtype = torch.float32) -> dict:
    """Convert the spectral-norm discriminator (``Discriminator_VGG_128_SN``,
    architecture.py:133-175; vendored SN state: ``weight_orig`` + ``weight_u``).
    The power-iteration u imports directly: the port's weight matricisation
    permutes the contraction columns relative to torch's (hwi vs ihw order),
    which leaves u, sigma and the normalised weight invariant."""
    t = lambda v: torch.as_tensor(v).detach().to(dtype)

    def conv(i):
        return {"w": _oihw_to_hwio(t(sd[f"conv{i}.weight_orig"])),
                "b": t(sd[f"conv{i}.bias"]), "u": t(sd[f"conv{i}.weight_u"])}

    params = {"convs": [{"a": conv(2 * i), "b": conv(2 * i + 1)} for i in range(cfg.n_stages)]}
    for ours, theirs in (("fc0", "linear0"), ("fc1", "linear1")):
        params[ours] = {"w": t(sd[f"{theirs}.weight_orig"]).T.contiguous(),
                        "b": t(sd[f"{theirs}.bias"]), "u": t(sd[f"{theirs}.weight_u"])}
    return params
