"""SFT-GAN: spatial-feature-transform SR conditioned on segmentation maps.

Counterpart of ``esrganplus_tpu/models/sft.py`` (reference
``codes/models/modules/sft_arch.py``):

  * the SFT layer, a seg-conditioned affine modulation
    ``fea·(scale + 1) + shift`` with 1×1 cond convs and lrelu(0.1)
    (``sft_arch.py:8-20``); the torch-legacy variant ``fea·scale + shift``
    with lrelu(0.01) (``sft_arch.py:150-162``), selected by ``legacy``;
  * :class:`SFTNetConfig`: conv0 → nb SFT resblocks (parameters stacked
    over nb, run as a Python loop where JAX scans) → final SFT and conv with
    the long skip → ×4 pixel-shuffle HR branch; CondNet compresses the
    8-class HR seg map ×4 with a 4×4 stride-4 conv and four 1×1s
    (``sft_arch.py:40-83``);
  * :func:`acd_forward`: the ACD_VGG_BN_96 auxiliary-classifier
    discriminator, a BN pyramid to 512×6×6 with lrelu(0.1) and two linear
    heads (gan 1, cls 8) on the NCHW flatten (``sft_arch.py:87-142``).

Parameters are the JAX package's trees (HWIO weights), so both carry across
with no transposition. Nothing here runs a kernel of the port: on the card
the convolutions, batch norms and linears are cuDNN's / cuBLAS's, where the
JAX package runs XLA's. ``dtype`` casts each conv's and linear's input and
weights and keeps its output there, where the JAX package's ``conv2d`` and
``linear`` round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from esrganplus_tpu_torch.models.layers import (
    act,
    batchnorm,
    batchnorm_init,
    conv2d,
    kaiming_conv_init,
    kaiming_linear_init,
    linear,
    pixel_shuffle,
)


@dataclasses.dataclass(frozen=True)
class SFTNetConfig:
    in_nc: int = 3
    out_nc: int = 3
    nf: int = 64
    nb: int = 16
    cond_in: int = 8  # seg classes
    cond_nf: int = 32
    legacy: bool = False  # torch-version SFT semantics
    # The JAX package's scan unroll: it shapes JAX's compile, not the values.
    # The blocks here run as a Python loop, so any value is accepted and
    # changes nothing.
    unroll: int = 1
    upscale: int = 4  # fixed ×4 HR branch (two pixel-shuffle stages)

    @property
    def sft_slope(self) -> float:
        return 0.01 if self.legacy else 0.1


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sft_layer(gen, cfg: SFTNetConfig, dtype) -> dict:
    c = cfg.cond_nf
    return {"scale0": kaiming_conv_init(gen, 1, 1, c, c, dtype=dtype),
            "scale1": kaiming_conv_init(gen, 1, 1, c, cfg.nf, dtype=dtype),
            "shift0": kaiming_conv_init(gen, 1, 1, c, c, dtype=dtype),
            "shift1": kaiming_conv_init(gen, 1, 1, c, cfg.nf, dtype=dtype)}


def _stack(trees: list):
    """A list of equally shaped trees → one tree of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _unstack(tree, i: int):
    """Entry ``i`` of a tree of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def init_sftnet(cfg: SFTNetConfig = SFTNetConfig(), seed: int = 0,
                dtype: torch.dtype = torch.float32) -> dict:
    """Seeded He-normal parameters (CPU), unscaled as the JAX package's
    ``init_sftnet``; the values differ from its init for the same seed
    (another RNG)."""
    gen = torch.Generator().manual_seed(seed)
    conv = lambda k, cin, cout: kaiming_conv_init(gen, k, k, cin, cout, dtype=dtype)
    nf = cfg.nf
    blocks = [{"sft0": _init_sft_layer(gen, cfg, dtype), "conv0": conv(3, nf, nf),
               "sft1": _init_sft_layer(gen, cfg, dtype), "conv1": conv(3, nf, nf)}
              for _ in range(cfg.nb)]
    return {
        "conv0": conv(3, cfg.in_nc, nf),
        "blocks": _stack(blocks),
        "final_sft": _init_sft_layer(gen, cfg, dtype),
        "final_conv": conv(3, nf, nf),
        "hr": {"up0": conv(3, nf, nf * 4), "up1": conv(3, nf, nf * 4),
               "conv0": conv(3, nf, nf), "conv1": conv(3, nf, cfg.out_nc)},
        "cond": {"c0": conv(4, cfg.cond_in, 128), "c1": conv(1, 128, 128),
                 "c2": conv(1, 128, 128), "c3": conv(1, 128, 128),
                 "c4": conv(1, 128, cfg.cond_nf)},
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _sft_layer(fea, cond, p: dict, cfg: SFTNetConfig, dtype):
    s = cfg.sft_slope
    scale = conv2d(act(conv2d(cond, p["scale0"], dtype=dtype), "leakyrelu", s),
                   p["scale1"], dtype=dtype)
    shift = conv2d(act(conv2d(cond, p["shift0"], dtype=dtype), "leakyrelu", s),
                   p["shift1"], dtype=dtype)
    if cfg.legacy:
        return fea * scale + shift
    return fea * (scale + 1.0) + shift


def sftnet_forward(params: dict, img: torch.Tensor, seg: torch.Tensor,
                   cfg: SFTNetConfig = SFTNetConfig(),
                   dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """img ``[B, h, w, 3]`` LR RGB [0,1]; seg ``[B, 4h, 4w, 8]`` HR seg
    probabilities → fp32 ``[B, 4h, 4w, 3]``."""
    c = params["cond"]  # CondNet: a 4×4 stride-4 conv, then lrelu(0.1) and 1×1s
    cond = conv2d(seg, c["c0"], stride=4, pad="valid", dtype=dtype)
    for name in ("c1", "c2", "c3", "c4"):
        cond = conv2d(act(cond, "leakyrelu", 0.1), c[name], dtype=dtype)
    fea0 = conv2d(img, params["conv0"], dtype=dtype)
    fea = fea0
    blocks = params["blocks"]
    for i in range(blocks["conv0"]["w"].shape[0]):
        blk = _unstack(blocks, i)
        h = _sft_layer(fea, cond, blk["sft0"], cfg, dtype)
        h = act(conv2d(h, blk["conv0"], dtype=dtype), "relu")
        h = _sft_layer(h, cond, blk["sft1"], cfg, dtype)
        fea = fea + conv2d(h, blk["conv1"], dtype=dtype)
    fea = _sft_layer(fea, cond, params["final_sft"], cfg, dtype)
    fea = fea0 + conv2d(fea, params["final_conv"], dtype=dtype)
    hr = params["hr"]
    fea = act(pixel_shuffle(conv2d(fea, hr["up0"], dtype=dtype), 2), "relu")
    fea = act(pixel_shuffle(conv2d(fea, hr["up1"], dtype=dtype), 2), "relu")
    fea = act(conv2d(fea, hr["conv0"], dtype=dtype), "relu")
    return conv2d(fea, hr["conv1"], dtype=dtype).float()


def is_sft_param(path: str) -> bool:
    """The SFT-GAN trainer's label rule (``esrganplus_tpu/train/
    sftgan_model.py:87-95``): a leaf whose "/"-joined tree path contains
    ``sft`` or ``cond`` (any case) is in the ``sft`` group (5× lr), every
    other leaf in ``other``."""
    p = path.lower()
    return "sft" in p or "cond" in p


# ---------------------------------------------------------------------------
# ACD discriminator (auxiliary classifier, 96×96)
# ---------------------------------------------------------------------------

ACD_PLAN = [  # (kernel, stride, cout, bn)
    (3, 1, 64, False), (4, 2, 64, True),
    (3, 1, 128, True), (4, 2, 128, True),
    (3, 1, 256, True), (4, 2, 256, True),
    (3, 1, 512, True), (4, 2, 512, True),
]
ACD_CLASSES = 8


def init_acd(seed: int = 0, dtype: torch.dtype = torch.float32) -> dict:
    """Seeded He-normal ACD parameters (CPU) in the JAX package's layout
    (``bn[0]`` is None: the first conv has no norm)."""
    gen = torch.Generator().manual_seed(seed)
    convs, bns = [], []
    cin = 3
    for k, _s, cout, bn in ACD_PLAN:
        convs.append(kaiming_conv_init(gen, k, k, cin, cout, dtype=dtype))
        bns.append(batchnorm_init(cout, dtype) if bn else None)
        cin = cout
    return {"convs": convs, "bn": bns,
            "gan0": kaiming_linear_init(gen, 512 * 6 * 6, 100, dtype=dtype),
            "gan1": kaiming_linear_init(gen, 100, 1, dtype=dtype),
            "cls0": kaiming_linear_init(gen, 512 * 6 * 6, 100, dtype=dtype),
            "cls1": kaiming_linear_init(gen, 100, ACD_CLASSES, dtype=dtype)}


def acd_forward(params: dict, x: torch.Tensor, train: bool = False,
                dtype: Optional[torch.dtype] = None):
    """x ``[B, 96, 96, 3]`` → (fp32 gan logits ``[B, 1]``, fp32 class
    logits ``[B, 8]``, BN updates: one entry per conv, None where it has no
    norm). The heads read the NCHW flatten, as torch's."""
    h = x
    updates = []
    for p, bn, (k, s, _cout, has_bn) in zip(params["convs"], params["bn"], ACD_PLAN):
        h = conv2d(h, p, stride=s, pad=("same" if k == 3 else 1), dtype=dtype)
        upd = None
        if has_bn:
            h, upd = batchnorm(h, bn, train)
        updates.append(upd)
        h = act(h, "leakyrelu", 0.1)
    h = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1)  # NCHW flatten order
    head = lambda a, b: linear(act(linear(h, params[a], dtype=dtype), "leakyrelu", 0.1),
                               params[b], dtype=dtype).float()
    return head("gan0", "gan1"), head("cls0", "cls1"), updates


def acd_apply_updates(params: dict, updates) -> dict:
    """Fold one forward's BN updates into a new parameter tree."""
    out = dict(params)
    out["bn"] = [({**bn, **upd} if (bn is not None and upd is not None) else bn)
                 for bn, upd in zip(params["bn"], updates)]
    return out


@torch.no_grad()
def acd_merge_sequential(params: dict, upd_first, upd_second, momentum: float = 0.9) -> dict:
    """Fold two train-forward BN updates made from the same running
    statistics as if applied one after the other (torch updates them on
    every forward): ``m·u1 + (u2 − m·old)``, as
    ``discriminator.merge_sequential_bn``."""
    out = dict(params)
    out["bn"] = [
        ({**{k: momentum * u1[k] + (u2[k] - momentum * bn[k]) for k in ("mean", "var")},
          "scale": bn["scale"], "bias": bn["bias"]}
         if (bn is not None and u1 is not None and u2 is not None) else bn)
        for bn, u1, u2 in zip(params["bn"], upd_first, upd_second)]
    return out


# ---------------------------------------------------------------------------
# torch .pth conversion (SFT_Net layout: sft_branch.{0..nb-1} resblocks, nb
# the final SFT, nb+1 the final conv; HR_branch indices 0, 3, 6, 8; CondNet
# 0, 2, 4, 6, 8)
# ---------------------------------------------------------------------------

_SFT_TORCH = (("scale0", "SFT_scale_conv0"), ("scale1", "SFT_scale_conv1"),
              ("shift0", "SFT_shift_conv0"), ("shift1", "SFT_shift_conv1"))
_HR_TORCH = (("up0", "HR_branch.0"), ("up1", "HR_branch.3"),
             ("conv0", "HR_branch.6"), ("conv1", "HR_branch.8"))
_HEADS_TORCH = (("gan0", "gan.0"), ("gan1", "gan.2"), ("cls0", "cls.0"), ("cls1", "cls.2"))


def _conv_from(sd, prefix: str, dtype) -> dict:
    from esrganplus_tpu_torch.convert.pth import _oihw_to_hwio

    return {"w": _oihw_to_hwio(torch.as_tensor(sd[prefix + ".weight"]).detach()).to(dtype),
            "b": torch.as_tensor(sd[prefix + ".bias"]).detach().to(dtype)}


def _cpu(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _put_conv(sd: dict, prefix: str, p: dict) -> None:
    from esrganplus_tpu_torch.convert.pth import _hwio_to_oihw

    sd[prefix + ".weight"] = _hwio_to_oihw(_cpu(p["w"]))
    sd[prefix + ".bias"] = _cpu(p["b"]).contiguous()


def sftnet_from_state_dict(sd: Dict[str, torch.Tensor], cfg: SFTNetConfig = SFTNetConfig(),
                           dtype: torch.dtype = torch.float32) -> Tuple[dict, SFTNetConfig]:
    """Reference SFT_Net state dict → (params on the CPU, cfg). ``cfg.nb``
    is corrected to the checkpoint's depth, so use the returned cfg."""
    # the sft_branch indices run to nb + 1: nb resblocks, the final SFT
    # layer, the final conv
    nb = max(int(k.split(".")[1]) for k in sd if k.startswith("sft_branch.")) - 1
    if nb != cfg.nb:
        cfg = dataclasses.replace(cfg, nb=nb)
    layer = lambda prefix: {ours: _conv_from(sd, f"{prefix}.{theirs}", dtype)
                            for ours, theirs in _SFT_TORCH}
    blocks = [{"sft0": layer(f"sft_branch.{i}.sft0"),
               "conv0": _conv_from(sd, f"sft_branch.{i}.conv0", dtype),
               "sft1": layer(f"sft_branch.{i}.sft1"),
               "conv1": _conv_from(sd, f"sft_branch.{i}.conv1", dtype)} for i in range(nb)]
    params = {
        "conv0": _conv_from(sd, "conv0", dtype),
        "blocks": _stack(blocks),
        "final_sft": layer(f"sft_branch.{nb}"),
        "final_conv": _conv_from(sd, f"sft_branch.{nb + 1}", dtype),
        "hr": {ours: _conv_from(sd, theirs, dtype) for ours, theirs in _HR_TORCH},
        "cond": {f"c{i}": _conv_from(sd, f"CondNet.{2 * i}", dtype) for i in range(5)},
    }
    return params, cfg


def sftnet_to_state_dict(params: dict, cfg: SFTNetConfig = SFTNetConfig()
                         ) -> Dict[str, torch.Tensor]:
    """Export params → the reference SFT_Net key layout (fp32 CPU tensors)."""
    sd: Dict[str, torch.Tensor] = {}

    def put_sft(prefix, layer):
        for ours, theirs in _SFT_TORCH:
            _put_conv(sd, f"{prefix}.{theirs}", layer[ours])

    _put_conv(sd, "conv0", params["conv0"])
    for i in range(cfg.nb):
        blk = _unstack(params["blocks"], i)
        put_sft(f"sft_branch.{i}.sft0", blk["sft0"])
        _put_conv(sd, f"sft_branch.{i}.conv0", blk["conv0"])
        put_sft(f"sft_branch.{i}.sft1", blk["sft1"])
        _put_conv(sd, f"sft_branch.{i}.conv1", blk["conv1"])
    put_sft(f"sft_branch.{cfg.nb}", params["final_sft"])
    _put_conv(sd, f"sft_branch.{cfg.nb + 1}", params["final_conv"])
    for ours, theirs in _HR_TORCH:
        _put_conv(sd, theirs, params["hr"][ours])
    for i in range(5):
        _put_conv(sd, f"CondNet.{2 * i}", params["cond"][f"c{i}"])
    return sd


def acd_from_state_dict(sd: Dict[str, torch.Tensor],
                        dtype: torch.dtype = torch.float32) -> dict:
    """Reference ``ACD_VGG_BN_96`` state dict → params on the CPU. Layout
    (``sft_arch.py:87-142``): ``feature.N`` with the conv at 0, then
    conv / BN pairs every 3 indices (2/3, 5/6, …, 20/21); heads
    ``gan.{0,2}`` / ``cls.{0,2}`` on the NCHW 512·6·6 flatten."""
    t = lambda v: torch.as_tensor(v).detach().to(dtype)
    convs, bns = [], []
    idx = 0
    for _k, _s, _cout, has_bn in ACD_PLAN:
        convs.append(_conv_from(sd, f"feature.{idx}", dtype))
        idx += 1
        bn = None
        if has_bn:
            bn = {"scale": t(sd[f"feature.{idx}.weight"]), "bias": t(sd[f"feature.{idx}.bias"]),
                  "mean": t(sd[f"feature.{idx}.running_mean"]),
                  "var": t(sd[f"feature.{idx}.running_var"])}
            idx += 1
        bns.append(bn)
        idx += 1  # in-place LeakyReLU
    params = {"convs": convs, "bn": bns}
    for ours, theirs in _HEADS_TORCH:
        params[ours] = {"w": t(sd[f"{theirs}.weight"]).T.contiguous(),
                        "b": t(sd[f"{theirs}.bias"])}
    return params


def acd_to_state_dict(params: dict) -> Dict[str, torch.Tensor]:
    """Export params → the reference ``ACD_VGG_BN_96`` layout (loadable
    with ``strict=True`` upstream: BN ``num_batches_tracked`` included)."""
    sd: Dict[str, torch.Tensor] = {}
    idx = 0
    for p, bn, (_k, _s, _cout, has_bn) in zip(params["convs"], params["bn"], ACD_PLAN):
        _put_conv(sd, f"feature.{idx}", p)
        idx += 1
        if has_bn:
            for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                                 ("mean", "running_mean"), ("var", "running_var")):
                sd[f"feature.{idx}.{theirs}"] = _cpu(bn[ours]).contiguous()
            sd[f"feature.{idx}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
            idx += 1
        idx += 1
    for ours, theirs in _HEADS_TORCH:
        sd[f"{theirs}.weight"] = _cpu(params[ours]["w"]).T.contiguous()
        sd[f"{theirs}.bias"] = _cpu(params[ours]["b"]).contiguous()
    return sd
