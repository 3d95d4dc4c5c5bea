"""SRResNet generator (reference ``codes/models/modules/architecture.py:13-44``).

Counterpart of ``esrganplus_tpu/models/srresnet.py``: fea_conv → nb EDSR-style
residual blocks (conv, act, conv, scaled by ``res_scale``) → trunk conv with
the long skip → pixel-shuffle upsampling → HR convs. The block weights are
stacked over nb, as the RRDB trunk's are; the trunk runs as a Python loop.
The default activation is relu (``networks.py:90``); the shipped configs use
no norm.

SRResNet has no CUDA kernel of its own: on the card its convolutions are
cuDNN's, where the JAX package runs XLA's.

Torch key layout (flattened ``B.sequential``, the same rules as RRDBNet):
``model.0`` fea_conv; ``model.1.sub.{n}.res.{0,2}`` the two block convs;
``model.1.sub.{nb}`` the trunk conv; then per upsampling stage [conv,
PixelShuffle, act] at ``model.{2,5,…}``; HR_conv0 / HR_conv1 at the tail
(``model.5/8/10`` for nb=16 ×4, as ``codes/scripts/transfer_params.py:15-20``
reads them).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional

import torch

from esrganplus_tpu_torch.models.layers import act, conv2d, kaiming_conv_init, pixel_shuffle


@dataclasses.dataclass(frozen=True)
class SRResNetConfig:
    in_nc: int = 3
    out_nc: int = 3
    nf: int = 64
    nb: int = 16
    upscale: int = 4
    act_type: str = "relu"
    res_scale: float = 1.0
    # The JAX package's scan unroll: it shapes JAX's compile, not the values.
    # The trunk here is always a Python loop, so any value is accepted and
    # changes nothing.
    unroll: int = 1

    @property
    def n_upscale_stages(self) -> int:
        if self.upscale == 3:
            return 1
        return int(round(math.log2(self.upscale))) if self.upscale > 1 else 0

    @property
    def shuffle(self) -> int:
        """The pixel-shuffle factor of each upsampling stage."""
        return 3 if self.upscale == 3 else 2


def init_srresnet(cfg: SRResNetConfig, seed: int = 0, init_scale: float = 1.0,
                  dtype: torch.dtype = torch.float32) -> dict:
    """Seeded random parameters (CPU) in the JAX package's layout. Values
    differ from ``esrganplus_tpu``'s init for the same seed (another RNG)."""
    gen = torch.Generator().manual_seed(seed)
    conv = lambda cin, cout: kaiming_conv_init(gen, 3, 3, cin, cout, init_scale, dtype=dtype)
    blocks = [{"conv0": conv(cfg.nf, cfg.nf), "conv1": conv(cfg.nf, cfg.nf)}
              for _ in range(cfg.nb)]
    trunk = {name: {leaf: torch.stack([b[name][leaf] for b in blocks]) for leaf in ("w", "b")}
             for name in ("conv0", "conv1")}
    r = cfg.shuffle
    return {
        "fea_conv": conv(cfg.in_nc, cfg.nf),
        "trunk": trunk,
        "trunk_conv": conv(cfg.nf, cfg.nf),
        "upconvs": [conv(cfg.nf, cfg.nf * r * r) for _ in range(cfg.n_upscale_stages)],
        "hr_conv0": conv(cfg.nf, cfg.nf),
        "hr_conv1": conv(cfg.nf, cfg.out_nc),
    }


def srresnet_forward(params: dict, x: torch.Tensor, cfg: SRResNetConfig,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """×``cfg.upscale`` SR of NHWC RGB [0,1] input → fp32. ``dtype`` casts
    every conv's input and weights and keeps its output there, where the JAX
    package's ``conv2d(dtype=...)`` rounds."""
    a = lambda t: act(t, cfg.act_type)
    fea = conv2d(x, params["fea_conv"], dtype=dtype)
    trunk = fea
    for i in range(cfg.nb):
        blk = {name: {leaf: v[i] for leaf, v in params["trunk"][name].items()}
               for name in ("conv0", "conv1")}
        res = conv2d(a(conv2d(trunk, blk["conv0"], dtype=dtype)), blk["conv1"], dtype=dtype)
        trunk = trunk + res * cfg.res_scale
    fea = fea + conv2d(trunk, params["trunk_conv"], dtype=dtype)
    for up in params["upconvs"]:
        fea = a(pixel_shuffle(conv2d(fea, up, dtype=dtype), cfg.shuffle))
    fea = a(conv2d(fea, params["hr_conv0"], dtype=dtype))
    return conv2d(fea, params["hr_conv1"], dtype=dtype).float()


# ---------------------------------------------------------------------------
# torch .pth conversion
# ---------------------------------------------------------------------------

_TOP = re.compile(r"^model\.(\d+)\.weight$")
_BLOCK = re.compile(r"^model\.1\.sub\.(\d+)\.res")


def is_srresnet_state_dict(sd) -> bool:
    return any(".res.0.weight" in k for k in sd)


def _top_convs(sd) -> list:
    return sorted({int(m.group(1)) for k in sd if (m := _TOP.match(k)) and int(m.group(1)) >= 2})


def infer_srresnet_config(sd: Dict[str, torch.Tensor]) -> SRResNetConfig:
    """(nb, nf, in/out channels, upscale) from the keys. One upsampling stage
    whose conv has 9·nf outputs reads as ×3, else ×2 per stage."""
    nb = 1 + max(int(m.group(1)) for k in sd if (m := _BLOCK.match(k)))
    nf, in_nc = sd["model.0.weight"].shape[:2]
    top = _top_convs(sd)
    n_up = len(top) - 2
    upscale = 2 ** n_up
    if n_up == 1 and sd[f"model.{top[0]}.weight"].shape[0] == 9 * nf:
        upscale = 3
    return SRResNetConfig(in_nc=int(in_nc), out_nc=int(sd[f"model.{top[-1]}.weight"].shape[0]),
                          nf=int(nf), nb=nb, upscale=upscale)


def srresnet_from_state_dict(sd: Dict[str, torch.Tensor], cfg: Optional[SRResNetConfig] = None,
                             dtype: torch.dtype = torch.float32):
    """Reference SRResNet state dict → (params on the CPU, cfg)."""
    from esrganplus_tpu_torch.convert.pth import _oihw_to_hwio

    inferred = infer_srresnet_config(sd)
    if cfg is None:
        cfg = inferred
    else:
        for f in ("in_nc", "out_nc", "nf", "nb", "n_upscale_stages"):
            a, b = getattr(cfg, f), getattr(inferred, f)
            if a != b:
                raise ValueError(f"checkpoint mismatch: cfg.{f}={a} but checkpoint has {b}")

    def conv(prefix):
        return {"w": _oihw_to_hwio(torch.as_tensor(sd[prefix + ".weight"])).to(dtype),
                "b": torch.as_tensor(sd[prefix + ".bias"]).detach().to(dtype)}

    blocks = [{"conv0": conv(f"model.1.sub.{n}.res.0"), "conv1": conv(f"model.1.sub.{n}.res.2")}
              for n in range(cfg.nb)]
    trunk = {name: {leaf: torch.stack([b[name][leaf] for b in blocks]) for leaf in ("w", "b")}
             for name in ("conv0", "conv1")}
    top = _top_convs(sd)
    params = {
        "fea_conv": conv("model.0"),
        "trunk": trunk,
        "trunk_conv": conv(f"model.1.sub.{cfg.nb}"),
        "upconvs": [conv(f"model.{i}") for i in top[:-2]],
        "hr_conv0": conv(f"model.{top[-2]}"),
        "hr_conv1": conv(f"model.{top[-1]}"),
    }
    return params, cfg


def srresnet_to_state_dict(params: dict, cfg: SRResNetConfig) -> Dict[str, torch.Tensor]:
    """Export params → a reference-layout state dict of fp32 CPU tensors
    (indices as in the module docstring)."""
    from esrganplus_tpu_torch.convert.pth import _hwio_to_oihw

    sd: Dict[str, torch.Tensor] = {}
    cpu = lambda t: torch.as_tensor(t).detach().to("cpu", torch.float32)

    def put(prefix, p):
        sd[prefix + ".weight"] = _hwio_to_oihw(cpu(p["w"]))
        sd[prefix + ".bias"] = cpu(p["b"]).contiguous()

    put("model.0", params["fea_conv"])
    for n in range(cfg.nb):
        for j, name in ((0, "conv0"), (2, "conv1")):
            put(f"model.1.sub.{n}.res.{j}",
                {leaf: params["trunk"][name][leaf][n] for leaf in ("w", "b")})
    put(f"model.1.sub.{cfg.nb}", params["trunk_conv"])
    idx = 2
    for up in params["upconvs"]:
        put(f"model.{idx}", up)
        idx += 3  # conv, PixelShuffle, act
    put(f"model.{idx}", params["hr_conv0"])
    put(f"model.{idx + 2}", params["hr_conv1"])
    return sd
