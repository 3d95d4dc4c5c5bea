"""One-shot super-resolution inference (the reference's ``test_image/test.py`` surface).

Counterpart of ``esrganplus_tpu/infer.py``. Runs on the card unless the
caller passes ``device="cpu"``; with no card and no explicit CPU it raises,
it does not fall back. On the card the forward goes through the CUDA kernels
(``models/rrdb.py``), with their weights converted once here.

Reference behaviour mirrored (``test_image/test.py:26-40``): BGR uint8 on disk →
RGB [0,1] → forward → clamp(0,1) → BGR ×255 rounded PNG named ``<base>_rlt.png``.

Not ported yet: ``ShardedEvaluator`` (mesh evaluation).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from esrganplus_tpu_torch.convert import generator_from_state_dict, load_state_dict
from esrganplus_tpu_torch.models import RRDBNetConfig, generator_forward
from esrganplus_tpu_torch.models.rrdb import needs_kernel_weights, prep_trunk_ct
from esrganplus_tpu_torch.ops.image_io import img2tensor, tensor2img


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def params_to(params, device):
    """Move a parameter tree to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to(v, device) for v in params]
    return params.to(device) if isinstance(params, torch.Tensor) else params


def load_generator(path: str, cfg: Optional[RRDBNetConfig] = None,
                   missing_conv1x1: str = "zeros", device="cuda"):
    """Load a reference RRDBNet ``.pth`` → (params on ``device``, cfg, info)."""
    dev = resolve_device(device)
    params, cfg, info = generator_from_state_dict(load_state_dict(path), cfg,
                                                  missing_conv1x1=missing_conv1x1)
    return params_to(params, dev), cfg, info


class SRInferencer:
    """×scale SR on arbitrary-size images.

    ``dtype=None`` is the fp32 parity path; ``torch.bfloat16`` the
    throughput path.

    ``noise_rng`` (an integer seed) activates the nESRGAN+/Tarsier noise
    sites at inference with a DETERMINISTIC realisation: every forward
    re-seeds a device generator from it, so the same image gives the same
    output (the Tarsier workflow evolves/selects such realisations per image;
    reference README.md:6, arXiv:2009.12177). The forward then runs in train
    mode without gradients, on the card through the training kernels' forward.
    None = standard deterministic inference."""

    def __init__(self, params, cfg: RRDBNetConfig, dtype: Optional[torch.dtype] = None,
                 pad_multiple: Optional[int] = None, noise_rng: Optional[int] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        params = params_to(params, self.device)
        kdt = dtype or torch.float32
        self.noise_active = noise_rng is not None
        self._noise_seed = noise_rng
        self._noise_gen = torch.Generator(device=self.device) if self.noise_active else None
        if (not self.noise_active and needs_kernel_weights(cfg, self.device, kdt)
                and params.get("trunk_ct", {}).get("dtype") != kdt):
            # convert the kernels' weights once, not inside every forward
            params = prep_trunk_ct(params, cfg, kdt)
        self.params = params
        self.cfg = cfg
        self.dtype = dtype
        self.pad_multiple = pad_multiple

    def upscale(self, img_rgb: np.ndarray, noise=None) -> np.ndarray:
        """HWC (or NHWC) RGB [0,1] float → upscaled float32 RGB, clipped to [0,1].
        In the noise mode ``noise`` may hand in the pre-drawn realisation
        (``models.rrdb.draw_noise`` layout) instead of the seeded draw."""
        x = np.asarray(img_rgb, np.float32)
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        h, w = x.shape[1], x.shape[2]
        if self.pad_multiple:
            m = self.pad_multiple
            ph, pw = (-h) % m, (-w) % m
            if ph or pw:
                x = np.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if self.noise_active:
            rng = self._noise_gen.manual_seed(self._noise_seed)
            with torch.no_grad():
                # threefry, as JAX's inferencer key: a fused-noise config
                # applies the noise between kernel calls and needs no site seeds
                y = generator_forward(self.params, xt, self.cfg, train=True, rng=rng,
                                      noise=noise, noise_prng="threefry", dtype=self.dtype)
        else:
            with torch.inference_mode():
                y = generator_forward(self.params, xt, self.cfg, dtype=self.dtype)
        s = self.cfg.upscale
        out = y[:, : h * s, : w * s, :].clamp(0.0, 1.0).cpu().numpy()
        return out[0] if squeeze else out

    def upscale_bgr_to_png(self, img_bgr01: np.ndarray) -> np.ndarray:
        """HWC BGR [0,1] → HWC BGR uint8 result (file-format ready)."""
        return tensor2img(self.upscale(img2tensor(img_bgr01)))

    def upscale_x8(self, img_rgb: np.ndarray, batched: bool = True) -> np.ndarray:
        """Geometric self-ensemble (EDSR-style ``test_x8``, reference
        ``codes/models/SR_model.py:82-120``): average the SR results of the 8
        dihedral transforms of the input, each inverse-transformed back.
        ``batched`` runs the 4 untransposed and the 4 transposed variants as
        two batched forwards instead of 8. In the noise mode batching would
        change the noise shapes, and with them the realisation each variant
        sees, so the per-variant path is forced, as in the JAX package."""
        assert img_rgb.ndim == 3
        if self.noise_active:
            batched = False

        def tf(img, op):
            if op == "v":
                return img[:, ::-1, :]
            if op == "h":
                return img[::-1, :, :]
            return img.transpose(1, 0, 2)  # 't'

        variants = [img_rgb]
        for op in ("v", "h", "t"):
            variants.extend(tf(v, op) for v in list(variants))

        if batched:
            srs = [None] * 8
            for group in ((0, 1, 2, 3), (4, 5, 6, 7)):
                out = self.upscale(np.stack([np.ascontiguousarray(variants[i])
                                             for i in group]))
                for j, i in enumerate(group):
                    srs[i] = out[j]
        else:
            srs = [self.upscale(np.ascontiguousarray(v)) for v in variants]

        outs = []
        for i, y in enumerate(srs):
            # inverse: ops applied in order v(bit0), h(bit1), t(bit2) — undo in reverse
            if i > 3:
                y = y.transpose(1, 0, 2)
            if (i % 4) > 1:
                y = y[::-1, :, :]
            if (i % 2) == 1:
                y = y[:, ::-1, :]
            outs.append(y)
        return np.mean(outs, axis=0)

    def derive_halo(self, eps: float = 1e-3, probe: int = 64, seed: int = 0) -> int:
        """Effective receptive radius (LR px) of THIS network's weights:
        perturb one pixel of a random probe image and find the largest radius
        where the output still changes by more than ``eps`` × the peak
        response. Stitched tiles with this halo are not bit-exact vs
        whole-image inference, but their seam error is below eps·peak.
        Cached per (eps, probe, seed); costs two forwards at probe size."""
        key = (float(eps), int(probe), int(seed))
        cache = getattr(self, "_halo_cache", {})
        if key in cache:
            return cache[key]
        rng = np.random.RandomState(seed)
        img = rng.rand(probe, probe, 3).astype(np.float32)
        base = self.upscale(img)
        img2 = img.copy()
        c = probe // 2
        img2[c, c, :] = 1.0 - img2[c, c, :]
        diff = np.abs(self.upscale(img2) - base).max(axis=2)
        s = self.cfg.upscale
        peak = float(diff.max())
        ys, xs = np.nonzero(diff > eps * max(peak, 1e-12))
        if len(ys) == 0:
            halo = 4
        else:
            # distance from the perturbed LR pixel's HR footprint, in LR px
            dy = np.maximum(0, np.maximum(c * s - ys, ys - (c * s + s - 1)))
            dx = np.maximum(0, np.maximum(c * s - xs, xs - (c * s + s - 1)))
            halo = int(-(-int(np.maximum(dy, dx).max()) // s)) + 1
        halo = max(4, min(halo, probe // 2 - 1))
        cache[key] = halo
        self._halo_cache = cache
        return halo

    def upscale_tiled(self, img_rgb: np.ndarray, tile: int = 128,
                      halo: Optional[int] = None, tile_batch: int = 8,
                      halo_eps: float = 1e-3) -> np.ndarray:
        """Spatially-tiled SR for images too large for one pass: ``tile``² LR
        tiles with a ``halo``-px overlap, centre-stitched, up to
        ``tile_batch`` tiles per batched forward. ``halo=None`` derives it
        from the weights via :meth:`derive_halo`."""
        if halo is None:
            halo = min(self.derive_halo(eps=halo_eps), max(1, (tile - 2) // 2))
        h, w, c = img_rgb.shape
        s = self.cfg.upscale
        if h <= tile and w <= tile:
            return self.upscale(img_rgb)
        out = np.zeros((h * s, w * s, c), np.float32)
        step = tile - 2 * halo
        assert step > 0, "tile must exceed 2*halo"
        ys = list(range(0, max(h - 2 * halo, 1), step))
        xs = list(range(0, max(w - 2 * halo, 1), step))

        jobs = []  # (y0c, x0c, y1, x1) with uniform [tile, tile] extraction
        for y0 in ys:
            for x0 in xs:
                y1, x1 = min(y0 + tile, h), min(x0 + tile, w)
                jobs.append((max(0, y1 - tile), max(0, x1 - tile), y1, x1))

        def paste(job, sr):
            y0c, x0c, y1, x1 = job
            ty0 = 0 if y0c == 0 else halo
            tx0 = 0 if x0c == 0 else halo
            ty1 = (y1 - y0c) if y1 == h else (y1 - y0c) - halo
            tx1 = (x1 - x0c) if x1 == w else (x1 - x0c) - halo
            out[(y0c + ty0) * s:(y0c + ty1) * s, (x0c + tx0) * s:(x0c + tx1) * s, :] = \
                sr[ty0 * s:ty1 * s, tx0 * s:tx1 * s, :]

        for i in range(0, len(jobs), tile_batch):
            chunk = jobs[i:i + tile_batch]
            stack = np.stack([img_rgb[y0c:y0c + tile, x0c:x0c + tile, :]
                              for (y0c, x0c, _, _) in chunk])
            if len(chunk) < tile_batch:  # keep one batch shape for every call
                pad = np.zeros((tile_batch - len(chunk),) + stack.shape[1:], stack.dtype)
                stack = np.concatenate([stack, pad])
            for job, sr in zip(chunk, self.upscale(stack)):
                paste(job, sr)
        return out
