"""The inference driver: one client super-resolving photographs one at a
time through ``SRInferencer.upscale``, a closed loop.

The images are a fixed list of LR shapes (the traffic's ``shapes``), cycled
in an order drawn from the seed, every cycle holding each once, with 8-bit
content made from the seed. Each request hands a host array in and takes
the host array out; its latency is that call's host-clock time, and the
window's rate is the output megapixels over the window's seconds.

A sample of the window's answers, ``check_images`` requests drawn from the
seed among its first ``check_from``, is copied aside as it comes and held
against the plain reference's fp32 forward of the same image once the
window has closed: the widest and the root-mean-square gap of an output
pixel.
"""

from __future__ import annotations

import gc
import math
import random
import sys
import time

import numpy as np
import torch

from core import data, harness, trace
from core import weights as W


def seeds(seed: int) -> dict:
    """The run's seeds: G's weights, the images, their order, the sample checked."""
    return harness.derive_seeds(seed, ("g", "images", "order", "sample"))


def make_images(shapes, seed: int, device) -> list:
    """One HWC float32 host image per listed (h, w): 8-bit content, as a
    decoded photograph."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for h, w in shapes:
        img = data.to_u8(data.smooth_images(gen, 1, h, w, device)).float() / 255.0
        out.append(np.ascontiguousarray(data.nhwc_host(img)[0]))
    return out


class Order:
    """Indices into the shape list, a fresh permutation each cycle."""

    def __init__(self, n: int, seed: int):
        self.n, self.rng, self.cycle = n, np.random.RandomState(seed % 2 ** 32), []
        self.drawn = []

    def __next__(self) -> int:
        if not self.cycle:
            self.cycle = list(self.rng.permutation(self.n))
        self.drawn.append(int(self.cycle.pop()))
        return self.drawn[-1]


def net_scale(cell) -> int:
    return int(cell.config["recipes"][cell.config["infer"]["recipe"]].get("scale", 4))


def make_model(cell, sd: dict, device):
    """(the inferencer, the benchmark's weights, the reference network, the
    traffic's shapes and images)."""
    from esrganplus_tpu_torch.infer import SRInferencer
    from esrganplus_tpu_torch.options.options import build_net_g_config, wrap_nonedict

    inf_cfg = cell.config["infer"]
    recipe = dict(cell.config["recipes"][inf_cfg["recipe"]])
    recipe["network_G"] = dict(recipe["network_G"], scale=recipe.get("scale", 4))
    net_g = build_net_g_config(wrap_nonedict(recipe))
    w = cell.config["weights"][inf_cfg["weights"]]
    weights = W.of_entry(cell, w, sd["g"], device)
    dtype = {"bfloat16": torch.bfloat16, "float32": None}[inf_cfg["compute_dtype"]]
    model = SRInferencer(W.clone(weights), net_g, dtype=dtype, device=device)
    shapes = [tuple(s) for s in cell.traffic["shapes"]]
    return model, weights, cell.network(w["net"]), shapes, make_images(shapes, sd["images"],
                                                                      device)


def run(cell, args, phases, device="cuda") -> dict:
    """One run of the cell → the result (metrics, checks, ...); ``phases``
    times set-up from the top of ``run.py`` (:class:`core.harness.Phases`)."""
    sd = seeds(args.seed)
    tr = cell.traffic
    cuda = torch.device(device).type == "cuda"
    phases.mark("driver")
    built = harness.build_kernels() if cuda else False
    phases.mark("build")
    model, weights, net, shapes, images = make_model(cell, sd, device)
    phases.mark("model")
    for img in images + images:  # every shape of the traffic, twice
        model.upscale(img)
    phases.mark("warm_up")
    setup_s = phases.total()
    phases.report()

    order = Order(len(shapes), sd["order"])
    # the answers checked: requests drawn from the seed among the first
    # check_from, copied into buffers made now, so that no answer the
    # program returned outlives its request (the host's heap, and so its
    # page faults, would depend on which ones did)
    picks = sorted(random.Random(sd["sample"]).sample(range(int(tr["check_from"])),
                                                      int(tr["check_images"])))
    size = lambda j: (shapes[j][0] * net_scale(cell), shapes[j][1] * net_scale(cell), 3)
    room = max(range(len(shapes)), key=lambda j: np.prod(size(j)))
    buffers = [np.empty(int(np.prod(size(room))), np.float32) for _ in picks]
    kept, lat, pixels = [], [], 0
    start = time.perf_counter()
    end = start
    while end - start < args.seconds:
        j = next(order)
        ts = time.perf_counter()
        out = model.upscale(images[j])
        end = time.perf_counter()
        lat.append(end - ts)
        pixels += out.shape[0] * out.shape[1]
        if len(lat) - 1 in picks:
            buf = buffers[len(kept)][:out.size].reshape(out.shape)
            np.copyto(buf, out)
            kept.append((j, buf))
        del out
    wall = end - start
    by_shape = {}
    for (j, t) in zip(order.drawn, lat):
        by_shape.setdefault(shapes[j], []).append(t * 1e3)
    print("latency ms by shape (count, median, max): "
          + "; ".join(f"{h}x{w}: {len(v)}, {np.median(v):.2f}, {max(v):.2f}"
                      for (h, w), v in sorted(by_shape.items())), file=sys.stderr)
    result = {"attempted": len(lat),
              "failed": sum(1 for _, o in kept if not np.isfinite(o).all()),
              "build_s": phases.seconds["build"] if built else 0.0,
              "metrics": {"setup_s": harness.metric(setup_s, "s"),
                          "sr_mpix_per_s": harness.metric(pixels / 1e6 / wall, "MPix/s"),
                          "sr_image_p95_ms": harness.metric(
                              float(np.percentile(np.asarray(lat) * 1e3, 95)), "ms")}}
    if args.trace:
        n = int(tr["trace_images"])
        idx = [next(order) for _ in range(n)]
        result["slice"] = trace.profile_slice(
            lambda: [model.upscale(images[j]) for j in idx],
            [{"h": shapes[j][0], "w": shapes[j][1]} for j in idx])
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    del model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # no answer to check (a window shorter than check_from requests) is no pass
    gaps = (check(net, weights, [(images[j], out) for j, out in kept], device, "fp32") if kept
            else (math.inf, math.inf))
    result["checks"] = [(k, dict(zip(("max_gap", "rms_gap"), gaps))[k], lim)
                        for k, lim in cell.limits().items()]
    result["correct"] = all(v <= l for _, v, l in result["checks"])
    return result


@torch.no_grad()
def check(net, weights, pairs, device, precision: str) -> tuple:
    """(widest, worst root-mean-square) gap between each answer and the
    reference network ``net``'s clipped output of its image."""
    from reference import layers

    pr = layers.Precision(precision)
    widest = rms = 0.0
    with pr.flags():
        for img, out in pairs:
            x = torch.from_numpy(img).to(device).permute(2, 0, 1)[None]
            ref = net.forward(weights, x, pr).clamp(0, 1)[0].permute(1, 2, 0)
            d = torch.from_numpy(np.asarray(out, np.float32)).to(device) - ref
            if not torch.isfinite(d).all():
                return math.inf, math.inf
            widest = max(widest, float(d.abs().max()))
            rms = max(rms, float(d.square().mean().sqrt()))
    return widest, rms


def readings(cell, seed: int, control: bool, device="cuda") -> list:
    """The compared numbers of one seed over every image of the traffic's
    list, with no window: the program's answers, or with ``control`` the
    reference's at the configuration's control precision."""
    from reference import layers

    sd = seeds(seed)
    model, weights, net, _, images = make_model(cell, sd, device)
    if control:
        pr = layers.Precision(cell.config["control"])
        with torch.no_grad(), pr.flags():
            answers = [net.forward(weights, torch.from_numpy(img).to(device).permute(2, 0, 1)[None],
                                   pr).clamp(0, 1)[0].permute(1, 2, 0).cpu().numpy()
                       for img in images]
    else:
        answers = [model.upscale(img) for img in images]
    del model
    gaps = check(net, weights, list(zip(images, answers)), device, "fp32")
    return [(k, dict(zip(("max_gap", "rms_gap"), gaps))[k], lim)
            for k, lim in cell.limits().items()]
