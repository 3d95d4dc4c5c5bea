"""The FLOP and byte counts of ``flops/`` against what the plain reference's
graphs run, counted by ``torch.utils.flop_counter.FlopCounterMode`` (FLOPs)
and by a dispatch mode that sums each convolution's and matrix product's
operands and results once (bytes), at small widths on the CPU: each network
forward, its data gradient and its weight gradient, and each recipe's step."""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [HERE]

from core import counting  # noqa: E402
from core import harness  # noqa: E402
from core import weights as W  # noqa: E402
from reference import layers, optim  # noqa: E402

aten = torch.ops.aten
ESR = harness.load_module(os.path.join(HERE, "flops", "esrganplus_x4.py"), "flops_esr_test")
SFT = harness.load_module(os.path.join(HERE, "flops", "sftgan_x4.py"), "flops_sft_test")
PR = layers.Precision("fp32")
NETS = {n: layers.net(n, os.path.join(HERE, "reference"))
        for n in ("rrdbnet", "discriminator_vgg", "vgg19", "sftnet", "acd")}


def make(net, seed, init=None, **args):
    """Seeded weights of reference network ``net`` at ``args``, on the CPU."""
    return W.make(NETS[net].spec(**args), seed, "cpu", init)


class ByteCounter(TorchDispatchMode):
    """Bytes of every convolution and matrix product: operands read once,
    results written once (a convolution's bias is not counted)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        nb = lambda t: t.numel() * t.element_size() if torch.is_tensor(t) else 0
        if func is aten.convolution.default:
            self.bytes += nb(args[0]) + nb(args[1]) + nb(out)
        elif func is aten.convolution_backward.default:
            g, x, w, mask = args[0], args[1], args[2], args[-1]
            if mask[0]:
                self.bytes += nb(g) + nb(w) + nb(out[0])
            if mask[1]:
                self.bytes += nb(g) + nb(x) + nb(out[1])
        elif func in (aten.mm.default, aten.addmm.default):
            a, b = (args[0], args[1]) if func is aten.mm.default else (args[1], args[2])
            self.bytes += nb(a) + nb(b) + nb(out)
        return out


def counted(fn):
    """(FLOPs, bytes) that ``fn()`` runs."""
    fc, bc = FlopCounterMode(display=False), ByteCounter()
    with fc, bc:
        fn()
    return fc.get_total_flops(), bc.bytes


def tally(layers, **kw):
    return counting.Tally(4).add(layers, **kw)


def test_rrdbnet_forward_dx_dw():
    params = make("rrdbnet", 1, {"scale": 0.1}, nf=8, nb=2, gc=4)
    g = ESR.rrdbnet(2, 6, 5, nf=8, nb=2, gc=4)
    layers = g["fea"] + g["trunk"] + g["tail"]
    check_passes(lambda p, xi: NETS["rrdbnet"].forward(p, xi, PR), torch.rand(2, 3, 6, 5), params, layers)


def check_passes(fwd, x, params, layers):
    f, fdx, fdw = _measure(fwd, x, params)
    for got, want in ((f, tally(layers, dx=False, dw=False)), (fdx, tally(layers, dw=False)),
                      (fdw, tally(layers, skip_first_dx=True))):
        assert got == (want.total_flops, want.total_bytes)


def _measure(fwd, x, params):
    """(forward), (forward + every dx), (forward + dx but the first + dW)."""
    out = []
    for grad_x, grad_w in ((False, False), (True, False), (False, True)):
        p = optim.detached(params)
        if grad_w:
            optim.trainable(p)
        xi = x.detach().clone().requires_grad_(grad_x)

        def fn():
            y = fwd(p, xi)
            y = y if torch.is_tensor(y) else sum(o.sum() for o in y)
            if grad_x or grad_w:
                y.sum().backward()

        out.append(counted(fn))
    return out


@pytest.mark.parametrize("net", ["discriminator", "vgg19", "sftnet", "acd"])
def test_network_forward_dx_dw(net):
    if net == "discriminator":
        params = make("discriminator_vgg", 2, input_size=96, base_nf=4)
        x = torch.rand(2, 3, 96, 96)
        layers = ESR.discriminator(2, 96, 4)
        fwd = lambda p, xi: NETS["discriminator_vgg"].forward(p, xi, PR)
    elif net == "vgg19":
        params = make("vgg19", 3)
        x = torch.rand(1, 3, 32, 32)
        layers = counting.vgg19_convs(1, 32, 32)
        fwd = lambda p, xi: NETS["vgg19"].forward(p, xi, PR)
    elif net == "sftnet":
        params = make("sftnet", 4, nf=8, nb=2)
        seg = torch.rand(2, 8, 20, 24)
        g = SFT.sftnet(2, 5, 6, nf=8, nb=2)
        every = g["conv0"] + g["cond0"] + g["cond"] + g["sft"] + g["body"] + g["hr"]
        f, fdx, fdw = _measure(lambda p, xi: NETS["sftnet"].forward(p, xi, seg, PR), torch.rand(2, 3, 5, 6),
                               params)
        fwd = tally(every, dx=False, dw=False)
        # from the image: the data gradient of conv0, the body and the HR
        # branch (CondNet and the SFT convs see only the seg map)
        img = copy.deepcopy(fwd).merge(tally(g["conv0"] + g["body"] + g["hr"], fwd=False,
                                             dw=False))
        # to the weights: every dW, and dx wherever a weight lies upstream
        # (not into the image or the seg map)
        wts = copy.deepcopy(fwd).merge(tally(every, fwd=False, dx=False)).merge(
            tally(g["cond"] + g["sft"] + g["body"] + g["hr"], fwd=False, dw=False))
        for got, want in ((f, fwd), (fdx, img), (fdw, wts)):
            assert got == (want.total_flops, want.total_bytes)
        return
    else:
        params = make("acd", 5)
        x = torch.rand(2, 3, 96, 96)
        layers = SFT.acd(2)
        fwd = lambda p, xi: NETS["acd"].forward(p, xi, PR)
    check_passes(fwd, x, params, layers)


def _tiny_esr():
    c = harness.load_json(os.path.join(HERE, "configs", "esrganplus_x4.json"))
    c = copy.deepcopy(c)
    for r in c["recipes"].values():
        r["network_G"].update(nf=8, nb=1, gc=4)
        r["train"].pop("compute_dtype", None)
    c["recipes"]["gan"]["network_D"]["nf"] = 4
    return c


def _batches(n, hr, seg=False):
    g = torch.Generator().manual_seed(0)
    b = {"LR": torch.rand(n, 3, hr // 4, hr // 4, generator=g),
         "HR": torch.rand(n, 3, hr, hr, generator=g)}
    if seg:
        b["seg"] = torch.rand(n, 8, hr, hr, generator=g)
        b["category"] = torch.tensor([1, 2])
    return [b]


@pytest.mark.parametrize("recipe", ["psnr", "gan"])
def test_esrganplus_step_counts(recipe):
    """One reference step of each ESRGAN+ recipe runs the FLOPs
    ``flops/esrganplus_x4.train_step`` counts (fp32, so 4 bytes an element)."""
    c = _tiny_esr()
    model = c["recipes"][recipe]["model"]
    steps = harness.load_module(os.path.join(HERE, "reference", f"steps_{model}.py"),
                                f"steps_{model}_flops_test")
    weights = {"g": make("rrdbnet", 1, {"scale": 0.1}, nf=8, nb=1, gc=4)}
    if model == "srragan":
        weights["d"] = make("discriminator_vgg", 2, input_size=128, base_nf=4)
        weights["f"] = make("vgg19", 3)
    hr = 128
    fl, by = counted(lambda: steps.run(weights, c["recipes"][recipe], _batches(2, hr), [None],
                                       PR))
    want = ESR.train_step(c, recipe, 2, hr)["total"]
    assert (fl, by) == (want.total_flops, want.total_bytes)


def test_sftgan_step_counts():
    c = copy.deepcopy(harness.load_json(os.path.join(HERE, "configs", "sftgan_x4.json")))
    c["recipes"]["gan"]["network_G"]["nb"] = 2
    steps = harness.load_module(os.path.join(HERE, "reference", "steps_sftgan.py"),
                                "steps_sftgan_flops_test")
    weights = {"g": make("sftnet", 1, {"scale_by_path": {"/blocks": 0.1}}, nb=2),
               "d": make("acd", 2), "f": make("vgg19", 3)}
    fl, by = counted(lambda: steps.run(weights, c["recipes"]["gan"], _batches(2, 96, seg=True),
                                       [None], PR))
    want = SFT.train_step(c, "gan", 2, 96)["total"]
    assert (fl, by) == (want.total_flops, want.total_bytes)


def test_image_counts():
    c = _tiny_esr()
    c["infer"]["compute_dtype"] = "float32"
    params = make("rrdbnet", 1, nf=8, nb=1, gc=4)
    x = torch.rand(1, 3, 7, 9)
    with torch.no_grad():
        got = counted(lambda: NETS["rrdbnet"].forward(params, x, PR))
    t = ESR.image(c, 7, 9)
    assert got == (t["total"].total_flops, t["total"].total_bytes)


def test_config_files_parse():
    for name in ("esrganplus_x4", "sftgan_x4"):
        json.dumps(harness.load_json(os.path.join(HERE, "configs", f"{name}.json")))
