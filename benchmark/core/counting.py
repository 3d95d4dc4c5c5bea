"""The arithmetic of the yardstick: FLOPs and bytes of convolutions and
linears, the published peaks of one H100, and VGG19's layers (the
perceptual net both configurations share).

A FLOP is half a multiply-add, as ``torch.utils.flop_counter`` counts:
a convolution's forward is 2·N·Ho·Wo·Cout·Cin·kh·kw, its data gradient (dx)
and its weight gradient (dW) as much again each; a linear's 2·M·Cin·Cout.
Biases, normalisations, activations and pooling are not counted. Bytes
count every input read once and every output written once: forward x, w
in and y out; dx: dy, w in, dx out; dW: dy, x in, dW out.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM, dense rates (the data sheet; at its 700 W limit)
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"float32": 4, "tf32": 4, "bfloat16": 2}


@dataclass(frozen=True)
class Conv:
    """One convolution of a network at one input shape (N, Hi, Wi)."""

    name: str
    cin: int
    cout: int
    k: int
    stride: int
    n: int
    hi: int
    wi: int
    pad: int = None  # None: k // 2

    @property
    def ho(self) -> int:
        p = self.k // 2 if self.pad is None else self.pad
        return (self.hi + 2 * p - self.k) // self.stride + 1

    @property
    def wo(self) -> int:
        p = self.k // 2 if self.pad is None else self.pad
        return (self.wi + 2 * p - self.k) // self.stride + 1

    @property
    def macs(self) -> int:
        return self.n * self.ho * self.wo * self.cout * self.cin * self.k * self.k

    def elems(self) -> tuple:
        """(x, w, y) element counts."""
        return (self.n * self.hi * self.wi * self.cin, self.k * self.k * self.cin * self.cout,
                self.n * self.ho * self.wo * self.cout)


@dataclass(frozen=True)
class Linear:
    name: str
    cin: int
    cout: int
    n: int

    @property
    def macs(self) -> int:
        return self.n * self.cin * self.cout

    def elems(self) -> tuple:
        return self.n * self.cin, self.cin * self.cout, self.n * self.cout


def flops(layer) -> int:
    """One pass (forward, dx or dW) of a layer."""
    return 2 * layer.macs


def pass_bytes(layer, part: str, itemsize: int) -> int:
    x, w, y = layer.elems()
    return itemsize * {"fwd": x + w + y, "dx": y + w + x, "dw": y + x + w}[part]


class Tally:
    """FLOPs and bytes by part of the work (``fwd``, ``dx``, ``dw``)."""

    def __init__(self, itemsize: int = 2):
        self.itemsize = itemsize
        self.flops = {"fwd": 0, "dx": 0, "dw": 0}
        self.bytes = {"fwd": 0, "dx": 0, "dw": 0}

    def add(self, layers, fwd=True, dx=True, dw=True, skip_first_dx=False):
        """Count ``layers``' forward and the named gradients; with
        ``skip_first_dx`` the first layer's input gets no gradient."""
        for i, layer in enumerate(layers):
            for part, on in (("fwd", fwd), ("dx", dx and not (skip_first_dx and i == 0)),
                             ("dw", dw)):
                if on:
                    self.flops[part] += flops(layer)
                    self.bytes[part] += pass_bytes(layer, part, self.itemsize)
        return self

    def merge(self, other: "Tally"):
        for part in self.flops:
            self.flops[part] += other.flops[part]
            self.bytes[part] += other.bytes[part]
        return self

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes.values())


def min_seconds(tally: Tally, dtype: str) -> float:
    """The least time the card could take for the tally: the larger of its
    FLOPs over the dtype's peak and its bytes over the memory's."""
    return max(tally.total_flops / PEAK_FLOPS[dtype], tally.total_bytes / PEAK_BYTES)


VGG19_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
                512, 512, 512, 512, "M", 512, 512, 512, 512, "M")


def vgg19_convs(n: int, h: int, w: int, layout=VGG19_LAYOUT, last: int = 34) -> list:
    """The convolutions of VGG19's ``features[:last + 1]`` on (n, h, w)."""
    out, cin, idx = [], 3, 0
    for item in layout:
        if idx > last:
            break
        if item == "M":
            h, w, idx = h // 2, w // 2, idx + 1
            continue
        out.append(Conv(f"vgg{idx}", cin, item, 3, 1, n, h, w))
        cin, idx = item, idx + 2
    return out


# The program's kernels by the work they do, as a trace names them (their
# families): the trunk's dense stages, data and weight gradients (the 69
# RDBs and the trunk conv), and the stage kernels (csrc/stage_ct.cu).
TRUNK_KERNELS = frozenset({"dense_mma_kernel", "dense_conv3x3_kernel", "dgrad_mma_kernel",
                           "dgrad_kernel", "wgrad_mma_kernel", "wgrad_kernel",
                           "wgrad_finish_kernel"})
STAGE_PREFIX = "stage_"


def train_tally(s, part: str):
    """The slice's training steps' tally of ``part`` ("total", "trunk",
    "stage"), summed over its steps."""
    ctx = s.context
    out = Tally(ITEMSIZE[ctx["dtype"]])
    for w in s.work:
        out.merge(ctx["flops"].train_step(ctx["config"], ctx["traffic"]["recipe"], w["batch"],
                                          w["hr"])[part])
    return out


def image_tally(s, part: str):
    ctx = s.context
    out = Tally(ITEMSIZE[ctx["dtype"]])
    for w in s.work:
        out.merge(ctx["flops"].image(ctx["config"], w["h"], w["w"])[part])
    return out


def roofline(tally: Tally, device_ms: float, dtype: str):
    """The share (%) of its least time that the kernels' device time is."""
    if device_ms <= 0 or tally.total_flops == 0:
        return None
    return 100.0 * min_seconds(tally, dtype) / (device_ms / 1e3)
