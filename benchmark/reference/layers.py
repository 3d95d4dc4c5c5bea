"""What the plain reference networks share: how they compute their products
(:class:`Precision`), the activations and batch norm, the leaves of a
network's weight tree (:func:`conv`, :func:`linear`, :func:`bn`), and the
lookup of a network by name (:func:`net`).

A network is a file of its own, ``nets/<name>.py``, with ``spec(**args)``
(its weight tree: which leaves, of which shapes, in the program's layout)
and its forward on NCHW activations, written from the published
architecture. A configuration's ``weights`` entry names it by ``net``; a new
architecture is a new file there. Nothing here imports the program under
test.

Every convolution and linear goes through :class:`Precision`, which computes
in float32 with TF32 off (the reference), or in a lower precision for the
control that has to fail the comparison: ``"tf32"`` (TF32 convolutions and
matmuls) or ``"fp8"``, which computes as the program computes in bf16, one
format lower: every product's operands and every stored activation (each
convolution's and linear's output, the RDB, RRDB and trunk sums) scaled per
tensor by its largest magnitude and rounded to float8 e4m3, the gradient
that flows back through each rounding rounded to e5m2 alike.
"""

from __future__ import annotations

import contextlib
import importlib.util
import os

import torch
import torch.nn.functional as F


def conv(kh, kw, cin, cout, bias=True, stack=None):
    """A conv leaf of a weight tree: HWIO ``w`` and ``b`` (``stack``: the
    number of blocks the leaf is stacked over, as a trunk's are)."""
    return ("conv", kh, kw, cin, cout, bias, stack)


def linear(cin, cout):
    """A linear leaf: ``w`` as ``[cin, cout]`` and ``b``."""
    return ("linear", cin, cout)


def bn(c):
    """A batch-norm leaf: ``scale``, ``bias``, ``mean``, ``var``."""
    return ("bn", c)


_NETS: dict = {}


def net(name: str, where: str):
    """The module of network ``name``: ``nets/<name>.py`` in the reference
    folder ``where`` (loaded once a path)."""
    path = os.path.join(os.path.abspath(where), "nets", f"{name}.py")
    if path not in _NETS:
        spec = importlib.util.spec_from_file_location(f"reference_net_{name}_{len(_NETS)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _NETS[path] = mod
    return _NETS[path]


def round_fp8(t, dtype=torch.float8_e4m3fn):
    """``t`` scaled per tensor so its largest magnitude meets the format's
    largest value, rounded to ``dtype`` and scaled back."""
    top = torch.finfo(dtype).max
    s = top / t.detach().abs().amax().float().clamp_min(1e-30)
    return ((t.float() * s).to(dtype).float() / s).to(t.dtype)


class _RoundFP8(torch.autograd.Function):
    """Operands rounded to e4m3 on the way in, their gradients to e5m2 on
    the way back, as fp8 training recipes do."""

    @staticmethod
    def forward(ctx, t):
        return round_fp8(t)

    @staticmethod
    def backward(ctx, g):
        return round_fp8(g, torch.float8_e5m2)


class Precision:
    """How the reference computes its products: ``"fp32"`` (TF32 off),
    ``"tf32"`` or ``"fp8"`` (see the module docstring)."""

    MODES = ("fp32", "tf32", "fp8")

    def __init__(self, mode: str = "fp32"):
        if mode not in self.MODES:
            raise ValueError(f"precision {mode!r}: one of {self.MODES}")
        self.mode = mode

    def _q(self, t):
        return _RoundFP8.apply(t) if self.mode == "fp8" else t

    def store(self, t):
        """A tensor as the precision stores it between operations (fp8:
        rounded like an operand; otherwise as it is)."""
        return self._q(t)

    @contextlib.contextmanager
    def flags(self):
        """TF32 on for "tf32", off otherwise, restored after."""
        prev = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cudnn.allow_tf32 = on
        torch.backends.cuda.matmul.allow_tf32 = on
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

    def conv(self, x, p: dict, stride: int = 1, padding=None):
        """NCHW ``x`` × the HWIO conv ``p``; ``padding`` None: half the
        kernel (odd kernels), as the published nets pad."""
        w = p["w"].permute(3, 2, 0, 1)
        if padding is None:
            padding = w.shape[-1] // 2
        return self.store(F.conv2d(self._q(x), self._q(w), p.get("b"), stride=stride,
                                   padding=padding))

    def linear(self, x, p: dict):
        """``x @ w + b`` with ``w`` as ``[cin, cout]``."""
        return self.store(self._q(x) @ self._q(p["w"]) + p["b"])


def lrelu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def bn_train(x, p: dict, eps: float = 1e-5):
    """Batch norm with the batch's statistics (training mode)."""
    return F.batch_norm(x, None, None, p["scale"], p["bias"], training=True, eps=eps)


def block(tree, i):
    """Block ``i`` of a tree stacked over a trunk's blocks."""
    if isinstance(tree, dict):
        return {k: block(v, i) for k, v in tree.items()}
    return tree[i]
