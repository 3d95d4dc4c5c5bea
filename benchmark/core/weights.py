"""Seeded weights for the program and the reference alike, made on the
device in one draw a network.

A network's weights are a tree in the program's layout (HWIO conv weights,
``[cin, cout]`` linears, the RRDB trunk stacked over its blocks, batch-norm
``scale``/``bias``/``mean``/``var``). :func:`make` draws one standard-normal
vector for the whole tree from a ``torch.Generator`` on the device and cuts
it into the leaves: He-normal (fan in, gain √2) weights times the leaf's
scale, zero biases unless the configuration names a value, unit batch-norm
scales and variances.

A network's tree of leaf specs is its reference file's ``spec``
(``reference/nets/<net>.py``, leaves from ``reference/layers.py``). The
scale of a leaf comes from the configuration's ``weights`` entry: a
default ``scale`` and ``scale_by_path`` / ``bias_by_path``, whose keys are
prefixes of the leaf's "/"-joined path (the longest prefix wins).
"""

from __future__ import annotations

import math

import torch


def _walk(spec, path=""):
    """(path, leaf spec) for every leaf of a spec tree, in a fixed order."""
    if spec is None:
        return
    if isinstance(spec, dict):
        for k in spec:
            yield from _walk(spec[k], f"{path}/{k}")
    elif isinstance(spec, list):
        for i, v in enumerate(spec):
            yield from _walk(v, f"{path}/{i}")
    else:
        yield path, spec


def _by_prefix(table: dict, path: str, default):
    best = max((k for k in table if path.startswith(k)), key=len, default=None)
    return default if best is None else table[best]


def _shapes(leaf):
    """{name: (shape, kind)} of one leaf spec; kind "he" (with its fan in),
    "zero", "one"."""
    kind = leaf[0]
    if kind == "conv":
        _, kh, kw, cin, cout, bias, stack = leaf
        pre = () if stack is None else (stack,)
        out = {"w": (pre + (kh, kw, cin, cout), ("he", kh * kw * cin))}
        if bias:
            out["b"] = (pre + (cout,), ("zero",))
        return out
    if kind == "linear":
        _, cin, cout = leaf
        return {"w": ((cin, cout), ("he", cin)), "b": ((cout,), ("zero",))}
    _, c = leaf
    return {"scale": ((c,), ("one",)), "bias": ((c,), ("zero",)),
            "mean": ((c,), ("zero",)), "var": ((c,), ("one",))}


def make(spec, seed: int, device, init: dict | None = None) -> dict:
    """The tree of ``spec`` with seeded values on ``device`` (float32):
    one draw of ``torch.randn`` for every He-normal entry of the tree."""
    init = init or {}
    scale = float(init.get("scale", 1.0))
    scales, biases = init.get("scale_by_path", {}), init.get("bias_by_path", {})
    leaves = list(_walk(spec))
    n = sum(math.prod(shape) for _, leaf in leaves
            for shape, kind in _shapes(leaf).values() if kind[0] == "he")
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    draw = torch.randn((n,), generator=gen, device=device, dtype=torch.float32)
    offset = 0
    values = {}
    for path, leaf in leaves:
        out = {}
        for name, (shape, kind) in _shapes(leaf).items():
            if kind[0] == "he":
                k = math.prod(shape)
                s = _by_prefix(scales, path, scale) * math.sqrt(2.0 / kind[1])
                out[name] = draw[offset:offset + k].view(shape) * s
                offset += k
            elif kind[0] == "one":
                out[name] = torch.ones(shape, device=device)
            else:
                out[name] = torch.full(shape, float(_by_prefix(biases, path, 0.0))
                                       if name == "b" else 0.0, device=device)
        values[path] = out
    return _build(spec, values)


def of_entry(cell, entry: dict, seed: int, device) -> dict:
    """The tree of one of the configuration's ``weights`` entries: its
    network's spec at the entry's ``args``, drawn from ``seed``."""
    return make(cell.network(entry["net"]).spec(**entry.get("args", {})), seed, device,
                entry.get("init"))


def _build(spec, values, path=""):
    if spec is None:
        return None
    if isinstance(spec, dict):
        return {k: _build(v, values, f"{path}/{k}") for k, v in spec.items()}
    if isinstance(spec, list):
        return [_build(v, values, f"{path}/{i}") for i, v in enumerate(spec)]
    return values[path]


def leaves(tree, path=""):
    """(path, tensor) for every tensor of a tree, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    elif torch.is_tensor(tree):
        yield path, tree


def clone(tree):
    """A detached copy of a tree (the reference's, before the program's
    steps update its own in place)."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone(v) for v in tree]
    return tree.detach().clone() if torch.is_tensor(tree) else tree


def copy_into(dst, src, path=""):
    """Copy ``src``'s tensors into the program's tree ``dst`` in place; the
    two trees must have the same tensors at the same paths."""
    if isinstance(dst, dict):
        extra = {k for k, v in src.items() if v is not None} ^ \
            {k for k, v in dst.items() if v is not None and (torch.is_tensor(v) or
                                                          isinstance(v, (dict, list)))}
        if extra:
            raise ValueError(f"{path}: the benchmark's tree and the program's differ at {extra}")
        for k, v in dst.items():
            if v is not None and (torch.is_tensor(v) or isinstance(v, (dict, list))):
                copy_into(v, src[k], f"{path}/{k}")
    elif isinstance(dst, (list, tuple)):
        if len(dst) != len(src):
            raise ValueError(f"{path}: {len(src)} entries against the program's {len(dst)}")
        for i, (d, s) in enumerate(zip(dst, src)):
            if d is not None:
                copy_into(d, s, f"{path}/{i}")
    else:
        if tuple(dst.shape) != tuple(src.shape):
            raise ValueError(f"{path}: shape {tuple(src.shape)} against the program's "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(src)
