"""Data parallelism over processes: the ``torch.distributed`` side of training.

Counterpart of ``esrganplus_tpu/parallel/mesh.py``. The JAX package runs one
SPMD program over a ``('data', 'model')`` mesh: the parameters replicated,
the batch sharded along ``data``, every reduction over the batch axis global
(XLA inserts the collectives). Here there is one process per card (or, on
the CPU, per gloo rank), each holding its contiguous rows of the global
batch, and every reduction over the batch axis that the JAX program makes
global is made global by hand:

  * the gradients, one all-reduce of a flat buffer per optimizer group
    (:func:`all_reduce_grads`: SUM, then a division by the world size, on
    either backend: gloo has no AVG);
  * the statistics of train-mode batch norm, the RaGAN pairing's mean of the
    other logits, SFT-GAN's count of kept labels (:func:`all_reduce`,
    differentiable: its backward is the same all-reduce of the cotangent);
  * the logged terms (:func:`reduce_logs`), so every rank logs the global
    values, as every JAX process does;
  * random draws over the batch axis, which are indexed by the global row:
    rank r's draw for its local row i is the global draw's row
    ``r·local + i`` (:func:`row_offset` as a Philox batch offset, or
    :func:`local_rows` of a draw of the whole global batch).

With no process group every helper is the identity (no copy, no
arithmetic), so a one-process run is bit for bit what it was before. A
process group of world size 1 runs the collectives, which leave the values
unchanged, so it steps bit for bit as no group does. In a captured
resident step every collective is recorded into the graph; over two ranks
or more each is a kernel node of NCCL's, but NCCL makes an in-place SUM
over one rank no operation at all, which leaves no node. :data:`captured`
counts the collectives issued while a CUDA graph was being captured.

The backend is NCCL on a CUDA device and gloo on the CPU; gloo may be asked
for on the card too (it accepts CUDA tensors and copies them through the
host: several ranks that share one card). There is no fallback: a failed
NCCL set-up raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_process_group", "destroy_process_group", "is_initialized", "rank",
           "world_size", "backend", "barrier", "local_batch_size", "local_rows",
           "row_offset", "global_rows", "replicate_tree", "all_reduce", "all_reduce_grads",
           "reduce_logs", "captured"]

captured = 0  # collectives issued on a stream that was capturing a CUDA graph


def init_process_group(coordinator: str, num_processes: int, process_id: int,
                       device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the group of ``num_processes`` processes whose rank 0 listens at
    ``coordinator`` (``HOST:PORT``) as rank ``process_id`` → this rank's
    device: ``cuda:{rank % device_count}`` on a CUDA device (made current),
    the CPU otherwise. ``backend`` defaults to NCCL on the card and gloo on
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))
    return device


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The group's backend ("nccl" or "gloo"), None without a group."""
    return dist.get_backend() if is_initialized() else None


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def local_batch_size(global_batch: int) -> int:
    """This rank's share of a global batch; the batch must divide evenly."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"batch {global_batch} not divisible by the world size {n}")
    return global_batch // n


def global_rows(local: int) -> int:
    """The global batch of which each rank holds ``local`` rows."""
    return local * world_size()


def row_offset(local: int) -> int:
    """The global row of this rank's first local row, ``local`` rows a rank."""
    return rank() * local


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous rows of a tensor over the global batch (its
    leading axis): rank r keeps rows ``[r·n, (r+1)·n)``."""
    if not is_initialized():
        return t
    n = local_batch_size(t.shape[0])
    return t[rank() * n:(rank() + 1) * n]


@torch.no_grad()
def replicate_tree(tree):
    """Every tensor leaf of ``tree`` broadcast from rank 0 in place, so
    every rank starts from the same values (the JAX package assembles its
    replicated state from identical, seeded local copies; one broadcast
    makes that hold whatever each rank built). → ``tree``."""
    if not is_initialized():
        return tree
    from esrganplus_tpu_torch.train.sr_model import tree_leaves

    for t in tree_leaves(tree):
        if torch.is_tensor(t):
            dist.broadcast(t.data, 0)
    return tree


def _sum_(t: torch.Tensor) -> None:
    """``t`` summed over the ranks, in place (counted in :data:`captured`
    when a graph is being captured)."""
    global captured
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        captured += 1
    dist.all_reduce(t)


def _summed(t: torch.Tensor) -> torch.Tensor:
    out = t.clone()
    _sum_(out)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the cotangent of every rank's input is the sum of the
    ranks' cotangents of the output: the same map, so the backward is itself
    differentiable (WGAN-GP's penalty differentiates through D's batch
    norms twice)."""

    @staticmethod
    def forward(ctx, t):
        return _summed(t)

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g) if torch.is_grad_enabled() else _summed(g)


def all_reduce(t: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or the mean (``"mean"``) of ``t`` over the ranks,
    differentiable; ``t`` itself without a group."""
    if not is_initialized():
        return t
    if op not in ("sum", "mean"):
        raise ValueError(f"op must be 'sum' or 'mean', got {op!r}")
    out = _AllReduceSum.apply(t) if t.requires_grad else _summed(t)
    return out / world_size() if op == "mean" else out


ALIGN = 16  # elements: each gradient's slice of the flat buffer starts 64-byte aligned


@torch.no_grad()
def all_reduce_grads(grads: list) -> list:
    """The mean over ranks of a group's gradients, as one all-reduce (SUM) of
    one flat fp32 buffer, then a division by the world size → new tensors of the same shapes and dtypes, views of the buffer
    at aligned offsets (so the optimizer's elementwise kernels take their
    vectorised form); ``grads`` itself without a group."""
    if not is_initialized():
        return grads
    pad = torch.zeros(ALIGN, dtype=torch.float32, device=grads[0].device)
    pieces, starts, n = [], [], 0
    for g in grads:
        starts.append(n)
        pieces.append(g.reshape(-1).float())
        rest = -g.numel() % ALIGN
        pieces += [pad[:rest]] if rest else []
        n += g.numel() + rest
    flat = torch.cat(pieces)  # one copy kernel, not one a leaf
    _sum_(flat)
    flat /= world_size()
    return [flat[i:i + g.numel()].view(g.shape).to(g.dtype) for g, i in zip(grads, starts)]


SAME_ON_EVERY_RANK = ("lr", "grad_norm")  # logged terms no rank's batch changes


@torch.no_grad()
def reduce_logs(logs: dict) -> dict:
    """A step's logged 0-dim terms as their mean over ranks (one all-reduce),
    but for those in SAME_ON_EVERY_RANK, left as they are. ``logs`` itself
    without a group."""
    if not is_initialized():
        return logs
    keys = [k for k in logs if k not in SAME_ON_EVERY_RANK]
    vals = torch.stack([logs[k].detach().float().reshape(()) for k in keys])
    _sum_(vals)
    vals /= world_size()
    return {**logs, **{k: vals[i] for i, k in enumerate(keys)}}
