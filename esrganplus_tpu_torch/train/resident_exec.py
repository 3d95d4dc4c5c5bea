"""Shared executor for resident-store training steps: a captured CUDA graph a step.

Counterpart of ``esrganplus_tpu/train/resident_exec.py``. The JAX package
runs a burst of K resident steps as one compiled dispatch (a
``lax.fori_loop`` over the step with its batch sampled inside). Here a
resident step of any of the three trainers, its batch sampled on the device
included, is captured once as a ``torch.cuda.CUDAGraph``, and a burst of K
steps is K replays of it: no host synchronisation and no launch from Python
between them.

What varies by step is device data, so one graph serves every step: each
step's scalars (learning rates, Adam's bias corrections, the keys of the
sampler and of every noise site, ``train/step_scalars.py``) sit in one row
of a table the host fills for the whole burst and uploads with one copy;
the captured step reads its row through a device index and increments it.
The host gates (GAN: ``do_g``; SFT-GAN: its two groups) pick the capture:
each pattern is its own graph, and a burst may switch between them from
step to step. The host mirrors ``state["step"]``, the Adam counts and the
parameter version (``GeneratorTrainerBase.advance``), so a checkpoint holds
what the eager path's would.

A capture holds the addresses of the state's tensors, of the store's pools
(a refresh copies into them, ``data/resident.py``) and of the table: a
state or a store with other tensors clears the cache and is captured anew.
The captures of one trainer share one private memory pool. Before a
capture the step runs once eagerly on a side stream (cuDNN, cuBLAS and the
kernels' libraries set up there, as capture requires), and the state's
tensors are put back after it. No cyclic garbage collection runs during a
capture: a dead object's CUDA graph destroyed on the capturing thread
invalidates the capture, so the collection runs just before it instead (and
the executor holds its trainer weakly, so a dropped trainer's graphs go with
it). The kernel wrappers count their calls, so
a capture adds two steps' launches to their counters (the warm-up and the
recording) and a replay adds none: what a replay launches is read from the
captured graph itself (:meth:`ResidentExecutor.kernel_nodes`). While a
step is captured, its body's phase marks (``utils/trace.phase``) record
where each phase's nodes begin, so each kernel a replay launches has its
phase (:meth:`ResidentExecutor.phase_nodes`), kept process-wide under the
id that the mark ``exec.replay:<id>`` before the replay's launch names
(``utils/trace.phase_lists``); the marks cost the capture, not a replay.

Under a process group (``parallel/mesh.py``) the step's collectives (the
gradients' all-reduces, the batch norms' and the RaGAN pairing's, the logs')
are captured with it: over two ranks or more NCCL's kernels are nodes of
the graph like the step's own (:meth:`ResidentExecutor.kernel_nodes` counts
them; over one rank NCCL records nothing for an in-place SUM, and
``mesh.captured`` counts the collectives the capture issued). The first
collective, which creates the NCCL communicator, runs eagerly in the
warm-up before the first capture. A backend whose collectives cannot be
captured (gloo: it copies through the host) raises at the resident step on
the card; :func:`run_eager` runs such a group's steps eagerly when asked.

On a CUDA device this is the only path of a resident step: a step that
cannot be captured raises, naming what broke the capture. On the CPU a
burst of n steps is n eager calls of the same body.
"""

from __future__ import annotations

import gc
import itertools
import time
import weakref

import numpy as np
import torch

from esrganplus_tpu_torch.parallel import mesh
from esrganplus_tpu_torch.train.sr_model import tree_leaves
from esrganplus_tpu_torch.utils import trace


def plan_burst(trainer, state: dict, rng: int, n_steps: int) -> tuple:
    """The rows and gates of the next ``n_steps`` steps → (int32 ``[n,
    width]``, [gates]); the host mirror advances by them."""
    rows, gates = [], []
    with trace.span("exec.plan"):
        for _ in range(n_steps):
            row, g = trainer.plan(state, rng)
            trainer.advance(state, g)
            rows.append(row)
            gates.append(g)
        return np.stack(rows), gates


def burst_gates(trainer, state: dict, n_steps: int) -> list:
    """The gates of the state's next ``n_steps`` steps (what
    :func:`plan_burst` gives), with nothing advanced."""
    step = int(state["step"])
    return [trainer.gates(step + 1 + i) for i in range(n_steps)]


def _step(trainer, state: dict, store, batch_size: int, sc, gates: tuple) -> dict:
    """One resident step: the batch sampled under the step's key, then the
    trainer's body, each part marked as a phase (``utils/trace.phase``)."""
    try:
        trace.phase("sample")
        batch = store.make_sampler(batch_size)(sc.sample_key)
        return trainer._step(state, batch, sc, gates)
    finally:
        trace.end_phase()


class ResidentExecutor:
    """The captured resident steps of one trainer on the card."""

    MIN_ROWS = 256  # the table's rows at first use (more are made for a longer burst)
    _ids = itertools.count()  # the process's captured graphs, numbered for their marks

    def __init__(self, trainer):
        self._trainer = weakref.ref(trainer)  # the trainer holds the executor
        self.device = trainer.device
        self._graphs = {}  # gates → (CUDAGraph, static logs, its replay mark's name)
        self._fingerprint = None
        self._pool = None
        self._table = None  # int32 [rows, width]: the burst's rows
        self._index = None  # int64 [1]: the row the next replay reads
        self.captures = 0  # graphs captured over the executor's life
        self.capture_seconds = 0.0

    @property
    def trainer(self):
        return self._trainer()

    def _prepare(self, state: dict, store, batch_size: int, n_rows: int) -> None:
        """Drop the captures that hold other tensors than this state's,
        store's and table's; make the table."""
        fingerprint = (tuple(t.data_ptr() for t in tree_leaves(state) if torch.is_tensor(t)),
                       tuple(t.data_ptr() for t in store.pools()), batch_size,
                       store.n_crops, store.use_flip, store.use_rot)
        width = self.trainer.scalars.width
        if self._table is None or self._table.shape[0] < n_rows:
            self._table = torch.zeros((max(n_rows, self.MIN_ROWS), width), dtype=torch.int32,
                                      device=self.device)
            self._index = torch.zeros((1,), dtype=torch.int64, device=self.device)
            self._fingerprint = None
        if fingerprint != self._fingerprint:
            self._graphs.clear()
            self._fingerprint = fingerprint

    def _captured_step(self, state, store, batch_size, gates):
        row = self._table.index_select(0, self._index)[0]
        self._index.add_(1)
        return _step(self.trainer, state, store, batch_size, self.trainer.scalars.view(row),
                     gates)

    def _capture(self, state: dict, store, batch_size: int, gates: tuple) -> None:
        """Warm the step up on a side stream, put the state back, capture it
        → ``self._graphs[gates]``, its (phase, kernel) list registered under
        the graph's id (``utils/trace.register_phases``). The table holds a
        valid row and the index 0."""
        with trace.span("exec.capture"):
            self._record(state, store, batch_size, gates)

    def _record(self, state: dict, store, batch_size: int, gates: tuple) -> None:
        t0 = time.perf_counter()
        trainer = self.trainer
        # the warm-up runs every collective of the step eagerly: the first
        # creates the NCCL communicator, which a capture cannot
        kept = [t.detach().clone() for t in tree_leaves(state) if torch.is_tensor(t)]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._captured_step(state, store, batch_size, gates)
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, k in zip((t for t in tree_leaves(state) if torch.is_tensor(t)), kept):
                t.copy_(k)
        del kept
        self._index.zero_()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept: kernel_nodes reads it
        gc.collect()  # dead graphs (and their cycles) go now, not mid-capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the checkpoint writer's copies on its own thread
            # may run while a step is captured (a gate opening mid-run)
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                with trace.capture_marks(torch.cuda.current_stream(self.device)) as marks:
                    logs = self._captured_step(state, store, batch_size, gates)
        except RuntimeError as e:
            raise RuntimeError(
                f"{type(trainer).__name__}: the resident step (gates {gates}) could not be "
                f"captured as a CUDA graph: {e}") from e
        finally:
            if collecting:
                gc.enable()
        graph.instantiate()
        gid = str(next(self._ids))
        trace.register_phases(gid, trace.node_phases(trace.graph_node_families(graph), marks))
        self._graphs[gates] = (graph, logs, trace.REPLAY + gid)
        torch.cuda.synchronize(self.device)
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0

    def kernel_nodes(self, gates: tuple):
        """The kernels a replay of the ``gates`` step launches, by family
        (``utils/trace.graph_kernels``: read from the captured graph)."""
        from esrganplus_tpu_torch.utils.trace import graph_kernels

        return graph_kernels(self._graphs[gates][0])

    def phase_nodes(self, gates: tuple) -> list:
        """The kernels a replay of the ``gates`` step launches, in order, each
        as (phase, family): the phase whose mark the capture had passed when
        it added the kernel (``utils/trace.node_phases``)."""
        return trace.phase_lists()[self._graphs[gates][2][len(trace.REPLAY):]]

    def capture(self, state: dict, store, rng: int, batch_size: int, n_steps: int) -> None:
        """Capture the steps the next ``n_steps`` need and this executor
        lacks (one per gate pattern); the state and its host mirror are left
        as they were, and nothing is replayed."""
        gates = burst_gates(self.trainer, state, n_steps)
        self._prepare(state, store, batch_size, n_steps)
        missing = [g for g in dict.fromkeys(gates) if g not in self._graphs]
        if missing:  # the warm-ups read the state's next row (any row would do)
            with trace.span("exec.upload"):
                self.trainer._uploader.upload(self.trainer.plan(state, rng)[0][None],
                                              self._table)
        for g in missing:
            self._capture(state, store, batch_size, g)

    def run(self, state: dict, store, rng: int, batch_size: int, n_steps: int) -> tuple:
        """``n_steps`` replays, captured first where missing → (state, the
        last step's logs, copied out of the graph's buffers)."""
        self.capture(state, store, rng, batch_size, n_steps)
        rows, gates = plan_burst(self.trainer, state, rng, n_steps)
        with trace.span("exec.upload"):
            self.trainer._uploader.upload(rows, self._table)
            self._index.zero_()
        for g in gates:
            graph, _, name = self._graphs[g]
            trace.mark(name)
            graph.replay()
        return state, {k: v.clone() for k, v in self._graphs[gates[-1]][1].items()}


def run_eager(trainer, state: dict, store, rng: int, batch_size: int, n_steps: int) -> tuple:
    """The burst's steps as eager calls of the same body, each row uploaded
    on its own → (state, the last step's logs): the CPU's path (and, on the
    card, what the graph is measured against)."""
    rows, gates = plan_burst(trainer, state, rng, n_steps)
    for row, g in zip(rows, gates):
        logs = _step(trainer, state, store, batch_size,
                     trainer.scalars.view(trainer._uploader.upload(row)), g)
    return state, logs


def train_step_resident(trainer, state: dict, store, rng: int, batch_size: int,
                        n_steps: int = 1) -> tuple:
    """``n_steps`` optimizer steps, each on a batch sampled on the device
    from ``store`` under its step's key → (state, the last step's logs).
    On the card: replays of the trainer's captured steps; on the CPU: the
    same body, eagerly, once a step."""
    if int(n_steps) < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps!r}")
    if trainer.device.type != "cuda":
        return run_eager(trainer, state, store, rng, batch_size, int(n_steps))
    if mesh.is_initialized() and mesh.backend() != "nccl":
        raise RuntimeError(f"the resident step is a captured CUDA graph, and the {mesh.backend()} "
                           "backend's collectives cannot be captured: train under NCCL, or "
                           "step eagerly with train.resident_exec.run_eager")
    return executor(trainer).run(state, store, rng, batch_size, int(n_steps))


def executor(trainer) -> ResidentExecutor:
    """The trainer's executor on the card, made at first use."""
    if trainer._resident is None:
        trainer._resident = ResidentExecutor(trainer)
    return trainer._resident
