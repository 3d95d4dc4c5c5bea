"""The training driver: resident steps of one of the program's trainers,
captured as CUDA graphs and replayed in bursts, on a crop pool in device
memory.

Set-up builds the trainer of the recipe's ``model`` by its bindings
(``trainers/<model>.py``) from the program's ``options`` functions, puts the benchmark's seeded weights into its
state, builds the resident crop store on a synthetic set, and drives that
one object through its first ``check_steps`` steps with the window's own
call (``train_step_resident``), reading each step's logged losses, after the
first step the gradient Adam received (its first moment over 1 − β1) and
after the last the change of every parameter. It then runs one burst, so
the window replays graphs already captured.

The window steps as the program's train loop does (``cli/train.py``):
bursts of ``steps_per_dispatch`` that stop at the print and refresh
boundaries, the pool refreshed every ``resident_refresh`` steps, the logs
read (a wait for the card) every ``print_freq`` steps. The rate is every
crop of every step of the window over the window's seconds, which end in a
synchronize.

Once the window has closed and the program's state is freed, the plain
reference (``reference/steps_<model>.py``) follows the same first steps from
the same weights, on the batches and noise it works out again from the
seeds, and the run is correct where the losses, the first gradients and
the changes agree within the cell's limits (``limits/<cell>.json``).
"""

from __future__ import annotations

import copy
import gc
import math
import statistics
import sys
import time

import torch

from core import data, harness, trace
from core import weights as W

MOVED = 1e-3  # a leaf counts where its float64 first gradient is this share of the median's


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def seeds(seed: int) -> dict:
    """The run's seeds: weights of each network, the data, the store's
    pools and the program's run seed (its sampler and noise keys)."""
    return harness.derive_seeds(seed, ("g", "d", "f", "data", "pool", "run"))


def recipe_of(cell) -> dict:
    recipe = copy.deepcopy(cell.config["recipes"][cell.traffic["recipe"]])
    recipe["network_G"]["scale"] = recipe.get("scale", 4)
    return recipe


def trainer_of(cell):
    """The bindings of the recipe's trainer (``trainers/<model>.py``)."""
    return cell.trainer(recipe_of(cell)["model"])


def make_weights(cell, sd: dict, device) -> dict:
    """{network: tree} of the networks the recipe's trainer takes
    (``recipe_weights`` may name another entry of ``weights`` for one)."""
    chosen = cell.config.get("recipe_weights", {}).get(cell.traffic["recipe"], {})
    return {net: W.of_entry(cell, cell.config["weights"][chosen.get(net, net)], sd[net], device)
            for net in trainer_of(cell).WEIGHTS}


def make_dataset(cell, sd: dict, device):
    d = cell.config["data"]
    cls = data.SegCropDataset if d.get("seg") else data.CropDataset
    recipe = recipe_of(cell)
    return cls(sd["data"], d["sources"], d["tile"], recipe["datasets"]["train"]["HR_size"],
               device)


class Program:
    """The trainer, its state and its store, set up from the seed."""

    def __init__(self, cell, sd: dict, weights: dict, dataset, device):
        from esrganplus_tpu_torch.options.options import wrap_nonedict

        recipe = recipe_of(cell)
        self.bindings = trainer_of(cell)
        trainer = self.bindings.build(wrap_nonedict(recipe), device)
        state = trainer.init_state(0)
        for net, (owner, key) in self.bindings.WEIGHTS.items():
            W.copy_into(getattr(trainer, key) if owner == "trainer" else state[key],
                        weights[net])
        ds = recipe["datasets"]["train"]
        self.store = self.bindings.store(
            dataset, device, n_crops=int(ds["resident_crops"]),
            refresh_steps=int(ds.get("resident_refresh", 1000)), seed=sd["pool"],
            use_flip=ds.get("use_flip", True), use_rot=ds.get("use_rot", True))
        self.trainer, self.state, self.recipe = trainer, state, recipe
        self.batch = int(ds["batch_size"])
        self.rng = sd["run"]

    def steps(self, n: int):
        return self.trainer.train_step_resident(self.state, self.store, self.rng, self.batch,
                                                n_steps=n)

    def first_steps(self, initial: dict, n: int) -> dict:
        """The first ``n`` steps through the window's call, one a burst →
        {"logs", "first_grads", "changes"}."""
        logs, grads = [], None
        for i in range(n):
            _, out = self.steps(1)
            logs.append({k: float(v) for k, v in out.items()})
            if i == 0:
                grads = self.first_grads()
        return {"logs": logs, "first_grads": grads, "changes": self.changes(initial)}

    def first_grads(self) -> dict:
        """{group: {path: norm}} of the gradient each group's Adam took at
        its first update: its first moment over 1 − β1."""
        out = {}
        for g, grp in self.bindings.GROUPS.items():
            b1 = self.recipe["train"].get(grp["beta1"], 0.9)
            out[g] = {p: float(t.float().norm()) / (1 - b1)
                      for p, t in W.leaves(_at(self.state, grp["mu"]))}
        return out

    def changes(self, initial: dict) -> dict:
        """{group: {path: norm}} of each parameter's change since ``initial``."""
        out = {}
        for g, grp in self.bindings.GROUPS.items():
            before = dict(W.leaves(initial[grp["net"]]))
            out[g] = {p: float((t.detach() - before[p]).float().norm())
                      for p, t in W.leaves(_at(self.state, grp["params"]))}
        return out


def run(cell, args, phases, device="cuda") -> dict:
    """One run of a training cell → the result (metrics, checks, ...);
    ``phases`` times set-up from the top of ``run.py``."""
    from esrganplus_tpu_torch.cli.train import compute_burst_len

    sd = seeds(args.seed)
    tr = cell.traffic
    cuda = torch.device(device).type == "cuda"
    phases.mark("driver")
    built = harness.build_kernels() if cuda else False
    phases.mark("build")
    weights = make_weights(cell, sd, device)
    initial = W.clone(weights)
    phases.mark("weights")
    dataset = make_dataset(cell, sd, device)
    phases.mark("data")
    prog = Program(cell, sd, weights, dataset, device)
    del weights
    phases.mark("program")

    check_steps = int(tr["check_steps"])
    program = prog.first_steps(initial, check_steps)
    phases.mark("first_steps")
    burst = int(prog.recipe["train"]["steps_per_dispatch"])
    prog.steps(burst)  # the window's burst: nothing is captured inside the window
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    phases.mark("burst")
    setup_s = phases.total()
    phases.report()

    print_freq = int(prog.recipe["logger"]["print_freq"])
    refresh = prog.store.refresh_steps
    step = int(prog.state["step"])
    attempted = failed = since_read = 0
    start = time.perf_counter()
    while time.perf_counter() - start < args.seconds:
        prog.store.maybe_refresh(step)
        n = compute_burst_len(step, burst, 2 ** 62, (print_freq, refresh), ())
        _, out = prog.steps(n)
        step += n
        attempted += n
        since_read += n
        if step % print_freq == 0:  # the train loop's log line: waits for the card
            if not all(math.isfinite(float(v)) for v in out.values()):
                failed += since_read
            since_read = 0
    sync()
    wall = time.perf_counter() - start
    crops = attempted * prog.batch

    result = {"attempted": attempted, "failed": failed,
              "build_s": phases.seconds["build"] if built else 0.0,
              "metrics": {"setup_s": harness.metric(setup_s, "s"),
                          "train_crops_per_s": harness.metric(crops / wall, "crops/s")}}
    if args.trace:
        result["slice"] = traced_slice(cell, prog, burst, cuda)
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda else 0)
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    reference = follow(cell, sd, initial, dataset, check_steps, device, "fp32")
    print(f"reference {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    result["checks"] = compare(program, reference, cell.limits())
    result["correct"] = all(v <= lim for _, v, lim in result["checks"])
    return result


def traced_slice(cell, prog, burst: int, cuda: bool):
    """``trace_steps`` steps (whole bursts) under the profiler."""
    n = int(cell.traffic["trace_steps"])
    hr = prog.recipe["datasets"]["train"]["HR_size"]
    work = [{"batch": prog.batch, "hr": hr}] * n

    def fn():
        for _ in range(n // burst):
            prog.steps(burst)

    expected, own = None, frozenset()
    if cuda:
        from esrganplus_tpu_torch.kernels.build import kernel_names

        ex, own = prog.trainer._resident, kernel_names()

        def expected():
            counts = ex.kernel_nodes(prog.trainer.gates(int(prog.state["step"]) + 1))
            return {k: v * n for k, v in counts.items()}

    return trace.profile_slice(fn, work, expected, own)


def follow(cell, sd: dict, initial: dict, dataset, n_steps: int, device, precision: str) -> dict:
    """The reference's first ``n_steps`` steps from ``initial`` →
    {"logs", "first_grads", "changes"} (norms per leaf)."""
    from reference import layers, optim

    recipe = recipe_of(cell)
    steps = cell.steps(recipe["model"])
    ds = recipe["datasets"]["train"]
    batch, hr = int(ds["batch_size"]), int(ds["HR_size"])
    batches = [optim.batch(dataset, sd["pool"], sd["run"], s, batch, int(ds["resident_crops"]),
                           ds.get("use_flip", True), ds.get("use_rot", True), device,
                           seg=bool(cell.config["data"].get("seg")))
               for s in range(n_steps)]
    noise = [steps.draw_noise(sd["run"], s, recipe, batch, hr, device) for s in range(n_steps)]
    out = steps.run(W.clone(initial), recipe, batches, noise, layers.Precision(precision))
    # the first step again in float64: which leaves' gradients are nought but
    # for rounding (a bias in front of a batch norm)
    f64 = lambda t: _map(t, lambda x: x.double())
    exact = steps.run(f64(initial), recipe, f64(batches[:1]), f64(noise[:1]),
                      layers.Precision("fp32"))["first_grads"]
    groups = trainer_of(cell).GROUPS
    changes = {}
    for grp, params in out["params"].items():
        before = dict(W.leaves(initial[groups[grp]["net"]]))
        changes[grp] = {p: float((t.detach() - before[p]).norm()) for p, t in params.items()}
    first = {grp: {p: float(t.norm()) for p, t in gr.items()}
             for grp, gr in out["first_grads"].items()}
    exact = {grp: {p: float(t.norm()) for p, t in gr.items()} for grp, gr in exact.items()}
    return {"logs": out["logs"], "first_grads": first, "changes": changes, "exact": exact}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree) if torch.is_tensor(tree) and tree.is_floating_point() else tree


def compare(program: dict, reference: dict, limits: dict) -> list:
    """[(name, value, limit)] of the numbers the cell's limits name, of:
    the widest relative gap of a logged loss over the steps (``loss_gap``),
    over the first step (``loss1_gap``) and of each term at the first step
    (``<term>_gap1``); the worst leaf's gap between
    the program's norm and the reference's of the first gradient
    (``grad_gap``) and of the change (``change_gap``), each against the
    reference's norm of that leaf or of the group's median leaf, whichever
    is larger, and the median leaf's of each (``grad_median_gap``,
    ``change_median_gap``). A leaf whose first gradient in float64 is under
    MOVED of the median leaf's is nought but for rounding (a bias in front
    of a batch norm): Adam moves it by round-off alone, and it is left out
    of both."""
    loss, loss1, where, first = 0.0, 0.0, {}, {}
    for i, (p, r) in enumerate(zip(program["logs"], reference["logs"])):
        for k, rv in r.items():
            gap = abs(p[k] - rv) / max(abs(rv), 1e-12)
            if i == 0:
                loss1 = max(loss1, gap)
                first[f"{k}_gap1"] = gap
            if gap >= loss:
                loss, where["loss_gap"] = gap, (f"step {i + 1} {k}", p[k], rv)
    grad = change = grad_med = change_med = 0.0
    for grp, ref_g in reference["first_grads"].items():
        exact = reference["exact"][grp]
        med_x = statistics.median(exact.values())
        kept = [p for p in ref_g if exact[p] >= MOVED * med_x]
        med_g = statistics.median(ref_g[p] for p in kept)
        ref_c = reference["changes"][grp]
        med_c = statistics.median(ref_c[p] for p in kept)
        gaps_g, gaps_c = [], []
        for p in kept:
            pg = program["first_grads"][grp].get(p, 0.0)
            gap = abs(pg - ref_g[p]) / max(ref_g[p], med_g, 1e-30)
            if gap >= grad:
                grad, where["grad_gap"] = gap, (grp + p, pg, ref_g[p], med_g)
            pc = program["changes"][grp][p]
            gap = abs(pc - ref_c[p]) / max(ref_c[p], med_c, 1e-30)
            if gap >= change:
                change, where["change_gap"] = gap, (grp + p, pc, ref_c[p], med_c)
            gaps_g.append(abs(pg - ref_g[p]) / max(ref_g[p], med_g, 1e-30))
            gaps_c.append(gap)
        grad_med = max(grad_med, statistics.median(gaps_g))
        change_med = max(change_med, statistics.median(gaps_c))
        top = sorted(zip(gaps_g, kept), reverse=True)[:5]
        print(f"group {grp}: {len(kept)} of {len(ref_g)} leaves kept; median gradient gap "
              f"{statistics.median(gaps_g):.4g}; largest {[(p, round(g, 4)) for g, p in top]}",
              file=sys.stderr)
    for k, v in where.items():
        print(f"worst {k}: {v}", file=sys.stderr)
    numbers = {"loss_gap": loss, "loss1_gap": loss1, "grad_gap": grad,
               "grad_median_gap": grad_med, "change_gap": change,
               "change_median_gap": change_med, **first}
    for k, v in numbers.items():
        print(f"reading {k}: {v!r}", file=sys.stderr)
    return [(k, numbers[k], lim) for k, lim in limits.items()]


def readings(cell, seed: int, control: bool, device="cuda") -> list:
    """The compared numbers of one seed, with no window: the program's
    first steps, or with ``control`` the reference at the configuration's
    control precision in the program's place, against the reference."""
    sd = seeds(seed)
    weights = make_weights(cell, sd, device)
    initial = W.clone(weights)
    dataset = make_dataset(cell, sd, device)
    n = int(cell.traffic["check_steps"])
    if control:
        record = follow(cell, sd, initial, dataset, n, device, cell.config["control"])
    else:
        prog = Program(cell, sd, weights, dataset, device)
        record = prog.first_steps(initial, n)
        del prog
        gc.collect()
    reference = follow(cell, sd, initial, dataset, n, device, "fp32")
    return compare(record, reference, cell.limits())
