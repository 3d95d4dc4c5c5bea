"""The bars that hold a data-parallel step's state to the one-process step
on the global batch (tests/test_torch_dist.py on the CPU, chip_smoke.py's
``dist-gloo-2`` on the card).

Ranks sum each batch reduction in another order than one process does, so
the two states differ by rounding, and how far rounding moves a leaf depends
on the leaf. :func:`held_state` takes each leaf of the state (a
``{path: numpy array}`` as ``torch_dist_worker.named_leaves`` names them:
``/params/...``, ``/opt_state/mu/...``, ``/g_opt/sft/mu/...``) through these
rules, in order. A leaf's noise is its relative L2 motion when the
one-process step's parameters and batch move by 1e-7 relative (a caller
may count other changes that leave the mathematics as it is: chip_smoke.py
also counts the card's cuDNN convolutions against PyTorch's own).

1. every entry within ``tol`` of max|leaf|: held;
2. a bias whose first moment is at most ROUNDING of its layer's weights'
   (the sibling leaf ``w``), with its moments and the parameter, is LEFT OUT
   and the reason returned: its gradient is rounding noise. Those are D's
   last bias, whose gradient the RaGAN pairing's common shift of the logits
   cancels, and the biases in front of a batch norm, which no loss reaches
   (1e-7 to 3e-5 of their weights' in fp32; a real bias's, 0.2 or more);
   Adam's first step moves such a parameter by ±lr on the noise's sign;
3. a parameter whose first moment rule 2 or 4 left out is LEFT OUT with
   it; a parameter leaf trained by its gradient (not a batch norm's running
   statistic, whose first moment is 0 in both states): each entry within
   ``tol``·max|leaf| plus what its gradient's difference δg moves Adam's
   first step, 2·lr·min(|δg|/|g|, 1): held (the gradients themselves are
   held through their first moments);
4. a leaf whose noise is at least ROUNDING_NOISE is LEFT OUT with the
   reason: its value is rounding noise too (the same biases' where the
   ratio of rule 2 reads more). Such leaves' noise reads 0.8 to 1e25, a real
   gradient's at most 1e-2 however small the gradient; a leaf whose
   one-process value is exactly 0 has an infinite noise (:func:`noise_of`);
5. any other leaf (a moment, a batch norm's running statistic): relative L2
   within max(``floor``, min(10·noise, ``cap``)), ``cap`` NOISE_CAP unless
   given.
"""

from __future__ import annotations

import numpy as np

ROUNDING = 1e-4  # rule 2: a bias's gradient this far below its weights'
ROUNDING_NOISE = 0.1  # rule 4: a 1e-7 perturbation moving a leaf by a tenth of it
NOISE_CAP = 5e-2  # rule 5: the most that 10× a leaf's own noise may allow
OPT_TREES = {"params": "opt_state", "g_params": "g_opt", "d_params": "d_opt"}


def rel_l2(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel())) / max(float(np.linalg.norm(b.ravel())), 1e-30)


def moment_of(name: str, want: dict):
    """The first moment's path of a parameter leaf, None for other leaves."""
    head, _, rest = name[1:].partition("/")
    opt = OPT_TREES.get(head)
    for k in ((f"/{opt}/mu/{rest}", f"/{opt}/other/mu/{rest}", f"/{opt}/sft/mu/{rest}")
              if opt else ()):
        if k in want:
            return k
    return None


def noise_of(perturbed: dict, ref: dict) -> dict:
    """Each leaf's noise: its relative L2 motion from the one-process step
    ``ref`` to the same step with its parameters and batch moved by 1e-7
    relative (``perturbed``); infinite for a leaf whose ``ref`` is exactly 0
    (a sum that cancels exactly: any motion of it is unbounded relative)."""
    return {n: rel_l2(perturbed[n], b) if np.any(b) else float("inf")
            for n, b in ref.items()}


def held_state(got: dict, want: dict, tol: float, lr: float, noise, floor: float,
               cap: float = NOISE_CAP) -> dict:
    """``got``'s leaves against ``want``'s (the one-process step's) by the
    module's rules; ``noise()`` gives {path: noise} (:func:`noise_of`,
    called only when rule 4 is reached) → {"bad": {path: (relative L2,
    bar)}, "left_out": {path: reason}, "held_by": {path: the rule, 1, 3 or
    5, that held it}, "barred": [the paths held by rule 5], "worst": their
    largest relative L2 / bar}."""
    out = {"bad": {}, "left_out": {}, "held_by": {}, "barred": [], "worst": 0.0}
    # the first moments first: a parameter whose gradient is left out goes too
    for n in sorted(want, key=lambda n: "/mu/" not in n):
        a, b = got[n], want[n]
        if a.shape != b.shape:
            out["bad"][n] = (float("inf"), 0.0)
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        d = np.abs(a - b)
        top = float(np.abs(b).max(initial=0.0))
        if float(d.max(initial=0.0)) <= tol * max(top, 1e-30):
            out["held_by"][n] = 1
            continue
        moment = "/mu/" in n or "/nu/" in n
        mu = n.replace("/nu/", "/mu/") if moment else moment_of(n, want)
        if mu is not None and mu.endswith("/b") and mu[:-1] + "w" in want:
            r = (float(np.abs(want[mu]).max(initial=0.0))
                 / max(float(np.abs(want[mu[:-1] + "w"]).max(initial=0.0)), 1e-30))
            if r <= ROUNDING:
                out["left_out"][n] = f"a bias's gradient at rounding level: {r:.3g} of its weights'"
                continue
        if mu is not None and not moment and mu in out["left_out"]:
            out["left_out"][n] = f"its gradient's first moment is left out ({out['left_out'][mu]})"
            continue
        if mu is not None and not moment and (np.any(want[mu]) or np.any(got[mu])):
            g = np.asarray(want[mu], np.float64)
            dg = np.abs(np.asarray(got[mu], np.float64) - g) / np.maximum(np.abs(g), 1e-30)
            if (d <= tol * top + 2 * lr * np.minimum(dg, 1.0)).all():
                out["held_by"][n] = 3
                continue
        own = noise()[n]
        if own >= ROUNDING_NOISE:
            out["left_out"][n] = (f"rounding noise: the one-process step's own noise moves it "
                                  f"by {own:.3g} of its norm")
            continue
        bar = max(floor, min(10 * own, cap))
        rel = rel_l2(a, b)
        out["barred"].append(n)
        out["worst"] = max(out["worst"], rel / bar)
        if rel > bar:
            out["bad"][n] = (rel, bar)
        else:
            out["held_by"][n] = 5
    return out
