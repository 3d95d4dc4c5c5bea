"""Where chip_smoke.py's dist-gloo-2 ``srragan`` state differs from one
process's: the one-process fp32 step (D 128, seeded VGG19, batch 16) run
again, with cuDNN off (PyTorch's own convolutions) and with its batch moved
by 1e-7 relative, each leaf's relative L2 distance to the first run, beside
the two gloo ranks' state (``chip_smoke.dist_gloo_2``) and its distance to
the cuDNN-off step; the 25 leaves furthest from the two ranks, then the
largest distance of each kind over D's and G's leaves (biases aside).

    python3 tools/dist_cudnn_probe.py   # on a machine with one H100
"""
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as C  # noqa: E402

from esrganplus_tpu_torch.kernels import build  # noqa: E402

t0 = time.perf_counter()
build.build(force=True)
print(json.dumps({"phase": "build", "s": time.perf_counter() - t0}), flush=True)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from esrganplus_tpu_torch.parallel import held  # noqa: E402

t, batch = C._gloo_case("srragan")
host = lambda st: {n: v.numpy() for n, v in C._tensors(st).items()}
A = host(t.train_step(t.init_state(0), batch, 1)[0])
A2 = host(t.train_step(t.init_state(0), batch, 1)[0])
torch.backends.cudnn.enabled = False
B = host(t.train_step(t.init_state(0), batch, 1)[0])
torch.backends.cudnn.enabled = True
gen = torch.Generator().manual_seed(5)
moved = tuple((b * (1 + 1e-7 * torch.randn(b.shape, generator=gen).to(b.device))) for b in batch)
P = host(t.train_step(t.init_state(0), moved, 1)[0])
del t
torch.cuda.empty_cache()
failures = []
workdir = os.path.join(ROOT, "build", "smoke")
os.makedirs(workdir, exist_ok=True)
with tempfile.TemporaryDirectory(dir=workdir) as tmp:
    C.dist_gloo_2(failures, tmp)
    two = torch.load(os.path.join(tmp, "gloo0.pt"), weights_only=False)["srragan"]["state"]
    two = {n: v.numpy() for n, v in two.items()}
keys = [n for n in A if np.any(A[n]) and not n.endswith("/b")]
rows = {n: {"rerun": held.rel_l2(A2[n], A[n]), "cudnn_off": held.rel_l2(B[n], A[n]),
            "perturbed": held.rel_l2(P[n], A[n]), "two_ranks": held.rel_l2(two[n], A[n]),
            "two_vs_cudnn_off": held.rel_l2(two[n], B[n])} for n in keys}
top = sorted(keys, key=lambda n: -rows[n]["two_ranks"])[:25]
for n in top:
    print(json.dumps({"leaf": n, **{k: float(f"{v:.3g}") for k, v in rows[n].items()}}))
for k in ("rerun", "cudnn_off", "perturbed", "two_ranks", "two_vs_cudnn_off"):
    print(k, "max over D", max(rows[n][k] for n in keys if n.startswith("/d_")),
          "max over G", max(rows[n][k] for n in keys if n.startswith("/g_")))
print(json.dumps({"phase": "done", "s": time.perf_counter() - t0}), flush=True)
