"""The port's SFT-GAN trainer and data path (esrganplus_tpu_torch/train/
sftgan_model.py, data/seg_dataset.py, data/resident.py's seg store, the
``sftgan`` branch of cli/train.py and cli/inspect_data.py) against the JAX
package on the CPU:

  (a) ``masked_cross_entropy`` against JAX's, an all-ignored batch included
      (0, where ``F.cross_entropy(ignore_index=0)`` gives NaN);
  (b) two steps (SFT nb 2, nf 16, cond_nf 8; the ACD at 96²; batch 2,
      ``feature_weight`` 0, ``other_start_iter`` 1, a milestone at step 2),
      each from the JAX state converted at that step, every leaf held on
      its own: every logged term within 1e-4 and D's running statistics
      within 1e-5 of max(1, max|ref|); each leaf's gradient (read back from
      its Adam first moment) within 1e-2 of JAX's in relative L2 (5e-3 is
      the most seen; D's conv biases in front of a batch norm are left out:
      the loss does not depend on them, so their gradient is rounding
      noise); and each parameter entry within 1e-6 of JAX's plus
      2·lr·|δg|/√v̂, what the two packages' gradient difference δg at that
      entry can move an Adam step. Not a flat 1e-5: Adam's first steps move
      an entry by about ±lr whatever its gradient's size, so a gradient
      within rounding of 0 may take the other sign; and one of D's 295k
      lrelu gates at 48² (pre-activation 7e-8) takes the other side of 0 in
      the two packages, which moves G's gradients by up to 0.8 % at that
      pixel. Across the gate, step 1 leaves the ``other`` group's
      parameters, moments and count bit-unchanged, step 2 moves them;
  (c) ``LRHRSegBGDataset`` samples bit-equal to JAX's for one seed, the
      background draws included, over ``.pth`` seg maps written by
      ``torch.save``;
  (d) ``build_seg_crop_pool`` / ``ResidentSegStore``: dtypes, the pool a
      function of (seed, pool index), one resident step equal to
      ``train_step`` on the sampled batch;
  (e) ``cli.train --device cpu`` on an ``sftgan`` options file (SFT nb 1 at
      the shipped widths, HR 96, batch 2, ``feature_weight`` 0), two steps
      and the second again from the first's checkpoint, bit-equal: host-fed
      with sequential validation, starting from a state the JAX package's
      trainer saved (loaded exactly), and resident with batched validation
      (``eval_sharded``, the seg maps as the evaluator's side input);
  (f) ``cli.inspect_data`` on the seg dataset writes the colourised grids.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from esrganplus_tpu.data.seg_dataset import LRHRSegBGDataset as JSegDataset
from esrganplus_tpu.models.sft import SFTNetConfig as JSFTCfg
from esrganplus_tpu.parallel import make_mesh, shard_batch
from esrganplus_tpu.train.sftgan_model import SFTGANTrainConfig as JTrainCfg
from esrganplus_tpu.train.sftgan_model import SFTGANTrainer as JTrainer
from esrganplus_tpu.train.sftgan_model import masked_cross_entropy as jmce
from esrganplus_tpu_torch.convert import sftgan_trainer_state_from_jax
from esrganplus_tpu_torch.data.resident import ResidentSegStore, build_seg_crop_pool, \
    pool_generators
from esrganplus_tpu_torch.data.seg_dataset import LRHRSegBGDataset
from esrganplus_tpu_torch.models.sft import SFTNetConfig
from esrganplus_tpu_torch.train import SFTGANTrainConfig, SFTGANTrainer
from esrganplus_tpu_torch.train.rng import sample_seed
from esrganplus_tpu_torch.train.sftgan_model import masked_cross_entropy
from esrganplus_tpu_torch.train.sr_model import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NET = dict(nb=2, nf=16, cond_nf=8)
LR = 1e-4
B1, B2 = 0.9, 0.999
TOL = 1e-5
TERMS = ("l_g_pix", "l_g_gan", "l_g_cls", "l_g_total", "l_d_total", "D_real", "D_fake", "lr")


@pytest.mark.parametrize("labels", [[0, 1, 2, 7], [0, 0, 0, 0], [3, 3, 5, 1]])
def test_masked_cross_entropy_matches_jax(labels):
    logits = np.random.RandomState(0).randn(4, 8).astype(np.float32) * 3
    want = float(jmce(jnp.asarray(logits), jnp.asarray(labels, jnp.int32)))
    got = masked_cross_entropy(torch.from_numpy(logits), torch.tensor(labels))
    assert np.isfinite(float(got))
    assert abs(float(got) - want) <= 1e-6 * max(1.0, abs(want))
    if not any(labels):
        assert float(got) == 0.0


def _batch(seed=0, b=2):
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, 96, 96, 8)
    seg = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    return (rs.rand(b, 24, 24, 3).astype(np.float32), seg,
            rs.rand(b, 96, 96, 3).astype(np.float32), np.asarray([0, 3][:b], np.int32))


def _carry(pt, jstate):
    carried = sftgan_trainer_state_from_jax(jax.tree.map(np.asarray, jstate), pt.net_g)
    return {"g_params": pt.ingest_params(carried["g_params"]),
            "d_params": pt.ingest_d_params(carried["d_params"]),
            "g_opt": carried["g_opt"], "d_opt": carried["d_opt"], "step": carried["step"]}


def _named(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _before_bn_bias(name):
    """An ACD conv bias followed by a batch norm (convs 1..7): the loss does
    not depend on it, so its gradient is rounding noise."""
    return name.startswith("/convs/") and name.endswith("/b") and name != "/convs/0/b"


def _moments(tag, ptree, jtree, jbefore):
    """{(tag, leaf name): (gradient, JAX's gradient, the smaller √v̂)}. Both
    packages start the step from JAX's moments, so each gradient is read
    back from its first moment: g = (μ − b1·μ_before) / (1 − b1)."""
    named, jl = _named(ptree["mu"]), jax.tree.leaves(jtree.mu)
    jb, jn, pn = jax.tree.leaves(jbefore.mu), jax.tree.leaves(jtree.nu), tree_leaves(ptree["nu"])
    assert len(named) == len(jl) == len(jb) == len(jn) == len(pn)
    c2 = 1.0 - B2 ** ptree["count"]
    out = {}
    for (n, mu), mj, mb, nj, nu in zip(named, jl, jb, jn, pn):
        mb = np.asarray(mb, np.float64)
        g = (mu.numpy().astype(np.float64) - B1 * mb) / (1.0 - B1)
        gj = (np.asarray(mj, np.float64) - B1 * mb) / (1.0 - B1)
        vhat = np.minimum(nu.numpy(), np.asarray(nj)).astype(np.float64) / c2
        out[(tag, n)] = (g, gj, np.sqrt(vhat))
    return out


def _gradients_close(moments, where):
    """Each leaf's gradient within 1e-2 of JAX's in relative L2, the
    pre-batch-norm biases left out."""
    for (tag, n), (g, gj, _) in moments.items():
        if _before_bn_bias(n) or not gj.any():
            continue
        rel = np.linalg.norm(g - gj) / np.linalg.norm(gj)
        assert rel <= 1e-2, (where, tag, n, rel)


def _params_close(tag, ptree, jtree, moments, lrs, where):
    """Each parameter entry within 1e-6 of JAX's, plus what its own gradient
    difference δg explains: Adam moves an entry by lr·m̂/(√v̂ + eps), which
    changes by at most 2·lr·|δg|/√v̂ (a gradient within rounding of 0 may
    take the other sign, and the step then flips from about +lr to −lr).
    BN running statistics are held on their own."""
    named, jl = _named(ptree), jax.tree.leaves(jtree)
    assert len(named) == len(jl)
    for (n, a), b in zip(named, jl):
        if n.endswith("/mean") or n.endswith("/var"):
            continue
        err = np.abs(a.detach().numpy().astype(np.float64) - np.asarray(b, np.float64))
        key = (tag, n)
        if key not in moments:  # a gated group: unchanged on both sides
            assert err.max() == 0.0, (where, tag, n)
            continue
        g, gj, root = moments[key]
        lr = lrs["sft" if tag == "G" and _is_sft(n) else tag]
        bound = 1e-6 + 2.0 * lr * np.abs(g - gj) / (root + 1e-8)
        assert np.all(err <= bound), (where, tag, n, float((err - bound).max()))


def _is_sft(name):
    return "sft" in name.lower() or "cond" in name.lower()


@pytest.fixture(scope="module")
def pair():
    kw = dict(lr_g=LR, lr_d=LR, milestones=(2,), feature_weight=0.0, other_start_iter=1)
    jt = JTrainer(JSFTCfg(**NET), JTrainCfg(**kw), mesh=make_mesh(devices=jax.devices()[:1]))
    pt = SFTGANTrainer(SFTNetConfig(**NET), SFTGANTrainConfig(**kw), device="cpu")
    return jt, pt


def test_two_steps_match_jax_and_the_gate_freezes_the_other_group(pair):
    jt, pt = pair
    jstate = jt.init_state(jax.random.PRNGKey(0))
    batch = _batch()
    jbatch = shard_batch(jt.mesh, tuple(jnp.asarray(a) for a in batch))
    for step in range(2):
        jbefore = jax.tree.map(np.asarray, jstate)  # the step donates jstate's buffers
        synced = _carry(pt, jstate)
        other_before = {k: [t.clone() for t in tree_leaves(synced["g_opt"]["other"][k])]
                        for k in ("mu", "nu")}
        g_before = [t.detach().clone() for t in tree_leaves(synced["g_params"])]
        jstate, jlogs = jt.train_step(jstate, jbatch, jax.random.PRNGKey(0))
        synced, plogs = pt.train_step(synced, batch, 0)
        assert set(plogs) == set(jlogs) == set(TERMS)
        for k in TERMS:
            got, want = float(plogs[k]), float(jlogs[k])
            assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (step, k, got, want)
        jinner, jinner0 = jstate["g_opt"].inner_states, jbefore["g_opt"].inner_states
        moments = _moments("D", synced["d_opt"], jstate["d_opt"], jbefore["d_opt"])
        for g in ("other", "sft"):
            assert synced["g_opt"][g]["count"] == int(jinner[g].inner_state.count)
            if synced["g_opt"][g]["count"]:
                moments.update(_moments("G", synced["g_opt"][g], jinner[g].inner_state,
                                        jinner0[g].inner_state))
        _gradients_close(moments, step)
        lr = LR * (0.5 if step else 1.0)  # the milestone at the 1-based step 2
        lrs = {"G": lr, "sft": 5 * lr, "D": lr}
        for tag in ("G", "D"):
            key = tag.lower() + "_params"
            _params_close(tag, synced[key], jstate[key], moments, lrs, step)
        for pe, je in zip(synced["d_params"]["bn"][1:], jstate["d_params"]["bn"][1:]):
            for k in ("mean", "var"):
                want = np.asarray(je[k])
                assert np.abs(pe[k].detach().numpy() - want).max() <= TOL * max(
                    1.0, np.abs(want).max()), (step, k)
        assert synced["d_opt"]["count"] == int(jstate["d_opt"].count) == step + 1
        # the gate: other_start_iter 1 holds the other group at step 1
        other_moved = [not torch.equal(a, b.detach()) for (n, a), b in zip(
            _named(g_before), tree_leaves(synced["g_params"]))]
        sft_leaf = [_is_sft(n) for n, _ in _named(synced["g_params"])]
        assert all(m for m, s in zip(other_moved, sft_leaf) if s)
        if step == 0:
            assert not any(m for m, s in zip(other_moved, sft_leaf) if not s)
            assert synced["g_opt"]["other"]["count"] == 0
            for k in ("mu", "nu"):
                assert all(torch.equal(a, b) for a, b in zip(
                    other_before[k], tree_leaves(synced["g_opt"]["other"][k])))
        else:
            assert all(m for m, s in zip(other_moved, sft_leaf) if not s)
            assert synced["g_opt"]["other"]["count"] == 1
    assert float(plogs["lr"]) == pytest.approx(LR / 2)  # the milestone at the 1-based step 2
    assert synced["g_opt"]["sft"]["count"] == 2


# ---------------------------------------------------------------------------
# data: the seg dataset, the resident store
# ---------------------------------------------------------------------------

NAMES = ("building_a", "sky_b", "plant_c", "water_d")


def _ost_tree(root, size=(100, 112)):
    """A synthetic OST tree: ``img/`` PNGs named by category, ``bicseg/``
    the [8, H, W] seg probabilities beside them, ``bg/`` two DIV2K-like
    background images, and a two-image val set (same layout)."""
    rs = np.random.RandomState(7)
    dirs = {}
    for part, names, hw in (("train", NAMES, size), ("val", ("grass_v", "animal_w"), (48, 40))):
        img_dir, seg_dir = root / part / "img", root / part / "bicseg"
        os.makedirs(img_dir)
        os.makedirs(seg_dir)
        for name in names:
            img = cv2.GaussianBlur((rs.rand(*hw, 3) * 255).astype(np.uint8), (5, 5), 2)
            cv2.imwrite(str(img_dir / f"{name}.png"), img)
            logits = rs.randn(8, *hw)
            prob = np.exp(logits) / np.exp(logits).sum(0, keepdims=True)
            torch.save(torch.from_numpy(prob.astype(np.float32)), str(seg_dir / f"{name}.pth"))
        dirs[part] = str(img_dir)
    os.makedirs(root / "bg")
    for i in range(2):
        cv2.imwrite(str(root / "bg" / f"{i:04d}.png"),
                    (rs.rand(size[0] + 8, size[1], 3) * 255).astype(np.uint8))
    dirs["bg"] = str(root / "bg")
    return dirs


@pytest.fixture(scope="module")
def ost(tmp_path_factory):
    return _ost_tree(tmp_path_factory.mktemp("ost"))


def _ds_opt(ost, **kw):
    return {"name": "OST", "mode": "LRHRseg_bg", "phase": "train", "scale": 4,
            "dataroot_HR": ost["train"], "dataroot_HR_bg": ost["bg"], "HR_size": 96,
            "use_flip": True, "use_rot": True, "bg_ratio": 3, "seed": 11, **kw}


def test_seg_dataset_samples_bit_equal_to_jax(ost):
    j, p = JSegDataset(_ds_opt(ost)), LRHRSegBGDataset(_ds_opt(ost))
    cats = []
    for i in range(12):
        a, b = j[i % 4], p[i % 4]
        assert set(a) == set(b)
        for k in ("LR", "HR", "seg"):
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=(i, k))
        assert a["HR_path"] == b["HR_path"] and int(a["category"]) == int(b["category"])
        cats.append((int(b["category"]), b["HR_path"]))
    assert b["LR"].shape == (24, 24, 3) and b["seg"].shape == (96, 96, 8)
    assert any(c == 0 and "/bg/" in path for c, path in cats)  # background draws
    assert any(c > 0 for c, _ in cats)
    val = {"phase": "val", "mode": "LRHRseg_bg", "scale": 4, "dataroot_HR": ost["train"]}
    jv, pv = JSegDataset(val)[1], LRHRSegBGDataset(val)[1]
    for k in ("LR", "HR", "seg"):
        np.testing.assert_array_equal(jv[k], pv[k])
    assert int(pv["category"]) == -1 and pv["HR"].shape == (96, 112, 3)


def test_seg_pool_and_one_resident_step(ost):
    ds = LRHRSegBGDataset(_ds_opt(ost))
    pools = [build_seg_crop_pool(ds, 6, *pool_generators(3, r)) for r in (0, 0, 1)]
    lr, seg, hr, cat = pools[0]
    assert (lr.dtype, seg.dtype, hr.dtype, cat.dtype) == (np.float32, np.uint8, np.uint8,
                                                          np.int64)
    assert lr.shape == (6, 24, 24, 3) and seg.shape == (6, 96, 96, 8) and hr.shape == (6, 96,
                                                                                       96, 3)
    assert all(np.array_equal(a, b) for a, b in zip(pools[0], pools[1]))
    assert not np.array_equal(pools[0][2], pools[2][2])
    assert "use_flip" in ds.opt and ds.opt["use_flip"] is True  # restored

    store = ResidentSegStore(ds, "cpu", n_crops=6, refresh_steps=2, seed=3,
                             async_refresh=False)
    assert store.nbytes == 6 * (24 * 24 * 3 * 4 + 96 * 96 * 8 + 96 * 96 * 3 + 8)
    np.testing.assert_array_equal(store.seg.numpy(), seg)
    make = lambda: SFTGANTrainer(SFTNetConfig(**NET), SFTGANTrainConfig(
        feature_weight=0.0, other_start_iter=0), device="cpu")
    a, b = make(), make()
    sa, sb = a.init_state(0), b.init_state(0)
    sa, la = a.train_step_resident(sa, store, 5, 2)
    sampled = store.make_sampler(2)(sample_seed(5, 0))
    assert sampled[3].dtype == torch.int64 and float(sampled[1].max()) <= 1.0
    sb, lb = b.train_step(sb, sampled, 5)
    assert all(torch.equal(x, y) if torch.is_tensor(x) else x == y
               for x, y in zip(tree_leaves(sa), tree_leaves(sb)))
    assert all(torch.equal(la[k], lb[k]) for k in la)
    store.maybe_refresh(2)
    assert store.pool_index == 1
    np.testing.assert_array_equal(store.hr.numpy(), pools[2][2])


# ---------------------------------------------------------------------------
# the train CLI and inspect_data
# ---------------------------------------------------------------------------


def _options(root, ost, name, **train_ds):
    from esrganplus_tpu_torch.options.options import _strip_comments

    shipped = os.path.join(os.path.dirname(__file__), "..", "esrganplus_tpu", "options",
                           "train", "train_sftgan.json")
    opt = json.loads(_strip_comments(open(shipped).read()))
    opt.update(name=name, use_tb_logger=False)
    opt["path"]["root"] = str(root)
    opt["datasets"]["train"].update(dataroot_HR=ost["train"], dataroot_HR_bg=ost["bg"],
                                    batch_size=2, n_workers=1, **train_ds)
    opt["datasets"]["val"] = {"name": "val", "mode": "LRHRseg_bg",
                              "dataroot_HR": ost["val"]}
    opt["network_G"]["nb"] = 1
    opt["logger"]["print_freq"] = 1
    opt["train"].update(niter=2, val_freq=2, save_checkpoint_freq=1, feature_weight=0)
    return opt


def _run(root, opt):
    from esrganplus_tpu_torch.cli import train as train_cli

    path = root / (opt["name"] + ".json")
    path.write_text(json.dumps(opt))
    train_cli.main(["-opt", str(path), "--device", "cpu"])
    return root / "experiments" / opt["name"]


def _log(exp):
    return "".join(open(exp / f).read() for f in sorted(os.listdir(exp)) if f.endswith(".log"))


def _sd(path):
    return torch.load(path, weights_only=True)


def _jax_written_state(path, step):
    """A state the JAX package's SFT-GAN trainer saved at ``step`` (its
    two-group ``multi_transform`` G optimizer, and ``f_params`` with the
    perceptual loss on), SFT nb 1 at the shipped widths; checks that the
    port's ``load_state_auto`` carries its parameters and moments exactly."""
    from esrganplus_tpu.models.vgg import VGGFeatConfig as JVCfg
    from esrganplus_tpu.train.checkpoint import save_state as jsave
    from esrganplus_tpu_torch.train.checkpoint import load_state_auto

    kw = dict(milestones=(50_000,), feature_weight=1.0)
    jt = JTrainer(JSFTCfg(nb=1), JTrainCfg(**kw), mesh=make_mesh(devices=jax.devices()[:1]),
                  vgg_cfg=JVCfg(feature_layer=2, layout=(8, 8)))
    jstate = jt.init_state(jax.random.PRNGKey(1))
    jstate["step"] = jnp.asarray(step, jnp.int32)
    jsave(str(path), jstate)

    pt = SFTGANTrainer(SFTNetConfig(nb=1), SFTGANTrainConfig(feature_weight=0.0), device="cpu")
    loaded = load_state_auto(str(path), pt.init_state(0), pt.net_g)
    want = sftgan_trainer_state_from_jax(jax.tree.map(np.asarray, jstate), pt.net_g)
    want.pop("f_params")
    assert loaded["step"] == step and loaded["g_opt"]["sft"]["count"] == 0
    for a, b in zip(tree_leaves(loaded), tree_leaves(want)):
        assert torch.equal(a.detach(), b) if torch.is_tensor(a) else a == b


@pytest.mark.parametrize("resident", [False, True])
def test_cli_sftgan_runs_and_resumes_bit_equal(tmp_path, ost, resident):
    """Two steps through ``cli.train``, then the second again from the
    first's checkpoint, bit-equal. Host-fed, the run starts from a state the
    JAX package wrote at step 1; resident, from the seed at step 0."""
    extra = dict(resident_crops=4, resident_refresh=3, resident_async_refresh=False) \
        if resident else {}
    opt = _options(tmp_path, ost, f"sftgan_cli_{int(resident)}", **extra)
    opt["eval_sharded"] = resident  # validation batched with its seg maps, or one by one
    start = 0 if resident else 1
    if not resident:
        _jax_written_state(tmp_path / "1.state.npz", 1)
        opt["path"]["resume_state"] = str(tmp_path / "1.state.npz")
    opt["train"]["niter"] = start + 2
    exp = _run(tmp_path, opt)
    log = _log(exp)
    assert "l_g_cls" in log and log.count("# Validation # PSNR") == 1
    assert ("resident crop store: 4 pairs" in log) == resident
    assert f"<step:       {start + 2}" in log
    assert resident or ("at step 1" in log and "<step:       1," not in log)
    models = exp / "models"
    g, d = _sd(models / "latest_G.pth"), _sd(models / "latest_D.pth")
    assert "sft_branch.2.conv0.weight" not in g and "sft_branch.0.sft0.SFT_scale_conv0.weight" in g
    assert "feature.21.running_var" in d and "cls.2.weight" in d
    assert os.path.isdir(exp / "val_images" / "grass_v")
    opt["path"]["resume_state"] = str(exp / "training_state" / f"{start + 1}.state.npz")
    _run(tmp_path, opt)
    for n, ref in (("G", g), ("D", d)):
        again = _sd(models / f"latest_{n}.pth")
        assert all(torch.equal(again[k], ref[k]) for k in ref), n


def test_inspect_data_writes_seg_grids(tmp_path, ost):
    from esrganplus_tpu_torch.cli import inspect_data

    opt = _options(tmp_path, ost, "inspect")
    path = tmp_path / "o.json"
    path.write_text(json.dumps(opt))
    out = tmp_path / "grids"
    inspect_data.main(["-opt", str(path), "--batches", "2", "--out", str(out)])
    for i in range(2):
        for key, hw in (("LR", (24, 96)), ("HR", (96, 384)), ("seg", (96, 384))):
            img = cv2.imread(str(out / f"batch{i}_{key}.png"))
            assert img.shape[:2] == hw, key
