"""The port's training-data tools against the JAX package's, on the CPU:
the pure-python LMDB writer and reader (``data/lmdb_io.py``), the ``lmdb``
data type of the datasets with its key cache, ``cli/prepare_data.py``
(``subimgs``, ``modlrbic``, ``lmdb``) and ``cli/inspect_data.py``."""

import json
import os
import pickle

import numpy as np
import pytest

from esrganplus_tpu.data import lmdb_io as jlmdb
from esrganplus_tpu_torch.data import lmdb_io as plmdb


def _items(seed=0):
    """Enough small entries for several leaf pages and a branch level, and
    values that take one and several overflow pages."""
    rng = np.random.RandomState(seed)
    items = {f"k{i:04d}".encode(): rng.bytes(40) for i in range(300)}
    items.update({b"big_one": rng.bytes(5000), b"big_two": rng.bytes(4080),
                  b"big_three": rng.bytes(12345)})
    return items


def _bytes(path):
    with open(os.path.join(path, "data.mdb"), "rb") as f:
        return f.read()


@pytest.mark.parametrize("n_small", [0, 300])
def test_write_lmdb_is_byte_identical_to_jax(tmp_path, n_small):
    items = {k: v for k, v in _items().items() if n_small or k.startswith(b"big")}
    mine, theirs = str(tmp_path / "port.lmdb"), str(tmp_path / "jax.lmdb")
    plmdb.write_lmdb(mine, items)
    jlmdb.write_lmdb(theirs, items)
    assert _bytes(mine) == _bytes(theirs)
    for reader in (plmdb.LmdbReader, jlmdb.LmdbReader):  # each reads the other's
        for path in (mine, theirs):
            r = reader(path)
            assert dict(r.items()) == items and r.entries == len(items)
            assert r.keys() == sorted(items)
            assert r.get(b"big_three") == items[b"big_three"] and r.get(b"nope") is None


def test_lmdb_reader_rejects_a_bad_file(tmp_path):
    path = tmp_path / "bad.lmdb"
    path.mkdir()
    (path / "data.mdb").write_bytes(b"\0" * (2 * plmdb.PAGE_SIZE))
    with pytest.raises(ValueError, match="not an LMDB file"):
        plmdb.LmdbReader(str(path))


def _seeded_images(root, sizes=((100, 90), (75, 130))):
    """Two smooth seeded BGR PNGs."""
    from esrganplus_tpu_torch.ops.image_io import save_img

    d = os.path.join(root, "src")
    rng = np.random.RandomState(4)
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w] / 9.0
        img = 0.5 + 0.3 * np.sin(yy[..., None] * (1 + np.arange(3)) + xx[..., None])
        img = np.clip(img + rng.rand(h, w, 3) * 0.1, 0, 1)
        save_img((img * 255).round().astype(np.uint8), os.path.join(d, f"im{i}.png"))
    return d


def _tree(root):
    """{relative path: file bytes} of every file under root."""
    out = {}
    for dp, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(dp, n), "rb") as f:
                out[os.path.relpath(os.path.join(dp, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    """Both CLIs' outputs of subimgs, modlrbic and lmdb on the same inputs."""
    from esrganplus_tpu.cli.prepare_data import main as jmain
    from esrganplus_tpu_torch.cli.prepare_data import main as pmain

    root = str(tmp_path_factory.mktemp("prep"))
    src = _seeded_images(root)
    out = {}
    for tag, main in (("port", pmain), ("jax", jmain)):
        base = os.path.join(root, tag)
        main(["subimgs", src, os.path.join(base, "sub"), "--crop", "48", "--step", "24",
              "--thres", "8", "--workers", "2"])
        main(["modlrbic", os.path.join(base, "sub"), os.path.join(base, "mod"),
              "--scale", "4"])
        main(["lmdb", os.path.join(base, "mod", "HR_x4"), os.path.join(base, "HR.lmdb")])
        main(["lmdb", os.path.join(base, "mod", "LR_x4"), os.path.join(base, "LR.lmdb")])
        out[tag] = base
    return out


@pytest.mark.parametrize("step", ["sub", "mod", "HR.lmdb", "LR.lmdb"])
def test_prepare_data_outputs_bit_equal_to_jax(prepared, step):
    got, want = _tree(os.path.join(prepared["port"], step)), _tree(
        os.path.join(prepared["jax"], step))
    assert sorted(got) == sorted(want) and got
    for name in got:
        assert got[name] == want[name], name
    if step == "sub":
        assert len(got) == 9 + 10  # 3×3 crops of the 100×90 image, 2×5 of the 75×130
    if step == "mod":
        assert sorted({n.split(os.sep)[0] for n in got}) == ["Bic_x4", "HR_x4", "LR_x4"]
    if step == "HR.lmdb":
        keys = pickle.load(open(os.path.join(prepared["port"], step, "_keys_cache.p"), "rb"))
        assert len(keys) == 2 * 19 and keys == sorted(keys)


def _train_opt(hr, lr, **kw):
    return {"mode": "LRHR", "phase": "train", "scale": 4, "HR_size": 32, "dataroot_HR": hr,
            "dataroot_LR": lr, "seed": 3, "use_flip": True, "use_rot": True, **kw}


def test_lmdb_dataset_gives_the_image_folder_samples(prepared):
    """The port's LRHRDataset over the packed LMDBs gives the samples of
    the same folders as images (and of JAX's lmdb dataset), at one seed;
    LRDataset reads an LR LMDB as the folder."""
    from esrganplus_tpu.data import create_dataset as jcreate
    from esrganplus_tpu_torch.data import create_dataset as pcreate

    base = prepared["port"]
    img_opt = _train_opt(os.path.join(base, "mod", "HR_x4"), os.path.join(base, "mod", "LR_x4"))
    db_opt = _train_opt(os.path.join(base, "HR.lmdb"), os.path.join(base, "LR.lmdb"),
                        data_type="lmdb")
    a, b, c = pcreate(db_opt), pcreate(img_opt), jcreate(db_opt)
    assert len(a) == len(b) == len(c) == 19
    assert a.paths_hr == [os.path.splitext(os.path.basename(p))[0] for p in b.paths_hr]
    for i in (0, 3, 18, 3):
        sa, sb, sc = a[i], b[i], c[i]
        for key in ("LR", "HR"):
            np.testing.assert_array_equal(sa[key], sb[key])
            np.testing.assert_array_equal(sa[key], sc[key])
    lr_img = pcreate({"mode": "LR", "dataroot_LR": os.path.join(base, "mod", "LR_x4")})
    lr_db = pcreate({"mode": "LR", "dataroot_LR": os.path.join(base, "LR.lmdb"),
                     "data_type": "lmdb"})
    np.testing.assert_array_equal(lr_db[4]["LR"], lr_img[4]["LR"])


def test_lmdb_keys_cache_honoured_and_created(tmp_path):
    from esrganplus_tpu_torch.data.datasets import _LmdbReader

    root = str(tmp_path / "env.lmdb")
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    plmdb.write_lmdb(root, {b"a": img.tobytes(), b"a.meta": b"4, 4, 3",
                            b"b": img.tobytes(), b"b.meta": b"4, 4, 3"})
    r1 = _LmdbReader(root)  # the first open writes the cache, as the reference's
    cache = os.path.join(root, "_keys_cache.p")
    assert r1.keys == ["a", "b"] and pickle.load(open(cache, "rb")) == ["a", "a.meta", "b",
                                                                         "b.meta"]
    with open(cache, "wb") as f:  # a cache is honoured over the cursor
        pickle.dump(["b", "b.meta"], f)
    r2 = _LmdbReader(root)
    assert r2.keys == ["b"]
    np.testing.assert_array_equal(r2.read("b"), img.astype(np.float32) / 255.0)


def _inspect_options(root, hr, lr, mode="LRHR"):
    opt = {"name": "inspect", "model": "sr", "scale": 4,
           "datasets": {"train": {"name": "t", "mode": mode, "dataroot_HR": hr,
                                  "dataroot_LR": lr, "n_workers": 1, "batch_size": 4,
                                  "HR_size": 32}},
           "path": {"root": root},
           "network_G": {"which_model_G": "RRDB_net", "nf": 8, "nb": 1, "gc": 4}}
    path = os.path.join(root, f"inspect_{mode}.json")
    with open(path, "w") as f:
        json.dump(opt, f)
    return path


def test_inspect_data_writes_its_grids(prepared, capsys):
    from esrganplus_tpu_torch.cli.inspect_data import main
    from esrganplus_tpu_torch.ops.image_io import read_img

    base = prepared["port"]
    out = os.path.join(base, "inspect")
    main(["-opt", _inspect_options(base, os.path.join(base, "HR.lmdb"),
                                   os.path.join(base, "LR.lmdb")),
          "--batches", "2", "--out", out])
    assert sorted(os.listdir(out)) == ["batch0_HR.png", "batch0_LR.png", "batch1_HR.png",
                                       "batch1_LR.png"]
    assert read_img(os.path.join(out, "batch0_HR.png")).shape == (32, 128, 3)
    assert read_img(os.path.join(out, "batch1_LR.png")).shape == (8, 32, 3)
    said = capsys.readouterr().out
    assert "batch 1: LR:(4, 8, 8, 3) HR:(4, 32, 32, 3)" in said


def test_inspect_data_refuses_seg_datasets(prepared):
    """Seg datasets are ported (``cli.inspect_data`` writes their grids:
    tests/test_torch_sftgan_trainer.py); one whose images have no seg map
    beside them is refused, naming the map it looked for, from the loader's
    worker thread on the caller's."""
    from esrganplus_tpu_torch.cli.inspect_data import main

    base = prepared["port"]
    with pytest.raises(FileNotFoundError, match="no seg map"):
        main(["-opt", _inspect_options(base, base, base, mode="LRHRseg_bg"),
              "--out", os.path.join(base, "nope")])
