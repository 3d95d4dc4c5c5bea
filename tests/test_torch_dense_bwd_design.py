"""Cheap CPU tests of the RDB adjoint kernels' two designs (no JAX, no card):
which design the three backward wrappers take (``rdb_ct_bwd``,
``conv3x3_ct_bwd``, ``rdb_t_bwd``), the C entries' design codes and arities,
a torch mirror of the bf16 data-gradient block (the flipped taps, the weight
elements each tap's slot reads in both layouts: the adjoint inverts
``wlayout.cuh``'s ``KN``) against ``_dgrad_plain``, a torch mirror of the
bf16 weight gradient's split (workspace rows, tiles a row, the fixed
finishing order, the blocks' m16 tiles) against ``_wgrad_plain``, and the
shared-memory fit against ``csrc/dgrad.cuh`` and ``csrc/wgrad.cuh``. The
twins themselves are held against the JAX package by
``test_torch_kernels_bwd.py`` and ``test_torch_rdb_t.py``."""

import re

import pytest
import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels import launch as L
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels import rdb_t as R
from esrganplus_tpu_torch.models.layers import fp32_exact
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = build.KERNEL_WIDTHS
PAIRS = [(nf, gc) for nf in WIDTHS for gc in WIDTHS]
DGRAD = (build.CSRC / "dgrad.cuh").read_text()
WGRAD = (build.CSRC / "wgrad.cuh").read_text()
BWD = (K.rdb_ct_bwd, K.conv3x3_ct_bwd, R.rdb_t_bwd)


def _params(nf, gc, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g) * 0.2
    p = {f"conv{k}": {"w": rnd(3, 3, nf + (k - 1) * gc, nf if k == 5 else gc),
                      "b": rnd(nf if k == 5 else gc)} for k in range(1, 6)}
    p["conv1x1"] = {"w": rnd(1, 1, nf, gc)}
    return p


def _stage_weights(nf, gc, seed=0):
    """Per conv of the RDB adjoint: (cin, s, taps, HWIO [taps, cin, s] flat,
    by-target flat), stages 1..5 and the 1×1 (key 11)."""
    p = _params(nf, gc, seed)
    byt = R.prepare_rdb_t_weights(p, nf, gc, True, torch.float32)
    out = {}
    for k in range(1, 6):
        w = p[f"conv{k}"]["w"]
        out[k] = (w.shape[2], w.shape[3], 9, w.reshape(9, w.shape[2], w.shape[3]),
                  byt[k - 1].flatten())
    out[11] = (nf, gc, 1, p["conv1x1"]["w"].reshape(1, nf, gc), byt[5].flatten())
    return out


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


# ---------------------------------------------------------------------------
# (a) the design by dtype, and the C entries that take it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", BWD, ids=lambda f: f.__name__)
def test_design_by_dtype(fn):
    """bf16 runs on the tensor cores, fp32 on the CUDA cores; every other
    dtype is refused; each wrapper counts its calls by design, and the
    ``*_mma_steps`` refuse anything but bf16."""
    assert L.design(torch.bfloat16) == "mma" and L.design(torch.float32) == "fma"
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            L.design(dt)
    assert set(fn.launches_by_design) == set(L.DESIGNS) == {"fma", "mma"}
    steps = {K.rdb_ct_bwd: K.rdb_ct_bwd_mma_steps, K.conv3x3_ct_bwd: K.conv3x3_ct_bwd_mma_steps,
             R.rdb_t_bwd: R.rdb_t_bwd_mma_steps}[fn]
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(TypeError, match="bfloat16"):
        steps(x, *([None] * {K.rdb_ct_bwd: 4, K.conv3x3_ct_bwd: 2, R.rdb_t_bwd: 8}[fn]))


@pytest.mark.parametrize("fn", BWD, ids=lambda f: f.__name__)
def test_public_wrappers_take_no_design(fn):
    """The design follows the dtype alone: a public backward wrapper takes
    no ``kind``, so a bf16 call cannot land on the FMA kernels (the FMA
    baseline of a bf16 call is the private planners', uncounted)."""
    import inspect

    assert "kind" not in inspect.signature(fn).parameters
    planner = {K.rdb_ct_bwd: K._rdb_ct_bwd_steps, K.conv3x3_ct_bwd: K._conv3x3_ct_bwd_steps,
               R.rdb_t_bwd: R._rdb_t_bwd_steps}[fn]
    assert "kind" in inspect.signature(planner).parameters


def test_cpu_calls_run_the_twins_and_count_nothing():
    nf, gc = 8, 8
    p = _params(nf, gc)
    g = torch.Generator().manual_seed(1)
    bf = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    x, gr = bf(1, 5, 7, nf), bf(1, 5, 7, nf)
    K.reset_design_counts()
    R.reset_design_counts()
    w = K.prepare_rdb_ct_weights(p, torch.bfloat16)
    _, cat, lsv = K._rdb_ct_train_plain(x, w)
    got, want = K.rdb_ct_bwd(x, w, cat, lsv, gr), K.rdb_ct_bwd_plain(x, w, cat, lsv, gr)
    assert all(got[k] is None or torch.equal(got[k], want[k]) for k in want)
    wc = w["w1"][:, :, :, :8].contiguous()
    got, want = K.conv3x3_ct_bwd(x, wc, gr), K.conv3x3_ct_bwd_plain(x, wc, gr)
    assert all(torch.equal(got[k], want[k]) for k in want)
    ws = R.prepare_rdb_t_weights(p, nf, gc, True, torch.bfloat16)
    got, want = R.rdb_t_bwd(x, *ws, gr), R.rdb_t_bwd_plain(x, *ws, gr)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for fn in BWD:
        assert fn.launches == 0 and fn.launches_by_design == {"fma": 0, "mma": 0}
    assert R.rdb_t_bwd.recompute_by_design == {"fma": 0, "mma": 0}


def _c_params(src: str, fn: str) -> list:
    m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("lib,fn,head", [
    ("dgrad_ct", "esr_dgrad", ["int dtype", "int design", "int chunk", "int taps"]),
    ("wgrad_ct", "esr_wgrad", ["int dtype", "int design", "int taps"]),
    ("rdb_t", "esr_rdb_t_dgrad", ["int dtype", "int design", "int chunk", "int taps", "int nf",
                                  "int gc"]),
    ("rdb_t", "esr_rdb_t_wgrad", ["int dtype", "int design", "int taps", "int nf", "int gc"]),
])
def test_c_entries_take_the_design(lib, fn, head):
    """Each backward entry takes (dtype, design, ...) in the arity its ctypes
    signature declares and hands the design to the template's run()."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    params = _c_params(src, fn)
    assert params[:len(head)] == head
    assert len(params) == len(build.SIGNATURES[lib][fn])
    assert re.search(r"run\(dtype, design, ", src[src.index(f"int {fn}("):])


@pytest.mark.parametrize("hdr", [DGRAD, WGRAD], ids=["dgrad", "wgrad"])
def test_run_refuses_fp32_on_the_tensor_cores(hdr):
    """run() sends bf16 + mma to the tensor cores, every other design code
    but fma is refused, and fp32 never reaches the tensor cores; the design
    codes are launch.DESIGNS."""
    body = hdr[hdr.index("int run(int dtype, int design"):]
    body = body[:body.index("\n}\n")]
    assert "if (dtype == kBFloat16 && design == kMma) return tc::dispatch(" in body
    assert "if (design != kFma) return (int)cudaErrorInvalidValue;" in body
    assert "kFloat32 && design == kMma" not in body
    assert body.index("design == kMma") < body.index("design != kFma") < body.index("kFloat32")
    enum = dict(re.findall(r"k(Fma|Mma) = (\d)", re.search(r"enum Design[^}]*}", hdr).group(0)))
    assert {k.lower(): int(v) for k, v in enum.items()} == L.DESIGNS


# ---------------------------------------------------------------------------
# (b) the data gradient: flipped taps and the slots' weight elements
# ---------------------------------------------------------------------------


def _slots(flat, cin, s, taps, by_target):
    """Every (chunk, tap) slot of one launch → ({(n0, t): [sp, np] weights},
    read count per flat element); asserts that each 16-byte vector is 8
    contiguous elements along the layout's vector axis."""
    np_ = L.dgrad_np(cin)
    seen = torch.zeros(flat.numel(), dtype=torch.long)
    slots = {}
    for n0 in range(0, cin, np_):
        for t in range(taps):
            k, n, idx = L.dgrad_slot_reads(t, n0, np_, s, cin, taps=taps, by_target=by_target)
            real = idx >= 0
            assert torch.equal(real, (k < s) & (n0 + n < cin))
            # HWIO: 8 dz channels (k) a vector; by-target: 8 input channels (n)
            vec = idx.reshape(-1, np_ // 8, 8) if by_target else idx.t().reshape(np_, -1, 8)
            ok = vec[..., 0] >= 0
            assert torch.equal(vec[ok] - vec[ok][:, :1], torch.arange(8).expand(int(ok.sum()), 8))
            seen += torch.bincount(idx[real], minlength=flat.numel())
            m = torch.zeros(k.shape)
            m[real] = flat[idx[real]]
            slots[(n0, t)] = m
    return slots, seen


@pytest.mark.parametrize("nf,gc", PAIRS)
def test_slots_read_every_weight_once_in_both_layouts(nf, gc):
    """At every conv of the adjoint (stages 1..5 and the 1×1) the slots of
    all chunks read each weight element exactly once, in both layouts, and
    slot t of chunk n0 holds forward tap taps-1-t: element (co, ci) is the
    HWIO weight w[taps-1-t, n0+ci, co]."""
    for cin, s, taps, hwio, byt in _stage_weights(nf, gc, seed=nf + gc).values():
        for flat, lay in ((hwio.flatten(), None), (byt, (nf, gc))):
            slots, seen = _slots(flat, cin, s, taps, lay)
            assert torch.equal(seen, torch.ones_like(seen))
            for (n0, t), m in slots.items():
                n = min(L.dgrad_np(cin), cin - n0)
                assert torch.equal(m[:s, :n], hwio[taps - 1 - t, n0:n0 + n, :].t())
                assert not m[s:].any() and not m[:, n:].any()


def _mirror_dgrad(dz, flat, cin, s, taps, by_target=None):
    """The bf16 kernel's sum for one launch in fp32: per chunk and tap slot
    t' = 3*dy + dx the haloed dz tile shifted by (dy, dx) times the slot,
    each tap summed from zero and joined in order. NHWC dz [B, H, W, s]."""
    B, H, W, _ = dz.shape
    sp = L.round16(s)
    tile = F.pad(dz, (0, sp - s, 1, 1, 1, 1))
    slots, _ = _slots(flat, cin, s, taps, by_target)
    np_ = L.dgrad_np(cin)
    out = torch.zeros(B, H, W, -(-cin // np_) * np_)
    with fp32_exact():
        for (n0, t), m in slots.items():
            dy, dx = divmod(t, 3) if taps == 9 else (1, 1)
            out[..., n0:n0 + np_] += tile[:, dy:dy + H, dx:dx + W] @ m
    return out[..., :cin]


def _close(got, want, tol=1e-5):
    d = (got - want).abs().max().item()
    assert d <= tol * max(1.0, want.abs().max().item()), d


@pytest.mark.parametrize("nf,gc", [(8, 8), (16, 8), (8, 32), (64, 16), (32, 64)])
def test_dgrad_mirror_equals_the_twin(nf, gc):
    """The mirrored block sums (both layouts, every conv of the adjoint,
    ragged chunks included) equal _dgrad_plain, conv_transpose2d of the
    rounded dz with the HWIO weight, to fp32 summation order."""
    g = torch.Generator().manual_seed(nf * gc)
    for cin, s, taps, hwio, byt in _stage_weights(nf, gc, seed=nf).values():
        dz = torch.randn(2, 5, 11, s, generator=g).to(torch.bfloat16).float()
        want = K._dgrad_plain(dz.permute(0, 3, 1, 2),
                              hwio.reshape(3 if taps == 9 else 1, -1, cin, s)).permute(0, 2, 3, 1)
        for flat, lay in ((hwio.flatten(), None), (byt, (nf, gc))):
            _close(_mirror_dgrad(dz, flat, cin, s, taps, lay), want)


@pytest.mark.parametrize("cin,cout", [(64, 64), (200, 64), (448, 64), (24, 8), (200, 16)])
def test_conv3x3_ct_bwd_chunks_take_any_cin(cin, cout):
    """conv3x3_ct_bwd's data gradient at cin 64, 200 and 448: ragged last
    chunks zero-filled past cin, equal to the twin."""
    g = torch.Generator().manual_seed(cin + cout)
    w = torch.randn(3, 3, cin, cout, generator=g) * 0.05
    dz = torch.randn(1, 6, 9, cout, generator=g).to(torch.bfloat16).float()
    want = K._dgrad_plain(dz.permute(0, 3, 1, 2), w).permute(0, 2, 3, 1)
    _close(_mirror_dgrad(dz, w.flatten(), cin, cout, 9), want)
    assert -(-cin // L.dgrad_np(cin)) == {64: 2, 200: 4, 448: 7, 24: 1}[cin]


# ---------------------------------------------------------------------------
# (c) the weight gradient's split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 32, 32), (2, 37, 53), (1, 5, 7), (1, 128, 128)])
@pytest.mark.parametrize("cin,s,taps", [(192, 64, 9), (64, 32, 9), (64, 32, 1), (448, 64, 9),
                                        (8, 8, 9), (8, 8, 1)])
def test_wgrad_rows_cover_every_tile_once(shape, cin, s, taps):
    """The mma rows cut the 4×16 tiles into contiguous ranges in tile order,
    none empty, at most 128 rows; the blocks of WG_MT m16 tiles cover every
    (16-channel chunk, tap) tile once and stage at most WG_XC channels."""
    B, H, W = shape
    tiles = L.wgrad_tiles(B, H, W, "mma")
    assert tiles == B * -(-H // 4) * -(-W // 16)
    ranges = L.wgrad_ranges(B, H, W, cin, s, taps=taps, kind="mma")
    assert len(ranges) == L.wgrad_parts(B, H, W, cin, s, taps=taps, kind="mma") <= 128
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a < b for a, b in ranges) and all(r[1] == q[0] for r, q in zip(ranges, ranges[1:]))
    mt = taps * -(-cin // 16)
    blocks = [range(m0, min(mt, m0 + L.WG_MT[taps])) for m0 in range(0, mt, L.WG_MT[taps])]
    assert sorted(m for b in blocks for m in b) == list(range(mt))
    for b in blocks:
        chunks = {m // taps for m in b}
        assert (max(chunks) - min(chunks) + 1) * 16 <= L.WG_XC[taps]
    if len(ranges) < min(tiles, 128):  # else at most one row a tile, or 128 rows
        assert len(blocks) * len(ranges) >= L.WG_BLOCKS * 0.5


def _mirror_wgrad(x, dz, taps, ranges):
    """The mma weight gradient in fp32: per workspace row the sum over its
    4×16 tiles (zero outside the image) of x shifted by each tap, transposed,
    times the rounded dz, and db of the unrounded dz; then the rows added in
    order."""
    B, H, W, cin = x.shape
    s = dz.shape[-1]
    ty, tx = -(-H // 4), -(-W // 16)
    xp = F.pad(x, (0, 0, 1, 16 * tx - W + 1, 1, 4 * ty - H + 1))
    zp = F.pad(dz, (0, 0, 0, 16 * tx - W, 0, 4 * ty - H))
    zr = zp.to(torch.bfloat16).float()
    dw, db = torch.zeros(taps, cin, s), torch.zeros(s)
    with fp32_exact():
        for a, b in ranges:
            row, rowb = torch.zeros(taps, cin, s), torch.zeros(s)
            for tile in range(a, b):
                bb, y0, x0 = tile // (tx * ty), (tile // tx) % ty * 4, tile % tx * 16
                d = zr[bb, y0:y0 + 4, x0:x0 + 16].reshape(64, s)
                rowb += zp[bb, y0:y0 + 4, x0:x0 + 16].reshape(64, s).sum(0)
                for t in range(taps):
                    dy, dx = divmod(t, 3) if taps == 9 else (1, 1)
                    xs = xp[bb, y0 + dy:y0 + dy + 4, x0 + dx:x0 + dx + 16].reshape(64, cin)
                    row[t] += xs.t() @ d
            dw, db = dw + row, db + rowb
    return dw, db


@pytest.mark.parametrize("cin,s,taps,shape", [(16, 8, 9, (2, 9, 21)), (24, 16, 9, (1, 13, 18)),
                                              (16, 32, 1, (2, 9, 21)), (40, 8, 9, (3, 5, 7))])
def test_wgrad_mirror_equals_the_twin(cin, s, taps, shape):
    """The split's rows added in the finishing pass's order equal
    _wgrad_plain (and db the unrounded dz's sum) at 1e-6 of max|ref|."""
    B, H, W = shape
    g = torch.Generator().manual_seed(cin * s + taps)
    x = torch.randn(B, H, W, cin, generator=g).to(torch.bfloat16).float()
    dz = torch.randn(B, H, W, s, generator=g)
    ranges = L.wgrad_ranges(B, H, W, cin, s, taps=taps, kind="mma")
    assert len(ranges) > 1
    dw, db = _mirror_wgrad(x, dz, taps, ranges)
    want = K._wgrad_plain(x.permute(0, 3, 1, 2),
                          dz.to(torch.bfloat16).float().permute(0, 3, 1, 2), 3 if taps == 9 else 1)
    _close(dw, want.reshape(taps, cin, s), 1e-6)
    _close(db, dz.sum((0, 1, 2)), 1e-6)


def test_fma_rows_are_unchanged():
    """The FMA design keeps its 8×16 tiles and its split."""
    assert L.wgrad_tiles(16, 32, 32) == 16 * 4 * 2
    assert [L.wgrad_parts(16, 32, 32, c, s) for c, s in ((192, 64), (64, 32), (8, 8))] == [
        43, 128, 128]
    assert [L.wgrad_parts(16, 32, 32, c, s, kind="mma") for c, s in ((192, 64), (64, 32))] == [
        29, 86]


# ---------------------------------------------------------------------------
# (d) shared memory against the headers
# ---------------------------------------------------------------------------


def test_constants_match_the_headers():
    """launch.py's mirrors of the bf16 blocks are csrc's: the data-gradient
    widths and shared memory, the weight-gradient tile, its blocks' m16
    tiles and staged channels."""
    assert _const(DGRAD, "MAX_S") == L.DGRAD_MAX_S
    assert _const(DGRAD, "MAX_SMEM") == L.MAX_SMEM
    assert re.search(r"return cin > 96 \? 64 : cin > 16 \? 32 : cin > 8 \? 16 : 8;", DGRAD)
    assert [L.dgrad_np(c) for c in (8, 16, 24, 64, 96, 104, 448)] == [8, 16, 32, 32, 32, 64, 64]
    assert re.search(r"return nk \? np \* ldsm_pitch\(sp\) : sp \* ldsm_pitch\(np\);", DGRAD)
    assert re.search(r"return HP \* ldsm_pitch\(sp\) \+ taps \* dgrad_slot\(np, sp, nk\);", DGRAD)
    assert _const(WGRAD, "WG_TH") == L.WG_TH
    assert re.search(r"MT = TAPS == 9 \? (\d+) : (\d+);", WGRAD).groups() == tuple(
        str(L.WG_MT[t]) for t in (9, 1))
    assert re.search(r"XC = TAPS == 9 \? (\d+) : (\d+);", WGRAD).groups() == tuple(
        str(L.WG_XC[t]) for t in (9, 1))
    assert re.search(r"return 2 \* \(XH \* XW \* ldsm_pitch\(taps == 9 \? 32 : 64\) \+ "
                     r"WG_PIX \* ldsm_pitch\(nch\)\);", WGRAD)
    assert L.wgrad_smem(9, 64) == 2 * (6 * 18 * 80 + 64 * 144)


@pytest.mark.parametrize("nf,gc", PAIRS)
def test_every_block_fits(nf, gc):
    """Every data- and weight-gradient block of the RDB adjoint at these
    widths fits the card's opt-in shared memory, in both layouts."""
    for cin, s, taps, _, _ in _stage_weights(nf, gc).values():
        assert s <= L.DGRAD_MAX_S
        for nk in (True, False):
            assert L.dgrad_smem(L.dgrad_np(cin), L.round16(s), taps, nk) <= L.MAX_SMEM
        assert L.wgrad_smem(taps, max(16, s)) <= L.MAX_SMEM


@pytest.mark.parametrize("cin", [200, 448])
def test_conv3x3_ct_bwd_fits_at_any_cin(cin):
    """The block's N is a chunk of at most 64 channels, so its shared memory
    does not grow with cin."""
    for cout in WIDTHS:
        assert L.dgrad_smem(L.dgrad_np(cin), L.round16(cout), 9, True) <= L.MAX_SMEM
        assert L.wgrad_smem(9, max(16, cout)) <= L.MAX_SMEM
