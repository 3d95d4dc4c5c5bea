"""Cheap CPU tests of the dense-stage kernel's two designs (no JAX, no card):
which design the three wrappers take (``rdb_ct``, ``conv3x3_ct``,
``rdb_t``), a torch mirror of the bf16 tensor-core kernel's K walk and of the
weight elements each ring slot reads in both layouts, its whole-tile or
sliced-tile decision against ``csrc/dense_conv.cuh``'s constants, and a torch
twin of the kernel's decomposition (shifted tile rows times ring slots,
summed in the walk's order) against the plain twins ``rdb_ct_plain``,
``rdb_t_plain`` and ``conv3x3_ct_plain``, which ``test_torch_kernels.py``
and ``test_torch_rdb_t.py`` hold against the JAX package."""

import re

import pytest
import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels import launch as L
from esrganplus_tpu_torch.kernels import rdb_ct as K
from esrganplus_tpu_torch.kernels import rdb_t as R
from esrganplus_tpu_torch.models.layers import fp32_exact

WIDTHS = build.KERNEL_WIDTHS
PAIRS = [(nf, gc) for nf in WIDTHS for gc in WIDTHS]
HDR = (build.CSRC / "dense_conv.cuh").read_text()


def _params(nf, gc, conv1x1=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g) * 0.2
    p = {f"conv{k}": {"w": rnd(3, 3, nf + (k - 1) * gc, nf if k == 5 else gc),
                      "b": rnd(nf if k == 5 else gc)} for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = {"w": rnd(1, 1, nf, gc)}
    return p


# ---------------------------------------------------------------------------
# (a) the design by dtype, and the C entries that take it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", [K.rdb_ct, K.conv3x3_ct, R.rdb_t])
def test_design_by_dtype(fn):
    """bf16 runs on the tensor cores, fp32 on the CUDA cores; every other
    dtype is refused; each wrapper counts its calls by design."""
    assert L.design(torch.bfloat16) == "mma" and L.design(torch.float32) == "fma"
    for dt in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            L.design(dt)
    assert set(fn.launches_by_design) == set(L.DESIGNS) == {"fma", "mma"}


def test_cpu_calls_run_the_twins_and_count_nothing():
    nf, gc = 8, 8
    p = _params(nf, gc)
    x = torch.randn(1, 5, 7, nf).to(torch.bfloat16)
    K.reset_design_counts()
    R.reset_design_counts()
    w = K.prepare_rdb_ct_weights(p, torch.bfloat16)
    assert torch.equal(K.rdb_ct(x, w), K.rdb_ct_plain(x, w))
    wc, bc = K.prepare_conv_ct_weights(p["conv1"]["w"][..., :8], None, torch.bfloat16)
    assert torch.equal(K.conv3x3_ct(x, wc, bc), K.conv3x3_ct_plain(x, wc, bc))
    ws = R.prepare_rdb_t_weights(p, nf, gc, True, torch.bfloat16)
    assert torch.equal(R.rdb_t(x, *ws), R.rdb_t_plain(x, *ws))
    for fn in (K.rdb_ct, K.conv3x3_ct, R.rdb_t):
        assert fn.launches == 0 and fn.launches_by_design == {"fma": 0, "mma": 0}
    assert R.rdb_t_bwd.recompute_by_design == {"fma": 0, "mma": 0}


def _c_params(src: str, fn: str) -> int:
    m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("lib", ["rdb_ct", "rdb_t"])
def test_c_entries_take_the_design(lib):
    """The dense entries take (dtype, design, ...) and the dispatch runs the
    tensor cores for bf16 only: fp32 on them (TF32) is refused."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    entry = "esr_dense_conv3x3" if lib == "rdb_ct" else "esr_rdb_t_stage"
    assert re.search(rf"int {entry}\(int dtype, int design, int cout, int mode,", src)
    assert re.search(r"dispatch\(dtype, design, cout, mode, a, esr::", src)
    for fn, argtypes in build.SIGNATURES[lib].items():
        if fn != "esr_dzsrc_size":  # csrc/dz_src.cuh's
            assert _c_params(src, fn) == len(argtypes), fn
    body = HDR[HDR.index("int dispatch(int dtype, int design"):]
    body = body[:body.index("\n}\n")]
    assert "dtype == kBFloat16 && design == kMma" in body
    assert "dtype == kFloat32 && design == kMma" not in body
    assert re.search(r"dtype == kFloat32 && design == kFma\) return dispatch_cout<float, false>",
                     body)
    enum = dict(re.findall(r"k(Fma|Mma) = (\d)", re.search(r"enum Design[^}]*}", HDR).group(0)))
    assert {k.lower(): int(v) for k, v in enum.items()} == L.DESIGNS


# ---------------------------------------------------------------------------
# (b) the K walk and the weight elements each ring slot reads
# ---------------------------------------------------------------------------


def _gather(flat, cin, cout, kn, *, taps=9, c11=0, by_target=None):
    """Walk one launch's ring stages (or the 1×1's one slot) and gather what
    each slot row reads → ([taps, cin, cout] weights, read count per flat
    element)."""
    got = torch.full((taps, cin, cout), float("nan"))
    seen = torch.zeros(flat.numel(), dtype=torch.long)
    stages = [(0, 0, c11)] if taps == 1 else L.dense_stages(cin, cout, kn)
    kp = L.round16(cin)
    for t, c, rows in stages:
        assert rows > 0 and rows % 16 == 0 and c + rows <= kp
        r, n, idx = L.dense_slot_reads(t, c, rows, cin, cout, taps=taps, by_target=by_target)
        real = idx >= 0
        assert torch.equal(real, c + r < cin)  # zero rows only past cin
        seen += torch.bincount(idx[real], minlength=flat.numel())
        got[t, c + r[real], n[real]] = flat[idx[real]]
    return got, seen


@pytest.mark.parametrize("nf,gc", PAIRS)
def test_k_walk_reads_every_weight_once(nf, gc):
    """At every stage k the ring's slots read every weight element of both
    layouts exactly once, and the element a slot row reads is the HWIO
    weight of its (tap, channel, output): against prepare_rdb_ct_weights
    (HWIO) and prepare_rdb_t_weights (by-target)."""
    p = _params(nf, gc, seed=nf + gc)
    hwio = K.prepare_rdb_ct_weights(p, torch.float32)
    byt = R.prepare_rdb_t_weights(p, nf, gc, True, torch.float32)
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        want = p[f"conv{k}"]["w"].reshape(9, cin, cout)
        for flat, kn, lay in ((hwio[f"w{k}"].flatten(), True, None),
                              (byt[k - 1].flatten(), False, (nf, gc))):
            got, seen = _gather(flat, cin, cout, kn, by_target=lay)
            assert torch.equal(seen, torch.ones_like(seen))
            assert torch.equal(got, want)
    # the stage-2 1×1 shortcut: one slot of round16(nf) K rows, zero past nf
    want = p["conv1x1"]["w"].reshape(1, nf, gc)
    for flat, kn, lay in ((hwio["w11"].flatten(), True, None),
                          (byt[5].flatten(), False, (nf, gc))):
        got, seen = _gather(flat, nf, gc, kn, taps=1, c11=L.round16(nf), by_target=lay)
        assert torch.equal(seen, torch.ones_like(seen)) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# (c) the whole or sliced tile against the header
# ---------------------------------------------------------------------------


def test_tile_constants_match_the_header():
    """csrc/dense_conv.cuh's ring, slice and opt-in constants and its
    shared-memory formulas are the ones launch.py mirrors."""
    const = lambda n: int(re.search(rf"constexpr int {n} = (\d+);", HDR).group(1))
    assert (const("NSLOT"), const("KCH"), const("MAX_SMEM")) == (
        L.DENSE_NSLOT, L.DENSE_KCH, L.MAX_SMEM)
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR

    assert L.MAX_SMEM == WR.MAX_SMEM
    assert re.search(r"return kn \? kch \* ldsm_pitch\(np\) : np \* ldsm_pitch\(kch\);", HDR)
    assert re.search(r"return HP \* ldsm_pitch\(kt\) \+ NSLOT \* dense_slot\(np, kt < KCH \? kt "
                     r": KCH, kn\) \+\s+\(c11 \? dense_slot\(np, c11, kn\) : 0\);", HDR)
    assert re.search(r"return dense_smem\(np, kp, kn, c11\) <= MAX_SMEM \? kp : KCH;", HDR)
    assert re.search(r"stage_x\(c, min\(kt, kp - c\), xp\);", HDR)  # the restage of a slice
    assert L.HALO_PIX == 180 and L.ldsm_pitch(64) == 144 and L.ldsm_pitch(192) == 400


@pytest.mark.parametrize("nf,gc", PAIRS)
def test_rdb_stages_stage_the_whole_tile(nf, gc):
    """Every dense stage of rdb_ct and rdb_t, up to stage 5's 64 + 4·64 =
    320 channels, fits a block with the tile of all its channels."""
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        c11 = L.round16(nf) if k == 2 else 0
        for kn in (True, False):
            kp = L.round16(cin)
            assert L.dense_kt(cout, kp, kn, c11) == kp
            assert L.dense_smem(cout, kp, kn, c11) <= L.MAX_SMEM


@pytest.mark.parametrize("cout", WIDTHS)
def test_conv3x3_ct_takes_any_cin(cout):
    """conv3x3_ct (HWIO) at cin 1..512: the tile is whole where it fits and
    else slices of KCH channels, each a single ring chunk; every block fits,
    and the walk covers every channel of every tap once."""
    sliced = []
    for cin in range(1, 513):
        kp = L.round16(cin)
        kt = L.dense_kt(cout, kp, True)
        assert L.dense_smem(cout, kt, True) <= L.MAX_SMEM
        if kt != kp:
            sliced.append(cin)
            assert kt == L.DENSE_KCH and L.dense_smem(cout, kp, True) > L.MAX_SMEM
        stages = L.dense_stages(cin, cout, True)
        for t in range(9):
            cover = sorted((c, rows) for tt, c, rows in stages if tt == t)
            assert [c for c, _ in cover] == list(range(0, kp, min(kt, L.DENSE_KCH)))
            assert sum(rows for _, rows in cover) == kp
    if cout == 64:  # the tile of all channels stops fitting beside the ring at 400+
        assert sliced and sliced[0] > 384 and 448 in sliced
    if cout == 8:
        assert not sliced


# ---------------------------------------------------------------------------
# (d) a torch twin of the decomposition against the plain twins
# ---------------------------------------------------------------------------


def _mirror_conv(src, w, cin, cout, *, by_target=None, w11=None, c0=0):
    """The kernel's sum for one stage: per ring stage (tap t, channels c ..
    c+rows) the haloed source shifted by tap t times the slot it reads from
    the flat weight ``w``, accumulated in the walk's order in fp32; with the
    flat 1×1 weight ``w11`` also the 1×1 over the centre tap's first
    round16(c0) rows (second result). NHWC fp32 ``src`` holds the stage's
    sources (x | concat prefix)."""
    B, H, W, _ = src.shape
    kp = L.round16(cin)
    tile = F.pad(src[..., :cin], (0, kp - cin, 1, 1, 1, 1))
    acc = torch.zeros(B, H, W, cout)
    acc11 = None

    def slot(flat, t, c, rows, taps, cw):
        r, n, idx = L.dense_slot_reads(t, c, rows, cw, cout, taps=taps, by_target=by_target)
        m = torch.zeros(rows, cout)
        real = idx >= 0
        m[r[real], n[real]] = flat[idx[real]]
        return m

    with fp32_exact():
        for t, c, rows in L.dense_stages(cin, cout, by_target is None):
            dy, dx = divmod(t, 3)
            acc = acc + tile[:, dy:dy + H, dx:dx + W, c:c + rows] @ slot(w, t, c, rows, 9, cin)
            if w11 is not None and t == 4 and c == 0:
                c11 = L.round16(c0)
                acc11 = tile[:, 1:1 + H, 1:1 + W, :c11] @ slot(w11, 0, 0, c11, 1, c0)
    return acc, acc11


def _mirror_rdb(x, flats, biases, nf, gc, *, by_target=None, res=None, rrdb_scale=None,
                slope=0.2, res_scale=0.2):
    """rdb_ct's rounding points (the kernels' shared epilogue) on the
    mirrored stage sums; x NHWC fp32."""
    rnd = lambda t: t.to(x.dtype).float()
    xf = x.float()
    cat = xf
    xs = []
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        s, s11 = _mirror_conv(cat, flats[k], cin, cout, by_target=by_target,
                              w11=flats["w11"] if k == 2 else None, c0=nf)
        v = s + biases[k]
        if k == 5:
            out = v * res_scale + xf
            if res is not None:
                out = out * rrdb_scale + res.float()
            return out.to(x.dtype)
        v = _lrelu(v, slope)
        if k == 2 and s11 is not None:
            v = v + s11
        if k == 4:
            v = v + xs[1]
        xs.append(rnd(v))
        cat = torch.cat([cat, xs[-1]], -1)


def _lrelu(t, slope):
    return torch.where(t >= 0, t, t * slope)


def _close(got, want):
    """Equal to fp32 rounding: the sums differ only in their order, so
    max|Δ| ≤ 1e-5·max(1, max|ref|)."""
    d = (got - want).abs().max().item()
    assert d <= 1e-5 * max(1.0, want.abs().max().item()), d


@pytest.mark.parametrize("nf,gc,conv1x1,fold", [(8, 8, True, False), (16, 8, False, True),
                                                (8, 16, True, True), (16, 16, True, False)])
def test_decomposition_equals_rdb_ct_plain(nf, gc, conv1x1, fold):
    g = torch.Generator().manual_seed(nf * gc)
    p = _params(nf, gc, conv1x1, seed=nf * gc)
    w = K.prepare_rdb_ct_weights(p, torch.float32)
    x = torch.randn(2, 9, 13, nf, generator=g)
    res = torch.randn(2, 9, 13, nf, generator=g) if fold else None
    kw = dict(res=res, rrdb_scale=0.2) if fold else {}
    flats = {k: w[f"w{k}"].flatten() for k in range(1, 6)}
    flats["w11"] = (w["w11"] if conv1x1 else torch.zeros(nf, gc)).flatten()
    got = _mirror_rdb(x, flats, {k: w[f"b{k}"] for k in range(1, 6)}, nf, gc, **kw)
    want = K.rdb_ct_plain(x, w, res, rrdb_scale=0.2 if fold else None)
    _close(got, want)


@pytest.mark.parametrize("nf,gc,fold", [(8, 8, False), (16, 8, True), (8, 16, False)])
def test_decomposition_equals_rdb_t_plain(nf, gc, fold):
    g = torch.Generator().manual_seed(3 * nf + gc)
    p = _params(nf, gc, True, seed=3 * nf + gc)
    ws = R.prepare_rdb_t_weights(p, nf, gc, True, torch.float32)
    x = torch.randn(2, 9, 13, nf, generator=g)
    res = torch.randn(2, 9, 13, nf, generator=g) if fold else None
    flats = {k: ws[k - 1].flatten() for k in range(1, 6)}
    flats["w11"] = ws[5].flatten()
    bias = ws[6].flatten()
    biases = {k: bias[R._boff(k, nf, gc):R._boff(k, nf, gc) + (nf if k == 5 else gc)]
              for k in range(1, 6)}
    got = _mirror_rdb(x, flats, biases, nf, gc, by_target=(nf, gc), res=res,
                      rrdb_scale=0.2 if fold else None)
    want = R.rdb_t_plain(x, *ws, res, rrdb_scale=0.2 if fold else None)
    _close(got, want)


@pytest.mark.parametrize("cin,cout", [(3, 8), (24, 16), (448, 64)])
def test_decomposition_equals_conv3x3_ct_plain(cin, cout):
    """Any cin, the sliced tile (448 at 64 outputs) included: conv + bias +
    residual, one rounding."""
    g = torch.Generator().manual_seed(cin)
    w, b = K.prepare_conv_ct_weights(torch.randn(3, 3, cin, cout, generator=g) * 0.05,
                                     torch.randn(cout, generator=g), torch.float32)
    x = torch.randn(1, 5, 7, cin, generator=g)
    res = torch.randn(1, 5, 7, cout, generator=g)
    s, _ = _mirror_conv(x, w.flatten(), cin, cout)
    got = s + b + res
    _close(got, K.conv3x3_ct_plain(x, w, b, res))


# ---------------------------------------------------------------------------
# tools/dense_variants.py: the accumulation variants it measures
# ---------------------------------------------------------------------------


def _variants_tool():
    import importlib.util

    path = build.CSRC.parents[1] / "tools" / "dense_variants.py"
    spec = importlib.util.spec_from_file_location("dense_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["stage", "chained", "kstep", "twosum", "split"])
def test_variants_tool_patches_the_shipped_join(name):
    """Each variant the tool builds replaces tap_mma's one stage join (the
    shipped design, "stage", is the header itself), so its measurements stay
    those of the kernel as it is apart from the accumulation."""
    tool = _variants_tool()
    assert tool.VARIANTS == ("stage", "chained", "kstep", "twosum", "split")
    out = tool.variant(name, HDR)
    if name == "stage":
        assert out == HDR
        return
    assert HDR.count(tool.STAGE_JOIN) == 1 and tool.STAGE_JOIN not in out
    assert out.count("variant_join<Tl::MT, Tl::NT8, KN>(acc, a,") == 1
    assert out.replace(tool.CALL, tool.STAGE_JOIN).replace(
        tool.HEAD + tool.BODIES[name] + "}\n\n", "") == HDR
    with pytest.raises(ValueError):
        tool.variant(name, HDR.replace(tool.STAGE_JOIN, ""))


def test_fp64_reference_equals_the_twin_to_fp32_rounding():
    """rdb_ct_fp64 is the training twin's graph summed in float64: on fp32
    tensors (no bf16 rounding between stages) it agrees with the twin to
    fp32 summation order, in every noise mode and with the fold."""
    nf, gc = 8, 8
    g = torch.Generator().manual_seed(4)
    w = K.prepare_rdb_ct_weights(_params(nf, gc), torch.float32)
    x, res, noise = (torch.randn(1, 6, 9, nf, generator=g) for _ in range(3))
    for kw in ({}, dict(res=res, rrdb_scale=0.2), dict(noise=noise, sigma=0.1),
               dict(seed=(3, 5), sigma=0.1)):
        for a, b in zip(K.rdb_ct_fp64(x, w, **kw), K._rdb_ct_train_plain(x, w, **kw)):
            assert a.dtype == b.dtype == torch.float32
            _close(a, b)
