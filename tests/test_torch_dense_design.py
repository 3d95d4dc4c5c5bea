"""Cheap CPU tests of the dense-stage kernel's two designs (no JAX, no card):
which design the three wrappers take (``rdb_ct``, ``conv3x3_ct``,
``rdb_t``), the mirror of the bf16 tensor-core kernel's plan
(``launch.dense_plan``: tile width, outputs a block owns, slots, blocks)
against ``csrc/dense_conv.cuh``'s constants, the tiles its blocks walk, the
weight elements it stages in both layouts, the order its partial sums join
in, the weight bytes it stages, and a torch twin of the kernel's
decomposition (shifted tile rows times the resident weights, summed in the
join order) against the plain twins ``rdb_ct_plain``, ``rdb_t_plain`` and
``conv3x3_ct_plain``, which ``test_torch_kernels.py`` and
``test_torch_rdb_t.py`` hold against the JAX package."""

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
    assert K.rdb_ct.weight_bytes_staged == K.conv3x3_ct.weight_bytes_staged == 0
    K.rdb_ct.weight_bytes_staged = K.conv3x3_ct.weight_bytes_staged = 7
    K.reset_design_counts()
    assert K.rdb_ct.weight_bytes_staged == K.conv3x3_ct.weight_bytes_staged == 0


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
# (b) the weights each block stages
# ---------------------------------------------------------------------------

NSM = 132  # the H100's SMs


def _gather(flat, cin, c0, cout, *, taps=9, by_target=None):
    """Stage one launch's weights as the kernel's blocks do (every tap, the
    K rows of the group walk, padding rows zero) → ([taps, cin, cout]
    weights, read count per flat element)."""
    got = torch.full((taps, cin, cout), float("nan"))
    seen = torch.zeros(flat.numel(), dtype=torch.long)
    kch = L.dense_k_channels(cin, c0)
    real = [c for c in kch if c is not None]
    assert real == list(range(cin))  # every channel once, in source order
    for t in range(taps):
        r, n, idx = L.dense_weight_reads(t, 0, cin, cin, cout, taps=taps, by_target=by_target)
        assert (idx >= 0).all()
        seen += torch.bincount(idx, minlength=flat.numel())
        got[t, r, n] = flat[idx]
    return got, seen


@pytest.mark.parametrize("nf,gc", PAIRS)
def test_k_walk_reads_every_weight_once(nf, gc):
    """At every stage k the staged weights read every weight element of both
    layouts exactly once (the parts of a split launch own disjoint outputs
    that together are all of them), and the element a staged row reads is
    the HWIO weight of its (tap, channel, output): against
    prepare_rdb_ct_weights (HWIO) and prepare_rdb_t_weights (by-target)."""
    p = _params(nf, gc, seed=nf + gc)
    hwio = K.prepare_rdb_ct_weights(p, torch.float32)
    byt = R.prepare_rdb_t_weights(p, nf, gc, True, torch.float32)
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        plan = L.dense_plan(cout, cin, nf, k == 2, 1, 339, 510, NSM)
        parts = [range(q * plan.nb, (q + 1) * plan.nb) for q in range(cout // plan.nb)]
        assert sorted(c for part in parts for c in part) == list(range(cout))
        want = p[f"conv{k}"]["w"].reshape(9, cin, cout)
        for flat, lay in ((hwio[f"w{k}"].flatten(), None), (byt[k - 1].flatten(), (nf, gc))):
            got, seen = _gather(flat, cin, nf, cout, by_target=lay)
            assert torch.equal(seen, torch.ones_like(seen))
            assert torch.equal(got, want)
    # the stage-2 1×1 shortcut: x's groups, zero past nf
    want = p["conv1x1"]["w"].reshape(1, nf, gc)
    for flat, lay in ((hwio["w11"].flatten(), None), (byt[5].flatten(), (nf, gc))):
        got, seen = _gather(flat, nf, nf, gc, taps=1, by_target=lay)
        assert torch.equal(seen, torch.ones_like(seen)) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# (c) the plan, the tile walk and the join order against the header
# ---------------------------------------------------------------------------


def test_tile_constants_match_the_header():
    """csrc/dense_conv.cuh's tile, group, slice, warpgroup, slot and opt-in
    constants are the ones launch.py mirrors (the mirror's plan is held
    against the C plan on the card)."""
    body = HDR[HDR.index("namespace dmma {"):]
    const = lambda n: int(re.search(rf"constexpr int {n} = (\d+);", body).group(1))
    assert (const("TH"), const("GCH"), const("SLICE_G"), const("NWG"), const("MAX_BUF"),
            const("MAX_SMEM")) == (L.DENSE_TH, L.DENSE_GCH, L.DENSE_SLICE_G, L.DENSE_NWG,
                                   L.DENSE_MAX_BUF, L.MAX_SMEM)
    from esrganplus_tpu_torch.kernels.workbench import rdb as WR

    assert L.MAX_SMEM == WR.MAX_SMEM
    assert L.dense_group_bytes(16) == 12288 and L.dense_group_bytes(8) == 7168
    assert L.HALO_PIX == 180 and L.ldsm_pitch(64) == 144 and L.ldsm_pitch(192) == 400


@pytest.mark.parametrize("nf,gc", PAIRS)
def test_rdb_stages_stage_the_whole_tile(nf, gc):
    """Every dense stage of rdb_ct and rdb_t has a plan at the inference and
    the training shape: stages up to 6 groups (192 channels at the
    flagship's widths) hold a tile's every channel in one slot (one partial
    sum a tap), the stage-2 1×1 always so, wider ones take slices of 6."""
    for B, H, W in ((1, 339, 510), (16, 32, 32)):
        for k in range(1, 6):
            cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
            plan = L.dense_plan(cout, cin, nf, k == 2, B, H, W, NSM)
            assert plan is not None and plan.smem <= L.MAX_SMEM
            _, ng = L.dense_groups(cin, nf)
            slices = len(L.dense_joins(cin, nf)) // 9
            assert slices == -(-ng // L.DENSE_SLICE_G)
            if k == 2:
                assert slices == 1


@pytest.mark.parametrize("nf,gc", PAIRS)
def test_smem_within_the_opt_in_for_every_stage(nf, gc):
    """Shared memory stays within the 232,448 bytes a block may opt into
    for every (stage, outputs, mode, weight layout): both layouts stage the
    same K-major core matrices, and the 1×1's rows ride only in stage 2;
    each warpgroup's stream gets the same number of slots."""
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        gx, ng = L.dense_groups(cin, nf)
        for mode in (L.ACT, L.ACT_1X1, L.ACT_ADD, L.RESID):
            s11 = mode == L.ACT_1X1
            for _layout in ("hwio", "by_target"):
                for B, H, W in ((1, 339, 510), (16, 32, 32), (2, 37, 53)):
                    plan = L.dense_plan(cout, cin, nf, s11, B, H, W, NSM)
                    assert plan.smem == L.dense_smem(plan.tw, plan.nb, plan.nbuf, ng, gx, s11)
                    assert plan.smem <= L.MAX_SMEM and plan.nbuf in (2, 4)
                    assert plan.tw == 8 or plan.nb <= 32


@pytest.mark.parametrize("cout", WIDTHS)
def test_conv3x3_ct_takes_any_cin(cout):
    """conv3x3_ct (HWIO) at cin 1..512: every launch has a plan within the
    opt-in, the weights of all cin stay resident (the outputs a block owns
    shrink instead), and the joins cover every channel of every tap once,
    in slices of at most 192."""
    for cin in range(1, 513):
        plan = L.dense_plan(cout, cin, cin, False, 2, 37, 53, NSM)
        _, ng = L.dense_groups(cin, cin)
        assert plan is not None and plan.smem <= L.MAX_SMEM
        assert plan.smem >= L.dense_w_bytes(ng, plan.nb)
        joins = L.dense_joins(cin, cin)
        for t in range(9):
            cover = [c for tt, chans in joins if tt == t for c in chans]
            assert cover == list(range(cin))
        assert all(len(chans) <= 192 for _, chans in joins)
    if cout == 64:  # 448 channels: a quarter of the outputs a block, three slices
        plan = L.dense_plan(64, 448, 448, False, 2, 37, 53, NSM)
        assert plan.nb == 16 and len(L.dense_joins(448, 448)) == 27


DIV2K_SHAPES = [(1, 339, 510), (1, 384, 510), (1, 288, 510), (1, 510, 339), (1, 510, 384)]


@pytest.mark.parametrize("B,H,W", DIV2K_SHAPES + [(1, 128, 128), (2, 37, 53), (16, 32, 32)])
def test_tiles_cover_every_output_once(B, H, W):
    """The blocks' tiles (``dense_walk``) cover every output pixel and
    channel exactly once, at the benchmark's five photo shapes, 128², the
    odd 37×53 at B = 2 and the training batch, for each stage's plan of the
    flagship (stage 5's split in two output halves included); at the photo
    shapes every block walks about ten tiles or more."""
    for cout, cin, s11 in ((32, 64, False), (32, 96, True), (32, 160, False), (64, 192, False),
                           (64, 64, False)):
        plan = L.dense_plan(cout, cin, 64, s11, B, H, W, NSM)
        seen = torch.zeros(B, -(-H // 8) * 8, -(-W // plan.tw) * plan.tw, cout, dtype=torch.long)
        walk = L.dense_walk(plan, cout, B, H, W)
        assert len(walk) == plan.blocks <= NSM
        for outs, tiles in walk:
            for b, y0, x0 in tiles:
                seen[b, y0:y0 + 8, x0:x0 + plan.tw, outs.start:outs.stop] += 1
        assert torch.equal(seen[:, :H, :W], torch.ones(B, H, W, cout, dtype=torch.long))
        per = [len(t) for _, t in walk]
        assert max(per) - min(per) <= 1
        if (B, H, W) in DIV2K_SHAPES:
            assert plan.tiles * cout // plan.nb >= 8 * plan.blocks


def _mma_sync_joins(cin, c0, cout, kn):
    """The join order of the mma.sync design this one replaced (its
    ``tap_mma`` walk over the channels x | concat, rounded up to 16): where
    the haloed 8×16 tile of all of them fitted beside the three-slot weight
    ring, tap by tap with chunks of 192 inside each; else slices of 192,
    tap by tap inside each."""
    kp = L.round16(cin)
    slot = lambda kch: kch * L.ldsm_pitch(cout) if kn else cout * L.ldsm_pitch(kch)
    whole = L.HALO_PIX * L.ldsm_pitch(kp) + 3 * slot(min(kp, 192)) <= L.MAX_SMEM
    chunk = lambda lo: list(range(lo, min(lo + 192, cin)))
    if whole:
        return [(t, chunk(lo)) for t in range(9) for lo in range(0, kp, 192)]
    return [(t, chunk(lo)) for lo in range(0, kp, 192) for t in range(9)]


@pytest.mark.parametrize("cin,c0,cout,kn,kept", [
    (64, 64, 32, True, True), (96, 64, 32, False, True), (128, 64, 32, True, True),
    (160, 64, 32, False, True), (192, 64, 64, True, True), (32, 32, 32, True, True),
    (160, 32, 32, False, True), (24, 8, 16, True, True), (448, 448, 64, True, True),
    (512, 512, 64, True, True), (256, 64, 64, True, False), (320, 64, 64, True, False),
    (320, 64, 64, False, False), (272, 16, 16, True, False), (200, 200, 16, True, False)])
def test_join_order_against_the_mma_sync_walk(cin, c0, cout, kn, kept):
    """Each output's partial sums join in the mma.sync design's (tap, chunk)
    order wherever a tile's channels fit one slot (up to 6 groups: every
    stage of the flagship) and wherever that design sliced the tile (past
    about 400 channels). Between the two (kept False: stages 4 and 5 at gc
    = 64, conv3x3_ct at 193 to about 400 channels) the joins go slice by
    slice, taps within each, where that design went tap by tap, chunks
    within each; with x narrower than a group the slices also cut the
    channels elsewhere. Each partial runs over its slice's channels from
    zero, and every tap covers every channel once either way."""
    joins = L.dense_joins(cin, c0)
    gx, ng = L.dense_groups(cin, c0)
    slices = [joins[i][1] for i in range(0, len(joins), 9)]
    assert [c for sl in slices for c in sl] == list(range(cin))
    assert joins == [(t, sl) for sl in slices for t in range(9)]
    assert all(len(sl) <= L.DENSE_SLICE_G * L.DENSE_GCH for sl in slices)
    assert (joins == _mma_sync_joins(cin, c0, cout, kn)) == kept
    assert kept or ng > L.DENSE_SLICE_G
    if c0 % 32 == 0 and cin % 32 == 0:  # the flagship's widths: no padding rows
        assert L.dense_k_channels(cin, c0) == list(range(cin))


@pytest.mark.parametrize("B,H,W", [(1, 339, 510), (16, 32, 32), (2, 37, 53)])
def test_weight_bytes_staged_is_blocks_times_stage_weights(B, H, W):
    """``dense_staged_bytes`` is blocks × the weights of the outputs a block
    owns (the 1×1's rows too); over an RDB's five launches at the photo
    shape it is under a fifth of what the mma.sync design staged (every
    8×16 tile the stage's whole weights)."""
    nf, gc = 64, 32
    new = old = 0
    for k in range(1, 6):
        cin, cout = nf + (k - 1) * gc, nf if k == 5 else gc
        plan = L.dense_plan(cout, cin, nf, k == 2, B, H, W, NSM)
        got = L.dense_staged_bytes(cout, cin, nf, k == 2, B, H, W, NSM)
        assert got == plan.blocks * (9 * cin + (nf if k == 2 else 0)) * plan.nb * 2
        new += got
        old += B * -(-H // 8) * -(-W // 16) * (9 * cin + (nf if k == 2 else 0)) * cout * 2
    if (B, H, W) == (1, 339, 510):
        assert new * 5 < old


# ---------------------------------------------------------------------------
# (d) a torch twin of the decomposition against the plain twins
# ---------------------------------------------------------------------------


def _mirror_conv(src, w, cin, cout, *, by_target=None, w11=None, c0=0):
    """The kernel's sum for one stage: per join (tap t, its slice's channels)
    the haloed source shifted by tap t times the staged rows of the flat
    weight ``w``, accumulated in the join order in fp32; with the flat 1×1
    weight ``w11`` also the 1×1 over the centre tap's first c0 channels
    (second result). NHWC fp32 ``src`` holds the stage's
    sources (x | concat prefix)."""
    B, H, W, _ = src.shape
    tile = F.pad(src[..., :cin], (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(B, H, W, cout)
    acc11 = None

    def slot(flat, t, c, rows, taps, cw):
        r, n, idx = L.dense_weight_reads(t, c, rows, cw, cout, taps=taps, by_target=by_target)
        m = torch.zeros(rows, cout)
        real = idx >= 0
        m[r[real], n[real]] = flat[idx[real]]
        return m

    with fp32_exact():
        for t, chans in L.dense_joins(cin, c0 or cin):
            c, rows = chans[0], len(chans)
            assert chans == list(range(c, c + rows))
            dy, dx = divmod(t, 3)
            acc = acc + tile[:, dy:dy + H, dx:dx + W, c:c + rows] @ slot(w, t, c, rows, 9, cin)
            if w11 is not None and t == 4 and c == 0:
                acc11 = tile[:, 1:1 + H, 1:1 + W, :c0] @ slot(w11, 0, 0, c0, 1, c0)
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
# tools/dense_variants.py: the split and accumulation variants it measures
# ---------------------------------------------------------------------------


def _variants_tool():
    import importlib.util

    path = build.CSRC.parents[1] / "tools" / "dense_variants.py"
    spec = importlib.util.spec_from_file_location("dense_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["shipped", "split16", "chained"])
def test_variants_tool_patches_the_shipped_kernel(name):
    """Each variant the tool builds changes only its own lines of the
    header (the shipped kernel is the header itself), so its measurements
    are those of the kernel as it is apart from that; a header that lost
    those lines is refused. split16's stage 5 (16 outputs a block, two
    16-column slots of 6 groups) fits the opt-in."""
    tool = _variants_tool()
    assert list(tool.VARIANTS) == ["shipped", "split16", "chained"]
    out = tool.variant(name, HDR)
    if name == "shipped":
        assert out == HDR
        return
    for old, new in tool.VARIANTS[name]:
        assert HDR.count(old) == 1 and out.count(new) == 1
        out = out.replace(new, old)
    assert out == HDR
    with pytest.raises(ValueError):
        tool.variant(name, HDR.replace(tool.VARIANTS[name][0][0], ""))
    if name == "split16":
        gx, ng = L.dense_groups(192, 64)
        assert L.dense_smem(16, 16, L.DENSE_NWG, ng, gx) <= L.MAX_SMEM
        assert L.dense_plan(64, 192, 64, False, 1, 339, 510, NSM).nb == 32


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
