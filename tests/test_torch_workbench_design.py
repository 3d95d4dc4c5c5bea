"""Cheap CPU tests of the workbench's two designs (no JAX, no card): which
design ``conv3x3`` and ``rdb_fused`` take by dtype, the tensor-core conv's
output-channel chunks, the tensor-core RDB's tile regions and shared-memory
count, a pure-torch mirror of its target-major decomposition against
``rdb_fused_plain``, and the C entries and tile constants against
``csrc/workbench_{conv,rdb}.cu``."""

import importlib.util
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from esrganplus_tpu_torch.kernels import build
from esrganplus_tpu_torch.kernels.stage_ct import DESIGNS
from esrganplus_tpu_torch.kernels.workbench import conv as C
from esrganplus_tpu_torch.kernels.workbench import rdb as R

CONV_SRC = (build.CSRC / "workbench_conv.cu").read_text()
RDB_SRC = (build.CSRC / "workbench_rdb.cu").read_text()
BF, F32 = torch.bfloat16, torch.float32


# ---------------------------------------------------------------------------
# designs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,design", [(BF, "mma"), (F32, "fma")], ids=["bf16", "fp32"])
def test_conv_design_by_dtype(dtype, design):
    assert C.conv_design(dtype) == design


@pytest.mark.parametrize("xdt,wdt,design", [(BF, BF, "mma"), (F32, F32, "fma"), (F32, BF, "fma")],
                         ids=["bf16", "fp32", "fp32x_bf16w"])
def test_rdb_design_by_dtype_pair(xdt, wdt, design):
    """bf16 activations with bf16 weights run on the tensor cores; fp32
    activations (fp32 or bf16 weights) stay on the FMA kernel."""
    assert R.rdb_design(xdt, wdt) == design
    want = R.MMA_TILE if design == "mma" else (R.KERNEL_TILE,) * 2
    assert R.kernel_tile(design, nf=64, gc=32) == want


def test_other_dtypes_are_refused():
    with pytest.raises(TypeError):
        C.conv_design(torch.float16)
    for pair in ((BF, F32), (torch.float16, torch.float16)):
        with pytest.raises(TypeError):
            R.rdb_design(*pair)


@pytest.mark.parametrize("tile", [(16, 16), (8, 32), 8])
def test_mma_kernel_runs_only_its_two_tiles(tile):
    """The tensor-core kernel runs the tiles of MMA_TILES and no other."""
    assert R.MMA_TILES == ((8, 16), (8, 8), (4, 8))
    with pytest.raises(ValueError):
        R.kernel_tile("mma", tile, nf=64, gc=32)


def test_fma_kernel_runs_a_square_tile():
    assert R.kernel_tile("fma", 16, nf=64, gc=32) == (16, 16)
    with pytest.raises(ValueError):
        R.kernel_tile("fma", (8, 16), nf=64, gc=32)


@pytest.mark.parametrize("nf,gc,tile", [(64, 32, (8, 16)), (16, 8, (8, 16)), (128, 32, (8, 8)),
                                        (128, 64, (8, 8)), (192, 32, (8, 8)), (72, 32, (8, 8)),
                                        (64, 40, (8, 8)), (256, 32, (4, 8)), (8, 160, (4, 8))])
def test_mma_tile_is_the_largest_that_fits(nf, gc, tile):
    """A call runs the first tile of MMA_TILES that takes its widths: 8×16
    at one pass (nf ≤ 64, gc ≤ 32; its planes fit there), else the first
    whose planes and ring fit a block; nf=128, gc=64 takes 8×8 (its 8×16
    planes would need 315 KB), nf=72, gc=32 too (8×16 would fit, but needs
    two K chunks of x a tap)."""
    assert R.mma_tile(nf, gc) == tile == R.kernel_tile("mma", nf=nf, gc=gc)
    assert R.mma_smem_bytes(nf, gc, *tile) <= R.MAX_SMEM
    one = nf <= R.MMA_NF_PASS and gc <= R.MMA_GC_PASS
    assert (tile == R.MMA_TILE) == one
    for t in R.MMA_TILES[R.MMA_TILES.index(tile) + 1:]:
        assert (t in R.mma_tiles(nf, gc)) == (R.mma_smem_bytes(nf, gc, *t) <= R.MAX_SMEM)


def test_mma_tile_raises_where_no_tile_fits():
    with pytest.raises(ValueError, match="shared memory"):
        R.mma_tile(512, 256)


def test_mma_takes_every_width_the_bf16_fma_kernel_took():
    """Before the tensor-core design, bf16 with bf16 weights ran the FMA
    kernel at tile 8 wherever its planes fit: every such nf, gc (multiples
    of 8 up to 512) has a tensor-core tile that fits."""
    for nf in range(8, 513, 8):
        for gc in range(8, 513, 8):
            if R.smem_bytes(BF, nf, gc, R.KERNEL_TILE) <= R.MAX_SMEM:
                assert R.mma_smem_bytes(nf, gc, *R.mma_tile(nf, gc)) <= R.MAX_SMEM, (nf, gc)


# ---------------------------------------------------------------------------
# conv3x3: output-channel chunks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cout,width", [(7, 8), (24, 32), (32, 32), (64, 64), (224, 128),
                                        (192, 64), (129, 64), (300, 64)])
def test_conv_chunks_cover_every_output_channel_once(cout, width):
    """The chunks over ``blockIdx.z`` take the output channels in order,
    each once, none empty, all of the chunk width but a ragged last one."""
    assert C.conv_chunk_width(cout) == width
    chunks = C.conv_chunks(cout)
    assert [c for a, b in chunks for c in range(a, b)] == list(range(cout))
    assert all(b - a == width for a, b in chunks[:-1]) and 0 < chunks[-1][1] - chunks[-1][0]
    assert len(chunks) == -(-cout // width)
    # the tensor-core warps split N into n8 tiles: 1 or an even count a warp
    assert width in (8, 16) or (width // 16) % 2 == 0


def test_conv_chunk_rule_is_the_kernels():
    body = CONV_SRC[CONV_SRC.index("constexpr int chunk_np(int cout)"):]
    body = body[:body.index("\n}\n")]
    assert "while (n < cout) n *= 2;" in body
    assert "(cout + 127) / 128 * 128 <= (cout + 63) / 64 * 64 ? 128 : 64" in body
    num = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", CONV_SRC).group(1))
    assert num("MAX_NP") == C.MMA_MAX_NP
    assert (num("NSLOT"), num("XC")) == (3, 192)


def test_conv_cpu_tensors_take_the_twin_and_count_nothing():
    C.reset_launch_counts()
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(1, 8, 16, 5).astype(np.float32))
    w = torch.from_numpy(rs.randn(3, 3, 5, 7).astype(np.float32))
    assert torch.equal(C.conv3x3(x, w, act_slope=0.0), C.conv3x3_plain(x, w, act_slope=0.0))
    assert C.conv3x3.launches == 0 and C.conv3x3.launches_by_design == {"fma": 0, "mma": 0}


# ---------------------------------------------------------------------------
# rdb_fused: the tensor-core tile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile", R.MMA_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mma_regions_and_m16_padding(tile):
    """Region j (j = 0: x) has halo 5 − j; its pixels pad to whole m16
    tiles; the warps' units cover every tile (and every N half) once."""
    th, tw = tile
    regions = R.mma_regions(th, tw)
    assert len(regions) == 6
    for j, (rh, rw, pix, nmt, nsplit, mt) in enumerate(regions):
        assert (rh, rw) == (th + 2 * (5 - j), tw + 2 * (5 - j)) and pix == rh * rw
        assert 16 * (nmt - 1) < pix <= 16 * nmt
        assert nsplit == (2 if j == 5 and nmt < R.MMA_WARPS else 1)
        units = [(u // nsplit, u % nsplit) for w in range(R.MMA_WARPS) for k in range(mt)
                 if (u := w + R.MMA_WARPS * k) < nmt * nsplit]
        assert sorted(units) == [(m, h) for m in range(nmt) for h in range(nsplit)]
        assert nsplit == 1 or mt == 1  # a warp with a split N holds one unit


def test_mma_regions_flagship_values():
    # 8×16: 24 / 20 / 15 / 12 / 8 m16 tiles for x1..x5, at most 3 a warp
    assert [r[3] for r in R.mma_regions(8, 16)] == [30, 24, 20, 15, 12, 8]
    assert [r[5] for r in R.mma_regions(8, 16)][1:] == [3, 3, 2, 2, 1]
    # 8×8: x5's 4 m16 tiles split N over 8 warps
    assert R.mma_regions(8, 8)[5] == (8, 8, 64, 4, 2, 1)


@pytest.mark.parametrize("tile", R.MMA_TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_mma_shared_memory_fits_at_flagship_widths(tile):
    """nf=64, gc=32 in bf16: planes of odd 16-byte rows (144 B for 64
    channels, 80 B for 32) plus the 3-slot ring fit a block's 227 KB."""
    got = R.mma_smem_bytes(64, 32, *tile)
    planes = sum(r[2] * (144 if j == 0 else 80) for j, r in enumerate(R.mma_regions(*tile)[:5]))
    assert got == planes + 3 * 64 * 144 <= R.MAX_SMEM
    assert got == {(8, 16): 184000, (8, 8): 129984, (4, 8): 102976}[tile]
    # the odd widths pad channels to 16 (48-byte rows for gc = 8)
    assert R.mma_smem_bytes(16, 8, *tile) < got


def test_mma_kernel_tile_fits_beside_the_fma_count():
    """The FMA kernel's count (``smem_bytes``) is unchanged and fp32 still
    runs it; the tensor-core count is a separate function."""
    assert R.smem_bytes(torch.float32, 64, 32, R.KERNEL_TILE) == 172032
    assert R.mma_smem_bytes(64, 32, *R.MMA_TILE) <= R.MAX_SMEM
    assert R.mma_smem_bytes(64, 32, 16, 16) > R.MAX_SMEM  # why 16×16 is not a tile


# ---------------------------------------------------------------------------
# rdb_fused: a torch mirror of the target-major decomposition
# ---------------------------------------------------------------------------


def _params(rs, nf, gc, conv1x1, draw):
    p = {f"conv{k}": {"w": draw(rs, (3, 3, nf + (k - 1) * gc, nf if k == 5 else gc)),
                      "b": draw(rs, (nf if k == 5 else gc,))} for k in range(1, 6)}
    if conv1x1:
        p["conv1x1"] = {"w": draw(rs, (1, 1, nf, gc))}
    return {k: {n: torch.from_numpy(v) for n, v in d.items()} for k, d in p.items()}


def _normal(rs, shape):
    fan = np.prod(shape[:-1]) if len(shape) > 1 else 10.0
    return (rs.randn(*shape) * np.sqrt(2.0 / fan)).astype(np.float32)


def _ints(rs, shape):
    """Sparse small integers: every product and sum of the chain stays exact
    in fp32 (checked by ``_partials_exact``)."""
    v = rs.randint(-1, 2, size=shape) * (rs.rand(*shape) < 0.25)
    return v.astype(np.float32)


def mirror(x, ws, bias, *, nf, gc, conv1x1, slope, res_scale, th, tw):
    """The tensor-core kernel's arithmetic in torch: per th × tw block and
    target j, one GEMM per source i < j over tap-shifted row gathers of source
    i's flattened [pixel][channel] plane (tap (kh, kw) of region pixel
    (u, v) is source pixel (u + j−i−1 + kh, v + j−i−1 + kw)), each source's
    fp32 partial rounded to the dtype and summed in source order; then the
    bias, lrelu, the rounded 1×1 (x2) or x2 (x4), the zero ring, one rounding;
    x5 · res_scale + x."""
    dt = x.dtype
    rnd = lambda t: t.to(dt).float()
    B, H, W, _ = x.shape
    regions = R.mma_regions(th, tw)
    b = bias.float().flatten()
    xp = F.pad(x.float(), (0, 0, 5, 5 + tw, 5, 5 + th))
    out = torch.empty_like(x)
    for bi in range(B):
        for ty0 in range(0, H, th):
            for tx0 in range(0, W, tw):
                planes = [xp[bi, ty0:ty0 + th + 10, tx0:tx0 + tw + 10].reshape(-1, nf)]
                for j in range(1, 6):
                    rh, rw = regions[j][:2]
                    u = torch.arange(rh).repeat_interleave(rw)
                    v = torch.arange(rw).repeat(rh)
                    n = nf if j == 5 else gc
                    lane0 = 0 if j == 5 else nf + (4 - j) * gc
                    tot = torch.zeros(rh * rw, n)
                    for i in range(j):
                        ci, rwi, o = (nf if i == 0 else gc), regions[i][1], j - i - 1
                        part = torch.zeros(rh * rw, n)
                        for kh in range(3):
                            for kw in range(3):
                                rows = (u + o + kh) * rwi + (v + o + kw)
                                wt = ws[i][kw, kh * ci:(kh + 1) * ci, lane0:lane0 + n].float()
                                part = part + planes[i][rows] @ wt
                        tot = tot + rnd(part)
                    tot = tot + b[lane0:lane0 + n]
                    if j == 5:
                        xv = planes[0][(u + 5) * regions[0][1] + v + 5]
                        o5 = (tot * res_scale + xv).to(dt).reshape(rh, rw, nf)
                        hh, ww = min(th, H - ty0), min(tw, W - tx0)
                        out[bi, ty0:ty0 + hh, tx0:tx0 + ww] = o5[:hh, :ww]
                        continue
                    tot = torch.where(tot >= 0, tot, tot * slope)
                    if j == 2 and conv1x1:
                        rows = (u + 2) * regions[0][1] + v + 2
                        w11 = ws[0][1, nf:2 * nf, nf + 4 * gc:nf + 5 * gc].float()
                        tot = tot + rnd(planes[0][rows] @ w11)
                    elif j == 4:
                        tot = tot + planes[2][(u + 2) * regions[2][1] + v + 2]
                    gy, gx = ty0 - (5 - j) + u, tx0 - (5 - j) + v
                    inside = ((gy >= 0) & (gy < H) & (gx >= 0) & (gx < W))[:, None]
                    planes.append(rnd(torch.where(inside, tot, torch.zeros(()))))
    return out


def _partials_exact(x, ws, bias, *, nf, gc, conv1x1, slope):
    """True when every per-source conv of the twin's chain is exact in fp32
    (its fp32 and float64 results agree), so no summation order can change
    a bit: the twin's graph, with each contribution taken both ways."""
    dt = x.dtype
    b = bias.double().flatten()
    off = lambda j: nf + (4 - j) * gc
    xs = [x.double().permute(0, 3, 1, 2)]
    cs = []
    exact = True
    for j in range(1, 6):
        w = ws[j - 1].double()
        k = w.reshape(3, 3, w.shape[1] // 3, w.shape[2]).permute(3, 2, 1, 0)
        c64 = F.conv2d(xs[-1], k, padding=1)
        c32 = F.conv2d(xs[-1].float(), k.float(), padding=1)
        exact = exact and torch.equal(c64, c32.double())
        cs.append(c64.to(dt).double())
        if j == 5:
            break
        t = sum(c[:, off(j):off(j) + gc] for c in cs) + b[off(j):off(j) + gc, None, None]
        t = torch.where(t >= 0, t, t * slope)
        if j == 2 and conv1x1:
            t = t + cs[0][:, nf + 4 * gc:]
        elif j == 4:
            t = t + xs[2]
        xs.append(t.to(dt).double())
    return exact


# (nf, gc, B, H, W, conv1x1, tile): tile seams, image borders, ragged edges
MIRROR_CASES = {
    "16_8_1x1_8x16": (16, 8, 2, 16, 32, True, (8, 16)),
    "16_8_no1x1_8x8": (16, 8, 1, 16, 24, False, (8, 8)),
    "24_16_ragged_8x16": (24, 16, 1, 12, 20, True, (8, 16)),
    # two passes of x1..x4's columns, two K chunks of x's channels a tap
    "72_40_wide_4x8": (72, 40, 1, 8, 16, True, (4, 8)),
}


@pytest.mark.parametrize("name", list(MIRROR_CASES))
def test_mirror_equals_the_twin_fp32(name):
    nf, gc, B, H, W, c11, tile = MIRROR_CASES[name]
    rs = np.random.RandomState(sorted(MIRROR_CASES).index(name))
    ws = R.prepare_rdb_weights(_params(rs, nf, gc, c11, _normal), nf, gc, c11, F32)
    x = torch.from_numpy(rs.randn(B, H, W, nf).astype(np.float32))
    kw = dict(nf=nf, gc=gc, conv1x1=c11, slope=0.2, res_scale=0.2)
    got = mirror(x, ws[:5], ws[5], th=tile[0], tw=tile[1], **kw)
    want = R.rdb_fused_plain(x, *ws, tile=4, **kw)
    assert (got - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("name", list(MIRROR_CASES))
def test_mirror_is_bit_equal_to_the_twin_bf16_where_the_convs_are_exact(name):
    """bf16 activations and weights on sparse small integers, dyadic slope
    and scale: every per-source conv is exact, so any K order gives the same
    partials and the mirror's rounding points give the twin's bits."""
    nf, gc, B, H, W, c11, tile = MIRROR_CASES[name]
    rs = np.random.RandomState(20 + sorted(MIRROR_CASES).index(name))
    ws = R.prepare_rdb_weights(_params(rs, nf, gc, c11, _ints), nf, gc, c11, BF)
    x = torch.from_numpy(rs.randint(-3, 4, size=(B, H, W, nf)).astype(np.float32)).to(BF)
    kw = dict(nf=nf, gc=gc, conv1x1=c11, slope=0.25, res_scale=0.5)
    assert _partials_exact(x, ws[:5], ws[5], nf=nf, gc=gc, conv1x1=c11, slope=0.25)
    got = mirror(x, ws[:5], ws[5], th=tile[0], tw=tile[1], **kw)
    want = R.rdb_fused_plain(x, *ws, tile=4, **kw)
    assert got.dtype == BF and torch.equal(got, want)
    assert got.float().abs().max() > 0 and (got != x).any()  # the RDB did change x


@pytest.mark.parametrize("name", list(MIRROR_CASES))
def test_fp64_reference_is_the_twin_where_the_convs_are_exact(name):
    """``rdb_fused_fp64`` takes the twin's rounding points: on sparse small
    integers (every per-source conv exact) it gives the twin's bits, and on
    normal inputs it stays within one bf16 rounding of the twin."""
    nf, gc, B, H, W, c11, tile = MIRROR_CASES[name]
    rs = np.random.RandomState(40 + sorted(MIRROR_CASES).index(name))
    ws = R.prepare_rdb_weights(_params(rs, nf, gc, c11, _ints), nf, gc, c11, BF)
    x = torch.from_numpy(rs.randint(-3, 4, size=(B, H, W, nf)).astype(np.float32)).to(BF)
    kw = dict(nf=nf, gc=gc, conv1x1=c11, slope=0.25, res_scale=0.5)
    assert _partials_exact(x, ws[:5], ws[5], nf=nf, gc=gc, conv1x1=c11, slope=0.25)
    got = R.rdb_fused_fp64(x, *ws, **kw)
    assert got.dtype == BF and got.shape == x.shape and torch.equal(got, R.rdb_fused_plain(
        x, *ws, tile=4, **kw))
    ws = R.prepare_rdb_weights(_params(rs, nf, gc, c11, _normal), nf, gc, c11, F32)
    x = torch.from_numpy(rs.randn(B, H, W, nf).astype(np.float32))
    kw.update(slope=0.2, res_scale=0.2)
    got, want = R.rdb_fused_fp64(x, *ws, **kw), R.rdb_fused_plain(x, *ws, tile=4, **kw)
    assert (got - want).abs().max().item() <= 1e-6 * max(1.0, want.abs().max().item())


def test_mirror_is_tile_independent_bf16():
    """Every tensor-core tile gives the same bits: no per-pixel sum depends
    on the tile (what kernels-workbench holds on the card)."""
    nf, gc = 16, 8
    rs = np.random.RandomState(30)
    ws = R.prepare_rdb_weights(_params(rs, nf, gc, True, _normal), nf, gc, True, BF)
    x = torch.from_numpy(rs.randn(1, 16, 32, nf).astype(np.float32)).to(BF)
    kw = dict(nf=nf, gc=gc, conv1x1=True, slope=0.2, res_scale=0.2)
    a, *others = (mirror(x, ws[:5], ws[5], th=t[0], tw=t[1], **kw) for t in R.MMA_TILES)
    assert len(others) == 2 and all(torch.equal(a, b) for b in others)


def test_rdb_cpu_tensors_take_the_twin_and_count_nothing():
    R.reset_launch_counts()
    nf, gc = 8, 8
    rs = np.random.RandomState(31)
    ws = R.prepare_rdb_weights(_params(rs, nf, gc, True, _normal), nf, gc, True, BF)
    x = torch.from_numpy(rs.randn(1, 8, 8, nf).astype(np.float32)).to(BF)
    kw = dict(nf=nf, gc=gc, tile=8)
    assert torch.equal(R.rdb_fused(x, *ws, **kw), R.rdb_fused_plain(x, *ws, **kw))
    assert R.rdb_fused.launches == 0 and R.rdb_fused.launches_by_design == {"fma": 0, "mma": 0}


# ---------------------------------------------------------------------------
# the C side
# ---------------------------------------------------------------------------


def _params_of(src, fn):
    m = re.search(rf"\bint {fn}\(([^)]*)\)", src)
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("lib,fn", [("workbench_conv", "esr_wb_conv3x3"),
                                    ("workbench_rdb", "esr_wb_rdb_fused")])
def test_c_entries_take_a_design_code_and_match_the_wrapper(lib, fn):
    """Each entry takes the design code first and refuses any design but
    the one its dtypes name, with one ctypes argument per C parameter."""
    src = CONV_SRC if lib == "workbench_conv" else RDB_SRC
    params = _params_of(src, fn)
    assert len(params) == len(build.SIGNATURES[lib][fn])
    assert params[0] == "design"
    body = src[src.index(f"int {fn}("):]
    body = body[:body.index("\n}\n")]
    assert re.search(r"if \(design != \(.* \? kMma : kFma\)\) return \(int\)cudaErrorInvalidValue;",
                     body)
    assert re.search(r"enum Design : int \{ kFma = 0, kMma = 1 \}", src)
    assert DESIGNS == {"fma": 0, "mma": 1}


def test_rdb_tile_constants_are_the_kernels():
    num = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", RDB_SRC).group(1))
    assert num("NW") == R.MMA_WARPS and num("NSLOT") == R.MMA_SLOTS
    assert (num("NF_PASS"), num("GC_PASS"), num("K_SLOT")) == (
        R.MMA_NF_PASS, R.MMA_GC_PASS, R.MMA_K_SLOT)
    launched = re.findall(r"if \(th == (\d+) && tw == (\d+)\) return wm::launch<(\d+), (\d+)>",
                          RDB_SRC)
    assert [(int(a), int(b)) for a, b, c, d in launched] == list(R.MMA_TILES)
    assert all(a == c and b == d for a, b, c, d in launched)
    assert "nsplit(int j) { return j == 5 && nmt(5) < NW ? 2 : 1; }" in RDB_SRC
    # one pass, one K chunk a tap at the flagship widths: 15 sources x 9 taps + the 1x1
    assert len(R.mma_stages(64, 32, True)) == 9 * 15 + 1


def _advance(st, nf, gc, conv1x1):
    """``csrc/workbench_rdb.cu`` ``advance``, line for line."""
    j, p, i, t, kc = st
    nk0, nkg = (-(-(-(-c // 16) * 16) // R.MMA_K_SLOT) for c in (nf, gc))
    kc += 1
    if kc < (nk0 if i in (0, j) else nkg):
        return j, p, i, t, kc
    kc = 0
    if i < j:
        t += 1
        if t < 9:
            return j, p, i, t, kc
        t = 0
        i += 1
        if i < j:
            return j, p, i, t, kc
        if j == 2 and conv1x1:
            return j, p, i, 4, kc
    i = t = 0
    p += 1
    if p < (-(-nf // R.MMA_NF_PASS) if j == 5 else -(-gc // R.MMA_GC_PASS)):
        return j, p, i, t, kc
    return j + 1, 0, i, t, kc


STAGE_WIDTHS = [(64, 32, True), (64, 32, False), (16, 8, True), (128, 64, True),
                (200, 72, True), (72, 40, False)]


@pytest.mark.parametrize("nf,gc,conv1x1", STAGE_WIDTHS)
def test_mma_stage_cursor_walks_the_listed_stages(nf, gc, conv1x1):
    """The kernel's producer cursor, stepped from (1, 0, 0, 0, 0), visits
    ``mma_stages`` in order (the consumer's loops take them so)."""
    want = R.mma_stages(nf, gc, conv1x1)
    st, got = (1, 0, 0, 0, 0), []
    for _ in want:
        got.append(st)
        st = _advance(st, nf, gc, conv1x1)
    assert got == want and st[0] == 6


@pytest.mark.parametrize("nf,gc,conv1x1", STAGE_WIDTHS)
def test_mma_stages_take_each_product_once(nf, gc, conv1x1):
    """The weight ring's stages: per target, every pass of columns, per
    pass every source in order, every tap and every K chunk once; the
    passes cover the target's N and the chunks round16(C_i)."""
    stages = R.mma_stages(nf, gc, conv1x1)
    assert len(set(stages)) == len(stages)
    assert [s[0] for s in stages] == sorted(s[0] for s in stages)  # target-major
    r16 = lambda c: -(-c // 16) * 16
    for j in range(1, 6):
        n, width = (nf, R.MMA_NF_PASS) if j == 5 else (gc, R.MMA_GC_PASS)
        passes = sorted({s[1] for s in stages if s[0] == j})
        assert passes == list(range(-(-n // width))) and n <= len(passes) * width
        for p in passes:
            mine = [s[2:] for s in stages if s[:2] == (j, p)]
            assert [i for i, t, kc in mine] == sorted(i for i, t, kc in mine)  # source order
            for i in range(j + (j == 2 and conv1x1)):
                chunks = {kc for ii, t, kc in mine if ii == i}
                taps = {t for ii, t, kc in mine if ii == i}
                assert taps == ({4} if i == j else set(range(9)))
                assert len(chunks) * R.MMA_K_SLOT >= r16(nf if i in (0, j) else gc)
                assert len(chunks) == -(-r16(nf if i in (0, j) else gc) // R.MMA_K_SLOT)


def test_variants_tool_cuts_the_kernels_accumulation():
    """``tools/wb_rdb_variants.py`` rebuilds the kernel with ``warp_mma_n``
    replaced (plain adds, or the tensor cores' own chaining): on a source
    with its two markers it swaps what lies between them and keeps the rest;
    a source without them raises (the tool then stops before any build)."""
    path = build.CSRC.parents[1] / "tools" / "wb_rdb_variants.py"
    spec = importlib.util.spec_from_file_location("wb_rdb_variants", path)
    V = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(V)
    src = "head\n" + V.BEGIN + "old body\n" + V.END + " tail\n"
    for name, body in V.VARIANTS.items():
        out = V.variant_source(src, body)
        assert out == "head\n" + body + V.END + " tail\n", name
        assert body.startswith(V.BEGIN) and "two_sum(" not in body, name
    with pytest.raises(ValueError):
        V.variant_source("no markers here", V.FRESH)

