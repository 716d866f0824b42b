"""Port parity of loop restoration (svt_av1_tpu_torch/ops/restoration.py,
a host numpy stage, and its syntax) against svt_av1_tpu on the CPU: the
Wiener block filter, the stripe rule and the RU grid, both searches and
both applies at 8 and 10 bits, the Wiener and self-guided syntax, and
whole encodes with restoration on IPPP (single tile and a 2x2 tile
grid) and hier-B, whose TUs must be byte-identical to the reference's
and decode, in the reference's mirror decoder, to the port's recon.
Mirrors tests/test_restoration.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.entropy import syntax as JS  # noqa: E402
from svt_av1_tpu.entropy.range_coder import RangeDecoder  # noqa: E402
from svt_av1_tpu.entropy.range_coder import \
    RangeEncoder as JRangeEncoder  # noqa: E402
from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.ops import restoration as JR  # noqa: E402
from svt_av1_tpu_torch.entropy import syntax as TS  # noqa: E402
from svt_av1_tpu_torch.entropy.range_coder import RangeEncoder  # noqa: E402
from svt_av1_tpu_torch.ops import restoration as TR  # noqa: E402

from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402


def _noisy(h, w, bd, seed, sigma):
    """A smooth picture plus Gaussian noise (restoration engages), as
    (source, degraded, deblocked) int32 planes."""
    rng = np.random.default_rng(seed)
    top = (1 << bd) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    src = ((0.47 + 0.23 * np.sin(xx / 9.0) * np.cos(yy / 7.0)) * top
           ).astype(np.int32)
    deg = np.clip(src + rng.normal(0, sigma, src.shape), 0, top).astype(
        np.int32)
    deb = np.clip(deg + rng.integers(-2, 3, deg.shape), 0, top).astype(
        np.int32)
    return src, deg, deb


@pytest.mark.parametrize("bd", [8, 10])
def test_wiener_block_equals_reference(bd):
    rng = np.random.default_rng(bd)
    ext = rng.integers(0, 1 << bd, (30, 38)).astype(np.int32)
    for th, tv in (((2, -5, 11), (1, -3, 9)), ((-5, -23, -17), (10, 8, 46))):
        assert np.array_equal(TR.wiener_block(ext, th, tv, bd),
                              JR.wiener_block(ext, th, tv, bd))


def test_stripes_and_ru_grid_equal_reference():
    for h in (40, 136, 160, 2160):
        for ss in (0, 1):
            assert TR._stripe_spans(h >> ss, ss) == \
                JR._stripe_spans(h >> ss, ss)
    for size in (68, 100, 200, 1080, 3840):
        for unit in (32, 64):
            assert TR.ru_grid(size, unit) == JR.ru_grid(size, unit)
    cdef = np.arange(200 * 8).reshape(200, 8).astype(np.int32) % 251
    deb = cdef + 1000
    for y0, y1 in ((0, 56), (56, 120), (120, 200)):
        assert np.array_equal(TR._extend_stripe(cdef, deb, y0, y1),
                              JR._extend_stripe(cdef, deb, y0, y1))


@pytest.mark.parametrize("bd,ss", [(8, 0), (10, 0), (10, 1)])
def test_wiener_search_and_apply_equal_reference(bd, ss):
    """A plane whose height and width are not multiples of the RU size
    (the last RU stretches, stripes are partial)."""
    src, deg, deb = _noisy(100 >> ss, 136 >> ss, bd, 1, 6 << (bd - 8))
    unit = 64 >> ss
    use_t, taps_t = TR.search_wiener_plane(src, deg, deb, unit, ss, bd=bd)
    use_j, taps_j = JR.search_wiener_plane(src, deg, deb, unit, ss, bd=bd)
    assert np.array_equal(use_t, use_j) and np.array_equal(taps_t, taps_j)
    assert use_t.any()
    got = TR.apply_wiener_plane(deg, deb, unit, ss, use_t, taps_t, bd)
    want = JR.apply_wiener_plane(deg, deb, unit, ss, use_j, taps_j, bd)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bd,eps", [(8, (4, 11)), (10, (4, 11)),
                                    (10, (0, 4, 7, 9, 11, 13, 14, 15))])
def test_sgr_search_and_apply_equal_reference(bd, eps):
    """The preset-6 ep pair and the full set."""
    src, deg, deb = _noisy(100, 136, bd, 2, 4 << (bd - 8))
    got = TR.search_sgr_plane(src, deg, deb, 64, 0, eps=eps, bd=bd)
    want = JR.search_sgr_plane(src, deg, deb, 64, 0, eps=eps, bd=bd)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    use, ep, xqd, _ = got
    assert use.any()
    assert np.array_equal(TR.apply_sgr_plane(deg, deb, 64, 0, use, ep, xqd,
                                             bd),
                          JR.apply_sgr_plane(deg, deb, 64, 0, use, ep, xqd,
                                             bd))


def test_sgr_syntax_round_trip():
    """The port writes the reference's bytes for every ep class (both
    radii, r0 only, r1 only), and the reference reads them back."""
    cases = [(4, (-20, 60)), (11, (0, 40)), (15, (-90, 31)), (0, (31, 95)),
             (10, (-96, 12)), (14, (5, -32))]
    enc, jenc = RangeEncoder(), JRangeEncoder()
    ref = list(TS.SGR_XQD_MID)
    coded = []
    for ep, xqd in cases:
        coded.append(TS.code_sgr_filter(enc, None, ref, ep, xqd))
        assert JS.code_sgr_filter(jenc, None, ref, ep, xqd) == coded[-1]
        ref = list(coded[-1][1])
    data = enc.done()
    assert data == jenc.done()
    dec = RangeDecoder(data)
    ref = list(JS.SGR_XQD_MID)
    for ep, out in coded:
        got = JS.code_sgr_filter(None, dec, ref)
        assert got == (ep, tuple(out))
        ref = list(got[1])


def test_wiener_syntax_round_trip():
    """Six taps per unit (vertical, then horizontal) against the running
    reference: the port's bytes are the reference's, and read back."""
    rng = np.random.default_rng(3)
    taps = [tuple(int(rng.integers(lo, hi + 1)) for lo, hi in
                  zip(TS.WIENER_MIN * 2, TS.WIENER_MAX * 2))
            for _ in range(12)]
    enc, jenc = RangeEncoder(), JRangeEncoder()
    ref = list(TS.WIENER_MID) * 2
    for t in taps:
        assert TS.code_wiener_filter(enc, None, ref, t) == t
        JS.code_wiener_filter(jenc, None, ref, t)
        ref = list(t)
    data = enc.done()
    assert data == jenc.done()
    dec = RangeDecoder(data)
    ref = list(JS.WIENER_MID) * 2
    for t in taps:
        got = JS.code_wiener_filter(None, dec, ref)
        assert tuple(got) == t
        ref = list(got)


def _noisy_clip(w, h, n, bd=8, seed=0):
    """A drifting noisy picture: restoration engages on every frame."""
    rng = np.random.default_rng(seed)
    top = (1 << bd) - 1
    base = synthetic_frame(w, h, seed=seed, kind="noise", bit_depth=bd)
    dt = base.y.dtype
    out = []
    for i in range(n):
        f = synthetic_frame(w, h, seed=seed, kind="noise", bit_depth=bd)
        f.y[:] = np.clip(np.roll(base.y, (i, 2 * i), (0, 1)).astype(np.int32)
                         + rng.normal(0, 6 << (bd - 8), f.y.shape), 0,
                         top).astype(dt)
        f.u[:] = np.roll(base.u, (0, i), (0, 1))
        f.v[:] = np.roll(base.v, (0, i), (0, 1))
        out.append(f)
    return out


def _restored_units(tus):
    """Restoration units switched on over the stream, read back by the
    reference's mirror decoder."""
    from svt_av1_tpu.decoder import Decoder

    dec, n = Decoder(), 0
    for p in tus:
        dec.decode_temporal_unit(p.payload)
        if p.recon is not None and dec.lr is not None:
            n += sum(int(pl["use"].sum()) for pl in dec.lr if pl is not None)
    return n


# 192x160: three luma stripes, a partial last RU row; CDEF on
IPPP_LR = dict(width=192, height=160, qp=50, intra_period=-1,
               pred_structure=0, enable_restoration=True,
               scene_change_detection=False, recon_output=False)


@pytest.mark.parametrize("tiles", [0, 1], ids=["one_tile", "tiles_2x2"])
def test_restoration_ippp_equals_reference(tiles):
    """Restored frames are the references of the next ones; with a 2x2
    tile grid the per-RU syntax is coded by the tile holding the RU's
    start with frame-absolute RU mapping.  Both runs share one step
    geometry (one reference compile)."""
    kw = dict(IPPP_LR, tile_columns_log2=tiles, tile_rows_log2=tiles)
    tus = encode_both(kw, _noisy_clip(192, 160, 3))
    assert all(p.recon is not None for p in tus)   # restored planes
    assert [p.display_idx for p in tus] == [0, 1, 2]
    assert_decodes_to_recon(tus)
    assert _restored_units(tus) > 0


def test_restoration_hierb_equals_reference():
    """A hier-B mini-GOP with compound prediction: every coded frame is
    restored before it becomes a reference; the clip, not one frame, is
    compared (a wrong restored copy drifts from the next frame on)."""
    kw = dict(width=128, height=96, qp=45, intra_period=-1,
              pred_structure=2, hierarchical_levels=2, compound_mode=1,
              enable_restoration=True, scene_change_detection=False,
              recon_output=False)
    tus = encode_both(kw, _noisy_clip(128, 96, 5, seed=3))
    assert len(tus) == 2 * 5 - 1
    assert_decodes_to_recon(tus)
    assert _restored_units(tus) > 0


def test_restoration_all_intra_10bit_equals_reference():
    """All-intra streams restore at packet time (no reference chain);
    10-bit: the highbd Wiener rounding and SGR at bd=10."""
    kw = dict(width=192, height=128, qp=30, bit_depth=10,
              enable_restoration=True, recon_output=False)
    tus = encode_both(kw, _noisy_clip(192, 128, 2, bd=10, seed=4))
    assert tus[0].recon.y.dtype == np.uint16
    assert all(p.display_idx is None for p in tus)
    assert_decodes_to_recon(tus)
    assert _restored_units(tus) > 0
