"""Card-only tests of the port (marker ``cuda``; they skip without a
CUDA device).  They need neither JAX nor the reference package, so they
run on the GPU machine as they are:

    python3 -m pytest -m cuda --noconftest tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX, which that
machine does not have.)  The CUDA tile gather must equal its plain
PyTorch version exactly, and the encoder must write the same bytes on
the card as on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from svt_av1_tpu_torch.ops import gather as TG  # noqa: E402

T_ = torch.from_numpy

# (plane dtype, bs, pad, reach, halo, off) of the grid call sites
GRID_SITES = [
    (np.int32, 8, 17, 16, 0, 0),      # GLOBALMV copy gather
    (np.int32, 8, 17, 16, 8, -4),     # merged-cell refine
    (np.int32, 8, 17, 17, 7, -3),     # MC patch, luma
    (np.int32, 4, 9, 9, 7, -3),       # MC patch, chroma
    (np.int32, 32, 17, 16, 8, -4),    # dense subpel refine (RD presets)
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bs,pad,reach,halo,off", GRID_SITES)
def test_kernel_equals_plain_at_call_sites(cuda, dtype, bs, pad, reach,
                                           halo, off):
    rng = np.random.default_rng(bs + halo)
    plane = rng.integers(0, 256, (5 * bs + 2 * pad + 7,
                                  7 * bs + 2 * pad + 7)).astype(dtype)
    mv_r = rng.integers(-reach, reach + 1, (5, 7)).astype(np.int32)
    mv_c = rng.integers(-reach, reach + 1, (5, 7)).astype(np.int32)
    before = TG.gather_tiles.launches
    got = TG.gather_blocks_grid(T_(plane).to(cuda), T_(mv_r).to(cuda),
                                T_(mv_c).to(cuda), bs, pad, reach,
                                halo=halo, off=off)
    torch.cuda.synchronize()
    assert TG.gather_tiles.launches == before + 1
    want = TG.gather_blocks_grid(T_(plane), T_(mv_r), T_(mv_c), bs, pad,
                                 reach, halo=halo, off=off)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_kernel_dtypes_and_off_contract_starts(cuda, dtype):
    plane = (torch.arange(40 * 50, dtype=torch.int32).reshape(40, 50)
             % 251).to(dtype)
    br = torch.tensor([-5, 0, 35, 100, 7], dtype=torch.int32)
    bc = torch.tensor([-9, 45, 3, -1, 60], dtype=torch.int32)
    got = TG.gather_tiles_cuda(plane.to(cuda), br.to(cuda), bc.to(cuda), 8,
                               8)
    assert got.dtype == dtype
    assert torch.equal(got.cpu(), TG.gather_tiles_ref(plane, br, bc, 8, 8))


# (dtype, Hp, Wp, th, tw, nbh, nbw), as chip_smoke.AWKWARD: odd and
# word-sized tile widths, rows that are and are not 4- and 16-byte
# aligned, tile counts that are not a multiple of a CTA's four
AWKWARD = [
    (torch.uint8, 45, 100, 32, 32, 3, 21),
    (torch.uint8, 45, 96, 12, 16, 2, 37),
    (torch.uint8, 37, 53, 11, 11, 3, 21),
    (torch.int16, 40, 66, 15, 15, 2, 37),
    (torch.int16, 40, 66, 16, 16, 3, 21),
    (torch.int32, 49, 177, 15, 15, 3, 21),
    (torch.int32, 49, 177, 11, 11, 2, 37),
    (torch.int32, 29, 89, 8, 8, 1, 16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hp,wp,th,tw,nbh,nbw", AWKWARD)
def test_designs_equal_plain_at_awkward_shapes(cuda, dtype, hp, wp, th, tw,
                                               nbh, nbw):
    """Every design, on starts at every edge, negative, past the end and
    random."""
    rng = np.random.default_rng(hp * wp + th)
    plane = T_(rng.integers(0, 250, (hp, wp)).astype(np.int32)).to(dtype)
    n = nbh * nbw
    br = rng.integers(-hp - 2, hp + 3, n).astype(np.int32)
    bc = rng.integers(-wp - 2, wp + 3, n).astype(np.int32)
    k = min(n, 8)
    br[:k] = [0, hp - th, -1, -hp, hp + 5, -th, hp - th + 1, 3][:k]
    bc[:k] = [0, wp - tw, -wp, -1, wp + 7, wp - tw + 1, -tw, 5][:k]
    br, bc = T_(br), T_(bc)
    want = TG.gather_tiles_ref(plane, br, bc, th, tw)
    p, r, c = plane.to(cuda), br.to(cuda), bc.to(cuda)
    outs = [TG.gather_tiles(p, r, c, nbh=nbh, nbw=nbw, stride=0, band_off=0,
                            band_h=hp, th=th, tw=tw),
            TG.gather_tiles_cuda(p, r, c, th, tw)]
    outs += [TG.gather_tiles_design(d, p, r, c, th, tw) for d in TG.DESIGNS]
    for got in outs:
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_stream_and_device_getters_equal_public_api(cuda):
    """The wrapper's device and stream getters answer as
    torch.cuda.current_device() and current_stream().cuda_stream do, and
    a gather issued on a side stream runs there and is right."""
    dev = torch.cuda.current_device()
    assert TG._current_device() == dev
    assert TG._raw_stream(dev) == torch.cuda.current_stream(dev).cuda_stream
    plane = (torch.arange(30 * 40, dtype=torch.int32).reshape(30, 40)
             % 97).to(torch.int16)
    br = torch.tensor([0, 7, 22, -3], dtype=torch.int32)
    bc = torch.tensor([5, 31, -8, 12], dtype=torch.int32)
    p, r, c = plane.to(cuda), br.to(cuda), bc.to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert TG._raw_stream(dev) == side.cuda_stream
        assert TG._raw_stream(dev) != torch.cuda.default_stream(
            dev).cuda_stream
        got = TG.gather_tiles_cuda(p, r, c, 8, 9)
    side.synchronize()
    assert torch.equal(got.cpu(), TG.gather_tiles_ref(plane, br, bc, 8, 9))


@pytest.mark.cuda
def test_kernel_rejects_unsupported_dtype(cuda):
    plane = torch.zeros((16, 16), dtype=torch.float32, device=cuda)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        TG.gather_tiles_cuda(plane, idx, idx, 4, 4)


@pytest.mark.cuda
def test_encoder_card_equals_cpu(cuda):
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    cfg = EncoderConfig(width=136, height=72, qp=36, intra_period=-1,
                        pred_structure=0, scene_change_detection=False,
                        recon_output=True)
    frames = [synthetic_frame(136, 72, seed=i) for i in range(3)]
    before = TG.gather_tiles.launches
    card = list(Encoder(cfg, device=cuda).encode_all(frames))
    assert TG.gather_tiles.launches - before == 12     # 6 per P frame
    cpu = list(Encoder(cfg, device="cpu").encode_all(frames))
    assert [p.payload for p in card] == [p.payload for p in cpu]
    for a, b in zip(card, cpu):
        assert np.array_equal(a.recon.y, b.recon.y)


def _hierb_refs(device, w=192, h=128):
    """Source and two reference pictures of a drifting synthetic clip,
    64-padded (the B step's inputs)."""
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.intra_encoder import pad_plane
    base = synthetic_frame(w, h, seed=3)
    ph, pw = -(-h // 64) * 64, -(-w // 64) * 64
    out = []
    for i in (0, 2, 4):                 # fwd ref, source, bwd ref
        planes = (np.roll(base.y, (i, 2 * i), (0, 1)),
                  np.roll(base.u, (i // 2, i), (0, 1)),
                  np.roll(base.v, (i // 2, -i), (0, 1)))
        out.append(tuple(
            T_(np.ascontiguousarray(pad_plane(p, ph >> (k > 0),
                                              pw >> (k > 0)))).to(device)
            for k, p in enumerate(planes)))
    return ph, pw, out


@pytest.mark.cuda
def test_b_step_card_equals_cpu(cuda):
    """The two-reference compound step at 192x128: 13 gather launches,
    every output equal to the CPU run's."""
    from svt_av1_tpu_torch.pipeline import inter_encoder as TPE
    ph, pw, (r0, src, r1) = _hierb_refs(cuda)
    step = TPE.build_b_frame_encoder_dyn(ph, pw, 32, 48, cdef=True,
                                         compound=True)
    before = TG.gather_tiles.launches
    card = step(*src, *r0, *r1, 166, 8, 4, 4)
    torch.cuda.synchronize()
    assert TG.gather_tiles.launches - before == 13
    cpu = step(*(p.cpu() for p in src), *(p.cpu() for p in r0),
               *(p.cpu() for p in r1), 166, 8, 4, 4)
    assert len(card) == len(cpu) == 11
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


# (plane dtype, bs, pad, reach, halo, off) of the B frame's grid sites at
# the 1080p geometry (1088x1920 padded: 136x240 cells)
B1080_SITES = [
    (np.int32, 8, 17, 16, 8, -4),     # merged-cell refine, per reference
    (np.int32, 8, 17, 17, 7, -3),     # MC patch, luma (x3)
    (np.int32, 4, 9, 9, 7, -3),       # MC patch, chroma (x6)
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bs,pad,reach,halo,off", B1080_SITES)
def test_kernel_equals_plain_at_1080p_b_sites(cuda, dtype, bs, pad, reach,
                                              halo, off):
    rng = np.random.default_rng(100 + bs + halo)
    nbh, nbw = 136, 240
    plane = rng.integers(0, 256, (nbh * bs + 2 * pad + 7,
                                  nbw * bs + 2 * pad + 7)).astype(dtype)
    mv_r = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    mv_c = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    got = TG.gather_blocks_grid(T_(plane).to(cuda), T_(mv_r).to(cuda),
                                T_(mv_c).to(cuda), bs, pad, reach,
                                halo=halo, off=off)
    want = TG.gather_blocks_grid(T_(plane), T_(mv_r), T_(mv_c), bs, pad,
                                 reach, halo=halo, off=off)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_warp_by_centers_equals_plain_at_1080p_mirrored_centers(cuda):
    """The ME warp of both references at 1080p: ref0's HME centers and
    the backward reference's mirrored, clipped ones."""
    from svt_av1_tpu_torch.ops import mc as TMC
    from svt_av1_tpu_torch.ops import me as TME
    rng = np.random.default_rng(5)
    ref = T_(rng.integers(0, 256, (1088, 1920)).astype(np.uint8))
    cen = T_(rng.integers(-13, 14, (34, 60, 2)).astype(np.int32))
    ref_pad = TMC.edge_pad(ref, 16, 16, 16, 16)
    for c in (cen, torch.clamp(-cen, -13, 13)):
        got = TME.warp_by_centers(ref_pad.to(cuda), c.to(cuda), 32, 16)
        assert torch.equal(got.cpu(), TME.warp_by_centers(ref_pad, c, 32, 16))


@pytest.mark.cuda
def test_hierb_encoder_card_equals_cpu(cuda):
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    cfg = EncoderConfig(width=136, height=72, qp=36, intra_period=-1,
                        pred_structure=2, hierarchical_levels=2,
                        scene_change_detection=False, recon_output=True)
    frames = [synthetic_frame(136, 72, seed=i) for i in range(6)]
    before = TG.gather_tiles.launches
    card = list(Encoder(cfg, device=cuda).encode_all(frames))
    # two base P frames (4 and 5) at 5 launches, three B frames at 13
    assert TG.gather_tiles.launches - before == 2 * 5 + 3 * 13
    cpu = list(Encoder(cfg, device="cpu").encode_all(frames))
    assert len(card) == 11
    assert [p.payload for p in card] == [p.payload for p in cpu]
    for a, b in zip(card, cpu):
        assert (a.recon is None) == (b.recon is None)
        if a.recon is not None:
            assert np.array_equal(a.recon.y, b.recon.y)


@pytest.mark.cuda
def test_ldb_encoder_card_equals_cpu(cuda):
    """Low-delay B at 192x128: 10 gather launches per LAST + GOLDEN frame
    (the two-reference step without compound prediction), and the card
    writes the CPU's TUs and recon."""
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    cfg = EncoderConfig(width=192, height=128, qp=40, intra_period=-1,
                        pred_structure=1, recon_output=True)
    frames = [synthetic_frame(192, 128, seed=60 + i) for i in range(4)]
    before = TG.gather_tiles.launches
    card = list(Encoder(cfg, device=cuda).encode_all(frames))
    assert TG.gather_tiles.launches - before == 3 * 10
    cpu = list(Encoder(cfg, device="cpu").encode_all(frames))
    assert [p.is_keyframe for p in card] == [True, False, False, False]
    assert [p.payload for p in card] == [p.payload for p in cpu]
    for a, b in zip(card, cpu):
        for p in ("y", "u", "v"):
            assert np.array_equal(getattr(a.recon, p), getattr(b.recon, p))


@pytest.mark.cuda
def test_cli_card_equals_cpu(cuda, tmp_path):
    """The port's CLI at --device cuda and --device cpu on the same
    synthetic input (low-delay B, 2 tile columns, a QP file) writes
    byte-identical IVF and recon files."""
    from svt_av1_tpu_torch.app import enc_app
    (tmp_path / "qp.txt").write_text("30\n-1\n45\n20\n")
    out = {}
    for device in ("cuda", "cpu"):
        ivf, rec = tmp_path / f"{device}.ivf", tmp_path / f"{device}.yuv"
        assert enc_app.main(["-w", "192", "-h", "128", "-q", "40",
                             "--synthetic", "4", "--intra-period", "-1",
                             "--pred-struct", "1", "--tiles-log2", "1",
                             "--qp-file", str(tmp_path / "qp.txt"),
                             "-b", str(ivf), "-o", str(rec),
                             "--device", device]) == 0
        out[device] = (ivf.read_bytes(), rec.read_bytes())
    assert out["cuda"] == out["cpu"]


@pytest.mark.cuda
def test_rd_b_step_card_equals_cpu(cuda):
    """The preset-6 step from three references with compound prediction
    at 192x128: 80 gather launches, every output equal to the CPU
    run's (the float32 RD merge included)."""
    from _torch_rd import step_planes
    from svt_av1_tpu_torch.pipeline import inter_encoder as TPE
    src, refs = step_planes(3)
    planes = [T_(np.ascontiguousarray(p)) for p in (*src, *refs)]
    step = TPE.build_b_frame_encoder_dyn(128, 192, 32, 48, cdef=True,
                                         compound=True, rdo=True, nrefs=3)
    for q, lf in ((60, (6, 3, 3)), (200, (30, 12, 12))):
        before = TG.gather_tiles.launches
        card = step(*(p.to(cuda) for p in planes), q, *lf)
        torch.cuda.synchronize()
        assert TG.gather_tiles.launches - before == 80
        cpu = step(*planes, q, *lf)
        assert len(card) == len(cpu) == 11
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_rd_keyframe_wavefront_card_equals_cpu(cuda):
    """frame_step16 (the RD presets' 16x16 keyframe search) at 200x136
    on the card equals its CPU run, size map and 16x16 levels
    included."""
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline import intra_encoder as TIE
    f = synthetic_frame(200, 136, seed=9)
    f.y[:, :64] = np.random.default_rng(9).integers(0, 256, (136, 64))
    src = (TIE.block_planes(f.y, 8), TIE.block_planes(f.u, 4),
           TIE.block_planes(f.v, 4))
    for q in (40, 160):
        card = TIE.frame_step16(*(T_(np.ascontiguousarray(p)).to(cuda)
                                  for p in src), q)
        cpu = TIE.frame_step16(*(T_(np.ascontiguousarray(p)) for p in src),
                               q)
        assert (cpu[10] == 16).any() and (cpu[10] == 8).any()
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_p5_b_step_card_equals_cpu(cuda):
    """The preset-5 step (tx-type search, rect leaves) from three
    references with compound prediction at 192x128: 128 gather launches
    (the preset-6 step's 80 and the rect leaves' 48), every output equal
    to the CPU run's."""
    from _torch_rd import step_planes
    from svt_av1_tpu_torch.pipeline import inter_encoder as TPE
    src, refs = step_planes(3)
    planes = [T_(np.ascontiguousarray(p)) for p in (*src, *refs)]
    step = TPE.build_b_frame_encoder_dyn(128, 192, 32, 48, cdef=True,
                                         compound=True, rdo=True, nrefs=3,
                                         txs=True, rect=True)
    for q, lf in ((60, (6, 3, 3)), (200, (30, 12, 12))):
        before = TG.gather_tiles.launches
        card = step(*(p.to(cuda) for p in planes), q, *lf)
        torch.cuda.synchronize()
        assert TG.gather_tiles.launches - before == 128
        cpu = step(*planes, q, *lf)
        assert len(card) == len(cpu) == 13
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_rich_keyframe_wavefronts_card_equal_cpu(cuda):
    """The rich intra set (presets <= 5) on the card equals its CPU run:
    the 8x8 wavefront on a batch of two frames and the 16x16-unit
    search at 200x136 (the 61-way luma and 5-way chroma argmins break
    ties at the first index on both)."""
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline import intra_encoder as TIE
    f = synthetic_frame(200, 136, seed=11)
    yy, xx = np.mgrid[0:136, 0:200]
    f.y[:, :96] = ((xx * 13 + yy * 29) // 7 % 220)[:, :96]
    src = (TIE.block_planes(f.y, 8), TIE.block_planes(f.u, 4),
           TIE.block_planes(f.v, 4))
    stack = [np.stack([p, p[::-1].copy()]) for p in src]
    for fn, inp in ((TIE.frame_step16, src), (TIE.frame_step, stack)):
        card = fn(*(T_(np.ascontiguousarray(p)).to(cuda) for p in inp), 80,
                  rich=True)
        cpu = fn(*(T_(np.ascontiguousarray(p)) for p in inp), 80, rich=True)
        assert (cpu[7] != 0).any()
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


# (plane dtype, bs, pad, reach, halo, off) of the preset-6 step's grid
# sites at the 1080p geometry: the dense refine per size, the 64x64 MC
# patch (me64, compound candidate, per-size MC) and the per-size MC's
# largest chroma patch
RD1080_SITES = [
    (np.int32, 8, 17, 16, 8, -4),
    (np.int32, 16, 17, 16, 8, -4),
    (np.int32, 32, 17, 16, 8, -4),
    (np.int32, 64, 17, 17, 7, -3),
    (np.int32, 32, 9, 9, 7, -3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bs,pad,reach,halo,off", RD1080_SITES)
def test_kernel_equals_plain_at_1080p_rd_sites(cuda, dtype, bs, pad, reach,
                                               halo, off):
    rng = np.random.default_rng(200 + bs + halo)
    ph, pw = (1088, 1920) if pad == 17 else (544, 960)
    nbh, nbw = ph // bs, pw // bs
    plane = rng.integers(0, 256, (ph + 2 * pad + 7,
                                  pw + 2 * pad + 7)).astype(dtype)
    mv_r = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    mv_c = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    got = TG.gather_blocks_grid(T_(plane).to(cuda), T_(mv_r).to(cuda),
                                T_(mv_c).to(cuda), bs, pad, reach,
                                halo=halo, off=off)
    want = TG.gather_blocks_grid(T_(plane), T_(mv_r), T_(mv_c), bs, pad,
                                 reach, halo=halo, off=off)
    assert torch.equal(got.cpu(), want)


# (bs, pad, reach, halo, off) of the 4K 10-bit preset-6 step's grid
# sites, on int16 planes (the port's 10-bit container): the dense refine
# per size, the 64x64 MC patch (71x71) and the largest chroma patch
VOD4K_SITES = [
    (8, 17, 16, 8, -4),
    (16, 17, 16, 8, -4),
    (32, 17, 16, 8, -4),
    (64, 17, 17, 7, -3),
    (32, 9, 9, 7, -3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bs,pad,reach,halo,off", VOD4K_SITES)
def test_kernel_equals_plain_at_4k_10bit_sites(cuda, bs, pad, reach, halo,
                                               off):
    rng = np.random.default_rng(400 + bs + halo)
    ph, pw = (2176, 3840) if pad == 17 else (1088, 1920)
    nbh, nbw = ph // bs, pw // bs
    plane = rng.integers(0, 1024, (ph + 2 * pad + 7,
                                   pw + 2 * pad + 7)).astype(np.int16)
    mv_r = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    mv_c = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    got = TG.gather_blocks_grid(T_(plane).to(cuda), T_(mv_r).to(cuda),
                                T_(mv_c).to(cuda), bs, pad, reach,
                                halo=halo, off=off)
    want = TG.gather_blocks_grid(T_(plane), T_(mv_r), T_(mv_c), bs, pad,
                                 reach, halo=halo, off=off)
    assert got.dtype == torch.int16
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_warp_by_centers_equals_plain_at_4k_10bit(cuda):
    """The ME warp gathers the 10-bit reference in its int16 container."""
    from svt_av1_tpu_torch.ops import me as TME
    rng = np.random.default_rng(41)
    ref_pad = T_(rng.integers(0, 1024, (2176 + 32, 3840 + 32)).astype(
        np.int16))
    cen = T_(rng.integers(-13, 14, (68, 120, 2)).astype(np.int32))
    got = TME.warp_by_centers(ref_pad.to(cuda), cen.to(cuda), 32, 16)
    assert torch.equal(got.cpu(), TME.warp_by_centers(ref_pad, cen, 32, 16))


@pytest.mark.cuda
def test_rd_b_step_10bit_lr_aq_card_equals_cpu(cuda):
    """The preset-6 three-reference step at 10 bits with the restoration
    outputs and a per-SB qindex map at 192x128: 80 gather launches,
    every output (the deblocked planes included) equal to the CPU
    run's."""
    from _torch_rd import step_planes
    from svt_av1_tpu_torch.pipeline import inter_encoder as TPE
    src, refs = step_planes(3)
    rng = np.random.default_rng(9)
    ten = lambda p: np.clip(p.astype(np.int32) * 4 + rng.integers(
        0, 4, p.shape), 0, 1023).astype(np.int16)
    planes = [T_(np.ascontiguousarray(ten(p))) for p in (*src, *refs)]
    qmap = T_(np.array([[120, 200, 160], [90, 160, 230]], np.int32))
    step = TPE.build_b_frame_encoder_dyn(128, 192, 32, 48, cdef=True,
                                         compound=True, bd=10, rdo=True,
                                         nrefs=3, lr=True, aq=True)
    before = TG.gather_tiles.launches
    card = step(*(p.to(cuda) for p in planes), 160, 30, 12, 12,
                qmap.to(cuda))
    torch.cuda.synchronize()
    assert TG.gather_tiles.launches - before == 80
    cpu = step(*planes, 160, 30, 12, 12, qmap)
    assert len(card) == len(cpu) == 14
    assert card[5].dtype == torch.int16
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_vod_encoder_card_equals_cpu(cuda):
    """bench.py's 4K 10-bit VOD config at 200x136, nine frames of its
    clip: the card writes the CPU's bytes and recon."""
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.io.yuv import vod_clip
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    kw = dict(width=200, height=136, qp=40, bit_depth=10, intra_period=-1,
              pred_structure=2, hierarchical_levels=3, compound_mode=1,
              enc_mode=6, enable_restoration=True,
              enable_adaptive_quantization=True, recon_output=False,
              scene_change_detection=False)
    frames = vod_clip(200, 136, 9)
    out = {d: list(Encoder(EncoderConfig(**kw), device=d).encode_all(frames))
           for d in ("cuda", "cpu")}
    assert len(out["cuda"]) == len(out["cpu"]) == 17
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.payload == b.payload
        if a.recon is not None:
            for p in ("y", "u", "v"):
                assert np.array_equal(getattr(a.recon, p),
                                      getattr(b.recon, p))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("dtype,bs,pad,reach,halo,off", GRID_SITES[1:4],
                         ids=["cell_refine", "mc_luma", "mc_chroma"])
def test_batched_kernel_equals_plain(cuda, S, dtype, bs, pad, reach, halo,
                                     off):
    """A stack of S planes at a 1080p P step's grid sites gathers in ONE
    launch and equals the plain version plane by plane."""
    rng = np.random.default_rng(S * 100 + bs + halo)
    nbh, nbw = 136, 240        # 8x8 cells (4x4 chroma) of a 1080p frame
    shape = (S, nbh * bs + 2 * pad + 7, nbw * bs + 2 * pad + 7)
    plane = rng.integers(0, 256, shape).astype(dtype)
    mv_r = rng.integers(-reach, reach + 1, (S, nbh, nbw)).astype(np.int32)
    mv_c = rng.integers(-reach, reach + 1, (S, nbh, nbw)).astype(np.int32)
    before = TG.gather_tiles.launches
    got = TG.gather_blocks_grid(T_(plane).to(cuda), T_(mv_r).to(cuda),
                                T_(mv_c).to(cuda), bs, pad, reach,
                                halo=halo, off=off)
    torch.cuda.synchronize()
    assert TG.gather_tiles.launches == before + 1
    assert got.shape == (S, nbh * nbw, bs + halo, bs + halo)
    for s in range(S):
        want = TG.gather_blocks_grid(T_(plane[s]), T_(mv_r[s]), T_(mv_c[s]),
                                     bs, pad, reach, halo=halo, off=off)
        assert torch.equal(got[s].cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 4])
def test_batched_warp_by_centers_equals_plain(cuda, S):
    """The ME warp of S u8 1080p references in one launch."""
    from svt_av1_tpu_torch.ops import me as TM
    rng = np.random.default_rng(7 + S)
    ref_pad = rng.integers(0, 256, (S, 1088 + 32, 1920 + 32)).astype(
        np.uint8)
    cen = rng.integers(-13, 14, (S, 34, 60, 2)).astype(np.int32)
    before = TG.gather_tiles.launches
    got = TM.warp_by_centers(T_(ref_pad).to(cuda), T_(cen).to(cuda), 32, 16)
    torch.cuda.synchronize()
    assert TG.gather_tiles.launches == before + 1
    for s in range(S):
        assert torch.equal(got[s].cpu(), TM.warp_by_centers(
            T_(ref_pad[s]), T_(cen[s]), 32, 16))


@pytest.mark.cuda
def test_kernel_refuses_a_plane_at_the_32_bit_limit(cuda):
    """A plane of 2^31 bytes raises before and inside the extension;
    a stack whose planes together pass 2^31 bytes, each below it,
    gathers exactly (64-bit plane offsets, no wrap)."""
    side = 46341                       # side * side > 2^31 - 1
    big = torch.zeros((1, side, side), dtype=torch.uint8, device=cuda)
    r = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="32 bits"):
        TG.gather_tiles_cuda(big, r, r, 8, 8)
    out = torch.empty((1, 4, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        TG._kernel()(0, big.data_ptr(), 1, side, side, 1, r.data_ptr(),
                     r.data_ptr(), out.data_ptr(), 4, 8, 8,
                     TG._raw_stream(big.get_device()))
    del big
    hp = wp = 33000                    # 2 planes: 2.18e9 bytes in all
    stack = torch.empty((2, hp, wp), dtype=torch.uint8, device=cuda)
    stack[1, -64:, -64:] = torch.arange(64 * 64, device=cuda).reshape(
        64, 64).to(torch.uint8)
    br = torch.tensor([[0, hp - 16], [hp - 64, hp - 8]], dtype=torch.int32,
                      device=cuda)
    bc = torch.tensor([[0, wp - 16], [wp - 64, wp - 8]], dtype=torch.int32,
                      device=cuda)
    got = TG.gather_tiles_cuda(stack, br, bc, 8, 8)
    want = torch.stack([torch.stack([stack[s, r:r + 8, c:c + 8]
                                     for r, c in zip(br[s].tolist(),
                                                     bc[s].tolist())])
                        for s in range(2)])
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_multistream_card_equals_cpu_with_one_launch_per_site(cuda):
    """Three lockstep 192x128 streams: the card writes the CPU's bytes,
    and a P slot launches the gather as often as one stream's P frame at
    the same settings (5: no global-motion copy), not three times."""
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.io.yuv import synthetic_frame
    from svt_av1_tpu_torch.pipeline.encoder import Encoder
    from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder
    kw = dict(width=192, height=128, qp=40, intra_period=-1,
              pred_structure=0, scene_change_detection=False,
              recon_output=True)
    slots = [[synthetic_frame(192, 128, seed=10 * s + i) for s in range(3)]
             for i in range(3)]
    out, counts = {}, []
    for d in ("cuda", "cpu"):
        ms = MultiStreamEncoder(EncoderConfig(**kw), 3, device=d)
        res = []
        for fr in slots:
            before = TG.gather_tiles.launches
            res.append(ms.send(fr))
            if d == "cuda":
                torch.cuda.synchronize()
                counts.append(TG.gather_tiles.launches - before)
        out[d] = res
    assert counts == [0, 5, 5]
    one = Encoder(EncoderConfig(**kw).replace(enable_global_motion=False,
                                              interp_filter=0),
                  device=cuda)
    one.send_picture(slots[0][0])
    one.get_packet()
    before = TG.gather_tiles.launches
    one.send_picture(slots[1][0])
    one.get_packet()
    torch.cuda.synchronize()
    assert TG.gather_tiles.launches - before == 5
    for a, b in zip(out["cuda"], out["cpu"]):
        assert [p.payload for p in a] == [p.payload for p in b]
