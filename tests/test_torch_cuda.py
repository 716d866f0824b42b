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
