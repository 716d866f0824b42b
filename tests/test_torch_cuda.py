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
