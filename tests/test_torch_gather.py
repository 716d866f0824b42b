"""Port parity of the tile gather (svt_av1_tpu_torch/ops/gather.py).

On the CPU the port's gather_tiles runs its plain version and must
equal the reference package's off-TPU path (vmapped dynamic_slice) at
every call-site geometry, including off-contract starts (both map them alike).
The CUDA kernel itself runs only on the card: tests/test_torch_cuda.py
holds it against this plain version there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.ops import gather as JG  # noqa: E402
from svt_av1_tpu_torch.ops import gather as TG  # noqa: E402

T_ = torch.from_numpy

# (name, plane dtype, bs, pad, reach, halo, off) of the grid call sites
# (inter_encoder + me at preset 8 and the RD presets' dense refine)
GRID_SITES = [
    ("globalmv_copy", np.int32, 8, 17, 16, 0, 0),
    ("cell_refine", np.int32, 8, 17, 16, 8, -4),
    ("mc_patch_luma", np.int32, 8, 17, 17, 7, -3),
    ("mc_patch_chroma", np.int32, 4, 9, 9, 7, -3),
    ("subpel_refine_dense_16", np.int32, 16, 17, 16, 8, -4),
    ("subpel_refine_dense_32", np.int32, 32, 17, 16, 8, -4),
]


def _grid_case(dtype, bs, pad, reach, seed):
    rng = np.random.default_rng(seed)
    nbh, nbw = 4, 6
    plane = rng.integers(0, 256, (nbh * bs + 2 * pad + 7,
                                  nbw * bs + 2 * pad + 7)).astype(dtype)
    mv_r = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    mv_c = rng.integers(-reach, reach + 1, (nbh, nbw)).astype(np.int32)
    return plane, mv_r, mv_c


@pytest.mark.parametrize("name,dtype,bs,pad,reach,halo,off", GRID_SITES)
def test_gather_blocks_grid_matches_reference(name, dtype, bs, pad, reach,
                                              halo, off):
    plane, mv_r, mv_c = _grid_case(dtype, bs, pad, reach, seed=bs + halo)
    want = np.asarray(JG.gather_blocks_grid(
        jnp.asarray(plane), jnp.asarray(mv_r), jnp.asarray(mv_c), bs, pad,
        reach, halo=halo, off=off))
    got = TG.gather_blocks_grid(T_(plane), T_(mv_r), T_(mv_c), bs, pad,
                                reach, halo=halo, off=off)
    assert got.dtype == T_(plane).dtype
    assert np.array_equal(want, got.numpy())


def test_warp_by_centers_site_matches_reference():
    """me.warp_by_centers: u8 32x32 tiles on the search-padded plane."""
    rng = np.random.default_rng(3)
    tile, pad, th, tw = 32, 16, 3, 4
    plane = rng.integers(0, 256, (th * tile + 2 * pad,
                                  tw * tile + 2 * pad)).astype(np.uint8)
    cen = rng.integers(-13, 14, (th, tw, 2)).astype(np.int32)
    br = (np.arange(th)[:, None] * tile + pad + cen[..., 0]).reshape(-1)
    bc = (np.arange(tw)[None, :] * tile + pad + cen[..., 1]).reshape(-1)
    kw = dict(nbh=th, nbw=tw, stride=tile, band_off=0,
              band_h=2 * pad + tile, th=tile, tw=tile)
    want = np.asarray(JG.gather_tiles(jnp.asarray(plane),
                                      jnp.asarray(br.astype(np.int32)),
                                      jnp.asarray(bc.astype(np.int32)), **kw))
    got = TG.gather_tiles(T_(plane), T_(br.astype(np.int32)),
                          T_(bc.astype(np.int32)), **kw)
    assert np.array_equal(want, got.numpy())


def test_off_contract_starts_map_like_dynamic_slice():
    """Off-contract starts: negative ones count from the end (numpy
    style), then every start is clamped so the tile fits — what
    lax.dynamic_slice does on the reference's CPU path."""
    rng = np.random.default_rng(9)
    plane = rng.integers(0, 256, (40, 50)).astype(np.int32)
    br = np.array([-5, 0, 35, 100], np.int32)
    bc = np.array([-9, 45, 3, -1], np.int32)
    kw = dict(nbh=1, nbw=4, stride=8, band_off=0, band_h=40, th=8, tw=8)
    want = np.asarray(JG.gather_tiles(jnp.asarray(plane), jnp.asarray(br),
                                      jnp.asarray(bc), **kw))
    got = TG.gather_tiles(T_(plane), T_(br), T_(bc), **kw).numpy()
    assert np.array_equal(want, got)
    assert np.array_equal(got[0], plane[32:40, 41:49])    # -5 -> 35 -> 32
    assert np.array_equal(got[2], plane[32:40, 3:11])     # clamped high


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16, torch.int32])
def test_ref_dtypes_preserved(dtype):
    plane = torch.arange(20 * 30, dtype=torch.int32).reshape(20, 30) % 100
    plane = plane.to(dtype)
    br = torch.tensor([0, 4], dtype=torch.int32)
    bc = torch.tensor([2, 7], dtype=torch.int32)
    out = TG.gather_tiles(plane, br, bc, nbh=1, nbw=2, stride=4,
                          band_off=0, band_h=20, th=5, tw=6)
    assert out.dtype == dtype and out.shape == (2, 5, 6)
    assert torch.equal(out[1], plane[4:9, 7:13])


@pytest.mark.parametrize("bad", ["dtype", "shape", "band", "count"])
def test_wrapper_rejects_bad_inputs(bad):
    plane = torch.zeros((32, 32), dtype=torch.int32)
    br = torch.zeros(4, dtype=torch.int32)
    bc = torch.zeros(4, dtype=torch.int32)
    kw = dict(nbh=2, nbw=2, stride=8, band_off=0, band_h=16, th=8, tw=8)
    if bad == "dtype":
        plane = plane.to(torch.float32)
    elif bad == "shape":
        plane = plane[None]
    elif bad == "band":
        kw["band_h"] = 40
    else:
        br, bc = br[:3], bc[:3]
    with pytest.raises((TypeError, ValueError)):
        TG.gather_tiles(plane, br, bc, **kw)


def test_cuda_entry_refuses_cpu_tensors():
    """No silent fallback: the kernel entry raises on a CPU tensor."""
    plane = torch.zeros((16, 16), dtype=torch.uint8)
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA tensor"):
        TG.gather_tiles_cuda(plane, idx, idx, 4, 4)



def test_grid_tile_args_build_int32_starts():
    """The CUDA wrapper converts nothing: grid_tile_args hands it
    contiguous int32 starts, whatever integer type the vectors have."""
    plane = torch.zeros((60, 80), dtype=torch.int32)
    mv = torch.ones((3, 4), dtype=torch.int64)
    br, bc, kw = TG.grid_tile_args(plane, mv, mv.expand(3, 4), 8, 17, 16)
    for s in (br, bc):
        assert s.dtype == torch.int32 and s.is_contiguous()
        assert s.shape == (kw["nbh"] * kw["nbw"],)


def test_warp_by_centers_builds_int32_starts(monkeypatch):
    from svt_av1_tpu_torch.ops import me as TM
    seen = []
    real = TG.gather_tiles

    def spy(plane, base_r, base_c, **kw):
        seen.append((base_r.dtype, base_c.dtype, base_r.is_contiguous(),
                     base_c.is_contiguous()))
        return real(plane, base_r, base_c, **kw)

    monkeypatch.setattr(TG, "gather_tiles", spy)
    ref_pad = torch.zeros((2 * 32 + 32, 3 * 32 + 32), dtype=torch.uint8)
    centers = torch.zeros((2, 3, 2), dtype=torch.int32)
    out = TM.warp_by_centers(ref_pad, centers, 32, 16)
    assert out.shape == (64, 96)
    assert seen == [(torch.int32, torch.int32, True, True)]


@pytest.mark.parametrize("bad", ["int64", "strided"])
def test_cuda_wrapper_rejects_starts_it_would_convert(bad):
    """The kernel entry raises on int64 or non-contiguous starts (checked
    before the device, so this runs without a card)."""
    plane = torch.zeros((16, 16), dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    if bad == "int64":
        idx = idx.long()
        err = TypeError
    else:
        idx = torch.zeros(8, dtype=torch.int32)[::2]
        err = ValueError
    with pytest.raises(err):
        TG.gather_tiles_cuda(plane, idx, idx, 4, 4)
    with pytest.raises(err):
        TG.check_cuda_args(plane, idx, idx)
