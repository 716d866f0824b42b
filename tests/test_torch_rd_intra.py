"""Keyframes at the RD presets (6-7) against svt_av1_tpu on the CPU.

The keyframe wavefront runs over 16x16 units: per unit the four 8x8
sub-blocks (each a full mode decision) and the whole 16x16 block, kept
where its float32 RD cost is no higher (svt_av1_tpu's frame_step16 with
rich=False).  The port's frame_step16 must give the reference step's
every output (modes, levels at both sizes, recon, the size map) at a
frame size of whole units and at one whose unit grid has a partial
last row and column (200x136: the edge units cannot take a 16x16 leaf,
and the above-right strip is cut).  The keyframe of an inter stream at
preset 7 must be byte-identical, with the mirror decoder reproducing
the port's recon; all-intra streams keep the 8x8 wavefront, as the
reference does."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_decodes_to_recon, encode_both  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.pipeline import intra_encoder as JIE  # noqa: E402
from svt_av1_tpu_torch.pipeline import intra_encoder as TIE  # noqa: E402


def frame(w, h, seed):
    """Smooth synthetic content with a noisy band (the band splits into
    8x8 leaves, the rest keeps 16x16 ones)."""
    f = synthetic_frame(w, h, seed=seed)
    rng = np.random.default_rng(seed)
    f.y[:, : w // 3] = rng.integers(0, 256, (h, w // 3))
    return f


def blocks(f, w, h):
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    return (JIE.block_planes(JIE.pad_plane(f.y, ph, pw), 8),
            JIE.block_planes(JIE.pad_plane(f.u, ph // 2, pw // 2), 4),
            JIE.block_planes(JIE.pad_plane(f.v, ph // 2, pw // 2), 4))


@pytest.mark.parametrize("w,h,q", [(192, 128, 100), (200, 136, 40),
                                   (200, 136, 200)],
                         ids=["192x128-q100", "200x136-q40", "200x136-q200"])
def test_frame_step16_equals_reference(w, h, q):
    sy, su, sv = blocks(frame(w, h, seed=q), w, h)
    nbh, nbw = sy.shape[:2]
    want = JIE.build_frame_encoder_dyn(nbh, nbw, 8, rich=False, part16=True)(
        jnp.asarray(sy), jnp.asarray(su), jnp.asarray(sv), jnp.int32(q))
    got = TIE.frame_step16(torch.from_numpy(sy), torch.from_numpy(su),
                           torch.from_numpy(sv), q)
    assert len(got) == len(want) == 14
    for i, (a, b) in enumerate(zip(want, got)):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype and b.shape == a.shape, i
        assert np.array_equal(a, b.numpy()), i
    sizes = got[10].numpy()
    assert (sizes == 16).any() and (sizes == 8).any()
    if nbh % 2 or nbw % 2:    # a partial unit never takes a 16x16 leaf
        assert (sizes[-1] == 8).all() if nbh % 2 else True
        assert (sizes[:, -1] == 8).all() if nbw % 2 else True


@pytest.mark.parametrize("w,h", [(192, 128), (200, 136)],
                         ids=["192x128", "200x136"])
def test_inter_stream_keyframe_preset7_byte_identical(w, h):
    """The keyframe of an IPPP stream takes the 16x16 search."""
    kw = dict(width=w, height=h, qp=40, enc_mode=7, intra_period=-1,
              pred_structure=0, scene_change_detection=False,
              recon_output=True)
    tus = encode_both(kw, [frame(w, h, seed=70)])
    assert tus[0].is_keyframe and tus[0].leaf16_cells
    assert_decodes_to_recon(tus)


def test_all_intra_preset7_keeps_8x8_wavefront_byte_identical():
    """All-intra streams keep the 8x8 wavefront at every preset, as the
    reference's batched all-intra path does."""
    kw = dict(width=192, height=128, qp=40, enc_mode=7, recon_output=True)
    tus = encode_both(kw, [frame(192, 128, seed=80 + i) for i in range(2)])
    assert all(p.is_keyframe and p.leaf16_cells is None for p in tus)
    assert_decodes_to_recon(tus)
