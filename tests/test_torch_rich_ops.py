"""Ops of presets 0-5 against svt_av1_tpu on the CPU.

The inter tx-type search codes IDTX beside DCT at the 8/16/32 luma and
4/8/16 chroma sizes; rectangular leaves code TX_16X8, TX_8X16, TX_32X16,
TX_16X32 (luma) and TX_8X4, TX_4X8, TX_16X8, TX_8X16 (chroma); the rich
intra chroma pick codes V / H / SMOOTH with their derived ADST types at
4x4 and 8x8.  The port's float32 forward (summed in XLA:CPU's order),
its exact integer forward and its inverse must equal the reference's bit
for bit on each.  The rich intra steps (61 luma candidates with angle
deltas, the DC / V / H / SMOOTH / CFL chroma pick) must give every
output of the reference's, for the 8x8 wavefront and the 16x16-unit
search.  And the two deblocking level pickers the encoders use (the
port's host rule, the reference's traced one in its lockstep step) must
agree at every qindex."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.io.yuv import synthetic_frame  # noqa: E402
from svt_av1_tpu.ops import deblock as JDB  # noqa: E402
from svt_av1_tpu.ops import transforms as JT  # noqa: E402
from svt_av1_tpu.pipeline import intra_encoder as JIE  # noqa: E402
from svt_av1_tpu_torch.ops import deblock as TDB  # noqa: E402
from svt_av1_tpu_torch.ops import transforms as TT  # noqa: E402
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402
from svt_av1_tpu_torch.pipeline import intra_encoder as TIE  # noqa: E402

# (tx size, tx type) of the inter path at presets <= 5
INTER_TX = ([(tx, JT.DCT_DCT) for tx in sorted(
    set(TPE.RECT_TX.values()) | set(TPE.RECT_TX_C.values()))]
    + [(tx, JT.IDTX) for tx in (JT.TX_4X4, JT.TX_8X8, JT.TX_16X16,
                                JT.TX_32X32)])
# the rich intra chroma's derived types at 4x4 and 8x8
INTRA_TX = [(tx, ty) for tx in (JT.TX_4X4, JT.TX_8X8)
            for ty in sorted(set(TIE.UV_TX.values()))]


def _name(tx, ty):
    return f"{JT.TX_H[tx]}x{JT.TX_W[tx]}-type{ty}"


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("tx,ty", INTER_TX,
                         ids=[_name(*c) for c in INTER_TX])
def test_inter_forward_and_inverse_bit_exact(tx, ty, bd):
    rng = np.random.default_rng(tx * 16 + ty + bd)
    hi = (1 << bd) - 1
    for n in (1, 7, 300):
        r = rng.integers(-hi, hi + 1, (n, JT.TX_H[tx], JT.TX_W[tx]))
        r[: n // 3] //= 16                  # small residuals too
        r = r.astype(np.int32)
        want = np.asarray(JT.fwd_txfm2d_batch(jnp.asarray(r), tx, ty, bd))
        got = TT.fwd_txfm2d_batch(torch.from_numpy(r), tx, ty, bd).numpy()
        assert np.array_equal(want, got), n
        c = (want // rng.integers(1, 9, want.shape)).astype(np.int32)
        want = np.asarray(JT.inv_txfm2d_batch(jnp.asarray(c), tx, ty, bd))
        got = TT.inv_txfm2d_batch(torch.from_numpy(c), tx, ty, bd).numpy()
        assert np.array_equal(want, got), n


@pytest.mark.parametrize("tx,ty", INTRA_TX,
                         ids=[_name(*c) for c in INTRA_TX])
def test_intra_chroma_exact_forward_bit_exact(tx, ty):
    rng = np.random.default_rng(ty)
    r = rng.integers(-255, 256, (257, JT.TX_H[tx], JT.TX_W[tx])).astype(
        np.int32)
    want = np.asarray(JT.fwd_txfm2d_batch_exact(jnp.asarray(r), tx, ty))
    got = TT.fwd_txfm2d_batch_exact(torch.from_numpy(r), tx, ty).numpy()
    assert np.array_equal(want, got)
    want = np.asarray(JT.inv_txfm2d_batch(jnp.asarray(want), tx, ty))
    got = TT.inv_txfm2d_batch(torch.from_numpy(got), tx, ty).numpy()
    assert np.array_equal(want, got)


def _diag_frame(w, h):
    """tests/test_intra_rich.py's diagonal content, with chroma that
    follows luma (so angle deltas, V / H / SMOOTH chroma and CFL win)."""
    f = synthetic_frame(w, h, seed=8)
    yy, xx = np.mgrid[0:h, 0:w]
    f.y[:] = ((xx * 13 + yy * 29) // 7 % 220).astype(np.uint8)
    f.u[:] = (f.y[::2, ::2] // 2 + 60).astype(np.uint8)
    f.v[:] = ((np.mgrid[0:h // 2, 0:w // 2][1] * 5) % 200).astype(np.uint8)
    return f


def _blocks(f, w, h):
    return (JIE.block_planes(JIE.pad_plane(f.y, h, w), 8),
            JIE.block_planes(JIE.pad_plane(f.u, h // 2, w // 2), 4),
            JIE.block_planes(JIE.pad_plane(f.v, h // 2, w // 2), 4))


RICH = [(64, 64, 60, False), (128, 64, 120, False), (64, 64, 60, True),
        (128, 64, 120, True)]


@pytest.fixture(scope="module")
def rich_runs():
    """The reference's rich steps, run once per case: {case: outputs}."""
    out = {}
    for w, h, q, part16 in RICH:
        sy, su, sv = _blocks(_diag_frame(w, h), w, h)
        fn = JIE.build_frame_encoder_dyn(h // 8, w // 8, 8, rich=True,
                                         part16=part16)
        res = fn(jnp.asarray(sy), jnp.asarray(su), jnp.asarray(sv),
                 jnp.int32(q))
        out[(w, h, q, part16)] = ((sy, su, sv),
                                  [np.asarray(a) for a in res])
    return out


@pytest.mark.parametrize("case", RICH, ids=[
    f"{w}x{h}-q{q}-{'16x16' if p else '8x8'}" for w, h, q, p in RICH])
def test_rich_intra_step_equals_reference(rich_runs, case):
    (sy, su, sv), want = rich_runs[case]
    w, h, q, part16 = case
    fn = TIE.frame_step16 if part16 else TIE.frame_step
    got = fn(torch.from_numpy(sy), torch.from_numpy(su),
             torch.from_numpy(sv), q, rich=True)
    assert len(got) == len(want) == (14 if part16 else 10)
    for i, (a, b) in enumerate(zip(want, got)):
        assert b.numpy().dtype == a.dtype and b.shape == a.shape, i
        assert np.array_equal(a, b.numpy()), i
    # the rich tools are used: angle deltas, chroma off DC, and CFL
    assert (got[7].numpy() != 0).any()
    assert set(np.unique(got[8].numpy())) > {0}
    assert (got[8].numpy() == TIE.UV_CFL_ID).any()


def test_rich_intra_batched_step_equals_single_frames(rich_runs):
    """The 8x8 rich wavefront with a frame axis (all-intra batches)
    codes each frame as alone."""
    (sy, su, sv), _ = rich_runs[(64, 64, 60, False)]
    (sy2, su2, sv2), _ = rich_runs[(64, 64, 60, True)]
    t = lambda *a: torch.from_numpy(np.stack(a))
    got = TIE.frame_step(t(sy, sy2[:, ::-1].copy()), t(su, su2),
                         t(sv, sv2), 60, rich=True)
    one = TIE.frame_step(torch.from_numpy(sy2[:, ::-1].copy()),
                         torch.from_numpy(su2), torch.from_numpy(sv2), 60,
                         rich=True)
    for a, b in zip(got, one):
        assert torch.equal(a[1], b)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("is_key", [True, False], ids=["key", "inter"])
def test_deblock_level_pickers_agree_at_every_qindex(is_key, bd):
    """The port picks loop-filter levels with the host rule everywhere;
    the reference's lockstep step uses its traced twin.  They must give
    the same levels at every qindex."""
    q = jnp.arange(256, dtype=jnp.int32)
    traced = [np.asarray(a) for a in
              JDB.pick_filter_levels_traced(jnp, q, is_key, bd)]
    for qi in range(256):
        host = TDB.pick_filter_levels(qi, is_key, bd)
        assert host == tuple(int(a[qi]) for a in traced), qi
        assert host == JDB.pick_filter_levels(qi, is_key, bd), qi
