"""Compound prediction and mini-GOP planning of the port against
svt_av1_tpu, exact:

- ``ops.mc.jnt_average`` and the compound constants;
- ``_interp_patch`` with ``jnt=True`` (CONV_BUF-domain output) and with
  ``both=True`` (regular + CONV_BUF from one convolution) at luma 8x8
  and chroma 4x4 cells, over all 16x16 phase pairs and the 3 filters,
  and ``_mc_patch(jnt=True)`` through a gather;
- ``pipeline.gop``: plan_minigop / plan_pins / layer_qindex for spans
  1-16."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.ops import mc as JMC  # noqa: E402
from svt_av1_tpu.pipeline import gop as JGOP  # noqa: E402
from svt_av1_tpu.pipeline import inter_encoder as JPE  # noqa: E402
from svt_av1_tpu_torch.ops import mc as TMC  # noqa: E402
from svt_av1_tpu_torch.pipeline import gop as TGOP  # noqa: E402
from svt_av1_tpu_torch.pipeline import inter_encoder as TPE  # noqa: E402


def _eq(a, b):
    a = np.asarray(a)
    b = b.numpy()
    return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                 b.astype(np.int64))


def test_compound_constants_and_average():
    assert TMC.JNT_ROUND1 == JMC.JNT_ROUND1
    assert TMC.JNT_ROUND_BITS == JMC.JNT_ROUND_BITS
    assert TMC.jnt_round_offset(8) == JMC.jnt_round_offset(8) == \
        JMC.JNT_ROUND_OFFSET
    assert TPE.COMP_EXTRA_BITS == JPE.COMP_EXTRA_BITS
    rng = np.random.default_rng(7)
    # CONV_BUF values span the 8-bit compound range, edges included
    lo, hi = -2048, 32767
    r0 = rng.integers(lo, hi + 1, (64, 64)).astype(np.int32)
    r1 = rng.integers(lo, hi + 1, (64, 64)).astype(np.int32)
    r0[0, :4] = (lo, hi, lo, hi)
    r1[0, :4] = (lo, hi, hi, lo)
    want = JMC.jnt_average(jnp, jnp.asarray(r0), jnp.asarray(r1), 8)
    got = TMC.jnt_average(torch.from_numpy(r0), torch.from_numpy(r1), 8)
    assert _eq(want, got)


def _phase_case(bs: int, seed: int):
    """One block per (row phase, column phase) pair: [256, bs+7, bs+7]
    uint8 patches with saturating pixels, and the [16, 16] phase maps."""
    rng = np.random.default_rng(seed)
    patch = rng.integers(0, 256, (256, bs + 7, bs + 7)).astype(np.int32)
    patch[::5] = np.where(patch[::5] > 127, 255, 0)   # clip the filters
    ph_r, ph_c = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    return (patch, np.ascontiguousarray(ph_r, np.int32),
            np.ascontiguousarray(ph_c, np.int32))


@pytest.mark.parametrize("bs", [8, 4], ids=["luma8", "chroma4"])
@pytest.mark.parametrize("filt", [0, 1, 2])
def test_interp_patch_jnt_and_both_bitexact(bs, filt):
    patch, ph_r, ph_c = _phase_case(bs, 10 * bs + filt)
    jargs = (jnp.asarray(patch), jnp.asarray(ph_r), jnp.asarray(ph_c), bs, 8)
    targs = (torch.from_numpy(patch), torch.from_numpy(ph_r),
             torch.from_numpy(ph_c), bs, 8)
    want_jnt = JPE._interp_patch(*jargs, True, filt)
    got_jnt = TPE._interp_patch(*targs, filt, jnt=True)
    assert _eq(want_jnt, got_jnt)
    want_reg, want_buf = JPE._interp_patch(*jargs, False, filt, both=True)
    got_reg, got_buf = TPE._interp_patch(*targs, filt, both=True)
    assert _eq(want_reg, got_reg)
    assert _eq(want_buf, got_buf)
    assert _eq(want_jnt, got_buf)
    # the regular half equals the single-output call
    assert torch.equal(got_reg, TPE._interp_patch(*targs, filt))


@pytest.mark.parametrize("chroma", [False, True])
def test_mc_patch_jnt_bitexact(chroma):
    rng = np.random.default_rng(20 + int(chroma))
    bs, pad = (4, 9) if chroma else (8, 17)
    plane = rng.integers(0, 256, (4 * bs, 6 * bs)).astype(np.uint8)
    pp = np.asarray(JMC.pad_for_filter(np, plane, pad))
    lim = pad * (16 if chroma else 8)
    mv8 = rng.integers(-lim // 2, lim // 2 + 1, (4, 6, 2)).astype(np.int32)
    want = JPE._mc_patch(jnp.asarray(pp), jnp.asarray(mv8), bs, pad, chroma,
                         8, jnt=True, filt=1)
    got = TPE._mc_patch(torch.from_numpy(pp), torch.from_numpy(mv8), bs, pad,
                        chroma, 8, jnt=True, filt=1)
    assert _eq(want, got)


def _steps(plan):
    return [(type(s).__name__, *vars(s).values()) for s in plan]


@pytest.mark.parametrize("span", range(1, 17))
def test_gop_plan_matches_reference(span):
    lo = 3
    hi = lo + span
    want = JGOP.plan_minigop(lo, hi)
    got = TGOP.plan_minigop(lo, hi)
    assert _steps(got) == _steps(want)
    assert TGOP.plan_pins(got, lo) == JGOP.plan_pins(want, lo)
    coded = [s for s in got if isinstance(s, TGOP.CodeStep)]
    assert sorted(s.disp for s in coded) == list(range(lo + 1, hi + 1))
    shows = [s.disp for s in got if isinstance(s, TGOP.ShowStep)]
    assert shows == list(range(lo + 1, hi + 1))


def test_layer_qindex_matches_reference():
    assert TGOP.LAYER_Q_OFFSET == JGOP.LAYER_Q_OFFSET
    for base in (1, 4, 60, 160, 250, 255):
        for layer in range(7):
            assert TGOP.layer_qindex(base, layer) == \
                JGOP.layer_qindex(base, layer)
