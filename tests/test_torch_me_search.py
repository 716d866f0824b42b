"""The exhaustive full-pel searches and the block gather of
svt_av1_tpu/ops/me.py (fullpel_search, fullpel_search_multisize,
gather_blocks): no encoder path calls them, and the port keeps them as
plain PyTorch functions with the reference's results (raster-order ties,
the MV-rate bias) on seeded inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from svt_av1_tpu.ops import me as JME  # noqa: E402
from svt_av1_tpu_torch.ops import me as TME  # noqa: E402

H, W, R = 64, 96, 5


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 255, (H, W)).astype(np.int32)
    # a shifted, noisy copy, and a flat band where offsets tie
    ref = np.roll(src, (2, -3), (0, 1)) + rng.integers(-5, 6, (H, W))
    ref[:, :16] = 100
    src[:, :16] = 100
    return src, np.pad(ref, R, mode="edge").astype(np.int32), rng


def as_t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("biased", [False, True])
def test_fullpel_search_equals_reference(planes, block, biased):
    src, ref, rng = planes
    lam = 37 if biased else None
    prior = (rng.integers(-3, 4, (H // block, W // block, 2)).astype(np.int32)
             if biased else None)
    want = JME.fullpel_search(jnp.asarray(src), jnp.asarray(ref), block, R,
                              lam, None if prior is None
                              else jnp.asarray(prior))
    got = TME.fullpel_search(as_t(src), as_t(ref), block, R, lam,
                             as_t(prior))
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("biased", [False, True])
def test_fullpel_search_multisize_equals_reference(planes, biased):
    src, ref, rng = planes
    lam = 50 if biased else None
    pri = ({bs: rng.integers(-3, 4, (H // bs, W // bs, 2)).astype(np.int32)
            for bs in (8, 16, 32)} if biased else None)
    want = JME.fullpel_search_multisize(
        jnp.asarray(src), jnp.asarray(ref), R, lam,
        None if pri is None else {k: jnp.asarray(v) for k, v in pri.items()})
    got = TME.fullpel_search_multisize(
        as_t(src), as_t(ref), R, lam,
        None if pri is None else {k: as_t(v) for k, v in pri.items()})
    for bs in (8, 16, 32):
        for i in (0, 1):
            assert np.array_equal(np.asarray(want[bs][i]), got[bs][i].numpy())


def test_gather_blocks_equals_reference(planes):
    _, ref, rng = planes
    for block in (4, 8, 16):
        mv = rng.integers(-R, R + 1, (H // block, W // block, 2)).astype(
            np.int32)
        want = JME.gather_blocks(jnp.asarray(ref), jnp.asarray(mv), block, R)
        got = TME.gather_blocks(as_t(ref), as_t(mv), block, R)
        assert np.array_equal(np.asarray(want), got.numpy())
