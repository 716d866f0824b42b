"""Tiled inter frames (tile_columns_log2 = tile_rows_log2 = 1: a 2x2
grid at 320x192) on IPPP, against svt_av1_tpu on the CPU: the TUs must
equal the reference encoder's byte for byte, with equal recon.
Keyframes stay single-tile in both (the intra wavefront predicts across
tile edges).  The port's Python tile writer must give the C++ coder's
bytes for every tile.  Hierarchical B and low-delay B with tiles are in
test_torch_surface_tiles_hierb.py and _ldb.py (one compile variant of
the reference's steps per file)."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import TILED, check_tiled, tiled_frames  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu_torch import EncoderConfig  # noqa: E402
from svt_av1_tpu_torch.entropy import obu as O  # noqa: E402
from svt_av1_tpu_torch.pipeline.encoder import Encoder  # noqa: E402


def test_tile_grid_is_two_by_two():
    cfg = EncoderConfig(**TILED)
    seq = O.SequenceParams(cfg.width, cfg.height, 8, 64)
    rows, cols = O.tile_starts(seq, 1, 1)
    assert (len(rows), len(cols)) == (2, 2)
    assert cfg.mi_rows == rows[-1][1] and cfg.mi_cols == cols[-1][1]


def test_tiled_ippp_byte_identical():
    check_tiled(dict(pred_structure=0), 3)


def test_python_tile_writer_gives_the_cpp_bytes():
    kw = {**TILED, "pred_structure": 1}
    got = {b: [p.payload for p in Encoder(
        EncoderConfig(**kw, entropy_backend=b), device="cpu").encode_all(
            tiled_frames(2))] for b in ("cpp", "python")}
    assert got["python"] == got["cpp"]
