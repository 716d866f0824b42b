"""The port's CLI with --nch (lockstep channels, MultiStreamEncoder) and
--gop-shards (lockstep GOPs, GopShardedEncoder) against
svt_av1_tpu.app.enc_app on the same raw YUV files at 192x128: every
IVF file byte-identical, and the reference decoder reads each."""

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import run_both_clis, write_yuv  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu.app import enc_app as japp  # noqa: E402
from svt_av1_tpu.decoder import Decoder  # noqa: E402
from svt_av1_tpu.io import IvfReader  # noqa: E402
from svt_av1_tpu_torch.app import enc_app as tapp  # noqa: E402

W, H, N = 192, 128, 4


def _decodes(data: bytes, n: int) -> None:
    import io
    dec = Decoder()
    frames = [dec.decode_temporal_unit(f) for _, f in
              IvfReader(io.BytesIO(data)).frames()]
    assert len(frames) == n and all(f is not None for f in frames)


def test_cli_nch_ivf_files_byte_identical(tmp_path):
    ins = []
    for ch in range(2):
        write_yuv(tmp_path / f"in{ch}.yuv", W, H, N, seed=20 + 10 * ch)
        ins.append(str(tmp_path / f"in{ch}.yuv"))
    out = {}
    for name, app, extra in (("jax", japp, []),
                             ("port", tapp, ["--device", "cpu"])):
        outs = [str(tmp_path / f"{name}{ch}.ivf") for ch in range(2)]
        argv = ["-i", ",".join(ins), "-b", ",".join(outs), "-w", str(W),
                "-h", str(H), "-q", "40", "--intra-period", "2", "--nch",
                "2", *extra]
        assert app.main(argv) == 0, name
        out[name] = [open(o, "rb").read() for o in outs]
    assert out["port"] == out["jax"]
    assert out["port"][0] != out["port"][1]
    for data in out["port"]:
        _decodes(data, N)


def test_cli_gop_shards_files_byte_identical(tmp_path):
    write_yuv(tmp_path / "in.yuv", W, H, 2 * N)
    got = run_both_clis(tmp_path, ["-w", str(W), "-h", str(H), "-q", "40",
                                   "--intra-period", str(N - 1),
                                   "--pred-struct", "0", "--gop-shards",
                                   "2", "--stat-report"])
    _decodes(got["ivf"], 2 * N)
