"""The port's encoder CLI (svt_av1_tpu_torch.app.enc_app) against
svt_av1_tpu.app.enc_app on the same raw YUV file, on IPPP at 192x128:
the IVF, recon and stat files must be byte-identical, with tiles,
look-ahead, a QP file, VBR (--rc 2), preset 5 and a config file.
Settings the port does not run yet, and the reference CLI's own refusals
of --nch / --gop-shards, exit non-zero, naming the gate; ``python -m
svt_av1_tpu_torch.app.enc_app`` runs.  Low-delay B and hierarchical B
through the CLI are in test_torch_app_ldb.py and _hierb.py."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from _torch_parity import run_both_clis, write_yuv  # noqa: E402
from _torch_threads import one_torch_thread  # noqa: E402,F401
pytest.importorskip("jax")

from svt_av1_tpu_torch.app import enc_app as tapp  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
W, H, N = 192, 128, 5
BASE = ["-w", str(W), "-h", str(H), "-q", "40", "--intra-period", "-1",
        "--pred-struct", "0", "--stat-report"]


@pytest.fixture
def yuv(tmp_path):
    write_yuv(tmp_path / "in.yuv", W, H, N)
    (tmp_path / "qp.txt").write_text("30\n-1\n45\n\n20\n")
    return tmp_path


# (id, extra flags)
CASES = [
    ("ippp", []),
    ("tiles-log2=1", ["--tiles-log2", "1"]),
    ("lookahead=3", ["--lookahead", "3"]),
    ("qp-file", ["--qp-file", "{qp}"]),
    ("rc=2", ["--rc", "2", "--tbr", "100000"]),
    ("preset=5", ["--preset", "5"]),
]


@pytest.mark.parametrize("flags", [c[1] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_cli_files_byte_identical(yuv, flags):
    flags = [f.replace("{qp}", str(yuv / "qp.txt")) for f in flags]
    got = run_both_clis(yuv, BASE + flags)
    assert got["ivf"][:4] == b"DKIF"
    assert len(got["rec"]) == N * W * H * 3 // 2
    assert got["stat"].decode().count("\n") == N + 2


def test_cli_config_file_byte_identical(yuv):
    """-c with Sample.cfg tokens; a CLI flag beats the file's value."""
    (yuv / "enc.cfg").write_text(
        f"SourceWidth : {W}\nSourceHeight : {H}\nQP : 50  # base\n"
        "IntraPeriod : -1\nPredStructure : 0\nLookAheadDistance : 2\n")
    run_both_clis(yuv, ["-c", str(yuv / "enc.cfg"), "-q", "36",
                        "--stat-report"])


@pytest.mark.parametrize("flags,gate", [
    # --nch and --gop-shards run (test_torch_app_multi.py); these cases
    # hold the reference CLI's own refusals of them
    (["--nch", "2"], "--nch N needs N comma-separated -i"),
    (["--gop-shards", "2", "--intra-period", "3", "--pred-struct", "1"],
     "--gop-shards needs --pred-struct 0"),
    (["--scm", "1"], "screen_content_mode"),
], ids=["nch=2", "gop-shards=2", "scm=1"])
def test_cli_refuses_unported_settings_by_name(yuv, capsys, flags, gate):
    argv = ["-i", str(yuv / "in.yuv"), "-w", str(W), "-h", str(H),
            "--device", "cpu", *flags]
    assert tapp.main(argv) != 0
    assert gate in capsys.readouterr().err


def test_cli_without_a_card_refuses_the_default_device(yuv, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["-i", str(yuv / "in.yuv"), "-w", str(W), "-h", str(H)]
    assert tapp.main(argv) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_runs_as_a_module(tmp_path):
    out = tmp_path / "o.ivf"
    res = subprocess.run(
        [sys.executable, "-m", "svt_av1_tpu_torch.app.enc_app", "-w", "64",
         "-h", "64", "--synthetic", "2", "--intra-period", "-1",
         "--pred-struct", "1", "-b", str(out), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert out.read_bytes()[:4] == b"DKIF"
