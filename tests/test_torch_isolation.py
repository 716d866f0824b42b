"""The port runs without JAX and without the reference package.

A subprocess drops every jax / jaxlib / svt_av1_tpu module (the test
environment may preload jax at interpreter start), installs an import
hook that refuses them, imports every module of svt_av1_tpu_torch (its
CLI, svt_av1_tpu_torch.app.enc_app, included) and chip_smoke (without
running it), and encodes a 64x64 IPPP clip, a 64x64 hierarchical-B clip
with compound prediction, a 64x64 hierarchical-B clip at preset 7 (the
16x16 keyframe search, a three-reference frame), a 64x64 low-delay-B
clip (through the Encoder and through the CLI) and a 64x64 10-bit hier-B
clip at preset 6 with loop restoration and per-superblock adaptive
quantization (the host restoration stage, ops/restoration), a 64x64
all-intra batch of 3 frames (device_batch=2), two 64x64 streams in
lockstep (pipeline/multistream) and two GOPs in lockstep
(parallel/gop) on the CPU end to end."""

import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
BLOCKED = ("jax", "jaxlib", "svt_av1_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
import importlib
import pkgutil

import svt_av1_tpu_torch
names = [m.name for m in pkgutil.walk_packages(svt_av1_tpu_torch.__path__,
                                               "svt_av1_tpu_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke  # noqa: F401  (main() is not run)
assert "svt_av1_tpu_torch.app.enc_app" in names
assert "svt_av1_tpu_torch.ops.restoration" in names
assert "svt_av1_tpu_torch.pipeline.multistream" in names
assert "svt_av1_tpu_torch.parallel.gop" in names

from svt_av1_tpu_torch import EncoderConfig
from svt_av1_tpu_torch.io.yuv import synthetic_frame
from svt_av1_tpu_torch.pipeline.encoder import Encoder
cfg = EncoderConfig(width=64, height=64, qp=40, intra_period=-1,
                    pred_structure=0, scene_change_detection=False,
                    recon_output=True)
pkts = list(Encoder(cfg, device="cpu").encode_all(
    [synthetic_frame(64, 64, seed=i) for i in range(3)]))
assert len(pkts) == 3 and pkts[0].is_keyframe
assert all(len(p.payload) > 0 for p in pkts)
hier = list(Encoder(cfg.replace(pred_structure=2, hierarchical_levels=1),
                    device="cpu").encode_all(
    [synthetic_frame(64, 64, seed=i) for i in range(4)]))
assert [(p.display_idx, p.show) for p in hier] == [
    (0, True), (2, False), (1, False), (1, True), (2, True), (3, False),
    (3, True)]
rd = Encoder(cfg.replace(pred_structure=2, hierarchical_levels=2,
                         enc_mode=7), device="cpu")
rd_tus = list(rd.encode_all([synthetic_frame(64, 64, seed=i)
                             for i in range(5)]))
assert [p.display_idx for p in rd_tus if not p.show] == [4, 2, 1, 3]
assert rd_tus[0].leaf16_cells and rd._nrefs3_frames == 1
ldb = list(Encoder(cfg.replace(pred_structure=1), device="cpu").encode_all(
    [synthetic_frame(64, 64, seed=i) for i in range(3)]))
assert [(p.is_keyframe, p.display_idx) for p in ldb] == [
    (True, 0), (False, 1), (False, 2)]
from svt_av1_tpu_torch.app import enc_app
ivf = sys.argv[2] + "/ldb.ivf"
assert enc_app.main(["-w", "64", "-h", "64", "--synthetic", "3",
                     "--intra-period", "-1", "--pred-struct", "1",
                     "-b", ivf, "--device", "cpu"]) == 0
assert open(ivf, "rb").read(4) == b"DKIF"
vod = list(Encoder(cfg.replace(bit_depth=10, pred_structure=2,
                               hierarchical_levels=2, enc_mode=6,
                               enable_restoration=True,
                               enable_adaptive_quantization=2),
                   device="cpu").encode_all(
    [synthetic_frame(64, 64, seed=i, bit_depth=10) for i in range(5)]))
coded = [p for p in vod if p.recon is not None]
assert len(coded) == 5 and str(coded[0].recon.y.dtype) == "uint16"
batch = Encoder(cfg.replace(intra_period=-2, device_batch=2), device="cpu")
for i in range(3):
    batch.send_picture(synthetic_frame(64, 64, seed=i))
assert [p.pts for p in batch.encode_all([])] == [0, 1, 2]
from svt_av1_tpu_torch.parallel import GopShardedEncoder
from svt_av1_tpu_torch.pipeline.multistream import MultiStreamEncoder
ms = MultiStreamEncoder(cfg, 2, device="cpu")
for i in range(2):
    slot = ms.send([synthetic_frame(64, 64, seed=i + s) for s in range(2)])
    assert len(slot) == 2 and slot[0].is_keyframe == (i == 0)
gop = list(GopShardedEncoder(cfg, 2, 2, device="cpu").encode_all(
    [synthetic_frame(64, 64, seed=i) for i in range(3)]))
assert [(p.pts, p.is_keyframe) for p in gop] == [
    (0, True), (1, False), (2, True)]
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("modules", len(names), "packets", [len(p.payload) for p in pkts])
"""


def test_port_imports_and_encodes_with_jax_blocked(tmp_path):
    res = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT),
                          str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "packets" in res.stdout


def test_no_silent_cpu_fallback_without_a_gpu():
    """Without a card: Encoder's default device raises, and so does the
    CUDA gather entry on CPU tensors (no fallback to the plain one)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-GPU refusal does not "
                    "apply")
    from svt_av1_tpu_torch import EncoderConfig
    from svt_av1_tpu_torch.ops import gather as G
    from svt_av1_tpu_torch.pipeline.encoder import Encoder, resolve_device
    cfg = EncoderConfig(width=64, height=64, intra_period=-1,
                        pred_structure=0, scene_change_detection=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    plane = torch.zeros((16, 16), dtype=torch.int32)
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError):
        G.gather_tiles_cuda(plane, idx, idx, 8, 8)


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """chip_smoke.py exits non-zero and prints no result without a card,
    and in a directory that holds nothing else of the repository."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
