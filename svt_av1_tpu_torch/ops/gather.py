"""Grid-anchored tile gather — the MC/ME gather primitive of the port.

Port of svt_av1_tpu/ops/gather.py.  The reference's TPU kernel
``svt_av1_tpu/ops/gather.py::_gather_tiles_pallas`` becomes the CUDA
kernel ``csrc/gather_tiles.cu`` (route: nvcc, sm_90a, to a small CPython
extension module without PyTorch headers, built at first use into
``build/svt_av1_tpu_torch/``).

``gather_tiles`` launches the kernel for CUDA tensors and uses the plain
PyTorch version ``gather_tiles_ref`` only for CPU tensors; any other
device, dtype, layout or shape raises.  The kernel's bound on an H100 is
bytes: (plane bytes touched + 8 N index bytes + N th tw output bytes)
over 3.35 TB/s — memory-bound at every 720p call site.  Its calls are
short (2-10 us on the card), so the host path is kept thin: one pass of
checks, no conversions, one allocation and one launch.
"""

from __future__ import annotations

import functools
import importlib.machinery
import importlib.util
import os
import shutil
import sysconfig
from pathlib import Path

import torch

from svt_av1_tpu_torch.utils.build import build_shared

_SRC = Path(__file__).parents[1] / "csrc" / "gather_tiles.cu"
_MODULE = "svtav1torch_gather"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPES = (torch.uint8, torch.int16, torch.int32)
# designs of csrc/gather_tiles.cu: the main path launches "direct"; "v1",
# the first port's kernel, is a yardstick that only chip_smoke.py launches
DESIGNS = {"direct": 0, "v1": 1}
MAIN_DESIGN = "direct"
_MAIN = DESIGNS[MAIN_DESIGN]
_I32 = torch.int32

# The current device and the raw handle of a device's current stream, as
# torch.cuda.current_device() and torch.cuda.current_stream(d).cuda_stream
# give them.  On the H100's host those public calls cost about 0.5 and
# 4-10 us a call, the private getters they wrap about 0.1 us (PERF.md),
# beside a kernel of 2-10 us.  A PyTorch build without the private
# getters gets the public calls; tests/test_torch_cuda.py holds both to
# the same answers on the card.
_current_device = (getattr(torch._C, "_cuda_getDevice", None)
                   or torch.cuda.current_device)
_raw_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
               or (lambda d: torch.cuda.current_stream(d).cuda_stream))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA tile gather cannot "
                           "be built on this machine")
    return str(path)


@functools.lru_cache(maxsize=1)
def kernel_module():
    """Build (once per source hash) and import the gather extension."""
    cmd = [_nvcc()] + NVCC_FLAGS + ["-I", sysconfig.get_paths()["include"]]
    so = build_shared(_SRC, _MODULE, cmd)
    loader = importlib.machinery.ExtensionFileLoader(_MODULE, str(so))
    module = importlib.util.module_from_spec(
        importlib.util.spec_from_loader(_MODULE, loader))
    loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=1)
def _kernel():
    return kernel_module().gather_tiles


def clamp_starts(base_r, base_c, hp: int, wp: int, th: int, tw: int):
    """Tile starts as lax.dynamic_slice takes them: a negative start
    counts from the end (+ Hp / + Wp), then the start is clamped so the
    tile fits ([0, Hp-th] x [0, Wp-tw])."""
    r = base_r.long()
    c = base_c.long()
    r = torch.clamp(torch.where(r < 0, r + hp, r), 0, hp - th)
    c = torch.clamp(torch.where(c < 0, c + wp, c), 0, wp - tw)
    return r, c


def gather_tiles_ref(plane, base_r, base_c, th: int, tw: int):
    """Plain PyTorch tile gather: [N, th, tw] tiles at (base_r, base_c),
    starts mapped like lax.dynamic_slice (clamp_starts)."""
    hp, wp = plane.shape
    r, c = clamp_starts(base_r, base_c, hp, wp, th, tw)
    ar = torch.arange(th, device=plane.device)
    ac = torch.arange(tw, device=plane.device)
    return plane[(r[:, None] + ar[None, :])[:, :, None],
                 (c[:, None] + ac[None, :])[:, None, :]]


def _check(plane, base_r, base_c, th: int, tw: int):
    """Shape and dtype checks of every entry; returns (Hp, Wp, N)."""
    if plane.dim() != 2:
        raise ValueError(f"plane must be 2-D, got {tuple(plane.shape)}")
    if plane.dtype not in DTYPES:
        raise TypeError(f"gather_tiles takes {DTYPES}, got {plane.dtype}")
    if base_r.dim() != 1 or base_r.shape != base_c.shape:
        raise ValueError("base_r / base_c must be equal-length 1-D tensors")
    hp, wp = plane.shape
    if not (0 < th <= hp and 0 < tw <= wp):
        raise ValueError(f"tile {th}x{tw} outside plane {(hp, wp)}")
    return hp, wp, base_r.shape[0]


def check_cuda_args(plane, base_r, base_c) -> int:
    """What the kernel takes beyond _check, checked before any launch:
    contiguous int32 starts and a contiguous plane, all on the current
    CUDA device, whose index it returns.  Converts nothing.  (The
    extension itself refuses a plane or an output of 2^31 bytes or
    more: it indexes in 32 bits.)"""
    if base_r.dtype is not _I32 or base_c.dtype is not _I32:
        raise TypeError(f"the CUDA tile gather takes int32 starts, got "
                        f"{base_r.dtype} / {base_c.dtype}")
    if not (plane.is_contiguous() and base_r.is_contiguous()
            and base_c.is_contiguous()):
        raise ValueError("plane and starts must be contiguous")
    if not plane.is_cuda:
        raise RuntimeError(f"the CUDA tile gather needs a CUDA tensor, "
                           f"got one on {plane.device}")
    dev = plane.get_device()
    if base_r.get_device() != dev or base_c.get_device() != dev:
        raise ValueError(f"starts on {base_r.device} / {base_c.device}, "
                         f"plane on {plane.device}")
    if dev != _current_device():
        raise RuntimeError(f"plane on {plane.device}, current device is "
                           f"cuda:{_current_device()}")
    return dev


def gather_tiles(plane, base_r, base_c, *, nbh: int, nbw: int, stride: int,
                 band_off: int, band_h: int, th: int, tw: int):
    """Gather N = nbh*nbw tiles of [th, tw] from a 2-D plane.

    Tiles are grid-anchored: tile k = i*nbw + j (row-major) starts at
    (base_r[k], base_c[k]) with the caller guaranteeing
    ``0 <= base_r[k] - (i*stride + band_off) <= band_h - th`` — grid row
    i reads only rows [i*stride + band_off, +band_h).  Returns
    [N, th, tw] in the plane's dtype, on the plane's device.

    CUDA tensors run csrc/gather_tiles.cu (counted in
    ``gather_tiles.launches``) and need contiguous int32 starts on the
    plane's device (``check_cuda_args``); CPU tensors run
    gather_tiles_ref.
    """
    hp, wp, n = _check(plane, base_r, base_c, th, tw)
    if band_off < 0 or (nbh - 1) * stride + band_off + band_h > hp:
        raise ValueError(f"band outside plane: Hp={hp} nbh={nbh} "
                         f"stride={stride} band_off={band_off} "
                         f"band_h={band_h}")
    if n != nbh * nbw:
        raise ValueError(f"{n} starts for {nbh}x{nbw} tiles")
    if plane.is_cpu:
        return gather_tiles_ref(plane, base_r, base_c, th, tw)
    return _launch(_MAIN, plane, base_r, base_c, hp, wp, n, th, tw)


def gather_tiles_cuda(plane, base_r, base_c, th: int, tw: int):
    """Launch the main design (no fallback) on N tiles with no band
    contract: [N, th, tw]."""
    return gather_tiles_design(MAIN_DESIGN, plane, base_r, base_c, th, tw)


def gather_tiles_design(design: str, plane, base_r, base_c, th: int,
                        tw: int):
    """One launch of a named design of csrc/gather_tiles.cu on N tiles.
    chip_smoke.py times and checks the designs with it; only MAIN_DESIGN
    launches count in ``gather_tiles.launches``."""
    hp, wp, n = _check(plane, base_r, base_c, th, tw)
    return _launch(DESIGNS[design], plane, base_r, base_c, hp, wp, n, th,
                   tw)


def _launch(design: int, plane, base_r, base_c, hp: int, wp: int, n: int,
            th: int, tw: int):
    dev = check_cuda_args(plane, base_r, base_c)
    out = torch.empty(n, th, tw, dtype=plane.dtype, device=plane.device)
    _kernel()(design, plane.data_ptr(), hp, wp, plane.element_size(),
              base_r.data_ptr(), base_c.data_ptr(), out.data_ptr(), n, th,
              tw, _raw_stream(dev))
    if design == _MAIN:
        gather_tiles.launches += 1
    return out


gather_tiles.launches = 0


def grid_tile_args(plane_pad, mv_r, mv_c, bs: int, pad: int, reach: int,
                   halo: int = 0, off: int = 0):
    """Starts and band geometry of a grid-anchored gather (see
    gather_blocks_grid): returns (base_r, base_c, gather_tiles kwargs)."""
    nbh, nbw = mv_r.shape
    th = bs + halo
    o = pad + 3 + off
    dev = plane_pad.device
    base_r = (torch.arange(nbh, dtype=torch.int32, device=dev)[:, None] * bs
              + o + mv_r.to(torch.int32)).reshape(-1)
    base_c = (torch.arange(nbw, dtype=torch.int32, device=dev)[None, :] * bs
              + o + mv_c.to(torch.int32)).reshape(-1)
    band_off = o - reach
    if band_off < 0:
        raise ValueError(f"reach {reach} exceeds the pad {pad}")
    return base_r, base_c, dict(nbh=nbh, nbw=nbw, stride=bs,
                                band_off=band_off, band_h=2 * reach + th,
                                th=th, tw=th)


def gather_blocks_grid(plane_pad, mv_r, mv_c, bs: int, pad: int,
                       reach: int, halo: int = 0, off: int = 0):
    """Grid-anchored gather from a pad_for_filter plane: block (i, j)
    reads a [bs+halo, bs+halo] tile starting at grid position
    (i*bs, j*bs) + (mv_r, mv_c) + off (pad_for_filter maps position p
    to index p + pad + 3).  |mv| <= reach must hold.
    Returns [nbh*nbw, bs+halo, bs+halo]."""
    base_r, base_c, kw = grid_tile_args(plane_pad, mv_r, mv_c, bs, pad,
                                        reach, halo, off)
    return gather_tiles(plane_pad, base_r, base_c, **kw)
