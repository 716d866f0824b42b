"""State carried between frames, and its hand-over from the reference.

The encoder has no weights.  What one frame leaves to the next is the
reference picture — the three recon planes, edge-padded to the 64-padded
inter geometry and kept on the device — or, for hierarchical B, a slot
book of such pictures (display index -> planes, decoder slot, remaining
uses), plus per-stream decisions made on the host (the interpolation
filter, the previous source for the global-motion estimate).  Each
packet's entropy coding starts from a fresh FrameContext, so no coder
state crosses frames.

These helpers turn the JAX reference's state into the port's, so a test
can start ``p_frame_step`` of both packages (one or two references) from
the same reference pictures.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svt_av1_tpu_torch.config import EncoderConfig


def refs_from_numpy(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                    device="cuda") -> tuple:
    """Reference planes (``np.asarray`` of the reference encoder's
    ``Encoder._ref_dev``, 64-padded; uint8 at 8 bits, uint16 at 10) as
    the port's device tensors: uint8, or int16 for 10-bit pixels
    (MC.pixel_dtype)."""
    planes = []
    for p in (y, u, v):
        a = np.asarray(p)
        if a.dtype not in (np.uint8, np.uint16) or a.ndim != 2:
            raise ValueError(f"reference plane must be 2-D uint8 or "
                             f"uint16, got {a.dtype} {a.shape}")
        if a.dtype == np.uint16:
            if a.max(initial=0) > 1023:
                raise ValueError("a uint16 reference plane holds more than "
                                 "10 bits")
            a = a.astype(np.int16)
        planes.append(torch.from_numpy(np.array(a)).to(device))
    return tuple(planes)


def config_from_reference(fields: dict) -> EncoderConfig:
    """The port's EncoderConfig from ``dataclasses.asdict`` of the
    reference's; unknown fields raise."""
    names = {f.name for f in dataclasses.fields(EncoderConfig)}
    extra = set(fields) - names
    if extra:
        raise ValueError(f"unknown EncoderConfig fields: {sorted(extra)}")
    kw = dict(fields)
    if "intra_modes" in kw:
        kw["intra_modes"] = tuple(kw["intra_modes"])
    return EncoderConfig(**kw)


def store_from_reference(store: dict, device="cuda") -> dict:
    """The hierarchical-B slot book of the reference encoder
    (``Encoder._store``: display index -> {"dev": 64-padded planes,
    "slot": reference slot, "pins": uses left}) as the port's, with the
    planes as the port's device tensors."""
    return {int(d): {"dev": refs_from_numpy(*(np.asarray(p) for p in e["dev"]),
                                            device=device),
                     "slot": e["slot"], "pins": int(e["pins"])}
            for d, e in store.items()}
