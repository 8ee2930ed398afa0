"""MapState checkpoint/resume: npz snapshot with integrity checksum.

JAX equivalent of the reference's Atlas save/load (boost serialization
with MD5 vocabulary checksum, /root/reference/src/rumi-slam/lib_src/
System.cc:29-36,220, SaveAtlas/LoadAtlas System.h:217-218).  The SoA MapState
serializes trivially: one compressed npz of the arrays + scalar counters,
plus a sha256 over the payload for corruption detection.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from . import map_state as M

_FORMAT_VERSION = 2  # v2: added kf_ur (stereo/RGB-D virtual right coords)


def save(ms: M.MapState, path: str | Path) -> str:
    """Write checkpoint; returns hex digest of the payload."""
    path = Path(path)
    buf = io.BytesIO()
    arrays = {name: np.asarray(getattr(ms, name)) for name in ms._fields}
    np.savez_compressed(buf, **arrays)
    payload = buf.getvalue()
    digest = hashlib.sha256(payload).hexdigest()
    meta = {
        "format_version": _FORMAT_VERSION,
        "sha256": digest,
        "fields": list(ms._fields),
        "max_kf": int(ms.max_kf),
        "max_feat": int(ms.max_feat),
        "max_pt": int(ms.max_pt),
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        header = json.dumps(meta).encode()
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(payload)
    return digest


def load(path: str | Path) -> M.MapState:
    """Read + verify checkpoint; raises on checksum mismatch."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode())
        payload = f.read()
    if meta["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['format_version']}")
    digest = hashlib.sha256(payload).hexdigest()
    if digest != meta["sha256"]:
        raise ValueError("checkpoint corrupt: sha256 mismatch")
    npz = np.load(io.BytesIO(payload))
    kwargs = {name: jnp.asarray(npz[name]) for name in meta["fields"]}
    return M.MapState(**kwargs)
