"""Content-addressed stage cache (disk-backed, npz; port of
``pcmi_tpu/utils/cache.py``, numpy only).

A stage result is keyed by a digest of the stage name, the config repr
and the *content* of every input array: change anything and the entry
misses; identical work is reused across runs and processes (resume after
a crash). Callers hand it numpy arrays (``tensor.cpu().numpy()``).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Callable, Dict, Optional

import numpy as np


class StageCache:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.hits = 0
        self.misses = 0

    @staticmethod
    def digest(stage: str, *parts) -> str:
        h = hashlib.sha256(stage.encode())
        for p in parts:
            if isinstance(p, (bytes, bytearray)):
                h.update(p)
            elif hasattr(p, "tobytes"):
                arr = np.asarray(p)
                h.update(str(arr.dtype).encode())
                h.update(str(arr.shape).encode())
                h.update(arr.tobytes())
            else:
                h.update(repr(p).encode())
        return h.hexdigest()[:32]

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".npz")

    def load(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception:
            return None  # corrupt entry = miss (crash-safe)

    def store(self, key: str, arrays: Dict[str, np.ndarray]) -> None:
        path = self._path(key)
        # unique tmp per writer: a fixed name races across processes (one
        # publishes a half-written file, the other crashes in os.replace)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                np.savez(fh, **{k: np.asarray(v) for k, v in arrays.items()})
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def get_or_compute(
        self, stage: str, inputs: tuple,
        compute: Callable[[], Dict[str, np.ndarray]],
    ) -> Dict[str, np.ndarray]:
        key = self.digest(stage, *inputs)
        found = self.load(key)
        if found is not None:
            self.hits += 1
            return found
        self.misses += 1
        out = compute()
        self.store(key, out)
        return out
