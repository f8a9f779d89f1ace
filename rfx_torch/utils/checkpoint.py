"""Chunked accumulation with checkpoint/resume (the port's own copy of
rfx/utils/checkpoint.py, held against it by tests/test_torch_host_copies.py).

The reference has no checkpointing (single-process, single-shot runs,
SURVEY.md 5). Here long Monte-Carlo jobs are a sequence of idempotent chunk
reductions: each chunk traces `chunk_rays` rays from a counter-derived PRNG
key and its partial result (IR histogram / coverage map — any pytree of
arrays that sums) is folded into an accumulator persisted to disk keyed by
chunk index. A killed run resumes at the first missing chunk; re-running a
completed chunk is a no-op (Monte-Carlo sums are order-independent). The same
chunk protocol is the elastic-recovery story for multi-host runs: a lost
host's chunks are simply re-executed.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

__all__ = ["ChunkAccumulator", "run_chunked"]


class ChunkAccumulator:
    """Disk-backed sum-accumulator over named chunks.

    Layout: <dir>/state.npz (summed arrays) + <dir>/meta.json
    ({"done": [chunk ids], "extra": ...}). Writes are atomic
    (tempfile + rename) so a kill mid-save never corrupts the state.
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._state: dict[str, np.ndarray] = {}
        self._done: set[int] = set()
        self._load()

    @property
    def done_chunks(self) -> set[int]:
        return set(self._done)

    def _paths(self):
        return os.path.join(self.dir, "state.npz"), os.path.join(self.dir, "meta.json")

    def _load(self):
        state_path, meta_path = self._paths()
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            self._done = set(meta["done"])
            if os.path.exists(state_path):
                with np.load(state_path) as z:
                    self._state = {k: z[k] for k in z.files}

    def _save(self):
        state_path, meta_path = self._paths()
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".npz")
        os.close(fd)
        np.savez(tmp, **self._state)
        os.replace(tmp, state_path)
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump({"done": sorted(self._done)}, f)
        os.replace(tmp, meta_path)

    def add(self, chunk_id: int, arrays: dict[str, np.ndarray]):
        """Fold one chunk's partial sums; idempotent per chunk_id."""
        if chunk_id in self._done:
            return
        for k, v in arrays.items():
            v = np.asarray(v)
            self._state[k] = self._state[k] + v if k in self._state else v.copy()
        self._done.add(chunk_id)
        self._save()

    def result(self) -> dict[str, np.ndarray]:
        return dict(self._state)


def run_chunked(
    compute_chunk,
    num_chunks: int,
    directory: str,
    *,
    log=None,
) -> dict[str, np.ndarray]:
    """Run `compute_chunk(chunk_id) -> {name: array}` for every missing chunk,
    accumulating into `directory`. Returns the summed result. Safe to call
    again after a crash — completed chunks are skipped."""
    acc = ChunkAccumulator(directory)
    for cid in range(num_chunks):
        if cid in acc.done_chunks:
            continue
        arrays = compute_chunk(cid)
        acc.add(cid, {k: np.asarray(v) for k, v in arrays.items()})
        if log is not None:
            log.info("chunk %d/%d done", cid + 1, num_chunks)
    return acc.result()
