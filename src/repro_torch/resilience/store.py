"""In-memory "in-DB" state store — the SPIRT / RedisAI stand-in
(``repro.resilience.store``, copied).

SPIRT's fault-tolerance story (arXiv 2309.14148) is that per-worker
model/optimizer partitions live in the database, so a dead worker's
state survives it and peers take over without replay.  This module is
that database for the real-training harness: a byte store holding one
serialized partition per worker, with read/write accounting so the
recovery benchmark can report *bytes moved* per policy.

The harness pushes ``checkpoint.dumps(state)`` split into ``W``
contiguous slices (partition ``w`` = the ``w``-th slice of the blob) —
the store is the source of truth at takeover time: survivors reassemble
the full blob from the partitions and adopt it on the survivor process
group, so recovered state genuinely round-trips through the DB's bytes
rather than being copied from surviving device memory.  In the port each
rank holds a store of its own with the same partitions (every rank builds
the same blob), so a survivor reads the dead rank's partition from its own
copy.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class InMemoryStore:
    """Keyed byte store with transfer accounting."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self.bytes_written = 0
        self.bytes_read = 0
        self.puts = 0
        self.gets = 0

    def put(self, key: str, data: bytes) -> None:
        self._data[key] = bytes(data)
        self.bytes_written += len(data)
        self.puts += 1

    def get(self, key: str) -> bytes:
        if key not in self._data:
            raise KeyError(
                f"store has no key {key!r}; present: "
                f"{sorted(self._data)}")
        data = self._data[key]
        self.bytes_read += len(data)
        self.gets += 1
        return data

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self) -> List[str]:
        return sorted(self._data)

    def reset(self) -> None:
        self._data.clear()
        self.bytes_written = self.bytes_read = 0
        self.puts = self.gets = 0

    # ------------------------------------------------------------------
    # per-worker state partitions (SPIRT's in-DB model shards)
    # ------------------------------------------------------------------
    @staticmethod
    def _part_key(worker: int) -> str:
        return f"shard/{worker}"

    def push_partitions(self, blob: bytes, n_workers: int) -> None:
        """Split ``blob`` into ``n_workers`` contiguous slices and store
        one per worker (overwriting the previous step's partition —
        the DB holds only the current state, like SPIRT's per-round
        in-place updates)."""
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        step = len(blob) // n_workers
        for w in range(n_workers):
            lo = w * step
            hi = (w + 1) * step if w < n_workers - 1 else len(blob)
            self.put(self._part_key(w), blob[lo:hi])

    def fetch_state(self, n_workers: int,
                    dead: int) -> Tuple[bytes, int]:
        """Reassemble the full blob from every worker's partition.

        Returns ``(blob, dead_partition_bytes)`` — the second value is
        the transfer peer takeover actually *buys*: survivors hold their
        own partitions already, so the dead peer's slice is the state
        that had to cross the network.  (Read accounting still counts
        every partition; ``bytes_read`` is the DB-side load.)"""
        parts = [self.get(self._part_key(w)) for w in range(n_workers)]
        if not 0 <= dead < n_workers:
            raise ValueError(
                f"dead worker {dead} out of range for {n_workers}")
        return b"".join(parts), len(parts[dead])
