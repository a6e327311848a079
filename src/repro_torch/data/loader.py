"""Sharding-aware loaders reproducing the paper's partitioning
(``repro.data.loader``, numpy only, a verbatim copy, so both packages
schedule byte-identical minibatches).

The paper's setup (§4.1/§4.3): 4 workers, batch 512 per worker-step,
24 minibatches per worker per epoch, global batch 2048.  ``WorkerShards``
pre-partitions an epoch into per-worker minibatch queues exactly as
SPIRT/MLLess schedule them; AllReduce/ScatterReduce workers act as
streaming dataloaders over an even split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np


@dataclasses.dataclass
class WorkerShards:
    """Per-worker minibatch schedule for one epoch."""
    images: np.ndarray
    labels: np.ndarray
    n_workers: int
    batch_size: int

    def epoch(self, epoch_idx: int) -> List[List[Dict[str, np.ndarray]]]:
        n = len(self.images)
        rng = np.random.RandomState(1234 + epoch_idx)
        order = rng.permutation(n)
        per_worker = n // self.n_workers
        out = []
        for w in range(self.n_workers):
            sel = order[w * per_worker:(w + 1) * per_worker]
            batches = []
            for s in range(0, per_worker - self.batch_size + 1,
                           self.batch_size):
                idx = sel[s:s + self.batch_size]
                batches.append({"images": self.images[idx],
                                "labels": self.labels[idx]})
            out.append(batches)
        return out

    @property
    def batches_per_worker(self) -> int:
        return (len(self.images) // self.n_workers) // self.batch_size


def global_batch_iter(shards: WorkerShards, epoch_idx: int
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Zip per-worker queues into global steps (data-parallel view)."""
    per_worker = shards.epoch(epoch_idx)
    for step in range(shards.batches_per_worker):
        imgs = np.concatenate([per_worker[w][step]["images"]
                               for w in range(shards.n_workers)])
        labs = np.concatenate([per_worker[w][step]["labels"]
                               for w in range(shards.n_workers)])
        yield {"images": imgs, "labels": labs}
