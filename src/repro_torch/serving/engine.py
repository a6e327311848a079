"""Continuous-batching serving engine (``repro.serving.engine``).

A decode-side request scheduler over ``Model.decode_step`` with per-slot
positions: new requests are prefilled one at a time (batch 1) and their
caches copied into a slot of a fixed-size batched decode cache; every
engine step decodes ONE token for every slot; finished slots free at once
for the next queued request (no head-of-line blocking).  A slot left
empty is still decoded at its stale position and its output ignored; the
next admission overwrites its whole row of the cache.

The cache is written in place: an admission copies the request's cache
into its slot row, and decode writes one slot a layer.  Tokens are chosen
on the device (argmax, the first maximal index, as in the reference) and
one copy of B ints reaches the host a step.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    generated: list = dataclasses.field(default_factory=list)


def _batch_dim(path) -> int:
    """Cache leaves under blocks/ are stacked over blocks and those under
    enc_kv/ over layers: batch lives at dim 1."""
    return 1 if "blocks" in path or "enc_kv" in path else 0


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _scatter_request(full_cache, one_cache, slot: int):
    """Copies a batch-1 cache into slot ``slot`` of the batched cache, in
    place; returns the batched cache."""
    ones = dict(_leaves(one_cache))
    for path, full in _leaves(full_cache):
        b = _batch_dim(path)
        full.select(b, slot).copy_(ones[path].squeeze(b))
    return full_cache


class ServingEngine:
    def __init__(self, model, *, batch_size: int, cache_len: int,
                 swa_variant: bool = False):
        self.model = model
        self.B = batch_size
        self.cache_len = cache_len
        self.swa_variant = swa_variant
        self.device = model.final_norm.device
        self.cache = model.init_cache(batch_size, cache_len,
                                      swa_variant=swa_variant)
        self.positions = np.zeros(batch_size, np.int64)
        self.tokens = np.zeros((batch_size, 1), np.int32)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.queue: deque = deque()
        self.finished: Dict[int, Request] = {}
        self._next_rid = 0

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, eos_id=None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens, eos_id))
        return rid

    def _admit(self):
        V = self.model.cfg.vocab_size
        for slot in range(self.B):
            # a request can finish AT prefill (max_new_tokens=1, or the
            # first token is eos): it never occupies the slot, which
            # stays free for the next queued request
            while self.slots[slot] is None and self.queue:
                req = self.queue.popleft()
                logits, cache1 = self.model.prefill(
                    {"tokens": torch.as_tensor(req.prompt[None, :],
                                               device=self.device)},
                    cache_len=self.cache_len, swa_variant=self.swa_variant)
                tok = int(torch.argmax(logits[0, -1, :V]))
                req.generated.append(tok)
                if len(req.generated) >= req.max_new_tokens or \
                        (req.eos_id is not None and tok == req.eos_id):
                    self.finished[req.rid] = req
                    continue
                _scatter_request(self.cache, cache1, slot)
                self.tokens[slot, 0] = tok
                self.positions[slot] = len(req.prompt)
                self.slots[slot] = req

    def _retire(self, slot: int):
        req = self.slots[slot]
        self.finished[req.rid] = req
        self.slots[slot] = None

    def step(self) -> int:
        """Admit + decode one token for every active slot.  Returns the
        number of active requests after the step."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return 0
        V = self.model.cfg.vocab_size
        logits, self.cache = self.model.decode_step(
            torch.as_tensor(self.tokens, device=self.device), self.cache,
            torch.as_tensor(self.positions, device=self.device),
            swa_variant=self.swa_variant)
        toks = torch.argmax(logits[:, 0, :V], dim=-1).cpu().numpy()
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            tok = int(toks[slot])
            req.generated.append(tok)
            self.tokens[slot, 0] = tok
            self.positions[slot] += 1
            done = len(req.generated) >= req.max_new_tokens or \
                (req.eos_id is not None and tok == req.eos_id)
            if done:
                self._retire(slot)
        return sum(s is not None for s in self.slots)

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: generated tokens}."""
        for _ in range(max_steps):
            active = self.step()
            if active == 0 and not self.queue:
                break
        return {rid: r.generated for rid, r in self.finished.items()}
