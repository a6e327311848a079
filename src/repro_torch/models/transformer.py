"""The dense transformer LM (``repro.models.transformer``, train path).

``Model`` holds the reference's parameter tree as the module's parameters,
named by their paths in the tree, so ``reference_leaves``,
``params_from_reference`` and ``params_to_reference`` line the two up leaf
for leaf:

* depth is organised as the reference organises it: each position j of
  ``cfg.layer_pattern`` has one stacked tree ``blocks.j`` whose leaves
  carry a leading dim of ``n_blocks`` (the reference's ``lax.scan`` over
  pattern blocks), and the remainder layers are ``tail.i``, unstacked;
* weights are (in, out) for ``x @ W``; norms are fp32 vectors even in a
  bf16 model;
* the leaf order is the sorted keys: ``blocks.j.attn.{wk,wo,wq,wv}``,
  ``blocks.j.mlp.*``, ``blocks.j.norm{1,2}``, an RWKV layer's
  ``blocks.j.rwkv.{bonus_u,decay_a,decay_b,decay_base,mix,w_g,w_k,w_o,
  w_r,w_v}`` in place of ``attn``, ``embed.table``, ``final_norm``,
  ``tail.*``, ``unembed.table``.

MLLess cuts each flattened gradient leaf into 256-wide blocks and the flat
strategies pack the leaves in this order, so the layout is semantics, not
taste (SmolLM-135M has 12 leaves and RWKV6-7B 17, not one per layer and
matrix).

``forward(batch)`` is the reference's ``apply``: token embedding, the
pattern blocks (each block recomputed in the backward, as
``jax.checkpoint`` does, here with ``torch.utils.checkpoint``), the tail
layers, the final norm and a separate unembedding over the vocab padded to
a multiple of 128.  Layer kinds GLOBAL and LOCAL (sliding window) and
RWKV (the RWKV6 time-mix of ``models.rwkv6``, no attention and no rotary
embedding) are supported; MoE, RG-LRU, encoder-decoder and VLM configs
raise.  With ``use_kernel`` (the reference's ``use_pallas``) the causal
self-attention goes through ``kernels.ops.swa_attention`` and the WKV
recurrence through ``kernels.ops.wkv6``, the Hopper kernels.

The weights are drawn with the ``torch.Generator`` given, on its device:
``build_model`` draws a model for the card on the card.

Serving (``repro.models.transformer``'s ``init_cache``, ``prefill`` and
``decode_step``): the decode cache is the reference's tree,
``{"blocks": [...], "tail": [...]}``, one leaf per pattern position
stacked over blocks (batch at dim 1 under ``blocks``, dim 0 under
``tail``).  An attention layer's leaf is a ring buffer ``{"k", "v"}`` of
(B, L, KV, hd) in the model's dtype (``{"q", "scale"}`` each under
``kv_quant``), L the context for a global layer and at most the window
for a local one; an RWKV layer's leaf is its recurrent state.  Prefill
runs each attention layer through kernel 8 when ``use_kernel`` (the
reference's Pallas path) and the RWKV layers through the plain chunked
WKV from the cache's zero state, as the reference does.  Both write the
cache in place (the reference donates it to decode): one slot a layer a
token, no copy of the cache.  ``prefill`` and ``decode_step`` run without
autograd.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GLOBAL, LOCAL, RWKV
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention, kvquant, layers, rwkv6
from repro_torch.models import params as _params
from repro_torch.models.params import (  # noqa: F401
    cache_from_reference, cache_to_reference, params_from_reference,
    reference_leaves,
)

_UNSUPPORTED = ("ROADMAP.md, Open items §1, slice 4: the transformer LM "
                "family beyond the dense attention and RWKV layers is not "
                "ported yet")
_KINDS = (GLOBAL, LOCAL, RWKV)


def _check_supported(cfg):
    what = None
    if cfg.is_moe:
        what = "MoE layers"
    elif cfg.is_encoder_decoder:
        what = "encoder-decoder models"
    elif cfg.family == "vlm":
        what = "VLM front ends"
    elif any(kind not in _KINDS for kind in cfg.layer_pattern):
        what = f"layer kinds {sorted(set(cfg.layer_pattern) - set(_KINDS))}"
    if what is not None:
        raise NotImplementedError(f"{cfg.name}: {what} ({_UNSUPPORTED})")


def _split_depth(cfg):
    P = len(cfg.layer_pattern)
    n_blocks = cfg.n_layers // P
    return n_blocks, cfg.layer_pattern[:cfg.n_layers - n_blocks * P]


def _tree_module(tree) -> nn.Module:
    """A module whose parameters are the tensors of a nested dict."""
    mod = nn.Module()
    for name, val in tree.items():
        if isinstance(val, dict):
            mod.add_module(name, _tree_module(val))
        else:
            mod.register_parameter(name, nn.Parameter(val))
    return mod


def _module_tree(mod: nn.Module) -> dict:
    tree = {name: p for name, p in mod.named_parameters(recurse=False)}
    for name, child in mod.named_children():
        tree[name] = _module_tree(child)
    return tree


def _layer_tree(gen, kind, cfg, dtype, lead=()):
    """One layer's parameters (``lead`` prepends the stacking dim)."""
    tree = {"norm1": layers.rmsnorm_init(*lead, cfg.d_model),
            "norm2": layers.rmsnorm_init(*lead, cfg.d_model),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                   dtype, lead)}
    if kind == RWKV:
        tree["rwkv"] = rwkv6.rwkv_init(gen, cfg, dtype, lead)
    else:
        tree["attn"] = attention.attention_init(gen, cfg, dtype, lead)
    return tree


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class _Table(nn.Module):
    def __init__(self, table):
        super().__init__()
        self.table = nn.Parameter(table)


class Model(nn.Module):
    def __init__(self, cfg, *, use_kernel: bool = False, remat: bool = True,
                 kv_quant: bool = False, gen=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.remat = remat
        # int8 KV caches (``models.kvquant``), for memory-bound decode
        self.kv_quant = kv_quant
        self.n_blocks, self.tail_kinds = _split_depth(cfg)
        dtype = getattr(torch, cfg.dtype)
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        with torch.device(gen.device):
            self.embed = _Table(layers.embed_init(
                gen, (self.padded_vocab, cfg.d_model), dtype))
            self.unembed = _Table(layers.dense_init(
                gen, (cfg.d_model, self.padded_vocab), dtype))
            self.final_norm = nn.Parameter(layers.rmsnorm_init(cfg.d_model))
            self.blocks = nn.ModuleList(
                [_tree_module(_layer_tree(gen, kind, cfg, dtype,
                                          (self.n_blocks,)))
                 for kind in cfg.layer_pattern] if self.n_blocks else [])
            self.tail = nn.ModuleList(
                [_tree_module(_layer_tree(gen, kind, cfg, dtype))
                 for kind in self.tail_kinds])

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (the extra logits are never
        labelled, but they enter the logsumexp, as in the reference)."""
        return -(-self.cfg.vocab_size // 128) * 128

    def init(self, seed: int = 0):
        """Redraws every parameter from ``seed`` (in place), on the
        parameters' device."""
        dev = self.final_norm.device
        fresh = Model(self.cfg,
                      gen=torch.Generator(device=dev).manual_seed(seed))
        with torch.no_grad():
            for p, q in zip(self.parameters(), fresh.parameters()):
                p.copy_(q)
        return self

    # ------------------------------------------------------------------
    def _layer(self, p, kind, x, positions):
        """Pre-norm layer: the sequence mixer (attention or the RWKV6
        time-mix), then the MLP."""
        cfg = self.cfg
        h = layers.rmsnorm(x, p["norm1"])
        if kind == RWKV:
            y, _ = rwkv6.rwkv_apply(p["rwkv"], h, cfg,
                                    use_kernel=self.use_kernel,
                                    with_state=False)
            x = x + y
        else:
            q, k, v = attention.project_qkv(p["attn"], h, cfg)
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
            o = attention.chunked_attention(
                q, k, v, causal=True,
                window=cfg.window if kind == LOCAL else None,
                pallas_fn=kops.swa_attention if self.use_kernel else None)
            B, S = o.shape[:2]
            x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
        h = layers.rmsnorm(x, p["norm2"])
        return x + layers.mlp_apply(p["mlp"], h, cfg.mlp)

    def _block(self, x, positions, block_params):
        for kind, p in zip(self.cfg.layer_pattern, block_params):
            x = self._layer(p, kind, x, positions)
        return x

    def forward(self, batch):
        """batch["tokens"]: (B, S) int -> (logits (B, S, padded vocab) in
        the model dtype, aux 0-dim fp32; 0 for dense layers)."""
        tokens = batch["tokens"]
        x = layers.embed(self.embed.table, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
        # one unbind per stacked leaf: its backward is one stack
        stacked = [_map(lambda t: t.unbind(0), _module_tree(m))
                   for m in self.blocks]
        for i in range(self.n_blocks):
            block = [_map(lambda ts: ts[i], tree) for tree in stacked]
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self._block, x, positions, block,
                               use_reentrant=False)
            else:
                x = self._block(x, positions, block)
        for kind, m in zip(self.tail_kinds, self.tail):
            x = self._layer(_module_tree(m), kind, x, positions)
        x = layers.rmsnorm(x, self.final_norm)
        logits = layers.unembed(self.unembed.table, x)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    # ------------------------------------------------------------------
    # serving: the decode cache, prefill and single-token decode
    # ------------------------------------------------------------------
    def _cache_len(self, kind: str, seq_len: int) -> int:
        if kind == GLOBAL:
            return seq_len
        return min(self.cfg.window, seq_len)

    def _pattern(self, swa_variant: bool):
        if swa_variant:
            return tuple(LOCAL if k == GLOBAL else k
                         for k in self.cfg.layer_pattern)
        return self.cfg.layer_pattern

    def _tail(self, swa_variant: bool):
        if swa_variant:
            return tuple(LOCAL if k == GLOBAL else k for k in self.tail_kinds)
        return self.tail_kinds

    def init_cache(self, batch_size: int, seq_len: int,
                   swa_variant: bool = False, device=None) -> dict:
        """Empty decode cache for a context of ``seq_len``, on ``device``
        (the model's by default; ``"meta"`` gives shapes only)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)
        device = self.final_norm.device if device is None else device

        def one(kind, lead=()):
            if kind == RWKV:
                state = rwkv6.rwkv_init_state(cfg, batch_size, dtype, device)
                return {k: torch.zeros(lead + tuple(v.shape), dtype=v.dtype,
                                       device=device)
                        for k, v in state.items()}
            L = self._cache_len(kind, seq_len)
            if self.kv_quant:
                return {name: kvquant.init_quant_cache(
                    batch_size, L, cfg.n_kv_heads, cfg.head_dim, lead,
                    device) for name in ("k", "v")}
            shape = lead + (batch_size, L, cfg.n_kv_heads, cfg.head_dim)
            return {name: torch.zeros(shape, dtype=dtype, device=device)
                    for name in ("k", "v")}

        return {"blocks": [one(kind, (self.n_blocks,))
                           for kind in self._pattern(swa_variant)]
                if self.n_blocks else [],
                "tail": [one(kind) for kind in self._tail(swa_variant)]}

    def _serve_layers(self, cache, swa_variant):
        """(kind, parameter tree, cache leaf) of every layer in order; the
        trees and leaves of stacked blocks are views of row i."""
        stacked = [_module_tree(m) for m in self.blocks]
        pattern = self._pattern(swa_variant)
        for i in range(self.n_blocks):
            for j, kind in enumerate(pattern):
                yield (kind, _map(lambda t: t[i], stacked[j]),
                       _map(lambda t: t[i], cache["blocks"][j]))
        for kind, m, leaf in zip(self._tail(swa_variant), self.tail,
                                 cache["tail"]):
            yield kind, _module_tree(m), leaf

    @torch.no_grad()
    def prefill(self, batch, cache_len=None, swa_variant: bool = False):
        """Forward over a prompt: (last-token logits (B, 1, padded vocab),
        the filled cache).  Each attention layer keeps the trailing
        ``min(L, S)`` positions at ring slots ``(S - take .. S - 1) mod
        L``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = layers.embed(self.embed.table, tokens)
        B, S, _ = x.shape
        cache_len = cache_len or S
        positions = torch.arange(S, device=x.device)[None, :]
        cache = self.init_cache(B, cache_len, swa_variant, x.device)
        for kind, p, leaf in self._serve_layers(cache, swa_variant):
            h = layers.rmsnorm(x, p["norm1"])
            if kind == RWKV:
                y, state = rwkv6.rwkv_apply(p["rwkv"], h, cfg, state=leaf)
                for name, val in state.items():
                    leaf[name].copy_(val)
                x = x + y
            else:
                q, k, v = attention.project_qkv(p["attn"], h, cfg)
                q = layers.apply_rope(q, positions, cfg.rope_theta)
                k = layers.apply_rope(k, positions, cfg.rope_theta)
                o = attention.chunked_attention(
                    q, k, v, causal=True,
                    window=cfg.window if kind == LOCAL else None,
                    pallas_fn=kops.swa_attention if self.use_kernel else None)
                x = x + o.reshape(B, S, -1) @ p["attn"]["wo"]
                L = (leaf["k"]["q"] if self.kv_quant else leaf["k"]).shape[1]
                take = min(L, S)
                slots = torch.remainder(
                    torch.arange(S - take, S, device=x.device), L)
                for name, val in (("k", k), ("v", v)):
                    if self.kv_quant:
                        qv, sv = kvquant.quantize_kv(val[:, S - take:])
                        leaf[name]["q"].index_copy_(1, slots, qv)
                        leaf[name]["scale"].index_copy_(1, slots, sv)
                    else:
                        leaf[name].index_copy_(1, slots, val[:, S - take:])
            h = layers.rmsnorm(x, p["norm2"])
            x = x + layers.mlp_apply(p["mlp"], h, cfg.mlp)
        x = layers.rmsnorm(x[:, -1:], self.final_norm)
        return layers.unembed(self.unembed.table, x), cache

    @torch.no_grad()
    def decode_step(self, token, cache, pos, swa_variant: bool = False):
        """token: (B, 1) int; ``pos`` the position of this token, an int or
        a 0-dim tensor for all rows, or a (B,) tensor of per-row positions
        (continuous batching).  Writes the token's entries into ``cache``
        in place and returns (logits (B, 1, padded vocab), cache)."""
        cfg = self.cfg
        x = layers.embed(self.embed.table, token)
        B = x.shape[0]
        pos = torch.as_tensor(pos, device=x.device)
        positions = pos.reshape(B, 1) if pos.dim() == 1 \
            else pos.expand(B, 1)
        for kind, p, leaf in self._serve_layers(cache, swa_variant):
            h = layers.rmsnorm(x, p["norm1"])
            if kind == RWKV:
                y, state = rwkv6.rwkv_decode_step(p["rwkv"], h, cfg, leaf)
                for name, val in state.items():
                    leaf[name].copy_(val)
                x = x + y
            else:
                q, k, v = attention.project_qkv(p["attn"], h, cfg)
                q = layers.apply_rope(q, positions, cfg.rope_theta)
                k = layers.apply_rope(k, positions, cfg.rope_theta)
                window = cfg.window if kind == LOCAL else None
                if self.kv_quant:
                    kvquant.quant_cache_update(leaf["k"], k, pos)
                    kvquant.quant_cache_update(leaf["v"], v, pos)
                    o = attention.decode_attention_quant(
                        q, leaf["k"], leaf["v"], pos, window=window)
                else:
                    attention.cache_update(leaf["k"], leaf["v"], k, v, pos)
                    o = attention.decode_attention(
                        q, leaf["k"], leaf["v"], pos, window=window)
                x = x + o.reshape(B, 1, -1) @ p["attn"]["wo"]
            h = layers.rmsnorm(x, p["norm2"])
            x = x + layers.mlp_apply(p["mlp"], h, cfg.mlp)
        x = layers.rmsnorm(x, self.final_norm)
        return layers.unembed(self.unembed.table, x), cache


def build_model(cfg, *, use_kernel: bool = False, remat: bool = True,
                device="cuda", seed: int = 0) -> Model:
    """The LM for ``cfg`` on ``device``, weights drawn from ``seed`` by a
    ``torch.Generator`` on that device (a card's draws differ from the
    CPU's; the reference's ``jax.random`` draws cannot be reproduced, so
    parity starts from ``params_from_reference``)."""
    dev = resolve_device(device)
    return Model(cfg, use_kernel=use_kernel, remat=remat,
                 gen=torch.Generator(device=dev).manual_seed(seed))


# ---------------------------------------------------------------------------
# the reference's parameter tree <-> the module's parameters
# (``reference_leaves`` and ``params_from_reference`` are the shared ones)
# ---------------------------------------------------------------------------
def params_to_reference(model: Model) -> dict:
    """The reference's tree of numpy arrays, with its empty lists."""
    tree = _params.params_to_reference(model)
    tree.setdefault("blocks", [])
    tree.setdefault("tail", [])
    return tree
