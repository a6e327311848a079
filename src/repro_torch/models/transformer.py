"""The transformer LM zoo (``repro.models.transformer``): train forward,
decode cache, prefill and single-token decode.

``Model`` holds the reference's parameter tree as the module's parameters,
named by their paths in the tree, so ``reference_leaves``,
``params_from_reference`` and ``params_to_reference`` line the two up leaf
for leaf:

* depth is organised as the reference organises it: each position j of
  ``cfg.layer_pattern`` has one stacked tree ``blocks.j`` whose leaves
  carry a leading dim of ``n_blocks`` (the reference's ``lax.scan`` over
  pattern blocks), and the remainder layers are ``tail.i``, unstacked;
  an encoder-decoder's encoder is one stacked tree ``encoder`` (leading
  dim ``n_encoder_layers``) and its final norm ``enc_norm``;
* weights are (in, out) for ``x @ W``; norms are fp32 vectors even in a
  bf16 model, and so are an MoE ``router`` and an RG-LRU ``lam``;
* the leaf order is the sorted keys: a layer's sequence mixer
  (``attn.{bk,bq,bv,wk,wo,wq,wv}``, ``rglru.*`` or ``rwkv.*``), its FFN
  (``mlp.*``, or ``moe.{router,w_down,w_gate,w_up}`` in an MoE model's
  attention layers), ``norm1``, ``norm2`` and, in a decoder layer of an
  encoder-decoder, ``norm_x`` and ``xattn.*``; then ``embed.table``,
  ``enc_norm``, ``encoder.*``, ``final_norm``, ``tail.*``,
  ``unembed.table``.

MLLess cuts each flattened gradient leaf into 256-wide blocks and the flat
strategies pack the leaves in this order, so the layout is semantics, not
taste (SmolLM-135M has 12 leaves, Mixtral 13, RecurrentGemma-2B 55,
Whisper-small 34).

Layer kinds: GLOBAL and LOCAL (sliding-window) attention, RGLRU (the
RG-LRU recurrent block of ``models.rglru``) and RWKV (the RWKV6 time-mix
of ``models.rwkv6``); any other kind raises ``ValueError``.  MoE configs
replace the MLP of every attention layer by the top-k expert layer of
``models.moe``, whose load-balance loss ``forward`` returns summed over
layers.  An encoder-decoder (Whisper) has no rotary embedding: sinusoidal
positions on the decoder's embeddings, a non-causal encoder over the
batch's stub ``frames`` (each layer recomputed in the backward), and a
cross-attention on every decoder layer.  A VLM (Pixtral) replaces the
first ``n_patches`` token embeddings by the batch's stub ``patch_emb``.

``forward(batch)`` is the reference's ``apply``: the embedding, the
pattern blocks (each block recomputed in the backward, as
``jax.checkpoint`` does, here with ``torch.utils.checkpoint``), the tail
layers, the final norm and a separate unembedding over the vocab padded
to a multiple of 128.  With ``use_kernel`` (the reference's
``use_pallas``) the causal self-attention goes through
``kernels.ops.swa_attention`` and the WKV recurrence through
``kernels.ops.wkv6``, the Hopper kernels; the encoder's attention and the
cross-attention are not causal and take the plain chunked path, as the
reference routes them.

The weights are drawn with the ``torch.Generator`` given, on its device:
``build_model`` draws a model for the card on the card.

Serving (``init_cache``, ``prefill`` and ``decode_step``): the decode
cache is the reference's tree, ``{"blocks": [...], "tail": [...]}`` and,
for an encoder-decoder, ``"enc_kv"``; one leaf per pattern position
stacked over blocks (batch at dim 1 under ``blocks`` and ``enc_kv``, dim
0 under ``tail``).  An attention layer's leaf is a ring buffer ``{"k",
"v"}`` of (B, L, KV, hd) in the model's dtype (``{"q", "scale"}`` each
under ``kv_quant``), L the context for a global layer and at most the
window for a local one; an RG-LRU or RWKV layer's leaf is its recurrent
state; ``enc_kv`` holds each decoder layer's cross-attention k and v,
(n_layers, B, encoder_seq, KV, hd) in layer order.  Prefill runs each
causal attention layer through kernel 8 when ``use_kernel`` (the
reference's Pallas path) and the recurrent layers from the cache's zero
state, as the reference does.  Both write the cache in place (the
reference donates it to decode): one slot a layer a token, no copy of the
cache.  ``prefill`` and ``decode_step`` run without autograd.

Sharding (``core.sharding``): under FSDP ``param_hook`` gathers each
layer's parameter shards inside the layer (inside the recomputed block,
so the backward gathers again, as the reference's remat does) and on each
tail layer; the encoder calls no hook, as in the reference.
``decode_step(..., shard=)`` decodes on a rank's slice of a
sequence-sharded cache (``core.serve_step.SeqShard``); the cache held
whole goes through ``WHOLE_CACHE``, the same interface.
``build_model(..., device="meta")`` gives shapes only (the dry-run).

Tensor parallelism (``tp``, a ``models.tp.TensorParallel`` set by the
train and serve steps; every family): the module holds this
rank's slice of each leaf that ``core.sharding.param_pspecs`` puts on the
model axis, and the layers read them through ``models.tp`` with
activations replicated over the model group.  ``forward`` then returns
this rank's vocab columns of the logits where the unembedding's columns
are sharded (``logits_sharded``; the loss is vocab-parallel), and
attention runs kernel 8 on this rank's H/M heads where M divides them,
else on every head.  ``prefill`` and ``decode_step`` return whole logits;
``prefill`` fills the rank's cache given to it, laid out by
``core.sharding.cache_pspecs`` (kv heads, head_dim or slots on the
model axis), and ``decode_step`` reaches that cache through the serve
step's cache operations (``core.serve_step.TpCache``).  The MoE layer
runs its experts on this rank's d_ff slice (``moe.moe_apply``), the
RWKV6 time-mix its WKV on this rank's heads and the RG-LRU its channels
(``rwkv6``, ``rglru``); an encoder-decoder's encoder layers and
cross-attention take the attention and MLP routes above, and ``enc_kv``
holds this rank's kv heads, head_dim slice or encoder positions; a
VLM's patch embeddings are replicated inputs.
"""
from __future__ import annotations

import itertools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GLOBAL, LOCAL, RGLRU, RWKV
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention, kvquant, layers, moe, rglru, rwkv6
from repro_torch.models.params import (  # noqa: F401
    cache_from_reference, cache_to_reference, param_tree,
    params_from_reference, params_to_reference, reference_leaves,
)

_ATTENTION = (GLOBAL, LOCAL)


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


def _layer_tree(gen, kind, cfg, dtype, lead=(), cross=False):
    """One layer's parameters (``lead`` prepends the stacking dim); an
    unknown layer kind raises ``ValueError(kind)``, as in the reference."""
    tree = {"norm1": layers.rmsnorm_init(*lead, cfg.d_model),
            "norm2": layers.rmsnorm_init(*lead, cfg.d_model)}
    if kind in _ATTENTION:
        tree["attn"] = attention.attention_init(gen, cfg, dtype, lead)
    elif kind == RGLRU:
        tree["rglru"] = rglru.rglru_init(gen, cfg, dtype, lead)
    elif kind == RWKV:
        tree["rwkv"] = rwkv6.rwkv_init(gen, cfg, dtype, lead)
    else:
        raise ValueError(kind)
    if cross:
        tree["norm_x"] = layers.rmsnorm_init(*lead, cfg.d_model)
        tree["xattn"] = attention.attention_init(gen, cfg, dtype, lead)
    if cfg.is_moe and kind in _ATTENTION:
        tree["moe"] = moe.moe_init(gen, cfg, dtype, lead)
    else:
        tree["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                      dtype, lead)
    return tree


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class _Table(nn.Module):
    def __init__(self, table):
        super().__init__()
        self.table = nn.Parameter(table)


class Model(nn.Module):
    # the reference tree's top-level lists, kept by ``param_tree`` when
    # empty (``'tail': []`` where the depth is whole pattern blocks)
    reference_lists = ("blocks", "tail")

    def __init__(self, cfg, *, use_kernel: bool = False, remat: bool = True,
                 kv_quant: bool = False, gen=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.use_kernel = use_kernel
        self.remat = remat
        # int8 KV caches (``models.kvquant``), for memory-bound decode
        self.kv_quant = kv_quant
        self.use_rope = not cfg.is_encoder_decoder
        self.n_blocks, self.tail_kinds = _split_depth(cfg)
        dtype = getattr(torch, cfg.dtype)
        cross = cfg.is_encoder_decoder
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        # FSDP: fn(layer subtree, kind in {"block", "tail"}, idx) -> the
        # gathered subtree, called inside each (recomputed) layer; set by
        # ``core.train_step.build_train_step``, identity when None
        self.param_hook = None
        # tensor parallelism (``models.tp.TensorParallel``), set by the
        # train and serve steps; None: every leaf whole
        self.tp = None
        # the process group whose ranks hold blocks of rows of one batch
        # that the MoE layers route as a whole (batch-sharded serving, set
        # by the serve step); None: the rows are the whole batch
        self.batch_group = None
        # a stand-in for kernel 8 in the causal self-attention (the
        # dry-run's shape-only one on ``meta`` tensors); None: as
        # ``use_kernel`` says
        self.attention_fn = None
        with torch.device(device if device is not None else gen.device):
            self.embed = _Table(layers.embed_init(
                gen, (self.padded_vocab, cfg.d_model), dtype))
            self.unembed = _Table(layers.dense_init(
                gen, (cfg.d_model, self.padded_vocab), dtype))
            self.final_norm = nn.Parameter(layers.rmsnorm_init(cfg.d_model))
            self.blocks = nn.ModuleList(
                [_tree_module(_layer_tree(gen, kind, cfg, dtype,
                                          (self.n_blocks,), cross))
                 for kind in cfg.layer_pattern] if self.n_blocks else [])
            self.tail = nn.ModuleList(
                [_tree_module(_layer_tree(gen, kind, cfg, dtype, (), cross))
                 for kind in self.tail_kinds])
            if cfg.is_encoder_decoder:
                self.encoder = _tree_module(_layer_tree(
                    gen, GLOBAL, cfg, dtype, (cfg.n_encoder_layers,)))
                self.enc_norm = nn.Parameter(
                    layers.rmsnorm_init(cfg.d_model))

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

    @property
    def logits_sharded(self) -> bool:
        """Whether ``forward`` returns this rank's vocab columns of the
        logits (tensor parallelism over the unembedding's columns)."""
        return self.tp is not None and self.tp.dim_of(
            self.unembed.table, (self.cfg.d_model, self.padded_vocab)) == 1

    def _norm(self, x, w):
        return layers.rmsnorm(x, w, tp=self.tp)

    def _attn_out(self, x, p, o):
        """x + the attention output o (B, S, H, hd) through ``p["wo"]``."""
        return x + attention.attention_out(p, o, self.cfg, self.tp)

    def _logits(self, x, whole=False):
        """The unembedding of x; ``whole`` gathers vocab-sharded logits."""
        shape = (self.cfg.d_model, self.padded_vocab)
        logits = layers.unembed(self.unembed.table, x, tp=self.tp,
                                shape=shape)
        if whole and logits.shape[-1] < self.padded_vocab:
            logits = self.tp.gather(logits, -1)
        return logits

    # ------------------------------------------------------------------
    def _attention_fn(self):
        if self.attention_fn is not None:
            return self.attention_fn
        return kops.swa_attention if self.use_kernel else None

    def _embed_inputs(self, batch):
        """Token embeddings; a VLM's patch embeddings in place of the first
        ``n_patches`` tokens; an encoder-decoder's sinusoidal positions."""
        cfg = self.cfg
        x = layers.embed(self.embed.table, batch["tokens"], tp=self.tp,
                         shape=(self.padded_vocab, cfg.d_model))
        S = x.shape[1]
        if cfg.family == "vlm" and "patch_emb" in batch:
            n = batch["patch_emb"].shape[1]
            if S < n:
                # the reference's concatenation would make the sequence n
                # long, out of step with the positions and cache slots
                raise ValueError(f"{cfg.name}: {S} tokens cannot hold "
                                 f"{n} patch embeddings")
            x = torch.cat([batch["patch_emb"].to(x.dtype), x[:, n:]], dim=1)
        if cfg.is_encoder_decoder:
            x = x + layers.sinusoidal_positions(S, cfg.d_model,
                                                x.device).to(x.dtype)
        return x

    def _encoder_layer(self, x, p):
        cfg = self.cfg
        h = self._norm(x, p["norm1"])
        q, k, v = attention.project_qkv(p["attn"], h, cfg, self.tp)
        k, v = attention.heads_for(q, k, v, cfg, self.tp)
        o = attention.chunked_attention(q, k, v, causal=False)
        x = self._attn_out(x, p["attn"], o)
        h = self._norm(x, p["norm2"])
        return x + layers.mlp_apply(p["mlp"], h, cfg.mlp, tp=self.tp,
                                    d_ff=cfg.d_ff)

    def _encode(self, frames):
        """The non-causal encoder over the stub frame embeddings, each
        layer recomputed in the backward."""
        cfg = self.cfg
        x = frames.to(getattr(torch, cfg.dtype))
        x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model,
                                            x.device).to(x.dtype)
        stacked = _map(lambda t: t.unbind(0), _module_tree(self.encoder))
        for i in range(cfg.n_encoder_layers):
            p = _map(lambda ts: ts[i], stacked)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(self._encoder_layer, x, p,
                               use_reentrant=False)
            else:
                x = self._encoder_layer(x, p)
        return self._norm(x, self.enc_norm)

    def _cross(self, x, p, enc_out):
        """x + the cross-attention of x over ``enc_out``; also the
        encoder's k and v (B, encoder_seq, KV, hd) of this layer (under
        tensor parallelism this rank's kv heads where they divide, else
        every one)."""
        cfg = self.cfg
        h = self._norm(x, p["norm_x"])
        q, _, _ = attention.project_qkv(p["xattn"], h, cfg, self.tp)
        _, k, v = attention.project_qkv(p["xattn"], enc_out, cfg, self.tp)
        ka, va = attention.heads_for(q, k, v, cfg, self.tp)
        o = attention.chunked_attention(q, ka, va, causal=False)
        return self._attn_out(x, p["xattn"], o), k, v

    def _ffn(self, x, p):
        """x + the FFN (MLP or MoE) of x; the MoE's aux loss (else 0)."""
        h = self._norm(x, p["norm2"])
        if "moe" in p:
            y, aux = moe.moe_apply(p["moe"], h, self.cfg, tp=self.tp,
                                   batch_group=self.batch_group)
            return x + y, aux
        return x + layers.mlp_apply(p["mlp"], h, self.cfg.mlp, tp=self.tp,
                                    d_ff=self.cfg.d_ff), 0.0

    def _rope(self, t, positions):
        if not self.use_rope:
            return t
        return layers.apply_rope(t, positions, self.cfg.rope_theta)

    def _layer(self, p, kind, x, positions, enc_out):
        """Pre-norm layer: the sequence mixer (attention, RG-LRU or the
        RWKV6 time-mix), the cross-attention of an encoder-decoder, then
        the FFN; returns (x, aux)."""
        cfg = self.cfg
        h = self._norm(x, p["norm1"])
        if kind == RWKV:
            y, _ = rwkv6.rwkv_apply(p["rwkv"], h, cfg,
                                    use_kernel=self.use_kernel,
                                    with_state=False, tp=self.tp)
            x = x + y
        elif kind == RGLRU:
            y, _ = rglru.rglru_apply(p["rglru"], h, cfg, tp=self.tp)
            x = x + y
        else:
            q, k, v = attention.project_qkv(p["attn"], h, cfg, self.tp)
            k, v = attention.heads_for(q, k, v, cfg, self.tp)
            q, k = self._rope(q, positions), self._rope(k, positions)
            o = attention.chunked_attention(
                q, k, v, causal=True,
                window=cfg.window if kind == LOCAL else None,
                pallas_fn=self._attention_fn())
            x = self._attn_out(x, p["attn"], o)
        if enc_out is not None:
            x, _, _ = self._cross(x, p, enc_out)
        return self._ffn(x, p)

    def _hook(self, tree, kind, idx):
        if self.param_hook is None:
            return tree
        return self.param_hook(tree, kind, idx)

    def _block(self, x, aux, positions, enc_out, block_params):
        for j, (kind, p) in enumerate(zip(self.cfg.layer_pattern,
                                          block_params)):
            x, a = self._layer(self._hook(p, "block", j), kind, x,
                               positions, enc_out)
            aux = aux + a
        return x, aux

    def forward(self, batch):
        """batch["tokens"]: (B, S) int (and ``frames`` (B, encoder_seq, d)
        for an encoder-decoder, ``patch_emb`` (B, n_patches, d) for a VLM)
        -> (logits (B, S, padded vocab) in the model dtype, aux 0-dim fp32:
        the MoE layers' load-balance loss summed, 0 without MoE); under
        tensor parallelism with ``logits_sharded``, this rank's
        (B, S, padded vocab / M) columns."""
        x = self._embed_inputs(batch)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        enc_out = None
        if self.cfg.is_encoder_decoder:
            enc_out = self._encode(batch["frames"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # one unbind per stacked leaf: its backward is one stack
        stacked = [_map(lambda t: t.unbind(0), _module_tree(m))
                   for m in self.blocks]
        for i in range(self.n_blocks):
            block = [_map(lambda ts: ts[i], tree) for tree in stacked]
            if self.remat and torch.is_grad_enabled():
                x, aux = checkpoint(self._block, x, aux, positions, enc_out,
                                    block, use_reentrant=False)
            else:
                x, aux = self._block(x, aux, positions, enc_out, block)
        for i, (kind, m) in enumerate(zip(self.tail_kinds, self.tail)):
            x, a = self._layer(self._hook(_module_tree(m), "tail", i), kind,
                               x, positions, enc_out)
            aux = aux + a
        x = self._norm(x, self.final_norm)
        return self._logits(x), aux

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
            if kind in (RWKV, RGLRU):
                init = rwkv6.rwkv_init_state if kind == RWKV \
                    else rglru.rglru_init_state
                state = init(cfg, batch_size, dtype, "meta")
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

        cache = {"blocks": [one(kind, (self.n_blocks,))
                            for kind in self._pattern(swa_variant)]
                 if self.n_blocks else [],
                 "tail": [one(kind) for kind in self._tail(swa_variant)]}
        if cfg.is_encoder_decoder:
            shape = (cfg.n_layers, batch_size, cfg.encoder_seq,
                     cfg.n_kv_heads, cfg.head_dim)
            cache["enc_kv"] = {name: torch.zeros(shape, dtype=dtype,
                                                 device=device)
                               for name in ("k", "v")}
        return cache

    def _serve_layers(self, cache, swa_variant):
        """(kind, parameter tree, cache leaf, encoder k/v leaf or None) of
        every layer in order; the trees and leaves of stacked blocks, and
        the encoder k/v, are views of row i."""
        stacked = [_module_tree(m) for m in self.blocks]
        pattern = self._pattern(swa_variant)
        order = [(kind, _map(lambda t: t[i], stacked[j]),
                  _map(lambda t: t[i], cache["blocks"][j]))
                 for i in range(self.n_blocks)
                 for j, kind in enumerate(pattern)]
        order += [(kind, _module_tree(m), leaf) for kind, m, leaf in
                  zip(self._tail(swa_variant), self.tail, cache["tail"])]
        enc = cache.get("enc_kv")
        for li, (kind, p, leaf) in enumerate(order):
            yield kind, p, leaf, (None if enc is None else
                                  _map(lambda t: t[li], enc))

    @torch.no_grad()
    def prefill(self, batch, cache_len=None, swa_variant: bool = False,
                cache=None):
        """Forward over a prompt: (last-token logits (B, 1, padded vocab),
        the filled cache).  Each attention layer keeps the trailing
        ``min(L, S)`` positions at ring slots ``(S - take .. S - 1) mod
        L``; an encoder-decoder's cache also takes each layer's encoder k
        and v.  ``cache`` (required under tensor parallelism: this rank's
        slice, zeros) is filled in place of a fresh one."""
        cfg = self.cfg
        x = self._embed_inputs(batch)
        B, S, _ = x.shape
        cache_len = cache_len or S
        positions = torch.arange(S, device=x.device)[None, :]
        enc_out = None
        if cfg.is_encoder_decoder:
            enc_out = self._encode(batch["frames"])
        if cache is None:
            if self.tp is not None:
                raise ValueError("under tensor parallelism prefill fills "
                                 "the rank's cache it is given "
                                 "(core.serve_step lays it out)")
            cache = self.init_cache(B, cache_len, swa_variant, x.device)
        for kind, p, leaf, enc in self._serve_layers(cache, swa_variant):
            h = self._norm(x, p["norm1"])
            if kind in (RWKV, RGLRU):
                if kind == RWKV:
                    y, state = rwkv6.rwkv_apply(p["rwkv"], h, cfg,
                                                state=leaf, tp=self.tp)
                else:
                    y, state = rglru.rglru_apply(p["rglru"], h, cfg,
                                                 state=leaf, tp=self.tp)
                for name, val in state.items():
                    leaf[name].copy_(val)
                x = x + y
            else:
                q, k, v = attention.project_qkv(p["attn"], h, cfg, self.tp)
                ka, va = attention.heads_for(q, k, v, cfg, self.tp)
                q = self._rope(q, positions)
                ka = self._rope(ka, positions)
                o = attention.chunked_attention(
                    q, ka, va, causal=True,
                    window=cfg.window if kind == LOCAL else None,
                    pallas_fn=self._attention_fn())
                x = self._attn_out(x, p["attn"], o)
                if ka is not k:
                    k = self._rope(k, positions)
                else:
                    k = ka
                self._fill_ring(leaf, k, v, S,
                                self._cache_len(kind, cache_len))
            if enc is not None:
                x, ek, ev = self._cross(x, p, enc_out)
                if self.tp is not None:
                    ek = self.tp.slice_like(ek, enc["k"])
                    ev = self.tp.slice_like(ev, enc["v"])
                enc["k"].copy_(ek)
                enc["v"].copy_(ev)
            x, _ = self._ffn(x, p)
        x = self._norm(x[:, -1:], self.final_norm)
        return self._logits(x, whole=True), cache

    def _fill_ring(self, leaf, k, v, S, L):
        """Write the trailing ``min(L, S)`` positions of k and v (B, S, *,
        hd) at slots ``(S - take .. S - 1) mod L`` of a ring of ``L``
        slots; under tensor parallelism, the leaf's slice of them (its kv
        heads, its head_dim slice, or its range of the slots, an int8
        scale's too)."""
        payload = leaf["k"]["q"] if self.kv_quant else leaf["k"]
        take = min(L, S)
        slots = torch.remainder(torch.arange(S - take, S, device=k.device),
                                L)
        tp = self.tp

        def put(ring, val):
            if ring.shape[1] == L:
                ring.index_copy_(1, slots, val)
                return
            # this rank's range of the slots: the model axis on them
            whole = ring.new_zeros(ring.shape[:1] + (L,) + ring.shape[2:])
            whole.index_copy_(1, slots, val)
            ring.copy_(tp.slice(whole, 1))

        for name, val in (("k", k), ("v", v)):
            val = val[:, S - take:]
            if tp is not None and val.shape[2] > payload.shape[2]:
                val = tp.slice(val, 2)
            if self.kv_quant:
                qv, sv = kvquant.quantize_kv(val)
                if tp is not None and qv.shape[3] > payload.shape[3]:
                    qv = tp.slice(qv, 3)
                put(leaf[name]["q"], qv)
                put(leaf[name]["scale"], sv)
            else:
                if tp is not None and val.shape[3] > payload.shape[3]:
                    val = tp.slice(val, 3)
                put(leaf[name], val)

    @torch.no_grad()
    def decode_step(self, token, cache, pos, swa_variant: bool = False,
                    shard=None):
        """token: (B, 1) int; ``pos`` the position of this token, an int or
        a 0-dim tensor for all rows, or a (B,) tensor of per-row positions
        (continuous batching).  Writes the token's entries into ``cache``
        in place and returns (logits (B, 1, padded vocab), cache).

        ``shard`` (``core.serve_step.SeqShard``): ``cache`` is this rank's
        slice of a cache sharded over ranks along the dim after the batch
        (the sequence of a ring buffer, a width of a recurrent state, the
        encoder positions of ``enc_kv``); a sharded ring buffer is written
        by its owner and attended through flash-decode, a sharded state is
        gathered for the step and its slice kept.  Under tensor
        parallelism ``shard`` is a ``core.serve_step.TpCache`` (around
        either): every rank computes every head of q, k and v and it hands
        the cache its slice."""
        cfg = self.cfg
        shard = WHOLE_CACHE if shard is None else shard
        gcache = getattr(shard, "cache", None)
        x = layers.embed(self.embed.table, token, tp=self.tp,
                         shape=(self.padded_vocab, cfg.d_model))
        B = x.shape[0]
        pos = torch.as_tensor(pos, device=x.device)
        if cfg.is_encoder_decoder:
            pe = layers.sinusoidal_position_at(pos, cfg.d_model)
            x = x + (pe[:, None, :] if pos.dim() == 1 else pe).to(x.dtype)
        positions = pos.reshape(B, 1) if pos.dim() == 1 \
            else pos.expand(B, 1)
        glob = itertools.repeat((None,) * 4) if gcache is None else \
            self._serve_layers(gcache, swa_variant)
        for (kind, p, leaf, enc), (_, _, gleaf, genc) in zip(
                self._serve_layers(cache, swa_variant), glob):
            h = self._norm(x, p["norm1"])
            if kind in (RWKV, RGLRU):
                step = rwkv6.rwkv_decode_step if kind == RWKV \
                    else rglru.rglru_decode_step
                y, state = step(p[kind], h, cfg, shard.gather(leaf, gleaf),
                                tp=self.tp)
                for name, val in state.items():
                    leaf[name].copy_(shard.keep(val, leaf[name]))
                x = x + y
            else:
                # every head on every rank (a cache op slices its own)
                q, k, v = attention.project_qkv(p["attn"], h, cfg, self.tp,
                                                head_local=False)
                q, k = self._rope(q, positions), self._rope(k, positions)
                window = cfg.window if kind == LOCAL else None
                o = shard.attend(q, k, v, leaf, gleaf, pos, window,
                                 self.kv_quant)
                x = self._attn_out(x, p["attn"], o)
            if enc is not None:
                h = self._norm(x, p["norm_x"])
                q = attention.project_q(p["xattn"], h, cfg, self.tp)
                o = shard.attend_all(q, enc, genc)
                x = self._attn_out(x, p["xattn"], o)
            x, _ = self._ffn(x, p)
        x = self._norm(x, self.final_norm)
        return self._logits(x, whole=True), cache


class WholeCache:
    """The decode step's cache operations on a cache held whole (the
    interface ``core.serve_step.SeqShard`` implements for a slice)."""

    @staticmethod
    def gather(leaf, _):
        return leaf

    @staticmethod
    def keep(val, _):
        return val

    @staticmethod
    def attend(q, k, v, leaf, _, pos, window, kv_quant, *, head_dim=None,
               partial=None, quantized=None):
        """Write the token's k and v at ring slot ``pos % L`` and attend.
        ``quantized`` gives the int8 entries (k's payload and scale, v's)
        where they were quantized elsewhere (over a whole head_dim);
        ``head_dim`` and ``partial`` go to the attention
        (``attention.decode_attention``)."""
        kw = dict(window=window, head_dim=head_dim, partial=partial)
        if kv_quant:
            if quantized is None:
                kvquant.quant_cache_update(leaf["k"], k, pos)
                kvquant.quant_cache_update(leaf["v"], v, pos)
            else:
                for name, (qv, sv) in zip("kv", (quantized[:2],
                                                 quantized[2:])):
                    attention.write_slots(leaf[name]["q"], qv, pos)
                    attention.write_slots(leaf[name]["scale"], sv, pos)
            return attention.decode_attention_quant(
                q, leaf["k"], leaf["v"], pos, **kw)
        attention.cache_update(leaf["k"], leaf["v"], k, v, pos)
        return attention.decode_attention(q, leaf["k"], leaf["v"], pos, **kw)

    @staticmethod
    def attend_all(q, enc, _, **extra):
        """Attend to every position of the encoder's k and v (``extra``:
        ``head_dim`` and ``partial``, as ``attend``)."""
        return attention.decode_attention(q, enc["k"], enc["v"],
                                          enc["k"].shape[1] - 1, **extra)


WHOLE_CACHE = WholeCache()


def build_model(cfg, *, use_kernel: bool = False, remat: bool = True,
                device="cuda", seed: int = 0) -> Model:
    """The LM for ``cfg`` on ``device``, weights drawn from ``seed`` by a
    ``torch.Generator`` on that device (a card's draws differ from the
    CPU's; the reference's ``jax.random`` draws cannot be reproduced, so
    parity starts from ``params_from_reference``).  ``device="meta"``
    gives the parameters' shapes and dtypes only."""
    if str(device) == "meta":
        # shapes and dtypes only (the dry-run): nothing is allocated
        return Model(cfg, use_kernel=use_kernel, remat=remat,
                     gen=torch.Generator().manual_seed(seed), device="meta")
    dev = resolve_device(device)
    return Model(cfg, use_kernel=use_kernel, remat=remat,
                 gen=torch.Generator(device=dev).manual_seed(seed))
