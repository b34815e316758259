"""LM transformer (dense GQA: the qwen family; MoE: olmoe) for serving:
``prefill`` then ``decode_step`` over a KV cache, and ``lm_forward``.

The reference (``models/transformer.py``) scans over weights stacked on
a layer axis; here :class:`TransformerLM` holds a list of
:class:`Block` modules (dense layers first, then MoE layers, as the
reference's two stacks) and runs them in a Python loop — PyTorch runs
eagerly.  The weights are parameters without gradients: this slice
serves, and the kernels of the path have no backward yet (the training
slice adds them).  The KV cache is a dict ``{"k", "v"}`` of
(L, B, max_len, Hk, Dh) tensors, which ``decode_step`` updates in place
where the reference returns a new one.  MLA and MTP (DeepSeek-V3) come
with their slice: a config with ``mla`` or ``mtp_depth`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import (_init, decode_attention,
                                       flash_attention, gqa_qkv,
                                       init_gqa_params, init_moe_params,
                                       moe_block, rms_norm, swiglu)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dt(cfg: TransformerConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for the parts of the config the port does not run yet."""
    if cfg.mla is not None or cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: MLA and MTP are not ported yet (ROADMAP.md queue A "
            f"item 11)")


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in d.items()})


class Block(nn.Module):
    """One transformer layer: ``attn`` (GQA projections and norms),
    ``ffn`` (a dense SwiGLU, or the router and the stacked experts when
    ``moe``), and the two RMS-norm weights."""

    def __init__(self, attn: dict, ffn: dict, ln1: torch.Tensor,
                 ln2: torch.Tensor, moe: bool):
        super().__init__()
        self.attn = _params(attn)
        self.ffn = _params(ffn)
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.moe = moe


class TransformerLM(nn.Module):
    """The LM: embedding, blocks, final norm and head (the embedding's
    transpose when ``cfg.tie_embeddings``)."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor,
                 blocks: list, final_norm: torch.Tensor,
                 lm_head: torch.Tensor | None = None):
        super().__init__()
        check_supported(cfg)
        if len(blocks) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(blocks)} blocks for "
                             f"{cfg.n_layers} layers")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        if cfg.tie_embeddings:
            self.lm_head = None
        else:
            if lm_head is None:
                raise ValueError(f"{cfg.name}: untied embeddings need lm_head")
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor):
        return lm_forward(self, tokens)


# --------------------------------------------------------------------------- #
# init
# --------------------------------------------------------------------------- #
def init_ffn_params(gen: torch.Generator, cfg: TransformerConfig, d_ff: int,
                    dtype, device=None) -> dict:
    return dict(wg=_init(gen, (cfg.d_model, d_ff), dtype=dtype, device=device),
                wu=_init(gen, (cfg.d_model, d_ff), dtype=dtype, device=device),
                wd=_init(gen, (d_ff, cfg.d_model), dtype=dtype, device=device))


def _init_block(gen: torch.Generator, cfg: TransformerConfig, moe: bool,
                dtype, device=None) -> Block:
    attn = init_gqa_params(gen, cfg, dtype, device)
    if moe:
        ffn = init_moe_params(gen, cfg, dtype, device)
    else:
        d_ff = (cfg.moe.d_ff_dense if (cfg.moe and cfg.moe.first_k_dense)
                else cfg.d_ff)
        ffn = init_ffn_params(gen, cfg, d_ff, dtype, device)
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    return Block(attn, ffn, ones, ones.clone(), moe)


def init_lm_params(gen: torch.Generator, cfg: TransformerConfig,
                   device=None) -> TransformerLM:
    """A random model, initialised as the reference's ``init_lm_params``
    does (normal weights scaled by ``1/sqrt(shape[0])``, the embedding and
    head by 0.02, norms 1, biases 0), drawn from ``gen`` — a
    :class:`torch.Generator` on ``device`` (default: the card)."""
    check_supported(cfg)
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"generator on {gen.device}, model on {device}")
    dtype = _dt(cfg)
    n_dense = cfg.moe.first_k_dense if cfg.moe else cfg.n_layers
    embed = _init(gen, (cfg.vocab, cfg.d_model), scale=0.02, dtype=dtype,
                  device=device)
    blocks = [_init_block(gen, cfg, i >= n_dense, dtype, device)
              for i in range(cfg.n_layers)]
    final_norm = torch.ones((cfg.d_model,), dtype=dtype, device=device)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = _init(gen, (cfg.d_model, cfg.vocab), scale=0.02,
                        dtype=dtype, device=device)
    return TransformerLM(cfg, embed, blocks, final_norm, lm_head)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def _ffn(blk: Block, cfg: TransformerConfig, hn: torch.Tensor):
    if blk.moe:
        return moe_block(blk.ffn, cfg, hn)
    f = blk.ffn
    return (swiglu(hn, f["wg"], f["wu"], f["wd"]),
            torch.zeros((), dtype=torch.float32, device=hn.device))


def _attn_full(blk: Block, cfg: TransformerConfig, x, positions):
    """Full-sequence (train/prefill) attention for one block; returns the
    projected output and the layer's (k, v)."""
    q, k, v = gqa_qkv(blk.attn, cfg, x, positions)
    o = flash_attention(q, k, v, causal=True)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ blk.attn["wo"], k, v


def _block_fwd(blk: Block, cfg: TransformerConfig, x, positions):
    """One layer over the full sequence: ``(out, aux, k, v)``."""
    o, k, v = _attn_full(blk, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                         positions)
    h = x + o
    y, aux = _ffn(blk, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
    return h + y, aux, k, v


def lm_forward(model: TransformerLM, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V), aux_loss, hidden)."""
    cfg = model.cfg
    S = tokens.shape[1]
    x = model.embed[tokens]
    positions = torch.arange(S, device=tokens.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk in model.blocks:
        x, aux, _, _ = _block_fwd(blk, cfg, x, positions)
        aux_total = aux_total + aux
    hidden = rms_norm(x, model.final_norm, cfg.norm_eps)
    return hidden @ model.head, aux_total, hidden


# --------------------------------------------------------------------------- #
# KV-cache serving
# --------------------------------------------------------------------------- #
@dataclass
class CacheSpec:
    """Shapes of the per-layer decode cache."""
    kind: str          # "gqa" ("mla" comes with the MLA slice)
    shapes: dict


def cache_spec(cfg: TransformerConfig, batch: int, max_len: int) -> CacheSpec:
    check_supported(cfg)
    L, dt = cfg.n_layers, _dt(cfg)
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return CacheSpec("gqa", dict(k=(shape, dt), v=(shape, dt)))


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    device = resolve_device(device)
    spec = cache_spec(cfg, batch, max_len)
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in spec.shapes.items()}


@torch.no_grad()
def decode_step(model: TransformerLM, cache: dict, tokens: torch.Tensor,
                length: int):
    """One decode step. tokens (B,) int; ``length`` = current cache fill
    (int): this step's k/v go to position ``length``.  Returns
    ``(logits (B, V), cache)``, the cache updated in place.

    A full cache (``length >= max_len``, the cache's sequence axis)
    raises ``ValueError`` before any slot is written.  The reference
    writes through ``jax.lax.dynamic_update_slice``, which clamps the
    start index, so there it silently overwrites the last slot and
    attends to the overwritten key; the port refuses instead."""
    cfg = model.cfg
    length = int(length)
    max_len = cache["k"].shape[2]
    if not 0 <= length < max_len:
        raise ValueError(f"decode_step: length = {length} does not fit a "
                         f"cache of max_len = {max_len}")
    B = tokens.shape[0]
    x = model.embed[tokens][:, None, :]                  # (B, 1, d)
    positions = torch.full((B, 1), length, dtype=torch.int32,
                           device=tokens.device)
    for li, blk in enumerate(model.blocks):
        xn = rms_norm(x, blk.ln1, cfg.norm_eps)
        q, k, v = gqa_qkv(blk.attn, cfg, xn, positions)
        ck, cv = cache["k"][li], cache["v"][li]
        ck[:, length] = k[:, 0].to(ck.dtype)
        cv[:, length] = v[:, 0].to(cv.dtype)
        o = decode_attention(q, ck, cv, length + 1)
        h = x + o.reshape(B, 1, -1) @ blk.attn["wo"]
        y, _ = _ffn(blk, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
        x = h + y
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return (x @ model.head)[:, 0], cache


@torch.no_grad()
def prefill(model: TransformerLM, tokens: torch.Tensor,
            max_len: int | None = None, last_only: bool = False):
    """Prefill: run the full sequence, return (logits, cache filled to S).
    ``last_only`` computes logits for the final position only (the
    decode handoff needs nothing else)."""
    cfg = model.cfg
    B, S = tokens.shape
    max_len = max_len or S
    if max_len < S:
        raise ValueError(f"max_len {max_len} < prompt length {S}")
    cache = init_cache(cfg, B, max_len, tokens.device)
    x = model.embed[tokens]
    positions = torch.arange(S, device=tokens.device)[None, :]
    for li, blk in enumerate(model.blocks):
        x, _, k, v = _block_fwd(blk, cfg, x, positions)
        cache["k"][li, :, :S] = k
        cache["v"][li, :, :S] = v
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        return x[:, -1:] @ model.head, cache
    return x @ model.head, cache
