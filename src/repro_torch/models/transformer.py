"""LM transformer (dense GQA: the qwen family; MoE: olmoe): serving with
``prefill`` then ``decode_step`` over a KV cache, ``lm_forward``, and
training with ``lm_loss``.

The reference (``models/transformer.py``) scans over weights stacked on
a layer axis; here :class:`TransformerLM` holds a list of
:class:`Block` modules (dense layers first, then MoE layers, as the
reference's two stacks) and runs them in a Python loop — PyTorch runs
eagerly.  Every weight is an ``nn.Parameter``, built frozen
(``requires_grad=False``), so serving builds no graph and asks the
attention kernel for no ``lse``; ``prefill`` and ``decode_step`` also run
under ``torch.no_grad()``.  Training turns the gradients on
(``model.requires_grad_(True)``; the trainer does) and differentiates
``lm_loss`` through ``lm_forward_hidden``, whose blocks
are each recomputed in the backward (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``), and through the kernels' backward
``autograd.Function``s (``models/layers.py``).  The KV cache is a dict
``{"k", "v"}`` of (L, B, max_len, Hk, Dh) tensors, which ``decode_step``
updates in place where the reference returns a new one.  MLA and MTP
(DeepSeek-V3) come with their slice: a config with ``mla`` or
``mtp_depth`` raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
            f"{cfg.name}: MLA (mla) and multi-token prediction (mtp_depth) "
            f"are not ported yet: ROADMAP.md queue A item 11")


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


def _block_out(blk: Block, cfg: TransformerConfig, x, positions):
    """One layer over the full sequence, for training: ``(out, aux)``."""
    out, aux, _, _ = _block_fwd(blk, cfg, x, positions)
    return out, aux


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


def lm_forward_hidden(model: TransformerLM, tokens: torch.Tensor,
                      remat: bool = True):
    """Like :func:`lm_forward` but never materializes logits (the loss is
    taken from the hidden states): ``(None, aux_loss, hidden)``.  With
    ``remat`` and gradients on, each block is recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), as the reference wraps
    each block in ``jax.checkpoint``: only the blocks' inputs stay
    resident, and each block's forward kernels launch twice a step."""
    cfg = model.cfg
    S = tokens.shape[1]
    # the embedding's backward sums each token's rows in sorted segments
    # (deterministic and parallel over a frequent token's copies), where
    # the index gather's serialises them
    x = F.embedding(tokens.long(), model.embed)
    positions = torch.arange(S, device=tokens.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk in model.blocks:
        if remat and torch.is_grad_enabled():
            x, aux = checkpoint(_block_out, blk, cfg, x, positions,
                                use_reentrant=False)
        else:
            x, aux = _block_out(blk, cfg, x, positions)
        aux_total = aux_total + aux
    return None, aux_total, rms_norm(x, model.final_norm, cfg.norm_eps)


# --------------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------------- #
def _masked_mean(ce: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return ce.mean()
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1)


def _ce(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """Mean cross entropy of ``logits`` (..., V) against ``labels`` in
    float32 (masked mean with ``mask``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return _masked_mean(lse - picked, mask)


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, mask=None, chunk: int = 8192):
    """Vocab-chunked cross entropy: an online log-sum-exp over chunks of
    the head's columns, each chunk's logits in float32, as the
    reference's scan (the flash trick applied to the LM head).  Autograd
    keeps each chunk's logits for the backward, as the reference's scan
    keeps its residuals."""
    B, S, _ = hidden.shape
    V = head.shape[1]
    chunk = min(chunk, V)
    dev = hidden.device
    m = torch.full((B, S), float("-inf"), dtype=torch.float32, device=dev)
    s = torch.zeros((B, S), dtype=torch.float32, device=dev)
    picked = torch.zeros((B, S), dtype=torch.float32, device=dev)
    labels = labels.long()
    for c0 in range(0, V, chunk):
        lg = (hidden @ head[:, c0:c0 + chunk]).float()     # (B, S, <= chunk)
        m_new = torch.maximum(m, lg.amax(-1))
        s = s * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
        in_chunk = (labels >= c0) & (labels < c0 + lg.shape[-1])
        idx = torch.clamp(labels - c0, 0, lg.shape[-1] - 1)
        pick_c = torch.gather(lg, -1, idx[..., None])[..., 0]
        picked = torch.where(in_chunk, pick_c, picked)
        m = m_new
    ce = m + torch.log(torch.clamp(s, min=1e-30)) - picked
    return _masked_mean(ce, mask)


def sharded_xent(hidden: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, mask=None):
    """The reference's vocab-sharded cross entropy on one card: logits in
    the model's dtype (bf16), reductions in float32.  The reference picks
    the label's logit with an iota compare and a masked sum, which keeps a
    mesh's vocab shards apart; one card has no shards, and a gather picks
    the same value (the masked sum adds exact zeros) without a (B, S, V)
    mask."""
    return _ce(hidden @ head, labels, mask)


def lm_loss(model: TransformerLM, tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.01, remat: bool = True,
            xent: str = "sharded", xent_chunk: int = 8192) -> torch.Tensor:
    """Next-token cross entropy plus the MoE load-balance term
    ``aux_weight * aux / n_layers`` (unless the router is aux-free), as
    the reference's ``lm_loss``.  ``xent`` is "sharded" (bf16 logits) or
    "chunked" (vocab chunks).  The reference's MTP term comes with MTP
    (``check_supported`` raises for such a config)."""
    cfg = model.cfg
    _, aux, hidden = lm_forward_hidden(model, tokens, remat=remat)
    if xent == "chunked":
        loss = chunked_xent(hidden, model.head, labels, chunk=xent_chunk)
    elif xent == "sharded":
        loss = sharded_xent(hidden, model.head, labels)
    else:
        raise ValueError(f"xent is 'sharded' or 'chunked', not {xent!r}")
    if cfg.moe is not None and not cfg.moe.router_aux_free:
        loss = loss + aux_weight * aux / max(cfg.n_layers, 1)
    return loss


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
