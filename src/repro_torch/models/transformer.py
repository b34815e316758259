"""LM transformer (dense GQA: the qwen family; MoE: olmoe; MLA + MoE:
deepseek-v3): serving with ``prefill`` then ``decode_step`` over a KV
cache, ``lm_forward``, and training with ``lm_loss``.

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
of per-layer tensors, which ``decode_step`` updates in place where the
reference returns a new one: ``{"k", "v"}`` of (L, B, max_len, Hk, Dh)
for GQA, and for MLA (DeepSeek-V3) the latent ``{"c_kv": (L, B,
max_len, kv_lora_rank), "k_rope": (L, B, max_len, qk_rope_head_dim)}``.
An MLA config's decode runs naive (per-head K/V expanded from the
latent) or absorbed (attention in the latent space).  The multi-token
prediction head (``mtp``, DeepSeek-V3's depth 1) is carried as
parameters; serving does not use it, and ``lm_loss`` adds its term.
:meth:`TransformerLM.decayed_params` names the parameters AdamW decays
by the reference's rule on its stacked tree.
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
                                       init_gqa_params, init_mla_params,
                                       init_moe_params, mla_absorbed_decode,
                                       mla_compress, mla_expand_kv,
                                       mla_queries, moe_block, rms_norm,
                                       swiglu)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dt(cfg: TransformerConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                             for k, v in d.items()})


class Block(nn.Module):
    """One transformer layer: ``attn`` (GQA or MLA projections and norms),
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


class MTPHead(nn.Module):
    """The depth-1 multi-token prediction head: a dense ``block``, the
    (2d, d) ``proj`` and its RMS-norm weight ``norm``."""

    def __init__(self, block: Block, proj: torch.Tensor, norm: torch.Tensor):
        super().__init__()
        self.block = block
        self.proj = nn.Parameter(proj, requires_grad=False)
        self.norm = nn.Parameter(norm, requires_grad=False)


class TransformerLM(nn.Module):
    """The LM: embedding, blocks, final norm and head (the embedding's
    transpose when ``cfg.tie_embeddings``), and the MTP head when
    ``cfg.mtp_depth``."""

    def __init__(self, cfg: TransformerConfig, embed: torch.Tensor,
                 blocks: list, final_norm: torch.Tensor,
                 lm_head: torch.Tensor | None = None,
                 mtp: MTPHead | None = None):
        super().__init__()
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
        if bool(cfg.mtp_depth) != (mtp is not None):
            raise ValueError(f"{cfg.name}: mtp_depth {cfg.mtp_depth} with "
                             f"{'an' if mtp is not None else 'no'} MTP head")
        self.mtp = mtp

    @property
    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens: torch.Tensor):
        return lm_forward(self, tokens)

    def decayed_params(self) -> set[str]:
        """The names of the parameters AdamW decays, by the reference's
        rule on its own tree (``ndim >= 2``): it stacks every layer's
        weights on a layer axis, so every parameter under ``blocks.``,
        norms, biases and ``router_bias`` included, counts one dimension
        more than it has here.  The MTP head's block is not stacked
        there: of it, and of the rest, only the 2-D and 3-D tensors
        (``embed``, ``lm_head``, ``mtp.proj``, the block's matrices)."""
        return {name for name, p in self.named_parameters()
                if p.ndim >= 2 or name.startswith("blocks.")}


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
    attn = (init_mla_params(gen, cfg, dtype, device) if cfg.mla is not None
            else init_gqa_params(gen, cfg, dtype, device))
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
    :class:`torch.Generator` on ``device`` (default: the card); with
    ``cfg.mtp_depth`` also the MTP head's dense block and projection.
    ``device="meta"`` builds the shapes alone (no storage, ``gen`` may
    be None): the mesh plan's and the dry-run's model."""
    device = resolve_device(device)
    if device.type != "meta" and gen.device.type != device.type:
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
    mtp = None
    if cfg.mtp_depth:
        mtp = MTPHead(_init_block(gen, cfg, False, dtype, device),
                      _init(gen, (2 * cfg.d_model, cfg.d_model), dtype=dtype,
                            device=device),
                      torch.ones((cfg.d_model,), dtype=dtype, device=device))
    return TransformerLM(cfg, embed, blocks, final_norm, lm_head, mtp)


# --------------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------------- #
def _ffn(blk: Block, cfg: TransformerConfig, hn: torch.Tensor):
    if blk.moe:
        return moe_block(blk.ffn, cfg, hn)
    f = blk.ffn
    return (swiglu(hn, f["wg"], f["wu"], f["wd"]),
            torch.zeros((), dtype=torch.float32, device=hn.device))


def _mla_qk(attn, cfg: TransformerConfig, x, positions, c_kv, k_r):
    """MLA's per-head q, k and v for attention over the latent ``c_kv``
    (B, S, r) and ``k_r`` (B, S, 1, Dr): q = [q_nope, q_rope] and k =
    [k_nope, k_r broadcast over the heads], each of width Dn + Dr, v of
    width Dv."""
    k_nope, v = mla_expand_kv(attn, cfg, c_kv)
    q_nope, q_rope = mla_queries(attn, cfg, x, positions)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_r.expand(*k_nope.shape[:-1], k_r.shape[-1])],
                  dim=-1)
    return q, k, v


def _attn_full(blk: Block, cfg: TransformerConfig, x, positions):
    """Full-sequence (train/prefill) attention for one block; returns the
    projected output and the layer's cache entries (``{"k", "v"}``, or
    MLA's ``{"c_kv", "k_rope"}``)."""
    if cfg.mla is not None:
        c_kv, k_r = mla_compress(blk.attn, cfg, x, positions)
        q, k, v = _mla_qk(blk.attn, cfg, x, positions, c_kv, k_r)
        kv = dict(c_kv=c_kv, k_rope=k_r[:, :, 0])
    else:
        q, k, v = gqa_qkv(blk.attn, cfg, x, positions)
        kv = dict(k=k, v=v)
    o = flash_attention(q, k, v, causal=True)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ blk.attn["wo"], kv


def _block_fwd(blk: Block, cfg: TransformerConfig, x, positions):
    """One layer over the full sequence: ``(out, aux, kv)``, ``kv`` the
    layer's cache entries."""
    o, kv = _attn_full(blk, cfg, rms_norm(x, blk.ln1, cfg.norm_eps),
                       positions)
    h = x + o
    y, aux = _ffn(blk, cfg, rms_norm(h, blk.ln2, cfg.norm_eps))
    return h + y, aux, kv


def _block_out(blk: Block, cfg: TransformerConfig, x, positions):
    """One layer over the full sequence, for training: ``(out, aux)``."""
    out, aux, _ = _block_fwd(blk, cfg, x, positions)
    return out, aux


def lm_forward(model: TransformerLM, tokens: torch.Tensor):
    """tokens (B, S) -> (logits (B, S, V), aux_loss, hidden)."""
    cfg = model.cfg
    S = tokens.shape[1]
    x = model.embed[tokens]
    positions = torch.arange(S, device=tokens.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for blk in model.blocks:
        x, aux, _ = _block_fwd(blk, cfg, x, positions)
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


def _mtp_hidden(model: TransformerLM, tokens: torch.Tensor,
                hidden: torch.Tensor) -> torch.Tensor:
    """The depth-1 MTP head's final-normed hidden states, as the
    reference's ``lm_loss`` computes them: position t joins the main
    path's (final-normed) ``hidden[t]``, normed again by ``mtp.norm``, with
    the embedding of token t + 1 (not normed; the last position wraps to
    token 0), projects the pair back to d by ``mtp.proj``, and runs the
    dense MTP block over positions 0..S-1 (without recompute, as there)
    and ``final_norm``."""
    cfg, mtp = model.cfg, model.mtp
    S = tokens.shape[1]
    # F.embedding, as lm_forward_hidden's: a deterministic backward
    nxt = F.embedding(torch.roll(tokens, -1, dims=1).long(), model.embed)
    cat = torch.cat([rms_norm(hidden, mtp.norm, cfg.norm_eps), nxt], dim=-1)
    positions = torch.arange(S, device=tokens.device)[None, :]
    h2, _ = _block_out(mtp.block, cfg, cat @ mtp.proj, positions)
    return rms_norm(h2, model.final_norm, cfg.norm_eps)


def lm_loss(model: TransformerLM, tokens: torch.Tensor, labels: torch.Tensor,
            aux_weight: float = 0.01, mtp_weight: float = 0.3,
            remat: bool = True, xent: str = "sharded",
            xent_chunk: int = 8192) -> torch.Tensor:
    """Next-token cross entropy plus the MoE load-balance term
    ``aux_weight * aux / n_layers`` (unless the router is aux-free) plus,
    with an MTP head, ``mtp_weight`` times the head's cross entropy
    against the labels one step on (``roll(labels, -1)``, the last
    position masked), as the reference's ``lm_loss``.  ``xent`` is
    "sharded" (bf16 logits) or "chunked" (vocab chunks), for both terms.
    The MTP term's mask is (1, S), so its masked mean divides the B rows'
    sum by S - 1, as the reference's does."""
    cfg = model.cfg
    if xent == "chunked":
        def ce(h, lab, mask=None):
            return chunked_xent(h, model.head, lab, mask, chunk=xent_chunk)
    elif xent == "sharded":
        def ce(h, lab, mask=None):
            return sharded_xent(h, model.head, lab, mask)
    else:
        raise ValueError(f"xent is 'sharded' or 'chunked', not {xent!r}")
    _, aux, hidden = lm_forward_hidden(model, tokens, remat=remat)
    loss = ce(hidden, labels)
    if cfg.moe is not None and not cfg.moe.router_aux_free:
        loss = loss + aux_weight * aux / max(cfg.n_layers, 1)
    if model.mtp is not None:
        S = tokens.shape[1]
        mask = (torch.arange(S, device=tokens.device) < S - 1).float()[None]
        loss = loss + mtp_weight * ce(_mtp_hidden(model, tokens, hidden),
                                      torch.roll(labels, -1, dims=1), mask)
    return loss


# --------------------------------------------------------------------------- #
# KV-cache serving
# --------------------------------------------------------------------------- #
@dataclass
class CacheSpec:
    """Shapes of the per-layer decode cache."""
    kind: str          # "gqa" | "mla"
    shapes: dict


def cache_spec(cfg: TransformerConfig, batch: int, max_len: int) -> CacheSpec:
    L, dt = cfg.n_layers, _dt(cfg)
    if cfg.mla is not None:
        m = cfg.mla
        return CacheSpec("mla", dict(
            c_kv=((L, batch, max_len, m.kv_lora_rank), dt),
            k_rope=((L, batch, max_len, m.qk_rope_head_dim), dt)))
    shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return CacheSpec("gqa", dict(k=(shape, dt), v=(shape, dt)))


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    device = resolve_device(device)
    spec = cache_spec(cfg, batch, max_len)
    return {k: torch.zeros(s, dtype=d, device=device)
            for k, (s, d) in spec.shapes.items()}


def _mla_decode_attn(blk: Block, cfg: TransformerConfig, cache: dict,
                     li: int, xn, positions, length: int, absorbed: bool):
    """MLA attention of one decode step: this step's latent and rope key
    go to position ``length`` of layer ``li``'s cache, then naive (per-head
    K/V expanded from the whole cache, :func:`decode_attention`) or
    absorbed (:func:`mla_absorbed_decode`) attention over it; returns the
    output after ``wo``."""
    c_kv, k_r = mla_compress(blk.attn, cfg, xn, positions)
    ck, kr = cache["c_kv"][li], cache["k_rope"][li]
    ck[:, length] = c_kv[:, 0].to(ck.dtype)
    kr[:, length] = k_r[:, 0, 0].to(kr.dtype)
    if absorbed:
        return mla_absorbed_decode(blk.attn, cfg, xn, ck, kr[:, :, None],
                                   length + 1, positions)
    q, k, v = _mla_qk(blk.attn, cfg, xn, positions, ck, kr[:, :, None])
    o = decode_attention(q, k, v, length + 1)
    return o.reshape(xn.shape[0], 1, -1) @ blk.attn["wo"]


@torch.no_grad()
def decode_step(model: TransformerLM, cache: dict, tokens: torch.Tensor,
                length: int, absorbed: bool = False):
    """One decode step. tokens (B,) int; ``length`` = current cache fill
    (int): this step's k/v (MLA: latent and rope key) go to position
    ``length``.  Returns ``(logits (B, V), cache)``, the cache updated in
    place.  ``absorbed`` picks MLA's weight-absorbed attention (the
    reference's serving mode for MLA) over the naive one; a GQA config
    ignores it.

    A full cache (``length >= max_len``, the cache's sequence axis)
    raises ``ValueError`` before any slot is written.  The reference
    writes through ``jax.lax.dynamic_update_slice``, which clamps the
    start index, so there it silently overwrites the last slot and
    attends to the overwritten key; the port refuses instead."""
    cfg = model.cfg
    length = int(length)
    max_len = next(iter(cache.values())).shape[2]
    if not 0 <= length < max_len:
        raise ValueError(f"decode_step: length = {length} does not fit a "
                         f"cache of max_len = {max_len}")
    B = tokens.shape[0]
    x = model.embed[tokens][:, None, :]                  # (B, 1, d)
    positions = torch.full((B, 1), length, dtype=torch.int32,
                           device=tokens.device)
    for li, blk in enumerate(model.blocks):
        xn = rms_norm(x, blk.ln1, cfg.norm_eps)
        if cfg.mla is not None:
            h = x + _mla_decode_attn(blk, cfg, cache, li, xn, positions,
                                     length, absorbed)
        else:
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
        x, _, kv = _block_fwd(blk, cfg, x, positions)
        for name, t in kv.items():
            cache[name][li, :, :S] = t
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    if last_only:
        return x[:, -1:] @ model.head, cache
    return x @ model.head, cache
