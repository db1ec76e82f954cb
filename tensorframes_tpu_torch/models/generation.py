"""Autoregressive decoding for the transformer family (causal LM).

The reference package's ``models/generation.py``: a dense static-shape KV
cache for ``generate`` (prefill the prompt as one chunk, then one cached
step per token), the cache-free ``generate_naive`` oracle, and the paged
int8 KV pool with the two step functions the serving decode engine runs
(``paged_prefill_fn``, ``paged_decode_step_fn``). Logits tie to the
token embedding (no separate LM head); greedy decoding is an argmax in
the step.

PyTorch runs eagerly, so there is no ``jit``/``scan``: the decode loop is
a Python loop. The caches and the paged pool are dicts of tensors that
the step functions **update in place** (the reference returns new
arrays); they still return the pool, so the call shapes match.

On CUDA tensors the decode step launches the hand-written paged
decode-attention kernel once per layer and every weight product of a
quantized model launches the int8-weight kernel; on CPU tensors both use
their plain versions. ``paged_decode_step_fn(plain=True)`` takes the plain
versions on any device (the card's check of kernel against plain).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..kernels.decode_attention import NEG, paged_attention_reference, paged_decode_attention
from ..ops.quantize import matmul, matmul_plain, quantize
from .transformer import TransformerConfig, _layer_norm, _mlp


def gpt_tiny(**kw) -> TransformerConfig:
    """A small causal config for tests/demos."""
    kw.setdefault("vocab_size", 97)
    kw.setdefault("hidden", 32)
    kw.setdefault("num_heads", 4)
    kw.setdefault("num_layers", 2)
    kw.setdefault("max_seq_len", 48)
    kw.setdefault("dtype", torch.float32)
    kw.setdefault("causal", True)
    return TransformerConfig(**kw)


def gpt_small(**kw) -> TransformerConfig:
    """GPT-2-small-shaped causal config (the decode server's model)."""
    kw.setdefault("vocab_size", 32_000)
    kw.setdefault("hidden", 768)
    kw.setdefault("num_heads", 12)
    kw.setdefault("num_layers", 12)
    kw.setdefault("max_seq_len", 1024)
    kw.setdefault("causal", True)
    return TransformerConfig(**kw)


def _device(params) -> torch.device:
    return params["embed"]["tok"].device


def _sqrt(hd: int, device) -> torch.Tensor:
    # a device scalar: true division, as the reference's f32 divide
    return torch.full((), math.sqrt(hd), dtype=torch.float32, device=device)


def _softmax(scores: torch.Tensor) -> torch.Tensor:
    """``exp(s - max) / sum`` over the last axis, as ``jax.nn.softmax``."""
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(
    cfg: TransformerConfig,
    batch: int,
    length: Optional[int] = None,
    quant: bool = False,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Static-shape cache on ``device`` (default ``config.device``): k/v
    per layer, ``[L, b, heads, length, hd]``.

    ``quant=True`` stores k/v as int8 with one f32 scale per cache slot
    (absmax over head_dim, ``[..., 1]``); the scales fold into the scores
    and the softmax weights, so no dequantized copy is made."""
    device = resolve_device(device)
    S = length or cfg.max_seq_len
    shape = (cfg.num_layers, batch, cfg.num_heads, S, cfg.head_dim)
    if quant:
        sshape = shape[:-1] + (1,)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.ones(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.ones(sshape, dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _quantize_slots(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-slot quantization over the trailing head_dim:
    ``[b, nh, t, hd]`` → (int8 values, f32 scales ``[b, nh, t, 1]``), by the
    shared :func:`~tensorframes_tpu_torch.ops.quantize.quantize` scheme."""
    qt = quantize(x.float(), channel_axis=(0, 1, 2))
    return qt.q, qt.scale


def _forward_cached(
    cfg: TransformerConfig,
    params: Dict,
    tokens: torch.Tensor,   # [b, t] chunk (prompt prefill or one decode step)
    cache: Dict,
    offset: int,            # positions [offset, offset + t) being written
) -> Tuple[torch.Tensor, Dict]:
    """Run a chunk through the decoder, writing its k/v into ``cache`` in
    place and attending over the cache's whole horizon with the validity
    mask ``j <= offset + i``. Returns (hidden states ``[b, t, h]``, cache)."""
    b, t = tokens.shape
    h, nh, hd = cfg.hidden, cfg.num_heads, cfg.head_dim
    dev = tokens.device
    S = cache["k"].shape[3]
    x = params["embed"]["tok"][tokens].to(cfg.dtype)
    pos = offset + torch.arange(t, device=dev)
    x = x + params["embed"]["pos"][pos].to(cfg.dtype)
    valid = torch.arange(S, device=dev)[None, :] <= pos[:, None]
    quant = "k_scale" in cache
    sl = slice(offset, offset + t)
    for li, p in enumerate(params["layers"]):
        y = _layer_norm(x, **p["ln1"])
        qkv = matmul(y, p["attn"]["qkv"]).reshape(b, t, 3, nh, hd)
        q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))  # [b, nh, t, hd]
        if quant:
            k, k_s = _quantize_slots(k)
            v, v_s = _quantize_slots(v)
            cache["k_scale"][li, :, :, sl] = k_s
            cache["v_scale"][li, :, :, sl] = v_s
        cache["k"][li, :, :, sl] = k
        cache["v"][li, :, :, sl] = v
        ck, cv = cache["k"][li], cache["v"][li]
        if quant:
            ck_s = cache["k_scale"][li][..., 0]      # [b, nh, S]
            cv_s = cache["v_scale"][li][..., 0]
            ck, cv = ck.to(cfg.dtype), cv.to(cfg.dtype)
        scores = torch.einsum("bntd,bnsd->bnts", q.float(), ck.float()) / _sqrt(hd, dev)
        if quant:
            scores = scores * ck_s[:, :, None, :]
        scores = scores.masked_fill(~valid[None, None], NEG)
        w = _softmax(scores)
        if quant:
            w = (w * cv_s[:, :, None, :]).to(cfg.dtype)
        else:
            w = w.to(cfg.dtype)
        ctx = torch.einsum("bnts,bnsd->bntd", w.float(), cv.float()).to(cfg.dtype)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, t, h)
        x = x + matmul(ctx, p["attn"]["out"])
        x = x + _mlp(p["mlp"], _layer_norm(x, **p["ln2"]))
    return _layer_norm(x, **params["final_ln"]), cache


def _logits(cfg: TransformerConfig, params: Dict, hs: torch.Tensor) -> torch.Tensor:
    """Weight-tied LM head: hidden ``[.., h]`` → logits ``[.., vocab]`` (f32)."""
    return hs.float() @ params["embed"]["tok"].float().T


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------

def generate(
    cfg: TransformerConfig,
    params: Dict,
    prompts,                 # [b, prompt_len] int tokens
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
    kv_quant: bool = False,
) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations on the parameters' device:
    greedy when ``temperature == 0``, else categorical sampling from a
    ``torch.Generator`` seeded with ``seed`` (its draws differ from the
    reference's ``jax.random``). Prefill runs the prompt as one chunk,
    then one cached step per token. Returns int32 ``[b, max_new_tokens]``.
    ``kv_quant=True`` keeps the cache int8."""
    dev = _device(params)
    prompts = _as_index(prompts, dev)
    b, plen = prompts.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    if plen + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt_len({plen}) + max_new_tokens({max_new_tokens}) exceeds "
            f"max_seq_len({cfg.max_seq_len})"
        )
    gen = None
    if temperature > 0.0:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
    cache = init_kv_cache(cfg, b, length=plen + max_new_tokens, quant=kv_quant, device=dev)
    hs, cache = _forward_cached(cfg, params, prompts, cache, 0)
    tok = _pick(cfg, params, hs[:, -1], temperature, gen)
    out = [tok]
    for i in range(max_new_tokens - 1):
        hs, cache = _forward_cached(cfg, params, tok[:, None].long(), cache, plen + i)
        tok = _pick(cfg, params, hs[:, -1], temperature, gen)
        out.append(tok)
    return torch.stack(out, dim=1).to(torch.int32)


def _pick(cfg, params, h_last, temperature, gen):
    logits = _logits(cfg, params, h_last)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def generate_naive(
    cfg: TransformerConfig,
    params: Dict,
    prompts,
    max_new_tokens: int,
) -> torch.Tensor:
    """Cache-free greedy reference: re-run the full forward per token
    (O(n²) per token; the correctness oracle for the cached path)."""
    from . import transformer as tr

    toks = _as_index(prompts, _device(params))
    plen = toks.shape[1]
    for _ in range(max_new_tokens):
        hs = tr.forward(cfg, params, toks)
        nxt = torch.argmax(_logits(cfg, params, hs[:, -1]), dim=-1)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    return toks[:, plen:].to(torch.int32)


# ---------------------------------------------------------------------------
# Paged KV: the pool layout and the step functions of the decode engine
# (serving/decode.py). Same int8-KV scheme as init_kv_cache(quant=True),
# laid out page-major so fixed-size pages are shared by many sequences
# through per-sequence page tables.
# ---------------------------------------------------------------------------

def init_paged_kv(
    cfg: TransformerConfig, num_pages: int, page_size: int, device=None
) -> Dict[str, torch.Tensor]:
    """The paged int8 KV pool on ``device`` (default ``config.device``)
    as columnar state: page-major tensors
    ``[num_pages, layers, heads, page_size, head_dim]`` (int8 k/v, f32
    per-slot scales ``[..., 1]``). Page 0 is the reserved NULL page:
    padding slots and masked prefill positions write there, and the
    attention masks guarantee it is never read unmasked."""
    if num_pages < 2:
        raise ValueError(
            f"num_pages must be >= 2 (page 0 is the reserved null page), got {num_pages}"
        )
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    device = resolve_device(device)
    shape = (num_pages, cfg.num_layers, cfg.num_heads, page_size, cfg.head_dim)
    sshape = shape[:-1] + (1,)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.ones(sshape, dtype=torch.float32, device=device),
        "v_scale": torch.ones(sshape, dtype=torch.float32, device=device),
    }


def paged_kv_nbytes(pool: Dict[str, torch.Tensor]) -> int:
    """Pool footprint in bytes (the budget eviction exists to honor)."""
    return sum(a.numel() * a.element_size() for a in pool.values())


def _as_index(a, device) -> torch.Tensor:
    """Token ids, positions or page tables (numpy or tensor) as int64 on
    ``device``."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(a), device=device).long()


def paged_prefill_fn(cfg: TransformerConfig, page_size: int, max_pages: int):
    """Build the prefill step for one sequence: ``fn(params, pool,
    tokens[T], length, table[max_pages]) -> (pool, first_token)``.

    ``tokens`` is the prompt padded to a ladder bucket T; ``length`` the
    true prompt length. Writes positions ``[0, length)`` into the
    sequence's pages through ``table`` (padding positions route to the
    null page; the pool is updated in place), attends causally within the
    chunk over the QUANTIZED k/v — exactly what decode steps will read
    back — and returns the greedy first token (an int32 0-d tensor on the
    pool's device)."""

    def prefill(params, pool, tokens, length, table):
        dev = pool["k"].device
        tokens = _as_index(tokens, dev)
        table = _as_index(table, dev)
        length = int(length)
        (T,) = tokens.shape
        h, nh, hd = cfg.hidden, cfg.num_heads, cfg.head_dim
        tpos = torch.arange(T, device=dev)
        x = params["embed"]["tok"][tokens].to(cfg.dtype)
        x = x + params["embed"]["pos"][tpos].to(cfg.dtype)
        valid = tpos < length
        # per-position pool coordinates; masked positions → null page 0
        pg = torch.where(valid, table[torch.clamp(tpos // page_size, max=max_pages - 1)], 0)
        off = tpos % page_size
        causal = tpos[None, :] <= tpos[:, None]      # [T, T]
        for li, p in enumerate(params["layers"]):
            y = _layer_norm(x, **p["ln1"])
            qkv = matmul(y, p["attn"]["qkv"]).reshape(T, 3, nh, hd)
            q, k, v = (qkv[:, i].permute(1, 0, 2) for i in range(3))   # [nh, T, hd]
            kq, ks = _quantize_slots(k[None])        # [1, nh, T, hd]
            vq, vs = _quantize_slots(v[None])
            kq, ks, vq, vs = kq[0], ks[0], vq[0], vs[0]
            # one scatter per tensor per layer; duplicate null-page
            # indices are plain stores (never accumulate)
            pool["k"][pg, li, :, off] = kq.permute(1, 0, 2)
            pool["v"][pg, li, :, off] = vq.permute(1, 0, 2)
            pool["k_scale"][pg, li, :, off] = ks.permute(1, 0, 2)
            pool["v_scale"][pg, li, :, off] = vs.permute(1, 0, 2)
            kd = kq.to(cfg.dtype)
            scores = torch.einsum("ntd,nsd->nts", q.float(), kd.float()) / _sqrt(hd, dev)
            scores = scores * ks[..., 0][:, None, :]
            scores = scores.masked_fill(~causal[None], NEG)
            w = _softmax(scores)
            w = (w * vs[..., 0][:, None, :]).to(cfg.dtype)
            ctx = torch.einsum("nts,nsd->ntd", w.float(), vq.to(cfg.dtype).float())
            ctx = ctx.to(cfg.dtype).permute(1, 0, 2).reshape(T, h)
            x = x + matmul(ctx, p["attn"]["out"])
            x = x + _mlp(p["mlp"], _layer_norm(x, **p["ln2"]))
        hs = _layer_norm(x, **params["final_ln"])
        first = torch.argmax(_logits(cfg, params, hs[length - 1]), dim=-1).to(torch.int32)
        return pool, first

    return prefill


def paged_decode_step_fn(cfg: TransformerConfig, page_size: int, max_pages: int,
                         logits_rows: Optional[int] = None, plain: bool = False):
    """Build the batched decode step: ``fn(params, pool, tokens[S], pos[S],
    tables[S, max_pages]) -> (pool, next_tokens[S])``.

    One token per running slot: writes each slot's new k/v into its
    current page (the pool in place; padding slots carry all-null tables
    and write into the null page), then attends each slot's pages masked
    to ``j <= pos`` — write before attend, so a slot attends its own new
    token. On CUDA the attention is the paged decode-attention kernel and
    the quantized weight products the int8 kernel; ``plain=True`` uses
    their plain versions instead. Every slot's row is computed on its own,
    which makes a batched step bit-identical per slot to a solo step.

    ``logits_rows``, when given, pads the f32 logits product (a plain
    ``torch.matmul``) to that many rows, so the library sees one shape
    whatever the slot count. ``fn(..., return_logits=True)`` also returns
    the ``[S, vocab]`` logits."""
    mm = matmul_plain if plain else matmul
    attend = paged_attention_reference if plain else paged_decode_attention

    def step(params, pool, tokens, pos, tables, return_logits=False):
        dev = pool["k"].device
        tokens = _as_index(tokens, dev)
        pos = _as_index(pos, dev)
        tables = _as_index(tables, dev)
        (S,) = tokens.shape
        h, nh, hd = cfg.hidden, cfg.num_heads, cfg.head_dim
        x = params["embed"]["tok"][tokens].to(cfg.dtype)
        x = x + params["embed"]["pos"][pos].to(cfg.dtype)
        wpg = tables.gather(1, torch.clamp(pos // page_size, max=max_pages - 1)[:, None])[:, 0]
        woff = pos % page_size
        tables32, pos32 = tables.to(torch.int32), pos.to(torch.int32)
        for li, p in enumerate(params["layers"]):
            y = _layer_norm(x, **p["ln1"])
            qkv = mm(y, p["attn"]["qkv"]).reshape(S, 3, nh, hd)
            q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]          # [S, nh, hd]
            kq, ks = _quantize_slots(k[:, :, None, :])           # [S, nh, 1, hd]
            vq, vs = _quantize_slots(v[:, :, None, :])
            pool["k"][wpg, li, :, woff] = kq[:, :, 0]
            pool["v"][wpg, li, :, woff] = vq[:, :, 0]
            pool["k_scale"][wpg, li, :, woff] = ks[:, :, 0]
            pool["v_scale"][wpg, li, :, woff] = vs[:, :, 0]
            ctx = attend(q, pool["k"], pool["v"], pool["k_scale"], pool["v_scale"],
                         li, tables32, pos32).reshape(S, h)
            x = x + mm(ctx, p["attn"]["out"])
            x = x + _mlp(p["mlp"], _layer_norm(x, **p["ln2"]), mm)
        hs = _layer_norm(x, **params["final_ln"])
        if logits_rows is not None and S < logits_rows:
            hs = torch.cat([hs, hs.new_zeros((logits_rows - S, h))])
        logits = _logits(cfg, params, hs)[:S]
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if return_logits:
            return pool, nxt, logits
        return pool, nxt

    return step


def generate_program(
    cfg: TransformerConfig,
    params: Dict,
    max_new_tokens: int,
    temperature: float = 0.0,
    seed: int = 0,
    kv_quant: bool = False,
):
    """map_blocks program: prompt block ``[n, plen]`` → ``{"generated":
    [n, max_new_tokens]}`` int32. When sampling, the sum of the block's
    tokens salts the seed, so different blocks draw different noise."""
    from torch._subclasses.fake_tensor import is_fake

    def program(prompts):
        salt = 0
        if temperature > 0.0 and not is_fake(prompts):
            salt = int(prompts.to(torch.int64).sum())
        return {
            "generated": generate(
                cfg, params, prompts, max_new_tokens, temperature, seed + salt,
                kv_quant=kv_quant,
            )
        }

    return program
