"""Encoder-decoder backbone (seamless-m4t): a transformer encoder over
stubbed audio frame embeddings and a causal decoder with cross-attention,
the JAX package's ``models/encdec.py`` function for function.

The mel-spectrogram / conformer feature extractor is the stubbed modality
frontend: the caller passes precomputed ``(B, S_enc, D)`` frame
embeddings.  The tree is the reference's: ``embed`` and ``lm_head``, the
stacked ``(L, ...)`` encoder layers ``enc`` (``ln1``, ``attn``, ``ln2``,
``mlp``) and decoder layers ``dec`` (the same with ``lnx`` / ``xattn``,
the cross-attention), ``enc_norm`` and ``final_norm``.  The layers run in
a Python loop (the reference's ``lax.scan``), each stacked leaf taken
apart with one ``unbind`` (``transformer._layers``).

On the card every attention of the forward is the kernel B4
(``chunked_attention``): non-causal in the encoder, causal in the
decoder's self-attention, non-causal in the cross-attention over the
encoder's keys.  A decode step attends over its self-attention cache with
``transformer.decode_attention_dyn`` (B5, reading a device ``pos``
there) and runs the cross-attention through B4 at one query; as
the reference, it projects the encoder output to keys and values again
in every layer of every step.  ``train=True`` (``loss_fn``) runs the
ports of the reference's scans instead, on any device: B4 has no
backward.  Dropout is accepted and ignored, as the reference does.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (attention_block, attn_project_qkv,
                                         chunked_attention,
                                         cross_attention_block)
from repro_torch.models.layers import (chunked_cross_entropy, cross_entropy,
                                      dtype_of, rms_norm, rope_tables, swiglu)
from repro_torch.models.shard_ctx import lookup
from repro_torch.models.transformer import (_cache_slot, _cache_write,
                                           _init_attn_layer, _init_mlp,
                                           _layers, _normal, _pos_arg,
                                           _remat, decode_attention_dyn)


def init_params(cfg: ModelConfig, gen: torch.Generator, device=None):
    """The reference's tree on ``device`` (``None`` means the card), drawn
    from ``gen``, which must live on that device: its shapes, scales and
    dtypes (``param_dtype`` weights, f32 norms), not its bits."""
    device = resolve_device(device)
    if gen.device.type != device.type:
        raise ValueError(f"the generator lives on {gen.device}, the params "
                         f"go to {device}: draw them where they live")
    dtype = dtype_of(cfg.param_dtype)
    d, v = cfg.d_model, cfg.vocab_size
    zeros = lambda *lead: torch.zeros((*lead, d), dtype=torch.float32,
                                      device=device)
    le, ld = (cfg.encoder_layers,), (cfg.n_layers,)
    embed = _normal(gen, (v, d), 0.02, dtype)
    enc = {"ln1": zeros(*le), "attn": _init_attn_layer(gen, cfg, dtype, le),
           "ln2": zeros(*le), "mlp": _init_mlp(gen, cfg, dtype, le)}
    dec = {"ln1": zeros(*ld), "attn": _init_attn_layer(gen, cfg, dtype, ld),
           "lnx": zeros(*ld), "xattn": _init_attn_layer(gen, cfg, dtype, ld),
           "ln2": zeros(*ld), "mlp": _init_mlp(gen, cfg, dtype, ld)}
    return {"embed": embed, "enc": enc, "dec": dec, "enc_norm": zeros(),
            "final_norm": zeros(),
            "lm_head": _normal(gen, (v, d), d ** -0.5, dtype)}


def _mlp(p, h, cfg):
    return swiglu(rms_norm(h, p["ln2"], cfg.norm_eps), p["mlp"]["wi"],
                  p["mlp"]["wg"], p["mlp"]["wo"])


def _stack(cfg, body, x, stacked, count: int):
    """``x`` through ``count`` layers of ``body(p, x) -> (x, 0.0)``, each
    checkpointed for ``remat == "block"`` (the reference checkpoints
    nothing else)."""
    for p in _layers(stacked, count):
        fn = partial(body, p)
        x, _ = _remat(cfg, fn, x) if cfg.remat == "block" else fn(x)
    return x


def encode(params, cfg: ModelConfig, frames, *, train: bool = False):
    """frames: (B, S_enc, D) precomputed frontend embeddings -> the
    encoder output (B, S_enc, D) in the compute dtype."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    # one set of RoPE tables for every layer (the reference builds the
    # same values in each)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    def body(p, x):
        h = x + _bidir_attn(p["attn"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, positions, rope=rope, train=train)
        return h + _mlp(p, h, cfg), 0.0

    x = _stack(cfg, body, x, params["enc"], cfg.encoder_layers)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _bidir_attn(p, x, cfg, positions, *, rope=None, train: bool = False):
    b, s, _ = x.shape
    q, k, v = attn_project_qkv(p, x, positions, cfg, rope=rope)
    o = chunked_attention(q, k, v, causal=False, train=train)
    return o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p["wo"]


def forward(params, cfg: ModelConfig, tokens, frames, *, drop_rng=None,
            drop_rate: float = 0.0, last_only: bool = False,
            return_hidden: bool = False, train: bool = False):
    """tokens: (B, S_dec); frames: (B, S_enc, D) -> logits (B, S_dec, V)
    in the compute dtype (B, 1, V with ``last_only``; the final-normed
    hidden states with ``return_hidden``).  ``train``: the differentiable
    scans in place of B4 on the card."""
    enc_out = encode(params, cfg, frames, train=train)
    x = lookup(params["embed"], tokens).to(dtype_of(cfg.compute_dtype))
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b, s)

    def body(p, x):
        h = x + attention_block(p["attn"],
                                rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                                positions=positions, train=train)
        h = h + cross_attention_block(
            p["xattn"], rms_norm(h, p["lnx"], cfg.norm_eps), enc_out, cfg,
            train=train)
        return h + _mlp(p, h, cfg), 0.0

    x = _stack(cfg, body, x, params["dec"], cfg.n_layers)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    if return_hidden:
        return x
    return torch.einsum("bsd,vd->bsv", x, params["lm_head"])


def loss_fn(params, cfg: ModelConfig, batch, *, drop_rng=None,
            drop_rate: float = 0.0):
    """Weighted-example loss over ``batch`` {"tokens", "labels", "frames",
    optional "weight"}: the training forward (``train=True``), and for a
    vocabulary of 65536 or more the chunked CE, which never makes the
    (B, S, V) f32 logits.  Returns (loss, {"loss", "per_example"})."""
    fw = dict(drop_rng=drop_rng, drop_rate=drop_rate, train=True)
    if cfg.vocab_size >= 65536:
        hidden = forward(params, cfg, batch["tokens"], batch["frames"],
                         return_hidden=True, **fw)
        per_ex = chunked_cross_entropy(hidden, params["lm_head"],
                                       batch["labels"])
    else:
        logits = forward(params, cfg, batch["tokens"], batch["frames"], **fw)
        per_ex = cross_entropy(logits, batch["labels"])
    w = batch.get("weight")
    if w is None:
        w = torch.ones_like(per_ex)
    loss = torch.sum(per_ex * w) / torch.clamp_min(torch.sum(w), 1e-9)
    return loss, {"loss": loss, "per_example": per_ex}


# --------------------------- decode -----------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None):
    """The reference's cache on ``device`` (``None`` means the card), all
    zeros in ``dtype`` (the compute dtype when None): the decoder's
    self-attention ``k`` / ``v`` ``(L, B, max_seq, KV, hd)`` and the
    encoder output ``enc_out`` ``(B, encoder_seq, D)``, which the caller
    sets once (``encode``) before decoding."""
    device = resolve_device(device)
    dtype = dtype or dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    zeros = lambda s: torch.zeros(s, dtype=dtype, device=device)
    return {"k": zeros(shape), "v": zeros(shape),
            "enc_out": zeros((batch, cfg.encoder_seq, cfg.d_model))}


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache, tokens, pos, *,
                window: int = 0):
    """Decode one token (tokens (B, 1)) at cache position ``pos`` (a host
    int, or a 0-d integer tensor on the tokens' device, as
    ``transformer.decode_step`` takes it) against ``cache``: each layer
    writes its key and value into ``cache["k"]`` / ``cache["v"]`` in
    place, attends over them with ``window`` (0 = global), then over
    ``cache["enc_out"]``.  A chunk (T > 1) raises: the reference's step
    reshapes its attention output to (B, 1, ·), so it takes one token
    only (its RoPE positions are ``jnp.full((b, 1), pos)``), and
    ``generate`` steps this family one token at a time.  Returns (logits
    (B, 1, V) in the compute dtype, ``cache``)."""
    x = lookup(params["embed"], tokens).to(dtype_of(cfg.compute_dtype))
    b, t = x.shape[:2]
    if t != 1:
        raise ValueError(f"an encoder-decoder decode step takes one token, "
                         f"as the reference's (its output reshape is "
                         f"(B, 1, ·)); got a chunk of {t}")
    pos = _pos_arg(pos, x.device)
    slot = _cache_slot(pos, t, cache["k"].shape[2])
    positions = torch.zeros((b, 1), dtype=torch.int32, device=x.device) + pos
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    enc_out = cache["enc_out"]
    for i, p in enumerate(_layers(params["dec"], cfg.n_layers)):
        ck, cv = cache["k"][i], cache["v"][i]
        xin = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn_project_qkv(p["attn"], xin, None, cfg, rope=rope)
        _cache_write(ck, cv, k, v, pos, slot)
        o = decode_attention_dyn(q, ck, cv, pos, window)
        h = x + o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["attn"]["wo"]
        h = h + cross_attention_block(
            p["xattn"], rms_norm(h, p["lnx"], cfg.norm_eps), enc_out, cfg)
        x = h + _mlp(p, h, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return torch.einsum("bsd,vd->bsv", x, params["lm_head"]), cache
