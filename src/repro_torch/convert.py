"""Carry weights, optimizer state, decode caches and flat buffers across
from the JAX package.

The caller hands numpy arrays (for a JAX tree,
``jax.tree_util.tree_map(np.asarray, params)``); nothing here imports
jax.  bfloat16 arrays (numpy's ``ml_dtypes`` extension type) cross as
their raw 16-bit patterns, so a bf16 flat store arrives bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """numpy array (f32, int, or bf16) -> tensor on ``device`` (``None``
    means the card), bits unchanged."""
    device = resolve_device(device)
    arr = np.asarray(arr)
    if not arr.flags.writeable:           # e.g. a view of a JAX buffer
        arr = arr.copy()
    # np.asarray(order="C"), not np.ascontiguousarray, which makes a 0-d
    # array 1-d
    arr = np.asarray(arr, order="C")
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy on the host; bf16 comes back as its ``uint16`` bit
    pattern (numpy has no bf16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def params_from_numpy(tree, device=None):
    """A tree (dicts/lists) of numpy arrays in the reference's structure ->
    the same tree of tensors on ``device`` (``None`` means the card)."""
    device = resolve_device(device)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays with exact
    dtypes, for the JAX package: bf16 leaves come back as ``ml_dtypes``'
    bfloat16 (the type JAX hands numpy), bit for bit."""
    def one(t):
        a = tensor_to_numpy(t)
        if t.dtype == torch.bfloat16:
            import ml_dtypes              # present wherever JAX is
            a = a.view(ml_dtypes.bfloat16)
        return a
    return tree_map(one, tree)


def lm_params_from_numpy(tree, cfg, device=None):
    """The JAX package's LM parameters (``init_params`` of
    ``repro.models.transformer``, as a numpy tree) -> the port's tree on
    ``device`` (``None`` means the card).  The two trees share key paths
    and the stacked ``(count, ...)`` segment layout — attention, Mamba2
    and RWKV-6 segments alike, and the empty ``{}`` of each call of a
    weight-tied shared block, whose parameters sit under ``"shared"`` —
    so the mapping is leaf for leaf; this checks that the segments stack
    ``layout(cfg)``, and that an MoE block's leaves hold
    ``cfg.moe.padded_experts`` experts with an f32 router."""
    from repro_torch.configs.base import SHARED_ATTN
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.transformer import layout
    segs = layout(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{len(tree['segments'])} segments for {cfg.name}, "
                         f"whose layout has {len(segs)}")
    if bool(cfg.shared_every) != ("shared" in tree):
        raise ValueError(f"{cfg.name}: shared_every {cfg.shared_every} but "
                         f"the tree {'has' if 'shared' in tree else 'lacks'} "
                         "a 'shared' block")
    for seg, sp in zip(segs, tree["segments"]):
        if seg.kind == SHARED_ATTN and sp:
            raise ValueError(f"a shared_attn segment holds {sorted(sp)}: its "
                             "parameters belong under 'shared'")
        for leaf in tree_leaves(sp):
            if np.shape(leaf)[0] != seg.count:
                raise ValueError(f"a {seg.kind} segment of {seg.count} "
                                 f"layers holds a leaf of shape "
                                 f"{np.shape(leaf)}")
        if "moe" in sp:
            _check_moe(sp["moe"], cfg)
    return params_from_numpy(tree, device)


_ENCDEC_LAYERS = {"enc": {"ln1", "attn", "ln2", "mlp"},
                  "dec": {"ln1", "attn", "lnx", "xattn", "ln2", "mlp"}}


def encdec_params_from_numpy(tree, cfg, device=None):
    """The JAX package's encoder-decoder parameters (``init_params`` of
    ``repro.models.encdec``, as a numpy tree) -> the port's tree on
    ``device`` (``None`` means the card).  The two trees share key paths
    (``embed``, ``enc``, ``dec``, ``enc_norm``, ``final_norm``,
    ``lm_head``), so the mapping is leaf for leaf; this checks that the
    stacked ``enc`` / ``dec`` leaves hold ``cfg.encoder_layers`` /
    ``cfg.n_layers`` layers of ``cfg``'s widths."""
    d, hd = cfg.d_model, cfg.head_dim
    attn = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    mlp = {"wi": (d, cfg.d_ff), "wg": (d, cfg.d_ff), "wo": (cfg.d_ff, d)}
    want = {"ln1": {"": (d,)}, "ln2": {"": (d,)}, "lnx": {"": (d,)},
            "attn": attn, "xattn": attn, "mlp": mlp}
    if set(tree) != {"embed", "enc", "dec", "enc_norm", "final_norm",
                     "lm_head"}:
        raise ValueError(f"not an encoder-decoder tree: keys {sorted(tree)}")
    for key, count in (("enc", cfg.encoder_layers), ("dec", cfg.n_layers)):
        if set(tree[key]) != _ENCDEC_LAYERS[key]:
            raise ValueError(f"{key} holds {sorted(tree[key])}, the "
                             f"reference's {sorted(_ENCDEC_LAYERS[key])}")
        for name in sorted(_ENCDEC_LAYERS[key]):
            spec, sub = want[name], tree[key][name]
            sub = sub if isinstance(sub, dict) else {"": sub}
            if set(sub) != set(spec) or any(
                    np.shape(sub[k]) != (count, *shape)
                    for k, shape in spec.items()):
                raise ValueError(
                    f"{key}/{name} of {cfg.name}: "
                    f"{ {k: np.shape(a) for k, a in sub.items()} }, "
                    f"expected {count} layers of {spec}")
    return params_from_numpy(tree, device)


def _check_moe(p, cfg):
    """An MoE block's stacked leaves: the router ``(L, D, E')`` in f32,
    the experts ``(L, E', ...)``, with E' = ``padded_experts``."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config, but the tree holds "
                         "MoE blocks")
    ne = cfg.moe.padded_experts
    router = np.asarray(p["router"])
    if router.dtype != np.float32 or router.shape[-1] != ne:
        raise ValueError(f"the router must be f32 over {ne} experts, got "
                         f"{router.dtype} {router.shape}")
    for k in ("wi", "wg", "wo"):
        if np.shape(p[k])[1] != ne:
            raise ValueError(f"moe/{k} holds {np.shape(p[k])[1]} experts, "
                             f"{cfg.name} {ne}")


_CACHE_KEYS = {"attn": {"k", "v"}, "shared_attn": {"k", "v"},
               "mamba2": {"h", "conv"},
               "rwkv6": {"wkv", "shift_t", "shift_c"}}


def cache_from_numpy(tree, cfg, device=None):
    """The JAX package's decode cache (``init_cache`` of
    ``repro.models.transformer`` or one a decode step returned, as a list
    of numpy dicts) -> the port's on ``device`` (``None`` means the card),
    leaf for leaf; this checks each segment's keys and leading count
    against ``layout(cfg)``."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.transformer import layout
    segs = layout(cfg)
    if len(tree) != len(segs):
        raise ValueError(f"{len(tree)} cache segments for {cfg.name}, whose "
                         f"layout has {len(segs)}")
    for seg, c in zip(segs, tree):
        count = 1 if seg.kind == "shared_attn" else seg.count
        if set(c) != _CACHE_KEYS[seg.kind] or any(
                np.shape(leaf)[0] != count for leaf in tree_leaves(c)):
            raise ValueError(f"a {seg.kind} segment of {count} layers holds "
                             f"{ {k: np.shape(a) for k, a in c.items()} }")
    return params_from_numpy(tree, device)


def cache_to_numpy(tree):
    """The port's decode cache -> the reference's tree of numpy arrays
    (bf16 leaves as ``ml_dtypes``' bfloat16, bit for bit)."""
    return params_to_numpy(tree)


def opt_state_from_numpy(state, device=None):
    """The JAX package's optimizer state as a numpy tree -> the port's on
    ``device`` (``None`` means the card): AdamW's ``{"m", "v", "t"}`` (the
    step count a 0-d int32, as both packages keep it) or SGD's
    ``{"v"}``, each moment tree in its params' structure."""
    keys = set(state)
    if keys not in ({"m", "v", "t"}, {"v"}):
        raise ValueError(f"not an AdamW or SGD state: keys {sorted(keys)}")
    if "t" in state:
        t = np.asarray(state["t"])
        if t.shape != () or t.dtype != np.int32:
            raise ValueError(f"AdamW's step count must be a 0-d int32, got "
                             f"{t.dtype} of shape {t.shape}")
    return params_from_numpy(state, device)
