"""The training form of RWKV-6's WKV scan (``models.rwkv6.wkv6_scan``):
chunks of the reference's length, their pairs of tokens a few batched
products under ``torch.utils.checkpoint`` and the state stepped once a
chunk, against the reference's ``wkv6_scan`` (a ``lax.scan`` over chunks
with a ``jax.checkpoint`` body, the same ``chunk``) and a float64
evaluation of the per-token recurrence, on the CPU.

Values, the final state and the gradients of r, k, v, w, u and the
initial state (of a random linear functional of y and the state), at S =
45 and 256 (chunk 64: one ragged-free chunk of 45, four of 64), 13 with
chunk 4 (no divisor but 1) and 45 with chunk 16 (chunks of 15); decays in
[0.3, 1), within 1e-3 of 1, and log-uniform down to 1e-20 a step; from a
zero and from a random state.

Each band is stated from the reference's own distance to float64 on the
same draw, floored at one f32 ulp of the quantity's largest value (the
reference sometimes lands within less): ``BAND_TIMES`` of it.  Over 144
draws (before this file) the port's distance was at most 3.3 times that
for every quantity but w's gradient, and 15.2 times for w's: the chunked
form carries the decays as sums of ``log w``, and an exponent of size
|log w| (46 at 1e-20) holds its value to |log w| f32 ulps, which the
gradient with respect to w (that of ``log w`` over w) hands on in full.
At decays near 1 the chunked form is nearer float64 than the reference
(a per-step product loses an ulp a step).  ROADMAP C10 suspected the
reference's distance: it is this recurrence's own f32 rounding, and the
port's is of the same size.

The op count: one rwkv6-7b layer's training forward and backward at S =
4,096 on meta tensors, counted by a ``TorchDispatchMode``, against the
per-token form (``ref.wkv6_ref`` in the scan's place) counted the same
way: 2,643 and 270,614 dispatches under torch 2.13, a 102nd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import rwkv6 as jrwkv6
from repro_torch.configs import get_config
from repro_torch.kernels.ref import wkv6_ref
from repro_torch.models import rwkv6

torch.set_num_threads(1)

NAMES = ("y", "state_out", "r", "k", "v", "w", "u", "state")
BAND_TIMES = dict.fromkeys(NAMES, 4.0) | {"w": 32.0}
B, H, KD = 2, 3, 8


def _draw(seed, s, decay, from_state):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, s, H, KD)).astype(np.float32)
               for _ in range(3))
    if decay == "mid":
        w = rng.uniform(0.3, 1.0, (B, s, H, KD))
    elif decay == "near_one":
        w = 1 - rng.uniform(0, 1e-3, (B, s, H, KD))
    else:                                   # log-uniform down to 1e-20
        w = np.exp(rng.uniform(np.log(1e-20), 0, (B, s, H, KD)))
    u = rng.normal(size=(H, KD)).astype(np.float32)
    st = (rng.normal(size=(B, H, KD, KD)) if from_state
          else np.zeros((B, H, KD, KD))).astype(np.float32)
    gy = rng.normal(size=(B, s, H, KD)).astype(np.float32)
    gs = rng.normal(size=(B, H, KD, KD)).astype(np.float32)
    return (r, k, v, w.astype(np.float32), u, st), gy, gs


def _f64_scan(r, k, v, w, u, S):
    """The recurrence token by token in whatever dtype it is given."""
    ys = []
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               S + u[None, :, :, None] * kv))
        S = S * w[:, t, ..., None] + kv
    return torch.stack(ys, 1), S


def _torch_run(fn, xs, gy, gs, dtype):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in xs]
    y, S = fn(*ts)
    ((y * torch.from_numpy(gy).to(dtype)).sum()
     + (S * torch.from_numpy(gs).to(dtype)).sum()).backward()
    return [y.detach().double().numpy(), S.detach().double().numpy()] + \
        [t.grad.double().numpy() for t in ts]


def _jax_run(xs, gy, gs, chunk):
    def loss(r, k, v, w, u, st):
        y, S = jrwkv6.wkv6_scan(r, k, v, w, u, st, chunk=chunk)
        return (y * gy).sum() + (S * gs).sum(), (y, S)
    grads, (y, S) = jax.grad(loss, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, xs))
    return [np.asarray(a, np.float64) for a in (y, S, *grads)]


@pytest.mark.parametrize("from_state", [False, True], ids=["zero", "state"])
@pytest.mark.parametrize("decay", ["mid", "near_one", "strong"])
@pytest.mark.parametrize("s,chunk", [(45, 64), (13, 4), (256, 64), (45, 16)])
def test_chunked_scan_matches_reference_and_float64(s, chunk, decay,
                                                    from_state):
    """y, the final state and the six gradients within BAND_TIMES of the
    reference's own distance to float64 (floored at an ulp of the largest
    value), and within that plus the reference's distance of the
    reference itself."""
    xs, gy, gs = _draw(s * 31 + chunk, s, decay, from_state)
    port = _torch_run(lambda r, k, v, w, u, st: rwkv6.wkv6_scan(
        r, k, v, w, u, st, chunk=chunk), xs, gy, gs, torch.float32)
    exact = _torch_run(_f64_scan, xs, gy, gs, torch.float64)
    ref = _jax_run(xs, gy, gs, chunk)
    assert port[0].shape == (B, s, H, KD)
    for name, p, j, e in zip(NAMES, port, ref, exact):
        ref_gap = np.abs(j - e).max()
        band = BAND_TIMES[name] * max(ref_gap, np.abs(e).max() * 2.0 ** -23)
        assert np.abs(p - e).max() <= band, name
        assert np.abs(p - j).max() <= band + ref_gap, name


def test_chunk_length_is_the_references():
    """``min(chunk, S)``, lowered until it divides S."""
    assert [rwkv6._chunk_len(s, c) for s, c in
            ((45, 64), (13, 4), (256, 64), (45, 16), (4096, 64), (1, 64))] \
        == [45, 1, 64, 15, 64, 1]


def test_no_overflow_at_the_strongest_decay():
    """Decays of 1e-20 (and w = 0, which the scan reads as the smallest
    f32 normal) over 64 tokens: finite values and gradients, the state
    after a chunk that of its last token alone."""
    xs, gy, gs = _draw(5, 64, "strong", True)
    r, k, v, w, u, st = xs
    w = np.full_like(w, 1e-20)
    w[:, 10] = 0.0
    out = _torch_run(lambda *a: rwkv6.wkv6_scan(*a, chunk=64),
                     (r, k, v, w, u, st), gy, gs, torch.float32)
    assert all(np.isfinite(a).all() for a in out)
    last = np.einsum("bhk,bhv->bhkv", k[:, -1], v[:, -1])
    np.testing.assert_allclose(out[1], last, rtol=1e-6, atol=1e-6)


class _Dispatches(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _layer_dispatches(monkeypatch, s, per_token):
    """Ops one rwkv6-7b layer (full width, one row, bf16) dispatches over
    its training forward (``time_mix(train=True)``, ``channel_mix``) and
    backward, on meta tensors."""
    if per_token:
        monkeypatch.setattr(rwkv6, "wkv6_scan", lambda r, k, v, w, u, state:
                            wkv6_ref(r, k, v, w, u, state=state,
                                     out_dtype=torch.float32))
    cfg = get_config("rwkv6-7b")
    p = rwkv6.init_rwkv6(lambda shape, sc, dt: torch.empty(
        shape, dtype=dt, device="meta"), cfg, torch.bfloat16)
    p = {k: t.requires_grad_() for k, t in p.items()}
    x = torch.empty(1, s, cfg.d_model, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    with _Dispatches() as count:
        y, _, _ = rwkv6.time_mix(p, x, cfg, train=True)
        y, _ = rwkv6.channel_mix(p, y, cfg)
        y.float().sum().backward()
    monkeypatch.undo()
    return count.n


def test_layer_dispatches_a_twentieth_of_the_per_token_form(monkeypatch):
    """At S = 4,096 (64 chunks) the chunked form dispatches at most a
    twentieth of the per-token form's ops (2,643 and 270,614 in torch
    2.13)."""
    chunked = _layer_dispatches(monkeypatch, 4096, per_token=False)
    per_token = _layer_dispatches(monkeypatch, 4096, per_token=True)
    assert 20 * chunked <= per_token, (chunked, per_token)
    # O(S / Q): twice the sequence, about twice the chunked count
    assert _layer_dispatches(monkeypatch, 8192, per_token=False) \
        <= 2 * chunked
