"""The port's flat store and the plain versions of its two kernels
(``dbl_apply_flat2d``, B1; ``dbl_merge_flat2d``, B2) against the JAX
package: codec geometry and bytes exactly, the update math bit for bit
against numpy in the same float op order, and within 1e-6 of the Pallas
kernels run in interpret mode (jitted XLA:CPU reassociates by up to a few
ulp; measured gap here: <= 4.8e-7)."""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.core import flat as jflat
from repro.kernels import dbl_merge as JK
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.core import flat
from repro_torch.core.tree import tree_leaves
from repro_torch.kernels import dbl_merge as K
from repro_torch.kernels import ref as kref

torch.set_num_threads(1)

VS_JAX_ATOL = 1e-6
LR, FACTOR, MOM = 0.05, 0.8367, 0.9


def _full_width_shapes():
    """Leaf tree of the full-width ResNet-18 (stem 64, 100 classes) as
    shape structs (JAX) and meta tensors (port): geometry only."""
    cfg = jget_config("cifar-resnet18")
    shapes = jax.eval_shape(lambda k: jmodels.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    tshapes = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, dtype=torch.float32, device="meta"),
        shapes)
    return shapes, tshapes


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_flat_spec_geometry_equals_reference_full_width(store):
    jst, tst = (None, None) if store == "f32" else (jnp.bfloat16,
                                                    torch.bfloat16)
    shapes, tshapes = _full_width_shapes()
    js = jflat.flat_spec(shapes, jst)
    ts = flat.flat_spec(tshapes, tst)
    assert (ts.n, ts.rows, ts.shape, ts.pad) == (js.n, js.rows, js.shape,
                                                 js.pad)
    assert ts.offsets == js.offsets and ts.sizes == js.sizes
    assert ts.shapes == js.shapes
    assert ts.store_bytes == js.store_bytes
    assert ts.n == 11_220_132 and len(ts.sizes) == 62
    assert ts.rows == 88_064
    # leaf order: jax.tree_util's (dict keys sorted, lists in order)
    paths = jax.tree_util.tree_map_with_path(
        lambda p, _: jax.tree_util.keystr(p), shapes)
    order = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert tree_leaves(paths) == order
    assert order[0] == "['bn0']['bias']" and order[-1] == "['stem']"
    assert flat.padded_rows(ts.n, tst or torch.float32) == \
        jflat.padded_rows(js.n, js.store_dtype)


@functools.lru_cache(maxsize=1)
def _width8_params():
    cfg = replace(jget_config("cifar-resnet18"), d_model=8, vocab_size=10)
    init = jax.jit(lambda k: jmodels.init_params(cfg, k))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(1)))


def _bits(x):
    """Bytes of a buffer (numpy / jax / torch), bf16 as int16 patterns."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.int16) if x.dtype.name == "bfloat16" else x).tobytes()


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_ravel_byte_equal_and_round_trip(store):
    jst, tst = (None, None) if store == "f32" else (jnp.bfloat16,
                                                    torch.bfloat16)
    p = _width8_params()
    tp = params_from_numpy(p, "cpu")
    js = jflat.flat_spec(jax.tree_util.tree_map(jnp.asarray, p), jst)
    ts = flat.flat_spec(tp, tst)
    buf = ts.ravel(tp)
    assert buf.shape == js.shape and buf.is_contiguous()
    assert _bits(buf) == _bits(js.ravel(p))
    assert _bits(ts.ravel_master(tp)) == _bits(js.ravel_master(p))
    # round trip: exact for f32; bf16 leaves come back as the rounded f32
    back = ts.unravel(ts.ravel_master(tp))
    for a, b in zip(tree_leaves(back), tree_leaves(tp)):
        assert torch.equal(a, b)
    jback = js.unravel(js.ravel(p))
    for a, b in zip(tree_leaves(ts.unravel(buf)),
                    jax.tree_util.tree_leaves(jback)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # stacked codec
    st = ts.ravel_stacked([tp, tp])
    assert st.shape == (2,) + ts.shape
    assert _bits(st) == _bits(js.ravel_stacked([p, p]))
    assert ts.zeros_stacked(3, "cpu").shape == js.zeros_stacked(3).shape
    fp = flat.FlatParams.from_tree(tp, ts)
    assert (fp.master is None) == (store == "f32")
    for a, b in zip(tree_leaves(fp.to_tree()), tree_leaves(tp)):
        assert torch.equal(a, b)


def test_unravel_returns_views_and_flat_gradients():
    p = params_from_numpy(_width8_params(), "cpu")
    ts = flat.flat_spec(p)
    buf = ts.ravel(p).requires_grad_()
    tree = ts.unravel(buf)
    leaves = tree_leaves(tree)
    base = buf.untyped_storage().data_ptr()
    assert all(l.untyped_storage().data_ptr() == base for l in leaves)
    loss = sum((l * (i + 1)).sum() for i, l in enumerate(leaves))
    (g,) = torch.autograd.grad(loss, buf)
    want = torch.cat([torch.full((sz,), float(i + 1))
                      for i, sz in enumerate(ts.sizes)]
                     + [torch.zeros(ts.pad)]).view(ts.shape)
    assert torch.equal(g, want)
    with torch.no_grad():
        buf[0, 0] = 123.0
    assert float(tree_leaves(ts.unravel(buf))[0].reshape(-1)[0]) == 123.0


# --------------------------- plain kernel versions --------------------------
def _inputs(rows, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(rows, 128).astype(np.float32)
            for k in ("p", "m", "gl", "gs", "v")}


def _np_expected(kernel, variant, x):
    """numpy, float32, the kernels' float op order."""
    f32 = np.float32
    if kernel == "dbl_merge_flat2d":
        inv = f32(1.0 / (1.0 + FACTOR))
        g = (x["gl"] + f32(FACTOR) * x["gs"]) * inv
    else:
        g = x["gl"]
    out = {}
    if "vel" in variant:
        g = out["v"] = f32(MOM) * x["v"] + g
    w = x["m"] if "master" in variant else x["p"]
    w = w - f32(LR) * g
    if "master" in variant:
        out["m"] = w
        out["shadow"] = w      # rounded to bf16 by the caller's compare
    else:
        out["p"] = w
    return out


def _run_port(kernel, variant, x):
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    kw = {"lr": LR}
    if "vel" in variant:
        kw.update(vel2=t["v"], momentum=MOM)
    if "master" in variant:
        t["shadow"] = t["p"].to(torch.bfloat16)     # old value never read
        kw["master2"] = t["m"]
        p2 = t["shadow"]
    else:
        p2 = t["p"]
    if kernel == "dbl_merge_flat2d":
        out = K.dbl_merge_flat2d(p2, t["gl"], t["gs"], factor=FACTOR, **kw)
    else:
        out = K.dbl_apply_flat2d(p2, t["gl"], **kw)
    out = out if isinstance(out, tuple) else (out,)
    assert out[0] is p2                     # in place, reference order
    return t, out


def _run_jax(kernel, variant, x):
    kw = {"lr": LR, "interpret": True}
    if "vel" in variant:
        kw.update(vel2=jnp.asarray(x["v"]), momentum=MOM)
    if "master" in variant:
        kw["master2"] = jnp.asarray(x["m"])
        p2 = jnp.asarray(x["p"]).astype(jnp.bfloat16)
    else:
        p2 = jnp.asarray(x["p"])
    if kernel == "dbl_merge_flat2d":
        out = JK.dbl_merge_flat2d(p2, jnp.asarray(x["gl"]),
                                  jnp.asarray(x["gs"]), factor=FACTOR, **kw)
    else:
        out = JK.dbl_apply_flat2d(p2, jnp.asarray(x["gl"]), **kw)
    out = out if isinstance(out, tuple) else (out,)
    names = ["p"] if "master" not in variant else ["shadow", "m"]
    if "vel" in variant:
        names.append("v")
    return dict(zip(names, (np.asarray(o) for o in out)))


@pytest.mark.parametrize("rows", [64, 3072])
@pytest.mark.parametrize("variant", K.VARIANTS)
@pytest.mark.parametrize("kernel", K.KERNELS)
def test_plain_kernel_matches_numpy_and_jax(kernel, variant, rows):
    x = _inputs(rows, seed=rows + len(variant))
    K.reset_counts()
    t, out = _run_port(kernel, variant, x)
    # one run of the plain version per call; no kernel launch on the CPU
    assert K.plain_count(kernel, variant) == 1
    assert K.plain_count() == 1 and K.launch_count() == 0
    want = _np_expected(kernel, variant, x)
    j = _run_jax(kernel, variant, x)
    for name, w in want.items():
        got = t[name]
        if name == "shadow":
            assert got.dtype == torch.bfloat16
            # the shadow is exactly the rounded master
            assert torch.equal(got, t["m"].to(torch.bfloat16))
            jsh = tensor_from_numpy(j["shadow"], "cpu")
            diff = (got.float() - jsh.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                t["m"].abs().clamp_min(1e-30))) - 7)
            assert bool((diff <= ulp).all())
            continue
        assert np.array_equal(got.numpy(), w), name      # bit for bit
        gap = float(np.max(np.abs(got.numpy() - j[name])))
        assert gap <= VS_JAX_ATOL, (name, gap)


def test_plain_merge_equals_reference_oracle_and_front_ends():
    x = _inputs(16, seed=3)
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    want = kref.dbl_merge_ref(t["p"], t["gl"], t["gs"], factor=FACTOR,
                              lr=LR)
    unf = kref.dbl_merge_unfused({"a": t["p"]}, {"a": t["gl"]},
                                 {"a": t["gs"]}, factor=FACTOR, lr=LR)
    got = K.dbl_merge_flat2d(t["p"].clone(), t["gl"], t["gs"], factor=FACTOR,
                             lr=LR)
    assert torch.allclose(got, want, atol=1e-6, rtol=0)
    assert torch.allclose(unf["a"], want, atol=1e-6, rtol=0)
    tree = {"w": t["p"][:3, :5].clone(), "b": [t["p"][0, :7].clone()]}
    gl = {"w": t["gl"][:3, :5], "b": [t["gl"][0, :7]]}
    gs = {"w": t["gs"][:3, :5], "b": [t["gs"][0, :7]]}
    K.reset_counts()
    new = K.dbl_merge_tree(tree, gl, gs, factor=FACTOR, lr=LR)
    assert K.plain_count("dbl_merge_flat2d") == 1      # one sweep, not per leaf
    for a, p, g1, g2 in zip(tree_leaves(new), tree_leaves(tree),
                            tree_leaves(gl), tree_leaves(gs)):
        assert torch.allclose(a, kref.dbl_merge_ref(p, g1, g2, factor=FACTOR,
                                                    lr=LR), atol=1e-6, rtol=0)


def test_wrapper_rejects_bad_buffers():
    p2 = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="rows, 128"):
        K.dbl_apply_flat2d(torch.zeros(8, 64), torch.zeros(8, 64), lr=0.1)
    with pytest.raises(ValueError, match="float32"):
        K.dbl_apply_flat2d(p2, torch.zeros(8, 128, dtype=torch.float64),
                           lr=0.1)
    with pytest.raises(ValueError, match="bf16 shadow"):
        K.dbl_apply_flat2d(p2, torch.zeros(8, 128), lr=0.1,
                           master2=torch.zeros(8, 128))
    with pytest.raises(ValueError, match="shape"):
        K.dbl_merge_flat2d(p2, torch.zeros(8, 128), torch.zeros(16, 128),
                           factor=1.0, lr=0.1)
    with pytest.raises(ValueError, match="contiguous"):
        K.dbl_apply_flat2d(p2, torch.zeros(128, 8).t(), lr=0.1)
