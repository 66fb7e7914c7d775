"""The port's ResNet-18 against the JAX reference on the same parameters
and images (width 8, 10 classes, batch 6).  24 and 32 px pad (0, 1) at
stride 2 under XLA's SAME rule; 20 px reaches (0, 1) at 20 -> 10 and
(1, 1) at 5 -> 3.  Tolerances are f32 conv reassociation bands; measured
gaps: logits 2.9e-6, loss 4.8e-7, flat gradient 7.2e-6."""
import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import models as jmodels
from repro.configs import get_config as jget_config
from repro.core.flat import flat_spec as jflat_spec
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.flat import flat_spec
from repro_torch.models.resnet import _same_pads

torch.set_num_threads(1)

LOGITS_ATOL, LOSS_ATOL, GRAD_ATOL = 1e-5, 1e-6, 2e-5
SIZES = [24, 32, 20]


@functools.lru_cache(maxsize=1)
def _init(seed):
    jcfg = replace(jget_config("cifar-resnet18"), d_model=8, vocab_size=10)
    init = jax.jit(lambda k: jmodels.init_params(jcfg, k))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(seed)))


def _setup(size, weighted, seed=0):
    jcfg = replace(jget_config("cifar-resnet18"), d_model=8, vocab_size=10)
    cfg = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
    p = _init(seed)
    rng = np.random.RandomState(seed + size)
    batch = {"images": rng.rand(6, size, size, 3).astype(np.float32),
             "labels": rng.randint(0, 10, 6).astype(np.int32)}
    if weighted:
        batch["weight"] = np.array([1, 1, 0.7, 0.7, 0.0, 0.7], np.float32)
    return jcfg, cfg, p, batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_same_pads_match_xla():
    assert _same_pads(32, 3, 2) == (0, 1) and _same_pads(24, 3, 2) == (0, 1)
    assert _same_pads(5, 3, 2) == (1, 1) and _same_pads(7, 3, 2) == (1, 1)
    assert _same_pads(32, 3, 1) == (1, 1) and _same_pads(16, 1, 2) == (0, 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_forward_and_loss_match_reference(size, weighted):
    jcfg, cfg, p, batch = _setup(size, weighted)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # eager, as the reference's own model tests run it
    jlogits = np.asarray(jmodels.forward(p, jcfg, jb["images"]))
    jloss, _ = jmodels.loss_fn(p, jcfg, jb)
    tp = params_from_numpy(p, "cpu")
    with torch.no_grad():
        logits = models.forward(tp, cfg, _tbatch(batch)["images"])
        loss, aux = models.loss_fn(tp, cfg, _tbatch(batch))
    assert logits.shape == (6, 10)
    assert float(np.max(np.abs(logits.numpy() - jlogits))) <= LOGITS_ATOL
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert aux["per_example"].shape == (6,)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_flat_gradient_matches_reference(size, weighted):
    jcfg, cfg, p, batch = _setup(size, weighted)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jflat_spec(jp)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(
        lambda b: jmodels.loss_fn(js.unravel(b), jcfg, jb)[0]))(js.ravel(jp))
    tp = params_from_numpy(p, "cpu")
    ts = flat_spec(tp)
    buf = ts.ravel(tp).requires_grad_()
    loss, _ = models.loss_fn(ts.unravel(buf), cfg, _tbatch(batch))
    (g,) = torch.autograd.grad(loss, buf)
    assert g.shape == ts.shape
    assert float(np.max(np.abs(g.numpy() - np.asarray(jg)))) <= GRAD_ATOL
    assert float(g.reshape(-1)[ts.n:].abs().max()) == 0.0    # padding


def test_dropout_uses_the_generator_and_rate():
    cfg = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
    tp = models.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    x = torch.rand(4, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    a = models.forward(tp, cfg, x, drop_rng=torch.Generator().manual_seed(2),
                       drop_rate=0.5)
    b = models.forward(tp, cfg, x, drop_rng=torch.Generator().manual_seed(2),
                       drop_rate=0.5)
    c = models.forward(tp, cfg, x)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unported_arch_names_its_slice():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        models.init_params(replace(get_config("cifar-resnet18"),
                                   arch_type="transformer"),
                           torch.Generator())
