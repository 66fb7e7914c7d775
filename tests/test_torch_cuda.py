"""The engine's device fences on the card: the default device is CUDA, TF32
is off, and parameters that live elsewhere are refused.  (``chip_smoke.py``
holds every kernel variant bit-equal to its plain version on the card.)
Skips without a GPU; on one, run

    python -m pytest -q -m cuda tests/test_torch_cuda.py

(this file imports no JAX, so it runs where only PyTorch is installed)."""
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the device fences are tested "
                    "without one in test_torch_imports.py)")
    return torch.device("cuda")


def test_engine_refuses_params_off_its_device(cuda):
    from dataclasses import replace

    from repro_torch import models
    from repro_torch.configs import get_config
    from repro_torch.engine import TrainEngine
    from repro_torch.optim import sgd_momentum
    cfg = replace(get_config("cifar-resnet18"), d_model=8, vocab_size=10)
    engine = TrainEngine(cfg, sgd_momentum(0.0), sgd_server=True)
    assert engine.device.type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    on_card = models.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(t.device == engine.device for t in
               [on_card["stem"], on_card["fc_w"], on_card["bn0"]["scale"]])
    params = models.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(ValueError, match="live on cpu"):
        engine.run([], params, None, lambda ph, g: {})
