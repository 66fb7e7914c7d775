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


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_kernels_match_plain_versions(cuda, kv_dtype):
    """B5 and B6 on the card against their plain versions at a small GQA
    shape with a window and a dead row, f32 q (within 2e-5: the two sum
    the softmax in other orders; chip_smoke.py holds them at the serving
    shapes)."""
    from repro_torch.kernels import flash_decode as fd
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, h, kv, hd, page_len, pp, n_pages = 4, 4, 2, 64, 16, 4, 20
    q = torch.randn(rows, h, 1, hd, generator=gen, device=cuda)
    kp = torch.randn(n_pages, page_len, kv, hd, generator=gen,
                     device=cuda).to(kv_dtype)
    vp = torch.randn(n_pages, page_len, kv, hd, generator=gen,
                     device=cuda).to(kv_dtype)
    table = torch.randperm(n_pages, generator=gen, device=cuda)[
        :rows * pp].reshape(rows, pp).int()
    table[1] = n_pages                                   # dead row
    lengths = torch.tensor([63, 0, 17, 40], dtype=torch.int32, device=cuda)
    fd.reset_counts()
    for w in (0, 8):
        got = fd.flash_decode_paged(q, kp, vp, table, lengths, window=w)
        want = fd.paged_decode_ref(q, kp, vp, table, lengths, window=w)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
        kc = kp[table.long().clamp(0, n_pages - 1)].reshape(
            rows, pp * page_len, kv, hd).transpose(1, 2).contiguous()
        vc = vp[table.long().clamp(0, n_pages - 1)].reshape(
            rows, pp * page_len, kv, hd).transpose(1, 2).contiguous()
        got = fd.flash_decode(q, kc, vc, 50, window=w)
        torch.testing.assert_close(got, fd._xla_decode(q, kc, vc, 50,
                                                       window=w),
                                   atol=2e-5, rtol=0)
    assert fd.launch_count() == 4 and fd.plain_count() == 0
