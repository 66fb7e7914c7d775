"""ResNet-18 / CIFAR-100 — the paper's own evaluation model (faithful repro).

[He et al. 2016; paper §5] 18 conv layers + FC, trained with the dual-batch /
cyclic-progressive / hybrid schemes on 32x32 (sub-stage 24x24) images.
"""
from repro_torch.configs.base import ModelConfig, TrainConfig

CONFIG = ModelConfig(
    name="cifar-resnet18",
    arch_type="cnn",
    n_layers=18,
    d_model=64,            # stem width
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=100,        # num classes
    param_dtype="float32",
    compute_dtype="float32",
    source="He et al. 2016 / paper §5",
)

# Paper Table 7 training configuration (CIFAR-100, hybrid scheme).
TRAIN = TrainConfig(
    optimizer="sgd",
    learning_rate=0.2,
    extra_time_ratio=1.05,
    n_workers=4,
    n_small=3,
    update_factor="ds_over_dl",
    stages=(80, 40, 20),
    stage_lrs=(0.2, 0.02, 0.002),
    sub_resolutions=(24, 32),
    sub_dropouts=(0.1, 0.2),
)
