from orcai_tpu_torch.models.crnn import (
    ORCAI_ARCHITECTURES,
    ResNet1DConv,
    ResNetLSTM,
    ResNetTCN,
    build_model,
    init_variables,
    l2_regularization,
)

__all__ = [
    "ORCAI_ARCHITECTURES",
    "ResNet1DConv",
    "ResNetLSTM",
    "ResNetTCN",
    "build_model",
    "init_variables",
    "l2_regularization",
]
