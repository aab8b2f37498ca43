from orcai_tpu_torch.models.crnn import ResNetLSTM, build_model

__all__ = ["ResNetLSTM", "build_model"]
