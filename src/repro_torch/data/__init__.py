from repro_torch.data.pipeline import DataConfig, SyntheticLM

__all__ = ["DataConfig", "SyntheticLM"]
