from repro_torch.models.model import LMModel, build_model  # noqa: F401
