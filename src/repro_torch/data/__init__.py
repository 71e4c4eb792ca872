from repro_torch.data.pipeline import SyntheticTokens, make_pipeline  # noqa: F401
