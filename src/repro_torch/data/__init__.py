from repro_torch.data.pipeline import DataState, SyntheticLMPipeline
