from repro_torch.data.pipeline import (
    SyntheticTokenPipeline, make_batch_specs, stub_modality_inputs,
)
