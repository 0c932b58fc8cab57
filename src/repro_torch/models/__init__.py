from repro_torch.models.config import (  # noqa: F401
    EncoderConfig,
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.models import model  # noqa: F401
