from sdumc_tpu_torch.models.modules.transformer_encoder import (  # noqa: F401
    CrossModalTransformerEncoder,
    LSTMEncoder,
    MLPEncoder,
    sinusoidal_positions,
)
