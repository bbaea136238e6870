from sdumc_tpu_torch.core.registry import MODELS
from sdumc_tpu_torch.models.baselines import (  # noqa: F401  (self-register)
    LMF, MISA, MMIM, TFN, AttentionFusion)
from sdumc_tpu_torch.models.baselines_seq import (  # noqa: F401  (self-register)
    MCTN, MFM, MFN, MULT, GraphMFN)
from sdumc_tpu_torch.models.fusion import SDUMCFusion  # noqa: F401  (self-registers)


def get_model(cfg, generator=None):
    """Build the registered model named ``cfg.name`` (on the CPU)."""
    return MODELS.get(cfg.name)(cfg, generator)
