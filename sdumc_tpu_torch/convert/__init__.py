from sdumc_tpu_torch.convert.checkpoint import (  # noqa: F401
    load_reference_checkpoint, load_reference_state_dict)
from sdumc_tpu_torch.convert.from_flax import (  # noqa: F401
    llama_state_dict_from_flax, manet_state_dict_from_flax, state_dict_from_flax,
    wavlm_state_dict_from_flax, whisper_state_dict_from_flax)
