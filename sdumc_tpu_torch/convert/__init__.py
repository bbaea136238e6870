from sdumc_tpu_torch.convert.checkpoint import (  # noqa: F401
    load_reference_checkpoint, load_reference_state_dict)
from sdumc_tpu_torch.convert.from_flax import (  # noqa: F401
    albert_state_dict_from_flax, baseline_state_dict_from_flax, bert_state_dict_from_flax,
    bloom_state_dict_from_flax, clip_state_dict_from_flax, deberta_state_dict_from_flax,
    dinov2_state_dict_from_flax, eva02_state_dict_from_flax, glm_state_dict_from_flax,
    llama_state_dict_from_flax, manet_state_dict_from_flax, resnet_state_dict_from_flax,
    state_dict_from_flax, videomae_state_dict_from_flax, wavlm_state_dict_from_flax,
    whisper_state_dict_from_flax)
