from clip_event_tpu_torch.models.clip import (  # noqa: F401
    CLIP,
    CLIPConfig,
    VIT_B16,
    VIT_B32,
    VIT_L14,
    encode_image,
    encode_text,
    forward,
    init_params,
)
from clip_event_tpu_torch.models.convert import (  # noqa: F401
    config_from_state_dict,
    params_from_jax,
    params_from_state_dict,
    state_dict_from_params,
)
