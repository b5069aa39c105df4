from resnetc_tpu_torch.models.resnet import (  # noqa: F401
    RESNET_CONFIGS,
    ResNetConfig,
    fold_inference_params,
    forward,
    forward_folded,
    get_config,
    init,
    merge_params_state,
    param_shapes,
    split_params_state,
)
