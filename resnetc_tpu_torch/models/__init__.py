from resnetc_tpu_torch.models.resnet import (  # noqa: F401
    RESNET_CONFIGS,
    ResNetConfig,
    fold_inference_params,
    forward_folded,
    get_config,
    init,
    param_shapes,
)
