from vision_transformers_tpu_torch.core.dtypes import (  # noqa: F401
    Policy,
    default_policy,
)
