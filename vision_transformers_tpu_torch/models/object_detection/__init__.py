from vision_transformers_tpu_torch.models.object_detection.backbone import (
    ResNet,
    build_backbone,
)
from vision_transformers_tpu_torch.models.object_detection.detr import (
    Detr,
    Joiner,
    AbsolutePositionalEncoding,
    SinePositionalEncoding,
    PostProcess,
    set_model_and_positional_embeddings,
)
from vision_transformers_tpu_torch.models.object_detection.transformer import (
    Transformer,
)
from vision_transformers_tpu_torch.models.object_detection.matcher import (
    HungarianMatcher,
    prepare_targets,
)
from vision_transformers_tpu_torch.models.object_detection.criterion import (
    SetCriterion,
)
