from vision_transformers_tpu_torch.models.image_classification.cpe_vit import (
    CPEViT,
)
from vision_transformers_tpu_torch.models.image_classification.cpvt import (
    CPVT,
    CPVTGAP,
)
from vision_transformers_tpu_torch.models.image_classification.deit import DeiT
from vision_transformers_tpu_torch.models.image_classification.pvt import (
    PVT,
    PVTBlock,
)
from vision_transformers_tpu_torch.models.image_classification.swin_transformer import (
    SwinTransformer,
    SwinTransformerBlock,
    SwinTransformerBlockV2,
    SwinTransformerV2,
)
from vision_transformers_tpu_torch.models.image_classification.twins_svt import (
    GroupAttention,
    GroupBlock,
    PosCNN,
    TwinSVT,
)
from vision_transformers_tpu_torch.models.image_classification.t2t_vit import (
    T2T_ViT,
)
from vision_transformers_tpu_torch.models.image_classification.tnt import TNT
from vision_transformers_tpu_torch.models.image_classification.vanilla_vit import ViT

__all__ = ["ViT", "SwinTransformer", "SwinTransformerV2",
           "SwinTransformerBlock", "SwinTransformerBlockV2",
           "PVT", "PVTBlock", "TwinSVT", "GroupBlock", "GroupAttention",
           "PosCNN", "DeiT", "CPEViT", "T2T_ViT", "CPVT", "CPVTGAP", "TNT"]
