from vision_transformers_tpu_torch.models.image_classification.vanilla_vit import ViT

__all__ = ["ViT"]
