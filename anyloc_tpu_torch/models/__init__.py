"""The model zoo: one ViT trunk configured per family (DINOv2, DINO v1,
CLIP, HF / CosPlace ViT, ImageBind's vision trunk, LSeg's backbone), the
MAE and SAM encoders, ImageBind's multimodal towers, the trained
baselines' CNN and Swin backbones (``resnet``: ResNet / VGG-16 / AlexNet,
``efficientnet``, ``swin``, ``cct``) and their checkpoint converters
(``registry``, ``convert``)."""
