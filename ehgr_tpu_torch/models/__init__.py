"""Models: the backbones with ACTION/TSM (ResNet, Res2Net, MobileNetV2,
BN-Inception; L2), the TSN task model (L4), the image-level BYOT ResNet,
the modality helpers and the JAX-weights converter."""
