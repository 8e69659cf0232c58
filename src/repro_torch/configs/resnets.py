"""The paper's own models: ResNet18/34/50 at ImageNet scale (the reference
package's configs/resnets.py)."""
from .base import ArchConfig

RESNET18 = ArchConfig(name="resnet18", family="resnet", block="basic",
                      stage_sizes=(2, 2, 2, 2), num_classes=1000,
                      img_size=224)
RESNET34 = ArchConfig(name="resnet34", family="resnet", block="basic",
                      stage_sizes=(3, 4, 6, 3), num_classes=1000,
                      img_size=224)
RESNET50 = ArchConfig(name="resnet50", family="resnet", block="bottleneck",
                      stage_sizes=(3, 4, 6, 3), num_classes=1000,
                      img_size=224)
