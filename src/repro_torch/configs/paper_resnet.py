"""The paper's own model family: a mini-ResNet (ReLU + BatchNorm) for the
reproduction of Tables 1/2/3/4/6 on a synthetic task (no ImageNet
offline). Port of `repro.configs.paper_resnet`."""
from repro_torch.models.cnn import CNNConfig


def config() -> CNNConfig:
    return CNNConfig(name="paper-resnet", num_classes=16, width=32,
                     stages=(2, 2, 2), img_size=32)


def reduced() -> CNNConfig:
    return CNNConfig(name="paper-resnet-reduced", num_classes=8, width=16,
                     stages=(1, 1), img_size=16)
