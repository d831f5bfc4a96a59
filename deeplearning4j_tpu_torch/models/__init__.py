"""The model zoo of the port (mirrors ``deeplearning4j_tpu/models``).  Each
entry of ``ZOO`` is a function that builds a network on ``device``
(default ``cuda``) by the reference's ZOO name.  The entries whose layers
are not ported yet raise, naming the ROADMAP item that ports them;
``pretrained.py`` waits with them (the repository ships no CNN weights).
"""

from .alexnet import AlexNet
from .darknet19 import Darknet19
from .googlenet import GoogLeNet
from .lenet import LeNet
from .resnet50 import ResNet50
from .simplecnn import SimpleCNN
from .textgen_lstm import TextGenerationLSTM
from .transformer import (PositionalEmbedding, TransformerBlock,
                          TransformerDecodeAdapter, TransformerLM)
from .vgg import VGG16, VGG19


def _waits(name: str, needs: str):
    def build(*_, **__):
        raise NotImplementedError(
            f"zoo model {name!r} is not ported yet: it needs {needs} "
            "(ROADMAP queue 1 item 6)")
    build.__name__ = name
    return build


ZOO = {
    "lenet": LeNet,
    "simplecnn": SimpleCNN,
    "alexnet": AlexNet,
    "vgg16": VGG16,
    "vgg19": VGG19,
    "resnet50": ResNet50,
    "darknet19": Darknet19,
    "tinyyolo": _waits("TinyYOLO", "Yolo2OutputLayer (nn/layers/objdetect.py)"),
    "textgenerationlstm": TextGenerationLSTM,
    "transformerlm": TransformerLM,
    "googlenet": GoogLeNet,
    "inceptionresnetv1": _waits("InceptionResNetV1",
                                "CenterLossOutputLayer (nn/layers/special.py)"),
    "facenetnn4small2": _waits("FaceNetNN4Small2",
                               "CenterLossOutputLayer (nn/layers/special.py)"),
}

__all__ = ["AlexNet", "Darknet19", "GoogLeNet", "LeNet", "PositionalEmbedding",
           "ResNet50", "SimpleCNN", "TextGenerationLSTM", "TransformerBlock",
           "TransformerDecodeAdapter", "TransformerLM", "VGG16", "VGG19", "ZOO"]
