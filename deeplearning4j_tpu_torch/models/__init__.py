"""The model zoo of the port (mirrors ``deeplearning4j_tpu/models``).  Each
entry of ``ZOO`` is a function that builds a network on ``device``
(default ``cuda``) by the reference's ZOO name; ``pretrained.py`` loads
weights through the reference's checksum-verified cache.
"""

from .alexnet import AlexNet
from .darknet19 import Darknet19
from .facenet_nn4 import FaceNetNN4Small2
from .googlenet import GoogLeNet
from .inception_resnet_v1 import InceptionResNetV1
from .lenet import LeNet
from .pretrained import (PretrainedType, cached_path, checksum, init_pretrained,
                         init_pretrained_int8, install_weights)
from .resnet50 import ResNet50
from .simplecnn import SimpleCNN
from .textgen_lstm import TextGenerationLSTM
from .tinyyolo import TinyYOLO
from .transformer import (PositionalEmbedding, TransformerBlock,
                          TransformerDecodeAdapter, TransformerLM)
from .vgg import VGG16, VGG19

ZOO = {
    "lenet": LeNet,
    "simplecnn": SimpleCNN,
    "alexnet": AlexNet,
    "vgg16": VGG16,
    "vgg19": VGG19,
    "resnet50": ResNet50,
    "darknet19": Darknet19,
    "tinyyolo": TinyYOLO,
    "textgenerationlstm": TextGenerationLSTM,
    "transformerlm": TransformerLM,
    "googlenet": GoogLeNet,
    "inceptionresnetv1": InceptionResNetV1,
    "facenetnn4small2": FaceNetNN4Small2,
}

__all__ = ["AlexNet", "Darknet19", "FaceNetNN4Small2", "GoogLeNet", "InceptionResNetV1",
           "LeNet", "PositionalEmbedding", "PretrainedType", "ResNet50", "SimpleCNN",
           "TextGenerationLSTM", "TinyYOLO", "TransformerBlock", "TransformerDecodeAdapter",
           "TransformerLM", "VGG16", "VGG19", "ZOO", "cached_path", "checksum",
           "init_pretrained", "init_pretrained_int8", "install_weights"]
