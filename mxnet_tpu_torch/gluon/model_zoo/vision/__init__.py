"""Vision model zoo (the counterpart of
`mxnet_tpu/gluon/model_zoo/vision`; reference
`python/mxnet/gluon/model_zoo/vision/`): AlexNet, VGG (with and without
BatchNorm), ResNet v1/v2, DenseNet, SqueezeNet, Inception-v3 and MobileNet
v1/v2, by the reference's names in ``_models`` and `get_model`.
``pretrained=True`` raises: the repository holds no weights."""
from .alexnet import AlexNet, alexnet
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2,
                     BottleneckV1, BottleneckV2, resnet18_v1, resnet34_v1,
                     resnet50_v1, resnet101_v1, resnet152_v1, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2,
                     get_resnet)
from .vgg import (VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn,
                  vgg16_bn, vgg19_bn, get_vgg)
from .squeezenet import (SqueezeNet, get_squeezenet, squeezenet1_0,
                         squeezenet1_1)
from .densenet import (DenseNet, get_densenet,
                       densenet121, densenet161, densenet169,
                       densenet201)
from .inception import Inception3, inception_v3
from .mobilenet import (MobileNet, MobileNetV2, mobilenet1_0, mobilenet0_75,
                        mobilenet0_5, mobilenet0_25, mobilenet_v2_1_0,
                        mobilenet_v2_0_75, mobilenet_v2_0_5,
                        mobilenet_v2_0_25, get_mobilenet, get_mobilenet_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """A zoo model by name (reference `vision/__init__.py:get_model`)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)


__all__ = ["AlexNet", "ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "VGG", "get_vgg",
           "SqueezeNet", "get_squeezenet", "DenseNet", "get_densenet",
           "Inception3", "inception_v3", "MobileNet", "MobileNetV2",
           "get_mobilenet", "get_mobilenet_v2", "get_model",
           "squeezenet1_0", "squeezenet1_1", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"] + \
    sorted(n for n in _models if n.isidentifier())
