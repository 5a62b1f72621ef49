"""Vision model zoo (the counterpart of
`mxnet_tpu/gluon/model_zoo/vision`): ResNet v1 and v2 at 18, 34, 50, 101
and 152 layers.  The other families wait for a later slice."""
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, get_resnet, resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "resnet18_v2": resnet18_v2, "resnet34_v2": resnet34_v2,
    "resnet50_v2": resnet50_v2, "resnet101_v2": resnet101_v2,
    "resnet152_v2": resnet152_v2,
}


def get_model(name, **kwargs):
    """A zoo model by name (reference `vision/__init__.py:get_model`)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            f"Model {name} is not supported. Available: {sorted(_models)}")
    return _models[name](**kwargs)


__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "get_model"] + \
    sorted(_models)
