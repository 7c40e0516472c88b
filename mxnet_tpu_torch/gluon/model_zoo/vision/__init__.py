"""Vision models of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ResNet v1 and v2, VGG, AlexNet,
DenseNet, SqueezeNet, Inception v3 and MobileNet v1/v2/v3, each taking
``layout``, ``ctx``, ``dtype`` and ``generator``, the SSD detector
(``SSD``, ``SSDMultiBoxLoss``, ``get_ssd``, ``ssd_toy``), and
:func:`get_model` over the reference's names. ``pretrained=True`` reads
the local model store."""
from ....base import MXNetError
from . import alexnet as _alexnet
from . import densenet as _densenet
from . import inception as _inception
from . import mobilenet as _mobilenet
from . import resnet as _resnet
from . import squeezenet as _squeezenet
from . import ssd as _ssd
from . import vgg as _vgg
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .ssd import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403


_models = {
    "ssd_toy": _ssd.ssd_toy,
    "resnet18_v1": _resnet.resnet18_v1,
    "resnet34_v1": _resnet.resnet34_v1,
    "resnet50_v1": _resnet.resnet50_v1,
    "resnet101_v1": _resnet.resnet101_v1,
    "resnet152_v1": _resnet.resnet152_v1,
    "resnet18_v2": _resnet.resnet18_v2,
    "resnet34_v2": _resnet.resnet34_v2,
    "resnet50_v2": _resnet.resnet50_v2,
    "resnet101_v2": _resnet.resnet101_v2,
    "resnet152_v2": _resnet.resnet152_v2,
    "vgg11": _vgg.vgg11,
    "vgg13": _vgg.vgg13,
    "vgg16": _vgg.vgg16,
    "vgg19": _vgg.vgg19,
    "vgg11_bn": _vgg.vgg11_bn,
    "vgg13_bn": _vgg.vgg13_bn,
    "vgg16_bn": _vgg.vgg16_bn,
    "vgg19_bn": _vgg.vgg19_bn,
    "alexnet": _alexnet.alexnet,
    "densenet121": _densenet.densenet121,
    "densenet161": _densenet.densenet161,
    "densenet169": _densenet.densenet169,
    "densenet201": _densenet.densenet201,
    "squeezenet1.0": _squeezenet.squeezenet1_0,
    "squeezenet1.1": _squeezenet.squeezenet1_1,
    "inceptionv3": _inception.inception_v3,
    "mobilenet1.0": _mobilenet.mobilenet1_0,
    "mobilenet0.75": _mobilenet.mobilenet0_75,
    "mobilenet0.5": _mobilenet.mobilenet0_5,
    "mobilenet0.25": _mobilenet.mobilenet0_25,
    "mobilenetv2_1.0": _mobilenet.mobilenet_v2_1_0,
    "mobilenetv2_0.75": _mobilenet.mobilenet_v2_0_75,
    "mobilenetv2_0.5": _mobilenet.mobilenet_v2_0_5,
    "mobilenetv2_0.25": _mobilenet.mobilenet_v2_0_25,
    "mobilenetv3_large": _mobilenet.mobilenet_v3_large,
    "mobilenetv3_small": _mobilenet.mobilenet_v3_small,
}


def get_model(name, **kwargs):
    """The model ``name`` (one of the reference's ``_models``), built
    with ``kwargs`` (reference ``vision/__init__.py::get_model``)."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"Model {name!r} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)


__all__ = (["get_model"] + _ssd.__all__ + _resnet.__all__ + _vgg.__all__
           + _alexnet.__all__ + _densenet.__all__ + _squeezenet.__all__
           + _inception.__all__ + _mobilenet.__all__)
